"""Online serving of fitted WLSH-KRR models, on one device or sharded over
a grid of ranks.

Layered as artifact (disk format, shared with the JAX package: flat
artifacts and sharded piece grids) -> predictor (one CUDA graph per
padding bucket on the card, and the bucket-exact cache) or sharded
predictor (the SPMD grid: rank 0 fronts, every rank serves its piece) ->
batcher (request coalescing) -> lifecycle (version watching, canary swap,
rollback, worker supervision); ``repro_torch.launch.krr_serve`` strings
them together.  The structured serving errors re-export here for callers.
"""
from ..errors import (CircuitOpen, DeadlineExceeded, InvalidRequest,
                      Overloaded, ServingError, WorkerCrashed)
from .artifact import (ARTIFACT_FORMAT, GOLDEN_QUERIES, GOLDEN_TOL,
                       MANIFEST_NAME, LoadedArtifact, LoadedPiece,
                       LoadedShardedArtifact, Normalization, export_artifact,
                       export_artifact_sharded, load_artifact,
                       load_artifact_piece, load_artifact_sharded)
from .batcher import MicroBatcher, percentile
from .cache import BucketKeyFn, PredictionCache
from .lifecycle import (CircuitBreaker, LifecycleConfig, ServingRuntime,
                        SupervisedBatcher, discover_versions, version_dir)
from .predictor import Predictor, bucket_sizes, padding_bucket
from .sharded import ShardedPredictor, parse_mesh_shape

__all__ = ["ARTIFACT_FORMAT", "GOLDEN_QUERIES", "GOLDEN_TOL", "BucketKeyFn",
           "CircuitBreaker", "CircuitOpen", "DeadlineExceeded",
           "InvalidRequest", "LifecycleConfig", "LoadedArtifact",
           "LoadedPiece", "LoadedShardedArtifact", "MANIFEST_NAME",
           "MicroBatcher", "Normalization", "Overloaded", "PredictionCache",
           "Predictor", "ServingError", "ServingRuntime", "ShardedPredictor",
           "SupervisedBatcher", "WorkerCrashed", "bucket_sizes",
           "discover_versions", "export_artifact", "export_artifact_sharded",
           "load_artifact", "load_artifact_piece", "load_artifact_sharded",
           "padding_bucket", "parse_mesh_shape", "percentile",
           "version_dir"]
