"""Online serving of fitted WLSH-KRR models on one device.

Layered as artifact (disk format, shared with the JAX package) -> predictor
(one CUDA graph per padding bucket on the card, and the bucket-exact cache)
-> batcher (request coalescing) -> lifecycle (version watching, canary swap,
rollback, worker supervision); ``repro_torch.launch.krr_serve`` strings them
together.  The structured serving errors re-export here for callers.
Sharded serving is not ported yet.
"""
from ..errors import (CircuitOpen, DeadlineExceeded, InvalidRequest,
                      Overloaded, ServingError, WorkerCrashed)
from .artifact import (ARTIFACT_FORMAT, GOLDEN_QUERIES, GOLDEN_TOL,
                       LoadedArtifact, Normalization, export_artifact,
                       load_artifact)
from .batcher import MicroBatcher, percentile
from .cache import BucketKeyFn, PredictionCache
from .lifecycle import (CircuitBreaker, LifecycleConfig, ServingRuntime,
                        SupervisedBatcher, discover_versions, version_dir)
from .predictor import Predictor, bucket_sizes, padding_bucket

__all__ = ["ARTIFACT_FORMAT", "GOLDEN_QUERIES", "GOLDEN_TOL", "BucketKeyFn",
           "CircuitBreaker", "CircuitOpen", "DeadlineExceeded",
           "InvalidRequest", "LifecycleConfig", "LoadedArtifact",
           "MicroBatcher", "Normalization", "Overloaded", "PredictionCache",
           "Predictor", "ServingError", "ServingRuntime",
           "SupervisedBatcher", "WorkerCrashed", "bucket_sizes",
           "discover_versions", "export_artifact", "load_artifact",
           "padding_bucket", "percentile", "version_dir"]
