"""Paper core: WLSH estimator, kernels and KRR, in PyTorch."""
from .bucket_fns import BUCKET_FNS, RECT, SMOOTH, TENT, BucketFn, get_bucket_fn
from .kernels import WLSHKernelSpec, laplace_kernel
from .krr import (PCGResult, SolveState, WLSHKRRModel, exact_krr_fit,
                  exact_krr_predict, model_operator, pcg_solve, wlsh_krr_fit,
                  wlsh_krr_predict)
from .lsh import (Features, GammaPDF, LSHParams, featurize,
                  lsh_params_from_numpy, sample_lsh_params,
                  slots_from_features)
from .operator import WLSHOperator, default_table_size, make_operator
from .precond import (PRECOND_NAMES, Preconditioner, identity_precond,
                      jacobi_precond, make_preconditioner, nystrom_factors,
                      nystrom_precond, table_diag)
from .wlsh import (BlockedLayout, TableIndex, build_blocked_layout,
                   build_table_index, table_loads, table_matvec_fused,
                   table_readout)
