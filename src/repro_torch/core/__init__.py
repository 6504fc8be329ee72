"""Paper core: WLSH estimator, kernels and KRR, in PyTorch."""
from .bucket_fns import BUCKET_FNS, RECT, SMOOTH, TENT, BucketFn, get_bucket_fn
from .kernels import (KERNELS, WLSHKernel, WLSHKernelSpec, gaussian_kernel,
                      laplace_kernel, make_wlsh_kernel, matern52_kernel,
                      tabulate_wlsh_k1d)
from .krr import (CGResult, PCGResult, SolveState, WLSHKRRModel, cg_solve,
                  exact_krr_fit, exact_krr_predict, load_solve_state,
                  model_operator, pcg_solve, solve_state_template,
                  wlsh_krr_fit, wlsh_krr_predict)
from .lsh import (Features, GammaPDF, LSHParams, featurize,
                  lsh_params_from_numpy, sample_lsh_params,
                  slots_from_features)
from .operator import WLSHOperator, default_table_size, make_operator
from .precond import (PRECOND_NAMES, Preconditioner, identity_precond,
                      jacobi_precond, make_preconditioner, nystrom_factors,
                      nystrom_precond, table_diag)
from .rff import (RFFModel, rff_draw, rff_features, rff_krr_fit,
                  rff_krr_predict, rff_krr_solve)
from .wlsh import (BlockedLayout, ExactIndex, TableIndex, WLSHEstimator,
                   build_blocked_layout, build_exact_index, build_table_index,
                   exact_kernel_matrix, exact_matvec, make_matvec,
                   table_kernel_matrix, table_loads, table_matvec,
                   table_matvec_fused, table_readout)
