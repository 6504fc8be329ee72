from .kernel import (bin_fused_matvec_cuda, bin_gather_cuda,
                     bin_scatter_blocked_cuda)
from .ops import bin_fused_matvec_op, bin_loads_blocked_op, bin_readout_op
from .ref import fused_matvec_ref, gather_ref, scatter_blocked_ref
