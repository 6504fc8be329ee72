from .kernel import (bin_fused_matvec_cuda, bin_gather_blocked_cuda,
                     bin_gather_cuda, bin_readout_cuda,
                     bin_scatter_blocked_cuda, bin_scatter_cuda,
                     route_pack_cuda, route_unpack_cuda)
from .ops import (bin_fused_matvec_op, bin_loads_blocked_op, bin_loads_op,
                  bin_readout_blocked_op, bin_readout_op, route_pack_op,
                  route_unpack_op, table_matvec_op)
from .ref import (fused_matvec_ref, fused_matvec_src_ref,
                  gather_blocked_ref, gather_ref,
                  readout_ref, route_pack_ref, route_unpack_ref,
                  scatter_blocked_ref, scatter_ref)
