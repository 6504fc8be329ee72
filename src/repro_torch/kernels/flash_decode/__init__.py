from .kernel import flash_decode_cuda
from .ops import decode_attend_op
from .ref import flash_decode_ref
