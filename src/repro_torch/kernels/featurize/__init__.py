from .kernel import featurize_cuda
from .ops import featurize_op
from .ref import featurize_ref
