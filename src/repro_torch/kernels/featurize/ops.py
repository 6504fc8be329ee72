"""Public op: WLSH featurization, dispatched on the points' device (the
CUDA kernel on the card, the plain version on the CPU)."""
from __future__ import annotations

from ...backend import as_tensor, on_card
from ...core.bucket_fns import BucketFn
from ...core.lsh import Features, LSHParams
from .kernel import featurize_cuda
from .ref import featurize_ref


def featurize_op(params: LSHParams, f: BucketFn, x, *,
                 table_size: int = 0) -> Features:
    """Features of x (n, d) under the m instances of ``params``; with a
    ``table_size`` also the CountSketch slot and coeff the index needs."""
    x = as_tensor(x, params.w.device)
    if x.ndim != 2 or x.shape[1] != params.d:
        raise ValueError(f"x must be (n, {params.d}), got {tuple(x.shape)}")
    if on_card(x, params.w):
        out = featurize_cuda(x, *params, f=f, table_size=table_size)
    else:
        out = featurize_ref(x, *params, f=f, table_size=table_size)
    feats = Features(*out)
    if not table_size:
        feats = feats._replace(slot=None, coeff=None)
    return feats
