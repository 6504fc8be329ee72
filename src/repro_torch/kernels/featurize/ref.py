"""Plain PyTorch version of the featurize kernel: the paper's Def. 6 as
written in core/lsh.py, one instance at a time."""
from __future__ import annotations

from ...core.bucket_fns import BucketFn
from ...core.lsh import LSHParams, featurize


def featurize_ref(x, w, z, r1, r2, *, f: BucketFn, table_size: int):
    """(key1, key2, weight, sign, slot, coeff), each (m, n)."""
    return tuple(featurize(LSHParams(w, z, r1, r2), f, x,
                           table_size=table_size))
