"""The WLSH operator: the primitive set every path of the port runs through.

    featurize       points -> Features             (hash + weight + sign)
    build_index     Features -> TableIndex         (with the slot-blocked
                                                    layout for fits), or
                                ExactIndex         (mode='exact')
    loads           index, beta -> (m, B) tables   (CountSketch scatter)
    readout         index, tables -> per point     (CountSketch gather)
    matvec          index, beta -> K~ beta         (fused one-pass off the
                                                    layout, or loads then
                                                    readout when split; the
                                                    sorted segment sum of
                                                    an ExactIndex)
    featurize_buckets / predict_from_buckets / predict_batched (prediction)

There is no backend switch: the operator's tensors live on one device, and
each primitive runs the CUDA kernels on the card and their plain versions on
the CPU (see backend.py).  ``fused=False`` keeps the split matvec, and
gives a layout built by ``build_index`` the split kernels' geometry: the
distributed psum step's operator on a sharded data axis.

Two obs timers hold the host's time in the hot primitives: ``op.matvec``
(one matvec's issue) and ``predict.block`` (one block of
``predict_batched``: featurize, index, readout).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import obs
from ..backend import as_tensor, resolve_device
from .bucket_fns import BucketFn
from .lsh import Features, LSHParams
from .wlsh import (BLOCKED_N, BLOCKED_SPLIT_N, BLOCKED_SPLIT_T, BLOCKED_T,
                   ExactIndex, TableIndex, build_blocked_layout,
                   build_exact_index, build_table_index, exact_matvec)

_MATVEC = obs.timer("op.matvec")
_BLOCK = obs.timer("predict.block")


def default_table_size(n: int, *, min_pow: int = 8) -> int:
    """CountSketch table-size heuristic: the smallest power of two >= 4n
    (>= 2^min_pow) keeps same-slot collisions rare."""
    return 1 << max(min_pow, int(4 * max(n, 1) - 1).bit_length())


class WLSHOperator(NamedTuple):
    """WLSH primitive set bound to m LSH instances on one device."""

    lsh: LSHParams
    bucket: BucketFn
    table_size: int
    fused: bool = True     # one-pass matvec off the slot-blocked layout

    @property
    def device(self) -> torch.device:
        return self.lsh.w.device

    def featurize(self, x) -> Features:
        from ..kernels.featurize import featurize_op
        return featurize_op(self.lsh, self.bucket, x,
                            table_size=self.table_size)

    def build_index(self, feats: Features, mode: str = "table", *,
                    blocked: bool | None = None,
                    parts: str = "kernel") -> TableIndex | ExactIndex:
        """CountSketch index (mode 'table'), or the exact sorted-bucket
        index (mode 'exact'; ``blocked`` and ``parts`` unused).
        ``blocked`` (None: the operator's ``fused``) attaches the
        slot-blocked layout (one sort per instance) that the fused matvec,
        the table build and the layout readout read, at the split geometry
        when the operator is not fused.  ``parts`` picks the
        layout's array groups (the hash join also needs 'reference').
        Prediction passes ``blocked=False``: it only gathers."""
        if mode == "exact":
            return build_exact_index(feats)
        if mode != "table":
            raise ValueError(f"unknown mode {mode!r}")
        idx = build_table_index(feats, self.table_size)
        if self.fused if blocked is None else blocked:
            bn = BLOCKED_N if self.fused else BLOCKED_SPLIT_N
            bt = BLOCKED_T if self.fused else BLOCKED_SPLIT_T
            idx = idx._replace(blocked=build_blocked_layout(
                idx.slot, idx.coeff, self.table_size, block_n=bn,
                block_t=bt, parts=parts))
        return idx

    def loads(self, index: TableIndex, beta: torch.Tensor) -> torch.Tensor:
        """Bucket-load tables, the psum-able object: (m, B) for beta (n,),
        (m, B, k) for (n, k); off the layout when the index has one."""
        from ..kernels.binning import bin_loads_op
        return bin_loads_op(index, beta)

    def readout(self, index: TableIndex, tables: torch.Tensor, *,
                average: bool = True) -> torch.Tensor:
        """Per-point readout; ``average`` gives (1/m) sum_s, else the sum
        (the distributed step divides by the global m after its reduce)."""
        from ..kernels.binning import bin_readout_op
        return bin_readout_op(index, tables, average=average)

    def matvec(self, index: TableIndex | ExactIndex, beta: torch.Tensor, *,
               average: bool = True) -> torch.Tensor:
        """K~ beta in O(n m) for beta (n,) or an (n, k) block: one pass over
        the slot-blocked layout when the operator is fused and the index
        has the layout's kernel group, else loads then readout.  An
        ``ExactIndex`` runs the exact estimator (``average`` only)."""
        from ..kernels.binning import bin_fused_matvec_op, table_matvec_op
        with _MATVEC():
            if isinstance(index, ExactIndex):
                if not average:
                    raise ValueError("exact-mode matvec only supports "
                                     "average=True")
                return exact_matvec(index, beta)
            lay = index.blocked
            if self.fused and lay is not None and lay.blk_start is not None:
                return bin_fused_matvec_op(index, beta, average=average)
            return table_matvec_op(index, beta, average=average)

    def featurize_buckets(self, x) -> TableIndex:
        """Query half of prediction: the readout-only index of x."""
        return self.build_index(self.featurize(x), blocked=False)

    def predict_from_buckets(self, index: TableIndex,
                             tables: torch.Tensor) -> torch.Tensor:
        """Readout half of prediction: (n_query,) or (n_query, k)."""
        return self.readout(index, tables)

    def predict_batched(self, tables: torch.Tensor, x_test, *,
                        batch_size: int | None = None) -> torch.Tensor:
        """Predictions at x_test from the tables, in blocks of
        ``batch_size`` points (peak memory O(batch_size * m)); one
        ``predict.block`` sample a block (the whole of x_test is one)."""
        x_test = as_tensor(x_test, self.device)
        n = x_test.shape[0]
        if batch_size is None or batch_size >= n:
            with _BLOCK():
                return self.predict_from_buckets(
                    self.featurize_buckets(x_test), tables)
        out = []
        for i in range(0, n, batch_size):
            with _BLOCK():
                out.append(self.predict_from_buckets(
                    self.featurize_buckets(x_test[i:i + batch_size]), tables))
        return torch.cat(out)


def make_operator(lsh: LSHParams, bucket: BucketFn, table_size: int, *,
                  device=None, fused: bool = True) -> WLSHOperator:
    """An operator on ``device`` (None: the card; raises without one).
    ``fused=False`` keeps the split matvec reachable for A/B runs."""
    dev = resolve_device(device)
    return WLSHOperator(lsh=lsh.to(dev), bucket=bucket,
                        table_size=int(table_size), fused=fused)
