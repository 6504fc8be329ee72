"""The WLSH operator: the primitive set every path of the port runs through.

    featurize       points -> Features             (hash + weight + sign)
    build_index     Features -> TableIndex         (with the slot-blocked
                                                    layout for fits)
    loads           index, beta -> (m, B) tables   (CountSketch scatter)
    readout         index, tables -> per point     (CountSketch gather)
    matvec          index, beta -> K~ beta         (fused one-pass off the
                                                    layout, or loads then
                                                    readout when split)
    featurize_buckets / predict_from_buckets / predict_batched (prediction)

There is no backend switch: the operator's tensors live on one device, and
each primitive runs the CUDA kernels on the card and their plain versions on
the CPU (see backend.py).  ``fused=False`` keeps the split matvec, and
gives a layout built by ``build_index`` the split kernels' geometry: the
distributed psum step's operator on a sharded data axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..backend import as_tensor, resolve_device
from .bucket_fns import BucketFn
from .lsh import Features, LSHParams
from .wlsh import (BLOCKED_N, BLOCKED_SPLIT_N, BLOCKED_SPLIT_T, BLOCKED_T,
                   TableIndex, build_blocked_layout, build_table_index)


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
                    parts: str = "kernel") -> TableIndex:
        """CountSketch index; ``blocked`` (None: the operator's ``fused``)
        attaches the slot-blocked layout (one sort per instance) that the
        fused matvec, the table build and the layout readout read, at the
        split geometry when the operator is not fused.  ``parts`` picks the
        layout's array groups (the hash join also needs 'reference').
        Prediction passes ``blocked=False``: it only gathers."""
        if mode != "table":
            raise NotImplementedError(f"mode {mode!r}: only 'table' is ported")
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

    def matvec(self, index: TableIndex, beta: torch.Tensor, *,
               average: bool = True) -> torch.Tensor:
        """K~ beta in O(n m) for beta (n,) or an (n, k) block: one pass over
        the slot-blocked layout when the operator is fused and the index
        has the layout's kernel group, else loads then readout."""
        from ..kernels.binning import bin_fused_matvec_op, table_matvec_op
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
        ``batch_size`` points (peak memory O(batch_size * m))."""
        x_test = as_tensor(x_test, self.device)
        n = x_test.shape[0]
        if batch_size is None or batch_size >= n:
            return self.predict_from_buckets(self.featurize_buckets(x_test),
                                             tables)
        return torch.cat([
            self.predict_from_buckets(
                self.featurize_buckets(x_test[i:i + batch_size]), tables)
            for i in range(0, n, batch_size)])


def make_operator(lsh: LSHParams, bucket: BucketFn, table_size: int, *,
                  device=None, fused: bool = True) -> WLSHOperator:
    """An operator on ``device`` (None: the card; raises without one).
    ``fused=False`` keeps the split matvec reachable for A/B runs."""
    dev = resolve_device(device)
    return WLSHOperator(lsh=lsh.to(dev), bucket=bucket,
                        table_size=int(table_size), fused=fused)
