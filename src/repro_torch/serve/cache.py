"""Bucket-exact prediction cache.

A WLSH prediction depends on a query point only through its per-instance
bucket structure: readout is ``(1/m) sum_s coeff[s] * tables[s, slot[s]]``
with ``slot``/``sign`` pure functions of the m bucket ids ``(key1, key2)``
and — for the rect bucket fn (random binning, the paper's §5 serving choice)
— ``weight ≡ 1``, so ``coeff = sign`` is too.  Caching on the m-tuple of
bucket ids is therefore EXACT for rect: any two queries landing in the same
m buckets have bitwise-identical predictions, so near-duplicate traffic hits
without approximation.  For the smooth bucket fns the weight varies inside a
bucket, so the key additionally folds in the residual bytes — hits then
require an identical featurization (still exact, just only for repeated
points).

The key is computed HOST-SIDE in numpy, replicating core/lsh.featurize's
integer pipeline bit-for-bit (float32 IEEE sub/div/round, uint32 wraparound
linear hash + murmur3 finalizer; pinned against the port's featurize and
the JAX package's by tests/test_torch_serving.py).  That is the entire point: a
cache hit costs one small numpy evaluation plus a dict probe (microseconds)
and never reaches the device.

A copy of the JAX package's module (which imports JAX through its core),
taking the port's ``LSHParams`` (tensors) and ``BucketFn``.
``keys_with_touch`` gives the sharded tier's key: the bucket key and the
data shards a row's slots touch, in one hash pass.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from ..core.bucket_fns import BucketFn
from ..core.lsh import LSHParams

# murmur3 finalizer constants: must match core/lsh._fmix32
_C1 = np.uint32(0x85EB_CA6B)
_C2 = np.uint32(0xC2B2_AE35)


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * _C1
    x = x ^ (x >> np.uint32(13))
    x = x * _C2
    x = x ^ (x >> np.uint32(16))
    return x


class BucketKeyFn:
    """Host-side bucket-id keys for query rows, one opaque ``bytes`` per row.

    ``exact_within_bucket`` is True for rect (weight constant inside a
    bucket): keys are then purely the m (key1, key2) pairs and any
    same-bucket query hits.  Otherwise the float32 residual bytes ride along
    in the key, restricting hits to bitwise-identical featurizations.
    """

    def __init__(self, lsh: LSHParams, bucket: BucketFn):
        w, z, r1, r2 = (t.detach().cpu().numpy() for t in lsh)
        self.w = np.ascontiguousarray(w, np.float32)   # (m, d)
        self.z = np.ascontiguousarray(z, np.float32)
        # both universal-hash coefficient sets stacked: one multiply + one
        # wrapping sum + one fmix sweep produce key1 AND key2 (the hit path
        # is numpy-dispatch-bound, so op count is latency)
        self.r12 = np.stack([np.asarray(r1, np.uint32),
                             np.asarray(r2, np.uint32)])  # (2, m, d)
        self.exact_within_bucket = bucket.name == "rect"

    def bucket_ids(self, x: np.ndarray):
        """(keys, h, t): keys is (2, n, m) uint32 — [key1; key2] — plus the
        (n, m, d) rounded buckets / scaled positions.  A numpy mirror of
        core/lsh.featurize's hash pipeline (same IEEE f32 sub/div/round, same
        uint32 wraparound), so ids agree bitwise with the device path."""
        x = np.asarray(x, np.float32)
        # NaN/inf queries reach the f32->int32 cast below; the resulting
        # rows are keyed by raw identity in __call__, so silence the cast's
        # RuntimeWarning here instead of spamming (or, under -W error,
        # crashing) the serving path
        with np.errstate(invalid="ignore"):
            t = (x[:, None, :] - self.z) / self.w      # (n, m, d) f32
            h = np.rint(t)                             # round-half-even, f32
            hi = h.astype(np.int32).view(np.uint32)    # same bits, no copy
        keys = _fmix32_np((hi[None] * self.r12[:, None]).sum(
            axis=-1, dtype=np.uint32))                 # (2, n, m)
        return keys, h, t

    def __call__(self, x: np.ndarray) -> list[bytes]:
        x = np.asarray(x, np.float32)
        keys, h, t = self.bucket_ids(x)
        n = keys.shape[1]
        # rows whose bucket coordinate leaves the well-defined f32->int32
        # range (NaN/inf or |h| >= 2^31) hash DIFFERENTLY in numpy and on
        # the device (numpy collapses them all to 0x80000000; featurize
        # saturates), so two
        # distinct garbage queries could alias one numpy key — such rows are
        # keyed by raw row identity instead: identical queries still hit,
        # distinct ones can never collide
        with np.errstate(invalid="ignore"):
            ok = (np.isfinite(h).all(axis=(1, 2))
                  & (np.abs(h) < 2147483648.0).all(axis=(1, 2)))
        if self.exact_within_bucket:
            if n == 1 and ok[0]:                       # serving fast path
                return [keys.tobytes()]
            out = [keys[:, i, :].tobytes() for i in range(n)]
        else:
            resid = h - t                              # weight varies in-bucket
            out = [keys[:, i, :].tobytes() + resid[i].tobytes()
                   for i in range(n)]
        for i in np.nonzero(~ok)[0]:
            out[i] = b"!raw" + x[i].tobytes()
        return out

    def keys_with_touch(self, x: np.ndarray, *, table_size: int,
                        n_shards: int):
        """Per-row ``(bucket key, touched-shard tuple)`` in ONE hash pass.

        The touched shards are the owners of the row's m table slots
        (``slot = key1 & (table_size-1)``, owner ``slot // spp``: the
        hash-join layout of core/distributed.py): a sharded prediction
        depends on nothing else, so the sharded cache key only changes when
        one of THOSE shards' table pieces changes.  Rows whose bucket
        coordinates leave the well-defined f32->int32 range are keyed by
        raw identity (as in ``__call__``) and touch every shard."""
        x = np.asarray(x, np.float32)
        keys, h, t = self.bucket_ids(x)
        n = keys.shape[1]
        with np.errstate(invalid="ignore"):
            ok = (np.isfinite(h).all(axis=(1, 2))
                  & (np.abs(h) < 2147483648.0).all(axis=(1, 2)))
        if self.exact_within_bucket:
            out = [keys[:, i, :].tobytes() for i in range(n)]
        else:
            resid = h - t
            out = [keys[:, i, :].tobytes() + resid[i].tobytes()
                   for i in range(n)]
        owners = (keys[0] & np.uint32(table_size - 1)) \
            // np.uint32(table_size // n_shards)            # (n, m)
        every = tuple(range(n_shards))
        touched = [every if not ok[i]
                   else tuple(np.unique(owners[i]).tolist())
                   for i in range(n)]
        for i in np.nonzero(~ok)[0]:
            out[i] = b"!raw" + x[i].tobytes()
        return list(zip(out, touched))


class PredictionCache:
    """Thread-safe LRU from bucket key -> stored prediction row.

    Values are whatever the cold path produced (numpy scalars or (k,) rows,
    already denormalized) — a hit replays them verbatim, which is what the
    bitwise cache == cold-path test pins.  ``max_entries`` bounds memory;
    eviction is least-recently-USED (hits refresh recency).
    """

    def __init__(self, max_entries: int = 65536):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self.max_entries = int(max_entries)
        self._data: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_many(self, keys: list[bytes]) -> list[np.ndarray | None]:
        """One locked pass: per-key value or None (miss)."""
        out: list[np.ndarray | None] = []
        with self._lock:
            for key in keys:
                val = self._data.get(key)
                if val is None:
                    self.misses += 1
                else:
                    self._data.move_to_end(key)
                    self.hits += 1
                out.append(val)
        return out

    def put_many(self, keys: list[bytes], values) -> None:
        with self._lock:
            for key, val in zip(keys, values):
                self._data[key] = val
                self._data.move_to_end(key)
            while len(self._data) > self.max_entries:
                self._data.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        """Drop every entry (stat counters keep accumulating)."""
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._data), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "hit_rate": self.hits / total if total else 0.0}
