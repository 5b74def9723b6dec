"""Small-message merging (§5, first optimization), a copy of
``repro.core.bucketing`` (numpy only).

Layer-wise sparsified tensors can be tiny; collectives with tiny payloads
are latency-bound.  The paper buffers sparsified gradients and flushes when
the buffer fills or the first layer's gradients arrive.  The grouping is
computed once, at build time, from the per-layer k's: consecutive layers
(in backprop order) are grouped until the bucket reaches ``target_bytes``.
One sparse all-gather is issued per bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# dtypes numpy only knows with ml_dtypes registered (jax brings it, but
# this module must not require it)
_ITEMSIZE_FALLBACK = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def payload_bytes_per_elem(value_dtype="float32",
                           index_bytes: int = 4) -> int:
    """Wire bytes per kept element: one value + one int32 index.

    The sparse exchange ships (values, indices) pairs, so the payload
    depends on the *value* dtype — 8 B/elem for fp32 values but 6 B/elem
    for bf16; a hard-coded 8 over-sizes bf16 buckets by a third."""
    try:
        item = np.dtype(value_dtype).itemsize
    except TypeError:
        item = _ITEMSIZE_FALLBACK[str(value_dtype)]
    return int(item) + int(index_bytes)


@dataclasses.dataclass(frozen=True)
class Bucket:
    layer_indices: tuple[int, ...]   # indices into the backprop-ordered layer list
    nbytes: int


def assign_buckets(ks: Sequence[int], target_bytes: int = 1 << 20,
                   bytes_per_elem: int | None = None, *,
                   value_dtype="float32") -> list[Bucket]:
    """Greedy size-targeted grouping of backprop-ordered layers.

    ``bytes_per_elem`` is derived from ``value_dtype`` (+ int32 index)
    unless given explicitly."""
    if bytes_per_elem is None:
        bytes_per_elem = payload_bytes_per_elem(value_dtype)
    buckets: list[Bucket] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, k in enumerate(ks):
        nb = int(k) * bytes_per_elem
        if cur and cur_bytes + nb > target_bytes:
            buckets.append(Bucket(tuple(cur), cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(Bucket(tuple(cur), cur_bytes))
    return buckets


def bucket_stats(buckets: Sequence[Bucket]) -> dict:
    sizes = [b.nbytes for b in buckets]
    return {
        "n_buckets": len(buckets),
        "min_bytes": min(sizes) if sizes else 0,
        "max_bytes": max(sizes) if sizes else 0,
        "mean_bytes": sum(sizes) / len(sizes) if sizes else 0,
    }
