"""Wave planning: group leaves by wire payload, and the predicted step
timeline — the counterpart of ``repro.pipeline.waves``.

``default_waves`` builds a ``WaveSchedule`` from geometry alone: leaves
walked in backprop order (reversed flatten order) and greedily grouped
by wire payload (``bucketing.payload_bytes_per_elem`` sizing, the
``assign_buckets`` close) so tiny sparse payloads amortise the
per-collective latency.  Leaf sizes come from shapes (tensors or
``Spec``s); nothing is allocated.

``predict_pipeline`` is the wave recurrence: wave w's collective starts
once its last gradient lands (``t_ready``) and the wire is free; exposed
comm is whatever sticks out past the end of compute.  ``async1``
overlaps the whole exchange with the next step's compute.

Strategies that select over the whole-model vector (``slgs``,
``wave_granularity == "model"``) get a single wave in flatten order.

``plan_waves``, the measurement-driven partition, needs the autotune
planner and is not ported yet (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import math
from typing import Any, Sequence

from repro_torch import tree
from repro_torch.core import bucketing
from repro_torch.pipeline.buckets import Wave, WaveSchedule, leaf_names

PIPELINE_MODES = ("off", "wave", "async1")
# fallback wave target when no hardware fit is available yet
DEFAULT_TARGET_BYTES = 1 << 18


def latency_matched_bytes(hw, amortize: float = 8.0,
                          lo: int = 1 << 14, hi: int = 1 << 24) -> int:
    """Payload at which wire time = ``amortize`` x per-collective latency
    (bytes = amortize * alpha / beta): below it waves are latency-bound,
    far above it they stop tapping backprop often enough to overlap.
    ``hw``: anything with ``alpha`` (s) and ``beta`` (s/byte)."""
    if hw is None or getattr(hw, "beta", 0.0) <= 0.0:
        return DEFAULT_TARGET_BYTES
    return int(min(hi, max(lo, amortize * hw.alpha / hw.beta)))


def _leaf_nbytes(d: int, k: int | None) -> int:
    """Wire payload for one leaf: sparse (value, index) pairs when a
    budget k < d is planned, dense fp32 otherwise."""
    if k is not None and int(k) < int(d):
        return int(k) * bucketing.payload_bytes_per_elem("float32")
    return 4 * int(d)


def _group(nbytes_seq: Sequence[int], target_bytes: int) -> list[list[int]]:
    """``bucketing.assign_buckets``'s greedy close over positions."""
    return [list(b.layer_indices) for b in bucketing.assign_buckets(
        nbytes_seq, target_bytes, bytes_per_elem=1)]


def predict_pipeline(waves: Sequence[Wave], *, t_forward: float,
                     t_backward: float, pipeline: str) -> dict:
    """Predicted step timeline for a wave partition."""
    t_comm = sum(w.t_comm for w in waves)
    comp_end = t_forward + t_backward
    if pipeline == "async1":
        # step-N exchange runs against step-N+1 forward+backward
        t_step = max(comp_end, t_comm)
        exposed = max(0.0, t_comm - comp_end)
    elif pipeline == "wave":
        comm_done = 0.0
        for w in waves:
            comm_done = max(comm_done, w.t_ready) + w.t_comm
        t_step = max(comp_end, comm_done)
        exposed = max(0.0, t_step - comp_end)
    else:  # "off": one monolithic post-backward exchange
        t_step = comp_end + t_comm
        exposed = t_comm
    # exposed <= t_comm holds exactly, but fp rounding can push the ratio
    # a hair past 1: clamp so the overlap is never negative
    overlap = max(0.0, 1.0 - exposed / t_comm) if t_comm > 0 else 1.0
    return {"t_step": t_step, "t_comm": t_comm, "t_forward": t_forward,
            "t_backward": t_backward, "exposed_comm": exposed,
            "overlap": overlap, "pipeline": pipeline}


def default_waves(params_like, ks: Any = None, *,
                  granularity: str = "leaf",
                  target_bytes: int | None = None,
                  pipeline: str = "wave") -> WaveSchedule:
    """Build-time wave partition from geometry alone (no measurements).

    ``ks`` is the per-leaf budget tree (``None`` = dense payloads).
    Leaves are walked in backprop order (reversed flatten order) and
    greedily grouped by wire payload."""
    names = leaf_names(params_like)
    dims = [int(math.prod(x.shape)) for x in tree.leaves(params_like)]
    flat_k = tree.leaves(ks) if ks is not None else [None] * len(names)
    n = len(names)
    order = list(range(n - 1, -1, -1))          # backprop order
    nbytes = [_leaf_nbytes(dims[i], flat_k[i]) for i in order]
    if granularity == "model":
        # whole-model selection (slgs): one wave, FLATTEN order: the
        # packed-vector strategies index the concatenation by flat id
        waves = (Wave(leaf_ids=tuple(range(n)), names=tuple(names),
                      nbytes=sum(nbytes)),)
    else:
        groups = _group(nbytes, target_bytes or DEFAULT_TARGET_BYTES)
        waves = tuple(
            Wave(leaf_ids=tuple(order[p] for p in g),
                 names=tuple(names[order[p]] for p in g),
                 nbytes=sum(nbytes[p] for p in g))
            for g in groups)
    ws = WaveSchedule(waves=waves, pipeline=pipeline,
                      meta={"source": "default", "granularity": granularity})
    ws.validate_cover(n)
    return ws


def plan_waves(*args, **kwargs) -> WaveSchedule:
    """Measurement-driven wave partition: not ported yet."""
    raise NotImplementedError(
        "plan_waves prices each leaf with the autotune planner, not "
        "ported yet (ROADMAP.md queue 1 item 10); use default_waves or "
        "pass RunConfig(waves=...)")
