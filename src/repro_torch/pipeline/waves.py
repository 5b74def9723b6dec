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

``plan_waves`` is the measurement-driven partition: the same
backprop-ordered ``profiler.LeafSample`` list the ratio planner takes
(measured ``t_backward``), each leaf's exchange priced with
``planner.leaf_comm_time`` at the schedule's ratio, per-wave readiness
times and the predicted timeline written into the artifact.
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


def plan_waves(leaves: Sequence, sched, p: int, hw, *,
               t_forward: float = 0.0, pipeline: str = "wave",
               granularity: str = "leaf",
               target_bytes: int | None = None,
               flat_names: Sequence[str] | None = None) -> WaveSchedule:
    """Measurement-driven wave partition + predicted timeline.

    ``leaves``: backprop-ordered ``profiler.LeafSample``-likes (``name``,
    ``d``, ``t_backward``).  ``sched``: the planned ratio ``Schedule``
    (``None`` prices every leaf dense).  ``flat_names``: leaf names in
    flatten order, to bind global ids; defaults to the reversed-backprop
    identity (exactly how ``profiler.backprop_leaves`` is built)."""
    from repro_torch.autotune import planner

    n = len(leaves)
    if flat_names is not None:
        index = {nm: i for i, nm in enumerate(flat_names)}
        ids = [index[leaf.name] for leaf in leaves]
    else:
        ids = list(range(n - 1, -1, -1))
    ratio = ({lp.name: lp.ratio for lp in sched.leaves} if sched is not None
             else {})
    ks = [None if ratio.get(leaf.name, 1.0) <= 1.0
          else max(1, int(round(leaf.d / ratio[leaf.name])))
          for leaf in leaves]
    nbytes = [_leaf_nbytes(leaf.d, k) for leaf, k in zip(leaves, ks)]
    t_c = [planner.leaf_comm_time(leaf.d, ratio.get(leaf.name, 1.0), p, hw)
           for leaf in leaves]
    # readiness clock: forward, then backward leaf by leaf
    clock = t_forward
    ready = []
    for leaf in leaves:
        clock += max(0.0, leaf.t_backward)
        ready.append(clock)
    if granularity == "model":
        # whole-model selection (slgs): one wave, FLATTEN order, ready
        # only once the entire backward pass has finished
        by_id = sorted(range(n), key=lambda pos: ids[pos])
        waves = (Wave(leaf_ids=tuple(ids[pos] for pos in by_id),
                      names=tuple(leaves[pos].name for pos in by_id),
                      nbytes=sum(nbytes), t_comm=sum(t_c),
                      t_ready=max(ready, default=t_forward)),)
    else:
        groups = _group(nbytes, target_bytes or latency_matched_bytes(hw))
        waves = tuple(
            Wave(leaf_ids=tuple(ids[pos] for pos in g),
                 names=tuple(leaves[pos].name for pos in g),
                 nbytes=sum(nbytes[pos] for pos in g),
                 t_comm=sum(t_c[pos] for pos in g),
                 t_ready=ready[g[-1]])
            for g in groups)
    t_backward = sum(max(0.0, leaf.t_backward) for leaf in leaves)
    predicted = predict_pipeline(waves, t_forward=t_forward,
                                 t_backward=t_backward, pipeline=pipeline)
    ws = WaveSchedule(waves=waves, pipeline=pipeline, predicted=predicted,
                      meta={"source": "planned", "granularity": granularity,
                            "n_workers": int(p),
                            "hardware": getattr(hw, "name", None)})
    ws.validate_cover(n)
    return ws
