"""Trace events -> the measurements the autotune pipeline consumes (a
copy of ``repro.observe.attribution``).

This is the bridge that turns a :class:`~repro_torch.observe.trace.Trace`
(real or fake) into the two inputs Eq. 18 planning actually wants:

  * :func:`comm_samples` — per-bucket/collective events become
    ``profiler.CommSample``\\ s, the exact type ``costfit.fit_alpha_beta``
    and ``runtime.hier.tier_hardware`` already consume.  Each sample
    carries its tier/label so hierarchical fits can filter per tier.
  * :func:`attribute_leaves` / :func:`backward_times` — per-leaf ``bwd``
    events become **measured** ``LeafSample.t_backward`` budgets,
    replacing the FLOPs-share apportionment of
    ``profiler.apportion_backward``.  The heuristic stays as the
    explicit fallback: leaves the trace did not cover keep an
    apportioned share, and a trace with no backward events at all
    degrades to exactly the old behaviour.

Durations for a leaf/bucket that appears in several events (multiple
instrumented steps in one capture) are averaged, not summed, so a
multi-step capture still yields per-step budgets.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

from repro_torch.autotune import profiler
from repro_torch.observe import names
from repro_torch.observe.trace import Trace


def _parsed(trace: Trace):
    for ev in trace.events:
        info = names.parse(ev.name)
        if info is not None:
            yield ev, info


def comm_samples(trace: Trace, tier: str | None = None) -> list:
    """Per-collective ``profiler.CommSample``\\ s from a trace.

    ``tier=None`` returns every tier's samples; pass ``"flat"`` /
    ``"inner"`` / ``"outer"`` to fit one tier's wire in isolation (a
    joint fit over two wires is meaningless).  Samples with no payload
    metadata (``nbytes<=0`` or ``p<=1``) are dropped — they cannot be
    normalized to an (msg_bytes, t) point.
    """
    out = []
    for ev, info in _parsed(trace):
        if info["type"] != "comm":
            continue
        if tier is not None and info["tier"] != tier:
            continue
        if info["nbytes"] <= 0 or info["p"] <= 1:
            continue
        out.append(profiler.CommSample(
            kind=info["kind"], nbytes=float(info["nbytes"]),
            p=int(info["p"]), t=float(ev.dur),
            label=f"{info['tier']}/{info['label']}"))
    return out


def comm_tiers(trace: Trace) -> tuple[str, ...]:
    """Tiers that contributed at least one usable collective sample."""
    seen = []
    for ev, info in _parsed(trace):
        if (info["type"] == "comm" and info["nbytes"] > 0
                and info["p"] > 1 and info["tier"] not in seen):
            seen.append(info["tier"])
    return tuple(seen)


def backward_times(trace: Trace) -> dict[str, float]:
    """{leaf path: mean measured backward seconds} from ``bwd`` events."""
    total: dict[str, float] = collections.defaultdict(float)
    count: dict[str, int] = collections.defaultdict(int)
    for ev, info in _parsed(trace):
        if info["type"] == "bwd" and ev.dur > 0.0:
            total[info["leaf"]] += ev.dur
            count[info["leaf"]] += 1
    return {leaf: total[leaf] / count[leaf] for leaf in total}


def _mean_dur(trace: Trace, name: str) -> float:
    durs = [ev.dur for ev in trace.events if ev.name == name]
    return sum(durs) / len(durs) if durs else 0.0


def step_time(trace: Trace) -> float:
    """Mean duration of the ``lags/step`` events (0.0 when absent)."""
    return _mean_dur(trace, names.STEP)


def forward_time(trace: Trace) -> float:
    return _mean_dur(trace, names.FWD)


def overlap_report(trace: Trace, *, include_forward: bool = False) -> dict:
    """Achieved comm-overlap attribution for one captured step: how much
    of each collective's duration ran *under* backward (optionally also
    forward) compute, and how much stuck out (was exposed).

    Thin delegation to :func:`repro_torch.pipeline.overlap.overlap_report`
    (lazy import — attribution stays usable without the pipeline
    package loaded); lives here because it is the same trace->evidence
    direction as :func:`comm_samples` / :func:`backward_times`, and the
    replan controller reads its telemetry through this module.
    """
    from repro_torch.pipeline import overlap as PO
    return PO.overlap_report(trace, include_forward=include_forward)


def attribute_leaves(leaves: Sequence, trace: Trace, *,
                     t_backward_total: float | None = None) -> tuple:
    """Leaves with **measured** per-leaf backward budgets where the trace
    has them, FLOPs-share apportionment everywhere else.

    ``leaves`` is the backprop-ordered ``profiler.LeafSample`` template.
    When ``t_backward_total`` is given, the un-measured leaves split the
    *remainder* (total minus the measured mass, floored at 0) by FLOPs
    share — so a partial trace never double-counts backward time.  With
    no total and no measured events the input is returned unchanged
    (the caller's existing budgets are already the fallback).
    """
    measured = backward_times(trace)
    if not measured:
        if t_backward_total is not None:
            return profiler.apportion_backward(leaves, t_backward_total)
        return tuple(leaves)
    rest = [l for l in leaves if l.name not in measured]
    rest_times: dict[str, float] = {}
    if rest:
        if t_backward_total is not None:
            got = sum(measured[l.name] for l in leaves if l.name in measured)
            remainder = max(0.0, t_backward_total - got)
            rest_times = {l.name: l.t_backward for l in
                          profiler.apportion_backward(rest, remainder)}
        else:
            rest_times = {l.name: l.t_backward for l in rest}
    return tuple(
        dataclasses.replace(l, t_backward=measured.get(
            l.name, rest_times.get(l.name, l.t_backward)))
        for l in leaves)
