"""Achieved-overlap attribution: how much comm actually hid under compute
(a copy of ``repro.pipeline.overlap``).

The planner *predicts* overlap (``waves.predict_pipeline``); this module
*measures* it from a captured :class:`~repro_torch.observe.trace.Trace` by
pure interval arithmetic: a collective's **hidden** time is the part of
its span that intersects the union of compute spans (``lags/bwd/...``
events, plus ``lags/fwd`` for async1 where the exchange runs against the
next step's forward), and its **exposed** time is the rest.  Predicted
vs achieved overlap — not just comm totals — is what bench_runtime
asserts on the deterministic fake-trace backend, and what
``repro_torch.observe.check --min-overlap`` gates in CI.

``emit_metrics`` publishes the report as the ``lags/overlap/...`` gauge
family on the train plane:

  * ``train_overlap_frac{mode,source}`` — hidden/total comm fraction
    (``source`` = ``achieved`` | ``predicted``);
  * ``train_overlap_comm_seconds{kind,span,mode}`` — exposed vs hidden
    seconds per collective, ``span`` = ``lags/overlap/<label>``.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.observe import names


def _union(spans: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge possibly-overlapping spans into disjoint sorted intervals."""
    out: list[tuple[float, float]] = []
    for lo, hi in sorted(s for s in spans if s[1] > s[0]):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _hidden_len(span: tuple[float, float],
                union: Sequence[tuple[float, float]]) -> float:
    lo, hi = span
    return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in union)


def overlap_report(trace, *, include_forward: bool = False) -> dict:
    """Per-collective and total exposed/hidden comm seconds.

    ``include_forward`` adds the ``fwd`` span to the compute union — the
    right setting for ``pipeline="async1"`` traces, where step-N comm
    legitimately hides under step-N+1 forward compute.
    """
    comm: list[tuple] = []
    compute: list[tuple[float, float]] = []
    for e in trace.events:
        parsed = names.parse(e.name)
        if parsed is None:
            continue
        if parsed["type"] == "comm":
            comm.append((e, parsed))
        elif parsed["type"] == "bwd" or (include_forward
                                         and parsed["type"] == "fwd"):
            compute.append((e.t_start, e.t_start + e.dur))
    union = _union(compute)
    per_comm = []
    for e, parsed in comm:
        hid = _hidden_len((e.t_start, e.t_start + e.dur), union)
        per_comm.append({"label": parsed["label"], "tier": parsed["tier"],
                         "t_comm": e.dur, "hidden_s": hid,
                         "exposed_s": max(0.0, e.dur - hid)})
    comm_s = sum(r["t_comm"] for r in per_comm)
    hidden_s = sum(r["hidden_s"] for r in per_comm)
    exposed_s = max(0.0, comm_s - hidden_s)
    return {"comm_s": comm_s, "hidden_s": hidden_s, "exposed_s": exposed_s,
            "overlap": hidden_s / comm_s if comm_s > 0 else 1.0,
            "per_comm": per_comm}


def emit_metrics(report: dict, registry, *, mode: str,
                 source: str = "achieved") -> None:
    """Publish an ``overlap_report`` (or a planner-predicted stand-in
    with an ``overlap`` key) onto the train metrics plane."""
    frac = registry.gauge(
        "train_overlap_frac",
        "fraction of exchange comm hidden under compute",
        labelnames=("mode", "source"))
    frac.set(float(report["overlap"]), mode=mode, source=source)
    per = report.get("per_comm") or ()
    if per:
        secs = registry.gauge(
            "train_overlap_comm_seconds",
            "per-collective exposed vs hidden comm seconds",
            labelnames=("kind", "span", "mode"))
        for r in per:
            span = names.overlap_name(r["label"])
            secs.set(float(r["exposed_s"]), kind="exposed", span=span,
                     mode=mode)
            secs.set(float(r["hidden_s"]), kind="hidden", span=span,
                     mode=mode)
