"""Trace capture around instrumented train steps: the port of
``repro.observe.trace`` on ``torch.profiler``.

Two backends produce the same artifact — a :class:`Trace` of named
:class:`TraceEvent`\\ s using the ``repro_torch.observe.names`` grammar —
so everything downstream (:mod:`repro_torch.observe.attribution`, the
runtime controller, benchmarks) is backend-agnostic:

  * :class:`FakeTraceBackend` — **deterministic** synthesis from the α–β
    cost model: per-leaf backward events from measured budgets, per-leaf
    collective events priced on the live wire, and a step event from the
    pipelined LAGS timeline (``cm.iteration_time_lags``).  Benchmarks
    and tests need an *injectable* wire, which a real capture cannot
    give.
  * :func:`capture_trace` — real ``torch.profiler`` capture around N
    calls of a step function.  The collectives in ``core.lags`` run
    under ``record_function`` ranges carrying the same names, so a real
    trace groups them per bucket/collective.  ``torch.profiler`` writes
    chrome-trace JSON itself, which :func:`_events_from_chrome_obj`
    parses (``meta["decoder"] == "chrome"``); there is no XPlane to
    decode.

``annotation(name)`` and ``device_annotation(name)`` are both
``torch.profiler.record_function``: PyTorch has one primitive, a host
range; :func:`capture_trace` times it on the device through the work it
launched.
"""
from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
import os
from typing import Any, Callable, Sequence

from repro_torch import block_until_ready
from repro_torch.core import comm_model as cm
from repro_torch.observe import names


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One named span: ``t_start``/``dur`` in seconds on a common clock."""
    name: str
    t_start: float
    dur: float


@dataclasses.dataclass(frozen=True)
class Trace:
    """A bag of events plus provenance; JSON round-trippable."""
    events: tuple[TraceEvent, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    def named(self, prefix: str) -> list[TraceEvent]:
        return [e for e in self.events if e.name.startswith(prefix)]

    def to_json(self) -> str:
        return json.dumps({"meta": self.meta,
                           "events": [dataclasses.asdict(e)
                                      for e in self.events]},
                          indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Trace":
        obj = json.loads(text)
        return Trace(events=tuple(TraceEvent(**e) for e in obj["events"]),
                     meta=dict(obj.get("meta", {})))


def export_chrome_trace(trace: Trace, path: str) -> str:
    """Write ``trace`` as Perfetto-loadable chrome-trace-format JSON.

    The inverse of :func:`_parse_chrome_trace`: every event becomes a
    complete ``"ph": "X"`` slice with ``ts``/``dur`` in microseconds, so
    a FakeTraceBackend synthesis (wave/overlap events included) opens in
    ``ui.perfetto.dev`` / ``chrome://tracing`` and round-trips through
    ``_events_from_chrome_obj`` unchanged.  Trace meta rides in
    ``otherData``; ``.gz`` paths are gzip-compressed.  Returns ``path``.
    """
    obj = {
        "traceEvents": [
            {"name": e.name, "ph": "X", "pid": 0, "tid": 0,
             "ts": e.t_start * 1e6, "dur": e.dur * 1e6,
             "cat": (names.parse(e.name) or {}).get("type", "span")}
            for e in trace.events
        ],
        "displayTimeUnit": "ms",
        "otherData": dict(trace.meta),
    }
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(obj, f)
    return path


def annotation(name: str):
    """Host-side profiler range (``torch.profiler.record_function``; a
    no-op unless a profiler is recording)."""
    from torch.profiler import record_function
    return record_function(name)


def device_annotation(name: str):
    """The range that names the device work launched under it: the same
    ``record_function`` (a capture finds that work through the launches'
    correlation ids, :func:`_device_spans`)."""
    return annotation(name)


# ---------------------------------------------------------------------------
# real backend: torch.profiler capture
# ---------------------------------------------------------------------------

#: chrome-trace categories: a ``record_function`` range on the host, the
#: runtime calls that launch device work, and the device work itself
HOST_CATEGORY = "user_annotation"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_spans(obj: dict) -> tuple[dict, dict]:
    """The grammar-named ranges of a ``torch.profiler`` chrome trace, one
    per range on the host, each timed on the device where it launched
    device work, and what was kept.

    A ``record_function`` range is recorded on the host, where an
    ``async_op=True`` collective's range covers only its enqueue; the
    profiler names device work after the innermost range only (NCCL's
    own ``nccl:*`` range sits inside ours).  So a range's device span is
    the envelope of the device work (kernels, copies, sets) whose launch
    (the runtime call with the same ``correlation``) falls inside the
    range on the host.  A range that launched nothing — every range on
    the CPU, an in-place all-reduce at world size 1 — keeps its host
    duration.  Returns (a chrome-trace dict of the chosen ranges, the
    counts ``{"user_annotation": host-timed, "device": device-timed,
    "device_comm": device-timed lags/comm ranges}``)."""
    ranges, launches, work = [], {}, []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") not in (None, "X"):
            continue
        cat = ev.get("cat", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat == HOST_CATEGORY and names.parse(ev.get("name", "")):
            ranges.append(ev)
        elif cat in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = float(ev.get("ts", 0.0))
        elif cat in DEVICE_CATEGORIES and corr is not None:
            work.append(ev)
    # each device activity at the host time of its launch
    placed = sorted((launches[w["args"]["correlation"]],
                     float(w.get("ts", 0.0)),
                     float(w.get("ts", 0.0)) + float(w.get("dur", 0.0)))
                    for w in work if w["args"]["correlation"] in launches)
    keys = [p[0] for p in placed]
    kept, counts = [], {HOST_CATEGORY: 0, "device": 0, "device_comm": 0}
    for ev in ranges:
        lo = float(ev.get("ts", 0.0))
        hi = lo + float(ev.get("dur", 0.0))
        inside = placed[bisect.bisect_left(keys, lo):
                        bisect.bisect_right(keys, hi)]
        if inside:
            start = min(p[1] for p in inside)
            end = max(p[2] for p in inside)
            kept.append({"name": ev["name"], "ph": "X", "ts": start,
                         "dur": end - start})
            counts["device"] += 1
            counts["device_comm"] += ev["name"].startswith(names.COMM_PREFIX)
        else:
            kept.append({"name": ev["name"], "ph": "X", "ts": lo,
                         "dur": hi - lo})
            counts[HOST_CATEGORY] += 1
    kept.sort(key=lambda e: e["ts"])
    return {"traceEvents": kept}, counts


def capture_trace(step_fn: Callable, *args, log_dir: str,
                  steps: int = 1) -> Trace:
    """Run ``step_fn(*args)`` ``steps`` times under ``torch.profiler``
    (CPU activity, and CUDA when a card is visible), each call inside a
    ``record_function(names.STEP)`` range; export the chrome trace to
    ``<log_dir>/trace.json`` and parse it.

    Events come one per range (:func:`_device_spans`): device spans
    where the range launched device work, host durations otherwise — on
    the CPU (the tests) there are only host ranges, and an
    ``async_op=True`` collective's host range is its enqueue, not its
    wire time.  ``meta["categories"]`` counts the events timed each way;
    ``meta["decoder"]`` is ``"chrome"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = None
    with profile(activities=activities) as prof:
        for _ in range(steps):
            with record_function(names.STEP):
                out = step_fn(*args)
        block_until_ready(out)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chosen, counts = _device_spans(json.load(f))
    events = _events_from_chrome_obj(chosen)
    return Trace(events=tuple(events),
                 meta={"backend": "torch.profiler", "trace_dir": log_dir,
                       "steps": int(steps), "parsed": bool(events),
                       "decoder": "chrome", "categories": counts})


def _events_from_chrome_obj(obj: dict) -> list[TraceEvent]:
    """Chrome-trace-format dict -> grammar-named events (``ts``/``dur``
    in µs)."""
    out = []
    for ev in obj.get("traceEvents", []):
        name = ev.get("name", "")
        if names.parse(name) is None or ev.get("ph") not in (None, "X"):
            continue
        out.append(TraceEvent(name=name,
                              t_start=float(ev.get("ts", 0.0)) * 1e-6,
                              dur=float(ev.get("dur", 0.0)) * 1e-6))
    return out


def _parse_chrome_trace(path: str) -> list[TraceEvent]:
    """Best-effort chrome-trace-format parse."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        obj = json.load(f)
    return _events_from_chrome_obj(obj)


# ---------------------------------------------------------------------------
# deterministic fake backend (CPU / CI)
# ---------------------------------------------------------------------------

class FakeTraceBackend:
    """Synthesizes the trace an annotated step *would* produce.

    Deterministic by construction — durations come from the α–β model of
    the **live** wires, so CI can inject a mid-run bandwidth regression
    by mutating ``wires`` and every downstream consumer (attribution →
    costfit → planner, the anomaly detector) sees exactly the physics
    the injection implies, with zero wall-clock noise.

    Args:
      leaves: backprop-ordered objects with ``name``/``d``/``t_backward``
        (``profiler.LeafSample`` — budgets are the per-leaf backward
        durations emitted as ``bwd`` events).
      wires: ``{tier: cm.Hardware}`` — a LIVE mapping; callers mutate it
        to shift a tier's wire mid-run.
      tier_workers: ``{tier: worker count}`` for the same tiers.
      t_forward: forward-pass duration (seconds) for the ``fwd`` event.
      schedule_fn: ``() -> Schedule | HierSchedule | None`` — the live
        plan; per-leaf ratios price each tier's collective (a flat
        schedule prices the ``flat``/``outer`` tier; ``None`` falls back
        to ``static_ratio``, today's uniform ``cfg.compression_ratio``).
      static_ratio: ratio used when no schedule is live (1.0 = dense).
      wave_fn: optional ``() -> repro.pipeline.WaveSchedule | None`` —
        when it returns a schedule, :meth:`capture` synthesizes the
        *wave-pipelined* step instead: one aggregated collective per
        (wave, tier) — allreduce for the wave's dense leaves, allgather
        for its sparse ones — starting at ``max(wave readiness, wire
        free)`` (``pipeline="async1"`` drops the readiness gate: the
        payload is the previous step's), and the step event ends at
        ``max(compute end, last wire end)``.  ``None`` (the default, and
        a ``wave_fn`` returning None) keeps the classic per-leaf
        synthesis byte-for-byte.
    """

    def __init__(self, leaves: Sequence, wires: dict,
                 tier_workers: dict, *, t_forward: float,
                 schedule_fn: Callable[[], Any] | None = None,
                 static_ratio: float = 1.0,
                 wave_fn: Callable[[], Any] | None = None):
        self.leaves = tuple(leaves)
        self.wires = wires
        self.tier_workers = dict(tier_workers)
        self.t_forward = float(t_forward)
        self.schedule_fn = schedule_fn or (lambda: None)
        self.static_ratio = float(static_ratio)
        self.wave_fn = wave_fn or (lambda: None)

    def _tier_ratios(self) -> dict[str, dict[str, float]]:
        sched = self.schedule_fn()
        fallback = {l.name: self.static_ratio for l in self.leaves}
        if sched is None:
            return {t: fallback for t in self.wires}
        tiers = getattr(sched, "tiers", None)
        if tiers is not None:
            by_tier = {t: {lp.name: lp.ratio for lp in s.leaves}
                       for t, s in tiers.items()}
            # the inner tier of a HierSchedule prices "inner"; anything
            # else (flat/outer wires) prices on the sparse outer tier
            return {t: by_tier.get("inner" if t == "inner" else "outer",
                                   fallback)
                    for t in self.wires}
        flat = {lp.name: lp.ratio for lp in sched.leaves}
        # a flat schedule plans the sparse exchange: price the flat/outer
        # wires with it; an intra-pod tier it never planned stays static
        return {t: (fallback if t == "inner" else flat) for t in self.wires}

    def _comm_event(self, leaf, tier: str, ratio: float,
                    t_start: float) -> TraceEvent | None:
        p = int(self.tier_workers.get(tier, 1))
        if p <= 1:
            return None
        hw = self.wires[tier]
        if ratio <= 1.0:
            kind, nbytes = "allreduce", 4.0 * leaf.d
            t = cm.allreduce_time(nbytes, p, hw)
        else:
            k = max(1, int(round(leaf.d / ratio)))
            kind, nbytes = "allgather", 8.0 * k   # fp32 values + int32 idx
            t = cm.allgather_time(nbytes, p, hw)
        return TraceEvent(
            name=names.comm_name(tier, kind, leaf.name, nbytes=nbytes, p=p),
            t_start=t_start, dur=t)

    def _capture_waves(self, waves, ratios, step: int) -> Trace:
        """Wave-pipelined synthesis (see ``wave_fn``): collectives start
        when their wave's last gradient lands AND the tier's wire is
        free; exposed comm is whatever sticks out past compute."""
        by_name = {l.name: l for l in self.leaves}
        events = [TraceEvent(names.FWD, 0.0, self.t_forward)]
        clock = self.t_forward
        ready: dict[str, float] = {}
        for leaf in self.leaves:
            events.append(TraceEvent(names.bwd_name(leaf.name), clock,
                                     leaf.t_backward))
            clock += leaf.t_backward
            ready[leaf.name] = clock
        comp_end = clock
        asynchronous = getattr(waves, "pipeline", "wave") == "async1"
        wire_clock = {t: 0.0 for t in self.wires}
        for w_no, wave in enumerate(waves.waves):
            wleaves = [by_name[nm] for nm in wave.names if nm in by_name]
            if not wleaves:
                continue
            # async1 ships the PREVIOUS step's payload: nothing to wait on
            t_ready = (0.0 if asynchronous
                       else max(ready[l.name] for l in wleaves))
            label = f"wave{w_no}"
            for tier in self.wires:
                p = int(self.tier_workers.get(tier, 1))
                if p <= 1:
                    continue
                hw = self.wires[tier]
                dense_d = sparse_k = 0
                for l in wleaves:
                    r = ratios[tier].get(l.name, 1.0)
                    if r <= 1.0:
                        dense_d += l.d
                    else:
                        sparse_k += max(1, int(round(l.d / r)))
                start = max(t_ready, wire_clock[tier])
                if dense_d:
                    nbytes = 4.0 * dense_d
                    t = cm.allreduce_time(nbytes, p, hw)
                    events.append(TraceEvent(
                        names.comm_name(tier, "allreduce", label,
                                        nbytes=nbytes, p=p), start, t))
                    start += t
                if sparse_k:
                    nbytes = 8.0 * sparse_k   # fp32 values + int32 idx
                    t = cm.allgather_time(nbytes, p, hw)
                    events.append(TraceEvent(
                        names.comm_name(tier, "allgather", label,
                                        nbytes=nbytes, p=p), start, t))
                    start += t
                wire_clock[tier] = start
        t_step = max(comp_end, max(wire_clock.values(), default=comp_end))
        events.insert(0, TraceEvent(names.STEP, 0.0, t_step))
        return Trace(events=tuple(events),
                     meta={"backend": "fake", "step": int(step),
                           "pipeline": getattr(waves, "pipeline", "wave")})

    def capture(self, step: int = 0) -> Trace:
        """One instrumented step's worth of events (pure function of the
        live wires/schedule — the ``step`` argument is provenance only)."""
        ratios = self._tier_ratios()
        waves = self.wave_fn()
        if waves is not None:
            return self._capture_waves(waves, ratios, step)
        events = [TraceEvent(names.FWD, 0.0, self.t_forward)]
        clock = self.t_forward
        t_b, t_c = [], []
        for leaf in self.leaves:
            events.append(TraceEvent(names.bwd_name(leaf.name), clock,
                                     leaf.t_backward))
            clock += leaf.t_backward
            leaf_comm = 0.0
            for tier in self.wires:
                ev = self._comm_event(leaf, tier,
                                      ratios[tier].get(leaf.name, 1.0),
                                      clock)
                if ev is not None:
                    events.append(ev)
                    leaf_comm += ev.dur
            t_b.append(leaf.t_backward)
            t_c.append(leaf_comm)
        t_step = cm.iteration_time_lags(self.t_forward, t_b, t_c)
        events.insert(0, TraceEvent(names.STEP, 0.0, t_step))
        return Trace(events=tuple(events),
                     meta={"backend": "fake", "step": int(step)})
