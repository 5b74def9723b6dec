"""``repro_torch.observe`` — trace-driven attribution + anomaly-triggered
re-planning: the port of ``repro.observe``.

Until this package, the online loop saw whole-step wall times only:
per-leaf backward budgets came from the FLOPs-share heuristic
(``profiler.apportion_backward``), wire samples from an injectable
micro-benchmark probe, and ``ReplanController`` re-planned on a blind
fixed cadence.  ``repro.observe`` turns that controller from
cadence-driven into evidence-driven, in four pieces:

  * :mod:`~repro_torch.observe.trace` — capture around instrumented steps:
    annotation primitives (``torch.profiler.record_function`` names on
    the ``core.lags`` collectives follow the :mod:`~repro_torch.observe.names`
    grammar), a real ``torch.profiler`` capture wrapper
    (``capture_trace``), and a **deterministic fake-trace backend** for
    benchmarks that inject a wire.
  * :mod:`~repro_torch.observe.attribution` — trace events → per-bucket
    ``CommSample``\\ s (consumed by ``costfit``/``tier_hardware``) and
    **measured** per-leaf backward times (consumed by
    ``planner.plan_schedule`` / ``profiler.profile_model``), with the
    FLOPs-share heuristic demoted to explicit fallback.
  * :mod:`~repro_torch.observe.anomaly` — robust median/MAD change-point
    detector over the telemetry step window (warmup/compile-spike
    masking, fire-exactly-once, checkpointable).
  * :mod:`~repro_torch.observe.triggers` — the ``ReplanTrigger`` protocol and
    the built-ins (cadence / anomaly / hardware-fingerprint drift) the
    controller ORs together; the default set reproduces the old
    ``replan_every`` semantics bit-for-bit.
  * :mod:`~repro_torch.observe.health` — the convergence-health plane: the
    paper's theory quantities (Assumption-1 delta, EF residual energy,
    async1 staleness) computed online from what the live exchange
    already returns, plus the :class:`HealthMonitor` that turns the
    delta stream into ``health_alarm`` events and
    :class:`~repro_torch.observe.triggers.HealthTrigger` re-plans.
  * :mod:`~repro_torch.observe.metrics` /
    :mod:`~repro_torch.observe.events` — the process-wide metrics
    registry (counters/gauges/histograms over the ``names`` grammar,
    Prometheus text + JSONL snapshot exporters) and the versioned event
    bus (replan swaps, trigger firings, publishes,
    guard trips, resyncs, per-request serve records) that every
    subsystem — ``api.Session.run``, ``runtime.ReplanController`` —
    reports into; :mod:`~repro_torch.observe.check` is the
    CI validator over exported snapshots.

Import is lazy (PEP 562): ``repro_torch.core`` annotates collectives via
the leaf module ``repro_torch.observe.names`` without dragging the
autotune stack into its import graph.
"""
from __future__ import annotations

_LAZY = {
    "names": "repro_torch.observe.names",
    "trace": "repro_torch.observe.trace",
    "attribution": "repro_torch.observe.attribution",
    "anomaly": "repro_torch.observe.anomaly",
    "triggers": "repro_torch.observe.triggers",
    "metrics": "repro_torch.observe.metrics",
    "events": "repro_torch.observe.events",
    "check": "repro_torch.observe.check",
    "health": "repro_torch.observe.health",
    "HealthMonitor": ("repro_torch.observe.health", "HealthMonitor"),
    "MetricsRegistry": ("repro_torch.observe.metrics", "MetricsRegistry"),
    "save_snapshot": ("repro_torch.observe.metrics", "save_snapshot"),
    "load_snapshot": ("repro_torch.observe.metrics", "load_snapshot"),
    "EventLog": ("repro_torch.observe.events", "EventLog"),
    "Event": ("repro_torch.observe.events", "Event"),
    "Trace": ("repro_torch.observe.trace", "Trace"),
    "TraceEvent": ("repro_torch.observe.trace", "TraceEvent"),
    "FakeTraceBackend": ("repro_torch.observe.trace", "FakeTraceBackend"),
    "capture_trace": ("repro_torch.observe.trace", "capture_trace"),
    "export_chrome_trace": ("repro_torch.observe.trace", "export_chrome_trace"),
    "AnomalyConfig": ("repro_torch.observe.anomaly", "AnomalyConfig"),
    "StepTimeAnomalyDetector": ("repro_torch.observe.anomaly",
                                "StepTimeAnomalyDetector"),
    "ReplanTrigger": ("repro_torch.observe.triggers", "ReplanTrigger"),
    "TriggerContext": ("repro_torch.observe.triggers", "TriggerContext"),
    "CadenceTrigger": ("repro_torch.observe.triggers", "CadenceTrigger"),
    "AnomalyTrigger": ("repro_torch.observe.triggers", "AnomalyTrigger"),
    "FingerprintTrigger": ("repro_torch.observe.triggers", "FingerprintTrigger"),
    "HealthTrigger": ("repro_torch.observe.triggers", "HealthTrigger"),
    "default_triggers": ("repro_torch.observe.triggers", "default_triggers"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    import importlib
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module 'repro_torch.observe' has no attribute "
                             f"{name!r}")
    if isinstance(target, str):
        return importlib.import_module(target)
    mod, attr = target
    return getattr(importlib.import_module(mod), attr)
