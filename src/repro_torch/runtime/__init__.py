"""``repro_torch.runtime`` — online re-planning with hierarchical LAGS
schedules, the port of ``repro.runtime``:

  * **telemetry** (:mod:`~repro_torch.runtime.telemetry`) — ring-buffer
    collector of per-step wall times (fence-amortized at the Python step
    boundary) and of the collective samples the probe hands back.
  * **hier** (:mod:`~repro_torch.runtime.hier`) — two-tier planner: Eq. 18
    solved separately per tier against each tier's own fitted α/β,
    emitting an ``autotune.schedule.HierSchedule`` (schema v2).
  * **controller** (:mod:`~repro_torch.runtime.controller`) — whenever
    its trigger set fires (``repro_torch.observe.triggers``: fixed
    cadence by default, optionally step-time anomaly detection, hardware-
    fingerprint drift and convergence health): re-fit the wire from
    fresh collective samples (trace-attributed per-bucket timings when a
    ``trace_source`` is installed, micro-benchmark probe otherwise),
    re-derive compute budgets, re-solve Eq. 18, and swap the live train
    step **only** when the predicted iteration time improves by more
    than ``swap_threshold``.  State — including stateful triggers —
    survives restarts via ``checkpoint.io``.

Usage::

    from repro_torch import api
    from repro_torch.runtime import RuntimeConfig

    sess = api.Session(cfg, api.RunConfig(lr=0.01), mesh)
    ctl = sess.controller(rcfg=RuntimeConfig(replan_every=50,
                                             swap_threshold=0.05))
    state, _ = sess.init_state()
    for t in range(steps):
        state, metrics = ctl.step(state, data.batch(t, B, S, device=dev))
    ctl.save_state("artifacts/runtime_state")    # resume: restore_state

or the whole loop, ``sess.run(data_fn, n, controller=ctl)``.

Why mid-training k changes are safe: Lemma 1 covers any partition of the
gradient into pieces, and the k-contraction analysis of Alistarh et al.
(arXiv 1809.10505) bounds the error-feedback residual for any k sequence
bounded below — the controller never plans past the ``c_upper`` cap, so
every window stays inside Assumption 1's validated range.
"""
from repro_torch.runtime.controller import (ReplanController, RuntimeConfig,
                                            SwapEvent)
from repro_torch.runtime.hier import (plan_hier_schedule,
                                      predict_hier_iteration, tier_hardware)
from repro_torch.runtime.telemetry import StepSample, Telemetry

__all__ = [
    "ReplanController", "RuntimeConfig", "SwapEvent", "plan_hier_schedule",
    "predict_hier_iteration", "tier_hardware", "StepSample", "Telemetry",
]
