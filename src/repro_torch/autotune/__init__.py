"""``repro_torch.autotune`` — measured-profile autotuner for per-layer
LAGS ratios, the port of ``repro.autotune``:

  1. **profile** (:mod:`~repro_torch.autotune.profiler`) — time the real
     train step (``launch.train.build_train_step``, dense and LAGS) and
     the mesh's collectives; a JSON ``ModelProfile`` of per-leaf
     backward times and (nbytes, t) collective samples.
  2. **fit** (:mod:`~repro_torch.autotune.costfit`) — least-squares
     (α, β) and the effective FLOP/s; a calibrated
     ``core.comm_model.Hardware``.
  3. **plan** (:mod:`~repro_torch.autotune.planner`) — Eq. 18 per leaf
     over the fitted model, with the c_u cap and the dense fallback.
  4. **schedule** (:mod:`~repro_torch.autotune.schedule`) — the per-leaf
     ratios and k's as a validated JSON ``Schedule`` (the reference's
     format), consumed by ``RunConfig(schedule=...)`` on both surfaces
     through ``core.lags.ks_from_ratios_tree`` under
     ``schedule.validate_for``.
"""
from repro_torch.autotune.costfit import fit_alpha_beta, fit_hardware
from repro_torch.autotune.planner import (plan_leaf, plan_schedule,
                                          predict_iteration)
from repro_torch.autotune.profiler import (CommSample, LeafSample,
                                           ModelProfile, backprop_leaves,
                                           profile_model, time_collectives)
from repro_torch.autotune.schedule import (HierSchedule, LeafPlan, Schedule,
                                           cache_path, load_any,
                                           schedule_from_json, summarize,
                                           validate_for)

__all__ = [
    "CommSample", "LeafSample", "ModelProfile", "backprop_leaves",
    "profile_model", "time_collectives", "fit_alpha_beta", "fit_hardware",
    "plan_leaf", "plan_schedule", "predict_iteration", "LeafPlan",
    "Schedule", "HierSchedule", "cache_path", "load_any",
    "schedule_from_json", "summarize", "validate_for",
]
