"""``repro_torch.runtime`` — the two-tier planner of ``repro.runtime``
(``hier``).  The online re-planning controller and its telemetry are
not ported yet (ROADMAP.md queue 1 item 12)."""
from repro_torch.runtime.hier import (plan_hier_schedule,
                                      predict_hier_iteration, tier_hardware)

__all__ = ["plan_hier_schedule", "predict_hier_iteration", "tier_hardware"]
