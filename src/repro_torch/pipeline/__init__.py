"""repro_torch.pipeline — wave-pipelined layer-wise gradient exchange,
the counterpart of ``repro.pipeline``.

Leaves are partitioned into **waves** (``buckets``, ``waves``); each
wave's select + pack + collective launches inside backprop as its
gradients land (``step.wave_backward``, autograd hooks), or before the
next step's forward (``RunConfig.pipeline="async1"``).

Modules:

  * ``buckets`` — ``Wave`` / ``WaveSchedule`` artifacts (JSON, binding,
    ``bucketing.bucket_stats`` views);
  * ``waves``   — planning: geometry-only ``default_waves``,
    measurement-driven ``plan_waves`` and ``predict_pipeline``;
  * ``step``    — execution: in-backprop ``wave_backward`` hooks and
    post-backward ``waved_exchange`` regrouping.

The reference's ``overlap_report`` / ``emit_overlap_metrics`` read
traces through ``observe.trace``/``names``, not ported yet (ROADMAP.md
queue 1 item 12).
"""
from __future__ import annotations

from repro_torch.pipeline.buckets import Wave, WaveSchedule, bind
from repro_torch.pipeline.step import wave_backward, waved_exchange
from repro_torch.pipeline.waves import (PIPELINE_MODES, default_waves,
                                        plan_waves, predict_pipeline)

__all__ = ["PIPELINE_MODES", "Wave", "WaveSchedule", "bind",
           "default_waves", "plan_waves", "predict_pipeline",
           "wave_backward", "waved_exchange"]
