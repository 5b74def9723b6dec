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
    post-backward ``waved_exchange`` regrouping;
  * ``overlap`` — achieved-overlap attribution from traces and the
    ``lags/overlap/...`` gauge family.
"""
from __future__ import annotations

from repro_torch.pipeline.buckets import Wave, WaveSchedule, bind
from repro_torch.pipeline.overlap import emit_metrics as emit_overlap_metrics
from repro_torch.pipeline.overlap import overlap_report
from repro_torch.pipeline.step import wave_backward, waved_exchange
from repro_torch.pipeline.waves import (PIPELINE_MODES, default_waves,
                                        plan_waves, predict_pipeline)

__all__ = ["PIPELINE_MODES", "Wave", "WaveSchedule", "bind",
           "default_waves", "emit_overlap_metrics", "overlap_report",
           "plan_waves", "predict_pipeline", "wave_backward",
           "waved_exchange"]
