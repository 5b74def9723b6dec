"""``RunConfig`` — the typed knob-set of a training run, a copy of
``repro.api.config.RunConfig`` without JAX.

Pure data: construction checks only the values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

#: Legacy method-string spellings -> canonical train-mode vocabulary.
MODE_ALIASES: dict[str, str] = {"lags": "lags_dp"}


def canonical_mode(mode: str) -> str:
    """``"lags"`` -> ``"lags_dp"``; other names pass through (the
    registry rejects unknown ones)."""
    return MODE_ALIASES.get(mode, mode)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything about HOW to train that is not the model architecture.

    ``mode=None`` / ``ratio=None`` defer to the model config's
    ``train_mode`` / ``compression_ratio`` at build time."""
    mode: str | None = None
    ratio: float | None = None
    # "lags_hier2": the intra-pod tier's ratio (None = 1.0, dense), and
    # on the simulation surface how many of the P workers share a pod
    # (P factors as (P // inner_workers) pods x inner_workers); the
    # distributed step reads the mesh instead
    ratio_inner: float | None = None
    inner_workers: int | None = None
    compressor: str = "topk_exact"
    # "xla" (plain torch selection) or "kernel" (the CUDA kernels of
    # repro_torch.kernels), resolved per compressor via KERNEL_BACKED
    selection_backend: str = "xla"
    # "lags_hier2": the intra-pod tier's compressor (None = compressor)
    inner_compressor: str | None = None
    block_size: int = 4096
    # optional autotuned per-leaf plan (repro_torch.autotune Schedule /
    # HierSchedule, or anything with a ``ks_tree(params_like)`` method),
    # checked against the mode and mesh by ``autotune.schedule.validate_for``
    schedule: Any = None
    # optimizer
    lr: float = 0.01
    lr_schedule: Callable[[Any], Any] | None = None   # step -> lr
    momentum: float = 0.0
    # DGC momentum correction: the velocity accumulates BEFORE
    # sparsification (ExchangeSpec.init_extra_state, per-worker "mom")
    momentum_correction: float = 0.0
    # exchange pipelining (repro_torch.pipeline): "off" = monolithic
    # post-backward exchange; "wave" = per-wave exchange launched inside
    # backprop (bitwise equal to "off"); "async1" = step-N exchange
    # launched before step N+1's forward (one step of bounded staleness).
    # The distributed step runs them; SimTrainer, like the reference's,
    # always runs the monolithic exchange.
    pipeline: str = "off"
    # optional repro_torch.pipeline.WaveSchedule (names are re-bound at
    # build time); None = the geometry-default wave partition
    waves: Any = None
    # wave payload target in bytes; None = pipeline.waves'
    # DEFAULT_TARGET_BYTES
    wave_target_bytes: int | None = None
    # compute shape
    chunk: int = 1024
    loss_chunk: int = 512
    donate: bool = True
    # instrumentation
    measure_delta: bool = False        # Eq. 20 metric, simulation only
    # > 0: both surfaces compute the convergence-health quantities
    # (repro_torch.observe.health) every step; Session.run reads them
    # every health_every steps.  0: no key and no work
    health_every: int = 0
    seed: int = 0                      # stream of key-needing compressors

    def __post_init__(self):
        if self.mode is not None:
            object.__setattr__(self, "mode", canonical_mode(self.mode))
        if self.pipeline not in ("off", "wave", "async1"):
            raise ValueError(
                f"pipeline={self.pipeline!r} not in ('off', 'wave', "
                f"'async1')")
        if self.selection_backend not in ("xla", "kernel"):
            raise ValueError(
                f"selection_backend={self.selection_backend!r} not in "
                f"('xla', 'kernel')")
        if self.health_every < 0:
            raise ValueError(f"health_every={self.health_every} < 0")
        if self.pipeline == "wave" and self.momentum_correction > 0.0:
            # the wave taps form updates from raw gradients inside
            # backprop; the DGC velocity is a post-backward recurrence
            raise ValueError(
                "momentum_correction requires pipeline 'off' or 'async1' "
                "(wave taps compute updates inside backprop)")

    def resolved_mode(self, cfg=None) -> str:
        if self.mode is not None:
            return self.mode
        if cfg is not None:
            return canonical_mode(cfg.train_mode)
        return "lags_dp"

    def resolved_ratio(self, cfg=None) -> float:
        if self.ratio is not None:
            return float(self.ratio)
        if cfg is not None:
            return float(cfg.compression_ratio)
        return 250.0

    def resolved_ratio_inner(self) -> float:
        """Inner-tier ratio (``lags_hier2``): ``None`` means dense (1.0)."""
        return 1.0 if self.ratio_inner is None else float(self.ratio_inner)

    def lr_at(self, step):
        """Learning rate at ``step`` — the schedule wins."""
        if self.lr_schedule is not None:
            return self.lr_schedule(step)
        return self.lr

    def key_at(self, step: int):
        """The step's stream for key-needing compressors: ``Key(seed)``
        with the step folded in, the one derivation both surfaces use;
        the exchanges fold in leaf and worker themselves."""
        from repro_torch.core.compressors import Key   # lazy: pure data
        return Key(int(self.seed)).fold_in(int(step))
