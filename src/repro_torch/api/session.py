"""``Session`` — config + ``RunConfig`` -> the training surfaces, as
``repro.api.session.Session`` composes them.  This slice has the
simulation surface only (:meth:`Session.simulator`)."""
from __future__ import annotations

import dataclasses

from repro_torch import resolve_device
from repro_torch.api.config import RunConfig


class Session:
    """The config's ``train_mode`` is reconciled with ``run.mode`` once,
    here.  ``device`` defaults to ``cuda`` and raises without a card."""

    def __init__(self, cfg, run: RunConfig | None = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.run_config = run or RunConfig()
        mode = self.run_config.resolved_mode(cfg)
        self.cfg = (cfg if cfg.train_mode == mode
                    else dataclasses.replace(cfg, train_mode=mode))
        self.run_config = dataclasses.replace(self.run_config, mode=mode)

    @property
    def mode(self) -> str:
        return self.run_config.mode

    def simulator(self, loss_fn, params, n_workers: int):
        """``SimTrainer`` for this run: P simulated workers on one device,
        leading-P batches."""
        from repro_torch.training import train_loop as TL
        run = self.run_config
        if run.ratio is None:
            run = dataclasses.replace(run, ratio=run.resolved_ratio(self.cfg))
        return TL.SimTrainer(loss_fn, params, run, n_workers=n_workers,
                             device=self.device)
