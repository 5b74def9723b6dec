"""``Session`` — config + ``RunConfig`` (+ mesh) -> the training
surfaces, as ``repro.api.session.Session`` composes them:

    run = RunConfig(mode="lags_dp", ratio=100.0, lr=0.25)

    # simulation (P workers on one device)
    sim = Session(cfg, run).simulator(loss_fn, params, n_workers=4)

    # distributed, one process per rank (launch.mesh); the hierarchy
    # (lags_hier, lags_hier2) on a ("pod", "data") mesh: make_mesh(pod=2)
    M.init_process_group("tcp://localhost:29500", world_size, rank)
    sess = Session(cfg, run, mesh=M.make_mesh())
    step_fn, state_specs, meta = sess.train_step()
    state, _ = sess.init_state()
    state, metrics = step_fn(state, batch)
"""
from __future__ import annotations

import dataclasses

from repro_torch import resolve_device
from repro_torch.api.config import RunConfig


def build_train_step(cfg, mesh, run: RunConfig | None = None):
    """(step_fn, state_specs, meta) for the distributed step: the
    functional core of :meth:`Session.train_step`."""
    from repro_torch.launch import train as TR
    return TR.build_train_step(cfg, mesh, run or RunConfig())


class Session:
    """The config's ``train_mode`` is reconciled with ``run.mode`` once,
    here.  ``mesh`` is needed only by the distributed members
    (:meth:`train_step`, :meth:`init_state`).  ``device`` defaults to the
    mesh's device, or to ``cuda`` without a mesh, and raises without a
    card."""

    def __init__(self, cfg, run: RunConfig | None = None, mesh=None, *,
                 device=None):
        if mesh is not None:
            from repro_torch.launch import mesh as M
            mesh_dev = M.device_of(mesh)
            if device is not None and resolve_device(device).type \
                    != mesh_dev.type:
                raise ValueError(f"device {device} and a {mesh_dev.type} "
                                 f"mesh")
            device = mesh_dev
        self.device = resolve_device("cuda" if device is None else device)
        self.run_config = run or RunConfig()
        mode = self.run_config.resolved_mode(cfg)
        self.cfg = (cfg if cfg.train_mode == mode
                    else dataclasses.replace(cfg, train_mode=mode))
        self.run_config = dataclasses.replace(self.run_config, mode=mode)
        self.mesh = mesh
        self._built = None

    @property
    def mode(self) -> str:
        return self.run_config.mode

    def _need_mesh(self, what: str):
        if self.mesh is None:
            raise ValueError(f"Session.{what} needs a mesh — pass one to "
                             f"Session(cfg, run, mesh=...)")
        return self.mesh

    # -- distributed surface ------------------------------------------------
    def train_step(self):
        """(step_fn, state_specs, meta), built once and cached."""
        if self._built is None:
            self._built = build_train_step(self.cfg,
                                           self._need_mesh("train_step"),
                                           self.run_config)
        return self._built

    @property
    def step_fn(self):
        return self.train_step()[0]

    @property
    def state_specs(self):
        return self.train_step()[1]

    @property
    def meta(self):
        return self.train_step()[2]

    def init_state(self, seed: int = 0, params=None):
        """This rank's train state (with the ``extra`` entry the run's
        ``momentum_correction`` needs); ``params`` as in
        ``launch.train.init_state``."""
        from repro_torch.launch import train as TR
        return TR.init_state(
            self.cfg, self._need_mesh("init_state"), method=self.mode,
            seed=seed, pipeline=self.run_config.pipeline,
            momentum_correction=self.run_config.momentum_correction,
            params=params)

    # -- simulation surface -------------------------------------------------
    def simulator(self, loss_fn, params, n_workers: int):
        """``SimTrainer`` for this run: P simulated workers on one device,
        leading-P batches."""
        from repro_torch.training import train_loop as TL
        run = self.run_config
        if run.ratio is None:
            run = dataclasses.replace(run, ratio=run.resolved_ratio(self.cfg))
        return TL.SimTrainer(loss_fn, params, run, n_workers=n_workers,
                             device=self.device)
