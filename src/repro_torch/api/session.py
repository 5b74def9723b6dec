"""``Session`` — config + ``RunConfig`` (+ mesh) -> the training
surfaces, as ``repro.api.session.Session`` composes them:

    run = RunConfig(mode="lags_dp", ratio=100.0, lr=0.25)

    # simulation (P workers on one device)
    sim = Session(cfg, run).simulator(loss_fn, params, n_workers=4)

    # distributed, one process per rank (launch.mesh); the hierarchy
    # (lags_hier, lags_hier2) on a ("pod", "data") mesh: make_mesh(pod=2);
    # tensor parallelism (dense decoders, every mode) on ("data", "model")
    # or ("pod", "data", "model"): make_mesh(model=2, pod=2)
    M.init_process_group("tcp://localhost:29500", world_size, rank)
    sess = Session(cfg, run, mesh=M.make_mesh())
    step_fn, state_specs, meta = sess.train_step()
    state, _ = sess.init_state()
    state, metrics = step_fn(state, batch)

    # online re-planning (repro_torch.runtime), and the whole loop
    ctl = sess.controller(rcfg=RuntimeConfig(replan_every=50))
    state, history = sess.run(data_fn, n_steps, controller=ctl,
                              out_dir="artifacts/run")

The heavyweight imports (launch, training, runtime, observe) are lazy.
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
    (:meth:`train_step`, :meth:`init_state`, :meth:`controller`,
    :meth:`run`).  ``device`` defaults to the
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

    # -- online re-planning -------------------------------------------------
    def controller(self, rcfg=None, comm_probe=None, triggers=None,
                   trace_source=None, metrics=None, events=None):
        """``runtime.ReplanController`` owning this session's train step
        (re-fits/re-plans the schedule online; see
        ``repro_torch.runtime``).

        ``triggers``: optional ``repro_torch.observe.triggers`` sequence
        (OR composition; default = the ``rcfg.replan_every`` cadence).
        ``trace_source``: optional ``step -> repro_torch.observe.Trace``
        that makes telemetry trace-driven (measured per-leaf backward
        times, per-bucket collective samples).  ``metrics``/``events``:
        the observe plane to report into (default: process-wide)."""
        from repro_torch.runtime import controller as RC
        return RC.ReplanController(self.cfg,
                                   self._need_mesh("controller"),
                                   rcfg=rcfg, run=self.run_config,
                                   comm_probe=comm_probe,
                                   triggers=triggers,
                                   trace_source=trace_source,
                                   metrics=metrics, events=events)

    # -- convenience loop ----------------------------------------------------
    def run(self, data_fn, n_steps: int, *, controller=None, state=None,
            log_path: str | None = None, log_every: int = 10,
            ckpt_every: int = 0, out_dir: str | None = None,
            publisher=None, metrics=None, events=None,
            health_every: int | None = None, health_monitor=None,
            print_fn=print):
        """The whole distributed training loop in one call
        (``repro.api.session.Session.run``).

        ``data_fn(step) -> batch`` supplies global batches; the loop logs
        one JSONL row per step to ``log_path`` and — when
        ``ckpt_every``/``out_dir`` are set — checkpoints the train state
        (``{"params", "step"}`` in ``checkpoint.io``'s format) and the
        controller state periodically, plus a final
        ``ckpt_final``/``runtime_final`` pair.  On a mesh with a 'model'
        axis the checkpoint holds the full tensors (every rank gathers
        them, over ('data', 'model') under ``lags_hier``, so every rank
        must be given ``out_dir``); a controller or a
        publisher there raises (``launch.train.refuse_model_axis``).

        Each JSONL row is a thin view over the metrics plane
        (``repro_torch.observe.metrics``): ``step``, ``loss``,
        ``elapsed_s`` (cumulative wall seconds, rounded to 0.1 s) and
        ``step_s`` (this step's **unrounded** ``time.perf_counter``
        duration, including the device sync that reads the loss), plus
        the optional ``health`` / ``publish`` / ``replan`` sub-dicts.
        The same quantities land in the registry as
        ``train_step_seconds`` (histogram), ``train_loss`` (gauge),
        ``train_steps_total`` and ``train_comm_bytes_total`` (the live
        schedule's predicted exchange payload — counters), all labelled
        ``mode=``.  When ``out_dir`` is set the loop exports a final
        snapshot ``<out_dir>/metrics_snapshot.{jsonl,json,prom}``
        (``python -m repro_torch.observe.check`` validates it).

        ``controller``: a ``ReplanController`` from :meth:`controller`
        (its :meth:`~repro_torch.runtime.ReplanController.step` replaces
        the static step function, and its re-plan decisions — including
        which *trigger* fired — are logged as they happen).
        ``state=None`` initializes via :meth:`init_state`.
        ``publisher``: a ``repro_torch.stream.StreamPublisher`` (or
        anything with its ``maybe_publish(step, params)``): after every
        step the live parameters are offered, and an emitted
        ``DeltaPacket`` is logged as the row's ``publish`` field.
        ``metrics`` / ``events``: an ``observe.metrics.MetricsRegistry``
        and ``observe.events.EventLog`` (default: the process-wide
        plane).

        ``health_every`` (default: ``run.health_every``): every N steps
        the convergence-health quantities the step computed
        (``repro_torch.observe.health``) are read on the host (after the
        loss's sync) and set as ``train_health_*`` gauges whose ``leaf``
        label carries the ``lags/health/...`` grammar.
        ``health_monitor``: an optional ``observe.health.HealthMonitor``
        fed the delta_max stream — an alarm emits a ``health_alarm``
        event, bumps ``train_health_alarms_total`` and (when the
        controller's trigger set holds a ``HealthTrigger`` over the same
        monitor) re-plans at the next step boundary.  The step must have
        been BUILT with ``run.health_every > 0`` for the quantities to
        exist at all.

        Returns ``(state, history)``, ``history`` the logged row dicts.
        """
        import json
        import os
        import time

        import numpy as np

        from repro_torch.checkpoint import io as ckpt
        from repro_torch.observe import events as OE
        from repro_torch.observe import metrics as OM

        self._need_mesh("run")
        if publisher is not None:
            from repro_torch.launch import train as TR
            TR.refuse_model_axis(self.mesh, "Session.run(publisher=...)")
        from repro_torch.sharding import dtensor as SD
        step_fn = controller.step if controller is not None else self.step_fn
        if state is None:
            state, _ = self.init_state()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        reg = metrics if metrics is not None else OM.default_registry()
        evs = events if events is not None else OE.default_events()
        mode = self.mode
        m_steps = reg.counter("train_steps_total", "Train steps run.",
                              ("mode",))
        m_step_s = reg.histogram(
            "train_step_seconds",
            "Per-step wall time (perf_counter, incl. the loss sync).",
            ("mode",))
        m_loss = reg.gauge("train_loss", "Last step's training loss.",
                           ("mode",))
        m_comm = reg.counter(
            "train_comm_bytes_total",
            "Predicted sparse-exchange payload bytes under the live "
            "schedule (values + int32 indices per kept element).",
            ("mode",))
        m_overlap = reg.gauge(
            "train_overlap_frac",
            "Fraction of exchange comm hidden under compute "
            "(source=predicted: the live wave plan's timeline; "
            "source=achieved: trace attribution via repro.pipeline).",
            ("mode", "source"))
        if health_every is None:
            health_every = self.run_config.health_every
        health_every = int(health_every)
        health_leaves: list[str] = []
        if health_every > 0:
            from repro_torch.observe import health as OH
            from repro_torch.observe import names as ON
            health_leaves = OH.leaf_names(state["params"])
            m_h_delta = reg.gauge(
                "train_health_delta",
                "Online per-leaf Assumption-1 delta (Eq. 20, closed-form "
                "RandK denominator); leaf label = lags/health/delta/...",
                ("leaf", "mode"))
            m_h_dmax = reg.gauge(
                "train_health_delta_max",
                "Max online delta over leaves at the last health fence.",
                ("mode",))
            m_h_ef = reg.gauge(
                "train_health_ef_energy",
                "Per-leaf EF residual energy retention ||e||^2/||acc||^2 "
                "per tier; leaf label = lags/health/ef_energy/...",
                ("leaf", "mode", "tier"))
            m_h_stale = reg.gauge(
                "train_health_staleness",
                "async1 one-step staleness gap ||u_t - u_{t-1}||/||u_t||.",
                ("mode",))
            m_h_alarms = reg.counter(
                "train_health_alarms_total",
                "Convergence-health alarms fired (threshold or drift).",
                ("mode", "reason"))

        def save_ckpt(tag: str):
            if not out_dir:
                return
            # on a 'model' axis the full tensors (an all-gather that
            # every rank runs), in the reference's format
            ckpt.save(os.path.join(out_dir, f"ckpt_{tag}"),
                      {"params": SD.gather(state["params"]),
                       "step": np.asarray(state["step"], np.int32)})
            if controller is not None:
                controller.save_state(os.path.join(out_dir,
                                                   f"runtime_{tag}"))

        history: list[dict] = []
        n_events = 0
        t_start = time.time()
        log = open(log_path, "a") if log_path else None
        try:
            for t in range(n_steps):
                t0 = time.perf_counter()
                state, metrics_out = step_fn(state, data_fn(t))
                loss = float(metrics_out["loss"])   # device sync
                step_s = time.perf_counter() - t0
                row = {"step": t, "loss": loss,
                       "elapsed_s": round(time.time() - t_start, 1),
                       "step_s": step_s}
                m_steps.inc(mode=mode)
                m_step_s.observe(step_s, mode=mode)
                m_loss.set(loss, mode=mode)
                live_meta = (controller.meta if controller is not None
                             else self.meta)
                m_comm.inc(_step_comm_bytes(live_meta, state["params"]),
                           mode=mode)
                waves = live_meta.get("waves")
                if waves is not None and waves.predicted:
                    m_overlap.set(float(waves.predicted["overlap"]),
                                  mode=mode, source="predicted")
                if (health_every > 0 and t % health_every == 0
                        and "health_delta" in metrics_out):
                    delta = metrics_out["health_delta"].tolist()
                    dmax = float(metrics_out["health_delta_max"])
                    for leaf, v in zip(health_leaves, delta):
                        m_h_delta.set(float(v), mode=mode,
                                      leaf=ON.health_name("delta", leaf))
                    m_h_dmax.set(dmax, mode=mode)
                    for tier in ("flat", "inner", "outer"):
                        e = metrics_out.get(f"health_ef_energy_{tier}")
                        if e is None:
                            continue
                        for leaf, v in zip(health_leaves, e.tolist()):
                            m_h_ef.set(float(v), mode=mode, tier=tier,
                                       leaf=ON.health_name(
                                           "ef_energy", f"{tier}/{leaf}"))
                    if "health_staleness" in metrics_out:
                        m_h_stale.set(
                            float(metrics_out["health_staleness"]),
                            mode=mode)
                    row["health"] = {"delta_max": dmax}
                    if health_monitor is not None:
                        alarm = health_monitor.observe(t, dmax)
                        if alarm is not None:
                            m_h_alarms.inc(mode=mode,
                                           reason=alarm["reason"])
                            evs.emit("health_alarm", step=t,
                                     name=ON.health_name("delta"),
                                     **{k: v for k, v in alarm.items()
                                        if k != "step"})
                            row["health"]["alarm"] = alarm
                            print_fn(f"step {t:4d}  HEALTH ALARM "
                                     f"[{alarm['reason']}] "
                                     f"delta_max={dmax:.3g}")
                if publisher is not None:
                    pkt = publisher.maybe_publish(t, state["params"])
                    if pkt is not None:
                        row["publish"] = {"version": pkt.version,
                                          "kind": pkt.kind,
                                          "nbytes": pkt.nbytes}
                if (controller is not None
                        and len(controller.history) > n_events):
                    ev = controller.last_event
                    n_events = len(controller.history)
                    row["replan"] = {
                        "swapped": ev.swapped,
                        "improvement": round(ev.improvement, 4),
                        "trigger": ev.trigger}
                    print_fn(f"step {t:4d}  replan[{ev.trigger}]: "
                             f"swapped={ev.swapped} "
                             f"pred_improvement={ev.improvement:.3f}")
                history.append(row)
                if log is not None:
                    log.write(json.dumps(row) + "\n")
                    log.flush()
                if log_every and (t % log_every == 0 or t == n_steps - 1):
                    print_fn(f"step {t:4d}  loss {row['loss']:.4f}  "
                             f"({row['elapsed_s']}s)")
                if ckpt_every and t and t % ckpt_every == 0:
                    save_ckpt(str(t))
        finally:
            if log is not None:
                log.close()
        save_ckpt("final")
        if out_dir:
            OM.save_snapshot(os.path.join(out_dir, "metrics_snapshot"),
                             reg, evs,
                             meta={"arch": self.cfg.name, "mode": mode,
                                   "n_steps": int(n_steps)})
        return state, history


def _step_comm_bytes(meta, params) -> int:
    """Predicted per-step exchange payload bytes under the live plan:
    ``sum(k_l) * payload_bytes_per_elem`` for a sparse exchange (the
    hierarchical modes count the cross-pod tier — the wire the plan
    budgets), raw fp32 gradient bytes for dense."""
    from repro_torch import tree
    from repro_torch.core import bucketing
    ks = meta.get("ks")
    if ks is None:
        return int(sum(4 * x.numel() for x in tree.leaves(params)))
    kept = sum(int(k) for k in tree.leaves(ks))
    return int(kept) * bucketing.payload_bytes_per_elem()
