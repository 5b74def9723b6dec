"""Online re-planning controller: measured window -> fit -> plan -> swap
(the port of ``repro.runtime.controller``).

``ReplanController`` owns the train step and re-runs the autotune
pipeline whenever its *trigger set* fires (``repro_torch.observe.triggers`` —
the default set is a single cadence trigger reproducing the historical
``replan_every`` semantics): the wire (α, β) are re-fitted from fresh
collective samples, the per-leaf compute budgets are re-derived, and
Eq. 18 is re-solved — flat for ``lags_dp``, two-tier (``runtime.hier``)
for the hierarchical modes.  For ``lags_hier`` only the outer
(cross-pod) tier is executable, so the swap prediction prices that tier;
for ``lags_hier2`` BOTH tiers are live — an ICI-only bandwidth shift
re-prices the inner tier, and a swap hot-swaps both tiers' k's into the
running step.

Measurements come from the best evidence available, in order:

  * a ``trace_source`` (``step -> repro_torch.observe.Trace``, real capture or
    the deterministic fake backend) supplies **measured per-leaf
    backward times** and **per-bucket collective samples**, attributed
    by ``repro_torch.observe.attribution`` — the planner then consumes real
    budgets and ``costfit`` real wire points (fit names carry an
    ``attr_`` prefix so benchmarks can assert the provenance);
  * otherwise the fenced telemetry window supplies the step-time scale
    (FLOPs-share apportionment — the explicit fallback) and the
    ``comm_probe`` micro-benchmark supplies wire samples.

The candidate schedule only replaces the live one under hysteresis: the
α-β model predicts the iteration time of both the current and the
candidate schedule against the *new* fit, and the swap happens only when
the predicted relative improvement exceeds ``swap_threshold``.  Every
swap rebuilds the train step through ``repro_torch.api.build_train_step``
with the new per-leaf k's: no recompile in PyTorch, but a new exchange,
new wave hooks and new block geometry, so the threshold bounds that
churn — noise-level drift re-plans to a near-identical schedule and is
rejected.  The train state is the caller's and carries over untouched
(the EF residuals keep their per-leaf shapes whatever k is); the old
step is dropped with everything it held.

Changing k^(l) mid-training stays inside the paper's guarantee: Lemma 1
holds per partition piece, and the k-contraction analysis of Alistarh et
al. (arXiv 1809.10505) bounds the EF residual for any step-wise k
sequence bounded below — the c_u cap is that bound here.

One decision for the mesh: every rank runs a controller, and the
reference's single SPMD program takes one decision for all of them.  On
a process group of several ranks the triggers' votes are OR-ed over
every rank at each step boundary (one all-reduce of one flag a
trigger), and the fit's inputs (the measured leaves, the forward time,
each tier's wire samples and their provenance) are rank 0's, broadcast
before planning: every rank then re-plans at the same step, from the
same inputs, to the same swap.  The probes still run on every rank (the
live one is a collective).  A world of one skips both.  On a mesh with a
'model' axis the workers are the data ranks of each model index
(``tier_workers``, ``meta["n_workers"]``), and a swap rebuilds the step
on the same mesh: the caller's ``DTensor`` parameters and chunked
residuals carry over as they are.

Controller state (current schedule, telemetry window, swap history,
stateful triggers such as the anomaly detector) round-trips through
``checkpoint.io`` so re-planning survives restarts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import block_until_ready
from repro_torch.api.config import RunConfig
from repro_torch.autotune import planner, profiler
from repro_torch.autotune import schedule as S
from repro_torch.checkpoint import io as ckpt
from repro_torch.core import comm_model as cm
from repro_torch.launch import mesh as M
from repro_torch.observe import attribution as OA
from repro_torch.observe import triggers as OT
from repro_torch.runtime import hier
from repro_torch.runtime.telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Knobs of the online re-planning loop."""
    replan_every: int = 50        # default cadence trigger (0 = never)
    window: int = 64              # telemetry ring capacity (step samples)
    fence_every: int = 8          # device-synchronise cadence
    swap_threshold: float = 0.05  # min predicted rel. improvement to swap
    c_upper: float = 1000.0       # Assumption 1 ratio cap
    min_step_samples: int = 2     # don't re-plan on an empty window
    probe_sizes: tuple = (1 << 12, 1 << 16, 1 << 20)
    probe_iters: int = 3
    hw_base: cm.Hardware = cm.H100_NVLINK   # compute spec + wire fallback
    # cross-pod fallback wire: the reference's TPU_DCN is its chips with a
    # slow wire between pods; the port has no data-center-network preset,
    # so the paper's 1 Gbps Ethernet (ETH_1GBPS) stands in for the wire,
    # on H100_NVLINK's compute spec (the same cards in every pod)
    hw_base_outer: cm.Hardware = dataclasses.replace(
        cm.H100_NVLINK, name="eth_1gbps_wire", alpha=cm.ETH_1GBPS.alpha,
        beta=cm.ETH_1GBPS.beta)


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One re-plan decision (swapped or hysteresis-rejected)."""
    step: int
    swapped: bool
    improvement: float        # predicted (t_cur - t_new) / t_cur
    t_pred_current: float
    t_pred_candidate: float
    overlap: float            # predicted comm overlap under the candidate
    hw_name: str
    trigger: str = "cadence"  # comma-joined names of the triggers that fired


class ReplanController:
    """Owns the train step; closes the autotune loop online.

    Usage::

        ctl = ReplanController(cfg, mesh, rcfg=RuntimeConfig(replan_every=50))
        state, _ = TR.init_state(cfg, mesh)
        for t in range(steps):
            state, metrics = ctl.step(state, batch_fn(t))   # replans inside
        ctl.save_state("ckpt/runtime")                      # survives restart

    ``comm_probe(mesh, axes) -> [profiler.CommSample]`` defaults to the
    live ``profiler.time_collectives`` micro-benchmark; benchmarks/tests
    inject synthetic sources (e.g. a mid-run bandwidth shift).

    ``triggers``: sequence of ``observe.triggers.ReplanTrigger`` ORed at
    each step boundary; defaults to ``(CadenceTrigger(replan_every),)``.

    ``trace_source``: optional ``step -> observe.Trace`` (or None for "no
    trace this step").  When set it becomes the authoritative telemetry
    source — the step/comm rings are fed from attributed trace events
    instead of wall-clock fences, which is what makes anomaly-triggered
    re-planning deterministic in CI (fake-trace backend).
    """

    def __init__(self, cfg, mesh, *, rcfg: RuntimeConfig | None = None,
                 schedule=None, comm_probe: Callable | None = None,
                 run: RunConfig | None = None,
                 triggers: Sequence | None = None,
                 trace_source: Callable | None = None,
                 metrics=None, events=None):
        from repro_torch.observe import events as OE
        from repro_torch.observe import metrics as OM
        if cfg.train_mode == "dense":
            raise ValueError("nothing to re-plan for train_mode='dense'")
        self._metrics = metrics if metrics is not None \
            else OM.default_registry()
        self._events = events if events is not None else OE.default_events()
        self._m_triggers = self._metrics.counter(
            "replan_triggers_total",
            "Trigger firings, by trigger name.", ("trigger",))
        self._m_replans = self._metrics.counter(
            "replan_events_total",
            "Re-plan decisions, by hysteresis outcome.", ("swapped",))
        self._m_improvement = self._metrics.gauge(
            "replan_improvement",
            "Last re-plan's predicted relative improvement.")
        self._m_t_pred = self._metrics.gauge(
            "replan_t_pred_seconds",
            "Last re-plan's predicted iteration time.", ("which",))
        self._m_step_s = self._metrics.histogram(
            "replan_step_seconds",
            "Step time as the controller's telemetry saw it "
            "(trace-attributed when a trace_source is set).")
        run = run or RunConfig()
        self.cfg, self.mesh = cfg, mesh
        self.rcfg = rcfg or RuntimeConfig()
        self.mode = cfg.train_mode
        self.schedule = schedule if schedule is not None else run.schedule
        #: live wave partition (repro_torch.pipeline) when the run
        #: pipelines the exchange; re-planned from measured leaf timings alongside the
        #: ratio schedule and hot-swapped into the step on the same
        #: hysteresis decision
        self.waves = run.waves
        self._m_overlap = self._metrics.gauge(
            "replan_overlap_frac",
            "Wave-plan comm overlap under the fresh fit "
            "(source=predicted).", ("source",))
        # the live schedule is owned by the controller, not the RunConfig
        self._run = dataclasses.replace(run, mode=self.mode, schedule=None,
                                        donate=False)
        # a replan window must accumulate >= min_step_samples fenced
        # timings, so cap the fence interval at a quarter of the window
        fence = self.rcfg.fence_every
        if self.rcfg.replan_every > 0:
            fence = min(fence, max(1, self.rcfg.replan_every // 4))
        self.telemetry = Telemetry(window=self.rcfg.window,
                                   fence_every=fence)
        self.history: list[SwapEvent] = []
        self._probe = comm_probe or self._default_probe
        self.triggers = tuple(triggers) if triggers is not None else \
            OT.default_triggers(self.rcfg.replan_every)
        self.trace_source = trace_source
        self._last_trace = None
        self._last_trace_step = -1
        #: provenance of the last re-plan's leaf budgets: "trace" when a
        #: capture supplied measured per-leaf backward times, "window"
        #: for the FLOPs-share fallback over the fenced median
        self.measurement_source = "window"
        self._step_count = 0
        # tokens=1.0: apportion_backward splits by FLOPs *share*, so the
        # absolute token count cancels; budgets come from measured times
        self._leaf_template = profiler.backprop_leaves(cfg, 1.0)
        # (n_inner, n_outer) worker counts the two-tier planner/predictor
        # use (hier modes only); tests on single-device meshes override
        # this the same way they override meta["n_workers"]
        self.tier_workers = (
            max(1, M.n_workers(mesh, M.inner_axis_names(mesh))),
            max(1, M.n_workers(mesh, M.lags_axis_names(mesh, self.mode))))
        self._build()

    # -- step ownership ----------------------------------------------------
    def _build(self) -> None:
        from repro_torch import api
        run = dataclasses.replace(self._run, schedule=self.schedule,
                                  waves=self.waves)
        # drop the old step (its exchange and wave plan) before building
        self.step_fn = self.state_specs = self.meta = None
        self.step_fn, self.state_specs, self.meta = api.build_train_step(
            self.cfg, self.mesh, run)

    def _plan_waves(self, leaves, sched, t_fwd, hw):
        """Measurement-driven wave partition for the candidate schedule
        (``repro_torch.pipeline.waves.plan_waves``): measured per-leaf backward
        times set wave readiness, the fresh wire fit prices each wave's
        collective, and the artifact carries the predicted timeline the
        achieved-overlap assertion checks against."""
        from repro_torch.pipeline import waves as WW
        gran = "leaf"
        live = self.meta.get("waves")
        if live is not None and live.meta:
            gran = live.meta.get("granularity", "leaf")
        # hier modes: price the cross-pod (outer) tier — the wire the
        # plan budgets, and the hw the candidate was fitted against
        flat = (sched.outer if isinstance(sched, S.HierSchedule)
                else sched)
        p = (self.tier_workers[1] if self.mode in S.HIER_MODES
             else int(self.meta["n_workers"]))
        return WW.plan_waves(
            leaves, flat, p, hw,
            t_forward=t_fwd, pipeline=self._run.pipeline,
            granularity=gran,
            target_bytes=self._run.wave_target_bytes)

    def step(self, state, batch):
        """Run one train step; ticks telemetry and re-plans when a
        trigger fires."""
        state, metrics = self.step_fn(state, batch)
        self._step_count += 1
        ingested = False
        if self.trace_source is not None:
            trace = self.trace_source(self._step_count)
            if trace is not None:
                ingested = self.ingest_trace(self._step_count, trace)
        if not ingested:
            # no trace this step, or one with no usable step event (e.g.
            # the real backend's unparseable-XPlane empty Trace) — fall
            # back to the fenced wall clock so cadence/anomaly triggers
            # keep seeing step samples instead of starving forever
            self.telemetry.tick(self._step_count, (state, metrics))
        fired = self._fired_triggers()
        if fired:
            for name in fired:
                self._m_triggers.inc(trigger=name)
                self._events.emit("trigger", step=self._step_count,
                                  name=name)
            # drain in-flight device work before probing the wire —
            # collectives contending with unfinished step work would
            # inflate the α/β fit and could trigger a spurious swap
            block_until_ready((state, metrics))
            self.maybe_replan(self._step_count, trigger=",".join(fired))
        return state, metrics

    def ingest_trace(self, step_no: int, trace) -> bool:
        """Feed one attributed trace into the telemetry rings (step time
        from the ``lags/step`` event, per-bucket comm samples) and keep
        it as the budget source for the next re-plan.  Returns True when
        the trace carried a usable step timing (``step`` then skips the
        wall-clock fence); an eventless trace is ignored entirely."""
        t_step = OA.step_time(trace)
        samples = OA.comm_samples(trace)
        if t_step <= 0.0 and not samples and not OA.backward_times(trace):
            return False
        self._last_trace = trace
        self._last_trace_step = int(step_no)
        if t_step > 0.0:
            self.telemetry.record_step(int(step_no), t_step)
            self._m_step_s.observe(t_step)
        if samples:
            self.telemetry.record_comm(samples)
        return t_step > 0.0

    def _fresh_trace(self):
        """The last ingested trace, unless it has aged out of the
        telemetry window — re-planning must not brand stale-epoch
        evidence as measured (``attr_``/"trace") after the wire may have
        moved on."""
        if self._last_trace is None:
            return None
        if self._step_count - self._last_trace_step > self.rcfg.window:
            return None
        return self._last_trace

    def _trigger_ctx(self) -> OT.TriggerContext:
        return OT.TriggerContext(step=self._step_count,
                                 telemetry=self.telemetry,
                                 schedule=self.schedule, mode=self.mode)

    def _fired_triggers(self) -> list[str]:
        due = [False] * len(self.triggers)
        if len(self.telemetry) >= self.rcfg.min_step_samples:
            ctx = self._trigger_ctx()
            due = [t.due(ctx) for t in self.triggers]
        if _world() > 1:
            # a trigger that fires on one rank fires on all of them: the
            # re-plan's probe is a collective, and its swap changes the
            # exchange every rank runs
            vote = torch.tensor(due, dtype=torch.int32,
                                device=M.device_of(self.mesh))
            dist.all_reduce(vote, op=dist.ReduceOp.MAX)
            due = [bool(v) for v in vote.tolist()]
        return [t.name for t, d in zip(self.triggers, due) if d]

    def _due(self) -> bool:
        return bool(self._fired_triggers())

    @property
    def last_event(self) -> SwapEvent | None:
        return self.history[-1] if self.history else None

    # -- re-planning -------------------------------------------------------
    def _default_probe(self, mesh, axes) -> list:
        return profiler.time_collectives(
            mesh, axes, sizes_bytes=self.rcfg.probe_sizes,
            iters=self.rcfg.probe_iters)

    def _measured_leaves(self) -> tuple[Sequence, float]:
        """(leaves with measured budgets, t_forward estimate).

        Preferred source: the last attributed trace — measured per-leaf
        backward times with the FLOPs-share split only covering leaves
        the trace missed.  Fallback: apportion the fenced window's
        median step time by FLOPs share (the pre-observe behaviour)."""
        t_step = self.telemetry.median_step_time()
        t_bwd_total = profiler.BWD_FRACTION * t_step
        trace = self._fresh_trace()
        if trace is not None:
            measured = OA.backward_times(trace)
            if measured:
                leaves = OA.attribute_leaves(
                    self._leaf_template, trace,
                    t_backward_total=t_bwd_total)
                t_fwd = OA.forward_time(trace)
                if t_fwd <= 0.0:
                    t_fwd = max(0.0, t_step - sum(l.t_backward
                                                  for l in leaves))
                self.measurement_source = "trace"
                return leaves, t_fwd
        self.measurement_source = "window"
        leaves = profiler.apportion_backward(self._leaf_template,
                                             t_bwd_total)
        return leaves, max(0.0, (1.0 - profiler.BWD_FRACTION) * t_step)

    def _tier_samples(self, tier: str, axes) -> tuple[list, str]:
        """Wire samples for one tier: trace-attributed per-bucket samples
        when the (fresh) last trace covered that tier (fit name prefixed
        ``attr_``), else the injected/live probe."""
        trace = self._fresh_trace()
        if trace is not None:
            attributed = OA.comm_samples(trace, tier=tier)
            if attributed:
                return attributed, "attr_"
        if not axes:
            return [], ""
        # tag probe samples with their tier so downstream window fits
        # (FingerprintTrigger) never mix two wires into one line
        samples = [dataclasses.replace(s, label=f"{tier}/probe")
                   for s in self._probe(self.mesh, axes)]
        # probe samples are not already in the ring (trace samples are,
        # via ingest_trace) — record them so FingerprintTrigger and the
        # checkpoint see the evidence the fit consumed
        if samples:
            self.telemetry.record_comm(samples)
        return samples, ""

    def _static_baseline(self, leaves) -> S.Schedule:
        """The live per-leaf plan when no schedule was ever installed:
        the static ``cfg.compression_ratio`` applied uniformly."""
        c = max(1.0, float(self.cfg.compression_ratio))
        plans = tuple(S.LeafPlan(name=l.name, d=l.d, ratio=c,
                                 k=max(1, int(round(l.d / c))))
                      for l in leaves)
        return S.Schedule(arch=self.cfg.name, shape="static",
                          n_workers=int(self.meta["n_workers"]),
                          hardware={"name": "static"}, leaves=plans,
                          train_mode=self.mode)

    def _fit_samples(self) -> dict:
        """{tier: (wire samples, fit-name prefix)} of the tiers the
        planner fits: "inner" and "outer" for the hierarchical modes,
        else "flat"."""
        if self.mode in S.HIER_MODES:
            return {"inner": self._tier_samples(
                        "inner", M.inner_axis_names(self.mesh)),
                    "outer": self._tier_samples(
                        "outer", M.lags_axis_names(self.mesh, self.mode))}
        return {"flat": self._tier_samples("flat",
                                           M.data_axis_names(self.mesh))}

    def _plan_candidate(self, leaves, t_fwd, samples):
        """(candidate schedule, predict_fn, hw) from ``samples``
        (:meth:`_fit_samples`) — ``predict_fn(sched)`` prices any
        schedule (flat or hier) against the fresh fit."""
        rc = self.rcfg
        if self.mode in S.HIER_MODES:
            s_in, pre_in = samples["inner"]
            s_out, pre_out = samples["outer"]
            hw_in = hier.tier_hardware(s_in, rc.hw_base,
                                       name=pre_in + "ici_fit")
            hw_out = hier.tier_hardware(s_out, rc.hw_base_outer,
                                        name=pre_out + "dcn_fit")
            p_in, p_out = self.tier_workers
            cand = hier.plan_hier_schedule(
                leaves, p_inner=p_in, p_outer=p_out, hw_inner=hw_in,
                hw_outer=hw_out, arch=self.cfg.name, shape="runtime",
                c_upper=rc.c_upper, train_mode=self.mode)

            def predict(sched):
                if isinstance(sched, S.HierSchedule):
                    inner, outer = sched.inner, sched.outer
                else:
                    inner, outer = None, sched
                if self.mode != "lags_hier2":
                    # lags_hier's intra-pod reduction is the step's dense
                    # all-reduce whatever the inner plan says — price the
                    # executable (outer) tier only
                    return planner.predict_iteration(leaves, outer, p_out,
                                                     hw_out, t_fwd)
                # lags_hier2 executes both tiers: an ICI-only shift moves
                # the prediction (and can trigger an inner-tier swap)
                return hier.predict_hier_iteration(
                    leaves, inner, outer, p_inner=p_in, p_outer=p_out,
                    hw_inner=hw_in, hw_outer=hw_out, t_forward=t_fwd)
            return cand, predict, hw_out
        flat, prefix = samples["flat"]
        hw = hier.tier_hardware(flat, rc.hw_base, name=prefix + "wire_fit")
        p = int(self.meta["n_workers"])
        cand = planner.plan_schedule(leaves, p=p, hw=hw, arch=self.cfg.name,
                                     shape="runtime", c_upper=rc.c_upper,
                                     train_mode=self.mode)
        return (cand,
                lambda sched: planner.predict_iteration(leaves, sched, p,
                                                        hw, t_fwd),
                hw)

    def maybe_replan(self, step_no: int, trigger: str = "manual") -> SwapEvent:
        """Re-fit + re-plan on the current window; swap under hysteresis."""
        leaves, t_fwd = self._measured_leaves()
        inputs = (leaves, t_fwd, self._fit_samples(),
                  self.measurement_source)
        if _world() > 1:
            # every rank plans from rank 0's window, wire and trace
            box = [inputs]
            dist.broadcast_object_list(box, src=0,
                                       device=M.device_of(self.mesh))
            inputs = box[0]
        leaves, t_fwd, samples, self.measurement_source = inputs
        candidate, predict, hw = self._plan_candidate(leaves, t_fwd,
                                                      samples)
        current = (self.schedule if self.schedule is not None
                   else self._static_baseline(leaves))
        t_cur = predict(current)["t_lags"]
        pred = predict(candidate)
        t_new = pred["t_lags"]
        improvement = (t_cur - t_new) / t_cur if t_cur > 0 else 0.0
        swapped = improvement > self.rcfg.swap_threshold
        if self._run.pipeline != "off":
            # re-partition the waves against the fresh measurements; the
            # new partition rides the SAME hysteresis decision (a swap
            # rebuilds the step), but its predicted overlap is always fresh
            self.waves = self._plan_waves(
                leaves, candidate if swapped else current, t_fwd, hw)
            self._m_overlap.set(float(self.waves.predicted["overlap"]),
                                source="predicted")
        if swapped:
            self.schedule = candidate
            self._build()
        # probing/planning (and, on swap, the rebuild) happened between
        # two fences — re-baseline so none of it pollutes the step window
        self.telemetry.reset_baseline()
        event = SwapEvent(step=int(step_no), swapped=swapped,
                          improvement=float(improvement),
                          t_pred_current=float(t_cur),
                          t_pred_candidate=float(t_new),
                          overlap=float(pred["overlap"]), hw_name=hw.name,
                          trigger=str(trigger))
        self.history.append(event)
        self._m_replans.inc(swapped=str(swapped).lower())
        self._m_improvement.set(event.improvement)
        self._m_t_pred.set(event.t_pred_current, which="current")
        self._m_t_pred.set(event.t_pred_candidate, which="candidate")
        self._events.emit("replan", step=int(step_no),
                          swapped=swapped,
                          improvement=event.improvement,
                          t_pred_current=event.t_pred_current,
                          t_pred_candidate=event.t_pred_candidate,
                          overlap=event.overlap, hw=hw.name,
                          trigger=event.trigger,
                          source=self.measurement_source)
        ctx = self._trigger_ctx()
        for t in self.triggers:
            t.notify_replan(ctx, event)
        return event

    # -- checkpoint round-trip ---------------------------------------------
    def save_state(self, path: str) -> str:
        """Persist schedule + telemetry window (step AND per-bucket comm
        rings) + swap history + stateful-trigger state via
        ``checkpoint.io`` (arrays in the .npz, provenance in the JSON
        sidecar)."""
        meta = {
            "step_count": self._step_count,
            "train_mode": self.mode,
            "schedule": (self.schedule.to_json()
                         if self.schedule is not None else None),
            "history": [dataclasses.asdict(e) for e in self.history],
            "triggers": {t.name: t.state_dict() for t in self.triggers
                         if hasattr(t, "state_dict")},
        }
        ckpt.save(path, self.telemetry.state_arrays(), metadata=meta)
        return path

    def restore_state(self, path: str) -> None:
        meta = ckpt.load_metadata(path)["metadata"]
        if meta.get("train_mode") != self.mode:
            raise ValueError(
                f"runtime state was saved for train_mode="
                f"{meta.get('train_mode')!r}, controller runs {self.mode!r}")
        self.telemetry.load_state_arrays(ckpt.load_arrays(path))
        if not self.telemetry.comm_samples():
            # pre-observe checkpoints carried comm samples in the JSON
            # sidecar instead of the array payload
            self.telemetry.record_comm(
                [profiler.CommSample(**c) for c in meta.get("comm", [])])
        self._step_count = int(meta.get("step_count", 0))
        self.history = [SwapEvent(**e) for e in meta.get("history", [])]
        states = meta.get("triggers", {})
        for t in self.triggers:
            if t.name in states and hasattr(t, "load_state_dict"):
                t.load_state_dict(states[t.name])
        sched_json = meta.get("schedule")
        if sched_json is not None:
            self.schedule = S.schedule_from_json(sched_json)
            self._build()
        elif self.schedule is not None:
            # the checkpoint predates any swap: the static plan was live,
            # so a constructor-supplied schedule must not survive restore
            self.schedule = None
            self._build()


def _world() -> int:
    """The default process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1
