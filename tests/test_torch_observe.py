"""The port's observe plane (``repro_torch.observe``, ``pipeline.overlap``)
against the reference's ``repro.observe``, on the CPU.

  * the metrics exporters: the golden plane of ``tests/test_metrics.py``
    built through the port's registry and event log gives
    ``tests/golden/metrics.prom`` and ``snapshot.jsonl`` byte for byte;
    events and ``check.validate`` agree with the reference's on one
    snapshot, and ``python -m repro_torch.observe.check`` is the same
    CLI gate;
  * the anomaly detector, ``HealthMonitor``-free triggers and the
    fingerprint trigger fed the same series fire on the same steps and
    end in the same ``state_dict``;
  * ``FakeTraceBackend.capture(t).to_json()`` equals the reference's for
    the same leaves, wires and schedule (flat, two-tier, waves), and
    ``comm_samples``, ``backward_times``, ``attribute_leaves`` and
    ``overlap_report`` equal the reference's on it; the chrome export
    round-trips;
  * ``capture_trace`` of a real step on a gloo world of one carries the
    ``lags/comm/...`` names of every leaf's collective (host ranges: the
    CPU has no device ranges).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.autotune import profiler as JPR  # noqa: E402
from repro.autotune import schedule as JS  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.observe import anomaly as JAN  # noqa: E402
from repro.observe import attribution as JOA  # noqa: E402
from repro.observe import check as JCK  # noqa: E402
from repro.observe import events as JOE  # noqa: E402
from repro.observe import metrics as JOM  # noqa: E402
from repro.observe import names as JN  # noqa: E402
from repro.observe import trace as JOT  # noqa: E402
from repro.observe import triggers as JTG  # noqa: E402
from repro.pipeline import buckets as JWB  # noqa: E402
from repro.runtime import telemetry as JTM  # noqa: E402
from repro_torch.autotune import profiler as TPR  # noqa: E402
from repro_torch.autotune import schedule as TS  # noqa: E402
from repro_torch.core import comm_model as TCM  # noqa: E402
from repro_torch.observe import anomaly as TAN  # noqa: E402
from repro_torch.observe import attribution as TOA  # noqa: E402
from repro_torch.observe import check as TCK  # noqa: E402
from repro_torch.observe import events as TOE  # noqa: E402
from repro_torch.observe import metrics as TOM  # noqa: E402
from repro_torch.observe import names as TN  # noqa: E402
from repro_torch.observe import trace as TOT  # noqa: E402
from repro_torch.observe import triggers as TTG  # noqa: E402
from repro_torch.pipeline import buckets as TWB  # noqa: E402
from repro_torch.runtime import telemetry as TTM  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's TPU wire numbers, passed to both packages explicitly
WIRE = dict(alpha=1e-6, beta=1.0 / 50e9, flops=197e12)
SLOW = dict(alpha=50e-3, beta=1e-6, flops=197e12)


def _golden_plane(OM, OE):
    """``tests/test_metrics.py``'s golden plane, through either package."""
    reg, evs = OM.MetricsRegistry(), OE.EventLog()
    c = reg.counter("train_steps_total", "Train steps run.", ("mode",))
    c.inc(mode="lags_dp")
    c.inc(2, mode="lags_hier")
    reg.gauge("serve_decode_tokens_per_second",
              "Decode throughput.").set(123.5)
    b = reg.counter("publish_bytes_total", "Wire bytes streamed.",
                    ("kind",))
    b.inc(1024, kind="delta")
    b.inc(4096, kind="full")
    reg.counter("publish_bytes_full_equiv_total",
                "Full-checkpoint-equivalent bytes.").inc(8192)
    h = reg.histogram("replan_step_seconds", "Attributed step seconds.",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 2.0):
        h.observe(v)
    reg.gauge("train_loss", 'Loss with a "weird" label\nvalue.',
              ("mode",)).set(1.5, mode='lags\\dp "quoted"\nnewline')
    reg.gauge("train_health_delta",
              "Online per-leaf Assumption-1 delta (closed-form RandK "
              "denominator); leaf label = lags/health/delta/...",
              ("leaf", "mode")).set(
        0.8125, mode="lags_dp", leaf="lags/health/delta/blocks/0/wq")
    reg.gauge("publish_health_ef_energy",
              "Stream-residual energy retention per leaf.",
              ("leaf",)).set(
        0.25, leaf="lags/health/ef_energy/stream/embed")
    evs.emit("trigger", step=3, name="cadence")
    evs.emit("replan", step=3, swapped=True, improvement=0.25,
             trigger="cadence")
    evs.emit("publish", step=4, version=2, packet_kind="delta",
             nbytes=1024)
    evs.emit("request", step=0, name="serve/request/b2xn4?version=2",
             prefill_s=0.125, decode_tok_s=64.0, version=2)
    evs.emit("health_alarm", step=5, name="lags/health/delta/",
             reason="threshold", delta_max=1.75, threshold=1.5)
    return reg, evs


def _read(path):
    with open(path) as f:
        return f.read()


def test_prometheus_export_is_the_golden_file():
    reg, _ = _golden_plane(TOM, TOE)
    assert reg.to_prometheus() == _read(os.path.join(GOLDEN,
                                                     "metrics.prom"))


def test_snapshot_export_is_the_golden_file(tmp_path):
    reg, evs = _golden_plane(TOM, TOE)
    path = TOM.save_snapshot(str(tmp_path / "snap"), reg, evs,
                             meta={"suite": "golden"})
    assert _read(path) == _read(os.path.join(GOLDEN, "snapshot.jsonl"))
    assert _read(str(tmp_path / "snap") + ".prom") == _read(
        os.path.join(GOLDEN, "metrics.prom"))
    # the sidecar too: the reference's exporter on the same plane
    jreg, jevs = _golden_plane(JOM, JOE)
    JOM.save_snapshot(str(tmp_path / "jsnap"), jreg, jevs,
                      meta={"suite": "golden"})
    assert _read(str(tmp_path / "snap") + ".json") == _read(
        str(tmp_path / "jsnap") + ".json")


@pytest.mark.parametrize("kw", [
    {}, {"require": ("train", "replan", "stream", "serve")},
    {"require": ("train",), "require_health": True, "max_delta": 0.5},
    {"min_overlap": 0.5}, {"max_publish_ratio": 0.25}])
def test_events_and_check_agree_with_the_reference(tmp_path, kw):
    """The same snapshot loads alike and draws the same problems from
    both validators; the event rows carry the reference's fields."""
    reg, evs = _golden_plane(TOM, TOE)
    path = TOM.save_snapshot(str(tmp_path / "snap"), reg, evs)
    tsnap, jsnap = TOM.load_snapshot(path), JOM.load_snapshot(path)
    assert tsnap == jsnap
    assert TCK.validate(tsnap, **kw) == JCK.validate(jsnap, **kw)
    assert [dataclasses.asdict(e) for e in evs.events()] == [
        dataclasses.asdict(e) for e in _golden_plane(JOM, JOE)[1].events()]
    assert TOE.subsystem_of_kind("health_alarm") == \
        JOE.subsystem_of_kind("health_alarm")


def test_check_cli_exit_codes(tmp_path):
    reg, evs = _golden_plane(TOM, TOE)
    path = TOM.save_snapshot(str(tmp_path / "snap"), reg, evs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for args, want in (((), 0), (("--require-health", "--max-delta",
                                  "0.5"), None)):
        out = [subprocess.run(
            [sys.executable, "-m", f"{pkg}.observe.check", path, *args],
            env=env, capture_output=True, text=True,
            stdin=subprocess.DEVNULL) for pkg in ("repro_torch", "repro")]
        assert out[0].returncode == out[1].returncode
        assert out[0].stdout == out[1].stdout
        if want is not None:
            assert out[0].returncode == want
        else:
            assert out[0].returncode > 0


# ---------------------------------------------------------------------------
# anomaly detector and triggers: the same series, the same firings
# ---------------------------------------------------------------------------

def _series():
    rng = np.random.default_rng(11)
    base = 0.05 + 0.002 * rng.standard_normal(40)
    base[25:] *= 1.8                       # a wire regression at step 25
    base[5] = 0.4                          # one compile-like spike
    return [float(x) for x in base]


def _detector_run(AN, TM, cfg_kw):
    det = AN.StepTimeAnomalyDetector(AN.AnomalyConfig(**cfg_kw))
    tel = TM.Telemetry(window=16)
    fired = []
    for i, t in enumerate(_series()):
        tel.record_step(i, t)
        a = det.observe(tel.step_samples())
        if a is not None:
            fired.append(dataclasses.asdict(a))
            if i == 30:
                det.reset()
    return fired, det.state_dict()


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(warmup=1, recent=2, min_history=2, z=4.0, min_rel=0.2),
    dict(warmup=3, recent=4, min_history=6, z=3.0, min_rel=0.1)])
def test_anomaly_detector_fires_alike(cfg_kw):
    got = _detector_run(TAN, TTM, cfg_kw)
    want = _detector_run(JAN, JTM, cfg_kw)
    assert got == want
    assert got[0], "the regression must fire"
    # state_dict round-trips into a fresh detector of either package
    for AN in (TAN, JAN):
        det = AN.StepTimeAnomalyDetector(AN.AnomalyConfig(**cfg_kw))
        det.load_state_dict(json.loads(json.dumps(got[1])))
        assert det.state_dict() == got[1]


def _schedule(S, name, alpha, beta):
    plans = tuple(S.LeafPlan(name=f"layers/{i}/w", d=d, ratio=r,
                             k=max(1, int(round(d / r))))
                  for i, (d, r) in enumerate(((1024, 1.0), (8192, 16.0),
                                              (65536, 100.0))))
    return S.Schedule(arch="small", shape="test", n_workers=8,
                      hardware={"name": name, "alpha": alpha,
                                "beta": beta},
                      leaves=plans, train_mode="lags_dp")


def _trigger_run(TG, AN, TM, PR, S, CM):
    """Cadence, anomaly and fingerprint triggers over one telemetry
    stream: a step-time regression at step 9 and a wire that drifts
    from the schedule's fingerprint from step 16 on."""
    trigs = (TG.CadenceTrigger(5),
             TG.AnomalyTrigger(cfg=AN.AnomalyConfig(
                 warmup=1, recent=2, min_history=2, z=4.0, min_rel=0.2)),
             TG.FingerprintTrigger(drift=0.5, latest=8))
    sched = _schedule(S, "fit", 1e-5, 1e-10)
    tel = TM.Telemetry(window=16)
    fired = []
    for step in range(1, 24):
        tel.record_step(step, 0.05 if step < 9 else 0.09)
        hw = CM.Hardware(name="wire", alpha=1e-5 if step < 16 else 4e-5,
                         beta=1e-10 if step < 16 else 4e-10, flops=1e12)
        tel.record_comm([PR.CommSample("allgather", float(n), 8,
                                       CM.allgather_time(float(n), 8, hw),
                                       label="flat/l0")
                         for n in (1 << 12, 1 << 16, 1 << 20)])
        ctx = TG.TriggerContext(step=step, telemetry=tel, schedule=sched,
                                mode="lags_dp")
        names = [t.name for t in trigs if t.due(ctx)]
        if names:
            fired.append((step, names))
            for t in trigs:
                t.notify_replan(ctx, None)
    return fired, trigs[1].state_dict(), trigs[2].last_tier


def test_triggers_fire_alike_on_one_stream():
    got = _trigger_run(TTG, TAN, TTM, TPR, TS, TCM)
    want = _trigger_run(JTG, JAN, JTM, JPR, JS, JCM)
    assert got == want
    fired = {n for _, names in got[0] for n in names}
    assert fired == {"cadence", "anomaly", "fingerprint"}
    assert TTG.default_triggers(7)[0].every == 7


# ---------------------------------------------------------------------------
# the fake backend and attribution
# ---------------------------------------------------------------------------

def _leaves(PR, ds=(1024, 8192, 65536, 262144), t_backward=1e-3):
    return [PR.LeafSample(name=f"layers/{i}/w", d=d, backward_flops=4.0 * d,
                          t_backward=t_backward * (1 + i))
            for i, d in enumerate(ds)]


def _hier(S):
    inner = dataclasses.replace(_schedule(S, "ici", 1e-6, 2e-11),
                                tier="inner", train_mode="lags_hier2",
                                n_workers=4)
    outer = dataclasses.replace(_schedule(S, "dcn", 1e-5, 4e-11),
                                tier="outer", train_mode="lags_hier2",
                                n_workers=2)
    return S.HierSchedule(arch="small", shape="test", inner=inner,
                          outer=outer)


CASES = {
    "flat": dict(wires=("flat",), sched="flat"),
    "static": dict(wires=("flat",), sched=None, static_ratio=16.0),
    "hier": dict(wires=("inner", "outer"), sched="hier"),
    "waves": dict(wires=("flat",), sched="flat", waves="wave"),
    "async1": dict(wires=("flat",), sched="flat", waves="async1"),
}


def _fake(pkg, case):
    PR, S, CM, OT, WB = pkg
    kw = CASES[case]
    wires = {t: CM.Hardware(name=t, **(WIRE if t != "outer" else SLOW))
             for t in kw["wires"]}
    workers = {"flat": 8, "inner": 4, "outer": 2}
    sched = {"flat": _schedule(S, "fit", 1e-5, 1e-10), "hier": _hier(S),
             None: None}[kw["sched"]]
    waves = None
    if "waves" in kw:
        waves = WB.WaveSchedule(
            waves=(WB.Wave(names=("layers/0/w", "layers/1/w"),
                           leaf_ids=(0, 1)),
                   WB.Wave(names=("layers/2/w", "layers/3/w"),
                           leaf_ids=(2, 3))),
            pipeline=kw["waves"])
    return OT.FakeTraceBackend(
        _leaves(PR), wires, {t: workers[t] for t in wires},
        t_forward=2e-3, schedule_fn=lambda: sched,
        static_ratio=kw.get("static_ratio", 1.0),
        wave_fn=lambda: waves)


TPKG = (TPR, TS, TCM, TOT, TWB)
JPKG = (JPR, JS, JCM, JOT, JWB)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_backend_and_attribution_match_the_reference(case, tmp_path):
    tfake, jfake = _fake(TPKG, case), _fake(JPKG, case)
    ttr, jtr = tfake.capture(3), jfake.capture(3)
    assert ttr.to_json() == jtr.to_json()
    # attribution of the same events: the same samples, times, budgets
    assert [dataclasses.asdict(s) for s in TOA.comm_samples(ttr)] == \
        [dataclasses.asdict(s) for s in JOA.comm_samples(jtr)]
    for tier in ("flat", "inner", "outer"):
        assert ([dataclasses.asdict(s)
                 for s in TOA.comm_samples(ttr, tier=tier)]
                == [dataclasses.asdict(s)
                    for s in JOA.comm_samples(jtr, tier=tier)])
    assert TOA.comm_tiers(ttr) == JOA.comm_tiers(jtr)
    assert TOA.backward_times(ttr) == JOA.backward_times(jtr)
    assert TOA.step_time(ttr) == JOA.step_time(jtr)
    assert TOA.forward_time(ttr) == JOA.forward_time(jtr)
    template = [dataclasses.replace(l, t_backward=0.0)
                for l in _leaves(TPR, ds=(1024, 8192, 65536, 262144, 99))]
    jtemplate = [JPR.LeafSample(**dataclasses.asdict(l)) for l in template]
    for total in (None, 0.02):
        got = TOA.attribute_leaves(template, ttr, t_backward_total=total)
        want = JOA.attribute_leaves(jtemplate, jtr, t_backward_total=total)
        assert [dataclasses.asdict(l) for l in got] == \
            [dataclasses.asdict(l) for l in want]
    for fwd in (False, True):
        assert TOA.overlap_report(ttr, include_forward=fwd) == \
            JOA.overlap_report(jtr, include_forward=fwd)
    # the overlap gauges, and the chrome export's round trip
    treg, jreg = TOM.MetricsRegistry(), JOM.MetricsRegistry()
    from repro.pipeline import overlap as JPO
    from repro_torch.pipeline import overlap as TPO
    TPO.emit_metrics(TPO.overlap_report(ttr), treg, mode="lags_dp")
    JPO.emit_metrics(JPO.overlap_report(jtr), jreg, mode="lags_dp")
    assert treg.to_prometheus() == jreg.to_prometheus()
    path = TOT.export_chrome_trace(ttr, str(tmp_path / "t.json.gz"))
    back = TOT._parse_chrome_trace(path)
    assert [e.name for e in back] == [e.name for e in ttr.events]
    np.testing.assert_allclose([e.dur for e in back],
                               [e.dur for e in ttr.events], rtol=1e-12)
    assert TOT.Trace.from_json(ttr.to_json()) == ttr


def test_names_grammar_is_the_reference():
    n = TN.comm_name("inner", "allgather", "layers/0/attn/wq",
                     nbytes=4096.0, p=8)
    assert n == JN.comm_name("inner", "allgather", "layers/0/attn/wq",
                             nbytes=4096.0, p=8)
    for name in (n, TN.STEP, TN.FWD, TN.bwd_name("a/b"),
                 TN.health_name("delta", "a"), TN.overlap_name("l3"),
                 TN.serve_name("apply", "delta", version=7), "xla.1",
                 "lags/comm/flat/allgather/l0?nbytes=oops&p=bad"):
        assert TN.parse(name) == JN.parse(name)


def test_one_range_per_occurrence_keeps_device_time():
    """A chrome trace as ``torch.profiler`` writes it on CUDA: each range
    a host ``user_annotation``; the device work launched inside it
    (linked by ``correlation`` to its runtime call) names only the
    innermost range, NCCL's own ``nccl:*`` one for a collective.  A
    range with device work is timed by its envelope; one without (an
    in-place all-reduce at world size 1) keeps its host time."""
    comm = TN.comm_name("flat", "allgather", "blocks", nbytes=64.0, p=4)
    red = TN.comm_name("flat", "allreduce", "health/l0", nbytes=4.0, p=1)

    def host(name, ts, dur, cat="user_annotation"):
        return {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur}

    def launch(ts, corr):
        return {"name": "cudaMemcpyAsync", "ph": "X", "cat": "cuda_runtime",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def device(ts, dur, corr, cat="gpu_memcpy"):
        return {"name": "work", "ph": "X", "cat": cat, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    obj = {"traceEvents": [
        host(TN.STEP, 0, 900), host(comm, 10, 5), host("nccl:x", 11, 3),
        launch(12, 1), device(100, 50, 1),
        host(comm, 20, 5), launch(21, 2), launch(23, 3),
        device(160, 40, 2, "kernel"), device(190, 20, 3),
        host(red, 30, 2), host("aten::mm", 40, 3, "cpu_op"),
        launch(41, 4), device(300, 10, 4, "kernel"),
        {"name": "ac2g", "ph": "f", "cat": "ac2g", "ts": 12},
    ]}
    chosen, counts = TOT._device_spans(obj)
    events = TOT._events_from_chrome_obj(chosen)
    assert counts == {"user_annotation": 1, "device": 3, "device_comm": 2}
    got = [(e.name, round(e.t_start * 1e6), round(e.dur * 1e6))
           for e in events]
    assert got == [(red, 30, 2), (TN.STEP, 100, 210), (comm, 100, 50),
                   (comm, 160, 50)]


def test_capture_trace_of_a_gloo_step_carries_the_comm_names(tmp_path):
    """``capture_trace`` around the real distributed step (lags_dp, the
    smoke config, a gloo world of one): one ``lags/step`` range and one
    ``lags/comm/flat/allgather/blocks`` range per leaf, with the
    reference's byte count (8 bytes per pick: n_blocks·k_b per leaf),
    all host ranges on the CPU; the run's state is carried out of the
    capture by the caller."""
    import torch.distributed as dist
    from repro_torch import api, tree
    from repro_torch.configs import tinyllama_1_1b as tcfg
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    cfg = tcfg.smoke_config()
    with tempfile.NamedTemporaryFile() as f:
        M.init_process_group(f"file://{f.name}", 1, 0, device="cpu")
        try:
            sess = api.Session(cfg, api.RunConfig(mode="lags_dp",
                                                  ratio=8.0),
                               mesh=M.make_mesh(device="cpu"))
            state, _ = sess.init_state()
            batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=0).batch(
                0, 2, 16, device="cpu")
            box = {}

            def one():
                box["out"] = sess.step_fn(state, batch)
                return box["out"]

            tr = TOT.capture_trace(one, log_dir=str(tmp_path / "tr"),
                                   steps=1)
        finally:
            dist.destroy_process_group()
    assert box["out"][0]["step"] == 1
    assert tr.meta["decoder"] == "chrome" and tr.meta["parsed"]
    assert tr.meta["categories"]["device"] == 0
    assert os.path.exists(str(tmp_path / "tr" / "trace.json"))
    assert len(tr.named(TN.STEP)) == 1
    comm = [TN.parse(e.name) for e in tr.named(TN.COMM_PREFIX)]
    leaves = tree.leaves(state["params"])
    ks = tree.leaves(sess.meta["ks"])
    assert len(comm) == len(leaves)
    want = []
    for p, k in zip(leaves, ks):
        d = p.numel()
        bs = min(4096, d)
        k_b = max(1, min(bs, -(-k * bs // d)))
        want.append(8.0 * (-(-d // bs)) * k_b)
    assert sorted(c["nbytes"] for c in comm) == sorted(want)
    assert {(c["tier"], c["kind"], c["label"], c["p"]) for c in comm} == \
        {("flat", "allgather", "blocks", 1)}
    assert TOA.comm_samples(tr) == []          # p = 1: no wire points
    assert TOA.overlap_report(tr)["per_comm"]
