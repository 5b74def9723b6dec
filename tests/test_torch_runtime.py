"""The port's online re-planning (``repro_torch.runtime``: telemetry,
``ReplanController``), its checkpoint format (``checkpoint.io``) and
``Session.run`` against the reference's, on the CPU.

  * telemetry: the same ring semantics (capacity, upper median, the
    fence's baseline and cadence, the comm ring's order) and the same
    ``state_arrays``, loaded across the packages;
  * checkpoints: one tree of f32, bf16 and integer leaves written by
    either package loads into the other bit for bit (bf16 through its
    ``'<V2'`` records: numpy cannot cast those to ``ml_dtypes.bfloat16``,
    so the reference's own ``restore`` of a bf16 leaf fails on either
    package's file and its side reads them with ``load_arrays``); every
    ``.npy`` member and the JSON sidecar are the same bytes;
  * the controller on a gloo world of one against the reference's on a
    1-device mesh, set up as ``tests/test_runtime.py`` and
    ``tests/test_observe.py`` set it up (``meta["n_workers"] = 8``, the
    same synthetic probe or fake-trace wires, the reference's TPU wire
    numbers passed to both as ``RuntimeConfig.hw_base``): the
    ``SwapEvent`` sequences equal in ``swapped``/``trigger``/``hw_name``,
    to rel 1e-9 in the predictions, and the schedules leaf for leaf;
    ``save_state``/``restore_state`` across the packages;
  * 4 steps of ``Session.run`` with a controller (cadence, anomaly and
    health triggers over a fake-trace source) and a ``HealthMonitor``,
    port on gloo world 1 against the reference on its 1-device mesh: the
    same row keys, losses rtol 1e-5, the same replan rows, the final
    checkpoint loading across, and a snapshot ``observe.check`` passes.
"""
import dataclasses
import json
import os
import tempfile
import zipfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.autotune import profiler as JPR  # noqa: E402
from repro.checkpoint import io as JIO  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.observe import anomaly as JAN  # noqa: E402
from repro.observe import events as JOE  # noqa: E402
from repro.observe import health as JH  # noqa: E402
from repro.observe import metrics as JOM  # noqa: E402
from repro.observe import trace as JOT  # noqa: E402
from repro.observe import triggers as JTG  # noqa: E402
from repro.runtime import controller as JRC  # noqa: E402
from repro.runtime import telemetry as JTM  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.autotune import profiler as TPR  # noqa: E402
from repro_torch.checkpoint import io as TIO  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import comm_model as TCM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.observe import anomaly as TAN  # noqa: E402
from repro_torch.observe import check as TCK  # noqa: E402
from repro_torch.observe import events as TOE  # noqa: E402
from repro_torch.observe import health as TH  # noqa: E402
from repro_torch.observe import metrics as TOM  # noqa: E402
from repro_torch.observe import trace as TOT  # noqa: E402
from repro_torch.observe import triggers as TTG  # noqa: E402
from repro_torch.runtime import controller as TRC  # noqa: E402
from repro_torch.runtime import telemetry as TTM  # noqa: E402

# the reference's TPU presets, as numbers both packages are given
FAST = dict(name="tpu_v5e", alpha=1e-6, beta=1.0 / 50e9, flops=197e12)
DCN = dict(name="tpu_dcn", alpha=10e-6, beta=1.0 / 25e9, flops=197e12)
SLOW = dict(name="degraded", alpha=50e-3, beta=1e-6, flops=197e12)
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, dtype="float32", param_dtype="float32")


class Pkg:
    """One package's modules under one set of names."""

    def __init__(self, torch_side: bool):
        self.torch = torch_side
        (self.PR, self.CM, self.IO, self.TM, self.RC, self.TG, self.AN,
         self.OT, self.OM, self.OE, self.H, self.api, self.base) = (
            (TPR, TCM, TIO, TTM, TRC, TTG, TAN, TOT, TOM, TOE, TH, tapi,
             tbase) if torch_side else
            (JPR, JCM, JIO, JTM, JRC, JTG, JAN, JOT, JOM, JOE, JH, japi,
             jbase))

    def hw(self, d):
        return self.CM.Hardware(**d)

    def cfg(self, mode="lags_dp"):
        return dataclasses.replace(
            self.base.get_smoke_config("tinyllama_1_1b"), **SMALL,
            train_mode=mode, compression_ratio=1.0)


T, J = Pkg(True), Pkg(False)


@pytest.fixture(scope="module")
def meshes():
    """(the port's gloo world-1 mesh, the reference's 1-device mesh)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    with tempfile.NamedTemporaryFile() as f:
        M.init_process_group(f"file://{f.name}", 1, 0, device="cpu")
        try:
            yield M.make_mesh(device="cpu"), JM.make_host_mesh(data=1,
                                                               model=1)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _telemetry_run(pkg):
    tel = pkg.TM.Telemetry(window=4, fence_every=2, comm_window=5)
    fenced = [tel.tick(0), tel.tick(1), tel.tick(2) is not None,
              tel.tick(3), tel.tick(4) is not None]
    for i in range(10):
        tel.record_step(i, float(i % 7))
    for i in range(7):
        tel.record_comm([pkg.PR.CommSample("allgather", 4096.0 * (i + 1), 8,
                                           1e-4 * i, label=f"flat/l{i}")])
    return tel, fenced


def test_telemetry_rings_match_the_reference():
    (tt, tf), (jt, jf) = _telemetry_run(T), _telemetry_run(J)
    assert tf == jf == [None, None, True, None, True]
    assert tt.step_samples() == [T.TM.StepSample(**dataclasses.asdict(s))
                                 for s in jt.step_samples()]
    assert tt.median_step_time() == jt.median_step_time()
    assert [dataclasses.asdict(s) for s in tt.comm_samples(latest=3)] == \
        [dataclasses.asdict(s) for s in jt.comm_samples(latest=3)]
    ta, ja = tt.state_arrays(), jt.state_arrays()
    assert sorted(ta) == sorted(ja)
    for k in ta:
        np.testing.assert_array_equal(ta[k], ja[k])
        assert ta[k].dtype == ja[k].dtype
    # across: each package restores the other's arrays
    t2, j2 = T.TM.Telemetry(window=4), J.TM.Telemetry(window=4)
    t2.load_state_arrays(ja)
    j2.load_state_arrays(ta)
    assert [dataclasses.asdict(s) for s in t2.comm_samples()] == \
        [dataclasses.asdict(s) for s in j2.comm_samples()]
    assert t2.step_samples() == tt.step_samples()


# ---------------------------------------------------------------------------
# checkpoints: the reference's .npz + JSON format, both ways, bitwise
# ---------------------------------------------------------------------------

def _ckpt_tree(rng):
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    bf16 = rng.standard_normal((3, 11)).astype(np.float32)
    odd = np.array([np.inf, -0.0, np.nan, 1e-45], np.float32)
    return {"params": {"w": f32, "blocks": [bf16, odd]},
            "step": np.int32(12)}


def _as_torch(t):
    return {"params": {"w": torch.from_numpy(t["params"]["w"]),
                       "blocks": [torch.from_numpy(
                           t["params"]["blocks"][0]).bfloat16(),
                           torch.from_numpy(t["params"]["blocks"][1])]},
            "step": np.asarray(t["step"], np.int32)}


def _as_jax(t):
    return {"params": {"w": jnp.asarray(t["params"]["w"]),
                       "blocks": [jnp.asarray(t["params"]["blocks"][0],
                                              jnp.bfloat16),
                                  jnp.asarray(t["params"]["blocks"][1])]},
            "step": jnp.asarray(t["step"], jnp.int32)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "Vf" and a.dtype != np.float16 else a


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_checkpoints_cross_load_bitwise(tmp_path):
    base = _ckpt_tree(np.random.default_rng(3))
    ttree, jtree = _as_torch(base), _as_jax(base)
    meta = {"note": "x", "n": 3}
    TIO.save(str(tmp_path / "t" / "ck"), ttree, metadata=meta)
    JIO.save(str(tmp_path / "j" / "ck"), jtree, metadata=meta)
    # the same members, the same bytes, the same sidecar
    assert _members(tmp_path / "t" / "ck.npz") == \
        _members(tmp_path / "j" / "ck.npz")
    assert (tmp_path / "t" / "ck.json").read_text() == \
        (tmp_path / "j" / "ck.json").read_text()
    for src in ("t", "j"):
        path = str(tmp_path / src / "ck")
        got = TIO.restore(path, ttree)
        for a, b in zip(tree.leaves(got), tree.leaves(ttree)):
            assert type(a) is type(b)
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert got["params"]["blocks"][0].dtype == torch.bfloat16
        raw = JIO.load_arrays(path)
        assert sorted(raw) == ["params/blocks/0", "params/blocks/1",
                               "params/w", "step"]
        np.testing.assert_array_equal(raw["params/blocks/0"].view(np.uint16),
                                      _bits(jtree["params"]["blocks"][0]))
        f32_like = {"params": {"w": jtree["params"]["w"]},
                    "step": jtree["step"]}
        jgot = JIO.restore(path, f32_like)
        np.testing.assert_array_equal(np.asarray(jgot["params"]["w"]),
                                      base["params"]["w"])
        assert int(jgot["step"]) == 12
        assert TIO.load_metadata(path) == JIO.load_metadata(path)
    with pytest.raises(ValueError, match="shape"):
        TIO.restore(str(tmp_path / "t" / "ck"),
                    {"params": {"w": torch.zeros(7, 5)}})
    with pytest.raises(ValueError, match="missing"):
        TIO.restore(str(tmp_path / "t" / "ck"), {"other": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the controller against the reference's
# ---------------------------------------------------------------------------

def _synth(pkg, hw, p=8):
    out = []
    for n in (1 << 12, 1 << 16, 1 << 20):
        out.append(pkg.PR.CommSample("allgather", float(n), p,
                                     pkg.CM.allgather_time(float(n), p, hw)))
        out.append(pkg.PR.CommSample("allreduce", float(n), p,
                                     pkg.CM.allreduce_time(float(n), p, hw)))
    return out


def _rcfg(pkg, **kw):
    return pkg.RC.RuntimeConfig(**({"replan_every": 10, "fence_every": 1,
                                    "swap_threshold": 0.05,
                                    "min_step_samples": 1,
                                    "hw_base": pkg.hw(FAST),
                                    "hw_base_outer": pkg.hw(DCN)} | kw))


def _controller(pkg, mesh, mode="lags_dp", probe=None, triggers=None,
                **rkw):
    ctl = pkg.RC.ReplanController(
        pkg.cfg(mode), mesh, rcfg=_rcfg(pkg, **rkw), comm_probe=probe,
        run=pkg.api.RunConfig(chunk=16, loss_chunk=16), triggers=triggers)
    ctl.meta["n_workers"] = 8      # one device: pretend the data axis had 8
    for i in range(4):
        ctl.telemetry.record_step(i, 0.05)
    return ctl


def _same_events(tctl, jctl):
    assert len(tctl.history) == len(jctl.history)
    for t, j in zip(tctl.history, jctl.history):
        t, j = dataclasses.asdict(t), dataclasses.asdict(j)
        for k in ("step", "swapped", "trigger", "hw_name"):
            assert t[k] == j[k], k
        for k in ("improvement", "t_pred_current", "t_pred_candidate",
                  "overlap"):
            assert t[k] == pytest.approx(j[k], rel=1e-9, abs=1e-15), k


def _same_schedule(ts, js):
    if js is None:
        assert ts is None
        return
    t, j = json.loads(ts.to_json()), json.loads(js.to_json())
    def plans(obj):
        return [(lp["name"], lp["d"], lp["ratio"], lp["k"])
                for lp in obj["leaves"]]
    assert plans(t) == plans(j)
    for k, v in j["hardware"].items():
        if isinstance(v, float):
            assert t["hardware"][k] == pytest.approx(v, rel=1e-9), k
        else:
            assert t["hardware"][k] == v, k
    assert {k: v for k, v in t.items() if k not in ("leaves", "hardware")} \
        == {k: v for k, v in j.items() if k not in ("leaves", "hardware")}


def test_controller_hysteresis_matches_the_reference(meshes):
    """``tests/test_runtime.py``'s hysteresis case on both packages: a
    stable wire re-plans to no swap, the injected slow wire swaps to a
    sparse plan, the same slow wire again does not swap."""
    out = {}
    for pkg, mesh in ((T, meshes[0]), (J, meshes[1])):
        wire = {"hw": pkg.hw(FAST)}
        ctl = _controller(pkg, mesh,
                          probe=lambda m, a, w=wire, p=pkg: _synth(p, w["hw"]))
        ev1 = ctl.maybe_replan(10)
        wire["hw"] = pkg.hw(SLOW)
        ctl.meta["n_workers"] = 8
        ev2 = ctl.maybe_replan(20)
        ctl.meta["n_workers"] = 8
        ev3 = ctl.maybe_replan(30)
        assert [ev1.swapped, ev2.swapped, ev3.swapped] == [False, True,
                                                           False]
        out[pkg.torch] = ctl
    _same_events(out[True], out[False])
    _same_schedule(out[True].schedule, out[False].schedule)
    assert out[True].meta["ks"] is not None
    assert any(lp.ratio > 1.0 for lp in out[True].schedule.leaves)


def _trace_controller(pkg, mesh, wires, triggers=None):
    ctl = pkg.RC.ReplanController(
        pkg.cfg(), mesh,
        rcfg=_rcfg(pkg, replan_every=100),
        comm_probe=lambda m, a: [],
        run=pkg.api.RunConfig(chunk=16, loss_chunk=16), triggers=triggers)
    ctl.meta["n_workers"] = 8
    fake = pkg.OT.FakeTraceBackend(
        pkg.PR.apportion_backward(ctl._leaf_template, 0.040),
        wires=wires, tier_workers={"flat": 8}, t_forward=0.020,
        schedule_fn=lambda: ctl.schedule)
    ctl.trace_source = fake.capture
    return ctl, fake


def _anomaly_cfg(pkg):
    return pkg.AN.AnomalyConfig(warmup=1, recent=2, min_history=2, z=4.0,
                                min_rel=0.2)


def test_trace_driven_replan_matches_the_reference(meshes, tmp_path):
    """``tests/test_observe.py``'s trace-driven cases on both packages:
    evidence from three slow-wire traces re-plans against the attributed
    fit (``attr_wire_fit``, source "trace"); then a wire regression under
    an anomaly trigger (cadence 100) swaps once, on the same step."""
    out, fired = {}, {}
    for pkg, mesh in ((T, meshes[0]), (J, meshes[1])):
        ctl, fake = _trace_controller(pkg, mesh, {"flat": pkg.hw(SLOW)})
        for i in range(1, 4):
            ctl.ingest_trace(i, fake.capture(i))
        ev = ctl.maybe_replan(3, trigger="test")
        assert ev.hw_name == "attr_wire_fit" and ev.swapped
        assert ctl.measurement_source == "trace"
        wires = {"flat": pkg.hw(FAST)}
        trig = pkg.TG.AnomalyTrigger(cfg=_anomaly_cfg(pkg))
        ctl2, fake2 = _trace_controller(pkg, mesh, wires, triggers=(
            pkg.TG.CadenceTrigger(100), trig))
        hits = []
        for i in range(1, 10):
            if i == 6:
                wires["flat"] = pkg.hw(SLOW)      # the injected regression
            ctl2.ingest_trace(i, fake2.capture(i))
            ctl2._step_count = i
            f = ctl2._fired_triggers()
            if f:
                hits.append((i, f))
                ctl2.maybe_replan(i, trigger=",".join(f))
        assert len(hits) == 1 and hits[0][1] == ["anomaly"]
        out[pkg.torch], fired[pkg.torch] = (ctl, ctl2), hits
    assert fired[True] == fired[False]
    for t, j in zip(out[True], out[False]):
        _same_events(t, j)
        _same_schedule(t.schedule, j.schedule)
        assert t.measurement_source == j.measurement_source


def test_controller_state_cross_loads(meshes, tmp_path):
    """``save_state`` of either package restores into the other: step
    count, swap history, schedule, both telemetry rings and the anomaly
    detector's state; the restored schedule is live in the rebuilt
    step."""
    made = {}
    for pkg, mesh in ((T, meshes[0]), (J, meshes[1])):
        trig = pkg.TG.AnomalyTrigger(cfg=_anomaly_cfg(pkg))
        ctl = _controller(pkg, mesh, triggers=(trig,),
                          probe=lambda m, a, p=pkg: _synth(p, p.hw(SLOW)))
        for i in range(4, 8):
            trig.detector.observe(ctl.telemetry.step_samples())
            ctl.telemetry.record_step(i, 0.05)
        assert ctl.maybe_replan(10).swapped
        ctl._step_count = 17
        made[pkg.torch] = (ctl, ctl.save_state(
            str(tmp_path / ("t" if pkg.torch else "j") / "runtime")))
    for src, dst, mesh in ((True, J, meshes[1]), (False, T, meshes[0])):
        ctl, path = made[src]
        ctl2 = _controller(dst, mesh, triggers=(dst.TG.AnomalyTrigger(
            cfg=_anomaly_cfg(dst)),), probe=lambda m, a: [])
        ctl2.telemetry.record_comm(_synth(dst, dst.hw(FAST)))
        ctl2.restore_state(path)
        assert ctl2._step_count == 17
        assert [dataclasses.asdict(e) for e in ctl2.history] == \
            [dataclasses.asdict(e) for e in ctl.history]
        assert ctl2.schedule.to_json() == ctl.schedule.to_json()
        assert [dataclasses.asdict(s) for s in ctl2.telemetry.step_samples()] \
            == [dataclasses.asdict(s) for s in ctl.telemetry.step_samples()]
        assert [dataclasses.asdict(s) for s in ctl2.telemetry.comm_samples()] \
            == [dataclasses.asdict(s) for s in ctl.telemetry.comm_samples()]
        assert ctl2.triggers[0].state_dict() == ctl.triggers[0].state_dict()
        assert ctl2.meta["ks"] is not None


def test_controller_rejects_dense_and_defaults_to_h100():
    with pytest.raises(ValueError, match="dense"):
        TRC.ReplanController(T.cfg("dense"), None)
    rc = TRC.RuntimeConfig()
    assert rc.hw_base == TCM.H100_NVLINK
    assert (rc.hw_base_outer.alpha, rc.hw_base_outer.beta) == (
        TCM.ETH_1GBPS.alpha, TCM.ETH_1GBPS.beta)
    assert rc.hw_base_outer.flops == TCM.H100_NVLINK.flops
    assert [f.name for f in dataclasses.fields(TRC.RuntimeConfig)] == \
        [f.name for f in dataclasses.fields(JRC.RuntimeConfig)]
    assert [f.name for f in dataclasses.fields(TRC.SwapEvent)] == \
        [f.name for f in dataclasses.fields(JRC.SwapEvent)]


# ---------------------------------------------------------------------------
# Session.run with a controller and a health monitor
# ---------------------------------------------------------------------------

RUN_STEPS, B, S = 4, 2, 16


def _run_session(pkg, mesh, out_dir, start):
    cfg = pkg.cfg()
    run = pkg.api.RunConfig(mode="lags_dp", ratio=8.0, lr=0.1, chunk=8,
                            loss_chunk=8, health_every=1)
    sess = pkg.api.Session(cfg, run, mesh=mesh)
    if pkg.torch:
        state, _ = sess.init_state(params=TT.from_jax_params(
            start, cfg, device="cpu").params)
    else:
        state, _ = sess.init_state()
        flat, treedef = jax.tree.flatten(state["params"])
        state["params"] = jax.tree.unflatten(treedef, [
            jax.device_put(x, y.sharding)
            for x, y in zip(jax.tree.leaves(start), flat)])
    mon = pkg.H.HealthMonitor(threshold=1e-6)
    reg, evs = pkg.OM.MetricsRegistry(), pkg.OE.EventLog()
    wires = {"flat": pkg.hw(SLOW)}
    ctl = sess.controller(
        rcfg=_rcfg(pkg, replan_every=2),
        comm_probe=lambda m, a: [],
        triggers=(pkg.TG.CadenceTrigger(2),
                  pkg.TG.AnomalyTrigger(cfg=_anomaly_cfg(pkg)),
                  pkg.TG.HealthTrigger(mon)),
        metrics=reg, events=evs)
    ctl.meta["n_workers"] = 8
    fake = pkg.OT.FakeTraceBackend(
        pkg.PR.apportion_backward(ctl._leaf_template, 0.040), wires=wires,
        tier_workers={"flat": 8}, t_forward=0.020,
        schedule_fn=lambda: ctl.schedule)
    ctl.trace_source = fake.capture
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (RUN_STEPS, B, S + 1)).astype(np.int32)

    def data_fn(t):
        b = {"tokens": toks[t, :, :-1], "labels": toks[t, :, 1:]}
        return ({k: torch.from_numpy(v) for k, v in b.items()}
                if pkg.torch else b)

    state, hist = sess.run(data_fn, RUN_STEPS, controller=ctl, state=state,
                           out_dir=str(out_dir), metrics=reg, events=evs,
                           health_monitor=mon, log_every=0,
                           print_fn=lambda *a: None)
    return state, hist, ctl, reg


def test_session_run_matches_the_reference(meshes, tmp_path):
    cfg_j = J.cfg()
    start = jax.tree.map(np.asarray,
                         JT.init_model(jax.random.PRNGKey(0), cfg_j)[0])
    tstate, thist, tctl, treg = _run_session(T, meshes[0], tmp_path / "t",
                                             start)
    from repro import compat
    with compat.set_mesh(meshes[1]):
        jstate, jhist, jctl, jreg = _run_session(J, meshes[1],
                                                 tmp_path / "j", start)
    assert [sorted(r) for r in thist] == [sorted(r) for r in jhist]
    np.testing.assert_allclose([r["loss"] for r in thist],
                               [r["loss"] for r in jhist], rtol=1e-5)
    assert [r.get("replan") for r in thist] == \
        [r.get("replan") for r in jhist]
    assert any(r.get("replan", {}).get("swapped") for r in thist)
    for t, j in zip(thist, jhist):
        assert t["health"].keys() == j["health"].keys()
        np.testing.assert_allclose(t["health"]["delta_max"],
                                   j["health"]["delta_max"], rtol=1e-5,
                                   atol=1e-7)
        if "alarm" in j["health"]:
            assert t["health"]["alarm"]["reason"] == \
                j["health"]["alarm"]["reason"]
    _same_events(tctl, jctl)
    _same_schedule(tctl.schedule, jctl.schedule)
    # the artifacts: the same files, cross-loadable, a valid snapshot
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert {"ckpt_final.npz", "ckpt_final.json", "runtime_final.npz",
            "metrics_snapshot.jsonl"} <= set(names)
    tparams = TIO.restore(str(tmp_path / "j" / "ckpt_final"),
                          {"params": tstate["params"]})["params"]
    for got, want in zip(tree.leaves(tparams),
                         jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    assert TIO.load_arrays(str(tmp_path / "t" / "ckpt_final"))["step"] == 4
    snap = TOM.load_snapshot(str(tmp_path / "t" / "metrics_snapshot"))
    assert TCK.validate(snap, require=("train", "replan"),
                        require_health=True) == []
    rows = {r["name"] for r in snap["metrics"]}
    jrows = {r["name"] for r in JOM.load_snapshot(
        str(tmp_path / "j" / "metrics_snapshot"))["metrics"]}
    assert rows == jrows
    leaves = {r["labels"]["leaf"] for r in snap["metrics"]
              if r["name"] == "train_health_delta"}
    assert len(leaves) == len(tree.leaves(tstate["params"]))
    tctl2 = tapi.Session(T.cfg(), tapi.RunConfig(mode="lags_dp"),
                         mesh=meshes[0]).controller(rcfg=_rcfg(T))
    tctl2.restore_state(str(tmp_path / "j" / "runtime_final"))
    assert tctl2.schedule.to_json() == jctl.schedule.to_json()
