"""The port's convergence-health plane (``repro_torch.observe.health``)
against ``repro.observe.health``, on the CPU.

  * the helpers (``sq_norm`` … ``staleness_gap``, ``leaf_names``) on the
    same numpy trees, f32 and bf16 leaves: rtol 1e-5;
  * ``HealthMonitor`` fed one delta stream raises the same alarms
    (threshold and drift) and ends in the same ``state_dict``;
  * 3 ``SimTrainer`` steps of the 2-layer smoke TinyLlama at P = 2 with
    ``health_every=1``: ``health_delta``, ``health_delta_max`` and
    ``health_ef_energy_*`` allclose (rtol 1e-5, atol 1e-7) to the
    reference's, flat ``lags_dp`` and ``lags_hier2`` (one pod of two: the
    pod-replicated outer residual summed over P and divided by the
    pod's two workers);
  * the distributed step on a gloo world of one against the reference's
    ``build_train_step`` on a 1-device mesh: the same health keys, the
    values allclose, for ``lags_dp`` off, ``wave`` and ``async1`` (+ mc
    0.9: the staleness gap), ``lags_hier2`` and ``lags_hier``;
  * ``health_every=0`` adds no key, on both surfaces; ``dense`` and
    ``slgs`` (no per-leaf budget) add none either, as in the reference.
"""
import dataclasses
import tempfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import tinyllama_1_1b as jcfg  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.observe import anomaly as JAN  # noqa: E402
from repro.observe import health as JH  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.observe import anomaly as TAN  # noqa: E402
from repro_torch.observe import health as TH  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7
P, STEPS, B, S = 2, 3, 2, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16, dtype="float32", param_dtype="float32")
RUN_KW = dict(ratio=8.0, lr=0.1, chunk=8, loss_chunk=8, block_size=512)


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    shapes = {"a": (40,), "b": [(3, 17), (5, 8, 2)], "c": {"z": (64,)}}

    def leaf(s):
        return rng.standard_normal(lead + s).astype(np.float32)
    return {"a": leaf(shapes["a"]), "b": [leaf(s) for s in shapes["b"]],
            "c": {"z": leaf(shapes["c"]["z"])}}


def _t(x, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.bfloat16() if bf16 else t


def _j(x, bf16=False):
    return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_helpers_match_the_reference(bf16):
    e, m, u = _tree(1), _tree(2), _tree(3)
    te, tm, tu = (tree.map(lambda x: _t(x, bf16), t) for t in (e, m, u))
    je, jm, ju = (jax.tree.map(lambda x: _j(x, bf16), t) for t in (e, m, u))
    ks = {"a": 4, "b": [5, 80], "c": {"z": 64}}     # k = d on "c/z"
    _close(TH.sq_norm(te["a"]), JH.sq_norm(je["a"]))
    _close(TH.sq_leaves(te), JH.sq_leaves(je))
    _close(TH.energy_leaves(te, tu), JH.energy_leaves(je, ju))
    _close(TH.delta_leaves(te, tu, ks), JH.delta_leaves(je, ju, ks))
    _close(TH.delta_leaves_from_mean(te, tm, ks, 3),
           JH.delta_leaves_from_mean(je, jm, ks, 3))
    _close(TH.delta_online(te["a"], tu["a"], 4),
           JH.delta_online(je["a"], ju["a"], 4))
    _close(TH.acc_sq_leaves(te, tu),
           JH.sq_leaves(jax.tree.map(lambda a, b: a + b, je, ju)))
    for k, p in ((4, 2), (40, 1)):
        d, en = TH.delta_energy(te["a"], tm["a"], k, p)
        jagg = je["a"] + float(p) * jm["a"]
        _close(d, JH.delta_online(je["a"], jagg, k))
        _close(en, JH.safe_ratio(JH.sq_norm(je["a"]), JH.sq_norm(jagg)))
    zero = torch.zeros(())
    assert float(TH.safe_ratio(zero, zero)) == float(
        JH.safe_ratio(jnp.zeros(()), jnp.zeros(()))) == 0.0
    _close(TH.staleness_gap(torch.tensor(4.0), torch.tensor(1.0)),
           JH.staleness_gap(jnp.float32(4.0), jnp.float32(1.0)))
    assert TH.leaf_names(te) == JH.leaf_names(je) == [
        "a", "b/0", "b/1", "c/z"]
    assert TH.EPS == JH.EPS


def _monitor_run(H, AN, threshold):
    mon = H.HealthMonitor(threshold=threshold, cfg=AN.AnomalyConfig(
        warmup=1, recent=2, min_history=3, z=4.0, min_rel=0.2))
    rng = np.random.default_rng(5)
    stream = 0.6 + 0.01 * rng.standard_normal(30)
    stream[18:] += 0.5                       # delta creeps up at step 18
    alarms, consumed = [], []
    for t, v in enumerate(stream):
        alarm = mon.observe(t, float(v))
        if alarm is not None:
            alarms.append(alarm)
        if mon.alarming and t % 4 == 3:
            consumed.append(mon.consume())
            mon.reset()
    return alarms, consumed, mon.state_dict()


@pytest.mark.parametrize("threshold", [None, 0.9, 0.5])
def test_health_monitor_alarms_alike(threshold):
    got = _monitor_run(TH, TAN, threshold)
    want = _monitor_run(JH, JAN, threshold)
    assert got == want
    assert got[0], "the creep must raise an alarm"
    for H, AN in ((TH, TAN), (JH, JAN)):
        mon = H.HealthMonitor(threshold=threshold)
        mon.load_state_dict(got[2])
        assert mon.state_dict() == got[2]


# ---------------------------------------------------------------------------
# SimTrainer: 3 steps against the reference's
# ---------------------------------------------------------------------------

def _params():
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    cfg_t = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, jax.tree.map(np.asarray, params)


def _batches(vocab, lead):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, lead + (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _sim(run_kw, health_every=1):
    cfg_j, cfg_t, start = _params()
    kw = RUN_KW | run_kw | dict(health_every=health_every)
    module = TT.from_jax_params(start, cfg_t, device="cpu")
    ttr = tapi.Session(cfg_t, tapi.RunConfig(**kw), device="cpu").simulator(
        lambda p, b: TT.loss_fn(p, cfg_t, b, chunk=8, loss_chunk=8),
        module.params, n_workers=P)
    jtr = japi.Session(cfg_j, japi.RunConfig(**kw)).simulator(
        lambda p, b: JT.loss_fn(p, cfg_j, b, chunk=8, loss_chunk=8),
        jax.tree.map(jnp.asarray, start), n_workers=P)
    batches = _batches(cfg_j.vocab, (P,))
    thist = ttr.run(lambda t: {k: torch.from_numpy(v)
                               for k, v in batches[t].items()},
                    STEPS, log_every=1)
    jhist = jtr.run(lambda t: jax.tree.map(jnp.asarray, batches[t]),
                    STEPS, log_every=1)
    return ttr, thist, jhist


@pytest.mark.parametrize("run_kw", [
    dict(mode="lags_dp"),
    dict(mode="lags_hier2", inner_workers=2, ratio_inner=4.0)],
    ids=["lags_dp", "lags_hier2"])
def test_sim_trainer_health_matches_the_reference(run_kw):
    ttr, thist, jhist = _sim(run_kw)
    for got, want in zip(thist, jhist):
        keys = {k for k in want if k.startswith("health")}
        assert keys == {k for k in got if k.startswith("health")}
        assert "health_delta" in keys
        assert ("health_ef_energy_inner" in keys) == (
            run_kw["mode"] == "lags_hier2")
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in sorted(keys):
            _close(got[k], want[k])
    assert len(thist[0]["health_delta"]) == len(ttr.health_leaf_names)
    assert ttr.health_leaf_names == JH.leaf_names(
        jax.tree.map(np.asarray, _params()[2]))
    assert max(thist[-1]["health_delta"]) > 0.0


@pytest.mark.parametrize("mode", ["lags_dp", "dense", "slgs"])
def test_sim_trainer_health_every_zero_adds_no_key(mode):
    """No key without ``health_every``; none for dense and slgs with it
    either (no per-leaf budget), as the reference's trainer builds it."""
    _, cfg_t, start = _params()
    for every in (0, 1):
        if every and mode == "lags_dp":
            continue
        module = TT.from_jax_params(start, cfg_t, device="cpu")
        ttr = tapi.Session(cfg_t, tapi.RunConfig(
            **(RUN_KW | dict(mode=mode, health_every=every))),
            device="cpu").simulator(
            lambda p, b: TT.loss_fn(p, cfg_t, b, chunk=8, loss_chunk=8),
            module.params, n_workers=P)
        assert not ttr._health
        batch = {k: torch.from_numpy(v)
                 for k, v in _batches(cfg_t.vocab, (P,))[0].items()}
        assert sorted(ttr.step(batch)) == ["loss", "lr"]


# ---------------------------------------------------------------------------
# the distributed step: a gloo world of one against a 1-device mesh
# ---------------------------------------------------------------------------

DIST = {
    "lags_dp": dict(mode="lags_dp"),
    "lags_dp/wave": dict(mode="lags_dp", pipeline="wave",
                         wave_target_bytes=2048),
    "lags_dp/async1/mc0.9": dict(mode="lags_dp", pipeline="async1",
                                 momentum_correction=0.9),
    "lags_dp/async1": dict(mode="lags_dp", pipeline="async1"),
    "lags_hier2": dict(mode="lags_hier2", ratio_inner=4.0),
    "lags_hier": dict(mode="lags_hier"),
}
DIST_STEPS = 2


@pytest.fixture(scope="module")
def gloo_mesh():
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    with tempfile.NamedTemporaryFile() as f:
        M.init_process_group(f"file://{f.name}", 1, 0, device="cpu")
        try:
            yield M.make_mesh(device="cpu")
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(DIST))
def test_distributed_health_matches_the_reference(gloo_mesh, name):
    cfg_j, cfg_t, start = _params()
    kw = RUN_KW | dict(health_every=1) | DIST[name]
    kw.pop("block_size")
    mode = kw["mode"]
    sess = tapi.Session(cfg_t, tapi.RunConfig(**kw), mesh=gloo_mesh)
    state, _ = sess.init_state(params=TT.from_jax_params(
        start, cfg_t, device="cpu").params)
    mesh = JM.make_host_mesh(data=1, model=1)
    jstep, _, _ = japi.build_train_step(
        cfg_j, mesh, japi.RunConfig(donate=False, **kw))
    jstate, _ = JTR.init_state(cfg_j, mesh, method=mode,
                               pipeline=kw.get("pipeline", "off"),
                               momentum_correction=kw.get(
                                   "momentum_correction", 0.0))
    flat, treedef = jax.tree.flatten(jstate["params"])
    jstate["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(x, y.sharding)
        for x, y in zip(jax.tree.leaves(start), flat)])
    batches = _batches(cfg_j.vocab, ())
    for t in range(DIST_STEPS):
        state, got = sess.step_fn(state, {k: torch.from_numpy(v) for k, v
                                          in batches[t].items()})
        with compat.set_mesh(mesh):
            jstate, want = jstep(jstate, batches[t])
        keys = sorted(k for k in want if k.startswith("health"))
        assert keys == sorted(k for k in got if k.startswith("health"))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        for k in keys:
            _close(got[k].numpy(), want[k])
    want_keys = {
        "lags_dp": {"health_delta", "health_delta_max",
                    "health_ef_energy_flat"},
        "lags_hier2": {"health_delta", "health_delta_max",
                       "health_ef_energy_inner", "health_ef_energy_outer"}}
    if name in want_keys:
        assert set(keys) == want_keys[name]
    if "async1" in name:
        assert "health_staleness" in keys


@pytest.mark.parametrize("kw", [dict(mode="lags_dp", health_every=0),
                                dict(mode="dense", health_every=1),
                                dict(mode="slgs", health_every=1)],
                         ids=["lags_dp-0", "dense-1", "slgs-1"])
def test_distributed_health_every_zero_adds_no_key(gloo_mesh, kw):
    """The step as the reference builds it: no key without
    ``health_every``, none for dense and slgs (no per-leaf budget)."""
    _, cfg_t, start = _params()
    sess = tapi.Session(cfg_t, tapi.RunConfig(**(RUN_KW | kw)),
                        mesh=gloo_mesh)
    state, _ = sess.init_state(params=TT.from_jax_params(
        start, cfg_t, device="cpu").params)
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg_t.vocab, ())[0].items()}
    _, metrics = sess.step_fn(state, batch)
    assert sorted(metrics) == ["loss"]
