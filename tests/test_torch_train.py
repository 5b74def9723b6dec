"""Three ``SimTrainer`` steps of the port against the JAX ``SimTrainer``:
the same parameters (as numpy), the same numpy batches, P=2 workers,
ratio 8, for ``dense`` and for ``lags_dp`` and ``slgs`` under both
selection backends, with the DGC momentum correction, and under a
schedule the reference planned (mixed ratios, dense leaves among them),
written as JSON and loaded by the port.

A budget that keeps every entry (k >= d, ratio 1) skips the selection
on the kernel path (``kernels.ops.keep_all_rows``); its mean and
residual equal the plain path's and the reference's bit for bit.

Tolerance: losses rtol 1e-5, parameters atol 1e-5 + rtol 1e-4.  The
reference's jit may contract ``lr·g + e`` into one fma inside the step
(``repro/core/lags.py`` local_select_ef, parity note), and the model's
sums run in another order, so the two agree to float32 rounding rather
than bit for bit; the selections themselves are bitwise
(``test_torch_exchange.py``).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api import registry as JR  # noqa: E402
from repro.autotune import planner as JP  # noqa: E402
from repro.autotune import profiler as JPR  # noqa: E402
from repro.configs import tinyllama_1_1b as jcfg  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.api import registry as TR  # noqa: E402
from repro_torch.autotune import schedule as TS  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.core import lags as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

P, STEPS, B, S = 2, 3, 2, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16)


def _batches(vocab):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (P, B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


@pytest.mark.parametrize("mode,backend", [("dense", "xla"),
                                          ("lags_dp", "xla"),
                                          ("lags_dp", "kernel"),
                                          ("slgs", "xla"),
                                          ("slgs", "kernel")])
def test_three_steps_match_jax(mode, backend):
    _three_steps(mode, backend, 0.0)


@pytest.mark.parametrize("mode,backend", [("lags_dp", "xla"),
                                          ("lags_dp", "kernel")])
def test_three_steps_with_momentum_correction_match_jax(mode, backend):
    """mc = 0.9: the per-worker DGC velocity (``mom = mc·mom + lr·g``)
    follows the reference's too."""
    ttr, jtr = _three_steps(mode, backend, 0.9)
    for got, want in zip(tree.leaves(ttr.state["mom"]),
                         jax.tree.leaves(jtr.state["mom"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def _reference_schedule():
    """The reference's plan of the small model at P = 2 on the paper's
    1 GbE wire, from an apportioned 1 ms backward: ratios 1 to 1000.
    (Its dense leaf is small: the reference's kernel path selects a
    k >= d leaf with d arg-max passes, slow in interpret mode.)"""
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    leaves = JPR.apportion_backward(JPR.backprop_leaves(cfg_j, 32.0), 1e-3)
    return JP.plan_schedule(leaves, P, JCM.ETH_1GBPS, arch="small",
                            shape="test")


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_three_steps_under_a_schedule_match_jax(backend):
    """The reference's schedule, as JSON, drives both trainers: the
    port's budgets equal the plan's k's leaf for leaf (c = 1 leaves keep
    everything), and 3 steps match the reference's."""
    jsched = _reference_schedule()
    tsched = TS.Schedule.from_json(jsched.to_json())
    ratios = {lp.ratio for lp in tsched.leaves}
    assert 1.0 in ratios and 1000.0 in ratios and len(ratios) > 3
    ttr, jtr = _three_steps("lags_dp", backend, 0.0,
                            schedules=(tsched, jsched))
    assert tree.leaves(ttr.exchange.ks) == [lp.k for lp in sorted(
        tsched.leaves, key=lambda lp: tree.leaf_paths(
            ttr.state["params"]).index(lp.name))]
    assert tree.leaves(ttr.exchange.ks) == [
        int(k) for k in jax.tree.leaves(jtr.exchange.ks)]


def _three_steps(mode, backend, mc, schedules=(None, None)):
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    cfg_t = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    kw = dict(mode=mode, ratio=8.0, lr=0.1, selection_backend=backend,
              block_size=512, momentum_correction=mc)
    batches = _batches(cfg_j.vocab)

    jtr = japi.Session(cfg_j, japi.RunConfig(
        **kw, schedule=schedules[1])).simulator(
        lambda p, b: JT.loss_fn(p, cfg_j, b, chunk=8, loss_chunk=8),
        params, n_workers=P)
    ttr = tapi.Session(cfg_t, tapi.RunConfig(**kw, schedule=schedules[0]),
                       device="cpu").simulator(
        lambda p, b: TT.loss_fn(p, cfg_t, b, chunk=8, loss_chunk=8),
        module.params, n_workers=P)
    jhist = jtr.run(lambda t: jax.tree.map(jax.numpy.asarray, batches[t]),
                    STEPS, log_every=1)
    thist = ttr.run(lambda t: {k: torch.from_numpy(v)
                               for k, v in batches[t].items()},
                    STEPS, log_every=1)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for got, want in zip(tree.leaves(TT.to_numpy_tree(module)),
                         jax.tree.leaves(jtr.state["params"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    if mode != "dense":     # the EF residuals follow too
        for got, want in zip(tree.leaves(ttr.state["ef"]),
                             jax.tree.leaves(jtr.state["ef"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
    return ttr, jtr


# leaf sizes: one block or less, a short tail block, many blocks; and
# budgets of every leaf at k = d (ratio 1)
KEEP_LEAVES = {"a": (100,), "b": (40, 130), "c": (3, 700), "d": (2, 1024)}


def _keep_all_pair(mode, backend, p):
    like = {k: np.zeros(s, np.float32) for k, s in KEEP_LEAVES.items()}
    kw = dict(mode=mode, ratio=1.0, selection_backend=backend,
              block_size=1024, sim=True, n_workers=p)
    if mode == "lags_hier2":
        kw.update(ratio_inner=1.0, n_inner=2)
    return (TR.build_exchange(TR.ExchangeSpec(params_like=like, **kw)),
            JR.build_exchange(JR.ExchangeSpec(params_like=like, **kw)))


@pytest.mark.parametrize("mode", ["lags_dp", "slgs", "lags_hier2"])
def test_keep_all_budget_is_bitwise_the_plain_path(mode):
    """Ratio 1 everywhere (k >= d): the kernel backend keeps every entry
    without a selection (values in index order); the xla backend sorts
    them by magnitude, as the reference's ``lax.top_k``.  The payload
    order is not compared: the scatter-mean of one worker's distinct
    indices and the residual acc - acc = +0 do not depend on it.  Mean
    and residual: kernel == xla == the reference, bit for bit, two steps
    with the residual fed back (it stays zero)."""
    p = 4 if mode == "lags_hier2" else 2
    tk, _ = _keep_all_pair(mode, "kernel", p)
    tx, jx = _keep_all_pair(mode, "xla", p)
    like = {k: torch.zeros((p,) + s) for k, s in KEEP_LEAVES.items()}
    ek, ex = tk.init(like), tx.init(like)
    ej = jx.init(jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), like))
    rng = np.random.default_rng(4)
    for step in range(2):
        u = {k: rng.standard_normal((p,) + s).astype(np.float32)
             for k, s in KEEP_LEAVES.items()}
        ut = {k: torch.from_numpy(v) for k, v in u.items()}
        mk, ek = tk.exchange(ut, ek, None)
        mx, ex = tx.exchange(ut, ex, None)
        mj, ej = jx.exchange(jax.tree.map(jax.numpy.asarray, u), ej, None)
        for got in ((mk, ek), (mx, ex)):
            for a, b in zip(tree.leaves(got), jax.tree.leaves((mj, ej))):
                np.testing.assert_array_equal(
                    a.numpy().view(np.int32),
                    np.asarray(b, np.float32).view(np.int32))
        for e in tree.leaves(ek):
            assert not e.any()
        np.testing.assert_allclose(
            mk["b"].numpy(), u["b"].mean(0), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_block_budget_of_a_whole_block_is_bitwise_the_reference(use_kernel):
    """``BlockLAGSExchange`` at k_b = bs (k = d, and k one short of d on
    a two-block leaf, whose ceil(k·bs/d) is still bs) keeps every entry
    without a selection on both backends: mean and residual bitwise the
    reference's, a live residual beside them on the other leaves."""
    from repro.core import lags as JL
    ks = {"a": 100, "b": 5199, "c": 2100, "d": 64}
    like = {k: np.zeros(s, np.float32) for k, s in KEEP_LEAVES.items()}
    tex = TL.BlockLAGSExchange(ks=ks, block_size=1024,
                               use_kernel=use_kernel)
    jex = JL.BlockLAGSExchange(ks=ks, block_size=1024)
    for name, k in ks.items():
        d = int(np.prod(KEEP_LEAVES[name]))
        _, bs, k_b = tex._geom(d, k)
        assert (k_b == bs) == (name != "d"), name
    rng = np.random.default_rng(6)
    et = tex.init({k: torch.zeros((2,) + s) for k, s in KEEP_LEAVES.items()})
    ej = jex.init(jax.tree.map(lambda x: jax.numpy.zeros((2,) + x.shape),
                               like))
    for step in range(2):
        u = {k: rng.standard_normal((2,) + s).astype(np.float32)
             for k, s in KEEP_LEAVES.items()}
        mt, et = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                              et, None)
        mj, ej = jex.exchange(jax.tree.map(jax.numpy.asarray, u), ej, None)
        for a, b in zip(tree.leaves((mt, et)), jax.tree.leaves((mj, ej))):
            np.testing.assert_array_equal(
                a.numpy().view(np.int32),
                np.asarray(b, np.float32).view(np.int32))
    assert et["d"].abs().sum() > 0 and not et["a"].any()


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_three_steps_match_reference(weight_decay):
    """``AdamW`` on a small tree: three updates from the same numpy
    gradients and f32 parameters, applied with
    ``apply_deltas``; moments and parameters allclose at rtol 1e-6, atol
    1e-7 (f32; XLA's and torch's ``pow``/``sqrt`` may differ in the last
    bit), the step count equal."""
    import jax.numpy as jnp
    from repro.optim import optimizers as JO
    from repro_torch.optim import optimizers as TO
    rng = np.random.default_rng(3)
    shapes = {"w": (8, 6), "b": {"x": (5,)}}
    params = {"w": rng.standard_normal((8, 6)).astype(np.float32),
              "b": {"x": rng.standard_normal(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
        for _ in range(3)]
    jopt, topt = JO.AdamW(weight_decay=weight_decay), \
        TO.AdamW(weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree.map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, lr=1e-2)
        td, ts = topt.update(tree.map(torch.from_numpy, g), ts, tp, lr=1e-2)
        jp = JO.apply_deltas(jp, jd)
        tp = TO.apply_deltas(tp, td)
    assert ts["count"] == int(js["count"]) == 3
    for name in ("mu", "nu"):
        for a, b in zip(tree.leaves(ts[name]), jax.tree.leaves(js[name])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
