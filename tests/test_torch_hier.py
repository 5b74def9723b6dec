"""The port's hierarchy (``lags_hier``, ``lags_hier2``) on the simulation
surface, against the JAX reference: the counterpart of the hier parts of
``tests/test_lags.py``, ``tests/test_distributed.py`` and
``tests/test_pipeline.py``.

Contracts:
  * ``SparseHierLAGSExchange``'s simulation path equals the reference's
    bit for bit, mean and both residuals, two steps with the residuals
    fed back, over P in {2 (1 or 2 workers per pod), 4 (2 per pod)},
    the compressors ``topk_exact``, ``topk_block`` and ``topk_hier`` with
    and without an inner-tier override, and both selection backends (the
    port's plain versions against the reference's kernels in interpret
    mode);
  * the degeneracies: both ratios 1 equal ``dense``; inner ratio 1 equals
    ``lags_hier`` on pod-merged batches; one pod with outer ratio 1
    equals ``lags_dp`` with ``ks = ks_inner``; ``HierLAGSExchange`` with
    no axes is a local top-k (and equals the reference's bit for bit);
  * the per-tier EF invariant ``acc == scatter(values, indices) +
    residual`` bit for bit, and the waved exchange equals the monolithic
    one bit for bit;
  * 3 ``SimTrainer`` steps of ``lags_hier2`` (2 pods × 2) and of
    ``lags_hier`` match the reference's ``SimTrainer`` at
    ``test_torch_train.py``'s tolerances (losses rtol 1e-5; parameters
    and residuals rtol 1e-4 atol 1e-5);
  * a key-needing compressor (either tier) builds under the xla backend
    and raises under the kernel one, as in the reference (the sampled
    exchanges themselves: ``test_torch_sampling.py``);
  * ``lags_hier``'s block layout: ``BlockLAGSExchange(shard_dims=...)``
    equals the reference's bit for bit, and the port's logical axes,
    FSDP specs and laid-first dims equal the reference's on the same
    mesh shapes.

The distributed surface (4 gloo ranks on a (pod, data) mesh) is
``test_torch_hier_distributed.py``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api import registry as JR  # noqa: E402
from repro.configs import tinyllama_1_1b as jcfg  # noqa: E402
from repro.core import lags as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.pipeline import buckets as JB  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.api import registry as TR  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.core import compressors as TC  # noqa: E402
from repro_torch.core import lags as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.pipeline import step as TS  # noqa: E402
from repro_torch.training import train_loop as TLOOP  # noqa: E402

BLOCK = 256
# leaf sizes: one block or less, a short tail block, many blocks
LEAVES = {"a": (100,), "b": (40, 130), "c": (3, 700), "d": (2, 1024)}
# (P, workers per pod)
LAYOUTS = [(2, 1), (2, 2), (4, 2)]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _assert_bitwise(got, want, what):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _tree(p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal((p,) + s)).astype(np.float32)
            for k, s in LEAVES.items()}


def _start_state(p, n_in):
    """Live residuals of both tiers; the outer one the same on every
    worker of a pod, as the exchange keeps it."""
    e = {"inner": _tree(p, 1, 0.1), "outer": _tree(p, 2, 0.1)}
    for k, s in LEAVES.items():
        pods = e["outer"][k].reshape((p // n_in, n_in) + s)[:, :1]
        e["outer"][k] = np.repeat(pods, n_in, axis=1).reshape((p,) + s)
    return e


def _torch_state(e):
    return {t: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
            for t, d in e.items()}


def _hier2_pair(p, n_in, compressor="topk_exact", backend="xla",
                inner=None, ratio=64.0, ratio_inner=8.0):
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    kw = dict(mode="lags_hier2", ratio=ratio, ratio_inner=ratio_inner,
              compressor=compressor, inner_compressor=inner,
              selection_backend=backend, block_size=BLOCK, sim=True,
              n_workers=p, n_inner=n_in)
    return (TR.build_exchange(TR.ExchangeSpec(params_like=like, **kw)),
            JR.build_exchange(JR.ExchangeSpec(params_like=like, **kw)))


@pytest.mark.parametrize("backend", ["xla", "kernel"])
@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("compressor", ["topk_exact", "topk_block",
                                        "topk_hier"])
@pytest.mark.parametrize("p,n_in", LAYOUTS)
def test_sparse_hier_sim_matches_jax(p, n_in, compressor, override,
                                     backend):
    """Mean and both residuals bitwise over two steps, the residuals fed
    back; ``override`` gives the inner tier another compressor."""
    inner = None
    if override:
        inner = "topk_exact" if compressor == "topk_block" else "topk_block"
    tex, jex = _hier2_pair(p, n_in, compressor, backend, inner)
    assert tex.compressor_name == jex.compressor_name
    assert tex.inner_compressor_name == jex.inner_compressor_name
    assert tex.n_inner == jex.n_inner == n_in
    jstep = jax.jit(lambda u, e: jex.exchange(u, e, None))
    e0 = _start_state(p, n_in)
    te, je = _torch_state(e0), jax.tree.map(jnp.asarray, e0)
    for step in range(2):
        u = _tree(p, 10 + step)
        tm, te = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                              te, None)
        jm, je = jstep(jax.tree.map(jnp.asarray, u), je)
        for k in LEAVES:
            _assert_bitwise(tm[k], jm[k], f"mean {k}@{step}")
            for tier in ("inner", "outer"):
                _assert_bitwise(te[tier][k], je[tier][k],
                                f"{tier} residual {k}@{step}")


def test_state_is_one_residual_tree_per_tier():
    tex, jex = _hier2_pair(4, 2)
    like = {k: torch.zeros((4,) + s) for k, s in LEAVES.items()}
    state = tex.init(like)
    want = jex.init(jax.tree.map(jnp.asarray, _tree(4, 0)))
    assert list(state) == list(want) == ["inner", "outer"]
    for tier in state:
        for e, x in zip(tree.leaves(state[tier]), tree.leaves(like)):
            assert e.shape == x.shape and e.dtype == torch.float32
            assert not e.any()


def test_workers_must_factor_into_pods():
    tex, _ = _hier2_pair(3, 2)
    u = {k: torch.zeros((3,) + s) for k, s in LEAVES.items()}
    with pytest.raises(ValueError, match="n_inner=2"):
        tex.exchange(u, tex.init(u), None)


def test_both_tiers_ratio_one_equal_dense():
    """Ratio 1 on both tiers keeps everything: the mean is the dense
    mean and both residuals stay zero (the reference's test_lags)."""
    tex, _ = _hier2_pair(4, 2, ratio=1.0, ratio_inner=1.0)
    u = {k: torch.from_numpy(v) for k, v in _tree(4, 3).items()}
    mean, resid = tex.exchange(u, tex.init(u), None)
    dense, _ = TL.DenseExchange().exchange(u, (), None)
    for k in LEAVES:
        np.testing.assert_allclose(mean[k].numpy(), dense[k].numpy(),
                                   rtol=1e-5, atol=1e-6)
        for tier in ("inner", "outer"):
            assert not resid[tier][k].any()


def _quadratic_loss(p, b):
    # the mean over the batch dim: the gradient on a merged batch is the
    # mean of the sub-batches' gradients
    return (((p["w"][None, :] - b["w"]) ** 2).mean()
            + ((p["v"][None, :] - b["v"]) ** 2).mean(), {})


def _sim_batch(seed, p_workers, b=4):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((p_workers, b, 48)).astype(np.float32),
            "v": rng.standard_normal((p_workers, b, 20)).astype(np.float32)}


def _run_quadratic(run_kw, n_workers, batch_fn, steps=3):
    params = {"w": torch.linspace(-1.0, 1.0, 48).requires_grad_(),
              "v": torch.full((20,), 0.5).requires_grad_()}
    trainer = TLOOP.SimTrainer(_quadratic_loss, params,
                               tapi.RunConfig(lr=0.2, **run_kw),
                               n_workers=n_workers, device="cpu")
    for t in range(steps):
        trainer.step({k: torch.from_numpy(v) for k, v in batch_fn(t).items()})
    return trainer.state


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_inner_ratio_one_equals_lags_hier_on_pod_merged_batches(backend):
    """2 pods × 2: lags_hier2 with a dense inner tier (ratio_inner None
    = 1.0) matches lags_hier run over the pod-merged batches, step for
    step; its inner residual is zero and its outer residual, the same on
    both workers of a pod, is lags_hier's."""
    def batch4(t):
        return _sim_batch(50 + t, 4)

    def batch_pods(t):
        return {k: v.reshape((2, 2 * v.shape[1]) + v.shape[2:])
                for k, v in batch4(t).items()}

    s2 = _run_quadratic(dict(mode="lags_hier2", ratio=4.0, inner_workers=2,
                             selection_backend=backend), 4, batch4)
    s1 = _run_quadratic(dict(mode="lags_hier", ratio=4.0,
                             selection_backend=backend), 2, batch_pods)
    for a, b in zip(tree.leaves(s2["params"]), tree.leaves(s1["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    for r in tree.leaves(s2["ef"]["inner"]):
        assert not r.any()
    for r2, r1 in zip(tree.leaves(s2["ef"]["outer"]), tree.leaves(s1["ef"])):
        pods = r2.reshape((2, 2) + tuple(r2.shape[1:]))
        np.testing.assert_allclose(pods[:, 0].numpy(), r1.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(pods[:, 0], pods[:, 1])


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_single_pod_outer_ratio_one_equals_lags_dp(backend):
    """One pod of 4 with a dense outer tier: lags_hier2 reproduces
    lags_dp with ks = ks_inner (parameters, and the inner residual as
    lags_dp's), and the outer residual stays zero."""
    def batch4(t):
        return _sim_batch(90 + t, 4)

    s2 = _run_quadratic(dict(mode="lags_hier2", ratio=1.0, ratio_inner=4.0,
                             inner_workers=4, selection_backend=backend),
                        4, batch4)
    sd = _run_quadratic(dict(mode="lags_dp", ratio=4.0,
                             selection_backend=backend), 4, batch4)
    for a, b in zip(tree.leaves(s2["params"]), tree.leaves(sd["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(tree.leaves(s2["ef"]["inner"]), tree.leaves(sd["ef"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    for r in tree.leaves(s2["ef"]["outer"]):
        assert not r.any()


def test_hier_lags_no_axes_is_local_topk():
    """No axes: one worker's top-k with error feedback; mean + residual
    == the update, and both equal the reference's bit for bit."""
    u_np = {k: v[0] for k, v in _tree(1, 4).items()}
    ks = TL.ks_from_ratio(u_np, 5.0)
    tex = TL.HierLAGSExchange(ks=ks, inner_axes=(), outer_axes=())
    jex = JL.HierLAGSExchange(ks=ks, inner_axes=(), outer_axes=())
    u = {k: torch.from_numpy(v) for k, v in u_np.items()}
    mean, resid = tex.exchange(u, tex.init(u), None)
    jmean, jresid = jex.exchange(jax.tree.map(jnp.asarray, u_np),
                                 jex.init(u_np), None)
    for k in LEAVES:
        np.testing.assert_allclose((mean[k] + resid[k]).numpy(), u_np[k],
                                   rtol=1e-5, atol=1e-7)
        _assert_bitwise(mean[k], jmean[k], f"mean {k}")
        _assert_bitwise(resid[k], jresid[k], f"residual {k}")
        assert int((mean[k] != 0).sum()) == ks[k]


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_ef_invariant_per_tier_bitwise(backend):
    """Each tier: ``acc == scatter(values, indices) + residual`` bit for
    bit, on the exchange's own inputs, and the exchange's residuals and
    mean are those selections'."""
    p, n_in = 4, 2
    tex, _ = _hier2_pair(p, n_in, "topk_exact", backend, "topk_block")
    e0 = _torch_state(_start_state(p, n_in))
    u = {k: torch.from_numpy(v) for k, v in _tree(p, 21).items()}
    mean, resid = tex.exchange(u, e0, None)
    (icomp, ikw), (comp, kw) = tex._tiers()
    n_out = p // n_in
    for k, s in LEAVES.items():
        d = int(np.prod(s))
        ki, ko = tex.ks_inner[k], tex.ks[k]
        vals, idx, r_in = TL.local_select_ef(u[k], e0["inner"][k], ki, icomp,
                                             **ikw)
        recon = r_in.reshape(p, -1) + TC.decompress(vals, idx, d)
        assert torch.equal(recon, (e0["inner"][k] + u[k]).reshape(p, -1))
        assert torch.equal(r_in, resid["inner"][k])
        m = torch.stack([TL._gathered_scatter_mean(
            vals[o * n_in:(o + 1) * n_in], idx[o * n_in:(o + 1) * n_in], d,
            n_in) for o in range(n_out)])
        e_pod = e0["outer"][k].reshape(n_out, n_in, d)[:, 0]
        v2, i2, r_out = TL.local_select_ef(m, e_pod, ko, comp, **kw)
        recon = r_out + TC.decompress(v2, i2, d)
        assert torch.equal(recon, e_pod + m)
        for o in range(n_out):
            for i in range(n_in):
                assert torch.equal(resid["outer"][k][o * n_in + i]
                                   .reshape(-1), r_out[o])
        assert torch.equal(mean[k].reshape(-1),
                           TL._gathered_scatter_mean(v2, i2, d, n_out))


def test_waved_exchange_equals_exchange_bitwise():
    """Two waves, the second leaf order reversed: the same bits as the
    monolithic exchange (the reference's test_pipeline case)."""
    p = 4
    like = {k: torch.zeros(s) for k, s in LEAVES.items()}
    ex = tapi.build_exchange(tapi.ExchangeSpec(
        mode="lags_hier2", params_like=like, sim=True, n_workers=p,
        ratio=4.0, ratio_inner=2.0, n_inner=2))
    u = {k: torch.from_numpy(v) for k, v in _tree(p, 31).items()}
    state = _torch_state(_start_state(p, 2))
    names = JB.leaf_names({k: np.zeros(s) for k, s in LEAVES.items()})
    n = len(names)
    waves = (JB.Wave(leaf_ids=tuple(range(n - 1, 0, -1)),
                     names=tuple(names[n - 1:0:-1])),
             JB.Wave(leaf_ids=(0,), names=(names[0],)))
    mono_mean, mono_state = ex.exchange(u, state, None)
    tiers = TR.get_exchange("lags_hier2").ef_tiers
    wav_mean, wav_state = TS.waved_exchange(ex, waves, u, state, None,
                                            tiers=tiers)
    for a, b in zip(tree.leaves(mono_mean), tree.leaves(wav_mean)):
        assert torch.equal(a, b)
    for t in tiers:
        for a, b in zip(tree.leaves(mono_state[t]),
                        tree.leaves(wav_state[t])):
            assert torch.equal(a, b)


SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16)


@pytest.mark.parametrize("mode,p,backend,extra", [
    ("lags_hier2", 4, "xla", dict(inner_workers=2, ratio_inner=4.0)),
    ("lags_hier2", 4, "kernel", dict(inner_workers=2, ratio_inner=4.0,
                                     inner_compressor="topk_block")),
    ("lags_hier", 2, "xla", {}),
])
def test_sim_trainer_three_steps_match_jax(mode, p, backend, extra):
    """3 steps of the small transformer, the same start and batches:
    losses rtol 1e-5; parameters and every tier's residuals rtol 1e-4
    atol 1e-5 (the reference's jit may fuse ``lr·g + e``)."""
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    cfg_t = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    kw = dict(mode=mode, ratio=8.0, lr=0.1, selection_backend=backend,
              block_size=512, **extra)
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, cfg_j.vocab, (p, 2, 17)).astype(np.int32)
        batches.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    jtr = japi.Session(cfg_j, japi.RunConfig(**kw)).simulator(
        lambda q, b: JT.loss_fn(q, cfg_j, b, chunk=8, loss_chunk=8),
        params, n_workers=p)
    ttr = tapi.Session(cfg_t, tapi.RunConfig(**kw), device="cpu").simulator(
        lambda q, b: TT.loss_fn(q, cfg_t, b, chunk=8, loss_chunk=8),
        module.params, n_workers=p)
    jhist = jtr.run(lambda t: jax.tree.map(jnp.asarray, batches[t]), 3,
                    log_every=1)
    thist = ttr.run(lambda t: {k: torch.from_numpy(v)
                               for k, v in batches[t].items()}, 3,
                    log_every=1)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for got, want in zip(tree.leaves(TT.to_numpy_tree(module)),
                         jax.tree.leaves(jtr.state["params"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    tiers = TR.get_exchange(mode).ef_tiers
    assert tiers == JR.get_exchange(mode).ef_tiers
    t_ef = [ttr.state["ef"][t] for t in tiers] if tiers else [
        ttr.state["ef"]]
    j_ef = [jtr.state["ef"][t] for t in tiers] if tiers else [
        jtr.state["ef"]]
    for tt, jj in zip(t_ef, j_ef):
        leaves = tree.leaves(tt)
        assert len(leaves) == 12
        for got, want in zip(leaves, jax.tree.leaves(jj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("knob", ["compressor", "inner_compressor"])
def test_key_needing_compressor_raises_naming_item_10(knob):
    """randk in either tier: ported on both surfaces under the xla
    backend (its tier's compressor needs a key), and under the kernel
    backend it raises as the reference's does (no kernel variant)."""
    like = {k: torch.zeros(s) for k, s in LEAVES.items()}
    jlike = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    for sim in (True, False):
        ex = TR.build_exchange(TR.ExchangeSpec(
            mode="lags_hier2", params_like=like, sim=sim, ratio_inner=4.0,
            **{knob: "randk"}))
        tier = ex.compressor if knob == "compressor" else ex.inner_compressor
        assert tier.name == "randk" and tier.needs_key
        for build, params in ((TR, like), (JR, jlike)):
            with pytest.raises(ValueError, match="no kernel-backed"):
                build.build_exchange(build.ExchangeSpec(
                    mode="lags_hier2", params_like=params, sim=sim,
                    selection_backend="kernel", **{knob: "randk"}))


def test_registry_axis_plans_and_spec_match_reference():
    """Every strategy's axis plan and EF tiers are the reference's, and
    the two-tier spec resolves the same budgets and compressors."""
    assert TR.exchange_names() == JR.exchange_names()
    for name in TR.exchange_names():
        t, j = TR.get_exchange(name), JR.get_exchange(name)
        assert (t.axes, t.ef_tiers) == (j.axes, j.ef_tiers), name
    with pytest.raises(ValueError, match="axes plan"):
        TR.register_exchange("x", axes="model_auto")
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    for backend in ("xla", "kernel"):
        kw = dict(mode="lags_hier2", params_like=like, ratio=64.0,
                  ratio_inner=8.0, selection_backend=backend,
                  inner_compressor="topk_block", n_inner=2)
        ts, js = TR.ExchangeSpec(**kw), JR.ExchangeSpec(**kw)
        assert tree.leaves(ts.resolved_ks_inner()) == jax.tree.leaves(
            js.resolved_ks_inner())
        for inner in (False, True):
            assert ts.resolved_compressor(inner=inner) == \
                js.resolved_compressor(inner=inner)
    run = tapi.RunConfig()
    assert run.resolved_ratio_inner() == japi.RunConfig(
    ).resolved_ratio_inner() == 1.0
    assert tapi.RunConfig(ratio_inner=50).resolved_ratio_inner() == 50.0


# -- lags_hier's block layout: the reference's FSDP dims ------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_block_lags_shard_dims_layout_matches_jax(use_kernel):
    """A leaf's sharded dims laid first (the reference's FSDP layout of
    lags_hier): means and residuals bitwise, two steps, P = 2."""
    shapes = {"w": (3, 20, 12), "x": (12, 40)}
    sdims = {"w": (1,), "x": (1,)}
    ks = {"w": 30, "x": 24}
    tex = TL.BlockLAGSExchange(ks=ks, block_size=64, use_kernel=use_kernel,
                               shard_dims=sdims)
    jex = JL.BlockLAGSExchange(ks=ks, block_size=64, use_kernel=use_kernel,
                               shard_dims=sdims)
    rng = np.random.default_rng(5)
    e = {k: (0.1 * rng.standard_normal((2,) + s)).astype(np.float32)
         for k, s in shapes.items()}
    for step in range(2):
        u = {k: rng.standard_normal((2,) + s).astype(np.float32)
             for k, s in shapes.items()}
        tm, te = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                              {k: torch.from_numpy(v) for k, v in e.items()},
                              None)
        jm, je = jax.jit(lambda a, b: jex.exchange(a, b, None))(
            jax.tree.map(jnp.asarray, u), jax.tree.map(jnp.asarray, e))
        for k in shapes:
            _assert_bitwise(tm[k], jm[k], f"mean {k}@{step}")
            _assert_bitwise(te[k], je[k], f"residual {k}@{step}")
            assert te[k].is_contiguous()
        e = jax.tree.map(np.array, je)


@pytest.mark.parametrize("pod,data", [(2, 2), (1, 4), (4, 1)])
def test_fsdp_block_layout_matches_reference(pod, data):
    """The logical axes of every leaf, the FSDP specs over 'data' and the
    dims the block exchange lays first equal the reference's (its
    ``launch.train`` for lags_hier on the same mesh shape, model = 1)."""
    from repro.sharding import rules as JRULES
    from repro_torch.sharding import rules as TRULES
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    cfg_t = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    box = {}

    def initf(k):
        p, box["axes"] = JT.init_model(k, cfg_j)
        return p
    sds = jax.eval_shape(initf, jax.random.PRNGKey(0))
    jaxes = box["axes"]
    tparams = TT.abstract_params(cfg_t)
    is_axes = lambda a: isinstance(a, tuple)   # noqa: E731
    assert tree.flatten_up_to(tree.flatten(tparams)[1],
                              TT.logical_axes(cfg_t)) == \
        jax.tree.leaves(jaxes, is_leaf=is_axes)
    sizes = {"data": data, "model": 1} | ({"pod": pod} if pod > 1 else {})
    tspecs = TRULES.tree_specs(tparams, TT.logical_axes(cfg_t), sizes,
                               fsdp_axis="data")
    want = [tuple(s) for s in jax.tree.leaves(
        jax.tree.map(lambda p, a: JRULES.spec_for_leaf(
            p.shape, a, sizes, fsdp_axis="data"), sds, jaxes,
            is_leaf=is_axes),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]
    treedef = tree.flatten(tparams)[1]
    assert tree.flatten_up_to(treedef, tspecs) == want
    dims = tree.flatten_up_to(treedef, TRULES.shard_dims_tree(
        tparams, tspecs, ("data",)))
    assert dims == [tuple(i for i, e in enumerate(s) if e == "data")
                    for s in want]
    assert any(dims) == (data > 1)
