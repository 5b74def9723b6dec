"""The key-needing compressors (``randk``, ``topk_sampled``), the
per-(step, leaf, worker) streams and the Eq. 20 delta metric of the
port, against their contract and against ``repro``.

The port draws with ``torch.Generator`` streams named by the
reference's coordinates (``compressors.Key``); JAX's threefry cannot be
reproduced, so:

  * the contract is checked on the port's own draws: k distinct indices
    in [0, d), values equal to x[idx], a fixed draw per (seed, step,
    leaf, worker) and a fresh one per step;
  * bitwise equality with the reference holds with JAX's draws injected
    through the one draw function (``compressors._sample_indices``
    monkeypatched to draw from the JAX key that the same coordinates
    name): the compressors, and the simulated ``lags_dp``, ``slgs`` and
    ``lags_hier2`` exchanges at P ∈ {1, 2, 4}, mean and residual over two
    steps;
  * ``delta_metric`` with ``n_rand=0`` (closed-form denominator) to rtol
    1e-6 of the reference (the sums run in another order), and with
    ``n_rand > 0`` and injected draws; 3 ``SimTrainer`` steps with
    ``measure_delta`` at ``test_torch_train.py``'s tolerances.
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
from repro.core import assumption as JAS  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import lags as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.api import registry as TR  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.core import assumption as TAS  # noqa: E402
from repro_torch.core import compressors as TC  # noqa: E402
from repro_torch.core import lags as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

LEAVES = {"a": (100,), "b": (40, 130), "c": (3, 700), "d": (2, 1024)}
SAMPLERS = ("randk", "topk_sampled")


def _jax_key(key: TC.Key):
    """The JAX key the same coordinates name in the reference."""
    k = jax.random.PRNGKey(key.seed)
    for x in key.path:
        if isinstance(x, tuple):          # ("split", n, j)
            k = jax.random.split(k, x[1])[x[2]]
        else:
            k = jax.random.fold_in(k, x)
    return k


def _jax_draw(key, d, n, replace, device):
    """``_sample_indices`` with the reference's draws."""
    jk = _jax_key(key)
    if replace:
        idx = jax.random.randint(jk, (n,), 0, d)
    else:
        idx = jax.random.choice(jk, d, shape=(n,), replace=False)
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(TC, "_sample_indices", _jax_draw)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _assert_bitwise(got, want, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, i)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} output {i}")


def _x(d, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(d).astype(np.float32))


@pytest.mark.parametrize("name", SAMPLERS)
@pytest.mark.parametrize("d,k", [(7, 3), (1000, 10), (5000, 50),
                                 (300, 300)])
def test_sampler_contract(name, d, k):
    """k distinct indices in range, values x[idx]; the same draw for the
    same (seed, step, leaf, worker); another step, leaf or worker draws
    anew."""
    comp = TC.get_compressor(name)
    assert comp.needs_key
    x = _x(d)
    run = tapi.RunConfig(seed=5)

    def pick(step, leaf, worker):
        key = TL._leaf_key(run.key_at(step), leaf, worker)
        return comp(x, k, key=key)

    vals, idx = pick(0, 1, 0)
    assert idx.dtype == torch.int32 and vals.shape == idx.shape == (k,)
    assert len(set(idx.tolist())) == k
    assert 0 <= int(idx.min()) and int(idx.max()) < d
    assert torch.equal(vals, x[idx.long()])
    again = pick(0, 1, 0)
    assert torch.equal(again[1], idx) and torch.equal(again[0], vals)
    if name == "randk" and k < d:
        for other in (pick(1, 1, 0), pick(0, 2, 0), pick(0, 1, 1)):
            assert not torch.equal(other[1], idx)


def test_topk_sampled_draws_a_fresh_sample_every_step(monkeypatch):
    """The threshold's sample is redrawn each step (the reference's
    stale-key fix)."""
    seen = []
    real = TC._sample_indices

    def spy(key, d, n, replace, device):
        out = real(key, d, n, replace, device)
        seen.append(out.clone())
        return out

    monkeypatch.setattr(TC, "_sample_indices", spy)
    x = _x(20000, 3)
    run = tapi.RunConfig(seed=1)
    for step in range(3):
        TC.topk_sampled_compress(x, 20, key=run.key_at(step))
    assert len(seen) == 3 and all(s.shape == (256,) for s in seen)
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[1], seen[2])


def test_streams_fold_the_reference_coordinates():
    run = tapi.RunConfig(seed=7)
    k = run.key_at(3)
    assert k == TC.Key(7, (3,))
    assert TL._leaf_key(k, 2, 5) == TC.Key(7, (3, 2, 5))
    assert TL._leaf_key(None, 2) == TC.Key(0, (2,))
    assert TL._worker_keys(k, 2, 3) == [TC.Key(7, (3, 2, w))
                                         for w in range(3)]
    assert TL._worker_keys(k, 2, 2, base=4) == [TC.Key(7, (3, 2, 4)),
                                                 TC.Key(7, (3, 2, 5))]
    seeds = {TC.Key(7, p).seed64() for p in
             ((), (0,), (1,), (0, 1), (1, 0), (-1,), (("split", 2, 0),),
              (("split", 2, 1),))}
    assert len(seeds) == 8            # distinct coordinates, distinct seeds
    a = TC._sample_indices(k, 100, 10, False, "cpu")
    assert torch.equal(a, TC._sample_indices(k, 100, 10, False, "cpu"))
    assert TL._worker_index(None) == 0


@pytest.mark.parametrize("d,k", [(100, 12), (5000, 12), (5000, 5000),
                                 (3, 3)])
def test_compressors_bitwise_with_injected_draws(jax_draws, d, k):
    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    key = TC.Key(4).fold_in(9).fold_in(2)
    jk = _jax_key(key)
    _assert_bitwise(TC.randk_compress(xt, k, key),
                    JC.randk_compress(xj, k, jk), "randk")
    _assert_bitwise(TC.topk_sampled_compress(xt, k, key=key),
                    JC.topk_sampled_compress(xj, k, key=jk), "topk_sampled")
    _assert_bitwise(TC.topk_sampled_compress(xt, k),
                    JC.topk_sampled_compress(xj, k), "topk_sampled key=None")
    _assert_bitwise([TC.randk_dense(xt, k, key)],
                    [JC.randk_dense(xj, k, jk)], "randk_dense")
    _assert_bitwise([TC.topk_dense(xt, k)], [JC.topk_dense(xj, k)],
                    "topk_dense")
    # randk clamps a budget past d (topk_sampled rejects it, as the
    # reference's lax.top_k does)
    _assert_bitwise(TC.randk_compress(xt, d + 4, key),
                    JC.randk_compress(xj, d + 4, jk), "randk k > d")
    _assert_bitwise(
        [TC.sparsify_from(TC.topk_sampled_compress, xt, k, key=key,
                          sample_frac=0.1)],
        [JC.sparsify_from(JC.topk_sampled_compress, xj, k, key=jk,
                          sample_frac=0.1)], "sparsify_from")


def _tree(p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal((p,) + s)).astype(np.float32)
            for k, s in LEAVES.items()}


def _pair(mode, compressor, p):
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    kw = dict(mode=mode, ratio=16.0, compressor=compressor, block_size=1024,
              sim=True, n_workers=p)
    if mode == "lags_hier2":
        # P = 4: 2 pods x 2 with a sparse inner tier (the outer streams
        # shift past the inner workers'); P = 2: one pod, dense inner
        kw.update(n_inner=2 if p == 4 else p,
                  ratio_inner=4.0 if p == 4 else 1.0)
    return (TR.build_exchange(TR.ExchangeSpec(params_like=like, **kw)),
            JR.build_exchange(JR.ExchangeSpec(params_like=like, **kw)))


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("mode", ["lags_dp", "slgs", "lags_hier2"])
@pytest.mark.parametrize("compressor", SAMPLERS)
def test_sampled_exchanges_bitwise_with_injected_draws(jax_draws, p, mode,
                                                       compressor):
    """Two steps, the residual fed back, each with its step's stream
    (``RunConfig.key_at``): per-leaf means and residuals (every tier's)
    bit for bit."""
    tex, jex = _pair(mode, compressor, p)
    trun, jrun = tapi.RunConfig(seed=11), japi.RunConfig(seed=11)
    like = {k: torch.zeros((p,) + s) for k, s in LEAVES.items()}
    te = tex.init(like)
    je = jex.init(jax.tree.map(jnp.asarray, _tree(p, 0)))
    jstep = jax.jit(lambda u, e, key: jex.exchange(u, e, None, key=key))
    for step in range(2):
        u = _tree(p, 20 + step)
        tm, te = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                              te, None, key=trun.key_at(step))
        jm, je = jstep(jax.tree.map(jnp.asarray, u), je, jrun.key_at(step))
        _assert_bitwise(tree.leaves(tm), jax.tree.leaves(jm),
                        f"mean@{step}")
        _assert_bitwise(tree.leaves(te), jax.tree.leaves(je),
                        f"residual@{step}")
    assert any(float(x.abs().sum()) > 0 for x in tree.leaves(te))


def test_local_select_without_key_uses_the_fixed_stream(jax_draws):
    """No key: every worker draws from ``Key(0)``, the reference's
    ``PRNGKey(0)``."""
    comp = TC.get_compressor("randk")
    u = np.random.default_rng(1).standard_normal((2, 50)).astype(np.float32)
    e = np.zeros((2, 50), np.float32)
    got = TL.local_select_ef(torch.from_numpy(u), torch.from_numpy(e), 5,
                             comp)
    for w in range(2):
        want = JL.local_select_ef(jnp.asarray(u[w]), jnp.asarray(e[w]), 5,
                                  JC.get_compressor("randk"))
        _assert_bitwise([g[w] for g in got], want, f"worker {w}")


@pytest.mark.parametrize("p,d,k", [(1, 50, 5), (2, 1000, 10),
                                   (4, 3000, 300), (3, 64, 64)])
def test_delta_metric_matches_reference(p, d, k, jax_draws):
    xs = np.random.default_rng(d).standard_normal((p, d)).astype(np.float32)
    xt, xj = torch.from_numpy(xs), jnp.asarray(xs)
    got = TAS.delta_metric(xt, k, None, n_rand=0)
    want = JAS.delta_metric(xj, k, None, n_rand=0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    key = TC.Key(17).fold_in(3)
    got = TAS.delta_metric(xt, k, key, n_rand=4)
    want = JAS.delta_metric(xj, k, _jax_key(key), n_rand=4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    tree_in = {"w": xt.reshape(p, 2, -1) if d % 2 == 0 else xt, "v": xt}
    jtree = {k_: jnp.asarray(v.numpy()) for k_, v in tree_in.items()}
    ks = {"w": k, "v": max(1, k // 2)}
    got = TAS.delta_metric_tree(tree_in, ks, key, n_rand=2)
    want = JAS.delta_metric_tree(jtree, ks, _jax_key(key), n_rand=2)
    for name in ks:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-6)


P, STEPS, B, S = 2, 3, 2, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16)


@pytest.mark.parametrize("compressor", ["topk_exact", "randk"])
def test_measure_delta_three_steps_match_reference(jax_draws, compressor):
    """``measure_delta`` on ``lags_dp`` (and a sampled exchange): losses
    rtol 1e-5, parameters and the per-leaf delta rtol 1e-4 atol 1e-5 of
    the reference's ``SimTrainer`` over 3 steps; the delta rides along
    without changing the step."""
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    cfg_t = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    kw = dict(mode="lags_dp", ratio=8.0, lr=0.1, compressor=compressor,
              measure_delta=True, seed=2)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg_j.vocab, (P, B, S + 1)).astype(np.int32)
        batches.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    jtr = japi.Session(cfg_j, japi.RunConfig(**kw)).simulator(
        lambda p, b: JT.loss_fn(p, cfg_j, b, chunk=8, loss_chunk=8),
        params, n_workers=P)
    ttr = tapi.Session(cfg_t, tapi.RunConfig(**kw), device="cpu").simulator(
        lambda p, b: TT.loss_fn(p, cfg_t, b, chunk=8, loss_chunk=8),
        module.params, n_workers=P)
    jhist = jtr.run(lambda t: jax.tree.map(jnp.asarray, batches[t]), STEPS,
                    log_every=1)
    thist = ttr.run(lambda t: {k: torch.from_numpy(v)
                               for k, v in batches[t].items()},
                    STEPS, log_every=1)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for th, jh in zip(thist, jhist):
        assert len(th["delta_per_leaf"]) == 12
        np.testing.assert_allclose(th["delta_per_leaf"],
                                   jh["delta_per_leaf"], rtol=1e-4,
                                   atol=1e-5)
        for name in ("delta_max", "delta_mean"):
            np.testing.assert_allclose(th[name], jh[name], rtol=1e-4,
                                       atol=1e-5)
    for got, want in zip(tree.leaves(TT.to_numpy_tree(module)),
                         jax.tree.leaves(jtr.state["params"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    for got, want in zip(tree.leaves(ttr.state["ef"]),
                         jax.tree.leaves(jtr.state["ef"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
