"""The paper's own workloads in the port against the reference: layer
norm and the layer-norm decoders (``llama3_8b``'s and ``nemotron_4_340b``'s
smoke configs build now), the sLSTM and the 2 x 1500 sLSTM LM
(``paper_lstm_ptb``), the residual CNN (``paper_cnn_cifar``) and
``Blobs``, 3 ``SimTrainer`` steps of both paper models, and Eq. 20's delta
on the CNN.

The same parameters (the reference's init, carried over as numpy) and
the same numpy inputs go through both packages.  Tolerances are those of
``test_torch_model.py`` and ``test_torch_train.py``: loss rtol 2e-5,
gradients rtol 2e-4 atol 2e-6 (f32 on the CPU; the sums inside the
matmuls, convolutions, the time loop and the norms run in another
order); 3-step losses rtol 1e-5, parameters and residuals rtol 1e-4
atol 1e-5 (the reference's jit may contract ``lr·g + e`` into one fma;
the selections themselves are bitwise).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.training import train_loop as JTL  # noqa: E402
from repro import api as japi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import compressors as TCP  # noqa: E402
from repro_torch.data import synthetic as TD  # noqa: E402
from repro_torch.models import cnn as TC  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.training import train_loop as TTL  # noqa: E402
from test_torch_sampling import _jax_draw  # noqa: E402

LM_IDS = ("paper_lstm_ptb", "llama3_8b", "nemotron_4_340b")


def _paths(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


def _init_lm(cfg):
    """The reference's ``init_model`` parameters, jitted (its eager
    draws cost seconds on the CPU)."""
    return jax.jit(lambda k: JT.init_model(k, cfg)[0])(jax.random.PRNGKey(0))


def _init_cnn(cfg):
    return jax.jit(JC.init_cnn, static_argnums=1)(jax.random.PRNGKey(0), cfg)


def _assert_grads(got, want):
    for g, w in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-6)


# --- layer norm -------------------------------------------------------------

def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((4, 5, 48))).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias))
    got = TL.layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    assert torch.equal(TL.apply_norm("layernorm", torch.from_numpy(x), p),
                       got)
    with pytest.raises(ValueError, match="norm"):
        TL.apply_norm("batchnorm", torch.from_numpy(x), p)


def test_norm_inits_follow_init_norm():
    """rmsnorm scales by 1 + scale, so its scale starts at zeros;
    layernorm's scale at ones and its bias at zeros."""
    for kind in ("rmsnorm", "layernorm"):
        cfg = dataclasses.replace(TB.get_smoke_config("llama3_8b"), norm=kind)
        p, ax = JL.init_norm(kind, cfg.d_model, jnp.float32)
        assert sorted(TL.norm_specs(kind, (6,))) == sorted(p)
        assert TL.norm_axes(kind, ("embed",)) == ax
        t = TT.Transformer(cfg, device="cpu").params["final_norm"]
        for name, x in p.items():
            np.testing.assert_array_equal(t[name].detach().numpy(),
                                          np.asarray(x))


# --- the LMs: layer-norm decoders and the sLSTM stack -----------------------

@pytest.fixture(scope="module", params=LM_IDS)
def lm_pair(request):
    cfg_j = JB.get_smoke_config(request.param)
    cfg_t = TB.get_smoke_config(request.param)
    params = _init_lm(cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    return cfg_j, cfg_t, params, module


def test_lm_leaf_order_and_shapes_match_reference(lm_pair):
    _, _, params, module = lm_pair
    assert tree.leaf_paths(module.params) == _paths(params)
    assert [tuple(p.shape) for p in tree.leaves(module.params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(params)]


def test_lm_loss_and_grads_match_reference(lm_pair):
    cfg_j, cfg_t, params, module = lm_pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab, (2, 17)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -1                      # masked positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(
        p, cfg_j, b, chunk=8, loss_chunk=8)[0]))(
        params, jax.tree.map(jnp.asarray, batch))
    tl, _ = TT.loss_fn(module.params, cfg_t,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       chunk=8, loss_chunk=8)
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    _assert_grads(grads, jg)


@pytest.mark.parametrize("arch", LM_IDS)
def test_full_config_layouts_match_reference(arch):
    """Published widths, read without allocating: the port's meta
    tensors against the reference's ``eval_shape``, leaf for leaf, with
    the logical axes (``None`` entries included) of both inits."""
    cfg_t, cfg_j = TB.get_config(arch), JB.get_config(arch)
    if arch == "nemotron_4_340b":       # its 96 layers: the eval is slow
        cfg_t = dataclasses.replace(cfg_t, n_layers=2)
        cfg_j = dataclasses.replace(cfg_j, n_layers=2)
    box = {}

    def init(k):
        p, box["axes"] = JT.init_model(k, cfg_j)
        return p
    sds = jax.eval_shape(init, jax.random.PRNGKey(0))
    metas = TT.abstract_params(cfg_t)
    assert tree.leaf_paths(metas) == _paths(sds)
    assert [tuple(x.shape) for x in tree.leaves(metas)] == \
        [tuple(x.shape) for x in jax.tree.leaves(sds)]
    axes = tree.flatten_up_to(tree.flatten(metas)[1], TT.logical_axes(cfg_t))
    assert [tuple(a) for a in axes] == [tuple(a) for a in jax.tree.leaves(
        box["axes"], is_leaf=lambda a: isinstance(a, tuple))]
    if arch == "paper_lstm_ptb":
        assert len(tree.leaves(metas)) == 11
        assert sum(x.numel() for x in tree.leaves(metas)) == 55_524_000


def test_slstm_forward_matches_reference():
    """One block on random parameters and inputs: d_up = int(4/3 · d)
    (170 at d 128), the stabiliser from 0, h = o·c / max(n, 1), the tanh
    GELU, the RMS out-norm with (1 + scale)."""
    d, h = 128, 4
    pj, _ = JX.init_slstm(jax.random.PRNGKey(3), d, h, jnp.float32)
    rng = np.random.default_rng(3)
    pj = dict(pj, b_gates=jnp.asarray(rng.standard_normal(
        pj["b_gates"].shape).astype(np.float32)),
        out_norm=jnp.asarray(0.1 * rng.standard_normal(d).astype(
            np.float32)))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = jax.jit(lambda p, v: JX.slstm_forward(p, v, n_heads=h))(
        pj, jnp.asarray(x))
    pt = {k: torch.from_numpy(np.asarray(v)) for k, v in pj.items()}
    assert pt["up_proj"].shape == (d, 2 * 170)
    got = TX.slstm_forward(pt, torch.from_numpy(x), n_heads=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    specs, axes = TX.slstm_specs(d, h)
    assert {k: s[0] for k, s in specs.items()} == \
        {k: tuple(v.shape) for k, v in pj.items()}
    assert axes == JX.init_slstm(jax.random.PRNGKey(0), d, h,
                                 jnp.float32)[1]


def test_mlstm_pattern_raises_naming_item_13d():
    """The mLSTM pattern that raised builds now (item 13d's xLSTM part;
    its parity is ``test_torch_xlstm.py``'s): an mLSTM/sLSTM stack at the
    paper LSTM's smoke widths runs.  So does a Mamba/attention stack
    there, which raised naming 13d until its last part (its parity is
    ``test_torch_mamba.py``'s)."""
    cfg = dataclasses.replace(TB.get_smoke_config("paper_lstm_ptb"),
                              xlstm_pattern=("mlstm", "slstm"))
    module = TT.Transformer(cfg, device="cpu")
    assert "mlstm" in module.params["decoder"]["blocks"][0]
    hidden, _ = module(torch.zeros((1, 3), dtype=torch.int32))
    assert tuple(hidden.shape) == (1, 3, cfg.d_model)
    assert bool(torch.isfinite(hidden).all())
    # the LSTM carries no FFN (d_ff 0); the hybrid's layers each have one
    hybrid = TT.Transformer(dataclasses.replace(
        cfg, xlstm_pattern=None, attn_period=2, d_ff=2 * cfg.d_model),
        device="cpu")
    assert "mamba" in hybrid.params["decoder"]["blocks"][0]
    hidden, _ = hybrid(torch.zeros((1, 3), dtype=torch.int32))
    assert tuple(hidden.shape) == (1, 3, cfg.d_model)
    assert bool(torch.isfinite(hidden).all())


# --- the CNN ----------------------------------------------------------------

CNN_CASES = [("smoke", 8), ("smoke", 9), ("full", 8), ("full", 9)]


@pytest.fixture(scope="module")
def cnn_pairs():
    out = {}
    for size in ("smoke", "full"):
        get = "get_smoke_config" if size == "smoke" else "get_config"
        cfg_j = getattr(JB, get)("paper_cnn_cifar")
        cfg_t = getattr(TB, get)("paper_cnn_cifar")
        params = _init_cnn(cfg_j)
        out[size] = (cfg_j, cfg_t, params, TC.from_jax_params(
            jax.tree.map(np.asarray, params), cfg_t, device="cpu"))
    return out


@pytest.mark.parametrize("size,image", CNN_CASES)
def test_cnn_loss_acc_and_grads_match_reference(cnn_pairs, size, image):
    """Image sizes 8 and 9 pin both cases of XLA's SAME padding at
    stride 2: (0, 1) for an even size, (1, 1) for an odd one."""
    cfg_j, cfg_t, params, module = cnn_pairs[size]
    rng = np.random.default_rng(image)
    batch = {"images": rng.standard_normal(
        (6, image, image, cfg_t.channels)).astype(np.float32),
        "labels": rng.integers(0, cfg_t.n_classes, (6,)).astype(np.int32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JC.cnn_loss(p, cfg_j, b), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    tl, taux = TC.cnn_loss(module.params, cfg_t,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    assert float(taux["acc"]) == float(jaux["acc"])
    _assert_grads(grads, jg)


def test_cnn_layout_and_round_trip(cnn_pairs):
    """41 leaves and 271,578 parameters at full size, HWIO weights in the
    reference's flatten order; numpy -> port -> numpy is exact."""
    for size, (_, cfg_t, params, module) in cnn_pairs.items():
        assert tree.leaf_paths(module.params) == _paths(params)
        assert [tuple(x.shape) for x in tree.leaves(
            TC.abstract_params(cfg_t))] == \
            [tuple(x.shape) for x in jax.tree.leaves(params)]
        for a, b in zip(tree.leaves(TC.to_numpy_tree(module)),
                        jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, np.asarray(b))
    full = cnn_pairs["full"][3]
    assert len(tree.leaves(full.params)) == 41
    assert sum(x.numel() for x in tree.leaves(full.params)) == 271_578


def test_same_padding_is_xlas():
    assert TC.same_pads(32, 3, 1) == (1, 1)
    assert TC.same_pads(32, 3, 2) == (0, 1)
    assert TC.same_pads(9, 3, 2) == (1, 1)
    assert TC.same_pads(32, 1, 2) == (0, 0)


def test_cnn_init_follows_the_reference_distributions():
    cfg = TB.get_config("paper_cnn_cifar")
    p = TC.CNN(cfg, seed=0, device="cpu").params
    w = p["s2b1"]["w2"].detach()
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 64))) < 0.005
    assert float(p["head"]["b"].detach().abs().max()) == 0.0
    assert bool((p["s0b0"]["scale1"].detach() == 1.0).all())


# --- data -------------------------------------------------------------------

def test_blobs_shapes_determinism_and_fresh_draws():
    """NHWC f32 images and int64 labels in [0, classes), leading (P,)
    under ``worker_batches``; the same draw for the same step, another
    for the next.  The draws are the port's own, not the reference's."""
    blobs = TD.Blobs(n_classes=10, image_size=32, channels=3)
    b = blobs.worker_batches(0, 8, 4, device="cpu")
    assert b["images"].shape == (8, 4, 32, 32, 3)
    assert b["images"].dtype == torch.float32
    assert b["labels"].shape == (8, 4) and b["labels"].dtype == torch.int64
    assert 0 <= int(b["labels"].min()) and int(b["labels"].max()) < 10
    again = blobs.worker_batches(0, 8, 4, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    nxt = blobs.worker_batches(1, 8, 4, device="cpu")
    assert not torch.equal(b["images"], nxt["images"])
    # each image is its class centre plus noise of the reference's scale
    c = blobs.centers("cpu")
    resid = b["images"] - c[b["labels"]]
    assert abs(float(resid.std()) - blobs.noise) < 0.02
    assert dataclasses.asdict(blobs) == dataclasses.asdict(
        JD.Blobs(n_classes=10, image_size=32, channels=3))


def test_lm_input_batch_shapes():
    b = TD.lm_input_batch(3, 2, 5, 11, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (2, 5)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].max()) < 11
    assert torch.equal(TD.lm_input_batch(3, 2, 5, 11, device="cpu")["tokens"],
                       b["tokens"])


# --- training: 3 SimTrainer steps and the Eq. 20 delta ----------------------

P, STEPS = 2, 3


def _cnn_setup():
    cfg_j = JB.get_smoke_config("paper_cnn_cifar")
    cfg_t = TB.get_smoke_config("paper_cnn_cifar")
    params = _init_cnn(cfg_j)
    module = TC.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    rng = np.random.default_rng(4)
    batches = [{"images": rng.standard_normal((P, 4, 8, 8, 3)).astype(
        np.float32), "labels": rng.integers(0, cfg_t.n_classes, (P, 4))
        .astype(np.int32)} for _ in range(STEPS)]
    return (params, module, batches, TC.to_numpy_tree,
            lambda p, b: JC.cnn_loss(p, cfg_j, b),
            lambda p, b: TC.cnn_loss(p, cfg_t, b))


def _lstm_setup():
    cfg_j = JB.get_smoke_config("paper_lstm_ptb")
    cfg_t = TB.get_smoke_config("paper_lstm_ptb")
    params = _init_lm(cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg_j.vocab, (P, 2, 9)).astype(np.int32)
        batches.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return (params, module, batches, TT.to_numpy_tree,
            lambda p, b: JT.loss_fn(p, cfg_j, b, chunk=8, loss_chunk=8),
            lambda p, b: TT.loss_fn(p, cfg_t, b, chunk=8, loss_chunk=8))


def _three_steps(model, run_kw):
    """The reference's and the port's ``SimTrainer`` (the CNN through it
    directly, as the reference's benches drive it), 3 steps from the same
    parameters on the same batches."""
    params, module, batches, to_np, jloss, tloss = \
        (_cnn_setup if model == "cnn" else _lstm_setup)()
    jtr = JTL.SimTrainer(jloss, params, japi.RunConfig(**run_kw),
                         n_workers=P)
    ttr = TTL.SimTrainer(tloss, module.params, tapi.RunConfig(**run_kw),
                         n_workers=P, device="cpu")
    jhist = jtr.run(lambda t: jax.tree.map(jnp.asarray, batches[t]), STEPS,
                    log_every=1)
    thist = ttr.run(lambda t: {k: torch.from_numpy(v)
                               for k, v in batches[t].items()},
                    STEPS, log_every=1)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for got, want in zip(tree.leaves(to_np(module)),
                         jax.tree.leaves(jtr.state["params"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    if run_kw["mode"] != "dense":
        for got, want in zip(tree.leaves(ttr.state["ef"]),
                             jax.tree.leaves(jtr.state["ef"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
    return ttr, jtr, thist, jhist


#: the CNN at the paper benches' ratio, the LSTM at its config's.  At
#: ratio 16 the LSTM's k-th magnitude of w_gates (k = 8192 of 131,072)
#: lies where f32 ties are dense: on the xla path two entries of equal
#: |acc| at the boundary swapped between the packages at step 2 (one
#: pick of 8192 on one worker, measured), through last-bit differences
#: of the gradient that the gradient tolerance allows.
RATIOS = {"cnn": 16.0, "lstm": 250.0}


@pytest.mark.parametrize("model", ["cnn", "lstm"])
@pytest.mark.parametrize("mode,backend", [("dense", "xla"),
                                          ("lags_dp", "xla"),
                                          ("lags_dp", "kernel")])
def test_three_sim_steps_match_reference(model, mode, backend):
    """lr 0.05; every leaf of the smoke models is one row of the
    kernels' selection (d <= 4096) or several blocks of candidates."""
    ttr, _, _, _ = _three_steps(model, dict(
        mode=mode, ratio=RATIOS[model], lr=0.05, selection_backend=backend))
    if mode != "dense":
        assert max(tree.leaves(ttr.exchange.ks)) > 1


def test_cnn_delta_per_leaf_matches_reference(monkeypatch):
    """``measure_delta`` on the CNN: Eq. 20 per leaf, with the
    reference's RandK draws injected, at the 3-step tolerances."""
    monkeypatch.setattr(TCP, "_sample_indices", _jax_draw)
    _, _, thist, jhist = _three_steps("cnn", dict(
        mode="lags_dp", ratio=16.0, lr=0.05, measure_delta=True))
    for th, jh in zip(thist, jhist):
        assert len(th["delta_per_leaf"]) == 12
        np.testing.assert_allclose(th["delta_per_leaf"],
                                   jh["delta_per_leaf"], rtol=1e-4,
                                   atol=1e-5)
