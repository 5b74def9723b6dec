"""The port's TinyLlama (``repro_torch.models.transformer``) against the
JAX reference on the tinyllama smoke config in f32: the same parameters
(carried over as numpy) and the same numpy batch give the same loss and
gradients.

Tolerance: loss rtol 2e-5, gradients atol 2e-6 + rtol 2e-4.  Both run in
f32 on the CPU; they differ only in the order of sums inside matmuls,
softmax and the chunked cross-entropy, which moves the last few bits.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import tinyllama_1_1b as jcfg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


@pytest.fixture(scope="module")
def model_pair():
    cfg_j = jcfg.smoke_config()
    cfg_t = tcfg.smoke_config()
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg_j)
    np_tree = jax.tree.map(np.asarray, params)
    return cfg_j, cfg_t, params, TT.from_jax_params(np_tree, cfg_t,
                                                    device="cpu")


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                      # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def test_leaf_order_and_shapes_match_jax(model_pair):
    _, _, params, module = model_pair
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(params)[0])
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path in paths]
    assert tree.leaf_paths(module.params) == jpaths
    assert [tuple(p.shape) for p in tree.leaves(module.params)] == \
        [tuple(x.shape) for x in leaves]


def test_full_config_shapes_match_jax():
    """Published tinyllama: 12 leaves, 1,100,048,384 parameters, the
    reference's shapes (read without allocating)."""
    metas = TT._map_specs(lambda spec: torch.empty(spec[0], device="meta"),
                          TT._shapes(tcfg.CONFIG))
    flat = [tuple(t.shape) for t in tree.leaves(metas)]
    jflat = [tuple(x.shape) for x in jax.tree.leaves(
        jcfg.CONFIG._shape_tree()[0])]
    assert flat == jflat
    assert sum(int(np.prod(s)) for s in flat) == 1_100_048_384


@pytest.mark.parametrize("loss_chunk", [16, 24])
def test_loss_and_grads_match_jax(model_pair, loss_chunk):
    """chunk=8 runs the online softmax over 3 KV chunks; loss_chunk=16
    drops the 8-token remainder exactly as the reference does."""
    cfg_j, cfg_t, params, module = model_pair
    batch = _batch(cfg_j)

    def jloss(p):
        return JT.loss_fn(p, cfg_j, jax.tree.map(jax.numpy.asarray, batch),
                          chunk=8, loss_chunk=loss_chunk)[0]

    jl, jg = jax.value_and_grad(jloss)(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, _ = TT.loss_fn(module.params, cfg_t, tb, chunk=8,
                       loss_chunk=loss_chunk)
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-6)


def test_chunked_attention_matches_jax():
    from repro.models import attention as JA
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 10, 2, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    pos = np.arange(10)
    want = JA.chunked_attention(q, k, v, q_positions=pos, k_positions=pos,
                                chunk=4)
    got = TA.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               q_positions=torch.from_numpy(pos),
                               k_positions=torch.from_numpy(pos), chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_numpy_round_trip_is_exact(model_pair):
    _, _, params, module = model_pair
    back = TT.to_numpy_tree(module)
    for a, b in zip(tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_bf16_params_carry_over_exactly():
    cfg = dataclasses.replace(tcfg.smoke_config(), param_dtype="bfloat16",
                              dtype="bfloat16")
    cfg_j = dataclasses.replace(jcfg.smoke_config(), param_dtype="bfloat16",
                                dtype="bfloat16")
    params, _ = JT.init_model(jax.random.PRNGKey(1), cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    for p, x in zip(tree.leaves(module.params), jax.tree.leaves(params)):
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(x, np.float32))


def test_random_init_matches_reference_distributions():
    cfg = tcfg.smoke_config()
    module = TT.Transformer(cfg, seed=0, device="cpu")
    p = module.params
    w = p["decoder"]["blocks"][0]["ffn"]["w_down"].detach()
    assert abs(float(w.std()) - 1 / np.sqrt(cfg.d_ff)) < 0.01
    assert float(p["final_norm"]["scale"].detach().abs().max()) == 0.0
    assert sum(1 for _ in module.parameters()) == 12


def test_other_families_raise_naming_roadmap():
    """The families that raised naming item 13d build now: the mLSTM
    (item 13d's xLSTM part) and Mamba (its last part).  TinyLlama's smoke
    config with ``attn_period=2`` alternates Mamba (layer 0) and
    attention (layer 1) and runs."""
    cfg = dataclasses.replace(tcfg.smoke_config(), family="ssm",
                              xlstm_pattern=("mlstm", "slstm"), d_ff=0)
    assert len(tree.leaves(TT.Transformer(cfg, device="cpu").params)) == 21
    cfg = dataclasses.replace(tcfg.smoke_config(), attn_period=2)
    module = TT.Transformer(cfg, device="cpu")
    blocks = module.params["decoder"]["blocks"]
    assert "mamba" in blocks[0] and "attn" in blocks[1]
    # 9 Mamba leaves, 4 attention leaves, 3 FFN leaves and 2 norms each
    assert len(tree.leaves(module.params)) == 9 + 4 + 2 * (3 + 2) + 3
    hidden, _ = module(torch.zeros((2, 5), dtype=torch.int32))
    assert tuple(hidden.shape) == (2, 5, cfg.d_model)
    assert bool(torch.isfinite(hidden).all())


def test_layer_norm_decoder_builds():
    """The norm that used to raise: a layer-norm decoder builds, each
    norm ``{"bias", "scale"}`` (15 leaves), scale ones and bias zeros."""
    cfg = dataclasses.replace(tcfg.smoke_config(), norm="layernorm")
    module = TT.Transformer(cfg, device="cpu")
    assert len(tree.leaves(module.params)) == 15
    ln = module.params["decoder"]["blocks"][0]["ln_ffn"]
    assert bool((ln["scale"].detach() == 1).all())
    assert bool((ln["bias"].detach() == 0).all())
