"""The Mamba layers and the Jamba hybrid in the port
(``repro_torch.models.ssm``, its branches in the transformer and the
serving engine) against the reference's ``repro.models.ssm``,
``repro.models.transformer`` and ``repro.serving.engine``.

The same numpy inputs and parameters (the reference's init, carried
over as numpy) go through both packages.  Contracts, f32 on the CPU:

  * the block (d 32: d_inner 64, dt_rank 2, d_state 16):
    ``mamba_specs``' shapes, logical axes and key order are
    ``init_mamba``'s; ``A_log`` within one ulp of the reference's
    (XLA's log(7) rounds one ulp off torch's) and ``dt_proj_b`` within
    1e-4 (its f32 formula, exp(x) − 1 near 0.001, cancels ~10 bits, so
    an ulp of XLA's exp against torch's moves it ~3e-5); the conv, the
    (dt, B, C) projections, ``mamba_forward`` and the prefill state in
    one scan block and in several within rtol 2e-5, atol 2e-6 (the
    doubling scan groups its products apart from ``associative_scan``;
    ~5e-8 measured); the gradient of every leaf and of x (a sum of
    squares of the output and the prefill state) at rtol 2e-4 and an
    atol of 1e-6 of the leaf's largest |gradient|, the xLSTM tests';
    ``torch.autograd.gradcheck`` of the written-out backward in f64;
    a chain of ``mamba_decode`` steps against ``mamba_forward`` and its
    state, and one decode step against the reference's, at 2e-5 / 2e-6;
    the scan's autograd graph holds no (B, S, d_inner, d_state) tensor;
  * the Jamba smoke config (8 layers, d 128, 4 experts top 2: period 5
    and a tail of 3): the block pattern, leaf paths, order, shapes and
    logical axes; the forward's hidden states (rtol 1e-4, atol 2e-5,
    ``test_torch_serving.py``'s logits tolerance: 8.8e-6 measured after
    8 layers and the final norm), loss (rtol 2e-5) and every gradient
    (rtol 2e-4, atol 2e-6) with ``remat`` on and off; 3 ``SimTrainer``
    ``lags_dp`` steps on the kernel backend against the reference's in
    Pallas interpret mode at ``test_torch_train.py``'s tolerances
    (losses rtol 1e-5, parameters and residuals rtol 1e-4 atol 1e-5);
    the handoff against a token-by-token replay at 1e-4;
    ``launch/serve``'s steps on ``meta`` at smoke and full size; a
    stream ``ServeSession`` bitwise after the flush.  Prefill and
    decode against the reference are ``test_torch_serving.py``'s, whose
    parity ids include Jamba;
  * ``init_states`` and ``states_axes`` against the reference's for
    every config the port builds.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

D = 32
I = TS.EXPAND * D  # noqa: E741
ARCH = "jamba_v0_1_52b"
#: one scan block, and blocks of 5 channels (13 blocks of the 64)
BLOCKS = [TS.SCAN_BLOCK, 2 * 13 * TS.D_STATE * 5]


def _block(seed=0):
    """The reference's init of one Mamba block as numpy, with ``conv_b``
    and ``D`` drawn so that their gradients vary."""
    p, _ = JS.init_mamba(jax.random.PRNGKey(seed), D, jnp.float32)
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    p["conv_b"] = 0.1 * rng.standard_normal(I).astype(np.float32)
    p["D"] = p["D"] + 0.1 * rng.standard_normal(I).astype(np.float32)
    return p


def _x(seed=1, shape=(2, 13, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=2e-5,
                               atol=2e-6, err_msg=what)


# --- the block ---------------------------------------------------------------

def test_mamba_specs_match_init_mamba():
    specs, axes = TS.mamba_specs(D)
    p, jaxes = JS.init_mamba(jax.random.PRNGKey(0), D, jnp.float32)
    assert list(specs) == sorted(p) and axes == jaxes
    assert {k: tuple(s[0]) for k, s in specs.items()} == \
        {k: v.shape for k, v in p.items()}
    assert TS.dt_rank(D) == 2 and TS.dt_rank(4096) == 256
    assert (TS.D_STATE, TS.D_CONV, TS.EXPAND) == \
        (JS.D_STATE, JS.D_CONV, JS.EXPAND)
    cfg = TB.get_smoke_config(ARCH)
    module_p = TT.init_params(cfg, device="cpu")["decoder"]["blocks"][0]
    m = module_p["mamba"]
    n_periods = m["A_log"].shape[0]
    ref = JS.init_mamba(jax.random.PRNGKey(0), cfg.d_model, jnp.float32)[0]
    for t in range(n_periods):
        np.testing.assert_array_max_ulp(m["A_log"][t].numpy(),
                                        np.asarray(ref["A_log"]), maxulp=1)
        np.testing.assert_allclose(m["dt_proj_b"][t].numpy(),
                                   np.asarray(ref["dt_proj_b"]), rtol=0,
                                   atol=1e-4)
    assert bool((m["A_log"][0] == TS._a_log(2 * cfg.d_model)).all())
    assert bool((m["D"] == 1.0).all()) and bool((m["conv_b"] == 0.0).all())
    assert abs(float(m["conv_w"].std()) - 0.1) < 0.01
    # the computed leaves repeat in every layer of a stack (16 layers: 2
    # periods), also in bf16, and build as meta tensors
    bf = dataclasses.replace(cfg, n_layers=16, param_dtype="bfloat16")
    pb = TT.init_params(bf, device="cpu")["decoder"]["blocks"][0]["mamba"]
    assert pb["dt_proj_b"].dtype == torch.bfloat16
    for t in range(2):
        assert torch.equal(pb["dt_proj_b"][t], TS._dt_bias(
            2 * cfg.d_model).to(torch.bfloat16))
    meta = TT.abstract_params(cfg)["decoder"]["blocks"][0]["mamba"]
    assert {k: tuple(v.shape) for k, v in meta.items()} == \
        {k: tuple(v.shape) for k, v in m.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    p, x = _block(), _x(shape=(2, 5, I))
    st = _x(seed=2, shape=(2, TS.D_CONV - 1, I)) if with_state else None
    jy, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(p["conv_w"]),
                              jnp.asarray(p["conv_b"]),
                              None if st is None else jnp.asarray(st))
    ty, tst = TS._causal_conv(torch.from_numpy(x),
                              torch.from_numpy(p["conv_w"]),
                              torch.from_numpy(p["conv_b"]),
                              None if st is None else torch.from_numpy(st))
    _close(ty.numpy(), jy, "y")
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_ssm_params_match_reference():
    p, x = _block(), _x(shape=(2, 7, I))
    for what, got, want in zip(("dt", "B", "C"),
                               TS._ssm_params(_t(p), torch.from_numpy(x)),
                               JS._ssm_params(_j(p), jnp.asarray(x))):
        assert got.dtype == torch.float32
        _close(got.numpy(), want, what)


@pytest.mark.parametrize("block", BLOCKS)
def test_mamba_forward_and_prefill_state_match_reference(block, monkeypatch):
    monkeypatch.setattr(TS, "SCAN_BLOCK", block)
    p, x = _block(), _x()
    jout = JS.mamba_forward(_j(p), jnp.asarray(x))
    jout2, jst = JE._mamba_prefill(_j(p), jnp.asarray(x))
    tout, tst = TS.mamba_forward(_t(p), torch.from_numpy(x),
                                 return_state=True)
    _close(tout.numpy(), jout, "out")
    _close(tout.numpy(), jout2, "prefill out")
    assert sorted(tst) == sorted(jst)
    for k in tst:
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k].numpy(), jst[k], k)


@pytest.mark.parametrize("block", BLOCKS)
def test_gradients_match_reference(block, monkeypatch):
    """The output and the prefill state both feed the loss, so the
    written-out backward runs with both of its incoming gradients."""
    monkeypatch.setattr(TS, "SCAN_BLOCK", block)
    p, x = _block(), _x()

    def jloss(p, x):
        out, st = JE._mamba_prefill(p, x)
        return jnp.sum(out ** 2) + jnp.sum(st["ssm"] ** 2) + \
            jnp.sum(st["conv"] ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_j(p), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, st = TS.mamba_forward(tp, tx, return_state=True)
    loss = (out ** 2).sum() + (st["ssm"] ** 2).sum() + (st["conv"] ** 2).sum()
    got = torch.autograd.grad(loss, [*tp.values(), tx])
    wants = [want[0][k] for k in tp] + [want[1]]
    for name, g, w in zip([*tp, "x"], got, wants):
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


def test_selective_scan_gradcheck(monkeypatch):
    """f64, 2 × 6 steps × 3 channels in blocks of 2 channels: both
    outputs (y and the last state) against finite differences."""
    gen = torch.Generator().manual_seed(0)
    b, s, c, n = 2, 6, 3, TS.D_STATE

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    dt = torch.nn.functional.softplus(rnd(b, s, c)).requires_grad_()
    A = (-torch.exp(0.5 * rnd(c, n))).requires_grad_()
    Bm, Cm, x = (rnd(b, s, n).requires_grad_(), rnd(b, s, n).requires_grad_(),
                 rnd(b, s, c).requires_grad_())
    monkeypatch.setattr(TS, "SCAN_BLOCK", b * s * n * 2)
    assert len(TS._blocks(b * s, c, TS.SCAN_BLOCK)) == 2
    assert torch.autograd.gradcheck(TS.selective_scan, (dt, A, Bm, Cm, x))


def test_decode_chain_matches_forward_and_reference_step():
    """``mamba_decode`` token by token from zeros gives
    ``mamba_forward``'s outputs and its final state; one step from a
    nonzero state equals the reference's ``mamba_decode``."""
    p, x = _block(), _x()
    tp = _t(p)
    out, st = TS.mamba_forward(tp, torch.from_numpy(x), return_state=True)
    state = TS.init_mamba_state(2, D, torch.float32, device="cpu")
    steps = []
    for t in range(x.shape[1]):
        o, state = TS.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                   state)
        steps.append(o)
    _close(torch.cat(steps, 1).numpy(), out.numpy(), "decode chain")
    for k in ("conv", "ssm"):
        _close(state[k].numpy(), st[k].numpy(), k)
    rng = np.random.default_rng(5)
    st0 = {"conv": rng.standard_normal((2, TS.D_CONV - 1, I)).astype(
               np.float32),
           "ssm": rng.standard_normal((2, I, TS.D_STATE)).astype(np.float32)}
    jo, jst = JS.mamba_decode(_j(p), jnp.asarray(x[:, :1]), _j(st0))
    to, tst = TS.mamba_decode(tp, torch.from_numpy(x[:, :1]), _t(st0))
    _close(to.numpy(), jo, "decode step")
    for k in ("conv", "ssm"):
        _close(tst[k].numpy(), jst[k], f"decode {k}")


def test_scan_saves_no_state_sized_tensor():
    """What autograd keeps for one Mamba layer: no 4-D tensor, and less
    than one (B, S, d_inner, d_state) f32 tensor in all.  The reference's
    ``associative_scan`` keeps ~2·log2(S) of them."""
    b, s = 2, 64
    p, x = _t(_block()), torch.from_numpy(_x(shape=(b, s, D)))
    for v in p.values():
        v.requires_grad_()
    saved = {}

    def pack(t):
        saved[(t.data_ptr(), tuple(t.shape))] = t
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = TS.mamba_forward(p, x)
    assert all(t.ndim <= 3 for t in saved.values())
    nbytes = sum(t.numel() * t.element_size() for t in saved.values())
    assert nbytes < b * s * I * TS.D_STATE * 4
    out.sum().backward()
    assert all(v.grad is not None for v in p.values())


# --- the Jamba smoke model ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = JB.get_smoke_config(arch)
    return jax.jit(lambda k: JT.init_model(k, cfg)[0])(jax.random.PRNGKey(0))


def _module(arch=ARCH):
    return TT.from_jax_params(jax.tree.map(np.asarray, _jax_params(arch)),
                              TB.get_smoke_config(arch), device="cpu")


def _paths(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


def _batch(cfg, seed=1, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("layers,n_experts,period", [
    (8, 4, 5), (16, 16, 8), (32, 16, 8), (8, 0, 5)])
def test_block_pattern_and_period_match_reference(layers, n_experts, period):
    """Attention at layer i % 8 == 4, Mamba elsewhere, MoE on odd layers
    (none with the dense cut, ``n_experts=0``): the reference's pattern,
    and ``find_period``'s period at the smoke, serving, full and trained
    depths."""
    base = TB.get_config(ARCH) if layers > 8 else TB.get_smoke_config(ARCH)
    cfg = dataclasses.replace(base, n_layers=layers, n_experts=n_experts)
    jcfg = dataclasses.replace(JB.get_config(ARCH) if layers > 8
                               else JB.get_smoke_config(ARCH),
                               n_layers=layers, n_experts=n_experts)
    specs = TT.build_blockspecs(cfg)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in JT.build_blockspecs(jcfg)]
    assert [s.kind for s in specs] == \
        ["attn" if i % 8 == 4 else "mamba" for i in range(layers)]
    assert [s.ffn for s in specs] == \
        [("moe" if i % 2 else "dense") if n_experts else "dense"
         for i in range(layers)]
    assert TT.find_period(specs) == period == JT.find_period(
        JT.build_blockspecs(jcfg))


def test_leaf_paths_shapes_and_axes_match_reference():
    cfg_j, cfg_t = JB.get_smoke_config(ARCH), TB.get_smoke_config(ARCH)
    params, module = _jax_params(ARCH), _module()
    assert tree.leaf_paths(module.params) == _paths(params)
    assert [tuple(p.shape) for p in tree.leaves(module.params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(params)]
    box = {}
    jax.eval_shape(lambda k: box.setdefault(
        "axes", JT.init_model(k, cfg_j)[1]) and None, jax.random.PRNGKey(0))
    is_ax = lambda a: isinstance(a, tuple)  # noqa: E731
    assert tree.flatten_up_to(tree.flatten(module.params)[1],
                              TT.logical_axes(cfg_t)) == \
        jax.tree.leaves(box["axes"], is_leaf=is_ax)
    assert set(module.params["decoder"]["blocks"][0]) == \
        {"mamba", "ln_attn", "ffn", "ln_ffn"}
    assert "attn" in module.params["decoder"]["blocks"][4]
    assert cfg_t.param_count() == sum(x.size
                                      for x in jax.tree.leaves(params))
    # the Mamba leaves cross both ways bit for bit, bf16 included
    back = TT.to_numpy_tree(module)
    for got, want in zip(tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(want))
    bf = dataclasses.replace(cfg_t, param_dtype="bfloat16")
    pj = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    mb = TT.from_jax_params(pj, bf, device="cpu")
    assert mb.params["decoder"]["blocks"][0]["mamba"]["A_log"].dtype == \
        torch.bfloat16
    for got, want in zip(tree.leaves(TT.to_numpy_tree(mb)),
                         jax.tree.leaves(pj)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("remat", [True, False])
def test_forward_loss_and_grads_match_reference(remat):
    cfg_j, cfg_t = JB.get_smoke_config(ARCH), TB.get_smoke_config(ARCH)
    params, module = _jax_params(ARCH), _module()
    batch = _batch(cfg_j)
    jh, jaux = jax.jit(lambda p, t: JT.forward(p, cfg_j, t, chunk=8,
                                               remat=remat))(
        params, jnp.asarray(batch["tokens"]))
    th, taux = TT.forward(module.params, cfg_t,
                          torch.from_numpy(batch["tokens"]), chunk=8,
                          remat=remat)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               rtol=1e-4, atol=2e-5, err_msg="hidden")
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(
        p, cfg_j, b, chunk=8, loss_chunk=8, remat=remat)[0]))(
        params, jax.tree.map(jnp.asarray, batch))
    tl, _ = TT.loss_fn(module.params, cfg_t,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       chunk=8, loss_chunk=8, remat=remat)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    for g, w, path in zip(grads, jax.tree.leaves(jg),
                          tree.leaf_paths(module.params)):
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-6, err_msg=path)


def test_three_sim_steps_match_reference():
    """lags_dp at ratio 100, lr 0.1, 2 workers, the kernel backend (the
    reference's Pallas kernels in interpret mode, the port's plain
    versions)."""
    P, STEPS = 2, 3
    cfg_j, cfg_t = JB.get_smoke_config(ARCH), TB.get_smoke_config(ARCH)
    params, module = _jax_params(ARCH), _module()
    kw = dict(mode="lags_dp", ratio=100.0, lr=0.1, selection_backend="kernel")
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg_j.vocab, (P, 2, 9)).astype(np.int32)
        batches.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    jtr = japi.Session(cfg_j, japi.RunConfig(**kw)).simulator(
        lambda q, b: JT.loss_fn(q, cfg_j, b, chunk=8, loss_chunk=8),
        params, n_workers=P)
    ttr = tapi.Session(cfg_t, tapi.RunConfig(**kw), device="cpu").simulator(
        lambda q, b: TT.loss_fn(q, cfg_t, b, chunk=8, loss_chunk=8),
        module.params, n_workers=P)
    jhist = jtr.run(lambda t: jax.tree.map(jnp.asarray, batches[t]), STEPS,
                    log_every=1)
    thist = ttr.run(lambda t: {k: torch.from_numpy(v)
                               for k, v in batches[t].items()}, STEPS,
                    log_every=1)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for got, want in zip(tree.leaves(TT.to_numpy_tree(module)),
                         jax.tree.leaves(jtr.state["params"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    for got, want in zip(tree.leaves(ttr.state["ef"]),
                         jax.tree.leaves(jtr.state["ef"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# --- serving -----------------------------------------------------------------

def test_handoff_matches_token_by_token_replay():
    """Prefill -> ``pad_states_for_decode`` -> decode against feeding the
    prompt one token at a time, greedy, 1e-4: the Mamba states pass
    through the handoff unchanged (the same tensors), the attention
    layer's cache is padded."""
    cfg = TB.get_smoke_config(ARCH)
    params = TT.init_params(cfg, seed=2, device="cpu")
    prompt_len, gen, b = 12, 3, 2
    cap = prompt_len + gen
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, prompt_len)).astype(np.int32))

    def greedy(logits, st):
        out = [logits]
        for i in range(gen):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            logits, st = TE.serve_step(params, cfg, tok, st, prompt_len + i,
                                       chunk=8)
            out.append(logits)
        return out

    st = TE.init_states(cfg, b, cap, torch.float32, device="cpu")
    for i in range(prompt_len):
        logits_r, st = TE.serve_step(params, cfg, toks[:, i][:, None], st, i,
                                     chunk=8)
    replay = greedy(logits_r, st)
    logits_h, st2 = TE.prefill(params, cfg, toks, chunk=8)
    padded = TE.pad_states_for_decode(cfg, st2, prompt_len, cap)
    specs = TT.build_blockspecs(cfg)
    for j, (a, c) in enumerate(zip(padded["blocks"], st2["blocks"])):
        if specs[j].kind == "mamba":
            assert a["conv"] is c["conv"] and a["ssm"] is c["ssm"]
        else:
            assert a["self"]["k"].shape[2] == cap
    handoff = greedy(logits_h, padded)
    for i, (r, h) in enumerate(zip(replay, handoff)):
        np.testing.assert_allclose(h.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"decode step {i}")


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_serve_steps_on_meta(size, shape):
    """``launch/serve``'s steps build Jamba's ``meta`` stand-ins at each
    serving shape (``long_500k`` admitted: ``supports_long_context``),
    and a step applied to them gives meta outputs of the right shapes:
    the caches at capacity (B, S, 8, 128) for the attention layers, the
    O(1) Mamba states."""
    from repro.launch import specs as JSP
    from repro_torch.launch import specs as TSP
    cfg = TB.get_config(ARCH) if size == "full" else \
        TB.get_smoke_config(ARCH)
    inp = TB.INPUT_SHAPES[shape]
    assert TSP.supports_shape(cfg, inp) and JSP.supports_shape(
        JB.get_config(ARCH), JB.INPUT_SHAPES[shape])
    if size == "smoke":
        inp = dataclasses.replace(inp, seq_len=64, global_batch=2)
    b, s = inp.global_batch, inp.seq_len
    d_inner = TS.EXPAND * cfg.d_model
    if inp.kind == "prefill":
        fn, (psh, bsh) = TSV.make_prefill_step(cfg, None, inp, chunk=1024)
        logits, states = fn(psh, bsh)
        assert logits.device.type == "meta"
        assert tuple(logits.shape) == (b, cfg.vocab)
        attn = states["blocks"][4]["self"]["k"]
        assert tuple(attn.shape[1:3]) == (b, s)
    else:
        sds, _ = TSV.state_specs(cfg, None, inp)
        states = sds["states"]
        step, args = TSV.make_serve_step(cfg, None, inp)
        logits, out = step(*args[:3], 5)
        assert tuple(logits.shape) == (b, cfg.vocab) and out is args[2]
        assert tuple(states["blocks"][4]["self"]["k"].shape[1:3]) == (b, s)
    mamba = states["blocks"][0]
    n_periods = len(TT.build_blockspecs(cfg)) // TT.find_period(
        TT.build_blockspecs(cfg))
    assert tuple(mamba["conv"].shape) == (n_periods, b, TS.D_CONV - 1,
                                          d_inner)
    assert tuple(mamba["ssm"].shape) == (n_periods, b, d_inner, TS.D_STATE)
    assert mamba["ssm"].dtype == torch.float32
    assert all(x.device.type == "meta" for x in tree.leaves(states))


def test_stream_follows_jamba_smoke_training_bitwise(tmp_path):
    """``Session.run`` of 4 ``lags_dp`` steps on a gloo world of one,
    publishing every 2 steps; after the flush a ``ServeSession`` (cache
    regime ``hybrid``) that applied every packet file holds the trained
    parameters bit for bit, and generates from them."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SP
    from repro_torch.stream import ServeSession, StreamPublisher
    cfg = dataclasses.replace(TB.get_smoke_config(ARCH),
                              compression_ratio=8.0)
    shape = TB.InputShape("t", 16, 2, "train")
    with tempfile.NamedTemporaryFile() as f:
        M.init_process_group(f"file://{f.name}", 1, 0, device="cpu")
        try:
            sess = tapi.Session(cfg, tapi.RunConfig(
                lr=0.1, chunk=16, loss_chunk=16, donate=False),
                mesh=M.make_mesh(device="cpu"))
            state, _ = sess.init_state()
            pub = StreamPublisher(state["params"], every=2,
                                  out_dir=str(tmp_path))
            state, history = sess.run(
                lambda t: SP.concrete_batch(cfg, shape, seed=t,
                                            device="cpu"),
                4, state=state, publisher=pub, print_fn=lambda *_: None)
        finally:
            dist.destroy_process_group()
    assert all(np.isfinite(h["loss"]) for h in history)
    pub.flush(4, state["params"])
    sub = ServeSession(cfg, TB.InputShape("serve", 12, 2, "decode"),
                       tree.map(torch.zeros_like, state["params"]))
    for path in pub.packet_paths:
        assert sub.apply_packet_file(path) == "applied"
    assert sub.version == pub.version
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(sub.params), tree.leaves(state["params"])))
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 4)).astype(np.int32))
    got = sub.generate(prompts, 3)
    assert got.shape == (2, 3)
    assert sub.requests[-1].cache == "hybrid"


#: every config the port's transformer builds (the CNN is not one)
STATE_IDS = [a for a in JB.ARCH_IDS + JB.PAPER_IDS if a != "paper_cnn_cifar"]


@pytest.mark.parametrize("arch", STATE_IDS)
def test_init_states_and_axes_match_reference_for_every_config(arch):
    """Shapes, dtypes and logical axes of the decode states, leaf for
    leaf in the reference's order (cross caches of 4 frames for the
    encoder-decoder)."""
    cfg_j, cfg_t = JB.get_smoke_config(arch), TB.get_smoke_config(arch)
    want = jax.eval_shape(lambda: JE.init_states(cfg_j, 3, 40, jnp.bfloat16,
                                                 enc_len=4))
    got = TE.init_states(cfg_t, 3, 40, torch.bfloat16, enc_len=4,
                         device="cpu")
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in tree.leaves(got)] == \
        [(tuple(x.shape), x.dtype.name) for x in jax.tree.leaves(want)]
    is_ax = lambda a: isinstance(a, tuple) and all(  # noqa: E731
        isinstance(x, (str, type(None))) for x in a)
    want_ax = JE.states_axes(cfg_j)
    got_ax = TE.states_axes(cfg_t)
    assert jax.tree.structure(got_ax, is_leaf=is_ax) == \
        jax.tree.structure(want_ax, is_leaf=is_ax)
    assert jax.tree.leaves(got_ax, is_leaf=is_ax) == \
        jax.tree.leaves(want_ax, is_leaf=is_ax)
    assert [tuple(a) for a in tree.flatten_up_to(tree.flatten(got)[1],
                                                 got_ax)] == \
        jax.tree.leaves(want_ax, is_leaf=is_ax)
