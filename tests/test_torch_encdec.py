"""Encoders and frontends in the port: the encoder-decoder (SeamlessM4T's
smoke config: an audio encoder, cross-attention in every decoder layer)
and the VLM (LLaVA-NeXT's smoke config: patch embeddings ahead of the
text), against the reference's ``repro.models.attention``,
``repro.models.transformer``, ``repro.launch.specs``,
``repro.serving.engine`` and ``repro.launch.serve``.

The same numpy inputs and parameters (the reference's init, carried over
as numpy through ``from_jax_params``) go through both packages, the
reference in f32 under ``jax.jit``.  Tolerances, those of the parity
tests this file sits beside:

  * attention outputs rtol 2e-5, atol 2e-6 (``test_torch_xlstm.py``);
  * ``forward``'s hidden states, a whole model's output, rtol 2e-5 and
    atol 1e-5 (``test_torch_moe.py``'s forward: f32 sums in another
    order leave ~2e-6 on entries near zero);
  * ``loss_fn``'s loss rtol 2e-5, every gradient leaf (the encoder's
    included) rtol 2e-4, atol 2e-6 (``test_torch_xlstm.py``,
    ``test_torch_paper.py``);
  * prefill and decode logits and states rtol 1e-4, atol 2e-5
    (``test_torch_serving.py``);
  * 3 ``SimTrainer`` steps: losses rtol 1e-5, parameters and residuals
    rtol 1e-4, atol 1e-5 (``test_torch_train.py``).

The reference's encoder runs its layers through ``attention_forward``
with no window: causal and rotary (``attention_encoder``, bidirectional
and without rope, is reached by no caller there); the port's does the
same, and ``attention_encoder`` is held to the reference's on its own.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

ARCHS = ("seamless_m4t_large_v2", "llava_next_mistral_7b")


def _close(got, want, what, rtol=2e-5, atol=2e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# --- attention ---------------------------------------------------------------

D, H, KV, HD = 32, 4, 2, 8


def _attn_params(seed=0):
    p, _ = JA.init_attention(jax.random.PRNGKey(seed), D, H, KV, HD,
                             jnp.float32)
    return {k: np.array(v) for k, v in p.items()}


@pytest.mark.parametrize("case", ["encoder", "cross", "positions",
                                  "positions_rope"])
def test_attention_variants_match_reference(case):
    """``attention_encoder`` (bidirectional, no rope), cross-attention
    over a memory of another length, and ``attention_forward`` at given
    positions without rope and with it (a VLM's offset text), in key
    chunks of 4 over 10 queries (a padded last chunk)."""
    p = _attn_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, D)).astype(np.float32)
    mem = rng.standard_normal((2, 7, D)).astype(np.float32)
    pos = np.arange(5, 15, dtype=np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if case == "encoder":
        want = JA.attention_encoder(jp, jnp.asarray(x), n_kv_heads=KV,
                                    chunk=4)
        got = TA.attention_encoder(tp, torch.from_numpy(x), n_kv_heads=KV,
                                   chunk=4)
        # bidirectional: the first query sees the last key
        causal = TA.attention_forward(tp, torch.from_numpy(x),
                                      n_kv_heads=KV, chunk=4, use_rope=False)
        assert not torch.allclose(got[:, 0], causal[:, 0])
    elif case == "cross":
        want = JA.cross_attention_forward(jp, jnp.asarray(x),
                                          jnp.asarray(mem), n_kv_heads=KV,
                                          chunk=4)
        got = TA.cross_attention_forward(tp, torch.from_numpy(x),
                                         torch.from_numpy(mem),
                                         n_kv_heads=KV, chunk=4)
    else:
        rope = case == "positions_rope"
        want = JA.attention_forward(jp, jnp.asarray(x), n_kv_heads=KV,
                                    chunk=4, positions=jnp.asarray(pos),
                                    use_rope=rope)
        got = TA.attention_forward(tp, torch.from_numpy(x), n_kv_heads=KV,
                                   chunk=4, positions=torch.from_numpy(pos),
                                   use_rope=rope)
    _close(got.numpy(), want, case)


# --- the models --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = JB.get_smoke_config(arch)
    return jax.jit(lambda k: JT.init_model(k, cfg)[0])(jax.random.PRNGKey(0))


def _module(arch):
    return TT.from_jax_params(jax.tree.map(np.asarray, _jax_params(arch)),
                              TB.get_smoke_config(arch), device="cpu")


def _paths(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


def _n_front(cfg, s):
    """The frontend's length beside ``s`` text tokens: the VLM smoke
    config's patches, or the audio frames of ``s`` tokens."""
    return cfg.n_frontend_tokens if cfg.frontend == "vision" \
        else JSP.audio_frames(s)


def _batch(cfg, seed=1, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -1
    front = rng.standard_normal((b, _n_front(cfg, s), cfg.d_model)).astype(
        np.float32)
    return {"tokens": toks[:, :-1], "labels": labels,
            "frontend_embeds": front}


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_matches_reference(arch):
    """Leaf paths in the reference's flatten order (``enc_norm`` and
    ``encoder`` between ``embed`` and ``final_norm``; ``cross`` and
    ``ln_cross`` in each decoder layer of the encoder-decoder), shapes,
    logical axes and the parameter count."""
    cfg_j, cfg_t = JB.get_smoke_config(arch), TB.get_smoke_config(arch)
    params, module = _jax_params(arch), _module(arch)
    paths = tree.leaf_paths(module.params)
    assert paths == _paths(params)
    assert [tuple(p.shape) for p in tree.leaves(module.params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(params)]
    assert [tuple(x.shape) for x in tree.leaves(TT.abstract_params(cfg_t))] \
        == [tuple(x.shape) for x in jax.tree.leaves(params)]
    box = {}

    def init(key):
        p, box["axes"] = JT.init_model(key, cfg_j)
        return p

    jax.eval_shape(init, jax.random.PRNGKey(0))    # the axes, no arrays
    jaxes = box["axes"]
    is_ax = lambda a: isinstance(a, tuple) and all(  # noqa: E731
        isinstance(x, (str, type(None))) for x in a)
    got = tree.flatten_up_to(tree.flatten(module.params)[1],
                             TT.logical_axes(cfg_t))
    assert [tuple(a) for a in got] == \
        [tuple(a) for a in jax.tree.leaves(jaxes, is_leaf=is_ax)]
    assert cfg_t.param_count() == sum(x.size for x in
                                      jax.tree.leaves(params))
    if cfg_t.n_encoder_layers:
        block = module.params["decoder"]["blocks"][0]
        assert {"cross", "ln_cross"} <= set(block)
        i = paths.index("embed/embedding")
        assert paths[i + 1].startswith("enc_norm/")
        assert "cross" not in module.params["encoder"]["blocks"][0]
    else:
        assert "encoder" not in module.params


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, remat):
    """``forward(frontend_embeds=)``'s hidden states (the VLM's patch
    positions among them), and ``loss_fn``'s loss and every gradient leaf
    on the same batch, ``remat`` the same on both sides.  With remat the
    encoder's output feeds every checkpointed decoder period, and its
    gradient must still reach every encoder leaf."""
    cfg_j, cfg_t = JB.get_smoke_config(arch), TB.get_smoke_config(arch)
    params, module = _jax_params(arch), _module(arch)
    batch = _batch(cfg_j)
    jb = jax.tree.map(jnp.asarray, batch)
    jh, _ = jax.jit(lambda p, b: JT.forward(
        p, cfg_j, b["tokens"], frontend_embeds=b["frontend_embeds"],
        chunk=8, remat=remat))(params, jb)
    tb = _torch_batch(batch)
    with torch.no_grad():
        th, _ = module(tb["tokens"], frontend_embeds=tb["frontend_embeds"],
                       chunk=8, remat=remat)
    n_f = 0 if cfg_t.n_encoder_layers else batch["frontend_embeds"].shape[1]
    assert tuple(th.shape) == (2, n_f + 16, cfg_t.d_model)
    _close(th.numpy(), jh, "hidden", atol=1e-5)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(
        p, cfg_j, b, chunk=8, loss_chunk=8, remat=remat)[0]))(params, jb)
    tl, _ = TT.loss_fn(module.params, cfg_t, tb, chunk=8, loss_chunk=8,
                       remat=remat)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    paths = tree.leaf_paths(module.params)
    for g, w, path in zip(grads, jax.tree.leaves(jg), paths):
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-6, err_msg=path)
    if cfg_t.n_encoder_layers:
        # attn's 4, ffn's 2, two layer norms' 2 each, all nonzero above
        assert sum(p.startswith("encoder/") for p in paths) == 10


def test_encoder_decoder_needs_its_encoder_input():
    module = _module(ARCHS[0])
    with pytest.raises(ValueError, match="frontend_embeds"):
        module(torch.zeros((1, 4), dtype=torch.int32))


# --- launch/specs ------------------------------------------------------------

@pytest.mark.parametrize("shape", list(JB.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, shape):
    """``train_batch_specs`` and ``decode_batch_specs`` at the full
    configs (meta tensors), each of the reference's input shapes; then
    ``concrete_batch``'s fields at the smoke config."""
    cfg_t, cfg_j = TB.get_config(arch), JB.get_config(arch)
    shape_t, shape_j = TB.INPUT_SHAPES[shape], JB.INPUT_SHAPES[shape]
    for fn_t, fn_j in ((TSP.train_batch_specs, JSP.train_batch_specs),
                       (TSP.decode_batch_specs, JSP.decode_batch_specs)):
        got, want = fn_t(cfg_t, shape_t), fn_j(cfg_j, shape_j)
        assert list(got) == list(want)
        for name in got:
            assert got[name].device.type == "meta"
            assert tuple(got[name].shape) == tuple(want[name].shape), name
            assert str(got[name].dtype).split(".")[-1] == \
                want[name].dtype.name
    small = TB.InputShape(shape, 24, 3, shape_t.kind)
    cfg_s = TB.get_smoke_config(arch)
    batch = TSP.concrete_batch(cfg_s, small, seed=2, device="cpu")
    want = JSP.train_batch_specs(JB.get_smoke_config(arch),
                                 JB.InputShape(shape, 24, 3, shape_t.kind))
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert batch["tokens"].dtype == torch.int32
    assert 0 <= int(batch["tokens"].min()) and \
        int(batch["tokens"].max()) < cfg_s.vocab
    emb = batch["frontend_embeds"]
    assert emb.dtype == torch.float32 and bool(torch.isfinite(emb).all())
    assert abs(float(emb.std()) - 1.0) < 0.1
    if small.kind == "train":
        assert torch.equal(batch["labels"], batch["tokens"])
    again = TSP.concrete_batch(cfg_s, small, seed=2, device="cpu")
    assert all(torch.equal(again[k], batch[k]) for k in batch)


# --- serving -----------------------------------------------------------------

PROMPT, GEN = 12, 3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``init_states(enc_len=)``'s shapes and axes; ``prefill`` with the
    frontend's embeddings (logits and states: the cross caches filled
    from the encoder's output, or the patches' keys in the self caches);
    the handoff (``prompt_len`` counting the patches); three
    ``serve_step``s at the positions after them; and ``launch/serve``'s
    cross-cache size."""
    cfg_j, cfg_t = JB.get_smoke_config(arch), TB.get_smoke_config(arch)
    jp, tp = _jax_params(arch), _module(arch).params
    enc_len = 5
    want = jax.eval_shape(lambda: JE.init_states(cfg_j, 3, 40, jnp.float32,
                                                 enc_len=enc_len))
    got = TE.init_states(cfg_t, 3, 40, torch.float32, enc_len=enc_len,
                         device="cpu")
    assert [tuple(x.shape) for x in tree.leaves(got)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
    is_ax = lambda a: isinstance(a, tuple) and all(  # noqa: E731
        isinstance(x, (str, type(None))) for x in a)
    assert [tuple(a) for a in tree.flatten_up_to(
        tree.flatten(got)[1], TE.states_axes(cfg_t))] == \
        [tuple(a) for a in jax.tree.leaves(JE.states_axes(cfg_j),
                                           is_leaf=is_ax)]

    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg_j.vocab, (2, PROMPT + GEN)).astype(np.int32)
    n_front = _n_front(cfg_t, PROMPT)
    front = rng.standard_normal((2, n_front, cfg_t.d_model)).astype(
        np.float32)
    n_f = 0 if cfg_t.n_encoder_layers else n_front
    cap = n_f + PROMPT + GEN
    jl, js = jax.jit(lambda p, t, f: JE.prefill(p, cfg_j, t,
                                                frontend_embeds=f, chunk=8))(
        jp, jnp.asarray(toks[:, :PROMPT]), jnp.asarray(front))
    tl, ts = TE.prefill(tp, cfg_t, torch.from_numpy(toks[:, :PROMPT]),
                        frontend_embeds=torch.from_numpy(front), chunk=8)

    def states(got, want, what):
        g, w = tree.leaves(got), jax.tree.leaves(want)
        assert len(g) == len(w), what
        for i, (a, b) in enumerate(zip(g, w)):
            assert tuple(a.shape) == tuple(b.shape), f"{what} leaf {i}"
            _close(a.numpy(), b, f"{what} leaf {i}", 1e-4, 2e-5)

    _close(tl.numpy(), jl, "prefill logits", 1e-4, 2e-5)
    states(ts, js, "prefill states")
    js = JE.pad_states_for_decode(cfg_j, js, n_f + PROMPT, cap)
    ts = TE.pad_states_for_decode(cfg_t, ts, n_f + PROMPT, cap)
    states(ts, js, "handoff states")
    if cfg_t.n_encoder_layers:
        assert tuple(ts["blocks"][0]["cross"]["k"].shape[1:3]) == \
            (2, n_front)
    step = jax.jit(lambda p, t, s, pos: JE.serve_step(p, cfg_j, t, s, pos,
                                                      chunk=8))
    for i in range(GEN):
        tok = toks[:, PROMPT + i][:, None]
        pos = n_f + PROMPT + i
        jl, js = step(jp, jnp.asarray(tok), js, jnp.int32(pos))
        tl, _ = TE.serve_step(tp, cfg_t, torch.from_numpy(tok), ts, pos,
                              chunk=8)
        _close(tl.numpy(), jl, f"decode {i} logits", 1e-4, 2e-5)
        states(ts, js, f"decode {i} states")

    shape = TB.InputShape("decode_32k", 24, 2, "decode")
    sds, _ = TSV.state_specs(cfg_t, None, shape)
    jsds, _ = JSV.state_specs(
        cfg_j, jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model")),
        JB.InputShape("decode_32k", 24, 2, "decode"))
    assert [tuple(x.shape) for x in tree.leaves(sds["states"])] == \
        [tuple(x.shape) for x in jax.tree.leaves(jsds["states"])]
    if cfg_t.n_encoder_layers:
        assert sds["states"]["blocks"][0]["cross"]["k"].shape[2] == \
            TSP.audio_frames(24)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_on_meta_specs(arch, size):
    """``make_prefill_step`` over the frontend's specs (meta tensors in,
    meta logits and states out) and ``make_serve_step``'s specs, at the
    smoke config and at full size (a 4096-token prompt: LLaVA's 2048
    patches and 2048 tokens, SeamlessM4T's 4096 tokens and 1024
    frames)."""
    cfg = TB.get_smoke_config(arch) if size == "smoke" \
        else TB.get_config(arch)
    s, chunk = (32, 8) if size == "smoke" else (4096, 1024)
    shape = TB.InputShape("prefill_32k", s, 2, "prefill")
    fn, (psh, bsh) = TSV.make_prefill_step(cfg, None, shape, chunk=chunk)
    assert "frontend_embeds" in bsh
    logits, states = fn(psh, bsh)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (2, cfg.vocab)
    # the self caches hold the whole prompt: patches and text, or text
    assert {x.shape[-3] for x in tree.leaves(
        [st["self"] for st in states["blocks"]])} == {s}
    step, args = TSV.make_serve_step(
        cfg, None, TB.InputShape("decode_32k", s, 2, "decode"),
        chunk=2 * chunk)
    logits, _ = step(*args[:3], s - 12)
    assert tuple(logits.shape) == (2, cfg.vocab)


# --- training ----------------------------------------------------------------

P, STEPS = 2, 3


@pytest.mark.parametrize("arch,backend", [
    ("seamless_m4t_large_v2", "kernel"), ("llava_next_mistral_7b", "xla")])
def test_three_sim_steps_match_reference(arch, backend):
    """3 ``SimTrainer`` steps of ``lags_dp`` (ratio 100, lr 0.1, 2
    workers) with the frontend's embeddings in every batch, the same
    selection backend on both sides: the two backends differ from each
    other on this exchange (the kernel backend selects per block), so
    the port's kernel backend (the kernels' plain versions on the CPU)
    is held to the reference's own, in Pallas interpret mode, on the
    encoder-decoder, and the VLM runs the xla backend."""
    cfg_t = TB.get_smoke_config(arch)
    module = _module(arch)
    batches = _sim_batches(JB.get_smoke_config(arch))
    jtr, jhist = _reference_run(arch, backend)
    ttr = tapi.Session(cfg_t, tapi.RunConfig(**_run_kw(backend)),
                       device="cpu").simulator(
        lambda q, b: TT.loss_fn(q, cfg_t, b, chunk=8, loss_chunk=8),
        module.params, n_workers=P)
    thist = ttr.run(lambda t: _torch_batch(batches[t]), STEPS, log_every=1)
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


def _run_kw(backend):
    return dict(mode="lags_dp", ratio=100.0, lr=0.1,
                selection_backend=backend)


def _sim_batches(cfg):
    rng = np.random.default_rng(8)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, (P, 2, 9)).astype(np.int32)
        front = rng.standard_normal(
            (P, 2, _n_front(cfg, 8), cfg.d_model)).astype(np.float32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:],
                    "frontend_embeds": front})
    return out


def _reference_run(arch, backend):
    cfg = JB.get_smoke_config(arch)
    batches = _sim_batches(cfg)
    tr = japi.Session(cfg, japi.RunConfig(**_run_kw(backend))).simulator(
        lambda q, b: JT.loss_fn(q, cfg, b, chunk=8, loss_chunk=8),
        _jax_params(arch), n_workers=P)
    hist = tr.run(lambda t: jax.tree.map(jnp.asarray, batches[t]), STEPS,
                  log_every=1)
    return tr, hist
