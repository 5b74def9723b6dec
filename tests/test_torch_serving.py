"""The serving path of the port against the reference: ``serving.engine``
(prefill, the prefill→decode handoff, one-token decode) on full KV
caches, sliding-window rings, local/global interleaves, mLSTM, sLSTM
and Mamba states and MoE feed-forwards (Granite-3.0-MoE, OLMoE and
Jamba smoke configs, served drop-free); ``launch/serve`` (the
long-context rewrite, the one-device steps); ``launch/specs``; windowed
attention in training (gemma3's smoke config, loss and gradients).

Parity tests feed the reference's parameters (carried over as numpy
through ``from_jax_params``) and the same numpy tokens to both packages.
Tolerances (f32 on the CPU, the sums inside the matmuls, the online
softmax and the sLSTM loop in another order): logits and states rtol
1e-4, atol 2e-5 (the differences measured are ~3e-6); the port's own
handoff against a fresh prefill of the extended prompt 1e-4, the
reference test's bound; gemma3's loss rtol 2e-5 and gradients rtol 2e-4
atol 2e-6, ``test_torch_paper.py``'s.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JB  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

RTOL, ATOL = 1e-4, 2e-5
#: the smoke configs the parity tests run: a full cache, ring and
#: local/global caches (window 16, period 2), the sLSTM state, the MoE
#: feed-forwards (drop-free in serving), the mLSTM/sLSTM states and the
#: Jamba hybrid's Mamba states beside an attention cache
PARITY_IDS = ("tinyllama_1_1b", "gemma3_27b", "paper_lstm_ptb",
              "granite_moe_3b_a800m", "olmoe_1b_7b", "xlstm_1_3b",
              "jamba_v0_1_52b")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _assert_states(got, want, what):
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(b.shape), f"{what} leaf {i}"
        _close(a.float().numpy(), b, f"{what} leaf {i}")


@pytest.fixture(scope="module", params=PARITY_IDS)
def pair(request):
    cfg_j = JB.get_smoke_config(request.param)
    cfg_t = TB.get_smoke_config(request.param)
    params = jax.jit(lambda k: JT.init_model(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    return cfg_j, cfg_t, params, module.params


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and states, the handoff, then three decode steps'
    logits and states; gemma3's 20-token prompt overflows its window-16
    ring (rotation) while its global layer pads a full cache."""
    cfg_j, cfg_t, jp, tp = pair
    prompt_len, gen = 20, 3
    cap = prompt_len + gen
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab, (2, prompt_len + gen)).astype(np.int32)
    jl, js = jax.jit(lambda p, t: JE.prefill(p, cfg_j, t, chunk=8))(
        jp, jnp.asarray(toks[:, :prompt_len]))
    tl, ts = TE.prefill(tp, cfg_t, torch.from_numpy(toks[:, :prompt_len]),
                        chunk=8)
    _close(tl.numpy(), jl, "prefill logits")
    _assert_states(ts, js, "prefill states")
    js = JE.pad_states_for_decode(cfg_j, js, prompt_len, cap)
    ts = TE.pad_states_for_decode(cfg_t, ts, prompt_len, cap)
    _assert_states(ts, js, "handoff states")
    step = jax.jit(lambda p, t, s, pos: JE.serve_step(p, cfg_j, t, s, pos,
                                                      chunk=8))
    for i in range(gen):
        tok = toks[:, prompt_len + i][:, None]
        jl, js = step(jp, jnp.asarray(tok), js, jnp.int32(prompt_len + i))
        tl, ts2 = TE.serve_step(tp, cfg_t, torch.from_numpy(tok), ts,
                                prompt_len + i, chunk=8)
        assert ts2 is ts                      # written in place
        _close(tl.numpy(), jl, f"decode {i} logits")
        _assert_states(ts, js, f"decode {i} states")


def test_init_states_and_axes_match_reference(pair):
    cfg_j, cfg_t, _, _ = pair
    want = jax.eval_shape(lambda: JE.init_states(cfg_j, 3, 40, jnp.float32))
    got = TE.init_states(cfg_t, 3, 40, torch.float32, device="cpu")
    assert [tuple(x.shape) for x in tree.leaves(got)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
    assert all(float(x.abs().sum()) == 0.0 for x in tree.leaves(got))
    is_ax = lambda a: isinstance(a, tuple) and all(  # noqa: E731
        isinstance(x, (str, type(None))) for x in a)
    assert [tuple(a) for a in tree.flatten_up_to(
        tree.flatten(got)[1], TE.states_axes(cfg_t))] == \
        [tuple(a) for a in jax.tree.leaves(JE.states_axes(cfg_j),
                                           is_leaf=is_ax)]


# --- the port's handoff against a fresh prefill (tests/test_serving.py) ----

def _tiny(**kw):
    return dataclasses.replace(TB.get_smoke_config("tinyllama_1_1b"), **kw)


def _handoff_worst_err(cfg, prompt_len, gen=3, seed=3):
    """Prefill the prompt once, bridge with ``pad_states_for_decode``,
    decode ``gen`` known tokens; compare each step's logits against a
    fresh prefill of the extended prompt (the same causal model on the
    same tokens)."""
    params = TT.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, prompt_len + gen)).astype(np.int32))
    _, st = TE.prefill(params, cfg, toks[:, :prompt_len], chunk=8)
    st = TE.pad_states_for_decode(cfg, st, prompt_len, prompt_len + gen)
    worst = 0.0
    for i in range(gen):
        got, st = TE.serve_step(params, cfg, toks[:, prompt_len + i][:, None],
                                st, prompt_len + i, chunk=8)
        ref = TE.prefill(params, cfg, toks[:, :prompt_len + i + 1],
                         chunk=8)[0]
        worst = max(worst, float((got - ref).abs().max()))
    return worst


HANDOFF = {
    "full_kv": (_tiny, {}, 8),
    # prompt 8 > window 6: prefill ring-truncates, the handoff rotates
    # tokens onto their pos % cap slots
    "ring_longer_than_window": (_tiny, {"sliding_window": 6}, 8),
    # prompt 8 < window 10: the zero-padded slots are masked
    # (k_valid_len), not attended as keys
    "ring_shorter_than_window": (_tiny, {"sliding_window": 10}, 8),
    "ring_equals_window": (_tiny, {"sliding_window": 8}, 8),
    # gemma3: window-16 local layers and a global layer; prompt 20 >
    # window: the ring rotation and the full-cache pad in one handoff
    "local_global": (lambda: TB.get_smoke_config("gemma3_27b"), {}, 20),
    # sLSTM states are O(1): they pass through the handoff untouched
    "slstm_state": (lambda: TB.get_smoke_config("paper_lstm_ptb"), {}, 8),
}


@pytest.mark.parametrize("case", list(HANDOFF))
def test_handoff_matches_prefill_of_the_extended_prompt(case):
    make, kw, prompt_len = HANDOFF[case]
    assert _handoff_worst_err(make(**kw), prompt_len) < 1e-4


def test_prompt_overflowing_full_cache_raises():
    cfg = _tiny()
    params = TT.init_params(cfg, device="cpu")
    _, st = TE.prefill(params, cfg, torch.zeros((2, 8), dtype=torch.int32),
                       chunk=8)
    with pytest.raises(ValueError, match="cannot hand off"):
        TE.pad_states_for_decode(cfg, st, 8, 4)


def test_handoff_matches_token_by_token_replay():
    """Replaying the prompt through ``serve_step`` from cold caches and
    prefilling it once give the same logits stream."""
    cfg = _tiny()
    params = TT.init_params(cfg, device="cpu")
    b, prompt_len, gen = 2, 8, 3
    cap = prompt_len + gen
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (b, prompt_len)).astype(np.int32))

    def greedy(logits, st):
        out = [logits]
        for i in range(gen - 1):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            logits, st = TE.serve_step(params, cfg, tok, st, prompt_len + i,
                                       chunk=8)
            out.append(logits)
        return out

    st = TE.init_states(cfg, b, cap, TL.DTYPES[cfg.dtype], device="cpu")
    for i in range(prompt_len):
        logits_r, st = TE.serve_step(params, cfg, toks[:, i][:, None], st, i,
                                     chunk=8)
    replay = greedy(logits_r, st)
    logits_h, st2 = TE.prefill(params, cfg, toks, chunk=8)
    handoff = greedy(logits_h, TE.pad_states_for_decode(cfg, st2,
                                                        prompt_len, cap))
    for i, (r, h) in enumerate(zip(replay, handoff)):
        np.testing.assert_allclose(h.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch,what", [("jamba_v0_1_52b", "mamba")])
def test_unported_families_raise_naming_item_13d(arch, what):
    """The layers that raised naming item 13d serve now: Jamba's Mamba
    layers get their O(1) states (the conv tail in the cache dtype, the
    SSM state in f32), which ``pad_states_for_decode`` passes through
    untouched while it grows the attention layer's cache."""
    cfg = TB.get_smoke_config(arch)
    st = TE.init_states(cfg, 1, 8, torch.bfloat16, device="cpu")
    specs = TT.build_blockspecs(cfg)
    mamba = [st["blocks"][j] for j in range(TT.find_period(specs))
             if specs[j].kind == what]
    assert len(mamba) == 4
    for m in mamba:
        assert m["conv"].dtype == torch.bfloat16
        assert m["ssm"].dtype == torch.float32
        assert tuple(m["ssm"].shape) == (1, 1, 2 * cfg.d_model, 16)
    params = TT.init_params(cfg, device="cpu")
    _, pre = TE.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                        chunk=8)
    out = TE.pad_states_for_decode(cfg, pre, 4, 8)
    for j, spec in enumerate(specs[:TT.find_period(specs)]):
        if spec.kind == what:
            assert out["blocks"][j] is pre["blocks"][j]
        else:
            assert out["blocks"][j]["self"]["k"].shape[2] == 8


# --- launch/serve and launch/specs ------------------------------------------

def _cache_dims(states):
    return {leaf.shape[leaf.ndim - 3]
            for st in states["blocks"] + states["tail"]
            if isinstance(st, dict) and "self" in st
            for leaf in tree.leaves(st["self"])}


def test_make_prefill_step_applies_long_context_rewrite():
    """Under ``long_500k`` a gemma3 global layer prefills with the window
    it will decode with; the steps' specs are meta tensors, and a step
    applied to them gives meta outputs of the right shapes."""
    cfg = TB.get_smoke_config("gemma3_27b")
    win, s = cfg.sliding_window, 32
    fn, (psh, bsh) = TSV.make_prefill_step(
        cfg, None, TB.InputShape("long_500k", s, 2, "prefill"), chunk=8)
    logits, states = fn(psh, bsh)
    assert logits.device.type == "meta" and tuple(logits.shape) == \
        (2, cfg.vocab)
    assert _cache_dims(states) == {win}
    dshape = TB.InputShape("long_500k", s, 2, "decode")
    sds, cfg2 = TSV.state_specs(cfg, None, dshape)
    assert cfg2.local_global_period is None
    assert _cache_dims(sds["states"]) == {win}
    step, args = TSV.make_serve_step(cfg, None, dshape, chunk=8)
    logits, _ = step(*args[:3], 5)
    assert tuple(logits.shape) == (2, cfg.vocab)
    # the reference resolves the same configs
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(
        JSV.serve_cfg(JB.get_smoke_config("gemma3_27b"), "long_500k"))


def test_short_shapes_unchanged():
    cfg = TB.get_smoke_config("gemma3_27b")
    assert TSV.serve_cfg(cfg, "decode_32k") is cfg
    assert TSV.serve_cfg(cfg, "long_500k").local_global_period is None


def test_model_axis_raises_naming_item_7():
    """Since item 7f's second part every family is served on a 'model'
    axis (``tests/test_torch_tp_serving_families.py``): the steps' specs
    build for xLSTM on a 'model' axis of 2, and raise only where its 4
    heads do not split over the axis (8), as its layers hold a rank's
    heads."""
    shape = TB.InputShape("s", 8, 1, "decode")
    cfg = TB.get_smoke_config("xlstm_1_3b")
    for model, ok in ((2, True), (8, False)):
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     size=lambda i, m=model: (1, m)[i])
        assert TSV.tensor_parallel(cfg, mesh) and TSV.tensor_parallel(
            _tiny(), mesh)
        if ok:
            TSV.state_specs(cfg, mesh, shape)
        else:
            with pytest.raises(ValueError, match="heads do not split"):
                TSV.state_specs(cfg, mesh, shape)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_specs_match_reference(kind):
    cfg_t, cfg_j = _tiny(), JB.get_smoke_config("tinyllama_1_1b")
    shape_t = TB.InputShape("long_500k", 12, 3, kind)
    shape_j = JB.InputShape("long_500k", 12, 3, kind)
    for fn_t, fn_j in ((TSP.train_batch_specs, JSP.train_batch_specs),
                       (TSP.decode_batch_specs, JSP.decode_batch_specs)):
        got, want = fn_t(cfg_t, shape_t), fn_j(cfg_j, shape_j)
        assert sorted(got) == sorted(want)
        for name in got:
            assert got[name].device.type == "meta"
            assert tuple(got[name].shape) == tuple(want[name].shape)
            assert str(got[name].dtype).split(".")[-1] == \
                want[name].dtype.name
    batch = TSP.concrete_batch(cfg_t, shape_t, seed=1, device="cpu")
    assert batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < cfg_t.vocab
    if kind == "train":
        assert torch.equal(batch["labels"], batch["tokens"])
    for arch in ("tinyllama_1_1b", "gemma3_27b"):
        assert TSP.supports_shape(TB.get_config(arch), shape_t) == \
            JSP.supports_shape(JB.get_config(arch), shape_j)
    assert [TSP.audio_frames(n) for n in (1, 7, 4096)] == \
        [JSP.audio_frames(n) for n in (1, 7, 4096)]
    # a VLM's sequence: its patches (at most half of it), then the text
    got = TSP.train_batch_specs(TB.get_smoke_config("llava_next_mistral_7b"),
                                shape_t)
    want = JSP.train_batch_specs(
        JB.get_smoke_config("llava_next_mistral_7b"), shape_j)
    assert list(got) == list(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# --- windowed attention in training -----------------------------------------

def test_gemma3_smoke_loss_and_grads_match_reference():
    """gemma3's smoke config (window 16, local/global period 2) through
    ``from_jax_params``: 40 tokens, so the window masks keys, in chunks
    of 8."""
    cfg_j = JB.get_smoke_config("gemma3_27b")
    cfg_t = TB.get_smoke_config("gemma3_27b")
    assert cfg_t.sliding_window == 16 and cfg_t.local_global_period == 2
    params = jax.jit(lambda k: JT.init_model(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    assert [b.window for b in TT.build_blockspecs(cfg_t)] == [16, None]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab, (2, 41)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(
        p, cfg_j, b, chunk=8, loss_chunk=8)[0]))(
        params, jax.tree.map(jnp.asarray, batch))
    tl, _ = TT.loss_fn(module.params, cfg_t,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       chunk=8, loss_chunk=8)
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-6)
