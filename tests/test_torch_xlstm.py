"""The xLSTM family in the port (``repro_torch.models.xlstm``'s mLSTM and
its branches in the transformer) and per-period activation
checkpointing (``forward(remat=)``/``loss_fn(remat=)``), against the
reference's ``repro.models.xlstm`` and ``repro.models.transformer``.

The same numpy inputs and parameters (the reference's init, carried
over as numpy) go through both packages.  Contracts, f32 on the CPU:

  * the mLSTM block (d 32, 4 heads: hd 16): ``mlstm_specs``' shapes and
    logical axes are ``init_mlstm``'s and its constant biases (−10, 3)
    exact; the closed-form chunk (``_mlstm_chunk``) against that many
    steps of the reference's ``_mlstm_cell``, and ``mlstm_forward``
    (from zeros and from a given state, with ``return_state``, in one
    chunk and in several) within rtol 2e-5, atol 2e-6, the sLSTM test's
    (``test_torch_paper.py``); the gradients of both blocks (a sum of
    squares of the output and the final state) at rtol 2e-4 and an atol
    of 1e-6 of the leaf's largest |gradient| (f32 sums in another order
    cancel to absolute errors at the scale of their largest terms);
  * the xLSTM smoke model (one mLSTM/sLSTM period): leaf order and
    shapes; loss and gradients against the reference's ``loss_fn``, both
    with ``remat=True``, at ``test_torch_paper.py``'s tolerances (loss
    rtol 2e-5, gradients rtol 2e-4 atol 2e-6); 3 ``SimTrainer``
    ``lags_dp`` steps on the xla and kernel backends at
    ``test_torch_train.py``'s (losses rtol 1e-5, parameters and
    residuals rtol 1e-4 atol 1e-5);
  * serving: the prefill -> decode handoff against a token-by-token
    replay at 1e-4 (the engine's parity with the reference is
    ``test_torch_serving.py``'s, whose parity ids include the xLSTM);
  * ``remat``: loss and every gradient with remat on equal those with
    it off bit for bit, on the TinyLlama, Granite (MoE) and xLSTM smoke
    configs.
"""
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

D, H = 32, 4
ARCH = "xlstm_1_3b"


def _block(seed=0):
    """The reference's init of one mLSTM block, as numpy, with biases
    drawn so that both gates vary across heads."""
    p, _ = JX.init_mlstm(jax.random.PRNGKey(seed), D, H, jnp.float32)
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    p["b_igate"] = p["b_igate"] + rng.standard_normal(H).astype(np.float32)
    p["b_fgate"] = p["b_fgate"] + rng.standard_normal(H).astype(np.float32)
    p["out_norm"] = 0.1 * rng.standard_normal(2 * D).astype(np.float32)
    return p


def _x(seed=1, shape=(2, 12, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(seed=2, b=2):
    """A nonzero (C, n, m) to start from."""
    hd = 2 * D // H
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, H, hd, hd)).astype(np.float32),
            0.1 * rng.standard_normal((b, H, hd)).astype(np.float32),
            rng.standard_normal((b, H)).astype(np.float32))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=2e-5,
                               atol=2e-6, err_msg=what)


def test_mlstm_specs_match_init_mlstm():
    specs, axes = TX.mlstm_specs(D, H)
    p, jaxes = JX.init_mlstm(jax.random.PRNGKey(0), D, H, jnp.float32)
    assert sorted(specs) == sorted(p) and axes == jaxes
    for k, (shape, _) in specs.items():
        assert tuple(shape) == p[k].shape, k
    module_p = TT.init_params(
        TB.get_smoke_config(ARCH), device="cpu")["decoder"]["blocks"][0]
    assert bool((module_p["mlstm"]["b_igate"] == -10.0).all())
    assert bool((module_p["mlstm"]["b_fgate"] == 3.0).all())
    assert bool((module_p["mlstm"]["out_norm"] == 0.0).all())
    np.testing.assert_array_equal(np.asarray(p["b_igate"]),
                                  np.full(H, -10.0, np.float32))
    np.testing.assert_array_equal(np.asarray(p["b_fgate"]),
                                  np.full(H, 3.0, np.float32))
    w = module_p["mlstm"]["w_igate"]
    assert abs(float(w.std()) - 0.1 / math.sqrt(2 * D)) < 0.01


@pytest.mark.parametrize("steps", [1, 6])
def test_mlstm_chunk_matches_reference_cells(steps):
    """A chunk of 1 is one cell step; a chunk of 6 is six, the gates
    drawn wide so that the stabiliser moves."""
    b, hd = 2, 2 * D // H
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((b, H, steps, hd)).astype(np.float32)
               for _ in range(3))
    i_raw, f_raw = (3 * rng.standard_normal((b, H, steps)).astype(
        np.float32) for _ in range(2))
    state = tuple(map(jnp.asarray, _state()))
    jh = []
    for t in range(steps):
        state, h = JX._mlstm_cell(state, tuple(jnp.asarray(a[:, :, t]) for
                                               a in (q, k, v, i_raw, f_raw)))
        jh.append(h)
    (tc, tn, tm), th = TX._mlstm_chunk(
        tuple(map(torch.from_numpy, _state())),
        *map(torch.from_numpy, (q, k, v, i_raw, f_raw)))
    for what, got, want in (("C", tc, state[0]), ("n", tn, state[1]),
                            ("m", tm, state[2]),
                            ("h", th, np.stack(jh, axis=2))):
        _close(got.numpy(), want, what)


def _run_mlstm(p, x, st, chunk):
    return TX.mlstm_forward(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        n_heads=H, state=None if st is None else tuple(map(torch.from_numpy,
                                                           st)),
        return_state=True, chunk=chunk)


@pytest.mark.parametrize("chunk", [5, 1024])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_forward_matches_reference(with_state, chunk):
    p, x = _block(), _x()
    st = _state() if with_state else None
    jout, jst = JX.mlstm_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        n_heads=H, state=None if st is None else tuple(map(jnp.asarray, st)),
        return_state=True)
    tout, tst = _run_mlstm(p, x, st, chunk)
    _close(tout.numpy(), jout, "out")
    for i, (g, w) in enumerate(zip(tst, jst)):
        _close(g.numpy(), w, f"state {i}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_gradients_match_reference(kind):
    """Output and final state both feed the loss, so every backward path
    of the scans runs: the sLSTM's written-out backward (ties in its
    max(n, 1) at the zero start included) and the mLSTM's chunks."""
    if kind == "mlstm":
        p, st = _block(), _state()
        jfwd, tfwd = JX.mlstm_forward, TX.mlstm_forward
        kw = dict(chunk=5)
    else:
        pj, _ = JX.init_slstm(jax.random.PRNGKey(3), D, H, jnp.float32)
        p = {k: np.asarray(v) for k, v in pj.items()}
        st = tuple(np.zeros((2, H, D // H), np.float32) for _ in range(4))
        jfwd, tfwd = JX.slstm_forward, TX.slstm_forward
        kw = {}
    x = _x()

    def jloss(p, x, st):
        out, fin = jfwd(p, x, n_heads=H, state=st, return_state=True)
        return jnp.sum(out ** 2) + sum(jnp.sum(f ** 2) for f in fin)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        tuple(map(jnp.asarray, st)))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tst = tuple(torch.from_numpy(v).requires_grad_() for v in st)
    out, fin = tfwd(tp, tx, n_heads=H, state=tst, return_state=True, **kw)
    loss = (out ** 2).sum() + sum((f ** 2).sum() for f in fin)
    got = torch.autograd.grad(loss, [*tp.values(), tx, *tst])
    wants = [want[0][k] for k in tp] + [want[1], *want[2]]
    for i, (g, w) in enumerate(zip(got, wants)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=f"{kind} grad {i}")


# --- the smoke model ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = JB.get_smoke_config(arch)
    return jax.jit(lambda k: JT.init_model(k, cfg)[0])(jax.random.PRNGKey(0))


def _module(arch):
    return TT.from_jax_params(jax.tree.map(np.asarray, _jax_params(arch)),
                              TB.get_smoke_config(arch), device="cpu")


def _batch(cfg, seed=1, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _paths(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


def test_leaf_order_and_shapes_match_reference():
    params, module = _jax_params(ARCH), _module(ARCH)
    assert tree.leaf_paths(module.params) == _paths(params)
    assert [tuple(p.shape) for p in tree.leaves(module.params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(params)]
    assert {"mlstm", "ln_attn"} == set(module.params["decoder"]["blocks"][0])
    assert TB.get_smoke_config(ARCH).param_count() == sum(
        x.size for x in jax.tree.leaves(params))


def test_loss_and_grads_match_reference():
    cfg_j, cfg_t = JB.get_smoke_config(ARCH), TB.get_smoke_config(ARCH)
    params, module = _jax_params(ARCH), _module(ARCH)
    batch = _batch(cfg_j)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(
        p, cfg_j, b, chunk=8, loss_chunk=8, remat=True)[0]))(
        params, jax.tree.map(jnp.asarray, batch))
    tl, _ = TT.loss_fn(module.params, cfg_t,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       chunk=8, loss_chunk=8, remat=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    for g, w, path in zip(grads, jax.tree.leaves(jg),
                          tree.leaf_paths(module.params)):
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-6, err_msg=path)


P, STEPS = 2, 3


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_three_sim_steps_match_reference(backend):
    """lags_dp at ratio 100, lr 0.1, 2 workers."""
    cfg_j, cfg_t = JB.get_smoke_config(ARCH), TB.get_smoke_config(ARCH)
    params, module = _jax_params(ARCH), _module(ARCH)
    kw = dict(mode="lags_dp", ratio=100.0, lr=0.1, selection_backend=backend)
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


def test_handoff_matches_token_by_token_replay():
    """Prefill -> ``pad_states_for_decode`` -> decode against feeding the
    prompt one token at a time, greedy, 1e-4: the (C, n, m) and (c, n,
    m, h) states pass through the handoff unchanged."""
    from repro_torch.serving import engine as TE
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
    assert all(a is b for a, b in zip(tree.leaves(padded),
                                      tree.leaves(st2)))
    handoff = greedy(logits_h, padded)
    for i, (r, h) in enumerate(zip(replay, handoff)):
        np.testing.assert_allclose(h.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"decode step {i}")


# --- remat -------------------------------------------------------------------

def _loss_and_grads(arch, remat):
    cfg = TB.get_smoke_config(arch)
    module = _module(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=5).items()}
    loss, parts = TT.loss_fn(module.params, cfg, batch, chunk=8,
                             loss_chunk=8, remat=remat)
    return loss, parts, torch.autograd.grad(loss, tree.leaves(module.params))


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "granite_moe_3b_a800m",
                                  ARCH])
def test_remat_on_and_off_are_bitwise_equal(arch, monkeypatch):
    """The recompute of each period repeats its forward exactly: loss,
    aux and every gradient bit for bit.  With remat each period runs
    twice (the forward and its recompute in the backward)."""
    calls = []
    period = TT._period

    def counted(*args, **kw):
        calls.append(args[0])
        return period(*args, **kw)

    monkeypatch.setattr(TT, "_period", counted)
    specs = TT.build_blockspecs(TB.get_smoke_config(arch))
    n_periods = len(specs) // TT.find_period(specs)
    on_loss, on_parts, on_grads = _loss_and_grads(arch, True)
    assert len(calls) == 2 * n_periods
    calls.clear()
    off_loss, off_parts, off_grads = _loss_and_grads(arch, False)
    assert len(calls) == n_periods
    assert torch.equal(on_loss, off_loss)
    assert torch.equal(on_parts["aux"], off_parts["aux"])
    assert len(on_grads) == len(off_grads) >= 12
    for i, (a, b) in enumerate(zip(on_grads, off_grads)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), i
        assert float(a.abs().max()) > 0, i
