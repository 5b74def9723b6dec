"""The MoE family in the port (``repro_torch.models.moe`` and its
branches in the transformer, the exchange and the serving engine)
against the reference's ``repro.models.moe``.

The same numpy inputs and parameters (the reference's init, carried
over as numpy) go through both packages.  Contracts, f32 on the CPU:

  * the layer (d 32, F 64, E 4): the router's ``expert_idx`` exactly
    (the smallest margin between the k-th and the (k+1)-th probability
    is asserted above zero and reported in the failure message), its
    gates and aux within rtol 1e-6 (the softmax's exp is another
    library's: the gates differ by an ulp); ``_positions`` exactly;
    ``moe_forward`` at capacity factors 0.01, 1.25 and 8 and
    ``moe_forward_grouped`` at groups 1, 2 and 4 within atol and rtol
    1e-5; the gradients of a scalar loss with respect to x and every
    leaf within atol and rtol 1e-5; ties between experts go to the
    lowest index, as ``jax.lax.top_k``'s; ``tests/test_moe.py``'s
    behaviours (capacity drops, full capacity, the grouped dispatch
    equals per-group dispatch, normalised gates, aux >= 1);
  * the models (Granite-3.0-MoE and OLMoE smoke configs): leaf order and
    shapes; loss, aux and gradients against the reference's ``loss_fn``
    at ``test_torch_paper.py``'s tolerances (loss rtol 2e-5, gradients
    rtol 2e-4 atol 2e-6); 3 ``SimTrainer`` ``lags_dp`` steps at
    ``test_torch_train.py``'s (losses rtol 1e-5, parameters and
    residuals rtol 1e-4 atol 1e-5); the block exchange on the expert
    stacks bitwise, both backends;
  * ``lags_hier``'s FSDP block layout of the expert leaves equals the
    reference's;
  * serving: the prefill -> decode handoff against a token-by-token
    replay at 1e-4 (the reference-parity of prefill and decode is
    ``test_torch_serving.py``'s, whose parity ids include both configs);
  * the weight stream at smoke size: ``Session.run`` of Granite's smoke
    model publishing, a ``ServeSession`` following the files bitwise
    after the flush, then serving.
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
from repro.core import lags as JLG  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import lags as TLG  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

D, F, E = 32, 64, 4
MOE_IDS = ("granite_moe_3b_a800m", "olmoe_1b_7b")


def _layer(seed=0, gated=True):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if gated:
        p["w_gate"] = rng.standard_normal((E, D, F)) / np.sqrt(D)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(seed=1, shape=(4, 8, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad)
            for k, v in p.items()}


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


_jroute = jax.jit(JM._route, static_argnums=2)


# --- the layer ---------------------------------------------------------------

def test_specs_match_init_moe():
    """Shapes, axes and scales (each the std of the reference's draws of
    a wider layer) of ``init_moe``."""
    d, f, e = 256, 128, 8
    for gated in (False, True):
        box = {}

        def initf(k):
            p, box["axes"] = JM.init_moe(k, d, f, e, jnp.float32, gated=gated)
            return p
        jp, jax_axes = jax.jit(initf)(jax.random.PRNGKey(0)), box["axes"]
        specs, axes = TM.moe_specs(d, f, e, gated=gated)
        assert axes == jax_axes
        assert {k: s[0] for k, s in specs.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        for k, (_, scale) in specs.items():
            assert scale == pytest.approx(float(np.std(np.asarray(jp[k]))),
                                          rel=0.05), k


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_reference(top_k):
    p, xt = _layer(), _x(shape=(64, D))
    jg, ji, ja = _jroute(_jax(p), jnp.asarray(xt), top_k)
    tg, ti, ta = TM._route(_torch(p), torch.from_numpy(xt), top_k)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt) @ p["router"], -1))
    srt = -np.sort(-probs, -1)
    margin = float((srt[:, top_k - 1] - srt[:, top_k]).min())
    assert margin > 0, "a tie at the k-th probability"
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji),
                                  err_msg=f"smallest margin {margin:.3e}")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # tests/test_moe.py's router invariants
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert float(TM._route(_torch(p), torch.from_numpy(
        _x(4, (256, D))), 2)[2]) >= 0.99


def test_ties_go_to_the_lowest_expert_as_lax_top_k():
    """Router columns 1 and 3 equal, and 0 and 2: every token ties in
    pairs, and both packages pick the lower expert of each tie first."""
    p = _layer()
    p["router"][:, 3] = p["router"][:, 1]
    p["router"][:, 2] = p["router"][:, 0]
    xt = _x(shape=(16, D))
    for top_k in (1, 2, 3):
        ji = _jroute(_jax(p), jnp.asarray(xt), top_k)[1]
        ti = TM._route(_torch(p), torch.from_numpy(xt), top_k)[1]
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ((ti[:, 0] == 0) | (ti[:, 0] == 1)).all()


@pytest.mark.parametrize("capacity", [1, 3, 8, 100])
def test_positions_match_reference(capacity):
    flat = np.random.default_rng(2).integers(0, E, 40)
    jpos, jkeep = JM._positions(jnp.asarray(flat, jnp.int32), E, capacity)
    tpos, tkeep = TM._positions(torch.from_numpy(flat), E, capacity)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("capacity_factor", [0.01, 1.25, 8.0])
def test_moe_forward_matches_reference(capacity_factor, gated):
    p, x = _layer(gated=gated), _x()
    jo, ja = jax.jit(functools.partial(
        JM.moe_forward, top_k=2, capacity_factor=capacity_factor))(
        _jax(p), jnp.asarray(x))
    to, ta = TM.moe_forward(_torch(p), torch.from_numpy(x), top_k=2,
                            capacity_factor=capacity_factor)
    _close(to, jo, "output")
    _close(ta, ja, "aux")


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_forward_grouped_matches_reference(groups):
    p, x = _layer(), _x()
    jo, ja = jax.jit(functools.partial(
        JM.moe_forward_grouped, top_k=2, groups=groups))(
        _jax(p), jnp.asarray(x))
    to, ta = TM.moe_forward_grouped(_torch(p), torch.from_numpy(x), top_k=2,
                                    groups=groups)
    _close(to, jo, "output")
    _close(ta, ja, "aux")
    # tests/test_moe.py: the grouped dispatch is each group dispatched
    # alone, aux their mean
    tg = x.shape[0] // groups * x.shape[1]
    outs, auxs = [], []
    for xs in torch.from_numpy(x).reshape(groups, tg, D):
        o, a = TM._dense_core(_torch(p), xs, top_k=2, act=TL.ACTIVATIONS[
            "silu"], capacity=max(1, int(1.25 * tg * 2 / E)))
        outs.append(o)
        auxs.append(a)
    np.testing.assert_allclose(to.reshape(groups, tg, D).numpy(),
                               torch.stack(outs).numpy(), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(float(ta), float(torch.stack(auxs).mean()),
                               rtol=1e-5)


@pytest.mark.parametrize("rows,pods,data,want", [
    (8, 2, 2, 2), (16, 2, 2, 2), (8, 1, 4, 1), (6, 2, 1, 1), (4, 1, 1, 1),
    (4, 2, 2, 0), (12, 2, 2, 0)])
def test_pod_auto_token_groups_follow_the_reference(rows, pods, data, want,
                                                    monkeypatch):
    """``lags_hier``'s grouping: each rank's rows dispatched in
    ``pod_auto_moe_groups`` groups, concatenated over a pod's ranks, give
    the reference's dispatch of the pod's slice in pods·data groups (its
    vmap over pods, its auto 'pod' and 'data' axes), output and mean aux.
    A group that spans ranks (``POD_SPAN``, 0) goes as a ``TokenSpan``:
    the pod's rows gathered (here the gather hands each rank the pod's
    slice), one dispatch, each rank its own rows and the group's aux;
    beside a 'model' axis it raises naming item 7e's third part."""
    from repro_torch.launch import train as TTR
    assert TTR.pod_auto_moe_groups(rows, pods, data) == want
    if want == TTR.POD_SPAN:
        with pytest.raises(NotImplementedError, match="item 7e's third"):
            TTR.pod_auto_moe_groups(rows, pods, data, model=2)
    p, x = _layer(), _x(shape=(rows, 4, D))
    per_pod, per_rank = rows // pods, rows // (pods * data)
    for pod in range(pods):
        xs = x[pod * per_pod:(pod + 1) * per_pod]
        jo, ja = JM.moe_forward_grouped(_jax(p), jnp.asarray(xs), top_k=2,
                                        groups=pods * data)
        if want == TTR.POD_SPAN:
            seen = []
            monkeypatch.setattr(TM.TP, "gather_rows", lambda x, group, n: (
                seen.append((group, n)) or torch.from_numpy(xs)))
        outs, auxs = zip(*(TM.moe_forward_auto(
            _torch(p), torch.from_numpy(xs[r * per_rank:(r + 1) * per_rank]),
            top_k=2, groups=TM.TokenSpan("pod", data, r)
            if want == TTR.POD_SPAN else want) for r in range(data)))
        if want == TTR.POD_SPAN:
            assert seen == [("pod", data)] * data
            for a in auxs:
                _close(a, ja, f"pod {pod} aux")
        _close(torch.cat(outs), jo, f"pod {pod} output")
        _close(torch.stack(auxs).mean(), ja, f"pod {pod} aux")


@pytest.mark.parametrize("capacity_factor", [0.01, 1.25])
def test_gradients_match_reference(capacity_factor):
    """d(sum(out²) + aux) with respect to x and every leaf: the dropped
    pairs take no gradient, the kept ones exactly one (the gathers'
    inverse maps)."""
    p, x = _layer(), _x()

    def jloss(pp, xx):
        o, a = JM.moe_forward(pp, xx, top_k=2,
                              capacity_factor=capacity_factor)
        return jnp.sum(o * o) + a
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        _jax(p), jnp.asarray(x))
    tp = _torch(p, grad=True)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    o, a = TM.moe_forward(tp, tx, top_k=2, capacity_factor=capacity_factor)
    names = sorted(tp)
    grads = torch.autograd.grad((o * o).sum() + a, [tx] + [tp[n]
                                                          for n in names])
    _close(grads[0], jgx, "d/dx")
    for n, g in zip(names, grads[1:]):
        _close(g, jgp[n], f"d/d{n}")


def test_capacity_drop_and_full_capacity():
    """tests/test_moe.py: at a tiny capacity factor most tokens drop and
    give zero output (the residual carries them); at 8 none does."""
    p = _torch(_layer())
    out, _ = TM.moe_forward(p, torch.from_numpy(_x(5, (2, 16, D))), top_k=2,
                            capacity_factor=0.01)
    assert float((out.abs().sum(-1) == 0).float().mean()) > 0.5
    out, _ = TM.moe_forward(p, torch.from_numpy(_x(6, (2, 16, D))), top_k=2,
                            capacity_factor=8.0)
    assert float(out.abs().sum(-1).min()) > 0


def test_forward_and_backward_repeat_bitwise():
    p, x = _layer(), _x()
    runs = []
    for _ in range(2):
        tp = _torch(p, grad=True)
        tx = torch.from_numpy(x.copy()).requires_grad_()
        o, a = TM.moe_forward_auto(tp, tx, top_k=2)
        grads = torch.autograd.grad((o * o).sum() + a, [tx] + list(
            tp.values()))
        runs.append([o.detach(), a.detach()] + list(grads))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


def test_expert_parallel_raises_naming_item_7():
    """Expert parallelism runs (``tests/test_torch_tp_families.py`` holds
    it to the reference on a 'model' axis); on plain leaves, which no
    'model' axis splits, ``moe_forward_ep`` refuses and names what it
    takes."""
    with pytest.raises(ValueError, match="DTensor leaves.*split on E"):
        TM.moe_forward_ep(_torch(_layer()), torch.from_numpy(_x()), top_k=2)


# --- the models ----------------------------------------------------------------

def _init(cfg):
    return jax.jit(lambda k: JT.init_model(k, cfg)[0])(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=MOE_IDS)
def moe_pair(request):
    cfg_j = JB.get_smoke_config(request.param)
    cfg_t = TB.get_smoke_config(request.param)
    params = _init(cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    return cfg_j, cfg_t, params, module


def _paths(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


def test_leaf_order_shapes_and_axes_match_reference(moe_pair):
    cfg_j, cfg_t, params, module = moe_pair
    assert tree.leaf_paths(module.params) == _paths(params)
    assert [tuple(p.shape) for p in tree.leaves(module.params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(params)]
    box = {}
    jax.eval_shape(lambda k: box.setdefault(
        "axes", JT.init_model(k, cfg_j)[1]) and None, jax.random.PRNGKey(0))
    jaxes = box["axes"]
    is_ax = lambda a: isinstance(a, tuple)  # noqa: E731
    assert tree.flatten_up_to(tree.flatten(module.params)[1],
                              TT.logical_axes(cfg_t)) == \
        jax.tree.leaves(jaxes, is_leaf=is_ax)
    assert "moe" in module.params["decoder"]["blocks"][0]
    np.testing.assert_array_equal(
        TT.to_numpy_tree(module)["decoder"]["blocks"][0]["moe"]["w_up"],
        np.asarray(params["decoder"]["blocks"][0]["moe"]["w_up"]))


def test_loss_aux_and_grads_match_reference(moe_pair):
    cfg_j, cfg_t, params, module = moe_pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab, (2, 17)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :2] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p, b: (lambda r: (
        r[0], r[1]["aux"]))(JT.loss_fn(p, cfg_j, b, chunk=8, loss_chunk=8)),
        has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    tl, tm = TT.loss_fn(module.params, cfg_t,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        chunk=8, loss_chunk=8)
    assert float(tm["aux"]) > 0.99 * cfg_t.n_layers
    np.testing.assert_allclose(float(tm["aux"]), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    grads = torch.autograd.grad(tl, tree.leaves(module.params))
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-6)


P, STEPS = 2, 3


@pytest.mark.parametrize("arch", MOE_IDS)
def test_three_sim_steps_match_reference(arch):
    """lags_dp at ratio 100, lr 0.1, 2 workers, the xla backend (the
    kernel backend's plain versions on the expert stacks:
    ``test_block_exchange_on_expert_stacks_matches_reference``)."""
    cfg_j, cfg_t = JB.get_smoke_config(arch), TB.get_smoke_config(arch)
    params = _init(cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    kw = dict(mode="lags_dp", ratio=100.0, lr=0.1)
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg_j.vocab, (P, 2, 17)).astype(np.int32)
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


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_block_exchange_on_expert_stacks_matches_reference(use_kernel):
    """``BlockLAGSExchange`` (the distributed lags_dp exchange) on
    Granite's smoke expert stacks (2, 4, 128, 64), 16 blocks of 4096 at
    ratio 1000 (k_b 5): means and residuals bitwise over two steps, the
    residual fed back, P = 2."""
    cfg = TB.get_smoke_config("granite_moe_3b_a800m")
    moe = TT.abstract_params(cfg)["decoder"]["blocks"][0]["moe"]
    shapes = {k: tuple(v.shape) for k, v in moe.items()
              if k != "router"}
    ks = {k: max(1, int(np.prod(s) / 1000)) for k, s in shapes.items()}
    tex = TLG.BlockLAGSExchange(ks=ks, block_size=4096, use_kernel=use_kernel)
    jex = JLG.BlockLAGSExchange(ks=ks, block_size=4096, use_kernel=use_kernel)
    jstep = jax.jit(lambda u, e: jex.exchange(u, e, None))
    rng = np.random.default_rng(9)
    e = {k: np.zeros((P,) + s, np.float32) for k, s in shapes.items()}
    for step in range(2):
        u = {k: (1e-2 * rng.standard_normal((P,) + s)).astype(np.float32)
             for k, s in shapes.items()}
        tm, te = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                              {k: torch.from_numpy(np.array(v))
                               for k, v in e.items()}, None)
        jm, je = jstep(jax.tree.map(jnp.asarray, u),
                       jax.tree.map(jnp.asarray, e))
        for k in shapes:
            for got, want, what in ((tm[k], jm[k], "mean"),
                                    (te[k], je[k], "residual")):
                np.testing.assert_array_equal(
                    _bits(got.numpy()), _bits(want),
                    err_msg=f"{what} {k} step {step}")
            assert int((tm[k] != 0).sum()) > 0
        e = jax.tree.map(np.asarray, je)


@pytest.mark.parametrize("arch", MOE_IDS)
@pytest.mark.parametrize("pod,data", [(2, 2), (1, 4)])
def test_fsdp_block_layout_of_expert_leaves_matches_reference(arch, pod,
                                                              data):
    """lags_hier lays each leaf's FSDP dim first: the dim the
    reference's ``FSDP_CANDIDATES`` order picks (for the expert stacks
    "embed", the model width), so the same entries share a block."""
    from repro.sharding import rules as JRULES
    from repro_torch.sharding import rules as TRULES
    cfg_j, cfg_t = JB.get_smoke_config(arch), TB.get_smoke_config(arch)
    box = {}

    def initf(k):
        p, box["axes"] = JT.init_model(k, cfg_j)
        return p
    sds = jax.eval_shape(initf, jax.random.PRNGKey(0))
    is_axes = lambda a: isinstance(a, tuple)   # noqa: E731
    sizes = {"data": data, "model": 1} | ({"pod": pod} if pod > 1 else {})
    tparams = TT.abstract_params(cfg_t)
    tspecs = TRULES.tree_specs(tparams, TT.logical_axes(cfg_t), sizes,
                               fsdp_axis="data")
    want = [tuple(s) for s in jax.tree.leaves(
        jax.tree.map(lambda p, a: JRULES.spec_for_leaf(
            p.shape, a, sizes, fsdp_axis="data"), sds, box["axes"],
            is_leaf=is_axes),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]
    treedef = tree.flatten(tparams)[1]
    assert tree.flatten_up_to(treedef, tspecs) == want
    dims = dict(zip(tree.leaf_paths(tparams), tree.flatten_up_to(
        treedef, TRULES.shard_dims_tree(tparams, tspecs, ("data",)))))
    for name in ("w_up", "w_gate", "w_down"):
        path = f"decoder/blocks/0/moe/{name}"
        embed = TT.logical_axes(cfg_t)["decoder"]["blocks"][0]["moe"][
            name].index("embed")
        assert dims[path] == (embed,), path


# --- serving and the stream ---------------------------------------------------

@pytest.mark.parametrize("arch", MOE_IDS)
def test_handoff_matches_token_by_token_replay(arch):
    """Prefill -> ``pad_states_for_decode`` -> decode against feeding the
    prompt one token at a time, greedy, 1e-4: serving is drop-free, so
    the prefill's 2·12 tokens route as the replay's 2 at a time."""
    from repro_torch.serving import engine as TE
    cfg = TB.get_smoke_config(arch)
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
    handoff = greedy(logits_h, TE.pad_states_for_decode(cfg, st2,
                                                        prompt_len, cap))
    for i, (r, h) in enumerate(zip(replay, handoff)):
        np.testing.assert_allclose(h.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"decode step {i}")


def test_stream_follows_granite_smoke_training_bitwise(tmp_path):
    """``Session.run`` of 4 ``lags_dp`` steps on a gloo world of one,
    publishing every 2 steps; after the flush a ``ServeSession`` that
    applied every packet file holds the trained parameters bit for bit,
    and generates from them."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SP
    from repro_torch.stream import ServeSession, StreamPublisher
    cfg = dataclasses.replace(TB.get_smoke_config("granite_moe_3b_a800m"),
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
