"""The port's pipeline layer (``repro_torch.pipeline``) and the SLGS
baseline against the JAX reference, on the CPU, in one process: the
counterpart of ``tests/test_pipeline.py``'s artifact, planning and
regrouping tests.

  * wave artifacts and planning math (``default_waves``,
    ``predict_pipeline``, ``latency_matched_bytes``, ``stats``) equal the
    reference's, and a ``WaveSchedule`` written by either package binds
    in the other (leaf names match letter for letter);
  * ``waved_exchange`` over split waves is bitwise equal to the
    monolithic exchange, and to the reference's ``waved_exchange``;
  * ``SLGSExchange`` rejects split waves, and its simulation surface is
    bitwise equal to the reference's for ``topk_exact`` (xla) and for
    the kernel backend (the reference's Pallas kernels in interpret
    mode, the port's plain versions);
  * ``wave_backward`` (autograd hooks under ``loss.backward()``) is
    bitwise equal to ``autograd.grad`` + ``exchange`` on one worker, and
    leaves no ``.grad`` and no hook behind, also when a hook fails.

The distributed surface (4 gloo ranks, ``pipeline="wave"``/``"async1"``
through the train step) is ``test_torch_distributed.py``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import registry as JR  # noqa: E402
from repro.configs import tinyllama_1_1b as jcfg  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.core import lags as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.pipeline import buckets as JB  # noqa: E402
from repro.pipeline import step as JS  # noqa: E402
from repro.pipeline import waves as JW  # noqa: E402
from repro_torch import api, tree  # noqa: E402
from repro_torch import pipeline as TP  # noqa: E402
from repro_torch.api import registry as TR  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.core import lags as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.pipeline import buckets as TB  # noqa: E402
from repro_torch.pipeline import step as TS  # noqa: E402
from repro_torch.pipeline import waves as TW  # noqa: E402

BLOCK = 1024
# leaf sizes: one block or less, a short tail block, many blocks
LEAVES = {"a": (100,), "b": (40, 130), "c": (3, 700), "d": (2, 1024)}
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16, compression_ratio=8.0, dtype="float32",
             param_dtype="float32")
HW = JCM.Hardware(name="test_wire", alpha=1e-5, beta=5e-9, flops=1e12)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _assert_trees_bitwise(got, want, what=""):
    """Two trees (port or reference leaves: the port's flatten order is
    the reference's), leaf by leaf, bit for bit."""
    g, w = tree.leaves(got), tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(np.shape(b)), (what, i)
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what} leaf {i}")


def _np_tree(p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal((p,) + s)).astype(np.float32)
            for k, s in LEAVES.items()}


def _torch(t):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}


# ---------------------------------------------------------------------------
# artifacts and planning, against the reference
# ---------------------------------------------------------------------------

def _small_params():
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    cfg_t = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    jparams = jax.eval_shape(
        lambda: JT.init_model(jax.random.PRNGKey(0), cfg_j)[0])
    return jparams, TT.abstract_params(cfg_t)


def test_leaf_names_match_reference_letter_for_letter():
    jparams, tparams = _small_params()
    assert TB.leaf_names(tparams) == JB.leaf_names(jparams)
    nested = {"z": [np.ones(1), {"b": np.ones(2), "a": np.ones(3)}],
              "a": {"y": np.ones(4)}, "k": np.ones(7)}
    assert TB.leaf_names(nested) == JB.leaf_names(nested)


@pytest.mark.parametrize("granularity", ["leaf", "model"])
@pytest.mark.parametrize("target", [None, 1, 900, 2048, 1 << 20])
@pytest.mark.parametrize("budgets", [False, True])
def test_default_waves_match_reference(granularity, target, budgets):
    """The same partition, names, payload bytes and JSON, dense and
    sparse payloads, on the small transformer's leaves."""
    jparams, tparams = _small_params()
    ks = JL.ks_from_ratio(jparams, 8.0) if budgets else None
    tks = TL.ks_from_ratio(tparams, 8.0) if budgets else None
    if budgets:
        assert tree.leaves(tks) == jax.tree.leaves(ks)
    want = JW.default_waves(jparams, ks, granularity=granularity,
                            target_bytes=target, pipeline="async1")
    got = TW.default_waves(tparams, tks, granularity=granularity,
                           target_bytes=target, pipeline="async1")
    assert got.to_json() == want.to_json()
    assert TB.stats(got) == JB.stats(want)
    if granularity == "model":
        assert got.n_waves == 1
        assert got.waves[0].leaf_ids == tuple(range(got.n_leaves))


def test_default_waves_group_in_backprop_order():
    params = {"a": torch.zeros(100), "b": torch.zeros(100),
              "c": torch.zeros(100)}
    ws = TW.default_waves(params, None, target_bytes=900)
    ws.validate_cover(3)
    assert [w.names for w in ws.waves] == [("c", "b"), ("a",)]


@pytest.mark.parametrize("target", [1, 64, 100, 1 << 20])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_bucketing_matches_reference(target, value_dtype):
    from repro.core import bucketing as JBK
    from repro_torch.core import bucketing as TBK
    ks = [3, 17, 1, 40, 8, 8, 25, 2]
    assert TBK.payload_bytes_per_elem(value_dtype) == \
        JBK.payload_bytes_per_elem(value_dtype)
    got = TBK.assign_buckets(ks, target, value_dtype=value_dtype)
    want = JBK.assign_buckets(ks, target, value_dtype=value_dtype)
    assert [dataclasses.astuple(b) for b in got] == \
        [dataclasses.astuple(b) for b in want]
    assert TBK.bucket_stats(got) == JBK.bucket_stats(want)


@pytest.mark.parametrize("pipeline", ["off", "wave", "async1"])
@pytest.mark.parametrize("t_backward", [0.0, 3.0, 30.0])
def test_predict_pipeline_matches_reference(pipeline, t_backward):
    jw = (JB.Wave((0,), ("a",), t_comm=2.0, t_ready=2.0),
          JB.Wave((1,), ("b",), t_comm=2.0, t_ready=4.0),
          JB.Wave((2,), ("c",), t_comm=0.5, t_ready=4.5))
    tw = tuple(TB.Wave(**dataclasses.asdict(w)) for w in jw)
    kw = dict(t_forward=1.0, t_backward=t_backward, pipeline=pipeline)
    assert TW.predict_pipeline(tw, **kw) == JW.predict_pipeline(jw, **kw)
    assert TW.predict_pipeline((), **kw) == JW.predict_pipeline((), **kw)


def test_latency_matched_bytes_matches_reference():
    for hw in (HW, None, dataclasses.replace(HW, beta=0.0),
               dataclasses.replace(HW, alpha=1.0),
               dataclasses.replace(HW, alpha=1e-3)):
        assert TW.latency_matched_bytes(hw) == JW.latency_matched_bytes(hw)
    assert TW.DEFAULT_TARGET_BYTES == JW.DEFAULT_TARGET_BYTES
    assert TW.PIPELINE_MODES == JW.PIPELINE_MODES


def _two_waves(mod, pipeline="wave"):
    return mod.WaveSchedule(waves=(
        mod.Wave(leaf_ids=(1, 0), names=("w", "v"), nbytes=272,
                 t_comm=1e-4, t_ready=2e-3),
        mod.Wave(leaf_ids=(2,), names=("x",), nbytes=80,
                 t_comm=5e-5, t_ready=3e-3),
    ), pipeline=pipeline, predicted={"overlap": 0.5},
        meta={"granularity": "leaf"})


def test_wave_schedule_json_roundtrips_across_packages():
    assert TB.WAVE_SCHEDULE_VERSION == JB.WAVE_SCHEDULE_VERSION
    for pipeline in ("wave", "async1"):
        tws, jws = _two_waves(TB, pipeline), _two_waves(JB, pipeline)
        assert tws.to_json() == jws.to_json()
        assert TB.WaveSchedule.from_json(jws.to_json()) == tws
        assert JB.WaveSchedule.from_json(tws.to_json()) == jws
    with pytest.raises(ValueError, match="version"):
        TB.WaveSchedule.from_json('{"version": 99, "waves": []}')


def test_bind_rederives_ids_across_packages():
    """A schedule written by either package binds against the other's
    parameter tree (a differently ordered one remaps the ids)."""
    jparams = {"v": jnp.zeros(20), "w": jnp.zeros(48), "x": jnp.zeros(8)}
    tparams = {k: torch.zeros(v.shape) for k, v in jparams.items()}
    from_torch = JB.WaveSchedule.from_json(_two_waves(TB).to_json())
    from_jax = TB.WaveSchedule.from_json(_two_waves(JB).to_json())
    assert TB.bind(from_jax, tparams).to_json() == \
        JB.bind(from_torch, jparams).to_json()
    bound = TB.bind(from_jax, tparams)
    names = TB.leaf_names(tparams)
    for w in bound.waves:
        assert w.leaf_ids == tuple(names.index(n) for n in w.names)
    missing = dataclasses.replace(from_jax, waves=(dataclasses.replace(
        from_jax.waves[0], names=("nope", "v")),) + from_jax.waves[1:])
    with pytest.raises(ValueError, match="not in params"):
        TB.bind(missing, tparams)


def test_cover_invariant():
    ws = _two_waves(TB)
    ws.validate_cover(3)
    with pytest.raises(ValueError, match="expected exactly"):
        ws.validate_cover(4)
    with pytest.raises(ValueError, match="expected exactly"):
        TB.WaveSchedule(waves=ws.waves + ws.waves[-1:]).validate_cover(3)


def test_plan_waves_and_the_hierarchy_raise_naming_roadmap():
    """``plan_waves`` is ported (the full parity sweep is in
    ``test_torch_adaptive.py``): on a small leaf list it gives the
    reference's artifact; a key-needing compressor in the hierarchy
    raises only under the kernel backend, as in the reference."""
    from repro.autotune import profiler as JPR
    from repro_torch.autotune import profiler as TPR
    leaves = [("c", 4000, 0.002), ("b", 20, 0.001), ("a", 900, 0.003)]
    tl = [TPR.LeafSample(n, d, 4.0 * d, t) for n, d, t in leaves]
    jl = [JPR.LeafSample(n, d, 4.0 * d, t) for n, d, t in leaves]
    from repro_torch.core import comm_model as TCM
    thw = TCM.Hardware(**dataclasses.asdict(HW))
    for pipeline in ("wave", "async1"):
        tw = TP.plan_waves(tl, None, 4, thw, pipeline=pipeline,
                           target_bytes=8000)
        jw = JW.plan_waves(jl, None, 4, HW, pipeline=pipeline,
                           target_bytes=8000)
        assert tw.to_json() == jw.to_json() and tw.n_waves == 2
    for mode in ("lags_hier", "lags_hier2"):
        ex = TR.build_exchange(TR.ExchangeSpec(
            mode=mode, params_like={"a": torch.zeros(4)}, sim=True,
            compressor="randk"))
        assert ex.compressor.needs_key
        with pytest.raises(ValueError, match="no kernel-backed"):
            TR.build_exchange(TR.ExchangeSpec(
                mode=mode, params_like={"a": torch.zeros(4)}, sim=True,
                compressor="randk", selection_backend="kernel"))


def test_package_exports_match_reference_less_overlap():
    import repro.pipeline as JP
    assert TP.__all__ == sorted(set(JP.__all__) - {
        "overlap_report", "emit_overlap_metrics"})
    for name in TP.__all__:
        assert getattr(TP, name) is not None


def test_registry_records_match_reference():
    assert TR.exchange_names() == JR.exchange_names()
    for name in TR.exchange_names():
        assert TR.get_exchange(name).ef_tiers == JR.get_exchange(
            name).ef_tiers, name
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    for ratio in (1.0, 7.0, 64.0, 1e6):
        for sim in (True, False):
            kw = dict(mode="slgs", ratio=ratio, block_size=BLOCK, sim=sim)
            tex = TR.build_exchange(TR.ExchangeSpec(params_like=like, **kw))
            jex = JR.build_exchange(JR.ExchangeSpec(params_like=like, **kw))
            assert tex.k_total == jex.k_total
            assert tex.wave_granularity == jex.wave_granularity == "model"


# ---------------------------------------------------------------------------
# regrouping: waved == monolithic (simulation surface)
# ---------------------------------------------------------------------------

def _split_waves(names):
    n = len(names)
    return (TB.Wave(leaf_ids=tuple(range(n - 1, 0, -1)),
                    names=tuple(names[n - 1:0:-1])),
            TB.Wave(leaf_ids=(0,), names=(names[0],)))


def _pair(mode, backend, p, ratio=64.0):
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    kw = dict(mode=mode, ratio=ratio, selection_backend=backend,
              block_size=BLOCK, sim=True, n_workers=p)
    return (TR.build_exchange(TR.ExchangeSpec(params_like=like, **kw)),
            JR.build_exchange(JR.ExchangeSpec(params_like=like, **kw)))


@pytest.mark.parametrize("mode,backend", [("dense", "xla"),
                                          ("lags_dp", "xla"),
                                          ("lags_dp", "kernel")])
def test_waved_exchange_bitwise_matches_monolithic(mode, backend):
    """Split waves (backprop order, then leaf 0) give the monolithic
    exchange's means and residuals bit for bit, and the reference's
    ``waved_exchange`` over the same waves."""
    tex, jex = _pair(mode, backend, 4)
    u, e0 = _np_tree(4, 3), _np_tree(4, 4, 0.1)
    state_t = () if mode == "dense" else _torch(e0)
    state_j = () if mode == "dense" else jax.tree.map(jnp.asarray, e0)
    waves = _split_waves(TB.leaf_names({k: v[0] for k, v in u.items()}))
    mono = tex.exchange(_torch(u), state_t, None)
    got = TS.waved_exchange(tex, waves, _torch(u), state_t, None)
    want = JS.waved_exchange(
        jex, tuple(JB.Wave(w.leaf_ids, w.names) for w in waves),
        jax.tree.map(jnp.asarray, u), state_j, None)
    for part in (0, 1):
        _assert_trees_bitwise(got[part], mono[part], f"{mode} vs mono")
        _assert_trees_bitwise(got[part], want[part], f"{mode} vs jax")


def test_slgs_rejects_split_waves_and_equals_itself_in_one_wave():
    tex, _ = _pair("slgs", "xla", 4, ratio=4.0)
    assert tex.wave_granularity == "model"
    u = _torch(_np_tree(4, 3))
    state = tex.init(u)
    names = TB.leaf_names({k: v[0] for k, v in u.items()})
    with pytest.raises(ValueError, match="whole-model"):
        TS.waved_exchange(tex, _split_waves(names), u, state, None)
    whole = TW.default_waves({k: v[0] for k, v in u.items()},
                             granularity="model", target_bytes=1).waves
    assert len(whole) == 1
    mono = tex.exchange(u, state, None)
    got = TS.waved_exchange(tex, whole, u, state, None)
    for part in (0, 1):
        _assert_trees_bitwise(got[part], mono[part], "slgs one wave")


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_slgs_sim_exchange_matches_reference(p, backend):
    """Two exchange steps, the residual fed back: means and residuals
    bitwise.  ``xla``: ``topk_exact`` over the whole 9,448-element
    vector; ``kernel``: ``topk_hier_ef_kernel`` (candidates -> k-th
    candidate magnitude -> gated pack), the reference's Pallas kernels in
    interpret mode."""
    tex, jex = _pair("slgs", backend, p)
    assert tex.k_total == jex.k_total == round(9448 / 64)
    assert tex.compressor_name == jex.compressor_name
    jstep = jax.jit(lambda u, e: jex.exchange(u, e, None))
    e = _np_tree(p, 1, 0.1)
    te = _torch(e)
    je = jax.tree.map(jnp.asarray, e)
    for step in range(2):
        u = _np_tree(p, 10 + step)
        tm, te = tex.exchange(_torch(u), te, None)
        jm, je = jstep(jax.tree.map(jnp.asarray, u), je)
        _assert_trees_bitwise(tm, jm, f"mean@{step}")
        _assert_trees_bitwise(te, je, f"residual@{step}")
        kept = sum(int((m != 0).sum()) for m in tm.values())
        assert 0 < kept <= p * tex.k_total * 2


def test_slgs_distributed_split_reshapes_per_leaf():
    """The per-leaf split of the whole-model vector on the distributed
    surface (no leading P axis): the residual pieces take the leaves'
    own shapes and concatenate back to the vector."""
    vec = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    parts = TL._split(vec, [(2, 3), (2, 2, 2), (2, 5)])
    assert [tuple(x.shape) for x in parts] == [(2, 3), (2, 2, 2), (2, 5)]
    assert torch.equal(torch.cat([x.reshape(2, -1) for x in parts], 1), vec)
    flat = TL._split(vec[0], [(3,), (4, 2), (1,)], [torch.float32,
                                                  torch.bfloat16,
                                                  torch.float32])
    assert flat[1].dtype == torch.bfloat16 and flat[1].shape == (4, 2)


# ---------------------------------------------------------------------------
# wave_backward: autograd hooks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OneWorker:
    """A simulation-surface exchange seen as one worker's: updates and
    the residual get (or keep) a leading P = 1 axis."""
    inner: object

    @property
    def wave_granularity(self):
        return self.inner.wave_granularity

    def launch_bucket(self, wave, updates, state, axis_names, *, key=None):
        return self.inner.launch_bucket(wave, [u[None] for u in updates],
                                        state, None)

    def exchange(self, updates, state, axis_names, *, key=None):
        return self.inner.exchange(tree.map(lambda u: u[None], updates),
                                   state, None)


def _model():
    cfg = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    module = TT.Transformer(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_fn(params):
        return TT.loss_fn(params, cfg, batch, chunk=16, loss_chunk=16)
    return module.params, loss_fn


def _no_hooks_no_grads(params):
    for p in tree.leaves(params):
        assert p.grad is None
        assert not getattr(p, "_post_accumulate_grad_hooks", None)


def test_post_accumulate_hook_fires_under_backward_not_autograd_grad():
    """Which hook fires for the port's leaves: a post-accumulate-grad
    hook fires under ``loss.backward()`` (once per leaf) and never under
    ``torch.autograd.grad``, which accumulates nothing; a tensor hook
    fires under both.  So ``wave_backward`` runs ``loss.backward()``."""
    params, loss_fn = _model()
    leaves = tree.leaves(params)
    post, pre = [], []
    handles = [p.register_post_accumulate_grad_hook(
        lambda p, i=i: post.append(i)) for i, p in enumerate(leaves)]
    handles += [p.register_hook(lambda g, i=i: pre.append(i))
                for i, p in enumerate(leaves)]
    try:
        torch.autograd.grad(loss_fn(params)[0], leaves)
        assert post == [] and sorted(pre) == list(range(len(leaves)))
        pre.clear()
        loss_fn(params)[0].backward()
        assert sorted(post) == list(range(len(leaves)))
        assert sorted(pre) == list(range(len(leaves)))
    finally:
        for h in handles:
            h.remove()
        for p in leaves:
            p.grad = None
    _no_hooks_no_grads(params)


@pytest.mark.parametrize("mode,backend", [("dense", "xla"),
                                          ("lags_dp", "xla"),
                                          ("lags_dp", "kernel"),
                                          ("slgs", "xla"),
                                          ("slgs", "kernel")])
def test_wave_backward_matches_grad_then_exchange(mode, backend):
    """One worker: the loss, the exchanged means and the new residuals of
    ``wave_backward`` are those of ``autograd.grad`` + ``exchange``, bit
    for bit, with several waves where the granularity allows."""
    params, loss_fn = _model()
    leaves, treedef = tree.flatten(params)
    inner = TR.build_exchange(TR.ExchangeSpec(
        mode=mode, params_like=params, ratio=8.0, block_size=BLOCK,
        selection_backend=backend, sim=False, n_workers=1))
    exch = OneWorker(inner)
    ks = getattr(inner, "ks", None)
    waves = TW.default_waves(params, ks, granularity=inner.wave_granularity,
                             target_bytes=2048).waves
    assert (len(waves) == 1) == (mode == "slgs")
    lr = torch.tensor(0.1)
    gen = torch.Generator().manual_seed(2)
    ef = (() if mode == "dense" else tree.map(
        lambda p: 0.01 * torch.randn((1,) + tuple(p.shape), generator=gen),
        params))

    loss, _ = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves)
    updates = tree.unflatten(treedef, [g.float().mul_(lr) for g in grads])
    want_mean, want_ef = exch.exchange(updates, ef, None)

    marks = []
    (got_loss, _), got_mean, got_ef = TS.wave_backward(
        loss_fn, exch, waves, params, ef, None, lr=lr, has_aux=True,
        marks=marks)
    assert torch.equal(got_loss.detach(), loss.detach())
    _assert_trees_bitwise(got_mean, want_mean, "mean")
    if mode != "dense":
        _assert_trees_bitwise(got_ef, want_ef, "residual")
    else:
        assert got_ef == ()
    leads = TS.launch_leads(marks)
    assert sorted(x["wave"] for x in leads) == list(range(len(waves)))
    assert all(x["host_ms"] >= 0.0 and x["device_ms"] is None
               for x in leads)
    _no_hooks_no_grads(params)


def test_wave_backward_fires_the_lm_head_wave_first():
    """Backprop reaches the ``lm_head`` leaf before any other: its wave
    launches first and furthest from the end of backward."""
    params, loss_fn = _model()
    exch = OneWorker(TL.DenseExchange())
    waves = TW.default_waves(params, None, target_bytes=1).waves
    marks = []
    TS.wave_backward(loss_fn, exch, waves, params, (), None,
                     lr=torch.tensor(0.1), has_aux=True, marks=marks)
    names = TB.leaf_names(params)
    first = waves[marks[0][0]]
    assert [names[i] for i in first.leaf_ids] == ["lm_head/w"]
    leads = TS.launch_leads(marks)
    assert leads[0]["host_ms"] == max(x["host_ms"] for x in leads)


def test_wave_backward_refuses_a_stale_grad():
    params, loss_fn = _model()
    leaf = tree.leaves(params)[3]
    leaf.grad = torch.zeros_like(leaf)
    waves = TW.default_waves(params).waves
    with pytest.raises(ValueError, match="grad"):
        TS.wave_backward(loss_fn, OneWorker(TL.DenseExchange()), waves,
                         params, (), None, lr=torch.tensor(0.1),
                         has_aux=True)
    leaf.grad = None
    _no_hooks_no_grads(params)


def test_a_failing_hook_fails_the_step_and_leaves_nothing_behind():
    class Boom:
        wave_granularity = "leaf"

        def launch_bucket(self, *a, **k):
            raise RuntimeError("exchange failed")

    params, loss_fn = _model()
    waves = TW.default_waves(params, target_bytes=1).waves
    with pytest.raises(RuntimeError, match="exchange failed"):
        TS.wave_backward(loss_fn, Boom(), waves, params, (), None,
                         lr=torch.tensor(0.1), has_aux=True)
    _no_hooks_no_grads(params)


def test_a_leaf_without_gradient_is_reported():
    params, loss_fn = _model()
    extra = {"unused": torch.zeros(3, requires_grad=True)}
    both = {"model": params, "x": extra}
    waves = TW.default_waves(both, target_bytes=1).waves
    with pytest.raises(RuntimeError, match="never launched"):
        TS.wave_backward(lambda p: loss_fn(p["model"]),
                         OneWorker(TL.DenseExchange()), waves, both, (),
                         None, lr=torch.tensor(0.1), has_aux=True)
    _no_hooks_no_grads(both)


@pytest.mark.parametrize("pipeline", ["wave", "async1"])
def test_sim_trainer_runs_the_monolithic_exchange_whatever_pipeline(
        pipeline):
    """``SimTrainer``, like the reference's, never reads ``pipeline``:
    two steps equal ``off``'s bit for bit."""
    out = {}
    for pipe in ("off", pipeline):
        params, _ = _model()
        cfg = dataclasses.replace(tcfg.smoke_config(), **SMALL)
        run = api.RunConfig(mode="lags_dp", ratio=8.0, lr=0.1,
                            selection_backend="kernel", block_size=BLOCK,
                            pipeline=pipe)
        tr = api.Session(cfg, run, device="cpu").simulator(
            lambda p, b: TT.loss_fn(p, cfg, b, chunk=16, loss_chunk=16),
            params, n_workers=2)
        toks = torch.randint(0, cfg.vocab, (2, 2, 17),
                             generator=torch.Generator().manual_seed(3))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        losses = [float(tr.step(batch)["loss"]) for _ in range(2)]
        out[pipe] = (losses, tree.leaves(params), tree.leaves(tr.state["ef"]))
    assert out["off"][0] == out[pipeline][0]
    for part in (1, 2):
        for a, b in zip(out["off"][part], out[pipeline][part]):
            assert torch.equal(a, b)
