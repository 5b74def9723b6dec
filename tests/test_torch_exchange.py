"""The port's compressors and exchanges against the JAX reference, on the
same numpy updates and residuals: the simulation surface of every ported
strategy, and ``BlockLAGSExchange`` (the distributed ``lags_dp``
exchange) on its simulation path.

Selections (values, indices) and EF residuals are bitwise.  The exchange
mean is bitwise too: on the CPU ``index_add_`` sums duplicate indices in
index order, as XLA's scatter does.  The distributed surface across
processes is ``test_torch_distributed.py``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import registry as JR  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import lags as JL  # noqa: E402
from repro_torch.api import registry as TR  # noqa: E402
from repro_torch.core import compressors as TC  # noqa: E402
from repro_torch.core import lags as TL  # noqa: E402
from repro_torch import tree  # noqa: E402

BLOCK = 1024
# leaf sizes: one block or less, a short tail block, many blocks
LEAVES = {"a": (100,), "b": (40, 130), "c": (3, 700), "d": (2, 1024)}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _assert_bitwise(port, ref, what=""):
    for i, (p, r) in enumerate(zip(port, ref)):
        assert tuple(p.shape) == tuple(np.shape(r)), (what, i)
        np.testing.assert_array_equal(_bits(p), _bits(r), err_msg=f"{what}"
                                      f" output {i}")


def _tree(p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal((p,) + s)).astype(np.float32)
            for k, s in LEAVES.items()}


# the key-needing compressors draw from a stream the reference names
# differently: test_torch_sampling.py holds them with injected draws
@pytest.mark.parametrize("name", sorted(
    n for n, c in TC.REGISTRY.items() if not c.needs_key))
@pytest.mark.parametrize("d", [100, 5200])
def test_compressor_matches_jax(name, d):
    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    kw = {} if name == "topk_exact" else {"block_size": BLOCK}
    got = TC.get_compressor(name)(torch.from_numpy(x), 12, **kw)
    want = jax.jit(lambda v: JC.get_compressor(name)(v, 12, **kw))(
        jnp.asarray(x))
    _assert_bitwise(got, want, name)
    # the sparse form scatters back identically
    np.testing.assert_array_equal(
        _bits(TC.decompress(got[0], got[1], d)),
        _bits(JC.decompress(want[0], want[1], d)))


def test_fused_select_matches_jax():
    """The fused EF selectors: (vals, idx, residual) bitwise."""
    u = np.random.default_rng(1).standard_normal(5200).astype(np.float32)
    e = 0.1 * np.random.default_rng(2).standard_normal(5200).astype(
        np.float32)
    for name in ("topk_block_ef_kernel", "topk_hier_ef_kernel"):
        got = TC.REGISTRY[name].fused_select(torch.from_numpy(u),
                                             torch.from_numpy(e), 60,
                                             block_size=BLOCK)
        want = jax.jit(lambda a, b: JC.REGISTRY[name].fused_select(
            a, b, 60, block_size=BLOCK))(jnp.asarray(u), jnp.asarray(e))
        _assert_bitwise(got, want, name)


def test_kernel_backed_resolution_matches_jax():
    assert TC.KERNEL_BACKED == JC.KERNEL_BACKED
    assert sorted(TC.REGISTRY) == sorted(JC.REGISTRY)
    for name in ("randk", "topk_sampled"):
        with pytest.raises(ValueError):
            TC.kernel_backed(name)
        assert TC.get_compressor(name).needs_key
        assert JC.get_compressor(name).needs_key


def test_ks_from_ratio_matches_jax():
    params = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    for ratio in (1.0, 8.0, 333.0, 1e6):
        want = jax.tree.leaves(JL.ks_from_ratio(params, ratio))
        assert tree.leaves(TL.ks_from_ratio(params, ratio)) == want


def _exchanges(mode, compressor, backend, p):
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    kw = dict(mode=mode, ratio=64.0, compressor=compressor,
              selection_backend=backend, block_size=BLOCK, sim=True,
              n_workers=p)
    return (TR.build_exchange(TR.ExchangeSpec(params_like=like, **kw)),
            JR.build_exchange(JR.ExchangeSpec(params_like=like, **kw)))


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("backend", ["xla", "kernel"])
@pytest.mark.parametrize("compressor", ["topk_exact", "topk_block",
                                        "topk_hier"])
def test_lags_exchange_matches_jax(p, backend, compressor):
    """Two exchange steps (the residual feeds back): per-leaf means and
    residuals bitwise at P workers."""
    tex, jex = _exchanges("lags_dp", compressor, backend, p)
    assert tex.compressor_name == jex.compressor_name
    jstep = jax.jit(lambda u, e: jex.exchange(u, e, None))
    like = {k: torch.zeros((p,) + s) for k, s in LEAVES.items()}
    te = tex.init(like)
    je = jex.init(jax.tree.map(jnp.asarray, _tree(p, 0)))
    for step in range(2):
        u = _tree(p, 10 + step)
        tm, te = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                              te, None)
        jm, je = jstep(jax.tree.map(jnp.asarray, u), je)
        for k in LEAVES:
            _assert_bitwise((tm[k], te[k]), (jm[k], je[k]), f"{k}@{step}")


@pytest.mark.parametrize("p", [1, 2, 4])
def test_dense_exchange_matches_jax(p):
    tex, jex = _exchanges("dense", "topk_exact", "xla", p)
    u = _tree(p, 5)
    tm, ts = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                          tex.init(None), None)
    jm, js = jex.exchange(jax.tree.map(jnp.asarray, u), (), None)
    assert ts == () and js == ()
    for k in LEAVES:
        _assert_bitwise((tm[k],), (jm[k],), k)


def test_exchange_bucket_uses_global_leaf_ids():
    """A wave of leaves 2..3 selects exactly as the monolithic exchange
    does for those leaves (per-leaf k follows the global id)."""
    tex, _ = _exchanges("lags_dp", "topk_exact", "kernel", 2)
    u = {k: torch.from_numpy(v) for k, v in _tree(2, 3).items()}
    e = tex.init({k: torch.zeros((2,) + s) for k, s in LEAVES.items()})
    full_m, full_e = tex.exchange(u, e, None)
    keys = sorted(LEAVES)[2:]
    m, r = tex.exchange_bucket((2, 3), [u[k] for k in keys],
                               [e[k] for k in keys], None)
    for k, mm, rr in zip(keys, m, r):
        assert torch.equal(mm, full_m[k]) and torch.equal(rr, full_e[k])


def test_ef_invariant_exact():
    """e + u == scatter(values, indices) + residual, for every worker."""
    comp = TC.get_compressor("topk_hier_ef_kernel")
    u = torch.from_numpy(_tree(3, 7)["c"])
    e = torch.from_numpy(_tree(3, 8, 0.1)["c"])
    vals, idx, res = TL.local_select_ef(u, e, 40, comp, block_size=BLOCK)
    recon = res.reshape(3, -1) + TC.decompress(vals, idx, u[0].numel())
    assert torch.equal(recon, (e + u).reshape(3, -1))


@pytest.mark.parametrize("mode", ["lags_hier", "lags_hier2"])
def test_unported_modes_raise_naming_roadmap(mode):
    """The hierarchy and its key-needing compressors are ported: randk
    builds under the xla backend in both packages, and under the kernel
    backend raises in both (no kernel variant), nothing falling back."""
    tex, jex = _exchanges(mode, "randk", "xla", 2)
    assert tex.compressor.needs_key and jex.compressor.needs_key
    for build in (TR, JR):
        with pytest.raises(ValueError, match="no kernel-backed variant"):
            build.build_exchange(build.ExchangeSpec(
                mode=mode, params_like={"a": np.zeros(8, np.float32)},
                compressor="randk", selection_backend="kernel", sim=True,
                n_workers=2))


def test_distributed_surface_raises_naming_roadmap():
    """What the distributed surface still lacks raises, naming its
    ROADMAP.md item: on a ``model`` axis, what tensor parallelism does
    not run yet (here the health quantities, under slgs, which it
    trains).  Sharded dims are a block layout the exchange now takes
    (lags_hier's FSDP dim, ``test_torch_hier.py``); unsharded hints are
    the identity."""
    import types
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.launch import train as LT
    like = {"a": np.zeros((4, 6), np.float32)}
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: 2)
    LT.check_tensor_parallel(tinyllama_1_1b.smoke_config(), mesh, "slgs")
    with pytest.raises(NotImplementedError, match="ROADMAP.*tensor"):
        LT.check_tensor_parallel(tinyllama_1_1b.smoke_config(), mesh, "slgs",
                                 health=True)
    u = {"a": torch.from_numpy(_tree(2, 9)["b"][:, :4, :6].copy())}
    outs = []
    for sdims in ({"a": (1,)}, {"a": ()}, None):
        ex = TR.build_exchange(TR.ExchangeSpec(
            mode="lags_dp", params_like=like, ratio=3.0, block_size=6,
            shard_dims=sdims, sim=False, n_workers=2))
        outs.append(ex.exchange(u, ex.init(u), None))
    # the identity layouts agree; the sharded dim laid first picks other
    # blocks
    assert torch.equal(outs[1][0]["a"], outs[2][0]["a"])
    assert not torch.equal(outs[0][0]["a"], outs[1][0]["a"])


# -- BlockLAGSExchange: the distributed lags_dp exchange -----------------

BLOCK_LEAVES = {"a": (100,), "b": (257,), "c": (50, 100)}


def _block_pair(p, use_kernel):
    ks = {"a": 3, "b": 9, "c": 40}
    return (TL.BlockLAGSExchange(ks=ks, block_size=64, use_kernel=use_kernel),
            JL.BlockLAGSExchange(ks=ks, block_size=64, use_kernel=use_kernel))


def _block_tree(p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal((p,) + s)).astype(np.float32)
            for k, s in BLOCK_LEAVES.items()}


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_block_lags_sim_matches_jax(p, use_kernel):
    """Leaves of 100 (d > bs with a short tail), 257 (a one-element tail
    block) and 5000 elements at block_size 64; two steps, the residual
    fed back: means and residuals bitwise, both backends."""
    tex, jex = _block_pair(p, use_kernel)
    jstep = jax.jit(lambda u, e: jex.exchange(u, e, None))
    e = _block_tree(p, 1, 0.1)
    for step in range(2):
        u = _block_tree(p, 10 + step)
        tm, te = tex.exchange({k: torch.from_numpy(v) for k, v in u.items()},
                              {k: torch.from_numpy(np.array(v))
                               for k, v in e.items()}, None)
        jm, je = jstep(jax.tree.map(jnp.asarray, u),
                       jax.tree.map(jnp.asarray, e))
        for k in BLOCK_LEAVES:
            _assert_bitwise((tm[k], te[k]), (jm[k], je[k]), f"{k}@{step}")
        e = jax.tree.map(np.asarray, je)


def test_block_lags_small_leaf_below_block_size_matches_jax():
    """d < block_size: one block of d elements."""
    tex = TL.BlockLAGSExchange(ks={"w": 5}, block_size=64, use_kernel=True)
    jex = JL.BlockLAGSExchange(ks={"w": 5}, block_size=64, use_kernel=True)
    u = {"w": np.random.default_rng(3).standard_normal((2, 40)).astype(
        np.float32)}
    e = {"w": np.zeros((2, 40), np.float32)}
    tm, te = tex.exchange({"w": torch.from_numpy(u["w"])},
                          {"w": torch.from_numpy(e["w"])}, None)
    jm, je = jex.exchange(jax.tree.map(jnp.asarray, u),
                          jax.tree.map(jnp.asarray, e), None)
    _assert_bitwise((tm["w"], te["w"]), (jm["w"], je["w"]))


@pytest.mark.parametrize("p", [3, 4, 8])
def test_row_scatter_mean_sums_workers_in_rank_order(p):
    """Every worker picks the same entries, with values whose f32 sum
    depends on its order (1e8, -1e8, then ones): each entry must be the
    sum in rank order, as the reference's (worker, pick) scatter, / P."""
    n_blocks, bs, k_b = 3, 8, 2
    rng = np.random.default_rng(p)
    local = np.tile(np.array([[0, 5], [2, 7], [1, 3]], np.int32), (p, 1, 1))
    vals = (rng.standard_normal((p, n_blocks, k_b)) *
            10.0 ** rng.integers(-3, 9, (p, n_blocks, k_b))).astype(
        np.float32)
    vals[:, 0, 0] = [1e8, -1e8] + [1.0] * (p - 2)
    got = TL._row_scatter_mean(torch.from_numpy(vals),
                               torch.from_numpy(local), n_blocks, bs, p)
    want = np.zeros(n_blocks * bs, np.float32)
    for w in range(p):
        for b in range(n_blocks):
            for j in range(k_b):
                i = b * bs + local[w, b, j]
                want[i] = np.float32(want[i] + vals[w, b, j])
    want = want / np.float32(p)
    assert want[0] == np.float32(p - 2) / np.float32(p)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_distributed_factory_builds_block_lags_like_jax():
    """``lags_dp`` with ``sim=False`` builds the block exchange (the
    fused kernel under the kernel backend), with the reference's ks and
    its warning for a non-block compressor."""
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    for backend in ("xla", "kernel"):
        kw = dict(mode="lags_dp", ratio=64.0, selection_backend=backend,
                  block_size=BLOCK, sim=False, n_workers=4)
        tex = TR.build_exchange(TR.ExchangeSpec(params_like=like, **kw))
        jex = JR.build_exchange(JR.ExchangeSpec(params_like=like, **kw))
        assert isinstance(tex, TL.BlockLAGSExchange)
        assert tex.use_kernel == jex.use_kernel == (backend == "kernel")
        assert tree.leaves(tex.ks) == jax.tree.leaves(jex.ks)
        assert tex.block_size == jex.block_size
    with pytest.warns(UserWarning, match="block top-k"):
        TR.build_exchange(TR.ExchangeSpec(
            mode="lags_dp", params_like=like, compressor="topk_hier"))
    assert isinstance(TR.build_exchange(TR.ExchangeSpec(
        mode="dense", params_like=like)), TL.DenseExchange)


def test_momentum_extra_state_matches_jax_layout():
    like = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    tspec = TR.ExchangeSpec(mode="lags_dp", params_like={
        k: torch.zeros(s) for k, s in LEAVES.items()}, n_workers=3,
        momentum_correction=0.9)
    jspec = JR.ExchangeSpec(mode="lags_dp", params_like=like, n_workers=3,
                            momentum_correction=0.9)
    got, want = tspec.init_extra_state(), jspec.init_extra_state()
    assert list(got) == list(want) == ["mom"]
    for g, w in zip(tree.leaves(got["mom"]), jax.tree.leaves(want["mom"])):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any()
    assert dataclasses.replace(tspec, momentum_correction=0.0
                               ).init_extra_state() == {}


class _DoneWork:
    def wait(self):
        return True


def test_dense_all_reduce_buffers_are_contiguous(monkeypatch):
    """NCCL refuses a strided buffer ("Tensors must be contiguous"; gloo
    takes one), and a gradient may come strided (the sLSTM's did on the
    card): the dense mean all-reduces a contiguous copy of each update
    (here over a one-rank group) and still equals the update."""
    import torch.distributed as dist
    seen = []

    def all_reduce(t, *args, **kw):
        seen.append(t.is_contiguous())
        return _DoneWork()

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    gen = torch.Generator().manual_seed(3)
    u = {"w": torch.randn((40, 30), generator=gen).t()}    # strided
    assert not u["w"].is_contiguous()
    mean, _ = TL.DenseExchange().exchange(
        u, (), TL.Axes(names=("data",), group=None))
    assert torch.equal(mean["w"], u["w"])
    assert seen == [True]
