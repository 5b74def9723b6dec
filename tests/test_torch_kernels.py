"""The port's selection oracles and ``ops`` wrappers against the JAX
reference (``repro.kernels.ref`` and ``repro.kernels.ops``, the Pallas
kernels in interpret mode), bit for bit, on the same numpy inputs.

On the CPU every wrapper runs its plain version; the CUDA kernels are
held to those plain versions on the card by ``test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ef_sparsify, ops, ref  # noqa: E402
from repro_torch.kernels.block_topk import block_topk  # noqa: E402

SHAPES = [(1, 128), (7, 256), (8, 512), (16, 1024), (33, 4096), (3, 130)]
DTYPES = ["float32", "bfloat16"]

# jitted oracles: one compile per shape instead of one per primitive.
# At lr=1 jit cannot change the numbers (fma(1, g, e) == g + e); the
# lr != 1 test below runs the oracle eagerly.
_jref_block_topk = jax.jit(jref.block_topk_ref, static_argnums=(1,))
_jref_pack = jax.jit(jref.ef_select_pack_ref, static_argnums=(2, 3, 4))
_jops_block_pack = jax.jit(jops.ef_block_pack, static_argnums=(2, 3),
                           static_argnames=("block_size",))
_jops_hier_pack = jax.jit(jops.ef_hier_pack, static_argnums=(2, 3),
                          static_argnames=("block_size", "r"))
_jops_hier_thr = jax.jit(jops.hier_topk_threshold, static_argnums=(1,),
                         static_argnames=("block_size", "r"))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounds
    from f32 identically in both)."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _bits(x) -> np.ndarray:
    """Bit pattern (as int32 of the f32 value) of a jax array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _assert_bitwise(port, refs):
    for p, r in zip(port, refs):
        np.testing.assert_array_equal(_bits(p), _bits(r))


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", [1, 4, 8])
def test_block_topk_ref_matches_jax(shape, dtype, r):
    r = min(r, shape[1])
    xj, xt = _pair(_normal(shape, shape[0] * shape[1] + r), dtype)
    _assert_bitwise(ref.block_topk_ref(xt, r), _jref_block_topk(xj, r))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_topk_ops_matches_pallas(shape, dtype):
    xj, xt = _pair(_normal(shape, 7 + shape[1]), dtype)
    v, i = ops.block_topk(xt, 4)
    assert v.dtype == xt.dtype and i.dtype == torch.int32
    _assert_bitwise((v, i), jops.block_topk(xj, 4))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("thr", [None, 0.5])
def test_ef_select_pack_ref_matches_jax(shape, dtype, thr):
    n, bs = shape
    k = max(1, bs // 8)
    gj, gt = _pair(_normal(shape, n * bs), dtype)
    ej, et = _pair(_normal(shape, n * bs + 1), "float32")
    _assert_bitwise(ref.ef_select_pack_ref(gt, et, 1.0, thr, k),
                    _jref_pack(gj, ej, 1.0, thr, k))


@pytest.mark.parametrize("shape", [(1, 64), (7, 256), (8, 512), (3, 130)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("thr", [None, 0.5])
def test_ef_select_pack_rows_matches_pallas(shape, dtype, thr):
    n, bs = shape
    k = 5
    gj, gt = _pair(_normal(shape, 3 * n * bs), dtype)
    ej, et = _pair(_normal(shape, 3 * n * bs + 1), "float32")
    _assert_bitwise(ops.ef_select_pack_rows(gt, et, 1.0, thr, k),
                    jops.ef_select_pack_rows(gj, ej, 1.0, thr, k))


def _ties(shape, seed, inputs):
    """Tie-heavy rows: integers in [-3, 3], or normals rounded to bf16
    (8 significant bits: many equal magnitudes in a row of 4096)."""
    rng = np.random.default_rng(seed)
    if inputs == "int":
        return rng.integers(-3, 4, shape).astype(np.float32), "float32"
    return rng.standard_normal(shape).astype(np.float32), "bfloat16"


@pytest.mark.parametrize("k", [64, 512, 4095])
@pytest.mark.parametrize("inputs", ["int", "bf16"])
def test_ef_select_pack_ref_matches_jax_on_ties(k, inputs):
    """Large k at bs 4096 with most of a row tied at the k-th magnitude:
    the lowest-index rule decides the boundary, which the radix path's
    index-order ranking must reproduce; gate off and on."""
    g, dtype = _ties((4, 4096), k, inputs)
    e = np.trunc(_ties((4, 4096), k + 1, "int")[0] / 2)
    gj, gt = _pair(g, dtype)
    ej, et = _pair(e, "float32")
    for thr in (None, 1.5):
        _assert_bitwise(ref.ef_select_pack_ref(gt, et, 1.0, thr, k),
                        _jref_pack(gj, ej, 1.0, thr, k))


@pytest.mark.parametrize("k", [64, 512, 4095])
@pytest.mark.parametrize("inputs", ["int", "bf16"])
def test_block_topk_ref_matches_jax_on_ties(k, inputs):
    x, dtype = _ties((4, 4096), 2 * k, inputs)
    xj, xt = _pair(x, dtype)
    _assert_bitwise(ref.block_topk_ref(xt, k), _jref_block_topk(xj, k))


def test_ef_select_pack_nonunit_lr_bitwise_vs_oracle():
    """The oracles round lr·g and e + lr·g separately in both packages,
    so they agree bitwise at lr != 1 too."""
    gj, gt = _pair(_normal((5, 256), 11), "float32")
    ej, et = _pair(_normal((5, 256), 12), "float32")
    _assert_bitwise(ref.ef_select_pack_ref(gt, et, 0.3, 0.25, 16),
                    jref.ef_select_pack_ref(gj, ej, 0.3, 0.25, 16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ef_block_candidates_is_ungated_pack_without_residual(dtype):
    """Stage-1 candidates == the pack oracle's (vals, idx) at thr=None."""
    gj, gt = _pair(_normal((9, 1024), 21), dtype)
    ej, et = _pair(_normal((9, 1024), 22), "float32")
    vj, ij, _ = _jref_pack(gj, ej, 1.0, None, 4)
    _assert_bitwise(ef_sparsify.ef_block_candidates(gt, et, 1.0, 4), (vj, ij))


def test_per_group_threshold_equals_per_row_calls():
    """A (P,) threshold over P·n_blocks rows == P calls with a scalar."""
    g, e = _normal((6, 256), 31), _normal((6, 256), 32)
    thr = torch.tensor([0.5, 1.5], dtype=torch.float32)
    gt, et = torch.from_numpy(g), torch.from_numpy(e)
    got = ref.ef_select_pack_ref(gt, et, 1.0, thr, 8)
    for w in range(2):
        rows = slice(3 * w, 3 * w + 3)
        want = ref.ef_select_pack_ref(gt[rows], et[rows], 1.0,
                                      float(thr[w]), 8)
        _assert_bitwise([t[rows] for t in got], want)


@pytest.mark.parametrize("case", [
    # (d, k, block_size, r): multi-block, d <= bs, short tail block
    (2000, 64, 512, 4), (100, 10, 4096, 4), (10000, 100, 1024, 8),
    (1026, 32, 1024, 8)])
def test_ef_block_and_hier_pack_match_pallas(case):
    d, k, bs, r = case
    uj, ut = _pair(_normal((d,), d), "float32")
    ej, et = _pair(_normal((d,), d + 1, 0.1), "float32")
    _assert_bitwise(ops.ef_block_pack(ut, et, 1.0, k, block_size=bs),
                    _jops_block_pack(uj, ej, 1.0, k, block_size=bs))
    got = ops.ef_hier_pack(ut, et, 1.0, k, block_size=bs, r=r)
    _assert_bitwise(got, _jops_hier_pack(uj, ej, 1.0, k, block_size=bs,
                                           r=r))
    idx = got[1].numpy()
    assert (idx >= 0).all() and (idx < d).all()


def test_stacked_workers_equal_one_call_per_worker():
    """(P, d) inputs run P·n_blocks rows in one launch; the result equals
    P separate calls (per-worker thresholds included)."""
    u, e = _normal((3, 5000), 41), _normal((3, 5000), 42, 0.1)
    ut, et = torch.from_numpy(u), torch.from_numpy(e)
    for fn in (ops.ef_block_pack, ops.ef_hier_pack):
        got = fn(ut, et, 1.0, 40, block_size=1024)
        for w in range(3):
            _assert_bitwise([t[w] for t in got],
                            fn(ut[w], et[w], 1.0, 40, block_size=1024))


@pytest.mark.parametrize("d", [1026, 20000])
def test_hier_topk_threshold_matches_pallas(d):
    xj, xt = _pair(_normal((d,), d), "float32")
    thr, (cv, ci) = ops.hier_topk_threshold(xt, 100, block_size=1024, r=8)
    thr_j, (cv_j, ci_j) = _jops_hier_thr(xj, 100, block_size=1024, r=8)
    _assert_bitwise((thr, cv, ci), (thr_j, cv_j, ci_j))
    assert int(ci.min()) >= 0 and int(ci.max()) < d


def test_tie_break_lowest_index():
    x = torch.tensor([[1.0, -1.0, 1.0, 0.5]])
    v, i = block_topk(x, 2)
    assert i.tolist() == [[0, 1]] and v.tolist() == [[1.0, -1.0]]
    vals, idx, res = ef_sparsify.ef_select_pack(x, torch.zeros_like(x), 1.0,
                                                None, 3)
    assert idx.tolist() == [[0, 1, 2]]
    assert res.tolist() == [[0.0, 0.0, 0.0, 0.5]]


def test_values_keep_sign():
    v, _ = block_topk(torch.tensor([[-5.0, 1.0, 2.0, -3.0]]), 2)
    assert v.tolist() == [[-5.0, -3.0]]


def test_gate_emits_zero_with_in_range_index():
    g = torch.tensor([[3.0, 0.1, -2.0, 0.2]])
    vals, idx, res = ef_sparsify.ef_select_pack(g, torch.zeros_like(g), 1.0,
                                                2.5, 2)
    assert idx.tolist() == [[0, 2]]
    assert vals.tolist() == [[3.0, 0.0]]
    assert torch.equal(res, torch.tensor([[0.0, 0.1, -2.0, 0.2]]))


@pytest.mark.parametrize("d", [100, 1024, 5000, 70000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ef_accum_sparsify_matches_pallas(d, dtype):
    """Every ``TestEfSparsify`` case: the port's entry point (its plain
    version here) against the Pallas kernel in interpret mode, bitwise
    at lr = 1 and within that test's rtol = atol = 1e-6 elsewhere (XLA
    may contract ``e + lr·g`` into one fma)."""
    gj, gt = _pair(_normal((d,), 3 * d), dtype)
    ej, et = _pair(_normal((d,), 3 * d + 1), "float32")
    for lr, thr in [(0.1, 0.5), (1.0, 0.0), (0.01, 2.0)]:
        got = ops.ef_accum_sparsify(gt, et, lr, thr)
        want = jops.ef_accum_sparsify(gj, ej, lr, thr)
        assert all(t.dtype == torch.float32 and t.shape == (d,)
                   for t in got)
        if lr == 1.0:
            _assert_bitwise(got, want)
        for p, w in zip(got, want):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ef_accum_sparsify_ref_matches_jax_ref(dtype):
    """The plain versions of both packages round ``lr·g`` and the sum
    separately, so they agree bitwise at lr != 1 too."""
    gj, gt = _pair(_normal((3000,), 51), dtype)
    ej, et = _pair(_normal((3000,), 52), "float32")
    _assert_bitwise(ref.ef_accum_sparsify_ref(gt, et, 0.3, 0.7),
                    jref.ef_accum_sparsify_ref(gj, ej, 0.3, 0.7))


def test_ef_accum_sparsify_split_is_exact():
    """selected + residual == acc: Algorithm 1's exact EF split."""
    g, e = _normal((3000,), 61), _normal((3000,), 62)
    gt, et = torch.from_numpy(g), torch.from_numpy(e)
    sel, res = ops.ef_accum_sparsify(gt, et, 0.3, 0.7)
    assert torch.equal(sel + res, et + 0.3 * gt)
    np.testing.assert_allclose((sel + res).numpy(), e + 0.3 * g,
                               rtol=1e-6, atol=1e-6)


def test_ef_accum_sparsify_threshold_semantics():
    """With e = 0 and lr = 1 an entry is selected iff |g| >= thr; ties at
    the threshold are kept; a kept entry's residual is 0."""
    g = _normal((500,), 71)
    g[:3] = [1.5, -1.5, 1.4999999]
    sel, res = ops.ef_accum_sparsify(torch.from_numpy(g),
                                     torch.zeros(500), 1.0, 1.5)
    sel, res = sel.numpy(), res.numpy()
    assert ((np.abs(g) >= 1.5) == (sel != 0)).all()
    assert sel[:3].tolist() == [1.5, -1.5, 0.0]
    assert (res[sel != 0] == 0).all()
    np.testing.assert_array_equal(res[sel == 0], g[sel == 0])


def test_non_cpu_non_cuda_tensor_raises():
    """A wrapper runs the plain version only for a CPU tensor; any other
    device must launch the kernel or raise (no fallback)."""
    x = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        block_topk(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ef_sparsify.ef_select_pack(x, x, 1.0, None, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ef_sparsify.ef_block_candidates(x, x, 1.0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ef_accum_sparsify(x[0], x[0], 1.0, 0.5)
