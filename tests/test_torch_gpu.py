"""The CUDA selection kernels and the port's training path on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  The
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, kernels, tree  # noqa: E402
from repro_torch.configs import tinyllama_1_1b  # noqa: E402
from repro_torch.kernels import ef_sparsify, ref  # noqa: E402
from repro_torch.kernels.block_topk import block_topk  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(False)


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g = g.float() if g.dtype == torch.bfloat16 else g
        w = w.float() if w.dtype == torch.bfloat16 else w
        assert torch.equal(g.contiguous().view(torch.int32).cpu(),
                           w.contiguous().view(torch.int32).cpu())


@pytest.mark.parametrize("bs", [4096, 130, 1023])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_bitwise(cuda, bs, dtype):
    gen = torch.Generator(device=cuda).manual_seed(bs)
    g = torch.randn((37, bs), generator=gen, device=cuda).to(dtype)
    e = torch.randn((37, bs), generator=gen, device=cuda)
    for k in (1, 4, 5, bs):
        _bitwise(block_topk(g, k), ref.block_topk_ref(g, k))
        for thr in (None, 0.5):
            _bitwise(ef_sparsify.ef_select_pack(g, e, 1.0, thr, k),
                     ref.ef_select_pack_ref(g, e, 1.0, thr, k))
        _bitwise(ef_sparsify.ef_block_candidates(g, e, 0.3, k),
                 ref.ef_block_candidates_ref(g, e, 0.3, k))


@pytest.mark.parametrize("d", [100, 5000, 2**20 + 3, 2**22 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ef_accum_sparsify_matches_plain_bitwise(cuda, d, dtype):
    """Aligned (16-byte vectors and a d % 4 tail) and misaligned (element
    by element) views, at lr 1 and lr != 1; 2^22 + 5 elements take each
    thread of the one-wave grid round its grid-stride loop several
    times."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    g = torch.randn((d + 1,), generator=gen, device=cuda).to(dtype)
    e = torch.randn((d + 1,), generator=gen, device=cuda)
    for gv, ev in ((g[:d], e[:d]), (g[1:], e[1:])):
        for lr, thr in ((1.0, 0.0), (0.3, 0.7), (0.01, 2.0)):
            _bitwise(ef_sparsify.ef_accum_sparsify(gv, ev, lr, thr),
                     ref.ef_accum_sparsify_ref(gv, ev, lr, thr))
    with pytest.raises(ValueError, match="dtype"):
        ef_sparsify.ef_accum_sparsify(g, e.double(), 1.0, 0.5)


def test_block_lags_mean_has_the_same_bits_on_every_call(cuda):
    """Without deterministic algorithms: 4 workers' picks collide on the
    card (one leaf of mostly equal magnitudes), yet the exchanged mean
    is the CPU's bit for bit on every call, because the scatter runs
    worker by worker and never sums duplicates with atomics; so every
    distributed rank computes the same mean."""
    from repro_torch.core import lags as TL
    torch.use_deterministic_algorithms(False)
    gen = torch.Generator().manual_seed(7)
    u = {"w": torch.randn((4, 64, 4096), generator=gen).sign()
         + 1e-3 * torch.randn((4, 64, 4096), generator=gen)}
    e = {"w": torch.zeros((4, 64, 4096))}
    ex = TL.BlockLAGSExchange(ks={"w": 64 * 4096 // 8}, block_size=4096,
                              use_kernel=True)
    want, want_e = ex.exchange(u, e, None)
    for _ in range(5):
        got, got_e = ex.exchange({"w": u["w"].to(cuda)},
                                 {"w": e["w"].to(cuda)}, None)
        _bitwise((got["w"], got_e["w"]), (want["w"], want_e["w"]))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn((4, 256), device=cuda)
    with pytest.raises(ValueError, match="outside"):
        block_topk(x, 257)
    with pytest.raises(TypeError):
        block_topk(x.half(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        block_topk(torch.randn((256, 4), device=cuda).t(), 4)
    big = torch.zeros((1, 40_000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ef_sparsify.ef_select_pack(big, big, 1.0, None, 4)
    with pytest.raises(ValueError, match="shape"):
        ef_sparsify.ef_select_pack(x, x[:2], 1.0, None, 4)


def test_launch_counts_move_only_on_a_launch(cuda):
    kernels.reset_launch_counts()
    x = torch.randn((3, 512), device=cuda)
    block_topk(x, 2)
    block_topk(x.cpu(), 2)                       # plain version: no launch
    ef_sparsify.ef_select_pack(x, x, 1.0, None, 2)
    assert kernels.launch_counts() == {"block_topk": 1, "ef_select_pack": 1,
                                       "ef_block_candidates": 0,
                                       "ef_accum_sparsify": 0}


@pytest.mark.parametrize("compressor", ["topk_exact", "topk_block",
                                        "topk_hier"])
def test_training_on_the_card_tracks_the_cpu(cuda, compressor):
    """Two steps of the kernel-backed SimTrainer on the card and on the
    CPU (plain versions), f32 smoke model: losses and parameters agree to
    1e-4 (matmul and reduction order differ between the devices)."""
    torch.use_deterministic_algorithms(False)
    cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), n_layers=1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 2, 32),
                                     generator=torch.Generator().manual_seed(0))}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=-1)
    out = {}
    for dev in ("cpu", "cuda"):
        model = TT.Transformer(cfg, seed=0, device="cpu")
        model.to(dev)                  # moves the Parameters in place
        params = model.params
        run = api.RunConfig(mode="lags_dp", ratio=16.0, lr=0.1,
                            compressor=compressor, selection_backend="kernel",
                            block_size=1024)
        tr = api.Session(cfg, run, device=dev).simulator(
            lambda p, b: TT.loss_fn(p, cfg, b, chunk=16, loss_chunk=16),
            params, n_workers=2)
        losses = [float(tr.step({k: v.to(dev) for k, v in batch.items()})
                        ["loss"]) for _ in range(2)]
        out[dev] = (losses, [p.detach().cpu() for p in tree.leaves(params)])
    assert out["cpu"][0] == pytest.approx(out["cuda"][0], rel=1e-4)
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_slgs_on_the_card_equals_its_plain_version(cuda):
    """The kernel-backed SLGS exchange (``topk_hier_ef_kernel`` over the
    whole-model vector: candidates kernel, k-th candidate magnitude,
    gated pack kernel) on the card == on the CPU (plain versions), bit
    for bit, two steps with the residual fed back, P = 2 workers, d =
    2^22 + 5 (a 5-element tail block), ratio 1000."""
    from repro_torch.api import registry as R
    like = {"a": torch.zeros(2**21), "b": torch.zeros(2**10, 2**10 + 1),
            "c": torch.zeros(2**20 - 2**10 + 5)}
    assert sum(x.numel() for x in like.values()) == 2**22 + 5
    ex = R.build_exchange(R.ExchangeSpec(
        mode="slgs", params_like=like, ratio=1000.0,
        selection_backend="kernel", sim=True, n_workers=2))
    assert ex.compressor_name == "topk_hier_ef_kernel"
    gen = torch.Generator().manual_seed(11)
    e_cpu = ex.init({k: torch.zeros((2,) + tuple(v.shape))
                     for k, v in like.items()})
    e_gpu = {k: v.to(cuda) for k, v in e_cpu.items()}
    kernels.reset_launch_counts()
    for _ in range(2):
        u = {k: 1e-2 * torch.randn((2,) + tuple(v.shape), generator=gen)
             for k, v in like.items()}
        m_cpu, e_cpu = ex.exchange(u, e_cpu, None)
        m_gpu, e_gpu = ex.exchange({k: v.to(cuda) for k, v in u.items()},
                                   e_gpu, None)
        for k in like:
            _bitwise((m_gpu[k], e_gpu[k]), (m_cpu[k], e_cpu[k]))
    counts = kernels.launch_counts()
    assert counts["ef_block_candidates"] == 2
    assert counts["ef_select_pack"] == 2


def test_hier2_on_the_card_equals_its_plain_version(cuda):
    """The kernel-backed ``lags_hier2`` simulation exchange (2 pods x 2;
    inner ``topk_block``: the pack kernel; outer ``topk_exact``:
    candidates kernel, k-th candidate magnitude, gated pack kernel) on
    the card == on the CPU (plain versions), bit for bit: mean and both
    residuals, two steps with the residuals fed back, leaves with a
    short tail block."""
    from repro_torch.api import registry as R
    like = {"a": torch.zeros(3, 5000), "b": torch.zeros(2**16 + 7),
            "c": torch.zeros(2000)}
    ex = R.build_exchange(R.ExchangeSpec(
        mode="lags_hier2", params_like=like, ratio=100.0, ratio_inner=10.0,
        compressor="topk_exact", inner_compressor="topk_block",
        selection_backend="kernel", sim=True, n_workers=4, n_inner=2))
    assert ex.compressor_name == "topk_hier_ef_kernel"
    assert ex.inner_compressor_name == "topk_block_ef_kernel"
    gen = torch.Generator().manual_seed(12)
    e_cpu = ex.init({k: torch.zeros((4,) + tuple(v.shape))
                     for k, v in like.items()})
    e_gpu = tree.map(lambda v: v.to(cuda), e_cpu)
    kernels.reset_launch_counts()
    for _ in range(2):
        u = {k: 1e-2 * torch.randn((4,) + tuple(v.shape), generator=gen)
             for k, v in like.items()}
        m_cpu, e_cpu = ex.exchange(u, e_cpu, None)
        m_gpu, e_gpu = ex.exchange({k: v.to(cuda) for k, v in u.items()},
                                   e_gpu, None)
        _bitwise(tree.leaves(m_gpu) + tree.leaves(e_gpu),
                 tree.leaves(m_cpu) + tree.leaves(e_cpu))
    counts = kernels.launch_counts()
    # per step: 3 inner packs; "a" and "b" candidates + gated pack, "c"
    # (d <= block_size) one exact pack
    assert counts["ef_select_pack"] == 2 * 6
    assert counts["ef_block_candidates"] == 2 * 2


def _nccl_world_of_one():
    import socket
    from repro_torch.launch import mesh as M
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    M.init_process_group(f"tcp://localhost:{port}", 1, 0, device="cuda")
    return M.make_mesh(device="cuda")


@pytest.mark.parametrize("mode", ["dense", "lags_dp", "slgs", "lags_hier2",
                                  "lags_hier"])
def test_wave_step_equals_off_step_bitwise(cuda, mode):
    """Two distributed steps at world size 1 (NCCL) under deterministic
    algorithms: ``pipeline="wave"`` (exchanges launched by autograd hooks
    inside backprop, several waves where the granularity allows) leaves
    the parameters and residuals of ``"off"``, bit for bit."""
    import os
    import torch.distributed as dist
    # deterministic cuBLAS; torch reads it on every determinism check
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), n_layers=2)
    toks = torch.randint(0, cfg.vocab, (1, 33),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    mesh = _nccl_world_of_one()
    out = {}
    try:
        for pipeline in ("off", "wave"):
            run = api.RunConfig(mode=mode, ratio=16.0, lr=0.1,
                                selection_backend="kernel", block_size=1024,
                                pipeline=pipeline, wave_target_bytes=2048,
                                chunk=16, loss_chunk=16, ratio_inner=4.0)
            sess = api.Session(cfg, run, mesh=mesh)
            state, _ = sess.init_state(
                params=TT.Transformer(cfg, seed=0, device=cuda).params)
            losses = []
            for _ in range(2):
                state, metrics = sess.step_fn(state, batch)
                losses.append(float(metrics["loss"]))
            if pipeline == "wave":
                n = sess.meta["waves"].n_waves
                assert (n == 1) if mode == "slgs" else (n > 1)
            out[pipeline] = (losses, tree.leaves(state["params"]),
                             tree.leaves(state["ef"]))
    finally:
        dist.destroy_process_group()
    assert out["off"][0] == out["wave"][0]
    for part in (1, 2):
        _bitwise(out["wave"][part], out["off"][part])
