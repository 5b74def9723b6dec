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
from repro_torch.kernels.block_topk import (RADIX_MIN_K,  # noqa: E402
                                            block_topk)
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


@pytest.mark.parametrize("bs", [4096, 130, 1023, 10, 16, 27, 432])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inputs", ["normal", "ties"])
def test_kernels_match_plain_bitwise(cuda, bs, dtype, inputs):
    """Every k of the sweep up to bs (every k from 1 to bs on rows of
    at most 32, narrower than a warp or one warp wide: the paper CNN's
    small leaves, one row each), on the path the crossover picks and
    on each path forced (``radix_min_k`` 1: radix select; bs + 1: k
    arg-max passes), gate off and on, lr 1 and 0.3; "ties": integers in
    [-3, 3], so most of a row ties with the k-th magnitude and the
    lowest-index rule decides the picks."""
    gen = torch.Generator(device=cuda).manual_seed(bs)
    if inputs == "ties":
        g = torch.randint(-3, 4, (37, bs), generator=gen, device=cuda)
        e = torch.randint(-3, 4, (37, bs), generator=gen, device=cuda)
        g, e = g.to(dtype), e.float()
    else:
        g = torch.randn((37, bs), generator=gen, device=cuda).to(dtype)
        e = torch.randn((37, bs), generator=gen, device=cuda)
    ks = [k for k in (1, 4, 5, 16, 64, 256, 512, 1024) if k < bs]
    ks = range(1, bs + 1) if bs <= 32 else ks + [bs - 1, bs]
    for k in ks:
        for radix_min_k in (RADIX_MIN_K, 1, bs + 1):
            path = dict(radix_min_k=radix_min_k)
            _bitwise(block_topk(g, k, **path), ref.block_topk_ref(g, k))
            for lr in (1.0, 0.3):
                for thr in (None, 1.5):
                    _bitwise(
                        ef_sparsify.ef_select_pack(g, e, lr, thr, k, **path),
                        ref.ef_select_pack_ref(g, e, lr, thr, k))
                _bitwise(ef_sparsify.ef_block_candidates(g, e, lr, k, **path),
                         ref.ef_block_candidates_ref(g, e, lr, k))


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
    # a row of 30,000: 240 KB (acc and |acc|) on the arg-max path; 120 KB
    # and the keys of pow2(k) on the radix path
    wide = torch.zeros((1, 30_000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ef_sparsify.ef_select_pack(wide, wide, 1.0, None, 4)
    ef_sparsify.ef_select_pack(wide, wide, 1.0, None, 4, radix_min_k=1)
    ef_sparsify.ef_select_pack(wide, wide, 1.0, None, 8192)
    with pytest.raises(ValueError, match="shared memory"):
        ef_sparsify.ef_select_pack(wide, wide, 1.0, None, 16384)
    with pytest.raises(ValueError, match="radix_min_k"):
        block_topk(x, 4, radix_min_k=0)
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


def test_keep_all_budget_at_full_width_runs_on_the_card(cuda):
    """A leaf planned dense (ratio 1, k = d) at TinyLlama-1.1B's width:
    one layer's FFN weight, 2048 x 5632 = 11,534,336 entries, a single
    row far past the pack kernel's shared memory.  It used to raise on
    the card; now the kernel path keeps every entry without a selection
    (``ops.keep_all_rows``, no launch), as ``lags_dp`` (simulation),
    ``slgs`` and ``BlockLAGSExchange`` at k_b = bs run it, and its mean
    and residual equal the CPU plain path's (the sort-based selection of
    the xla backend) bit for bit."""
    from repro_torch.api import registry as R
    from repro_torch.core import lags as L
    like = {"w": torch.zeros(2048, 5632), "n": torch.zeros(2048)}
    gen = torch.Generator().manual_seed(13)
    u = {k: 1e-2 * torch.randn((2,) + tuple(v.shape), generator=gen)
         for k, v in like.items()}
    e0 = {k: 1e-3 * torch.randn((2,) + tuple(v.shape), generator=gen)
          for k, v in like.items()}
    for mode in ("lags_dp", "slgs"):
        on = {}
        for backend, dev in (("kernel", cuda), ("xla", torch.device("cpu"))):
            ex = R.build_exchange(R.ExchangeSpec(
                mode=mode, params_like=like, ratio=1.0,
                selection_backend=backend, sim=True, n_workers=2))
            kernels.reset_launch_counts()
            on[backend] = ex.exchange(
                {k: v.to(dev) for k, v in u.items()},
                {k: v.to(dev) for k, v in e0.items()}, None)
            if backend == "kernel":
                assert kernels.launch_counts()["ef_select_pack"] == 0
        _bitwise(tree.leaves(on["kernel"]), tree.leaves(on["xla"]))
        assert not any(e.any() for e in tree.leaves(on["kernel"][1]))
    ks = L.ks_from_ratio(like, 1.0)
    out = {}
    for use_kernel, dev in ((True, cuda), (False, torch.device("cpu"))):
        ex = L.BlockLAGSExchange(ks=ks, use_kernel=use_kernel)
        out[use_kernel] = ex.exchange({k: v.to(dev) for k, v in u.items()},
                                      {k: v.to(dev) for k, v in e0.items()},
                                      None)
    _bitwise(tree.leaves(out[True]), tree.leaves(out[False]))


def _mixed_schedule(cfg, p):
    """A plan of ``cfg`` at P = ``p`` on the paper's 1 Gbps wire from an
    apportioned 10 ms backward: ratios 1 to 1000."""
    from repro_torch.autotune import planner, profiler
    from repro_torch.core import comm_model as cm
    leaves = profiler.apportion_backward(profiler.backprop_leaves(cfg, 32.0),
                                         0.01)
    sched = planner.plan_schedule(leaves, p, cm.ETH_1GBPS, arch="smoke")
    ratios = {lp.ratio for lp in sched.leaves}
    assert 1.0 in ratios and len(ratios) > 2
    return sched


def test_scheduled_step_on_each_surface(cuda):
    """One step under a mixed schedule (planned-dense leaves among them)
    on each surface: the kernel-backed SimTrainer (P = 2) on the card
    tracks the CPU, and the distributed step (NCCL, world size 1) takes
    the plan's k's, launches the pack kernel for the sparse leaves and
    keeps every entry of the dense ones."""
    import torch.distributed as dist
    torch.use_deterministic_algorithms(False)
    cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), n_layers=2)
    sched = _mixed_schedule(cfg, 2)
    toks = torch.randint(0, cfg.vocab, (2, 1, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    out = {}
    for dev in ("cpu", "cuda"):
        model = TT.Transformer(cfg, seed=0, device="cpu")
        model.to(dev)
        run = api.RunConfig(mode="lags_dp", lr=0.1, schedule=sched,
                            selection_backend="kernel")
        tr = api.Session(cfg, run, device=dev).simulator(
            lambda p, b: TT.loss_fn(p, cfg, b, chunk=16, loss_chunk=16),
            model.params, n_workers=2)
        assert tree.leaves(tr.exchange.ks) == [
            sched.by_name[n].k for n in tree.leaf_paths(model.params)]
        loss = float(tr.step({k: v.to(dev) for k, v in batch.items()})
                     ["loss"])
        out[dev] = (loss, [p.detach().cpu() for p in tree.leaves(
            model.params)])
    assert out["cpu"][0] == pytest.approx(out["cuda"][0], rel=1e-4)
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    mesh = _nccl_world_of_one()
    try:
        sess = api.Session(cfg, api.RunConfig(
            mode="lags_dp", lr=0.1, schedule=sched,
            selection_backend="kernel", chunk=16, loss_chunk=16), mesh=mesh)
        with pytest.warns(UserWarning, match="planned for 2 workers"):
            step_fn = sess.step_fn
        assert tree.leaves(sess.meta["ks"]) == [
            sched.by_name[n].k for n in tree.leaf_paths(
                sess.state_specs["params"])]
        state, _ = sess.init_state(
            params=TT.Transformer(cfg, seed=0, device=cuda).params)
        kernels.reset_launch_counts()
        state, metrics = step_fn(state, {k: v[0].to(cuda)
                                         for k, v in batch.items()})
        assert torch.isfinite(metrics["loss"])
        # one pack per leaf whose per-block budget is below its block
        n_sparse = sum(1 for lp in sched.leaves if -(-lp.k * min(
            4096, lp.d) // lp.d) < min(4096, lp.d))
        assert kernels.launch_counts()["ef_select_pack"] == n_sparse
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("compressor", ["topk_block_kernel",
                                        "topk_hier_ef_kernel"])
def test_stream_codec_on_the_card_is_bitwise_the_plain_codec(cuda,
                                                             compressor):
    """The weight stream's kernel-backed encode on the card against the
    same encode on the CPU (the kernels' plain versions): bf16 leaves
    whose first delta is a difference of bf16 values, so |acc| ties at
    the selection boundary, payload and residual bit for bit; the packet
    applied on the card equals the one applied on the CPU."""
    from repro_torch.stream import DeltaCodec, DeltaPacket
    gen = torch.Generator().manual_seed(2)
    shapes = {"w": (3, 4096), "b": (5000,), "n": (700,)}
    pub = {k: torch.randn(s, generator=gen).to(torch.bfloat16)
           for k, s in shapes.items()}
    now = {k: (v.float() + 0.02 * torch.randn(v.shape, generator=gen))
           .to(torch.bfloat16) for k, v in pub.items()}
    ks = {"w": 384, "b": 160, "n": 20}
    outs = {}
    for dev in ("cpu", cuda):
        on = {k: v.to(dev) for k, v in pub.items()}
        codec = DeltaCodec(on, compressor=compressor)
        payload, res, nbytes, _ = codec.encode(
            on, {k: v.to(dev) for k, v in now.items()},
            codec.zero_residual(), ks)
        pkt = DeltaPacket(2, 0, codec.fingerprint, "delta", payload, nbytes)
        outs[str(dev)] = (payload, res, codec.apply(on, pkt, donate=False))
    (cp, cr, ca), (gp, gr, ga) = outs["cpu"], outs[str(cuda)]
    for k in shapes:
        _bitwise((gp[k]["values"], gp[k]["idx"], gr[k], ga[k]),
                 (cp[k]["values"], cp[k]["idx"], cr[k], ca[k]))


def test_publisher_device_memory_stays_flat_over_many_packets(cuda):
    """The publisher keeps its packets on the host: after the baseline
    and a first delta, twelve more publishes leave the card's allocated
    memory within one delta payload of where it was (a device packet
    kept per publish would add twelve)."""
    from repro_torch.stream import StreamPublisher
    gen = torch.Generator(device=cuda).manual_seed(3)
    live = {"w": torch.randn((512, 4096), generator=gen, device=cuda),
            "b": torch.randn((70_000,), generator=gen, device=cuda)}
    pub = StreamPublisher(live, every=1, compressor="topk_block_kernel")
    for step in range(2):
        live = {k: v + 1e-3 * torch.randn(v.shape, generator=gen,
                                          device=cuda)
                for k, v in live.items()}
        pub.publish(step, live)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for step in range(2, 14):
        live = {k: v + 1e-3 * torch.randn(v.shape, generator=gen,
                                          device=cuda)
                for k, v in live.items()}
        pkt = pub.publish(step, live)
        assert pkt.kind == "delta"
    delta_bytes = sum(v.numel() * v.element_size()
                      for entry in pkt.payload.values()
                      for v in entry.values())
    del pkt
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - base < delta_bytes
    assert len(pub.packets) == 14
    assert all(v.device.type == "cpu" for p in pub.packets
               for entry in p.payload.values() for v in entry.values())


def test_serving_engine_on_the_card_matches_the_cpu(cuda):
    """Prefill, the handoff and two decode steps of TinyLlama's smoke
    config (f32) on the card against the CPU, within 1e-4 of max |logit|
    (the same ops, summed in another order)."""
    from repro_torch.serving import engine
    cfg = tinyllama_1_1b.smoke_config()
    params = TT.init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    outs = {}
    for dev in ("cpu", cuda):
        p = tree.map(lambda x: x.to(dev), params)
        logits, st = engine.prefill(p, cfg, toks[:, :10].to(dev), chunk=8)
        st = engine.pad_states_for_decode(cfg, st, 10, 12)
        seq = [logits]
        for i in range(2):
            logits, st = engine.serve_step(p, cfg, toks[:, 10 + i:11 + i]
                                           .to(dev), st, 10 + i, chunk=8)
            seq.append(logits)
        outs[str(dev)] = [x.cpu() for x in seq]
    for g, c in zip(outs[str(cuda)], outs["cpu"]):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


def test_encoder_decoder_step_on_the_card_tracks_the_cpu(cuda):
    """One kernel-backed ``lags_dp`` SimTrainer step of SeamlessM4T's
    smoke config (f32: an encoder on 8 frames, cross-attention in every
    decoder layer) on the card and on the CPU (plain versions): the loss
    and every parameter agree to 1e-4, the encoder's included."""
    from repro_torch.configs import seamless_m4t_large_v2
    torch.use_deterministic_algorithms(False)
    cfg = seamless_m4t_large_v2.smoke_config()
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 1, 33), generator=gen)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "frontend_embeds": torch.randn((2, 1, 8, cfg.d_model),
                                            generator=gen)}
    out = {}
    for dev in ("cpu", "cuda"):
        model = TT.Transformer(cfg, seed=0, device="cpu")
        model.to(dev)
        run = api.RunConfig(mode="lags_dp", ratio=16.0, lr=0.1,
                            selection_backend="kernel", block_size=1024)
        tr = api.Session(cfg, run, device=dev).simulator(
            lambda p, b: TT.loss_fn(p, cfg, b, chunk=16, loss_chunk=16),
            model.params, n_workers=2)
        loss = float(tr.step({k: v.to(dev) for k, v in batch.items()})
                     ["loss"])
        out[dev] = (loss, tree.leaf_paths(model.params),
                    [p.detach().cpu() for p in tree.leaves(model.params)])
    assert out["cpu"][0] == pytest.approx(out["cuda"][0], rel=1e-4)
    assert any(p.startswith("encoder/") for p in out["cuda"][1])
    for path, a, b in zip(out["cpu"][1], out["cpu"][2], out["cuda"][2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=path)


def test_vlm_prefill_and_decode_on_the_card_match_the_cpu(cuda):
    """LLaVA-NeXT's smoke config (f32): prefill of 8 patches and 10
    tokens, the handoff at prompt length 18, two decode steps at
    positions 18 and 19, on the card against the CPU, within 1e-4 of max
    |logit|."""
    from repro_torch.configs import llava_next_mistral_7b
    from repro_torch.serving import engine
    cfg = llava_next_mistral_7b.smoke_config()
    params = TT.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen,
                         dtype=torch.int32)
    patches = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                          generator=gen)
    n_f = cfg.n_frontend_tokens
    outs = {}
    for dev in ("cpu", cuda):
        p = tree.map(lambda x: x.to(dev), params)
        logits, st = engine.prefill(p, cfg, toks[:, :10].to(dev),
                                    frontend_embeds=patches.to(dev), chunk=8)
        st = engine.pad_states_for_decode(cfg, st, n_f + 10, n_f + 12)
        seq = [logits]
        for i in range(2):
            logits, st = engine.serve_step(p, cfg, toks[:, 10 + i:11 + i]
                                           .to(dev), st, n_f + 10 + i,
                                           chunk=8)
            seq.append(logits)
        outs[str(dev)] = [x.cpu() for x in seq]
    for g, c in zip(outs[str(cuda)], outs["cpu"]):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


@pytest.mark.parametrize("arch,seq", [("tinyllama_1_1b", 1024),
                                      ("xlstm_1_3b", 128)])
def test_remat_lowers_peak_memory_and_keeps_the_bits(cuda, arch, seq):
    """4 layers at the published width (bf16): the loss and every
    gradient with ``remat`` equal those without it bit for bit, and the
    step's peak device memory above its start is lower with it."""
    import os
    from repro_torch.configs import base
    from repro_torch.data import synthetic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = dataclasses.replace(base.get_config(arch), n_layers=4)
    params = TT.Transformer(cfg, device=cuda).params
    leaves = tree.leaves(params)
    batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=3).batch(
        0, 1, seq, device=cuda)
    peaks, bits = {}, {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        loss, _ = TT.loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - start
        bits[remat] = [x.detach().cpu() for x in (loss,) + grads]
        del loss, grads
    _bitwise(bits[True], bits[False])
    print(f"{arch} 4 layers, {seq} tokens: peak above start "
          f"{peaks[False] / 2**20:.1f} MiB without remat, "
          f"{peaks[True] / 2**20:.1f} MiB with it")
    assert peaks[True] < peaks[False]


def test_moe_layer_repeats_bitwise_and_expert_stacks_pack_as_plain(cuda):
    """The MoE layer (Granite's widths cut to d 256, F 128; 40 experts,
    top 8; 512 bf16 tokens at capacity factor 1.25, so pairs drop):
    forward and backward give the same bits on two runs, with
    deterministic algorithms off (its gathers never collide) and on.
    Then ``ef_select_pack`` at ratio 1000's k_b 5 on a Granite
    expert-stack-shaped leaf ((1, 40, 1536, 128): 1920 rows of 4096, bf16
    updates, f32 residual) equals its plain version bit for bit."""
    import os
    from repro_torch.models import moe
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    gen = torch.Generator(device=cuda).manual_seed(20)
    d, f, e = 256, 128, 40
    p = {"router": torch.randn((d, e), generator=gen, device=cuda) / 16,
         "w_up": torch.randn((e, d, f), generator=gen, device=cuda) / 16,
         "w_gate": torch.randn((e, d, f), generator=gen, device=cuda) / 16,
         "w_down": torch.randn((e, f, d), generator=gen, device=cuda) / 11}
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = torch.randn((2, 256, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        runs = []
        for _ in range(2):
            leaves = [v.clone().requires_grad_() for v in p.values()]
            xx = x.clone().requires_grad_()
            out, aux = moe.moe_forward_auto(dict(zip(p, leaves)), xx,
                                            top_k=8)
            loss = (out.float() ** 2).mean() + aux
            runs.append([out, aux] + list(torch.autograd.grad(
                loss, [xx] + leaves)))
        _bitwise(runs[0], runs[1])
        assert float(runs[0][0].float().abs().sum(-1).eq(0).float()
                     .mean()) < 0.5
    u = torch.randn((1920, 4096), generator=gen, device=cuda).to(
        torch.bfloat16)
    resid = torch.randn((1920, 4096), generator=gen, device=cuda) * 1e-2
    _bitwise(ef_sparsify.ef_select_pack(u, resid, 0.01, None, 5),
             ref.ef_select_pack_ref(u, resid, 0.01, None, 5))


def test_mamba_layer_on_the_card_tracks_the_cpu(cuda, monkeypatch):
    """One Mamba block of Jamba's smoke config (f32, d 128: d_inner 256)
    on 2 × 24 tokens: the output, the prefill state and every gradient
    (the written-out scan backward, in two channel blocks), then four
    decode steps from that state, on the card against the CPU, each
    within 1e-4 of its largest entry (the same ops, summed in another
    order)."""
    from repro_torch.configs import jamba_v0_1_52b
    from repro_torch.models import ssm
    cfg = jamba_v0_1_52b.smoke_config()
    layer = TT.init_params(cfg, seed=3, device="cpu")["decoder"]["blocks"][0]
    p0 = {k: v[0] for k, v in layer["mamba"].items()}
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn((2, 28, cfg.d_model), generator=gen)
    monkeypatch.setattr(ssm, "SCAN_BLOCK", 2 * 24 * ssm.D_STATE * 128)
    outs = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev).requires_grad_() for k, v in p0.items()}
        x = x0[:, :24].to(dev).requires_grad_()
        out, st = ssm.mamba_forward(p, x, return_state=True)
        loss = (out ** 2).sum() + (st["ssm"] ** 2).sum()
        grads = torch.autograd.grad(loss, [x, *p.values()])
        seq = [out.detach(), st["ssm"].detach()] + list(grads)
        state = {k: v.detach() for k, v in st.items()}
        with torch.no_grad():
            for t in range(24, 28):
                o, state = ssm.mamba_decode(p, x0[:, t:t + 1].to(dev), state)
                seq += [o, state["ssm"]]
        outs[str(dev)] = [v.cpu() for v in seq]
    assert len(ssm._blocks(48, 2 * cfg.d_model, ssm.SCAN_BLOCK)) == 2
    for i, (g, c) in enumerate(zip(outs[str(cuda)], outs["cpu"])):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max()), i
