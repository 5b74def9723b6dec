#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, one card

1. Print the card (``nvidia-smi``) and build the CUDA selection kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, bit
   for bit (rows of 4096 plus a short and an odd row length, f32 and bf16
   inputs, k in {1, 4, 5, bs}, threshold gate on and off; for
   ``ef_accum_sparsify`` flat vectors of 100 to 2^22 + 5 elements, four
   (lr, thr) pairs and a misaligned view), then time it at the main
   path's largest shape beside its byte bound, its plain version and
   ``torch.topk`` on the same rows (no one PyTorch call computes
   ``ef_accum_sparsify``: its ``library_ms`` is null; its timed outputs
   are held bitwise against the plain version's too).
3. Small-input reference: the kernel-backed exchange on the card against
   the same exchange on the CPU (plain versions), bitwise.
4. The main path: LAGS-SGD training of TinyLlama-1.1B at its published
   width and depth (bf16 parameters), P=2 simulated workers, one
   1024-token sequence each, ratio 1000, 3 steps each of ``dense`` and of
   ``lags_dp`` with the kernel backend under ``topk_exact``,
   ``topk_block`` and ``topk_hier``, through ``Session.simulator``.  Every
   loss must be finite and every kernel of a configuration must launch in
   it; the EF invariant is checked on one leaf.
5. ``ef_accum_sparsify``'s own path, the entry point
   ``ops.ef_accum_sparsify`` as its users call it: two error-feedback
   threshold passes over every leaf of one full-size TinyLlama-1.1B
   gradient, the threshold from ``ops.hier_topk_threshold`` at ratio
   1000; every leaf's (selected, residual) equals the plain version's
   bit for bit, and ``selected + residual == acc``.
6. The distributed data-parallel surface: one NCCL rank (world size 1),
   full-size TinyLlama-1.1B, one 1024-token sequence, 3 steps each of
   ``dense``, ``lags_dp`` (kernel backend) and ``lags_dp`` + momentum
   correction 0.9 through ``Session(cfg, run, mesh=...).train_step()``;
   ``ef_select_pack`` must launch, and step 0's exchanged mean and EF
   residual must equal the simulation path's (``BlockLAGSExchange``,
   P = 1) bit for bit, under deterministic algorithms.
7. Print the kernels' JSON line, the card line and the result line.

    python3 chip_smoke.py --ranks 4  # the distributed phase alone, 4 cards

runs phase 6 on 4 NCCL ranks, one process and one card each, 4
sequences per global batch; after every step each rank's parameters
must equal rank 0's bit for bit, with deterministic algorithms off (the
replicas are never re-synchronised, so the exchange itself must give
every rank the same bits).

Any failure raises (non-zero exit).  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits 1 and prints no result.
Results also go to ``chiprun_out/chip_smoke.json``; ``--profile`` adds one
profiled step per configuration (``chiprun_out/profile_*.txt``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
REPLACES = {
    "block_topk": "src/repro/kernels/block_topk.py:49",
    "ef_select_pack": "src/repro/kernels/ef_sparsify.py:137",
    "ef_block_candidates": "src/repro/kernels/ef_sparsify.py:177",
    "ef_accum_sparsify": "src/repro/kernels/ef_sparsify.py:55",
}
SOURCE = "src/repro_torch/kernels/csrc/selection.cu"
# kernels each main-path configuration must launch
EXPECTED = {
    ("dense", "topk_exact"): (),
    ("lags_dp", "topk_exact"): ("ef_block_candidates", "ef_select_pack"),
    ("lags_dp", "topk_block"): ("ef_select_pack",),
    ("lags_dp", "topk_hier"): ("block_topk",),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def bits(t):
    import torch
    t = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    return t.contiguous().view(torch.int32)


def assert_bitwise(what, got, want) -> float:
    """Raise unless every output matches bit for bit; return the largest
    absolute difference of the float outputs (0.0 when they match)."""
    import torch
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} output {i}: {g.dtype}{tuple(g.shape)}"
                                 f" vs {w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            err = max(err, float((g.float() - w.float()).abs().max()))
        if not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"{what} output {i} differs from the plain "
                                 f"version")
    return err


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def parity(dev) -> dict:
    """Each kernel against its plain version, bitwise; returns the largest
    absolute error per kernel."""
    import torch
    from repro_torch.kernels import ef_sparsify, ref
    from repro_torch.kernels.block_topk import block_topk
    errs = {"block_topk": 0.0, "ef_select_pack": 0.0,
            "ef_block_candidates": 0.0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_cases = 0
    for n, bs in ((256, 4096), (37, 130), (37, 1023)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn((n, bs), generator=gen, device=dev).to(dtype)
            e = torch.randn((n, bs), generator=gen, device=dev)
            # ties: a run of equal magnitudes in every row
            g[:, 7:19] = 0.75
            g[:, 40:44] = -0.75
            e[:, 7:44] = 0.0
            lr1 = torch.ones((), device=dev)
            lr3 = torch.full((), 0.3, device=dev)
            thr = torch.full((), 0.5, device=dev)
            thr_groups = torch.tensor([0.5, 1.5], device=dev) \
                if n % 2 == 0 else thr
            for k in (1, 4, 5, bs):
                tag = f"n={n} bs={bs} {dtype} k={k}"
                errs["block_topk"] = max(errs["block_topk"], assert_bitwise(
                    f"block_topk {tag}", block_topk(g, k),
                    ref.block_topk_ref(g, k)))
                for t, lr in ((None, lr1), (thr, lr1), (thr_groups, lr1),
                              (thr, lr3)):
                    errs["ef_select_pack"] = max(
                        errs["ef_select_pack"], assert_bitwise(
                            f"ef_select_pack {tag} thr={t} lr={float(lr)}",
                            ef_sparsify.ef_select_pack(g, e, lr, t, k),
                            ref.ef_select_pack_ref(g, e, lr, t, k)))
                for lr in (lr1, lr3):
                    errs["ef_block_candidates"] = max(
                        errs["ef_block_candidates"], assert_bitwise(
                            f"ef_block_candidates {tag} lr={float(lr)}",
                            ef_sparsify.ef_block_candidates(g, e, lr, k),
                            ref.ef_block_candidates_ref(g, e, lr, k)))
                n_cases += 1
    errs["ef_accum_sparsify"] = 0.0
    # 2^22 + 5: each thread of the one-wave grid (132 SMs x 8 blocks x 256
    # threads on an H100) goes round its grid-stride loop several times
    for d in (100, 1024, 5000, 70000, 2**20 + 3, 2**22 + 5):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn((d + 1,), generator=gen, device=dev).to(dtype)
            e = torch.randn((d + 1,), generator=gen, device=dev)
            # |acc| == thr exactly at (lr, thr) = (0.1, 0.5): 0.3 + 0.2
            g[:32], e[:32] = 2.0, 0.3
            views = {"aligned": (g[:d], e[:d]),
                     # one element in: no pointer is 16-byte aligned, so
                     # the kernel takes its element-by-element path
                     "misaligned": (g[1:], e[1:])}
            for lr, thr in ((0.1, 0.5), (1.0, 0.0), (0.01, 2.0),
                            (0.3, 0.7)):
                for view, (gv, ev) in views.items():
                    errs["ef_accum_sparsify"] = max(
                        errs["ef_accum_sparsify"], assert_bitwise(
                            f"ef_accum_sparsify d={d} {dtype} lr={lr} "
                            f"thr={thr} {view}",
                            ef_sparsify.ef_accum_sparsify(gv, ev, lr, thr),
                            ref.ef_accum_sparsify_ref(gv, ev, lr, thr)))
                    n_cases += 1
    torch.cuda.synchronize()
    print(f"parity: {n_cases} shape/dtype/k cases, every kernel bitwise "
          f"equal to its plain version (max_abs_err {errs})")
    return errs


def timings(dev, cfg, p: int) -> dict:
    """Each kernel at the main path's largest leaf (the stacked FFN
    weights of every layer, P workers: P·n_blocks rows of 4096)."""
    import torch
    from repro_torch.kernels import ef_sparsify, ref
    from repro_torch.kernels.block_topk import block_topk
    d = cfg.n_layers * cfg.d_model * cfg.d_ff
    bs = 4096
    n = p * -(-d // bs)
    k_b = max(1, min(bs, -(-max(1, round(d / cfg.compression_ratio)) * bs
                           // d)))
    r = 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    g = torch.randn((n, bs), generator=gen, device=dev)
    e = 0.01 * torch.randn((n, bs), generator=gen, device=dev)
    lr = torch.ones((), device=dev)
    acc = e + g
    mag = acc.abs()
    out = {}

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    cases = {
        "ef_select_pack": (
            k_b, lambda: ef_sparsify.ef_select_pack(g, e, lr, None, k_b),
            lambda: ref.ef_select_pack_ref(g, e, lr, None, k_b),
            n * bs * 12 + n * k_b * 8),
        "ef_block_candidates": (
            r, lambda: ef_sparsify.ef_block_candidates(g, e, lr, r),
            lambda: ref.ef_block_candidates_ref(g, e, lr, r),
            n * bs * 8 + n * r * 8),
        "block_topk": (
            r, lambda: block_topk(acc, r), lambda: ref.block_topk_ref(acc, r),
            n * bs * 4 + n * r * 8),
    }
    for name, (k, kern, plain, nbytes) in cases.items():
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(lambda: torch.topk(mag, k, dim=1), 3)
        b_ms, b_by = bound(nbytes, k * n * bs)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "shape": [n, bs], "k": k, "bytes": nbytes}
        print(f"time {name}: rows {n}x{bs} k={k}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the bound")
    # ef_accum_sparsify on the same elements as one flat vector, the
    # threshold at ratio 1000 from the hierarchical top-k of the same acc
    from repro_torch.kernels import ops
    d_all = n * bs
    thr, _ = ops.hier_topk_threshold(acc.reshape(-1),
                                     round(d_all / cfg.compression_ratio))
    del mag
    for dtype, per in ((torch.float32, 16), (torch.bfloat16, 14)):
        gf = g.reshape(-1).to(dtype)
        ef = e.reshape(-1)
        ms = cuda_ms(lambda: ef_sparsify.ef_accum_sparsify(gf, ef, lr, thr),
                     10)
        plain_ms = cuda_ms(
            lambda: ref.ef_accum_sparsify_ref(gf, ef, lr, thr), 3)
        err = assert_bitwise(
            f"ef_accum_sparsify {d_all} elements g {dtype}",
            ef_sparsify.ef_accum_sparsify(gf, ef, lr, thr),
            ref.ef_accum_sparsify_ref(gf, ef, lr, thr))
        b_ms, b_by = bound(d_all * per, 4 * d_all)
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None, "shape": [d_all],
               "g_dtype": str(dtype), "thr": float(thr),
               "bytes": d_all * per, "max_abs_err": err}
        name = "ef_accum_sparsify" + ("" if dtype == torch.float32
                                      else "_bf16")
        out[name] = row
        print(f"time {name}: {d_all} elements g {dtype}: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, no library call, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the bound; "
              f"outputs bitwise equal to the plain version's")
        del gf
    del g, e, acc
    torch.cuda.empty_cache()
    return out


def small_reference(dev) -> None:
    """The kernel-backed exchange on the card == the same exchange on the
    CPU (plain versions), bitwise, on small leaves with short tails."""
    import torch
    from repro_torch.api import registry as R
    like = {"a": torch.zeros(100), "b": torch.zeros(40, 130),
            "c": torch.zeros(3, 700)}
    gen = torch.Generator().manual_seed(5)
    u = {k: torch.randn((2,) + tuple(v.shape), generator=gen)
         for k, v in like.items()}
    for comp in ("topk_exact", "topk_block", "topk_hier"):
        ex = R.build_exchange(R.ExchangeSpec(
            mode="lags_dp", params_like=like, ratio=16.0, compressor=comp,
            selection_backend="kernel", block_size=1024, sim=True,
            n_workers=2))
        e_cpu = ex.init({k: v for k, v in u.items()})
        e_gpu = {k: v.to(dev) for k, v in e_cpu.items()}
        for _ in range(2):
            m_cpu, e_cpu = ex.exchange(u, e_cpu, None)
            m_gpu, e_gpu = ex.exchange({k: v.to(dev) for k, v in u.items()},
                                       e_gpu, None)
            for k in like:
                assert_bitwise(f"exchange {comp} {k}",
                               (m_gpu[k].cpu(), e_gpu[k].cpu()),
                               (m_cpu[k], e_cpu[k]))
    print("small reference: kernel-backed exchange on the card == plain "
          "versions on the CPU, bitwise")


def profile_step(trainer, batch, label: str, out_dir: Path) -> dict:
    """One more step under ``torch.profiler``: device time by kernel
    group, the device's busy and idle share of the step's wall time; the
    per-kernel table goes to ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.step(batch)["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((ev.key, us / 1e3, ev.count))
    kernels.sort(key=lambda r: -r[1])
    groups: dict[str, float] = {}
    for name, ms, _ in kernels:
        low = name.lower()
        group = ("selection kernels" if ("block_topk_kernel" in low
                                         or "ef_select_kernel" in low)
                 else "matmul" if any(w in low for w in (
                     "gemm", "cutlass", "nvjet", "xmma", "cublas"))
                 else "sort" if ("sort" in low or "radix" in low)
                 else "index_add/scatter/gather" if any(
                     w in low for w in ("index", "scatter", "gather"))
                 else "elementwise/reduce/copy")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    safe = label.replace("/", "_")
    with open(out_dir / f"profile_{safe}.txt", "w") as f:
        f.write(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms\n")
        for name, ms, count in kernels:
            f.write(f"{ms:10.3f} ms {count:6d}x  {name}\n")
    row = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1 - busy / wall_ms), "groups": groups}
    print(f"profile {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {row['idle_share']:.3f}; " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in sorted(
                  groups.items(), key=lambda kv: -kv[1])))
    return row


def main_path(dev, cfg, p: int, seq: int, steps: int,
              profile_dir: Path | None = None) -> tuple[dict, dict]:
    """Train ``steps`` steps in each configuration of ``EXPECTED``;
    returns (kernel launches summed over the run, per-step rows)."""
    import torch
    from repro_torch import api, kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as T

    data = synthetic.MarkovLM(vocab=cfg.vocab, seed=3)
    batches = [data.worker_batches(t, p, 1, seq, device=dev)
               for t in range(steps)]
    torch.cuda.empty_cache()
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    results = {}

    def loss_fn(params, batch):
        return T.loss_fn(params, cfg, batch, chunk=1024, loss_chunk=512)

    for (mode, comp), expect in EXPECTED.items():
        backend = "xla" if mode == "dense" else "kernel"
        label = f"{mode}/{comp}/{backend}"
        model = T.Transformer(cfg, seed=0, device=dev)
        n_params = sum(x.numel() for x in tree.leaves(model.params))
        run = api.RunConfig(mode=mode, compressor=comp,
                            selection_backend=backend, lr=0.01)
        trainer = api.Session(cfg, run, device=dev).simulator(
            loss_fn, model.params, n_workers=p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rows = []
        for t in range(steps):
            t0 = time.perf_counter()
            loss = float(trainer.step(batches[t])["loss"])   # device sync
            step_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
            mem = torch.cuda.max_memory_allocated()
            held = torch.cuda.memory_allocated()
            stats = torch.cuda.memory_stats()
            alloc = {k: stats.get(k, 0) for k in (
                "num_device_alloc", "num_device_free", "num_alloc_retries")}
            rows.append({"step": t, "loss": loss, "step_s": step_s,
                         "max_memory_allocated": mem,
                         "memory_allocated_after": held, "allocator": alloc,
                         "launches": counts})
            print(f"main {label} step {t}: loss {loss:.6f} step_s "
                  f"{step_s:.4f} max_memory_allocated {mem / 2**30:.3f} GiB "
                  f"(held after the step {held / 2**30:.3f} GiB, allocator "
                  f"{alloc}) launches {counts}")
            if not math.isfinite(loss):
                raise AssertionError(f"{label} step {t}: loss {loss}")
        counts = kernels.launch_counts()
        missing = [k for k in expect if counts[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels {missing} never launched")
        for k, v in counts.items():
            totals[k] += v
        results[label] = {"params": n_params, "steps": rows}
        if comp == "topk_exact" and mode == "lags_dp":
            check_ef_invariant(trainer, dev)
        if profile_dir is not None:
            results[label]["profile"] = profile_step(
                trainer, batches[-1], label, profile_dir)
        del trainer, model
        torch.cuda.empty_cache()
    return totals, results


def check_ef_invariant(trainer, dev) -> None:
    """e + u == scatter(values, indices) + residual on the embedding leaf
    (P workers, the live residual, a fresh update), bit for bit."""
    import torch
    from repro_torch import tree
    from repro_torch.core import compressors as C
    from repro_torch.core import lags
    paths = tree.leaf_paths(trainer.state["ef"])
    i = paths.index("embed/embedding")
    e = tree.leaves(trainer.state["ef"])[i]
    k = tree.leaves(trainer.exchange.ks)[i]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    u = 1e-3 * torch.randn(e.shape, generator=gen, device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        vals, idx, res = lags.local_select_ef(
            u, e, k, trainer.exchange.compressor,
            **dict(trainer.exchange.compressor_kwargs))
        p = e.shape[0]
        recon = res.reshape(p, -1) + C.decompress(vals, idx, e[0].numel())
        if not torch.equal(recon, (e + u).reshape(p, -1)):
            raise AssertionError("EF invariant broken on embed/embedding")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"EF invariant e + u == scatter(vals, idx) + residual holds "
          f"bitwise on embed/embedding ({tuple(e.shape)}, k={k})")


def ef_accum_path(dev, cfg, seq: int) -> dict:
    """``ops.ef_accum_sparsify`` as its users call it: two error-feedback
    threshold passes (the residual feeds the second) over every leaf of
    one full-size gradient, lr 0.01, the threshold of each pass from
    ``ops.hier_topk_threshold`` of that pass's acc at the config's ratio.
    Every leaf's (selected, residual) must equal the plain version's bit
    for bit.  Returns (the launch counts of the pass, the largest
    absolute error)."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T

    model = T.Transformer(cfg, seed=0, device=dev)
    batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=3).batch(
        0, 1, seq, device=dev)
    leaves = tree.leaves(model.params)
    loss, _ = T.loss_fn(model.params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    del model, leaves, loss
    lr = 0.01
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    kept, err = 0, 0.0
    with torch.no_grad():
        for i, g in enumerate(grads):
            g = g.reshape(-1)
            e = torch.zeros(g.shape, dtype=torch.float32, device=dev)
            k = max(1, round(g.numel() / cfg.compression_ratio))
            for t in range(2):
                acc = e + lr * g.float()
                thr, _ = ops.hier_topk_threshold(acc, k)
                sel, e_new = ops.ef_accum_sparsify(g, e, lr, thr)
                # the plain version launches nothing, so counts stay
                err = max(err, assert_bitwise(
                    f"ef_accum path leaf {i} pass {t}", (sel, e_new),
                    ref.ef_accum_sparsify_ref(g, e, lr, thr)))
                if not torch.equal(sel + e_new, acc):
                    raise AssertionError("ef_accum_sparsify: selected + "
                                         "residual != acc")
                kept += int((sel != 0).sum())
                e = e_new
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["ef_accum_sparsify"] == 0:
        raise AssertionError("ef_accum_sparsify never launched on its path")
    print(f"ef_accum path: 2 threshold passes over {len(grads)} leaves of a "
          f"TinyLlama-1.1B gradient, {kept} entries selected, (selected, "
          f"residual) bitwise equal to the plain version's and selected + "
          f"residual == acc on every leaf; launches {counts}")
    del grads
    torch.cuda.empty_cache()
    return counts, err


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def distributed(dev, cfg, seq: int, steps: int, world: int = 1,
                rank: int = 0, init_method: str | None = None
                ) -> tuple[dict, dict]:
    """The data-parallel surface on ``world`` NCCL ranks (this process is
    ``rank``; one sequence per rank): ``steps`` steps each of dense,
    lags_dp (kernel backend) and lags_dp with momentum correction.  One
    rank: step 0 of lags_dp is held against the simulation path.
    Several: after every step each rank's parameters must equal rank
    0's bit for bit.  Returns (launch counts summed over the run,
    per-step rows)."""
    import torch
    import torch.distributed as dist
    from repro_torch import api, kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M

    configs = {
        "dense": api.RunConfig(mode="dense", lr=0.01),
        "lags_dp/kernel": api.RunConfig(mode="lags_dp", lr=0.01,
                                        selection_backend="kernel"),
        "lags_dp/kernel/mc0.9": api.RunConfig(
            mode="lags_dp", lr=0.01, selection_backend="kernel",
            momentum_correction=0.9),
    }
    data = synthetic.MarkovLM(vocab=cfg.vocab, seed=3)
    batches = [data.batch(t, world, seq, device=dev) for t in range(steps)]
    M.init_process_group(init_method or f"tcp://localhost:{free_port()}",
                         world, rank, device=dev.type)
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    results = {}
    try:
        mesh = M.make_mesh(device=dev.type)
        for label, run in configs.items():
            sess = api.Session(cfg, run, mesh=mesh)
            step_fn = sess.step_fn
            state, _ = sess.init_state(seed=0)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            counts = dict.fromkeys(kernels.WRAPPERS, 0)
            rows = []
            for t in range(steps):
                check = world == 1 and t == 0 and label == "lags_dp/kernel"
                if check:
                    p0 = [x.detach().clone()
                          for x in tree.leaves(state["params"])]
                    torch.use_deterministic_algorithms(True)
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batches[t])
                loss = float(metrics["loss"])                # device sync
                step_s = time.perf_counter() - t0
                for k, v in kernels.launch_counts().items():
                    counts[k] += v
                mem = torch.cuda.max_memory_allocated()
                if check:   # its comparison launches are not counted
                    try:
                        check_step0(sess, state, p0, batches[0])
                    finally:
                        torch.use_deterministic_algorithms(False)
                    del p0
                if world > 1:
                    check_replicas(state["params"], f"{label} step {t}")
                rows.append({"step": t, "loss": loss, "step_s": step_s,
                             "max_memory_allocated": mem,
                             "deterministic": check})
                who = f" rank {rank}/{world}" if world > 1 else ""
                print(f"distributed {label}{who} step {t}: loss {loss:.6f} "
                      f"step_s {step_s:.4f} max_memory_allocated "
                      f"{mem / 2**30:.3f} GiB launches {counts}"
                      + (" (deterministic algorithms)" if check else "")
                      + (", parameters equal on every rank"
                         if world > 1 else ""))
                if not math.isfinite(loss):
                    raise AssertionError(f"distributed {label} step {t}: "
                                         f"loss {loss}")
            if run.mode == "lags_dp" and counts["ef_select_pack"] == 0:
                raise AssertionError(f"distributed {label}: ef_select_pack "
                                     f"never launched")
            for k, v in counts.items():
                totals[k] += v
            results[label] = {"steps": rows, "launches": counts}
            del state, step_fn, sess
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return totals, results


def check_replicas(params, what: str) -> None:
    """Every rank's parameters == rank 0's, bit for bit (a broadcast of
    each leaf from rank 0, compared on every rank; a rank that differs
    fails the collective check on all of them)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    bad = 0
    for path, x in zip(tree.leaf_paths(params), tree.leaves(params)):
        x = x.detach()
        ref0 = x.clone()
        dist.broadcast(ref0, 0)
        if not torch.equal(bits(x), bits(ref0)):
            print(f"rank {dist.get_rank()}: {what} {path} differs from "
                  f"rank 0")
            bad += 1
        del ref0
    flag = torch.tensor([bad], device=tree.leaves(params)[0].device)
    dist.all_reduce(flag)
    if int(flag):
        raise AssertionError(f"{what}: parameters differ across ranks "
                             f"({int(flag)} leaf copies)")


def check_step0(sess, state, p0, batch) -> None:
    """Step 0 of the distributed lags_dp step against the simulation
    path, bit for bit: the gradient is taken again at the step's starting
    parameters (deterministic algorithms make it the step's own), the
    distributed exchange and ``BlockLAGSExchange``'s simulation path
    (P = 1) run on the same updates; their means and residuals must be
    equal, the residual must be the step's, and the step's parameters
    must be ``p0 - mean``."""
    import torch
    from repro_torch import tree
    from repro_torch.core import lags
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    run, meta = sess.run_config, sess.meta
    treedef = tree.flatten(state["params"])[1]
    start = [x.clone().requires_grad_() for x in p0]
    loss, _ = T.loss_fn(tree.unflatten(treedef, start), sess.cfg, batch,
                        chunk=run.chunk, loss_chunk=run.loss_chunk)
    grads = torch.autograd.grad(loss, start)
    del start, loss
    with torch.no_grad():
        lr = torch.full((), run.lr, device=p0[0].device)
        u = [g.float().mul_(lr) for g in grads]
        del grads
        zeros = [torch.zeros_like(x) for x in u]
        dist_ex = lags.BlockLAGSExchange(ks=meta["ks"],
                                         block_size=run.block_size,
                                         use_kernel=True)
        axes = M.worker_axes(sess.mesh, meta["manual"])
        m_d, e_d = dist_ex.exchange(tree.unflatten(treedef, u),
                                    tree.unflatten(treedef, zeros), axes)
        del zeros
        m_s, e_s = dist_ex.exchange(
            tree.unflatten(treedef, [x[None] for x in u]),
            tree.unflatten(treedef, [torch.zeros((1,) + x.shape,
                                                 device=x.device)
                                     for x in u]), None)
        del u
        for path, md, ms, ed, es, ef, p_start, p_new in zip(
                tree.leaf_paths(m_d), tree.leaves(m_d), tree.leaves(m_s),
                tree.leaves(e_d), tree.leaves(e_s), tree.leaves(state["ef"]),
                p0, tree.leaves(state["params"])):
            assert_bitwise(f"step 0 {path} mean / residual vs simulation",
                           (md, ed[None]), (ms, es))
            assert_bitwise(f"step 0 {path} residual vs the step's", (ef,),
                           (es,))
            assert_bitwise(f"step 0 {path} parameters vs p0 - mean",
                           (p_new,), ((p_start.float() - md).to(p_new.dtype),))
    print("distributed lags_dp step 0: exchanged mean and EF residual == "
          "BlockLAGSExchange simulation path (P = 1), bitwise; the step's "
          "residual and parameters agree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each main-path "
                         "configuration (tables to chiprun_out/)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="> 1: run only the distributed phase, on this "
                         "many NCCL ranks (one card each)")
    # a rank process of --ranks N, started by this script itself
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    # deterministic cuBLAS, for the distributed step-0 check; read when
    # the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tinyllama_1_1b.CONFIG            # published width and depth
    seq, steps = 1024, 3
    if args.rank is not None:
        return rank_main(args, cfg, seq, steps)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"built {lib_path.name} in {build_s:.1f} s")
    if args.ranks > 1:
        return ranks_main(args.ranks)
    dev = torch.device("cuda", 0)

    torch.use_deterministic_algorithms(True)
    try:
        errs = parity(dev)
        small_reference(dev)
    finally:
        torch.use_deterministic_algorithms(False)

    p = 2
    times = timings(dev, cfg, p)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    totals, results = main_path(dev, cfg, p, seq, steps,
                                out_dir if args.profile else None)
    # each later path: counts set to 0 just before it, read just after
    path_counts, path_err = ef_accum_path(dev, cfg, seq)
    for k, v in path_counts.items():
        totals[k] += v
    errs["ef_accum_sparsify"] = max(
        errs["ef_accum_sparsify"], path_err,
        times["ef_accum_sparsify"]["max_abs_err"],
        times["ef_accum_sparsify_bf16"]["max_abs_err"])
    dist_totals, dist_results = distributed(dev, cfg, seq, steps)
    for k, v in dist_totals.items():
        totals[k] += v

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": totals[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name in REPLACES]}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "config": dataclasses.asdict(cfg), "workers": p, "seq": seq,
         "timings": times, "main": results, "distributed": dist_results,
         **kernels_line}, indent=1))
    print(json.dumps(kernels_line))
    print(card_line())
    print(result_line(torch))
    return 0


def result_line(torch) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def ranks_main(world: int) -> int:
    """Start ``world`` rank processes of this script (the kernels are
    already built), wait for all of them, print their output; every
    rank must exit 0."""
    import torch
    if torch.cuda.device_count() < world:
        print(f"chip_smoke: --ranks {world} needs {world} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    init = f"tcp://localhost:{free_port()}"
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    logs = [out_dir / f"chip_smoke_rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--ranks", str(world), "--rank", str(r), "--init",
                     init], stdin=subprocess.DEVNULL, stdout=f,
                    stderr=subprocess.STDOUT, text=True))
        # a rank that fails leaves the others waiting in a collective:
        # stop them all then, or at the deadline
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(f"--- rank {r} (exit {p.returncode})")
        print(log.read_text(), end="")
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        print(f"chip_smoke: ranks {failed} failed", file=sys.stderr)
        return 1
    print(card_line())
    print(result_line(torch))
    return 0


def rank_main(args, cfg, seq: int, steps: int) -> int:
    """One rank of ``--ranks N``: the distributed phase on card ``rank``,
    its rows to ``chiprun_out/chip_smoke_rank<r>.json``."""
    import torch
    torch.cuda.set_device(args.rank)
    dev = torch.device("cuda", args.rank)
    totals, results = distributed(dev, cfg, seq, steps, world=args.ranks,
                                  rank=args.rank, init_method=args.init)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"chip_smoke_rank{args.rank}.json").write_text(json.dumps(
        {"card": card_line(), "torch": torch.__version__,
         "world": args.ranks, "rank": args.rank, "seq": seq,
         "launches": totals, "distributed": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
