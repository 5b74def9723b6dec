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
   ``ef_accum_sparsify``: its ``library_ms`` is null); every kernel's
   timed outputs are held bitwise against the plain version's too.
3. Small-input reference: the kernel-backed exchanges on the card
   (``lags_dp`` under three compressors, ``lags_hier2`` with 2 pods x 2)
   against the same exchanges on the CPU (plain versions), bitwise.
4. The main path: LAGS-SGD training of TinyLlama-1.1B at its published
   width (bf16 parameters), one 1024-token sequence per simulated
   worker, ratio 1000, 3 steps per configuration of ``SIM_CONFIGS``
   through ``Session.simulator``: P=2 workers at the published depth for
   ``dense`` and for ``lags_dp`` with the kernel backend under
   ``topk_exact``, ``topk_block`` and ``topk_hier``; and the two-tier
   ``lags_hier2`` with P=4 (2 pods x 2, inner ratio 100 under
   ``topk_block``, outer ratio 1000 under ``topk_exact``) at 16 of the
   22 layers, the depth at which its two f32 residuals per worker fit
   the card.  Every loss must be finite and every kernel of a
   configuration must launch in it; the EF invariant is checked on one
   leaf (for ``lags_hier2`` on each tier).
5. ``ef_accum_sparsify``'s own path, the entry point
   ``ops.ef_accum_sparsify`` as its users call it: two error-feedback
   threshold passes over every leaf of one full-size TinyLlama-1.1B
   gradient, the threshold from ``ops.hier_topk_threshold`` at ratio
   1000; every leaf's (selected, residual) equals the plain version's
   bit for bit, and ``selected + residual == acc``.
6. The distributed surface: one NCCL rank (world size 1), full-size
   TinyLlama-1.1B, one 1024-token sequence (the same every step), 3
   steps each of the configurations of ``DIST_CONFIGS`` through
   ``Session(cfg, run, mesh=...).train_step()``: ``dense``, ``lags_dp``
   (kernel backend) and ``lags_dp`` + momentum correction 0.9, each
   ``off`` (the exchange after backward), ``wave`` (exchanges launched by
   autograd hooks inside backprop) or ``async1`` (the previous step's
   exchange launched before the forward); ``slgs`` (kernel backend: one
   global top-k over the 1,100,048,384-element whole-model vector) off
   and in its one wave; ``lags_hier2`` (kernel backend, the simulation
   phase's tiers) off and ``wave``, and ``lags_hier`` (kernel backend),
   on the ``make_mesh()`` of one rank: one pod, so the outer tier runs
   over no axis.  Step 0 runs under deterministic algorithms: step 0's
   exchanged mean and EF residuals (every tier's) of ``lags_dp``,
   ``slgs``, ``lags_hier2`` and ``lags_hier`` must equal the simulation
   path's (P = 1) bit for bit, every kernel launch of that exchange (for
   ``slgs`` the 268,567-row block view of the whole-model vector) must
   equal its plain version on the same inputs bit for bit, step 0's
   parameters and residuals of each ``wave`` configuration must equal its
   ``off`` twin's, and the losses of each ``async1`` configuration must
   be ``[L0, L0, L1]`` of its twin's ``[L0, L1, ...]``.  Each step prints
   its time, peak memory and kernel launches, and each ``wave`` step how
   long before the end of backward each wave launched; the kernels of
   ``DIST_EXPECTED`` must launch.
7. Print the kernels' JSON line, the card line and the result line.

    python3 chip_smoke.py --ranks 4  # the distributed phase alone, 4 cards

runs phase 6 on 4 NCCL ranks, one process and one card each, 4
sequences per global batch: the flat configurations on the ("data",)
mesh of 4, the hierarchy on the ("pod", "data") mesh of 2 x 2; after
every step each rank's parameters must equal rank 0's bit for bit, with
deterministic algorithms off (the replicas are never re-synchronised, so
the exchange itself must give every rank the same bits).

Any failure raises (non-zero exit).  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits 1 and prints no result.
Results also go to ``chiprun_out/chip_smoke.json``; ``--profile`` adds one
profiled step per configuration (``chiprun_out/profile_*.txt``).
"""
from __future__ import annotations

import argparse
import contextlib
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
#: the main path's simulation configurations: label -> (RunConfig
#: kwargs, simulated workers, layers (None = the published depth), the
#: kernels it must launch)
SIM_CONFIGS = {
    "dense/topk_exact/xla": (dict(mode="dense"), 2, None, ()),
    "lags_dp/topk_exact/kernel": (
        dict(mode="lags_dp", compressor="topk_exact"), 2, None,
        ("ef_block_candidates", "ef_select_pack")),
    "lags_dp/topk_block/kernel": (
        dict(mode="lags_dp", compressor="topk_block"), 2, None,
        ("ef_select_pack",)),
    "lags_dp/topk_hier/kernel": (
        dict(mode="lags_dp", compressor="topk_hier"), 2, None,
        ("block_topk",)),
    # 2 pods x 2: the outer tier topk_exact (candidates + sort + gated
    # pack), the inner tier topk_block (pack).  Two f32 residuals per
    # worker (8 copies of the model at P = 4, old and new alive together
    # in the exchange) do not fit 80 GB at 22 layers: 16 layers, full width
    "lags_hier2/topk_exact+topk_block/kernel": (
        dict(mode="lags_hier2", compressor="topk_exact",
             inner_compressor="topk_block", ratio=1000.0, ratio_inner=100.0,
             inner_workers=2), 4, 16,
        ("ef_block_candidates", "ef_select_pack")),
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
        err = assert_bitwise(f"{name} rows {n}x{bs} k={k}", kern(), plain())
        b_ms, b_by = bound(nbytes, k * n * bs)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "shape": [n, bs], "k": k, "bytes": nbytes,
                     "max_abs_err": err}
        print(f"time {name}: rows {n}x{bs} k={k}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the bound; "
              f"outputs bitwise equal to the plain version's")
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
    CPU (plain versions), bitwise, on small leaves with short tails:
    lags_dp under each compressor (P = 2) and lags_hier2 (2 pods x 2)."""
    import torch
    from repro_torch import tree
    from repro_torch.api import registry as R
    like = {"a": torch.zeros(100), "b": torch.zeros(40, 130),
            "c": torch.zeros(3, 700)}
    cases = [("lags_dp", dict(compressor=comp), 2)
             for comp in ("topk_exact", "topk_block", "topk_hier")]
    cases.append(("lags_hier2", dict(compressor="topk_exact",
                                     inner_compressor="topk_block",
                                     ratio_inner=4.0, n_inner=2), 4))
    for mode, kw, p in cases:
        gen = torch.Generator().manual_seed(5)
        u = {k: torch.randn((p,) + tuple(v.shape), generator=gen)
             for k, v in like.items()}
        ex = R.build_exchange(R.ExchangeSpec(
            mode=mode, params_like=like, ratio=16.0,
            selection_backend="kernel", block_size=1024, sim=True,
            n_workers=p, **kw))
        e_cpu = ex.init(u)
        e_gpu = tree.map(lambda v: v.to(dev), e_cpu)
        for _ in range(2):
            m_cpu, e_cpu = ex.exchange(u, e_cpu, None)
            m_gpu, e_gpu = ex.exchange({k: v.to(dev) for k, v in u.items()},
                                       e_gpu, None)
            got = tree.leaves(m_gpu) + tree.leaves(e_gpu)
            for i, (g, w) in enumerate(zip(got, tree.leaves(m_cpu)
                                           + tree.leaves(e_cpu))):
                assert_bitwise(f"exchange {mode} {kw} output {i}",
                               (g.cpu(),), (w,))
    print("small reference: kernel-backed exchanges (lags_dp under three "
          "compressors, lags_hier2 2 pods x 2) on the card == plain "
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


def main_path(dev, cfg, seq: int, steps: int,
              profile_dir: Path | None = None) -> tuple[dict, dict]:
    """Train ``steps`` steps in each configuration of ``SIM_CONFIGS``;
    returns (kernel launches summed over the run, per-step rows)."""
    import torch
    from repro_torch import api, kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as T

    data = synthetic.MarkovLM(vocab=cfg.vocab, seed=3)
    torch.cuda.empty_cache()
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    results = {}

    for label, (kw, p, n_layers, expect) in SIM_CONFIGS.items():
        c = cfg if n_layers is None else dataclasses.replace(
            cfg, n_layers=n_layers)
        batches = [data.worker_batches(t, p, 1, seq, device=dev)
                   for t in range(steps)]

        def loss_fn(params, batch, c=c):
            return T.loss_fn(params, c, batch, chunk=1024, loss_chunk=512)

        model = T.Transformer(c, seed=0, device=dev)
        n_params = sum(x.numel() for x in tree.leaves(model.params))
        run = api.RunConfig(selection_backend="kernel" if expect else "xla",
                            lr=0.01, **kw)
        trainer = api.Session(c, run, device=dev).simulator(
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
        results[label] = {"params": n_params, "workers": p,
                          "n_layers": c.n_layers, "steps": rows}
        if label == "lags_dp/topk_exact/kernel":
            check_ef_invariant(trainer, dev)
        if kw["mode"] == "lags_hier2":
            check_ef_invariant_tiers(trainer, dev)
        if profile_dir is not None:
            results[label]["profile"] = profile_step(
                trainer, batches[-1], label, profile_dir)
        del trainer, model, batches
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


def check_ef_invariant_tiers(trainer, dev) -> None:
    """Each tier of lags_hier2 on the embedding leaf, with the live
    residuals and a fresh update: the inner tier's ``e_in + u ==
    scatter(values, indices) + residual`` per worker, and the outer
    tier's ``e_out + m == ...`` per pod, ``m`` the pod means of the inner
    picks; bit for bit."""
    import torch
    from repro_torch import tree
    from repro_torch.core import compressors as C
    from repro_torch.core import lags
    ex = trainer.exchange
    ef = trainer.state["ef"]
    i = tree.leaf_paths(ef["inner"]).index("embed/embedding")
    e_in, e_out = tree.leaves(ef["inner"])[i], tree.leaves(ef["outer"])[i]
    k_in, k_out = tree.leaves(ex.ks_inner)[i], tree.leaves(ex.ks)[i]
    (icomp, ikw), (comp, kw) = ex._tiers()
    p, n_in = e_in.shape[0], ex.n_inner
    n_out, d = p // n_in, e_in[0].numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    u = 1e-3 * torch.randn(e_in.shape, generator=gen, device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        vals, idx, res = lags.local_select_ef(u, e_in, k_in, icomp, **ikw)
        recon = res.reshape(p, -1) + C.decompress(vals, idx, d)
        if not torch.equal(recon, (e_in + u).reshape(p, -1)):
            raise AssertionError("inner-tier EF invariant broken")
        m = torch.stack([lags._gathered_scatter_mean(
            vals[o * n_in:(o + 1) * n_in], idx[o * n_in:(o + 1) * n_in], d,
            n_in) for o in range(n_out)])
        del vals, idx, res, recon, u
        e_pod = e_out.reshape(n_out, n_in, d)[:, 0].contiguous()
        vals, idx, res = lags.local_select_ef(m, e_pod, k_out, comp, **kw)
        if not torch.equal(res + C.decompress(vals, idx, d), e_pod + m):
            raise AssertionError("outer-tier EF invariant broken")
        for o in range(n_out):
            for w in range(o * n_in, (o + 1) * n_in):
                if not torch.equal(e_out[w].reshape(-1), e_pod[o]):
                    raise AssertionError("outer residual differs within a "
                                         "pod")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"EF invariant acc == scatter(vals, idx) + residual holds bitwise "
          f"on embed/embedding for both tiers (inner: {p} workers, k={k_in}; "
          f"outer: {n_out} pods, k={k_out}); the outer residual is the same "
          f"on every worker of a pod")


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


#: the distributed phase's configurations, in run order: each pipelined
#: one comes after its "off" twin (``TWINS``), which it is held to
DIST_CONFIGS = {
    "dense": dict(mode="dense"),
    "dense/wave": dict(mode="dense", pipeline="wave"),
    "lags_dp/kernel": dict(mode="lags_dp", selection_backend="kernel"),
    "lags_dp/kernel/wave": dict(mode="lags_dp", selection_backend="kernel",
                                pipeline="wave"),
    "lags_dp/kernel/async1": dict(mode="lags_dp", selection_backend="kernel",
                                  pipeline="async1"),
    "lags_dp/kernel/mc0.9": dict(mode="lags_dp", selection_backend="kernel",
                                 momentum_correction=0.9),
    "lags_dp/kernel/async1/mc0.9": dict(
        mode="lags_dp", selection_backend="kernel", pipeline="async1",
        momentum_correction=0.9),
    "slgs/kernel": dict(mode="slgs", selection_backend="kernel"),
    "slgs/kernel/wave": dict(mode="slgs", selection_backend="kernel",
                             pipeline="wave"),
    # the hierarchy, on the (pod, data) mesh when there are several ranks
    "lags_hier2/kernel": dict(mode="lags_hier2", selection_backend="kernel",
                              inner_compressor="topk_block",
                              ratio_inner=100.0),
    "lags_hier2/kernel/wave": dict(
        mode="lags_hier2", selection_backend="kernel",
        inner_compressor="topk_block", ratio_inner=100.0, pipeline="wave"),
    "lags_hier/kernel": dict(mode="lags_hier", selection_backend="kernel"),
}
TWINS = {"dense/wave": "dense", "lags_dp/kernel/wave": "lags_dp/kernel",
         "lags_dp/kernel/async1": "lags_dp/kernel",
         "lags_dp/kernel/async1/mc0.9": "lags_dp/kernel/mc0.9",
         "slgs/kernel/wave": "slgs/kernel",
         "lags_hier2/kernel/wave": "lags_hier2/kernel"}
# kernels each distributed configuration must launch, by mode
DIST_EXPECTED = {"dense": (), "lags_dp": ("ef_select_pack",),
                 "slgs": ("ef_block_candidates", "ef_select_pack"),
                 "lags_hier2": ("ef_block_candidates", "ef_select_pack"),
                 "lags_hier": ("ef_select_pack",)}
HIER_MODES = ("lags_hier", "lags_hier2")


def distributed(dev, cfg, seq: int, steps: int, world: int = 1,
                rank: int = 0, init_method: str | None = None
                ) -> tuple[dict, dict, dict]:
    """The data-parallel surface on ``world`` NCCL ranks (this process is
    ``rank``; one sequence per rank, the same global batch every step):
    ``steps`` steps of each configuration of ``DIST_CONFIGS``.  One rank:
    step 0 of every configuration runs under deterministic algorithms;
    step 0 of lags_dp and slgs is held against the simulation path, step
    0's parameters and residuals of each ``wave`` configuration against
    its ``off`` twin bit for bit, and each ``async1`` configuration's
    losses against ``[L0, L0, L1]`` of its twin.  Several ranks: after
    every step each rank's parameters must equal rank 0's bit for bit.
    Returns (launch counts summed over the run, per-step rows, each
    kernel's largest absolute error against its plain version in the
    step-0 checks)."""
    import torch
    import torch.distributed as dist
    from repro_torch import api, kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.pipeline import step as WS

    data = synthetic.MarkovLM(vocab=cfg.vocab, seed=3)
    batch = data.batch(0, world, seq, device=dev)
    M.init_process_group(init_method or f"tcp://localhost:{free_port()}",
                         world, rank, device=dev.type)
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    results, twins, errs = {}, {}, {}
    try:
        flat_mesh = M.make_mesh(device=dev.type)
        # two pods when the ranks split in two; one pod (no outer tier)
        # otherwise, as on the reference's single-pod mesh
        pods = 2 if world > 1 and world % 2 == 0 else 1
        pod_mesh = (M.make_mesh(pod=pods, device=dev.type) if pods > 1
                    else flat_mesh)
        for label, kw in DIST_CONFIGS.items():
            run = api.RunConfig(lr=0.01, **kw)
            mesh = pod_mesh if run.mode in HIER_MODES else flat_mesh
            sess = api.Session(cfg, run, mesh=mesh)
            step_fn = sess.step_fn
            state, _ = sess.init_state(seed=0)
            waves = sess.meta["waves"]
            if rank == 0:
                print(f"distributed {label}: mesh "
                      f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
                      f"{sess.meta['n_workers']} workers")
            if waves is not None and rank == 0:
                for i, w in enumerate(waves.waves):
                    print(f"distributed {label} wave {i}: {len(w.leaf_ids)} "
                          f"leaves {list(w.names)}")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            counts = dict.fromkeys(kernels.WRAPPERS, 0)
            rows, losses = [], []
            for t in range(steps):
                det = world == 1 and t == 0
                if det:
                    p0 = [x.detach().clone()
                          for x in tree.leaves(state["params"])]
                    torch.use_deterministic_algorithms(True)
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                marks = [] if run.pipeline == "wave" else None
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch, marks=marks)
                loss = float(metrics["loss"])                # device sync
                step_s = time.perf_counter() - t0
                step_counts = kernels.launch_counts()
                for k, v in step_counts.items():
                    counts[k] += v
                mem = torch.cuda.max_memory_allocated()
                losses.append(loss)
                leads = None if marks is None else WS.launch_leads(marks)
                if det:    # its comparison launches are not counted
                    try:
                        if run.mode != "dense" and run.pipeline == "off":
                            for k, v in check_step0(sess, state, p0,
                                                    batch).items():
                                errs[k] = max(errs.get(k, 0.0), v)
                        held(label, state, twins)
                    finally:
                        torch.use_deterministic_algorithms(False)
                    del p0
                if world > 1:
                    check_replicas(state["params"], f"{label} step {t}")
                rows.append({"step": t, "loss": loss, "step_s": step_s,
                             "max_memory_allocated": mem,
                             "launches": step_counts, "wave_leads": leads,
                             "deterministic": det})
                who = f" rank {rank}/{world}" if world > 1 else ""
                print(f"distributed {label}{who} step {t}: loss {loss:.6f} "
                      f"step_s {step_s:.4f} max_memory_allocated "
                      f"{mem / 2**30:.3f} GiB launches {step_counts}"
                      + (" (deterministic algorithms)" if det else "")
                      + (", parameters equal on every rank"
                         if world > 1 else ""))
                if leads is not None:
                    print(f"distributed {label}{who} step {t}: launch lead "
                          f"before the end of backward, per wave (host ms "
                          f"/ device ms): " + ", ".join(
                              f"w{x['wave']} {x['host_ms']:.3f}/"
                              f"{x['device_ms'] or 0.0:.3f}" for x in leads))
                if not math.isfinite(loss):
                    raise AssertionError(f"distributed {label} step {t}: "
                                         f"loss {loss}")
            if world == 1 and "async1" in label:
                want = twins[TWINS[label]]["losses"]
                if losses[:3] != [want[0], want[0], want[1]]:
                    raise AssertionError(
                        f"{label}: losses {losses} are not [L0, L0, L1] of "
                        f"{TWINS[label]}'s {want}")
                print(f"distributed {label}: losses {losses[:3]} == [L0, "
                      f"L0, L1] of {TWINS[label]} ({want[:2]}), exactly")
            if world == 1 and label not in TWINS:
                twins.setdefault(label, {})["losses"] = losses
            for k in DIST_EXPECTED[run.mode]:
                if counts[k] == 0:
                    raise AssertionError(f"distributed {label}: {k} never "
                                         f"launched")
            for k, v in counts.items():
                totals[k] += v
            results[label] = {"steps": rows, "launches": counts,
                              "n_waves": None if waves is None
                              else waves.n_waves,
                              "mesh": dict(zip(mesh.mesh_dim_names,
                                               mesh.mesh.shape))}
            del state, step_fn, sess
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    return totals, results, errs


def held(label: str, state, twins: dict) -> None:
    """Step 0 of an ``off`` configuration with a ``wave`` twin: keep its
    parameters and residuals on the host.  Step 0 of a ``wave``
    configuration: they must equal its twin's, bit for bit."""
    from repro_torch import tree
    parts = tree.leaves(state["params"]) + tree.leaves(state["ef"])
    wave_twins = {v for k, v in TWINS.items() if k.endswith("/wave")}
    if label in wave_twins:
        twins.setdefault(label, {})["step0"] = [
            x.detach().to("cpu", copy=True) for x in parts]
        return
    if not label.endswith("/wave"):
        return
    twin = TWINS[label]
    want = twins[twin].pop("step0")
    if len(want) != len(parts):
        raise AssertionError(f"{label}: {len(parts)} leaves, {twin} has "
                             f"{len(want)}")
    for i, (got, ref0) in enumerate(zip(parts, want)):
        assert_bitwise(f"{label} step 0 leaf {i} vs {twin}",
                       (got.detach().cpu(),), (ref0,))
    print(f"distributed {label} step 0: parameters and residuals == "
          f"{twin}'s, bitwise ({len(parts)} leaves)")


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


@contextlib.contextmanager
def held_to_plain(errs: dict, shapes: dict, chunk_rows: int = 1 << 15):
    """Inside the block, every ``ef_select_pack`` and
    ``ef_block_candidates`` launch is held against its plain version on
    the same inputs, bit for bit: the plain version runs chunk by chunk
    of ``chunk_rows`` rows (rows are independent; a gate with one
    threshold per row group runs whole), so the check fits beside the
    step at its full shapes.  ``errs`` takes each kernel's largest
    absolute error, ``shapes`` the row shapes it was launched at."""
    import types

    import torch
    from repro_torch.kernels import ef_sparsify, ops, ref
    kernel = {"ef_select_pack": ef_sparsify.ef_select_pack,
              "ef_block_candidates": ef_sparsify.ef_block_candidates}
    plain = {"ef_select_pack": ref.ef_select_pack_ref,
             "ef_block_candidates": ref.ef_block_candidates_ref}

    def checked(name):
        def call(g_rows, e_rows, lr, *rest):
            out = kernel[name](g_rows, e_rows, lr, *rest)
            n, bs = g_rows.shape
            thr = rest[0] if name == "ef_select_pack" else None
            whole = thr is not None and torch.as_tensor(thr).numel() > 1
            step = n if whole else chunk_rows
            for lo in range(0, n, step):
                hi = min(n, lo + step)
                errs[name] = max(errs.get(name, 0.0), assert_bitwise(
                    f"{name} rows {n}x{bs} [{lo}:{hi}]",
                    tuple(o[lo:hi] for o in out),
                    plain[name](g_rows[lo:hi], e_rows[lo:hi], lr, *rest)))
            shapes.setdefault(name, set()).add((n, bs))
            return out
        return call

    # the exchanges reach the kernels through ``ops``; the wrappers
    # themselves (and their launch counts) stay as they are
    ops._ef = types.SimpleNamespace(**{
        **vars(ef_sparsify), **{name: checked(name) for name in kernel}})
    try:
        yield
    finally:
        ops._ef = ef_sparsify


def check_step0(sess, state, p0, batch) -> dict:
    """Step 0 of a distributed exchange mode against the simulation path,
    bit for bit: the gradient is taken again at the step's starting
    parameters (deterministic algorithms make it the step's own), and
    the step's exchange (``meta["exchange"]``) runs over the step's axes
    and on its simulation path (P = 1) on the same updates; their means
    and residuals (every tier's) must be equal, the residuals must be the
    step's, and the step's parameters must be ``p0 - mean``.  (At world
    size 1 lags_hier's mean over the pod's ranks divides by 1, and with
    no pod axis its exchange is the simulation path itself.)  Every
    kernel launch of the distributed exchange (the step's own inputs and
    shapes: 268,567 rows of the whole-model vector for slgs) is held
    against its plain version too (``held_to_plain``).  Returns each
    kernel's largest absolute error there."""
    import torch
    from repro_torch import tree
    from repro_torch.api import registry as R
    from repro_torch.models import transformer as T
    run, meta = sess.run_config, sess.meta
    ex, axes = meta["exchange"], meta["axes"]
    tiers = R.get_exchange(meta["mode"]).ef_tiers
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

        def zeros(lead):
            z = tree.unflatten(treedef, [torch.zeros(lead + tuple(x.shape),
                                                     device=x.device)
                                         for x in u])
            return {t: tree.map(torch.zeros_like, z) for t in tiers} \
                if tiers else z

        def sim():
            return ex.exchange(tree.unflatten(treedef, [x[None] for x in u]),
                               zeros((1,)), None)

        errs, shapes = {}, {}
        with held_to_plain(errs, shapes):
            if axes is None:
                m_d, e_d = sim()
                e_d = tree.map(lambda x: x[0], e_d)
            else:
                m_d, e_d = ex.exchange(tree.unflatten(treedef, u), zeros(()),
                                       axes)
        if not errs:
            raise AssertionError(f"step 0 of {meta['mode']}: no kernel "
                                 f"launched in the exchange")
        m_s, e_s = sim()
        del u
        nonzero = 0
        for path, md, ms, p_start, p_new in zip(
                tree.leaf_paths(m_d), tree.leaves(m_d), tree.leaves(m_s),
                p0, tree.leaves(state["params"])):
            assert_bitwise(f"step 0 {path} mean vs simulation", (md,), (ms,))
            assert_bitwise(f"step 0 {path} parameters vs p0 - mean",
                           (p_new,), ((p_start.float() - md).to(p_new.dtype),))
            nonzero += int((md != 0).sum())
        n_resid = 0
        for path, ed, es, ef in zip(
                tree.leaf_paths(e_s), tree.leaves(e_d), tree.leaves(e_s),
                tree.leaves(state["ef"])):
            assert_bitwise(f"step 0 {path} residual vs simulation",
                           (ed[None],), (es,))
            assert_bitwise(f"step 0 {path} residual vs the step's", (ef,),
                           (es,))
            n_resid += 1
    what = (f"{type(ex).__name__} simulation path (P = 1), bitwise "
            f"({n_resid} residual leaves{', tiers ' + str(tiers) if tiers else ''});"
            f" the step's residuals and parameters agree; {nonzero} nonzero "
            f"entries in the mean")
    if meta["mode"] == "slgs":
        d = sum(x.numel() for x in p0)
        n_blocks = -(-d // run.block_size)
        what += (f" of d = {d}: k_total = {ex.k_total}, {n_blocks} blocks x "
                 f"r = 4 = {4 * n_blocks} candidates, the k-th clamped to "
                 f"the last (every candidate passes the gate)"
                 if 4 * n_blocks < ex.k_total else
                 f" of d = {d}: k_total = {ex.k_total}")
    print(f"distributed {meta['mode']} step 0: exchanged mean and EF "
          f"residual == {what}")
    print(f"distributed {meta['mode']} step 0: every kernel launch of the "
          f"exchange == its plain version on the same inputs, bitwise; row "
          f"shapes {dict((k, sorted(v)) for k, v in shapes.items())}")
    return errs


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
    totals, results = main_path(dev, cfg, seq, steps,
                                out_dir if args.profile else None)
    # each later path: counts set to 0 just before it, read just after
    path_counts, path_err = ef_accum_path(dev, cfg, seq)
    for k, v in path_counts.items():
        totals[k] += v
    errs["ef_accum_sparsify"] = max(
        errs["ef_accum_sparsify"], path_err,
        times["ef_accum_sparsify_bf16"]["max_abs_err"])
    for name in REPLACES:
        errs[name] = max(errs[name], times[name]["max_abs_err"])
    dist_totals, dist_results, dist_errs = distributed(dev, cfg, seq, steps)
    for name, err in dist_errs.items():
        errs[name] = max(errs[name], err)
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
        deadline = time.monotonic() + 600
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
    totals, results, _ = distributed(dev, cfg, seq, steps, world=args.ranks,
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
