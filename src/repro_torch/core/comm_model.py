"""α–β communication cost model and the paper's pipelining speedup bound
(Eq. 19): a copy of ``repro.core.comm_model`` (pure Python).

Two hardware profiles ship:

  * ``ETH_1GBPS`` — the paper's testbed (16 nodes, 1 Gbps Ethernet),
    used to reproduce Table 2 and as the slow cross-pod wire of the
    two-tier plans.
  * ``H100_NVLINK`` — this port's target: one H100 SXM per worker, the
    workers of one host joined by NVLink, used by the adaptive ratio
    selection (Eq. 18) and as ``autotune.costfit.fit_hardware``'s base.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    alpha: float          # per-message latency, seconds
    beta: float           # seconds per byte (1 / bandwidth)
    flops: float          # peak FLOP/s per worker (for compute-time estimates)
    hbm_bw: float = 819e9  # bytes/s


ETH_1GBPS = Hardware(name="eth_1gbps", alpha=50e-6, beta=1.0 / 0.125e9,
                     flops=10.77e12)  # P102-100 ~10.77 TFLOP/s fp32
# H100 SXM: 3.35 TB/s device memory, 67 TFLOP/s f32 outside the tensor
# cores (the datasheet figures of the kernels' bounds in PERF.md).  α and
# β: ``autotune.costfit.fit_alpha_beta`` over ``profiler.time_collectives``
# (all-gather and all-reduce, 4 KiB to 4 MiB) on four NCCL ranks, one
# NVIDIA H100 80GB HBM3 each at 700.00 W, on one host
# (``python3 chip_smoke.py --ranks 4``; run B in PERF.md's findings):
# 11.6 µs per message, 203 GB/s.
H100_NVLINK = Hardware(name="h100_nvlink", alpha=1.157810323451931e-05,
                       beta=4.917023597326778e-12, flops=67e12,
                       hbm_bw=3.35e12)


def allreduce_time(nbytes: float, p: int, hw: Hardware) -> float:
    """Ring all-reduce: 2(P-1) messages of n/P bytes."""
    if p <= 1 or nbytes <= 0:
        return 0.0
    return 2 * (p - 1) * (hw.alpha + (nbytes / p) * hw.beta)


def allgather_time(nbytes_per_worker: float, p: int, hw: Hardware) -> float:
    """Ring all-gather of ``nbytes_per_worker`` contributed by each worker."""
    if p <= 1 or nbytes_per_worker <= 0:
        return 0.0
    return (p - 1) * (hw.alpha + nbytes_per_worker * hw.beta)


def sparse_allgather_time(d: int, c: float, p: int, hw: Hardware,
                          bytes_per_elem: int = 8) -> float:
    """Sparse exchange of a layer with d params compressed by ratio c:
    each worker ships k = d/c (value, index) pairs (4 B f32 + 4 B int32)."""
    k = max(1.0, d / c)
    return allgather_time(k * bytes_per_elem, p, hw)


def pipeline_speedup_bound(t_f: float, t_b: float, t_c: float) -> float:
    """Eq. 19 — maximum speedup of LAGS over SLGS at equal compression.

    S_max = 1 + 1 / ( t_f / min(t_c, t_b) + max(r, 1/r) ),  r = t_c / t_b.
    """
    if t_b <= 0 or t_c <= 0:
        return 1.0
    r = t_c / t_b
    return 1.0 + 1.0 / (t_f / min(t_c, t_b) + max(r, 1.0 / r))


def iteration_time_slgs(t_f: float, t_b: float, t_c: float) -> float:
    """SLGS: communication starts only after the whole backward pass."""
    return t_f + t_b + t_c


def iteration_time_lags(t_f: float, t_b_layers, t_c_layers) -> float:
    """Wait-free pipelined iteration time, layers in backprop order
    (deepest first): layer i's exchange starts once its backward is done
    and the wire is free,

      done_comp_i = t_f + sum_{j<=i} t_b[j]
      done_comm_i = max(done_comm_{i-1}, done_comp_i) + t_c[i]
    """
    assert len(t_b_layers) == len(t_c_layers)
    t = t_f
    comm_done = t_f
    for tb, tc in zip(t_b_layers, t_c_layers):
        t += tb
        comm_done = max(comm_done, t) + tc
    return comm_done


def max_speedup_cap(t_f: float, t_b: float) -> float:
    """The 1 + t_b/(t_f+t_b) cap mentioned below Eq. 19."""
    return 1.0 + t_b / (t_f + t_b)


def layer_backward_time(flops_layer: float, hw: Hardware,
                        efficiency: float = 0.45) -> float:
    """Estimate a layer's backward time from its FLOPs at a given MFU."""
    return flops_layer / (hw.flops * efficiency)
