"""Fit ``core.comm_model.Hardware`` parameters from profiled samples: the
port of ``repro.autotune.costfit`` (numpy).

The α–β model underlying every prediction in ``core.comm_model`` is

    t_msg = α + msg_bytes · β

with the ring collectives composing messages as
``allgather: t = (P-1)·t_msg(nbytes)`` and
``allreduce: t = 2(P-1)·t_msg(nbytes/P)``.  Each profiled
``CommSample`` is therefore normalized to one (msg_bytes, t_msg) point
and (α, β) drop out of an ordinary least-squares line fit.  The compute
rate is the profiled dense step's FLOPs (``torch.utils.flop_counter``)
over its measured wall-clock — an *effective* (not peak) rate, which is
what Eq. 18 budgets should be solved against; the device-memory rate is
likewise the dense step's counted bytes (``profiler.ByteCounterMode``)
over the same time.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import comm_model as cm


def per_message_points(samples: Iterable) -> list[tuple[float, float]]:
    """Normalize CommSamples to (msg_bytes, t_per_message) points."""
    pts = []
    for s in samples:
        if s.p <= 1 or s.t <= 0.0:
            continue
        if s.kind == "allgather":
            pts.append((float(s.nbytes), s.t / (s.p - 1)))
        elif s.kind == "allreduce":
            pts.append((float(s.nbytes) / s.p, s.t / (2 * (s.p - 1))))
        else:
            raise ValueError(f"unknown collective kind {s.kind!r}")
    return pts


def fit_alpha_beta(samples: Sequence) -> tuple[float, float]:
    """Least-squares (α, β) from profiled collective timings.

    Clamps to a tiny positive floor: wall-clock noise on near-empty
    messages can drive the intercept (or slope) slightly negative, and a
    non-positive α/β breaks every downstream ``comm_model`` formula.
    """
    pts = per_message_points(samples)
    if len(pts) < 2:
        raise ValueError(
            f"need >=2 usable samples to fit alpha/beta, got {len(pts)}")
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    A = np.stack([np.ones_like(x), x], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, y, rcond=None)
    return max(float(alpha), 1e-9), max(float(beta), 1e-15)


def rel_drift(hardware, alpha: float, beta: float) -> float:
    """Relative drift of a live (α, β) fit from a recorded fingerprint.

    ``hardware`` is a ``Schedule.hardware`` dict (or anything with
    ``alpha``/``beta`` attributes); returns
    ``max(|Δα|/α₀, |Δβ|/β₀)``, the quantity a re-planner thresholds to
    invalidate a cached schedule.  A fingerprint with no usable wire constants (e.g.
    the static baseline's ``{"name": "static"}``) cannot drift — 0.0.
    """
    if isinstance(hardware, dict):
        a0, b0 = hardware.get("alpha"), hardware.get("beta")
    else:
        a0 = getattr(hardware, "alpha", None)
        b0 = getattr(hardware, "beta", None)
    if not a0 or not b0 or a0 <= 0 or b0 <= 0:
        return 0.0
    return max(abs(float(alpha) - a0) / a0, abs(float(beta) - b0) / b0)


def fit_hardware(profile, *, name: str | None = None,
                 base: cm.Hardware = cm.H100_NVLINK) -> cm.Hardware:
    """Calibrated ``Hardware`` from a ``profiler.ModelProfile``.

    α/β from the collective samples; effective FLOP/s (and bandwidth,
    when the profile counts bytes) from the dense step over its measured
    time.  Falls back to ``base`` for any quantity the profile cannot
    support (a single-worker run has no collective samples).
    """
    try:
        alpha, beta = fit_alpha_beta(profile.comm_samples)
    except ValueError:
        alpha, beta = base.alpha, base.beta
    if profile.t_step_dense > 0 and profile.flops_per_step > 0:
        flops = profile.flops_per_step / profile.t_step_dense
    else:
        flops = base.flops
    if profile.t_step_dense > 0 and profile.hbm_bytes_per_step > 0:
        hbm_bw = profile.hbm_bytes_per_step / profile.t_step_dense
    else:
        hbm_bw = base.hbm_bw
    return cm.Hardware(name=name or f"measured_{profile.arch}",
                       alpha=alpha, beta=beta, flops=flops, hbm_bw=hbm_bw)


def hybrid_hardware(profile, target: cm.Hardware, *,
                    name: str | None = None) -> cm.Hardware:
    """Measured interconnect on the target accelerator's compute spec.

    What-if planning: the wire α/β come from this profile's collective
    samples (the part a host can faithfully measure), compute/HBM rates
    from ``target``'s datasheet.  Useful when profiling runs on a slower
    host than the deployment accelerator — an honest all-measured fit
    there is so compute-bound that every layer plans dense (the fallback
    working as intended), which says nothing about the target.
    """
    try:
        alpha, beta = fit_alpha_beta(profile.comm_samples)
    except ValueError:
        alpha, beta = target.alpha, target.beta
    return cm.Hardware(name=name or f"{target.name}+measured_wire",
                       alpha=alpha, beta=beta, flops=target.flops,
                       hbm_bw=target.hbm_bw)
