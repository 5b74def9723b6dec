"""Theoretical convergence-bound calculators (Lemma 1, Corollaries 1–2,
Eq. 15): a copy of ``repro.core.convergence`` (pure Python).

  * ``lemma1_contraction``: the (1 - 1/c_max) contraction factor.
  * ``corollary1_bound``: bound on E||v_t - x_t||^2.
  * ``corollary2_bound``: the O(1/sqrt(T)) + O(c_max^3/T) rate bound.
  * ``stepsize_condition_D``: the geometric-series constant D of Eq. 15
    for constant step sizes with eta = 1/c_max.
"""
from __future__ import annotations

import math
from typing import Sequence


def lemma1_contraction(ratios: Sequence[float]) -> float:
    c_max = max(ratios)
    return 1.0 - 1.0 / c_max


def tau(c_max: float, eta: float | None = None) -> float:
    eta = 1.0 / c_max if eta is None else eta
    return (1.0 - 1.0 / c_max) * (1.0 + eta)


def stepsize_condition_D(alpha: float, c_max: float,
                         eta: float | None = None) -> float:
    """D = alpha * tau / (1 - tau) for constant step size (Cor. 2 proof)."""
    t = tau(c_max, eta)
    assert t < 1.0, "need (1-1/c_max)(1+eta) < 1"
    return alpha * t / (1.0 - t)


def corollary1_bound(t: int, alpha: float, c_max: float, M: float,
                     eta: float | None = None) -> float:
    """E||v_t - x_t||^2 <= (1/eta) sum_i tau^i alpha^2 M^2 (constant alpha)."""
    eta = 1.0 / c_max if eta is None else eta
    tt = tau(c_max, eta)
    s = tt * (1.0 - tt ** t) / (1.0 - tt)
    return (1.0 / eta) * s * alpha * alpha * M * M


def corollary2_bound(T: int, theta: float, c_max: float, C: float, M: float,
                     f0_minus_fstar: float) -> float:
    """RHS of Eq. 17."""
    term1 = (4.0 / theta * f0_minus_fstar + 2.0 * theta * C * M * M) \
        / math.sqrt(T)
    term2 = 4.0 * C * C * M * M * (c_max ** 3 - c_max) * theta * theta / T
    return term1 + term2


def stepsizes_diverge_sum(alphas: Sequence[float]) -> tuple[float, float]:
    """(sum alpha, sum alpha^2): Eq. 16 needs the first to diverge and
    the second to stay finite as T grows."""
    return sum(alphas), sum(a * a for a in alphas)
