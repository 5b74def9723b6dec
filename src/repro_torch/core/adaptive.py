"""Adaptive per-layer compression-ratio selection — Eq. 18, a copy of
``repro.core.adaptive`` (pure Python).

For each layer l, the smallest compression ratio c^(l) whose predicted
exchange hides behind the backward computation of the layer that
pipelines behind it:

    c^(l) = min{ c_u, min{ c : t_comm^(l)(c) + t_spar^(l) <= t_comp^(l-1) } }

(The paper prints ``max{c_u, ...}``; c_u is an *upper* bound on the
ratio, so the consistent reading is min{c_u, ...}.)  By Cor. 2 a lower
c converges faster, so no layer is compressed more than it must be.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import comm_model as cm


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Static per-layer workload numbers used by the selection rule."""
    name: str
    d: int                 # parameter count of the layer
    backward_flops: float  # FLOPs of this layer's backward pass


def sparsification_overhead(d: int, hw: cm.Hardware) -> float:
    """t_spar^(l): compress + decompress as three streaming passes over
    the layer's gradient at device-memory bandwidth (the selection reads
    it once, the scatter touches k elements, one pass of margin for the
    error-feedback update)."""
    bytes_touched = 3 * 4 * d
    return bytes_touched / hw.hbm_bw


def choose_ratio(
    d: int,
    t_comp_budget: float,
    p: int,
    hw: cm.Hardware,
    c_upper: float = 1000.0,
    candidate_ratios: Sequence[float] = (1, 2, 4, 8, 16, 32, 64, 128, 256,
                                         512, 1000),
) -> float:
    """Smallest candidate c with t_comm(c) + t_spar <= t_comp_budget,
    capped at ``c_upper``; c = 1 means dense (no sparsification cost).

    Saturation: when every candidate up to the cap exceeds the budget
    (a zero budget for the last layer to communicate, or a slow wire),
    the rule returns ``min(c_upper, candidate_ratios[-1])``, never a
    candidate beyond ``c_upper``; that exchange then spills past its
    budget.  ``autotune.planner.plan_leaf`` adds the dense fallback."""
    t_spar = sparsification_overhead(d, hw)
    for c in candidate_ratios:
        if c > c_upper:
            break
        if c == 1:
            t = cm.allreduce_time(4 * d, p, hw)  # dense path has no t_spar
        else:
            t = cm.sparse_allgather_time(d, c, p, hw) + t_spar
        if t <= t_comp_budget:
            return float(c)
    return float(min(c_upper, candidate_ratios[-1]))


def choose_ratios(
    layers: Sequence[LayerProfile],
    p: int,
    hw: cm.Hardware,
    c_upper: float = 1000.0,
    efficiency: float = 0.45,
) -> dict[str, float]:
    """Per-layer ratios, ``layers`` in backprop order (deepest first).
    Layer l's budget is the next layer's backward time (t_comp^(l-1));
    the last layer to communicate has nothing to hide behind (budget 0),
    so it gets the cap."""
    out: dict[str, float] = {}
    for i, layer in enumerate(layers):
        if i + 1 < len(layers):
            budget = cm.layer_backward_time(layers[i + 1].backward_flops, hw,
                                            efficiency)
        else:
            budget = 0.0
        out[layer.name] = choose_ratio(layer.d, budget, p, hw, c_upper)
    return out


def uniform_ratio_for_target(d_total: int, t_target: float, p: int,
                             hw: cm.Hardware) -> float:
    """The c at which the whole-model sparse exchange fits ``t_target``:
    (p-1)(alpha + (d/c)·8·beta) <= t."""
    per_msg = t_target / max(p - 1, 1) - hw.alpha
    if per_msg <= 0:
        return math.inf
    return max(1.0, (d_total * 8 * hw.beta) / per_msg)
