"""Per-layer error-feedback (gradient residual) state — Algorithm 1 lines
7–8, as ``repro.core.error_feedback`` keeps it, on the port's ``tree``.

One residual per learnable tensor, in the parameters' tree structure.
Units are parameter deltas: the learning rate is folded in before
sparsification (acc_t = eps_{t-1} + alpha·G).
"""
from __future__ import annotations

import torch

from repro_torch import tree


def init_residuals(params, dtype=torch.float32):
    """Zero residuals shaped like ``params`` (leaves with ``shape``, and
    ``device`` when they have one)."""
    return tree.map(lambda p: torch.zeros(
        tuple(p.shape), dtype=dtype, device=getattr(p, "device", None)),
        params)


def accumulate(residuals, updates, lr):
    """acc_t = eps_{t-1} + alpha_{t-1}·G   (line 7)."""
    return tree.map(lambda e, g: e + lr * g.to(e.dtype), residuals, updates)


def split(acc, sparse_dense):
    """eps_t = acc_t - TopK(acc_t, k)   (line 8), given the dense
    sparsified TopK(acc) of each leaf."""
    return tree.map(lambda a, s: a - s, acc, sparse_dense)
