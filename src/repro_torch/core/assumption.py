"""Empirical check of Assumption 1 — the delta^(l) metric of Eq. 20, as
``repro.core.assumption`` computes it:

    delta^(l) = || sum_p x^{p,(l)} - sum_p TopK(x^{p,(l)}, k) ||^2
              / || sum_p x^{p,(l)} - RandK(sum_p x^{p,(l)}, k) ||^2

Assumption 1 holds when delta^(l) <= 1 (the paper's Fig. 2).
``SimTrainer`` records it every step under ``RunConfig.measure_delta``.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import compressors as C


def delta_metric(xs: torch.Tensor, k: int, key: "C.Key | None",
                 n_rand: int = 4) -> torch.Tensor:
    """xs: (P, d) per-worker accumulated vectors of one layer.

    The RandK denominator is a random variable whose expectation has the
    closed form (1 - k/d)·||agg||^2 (Stich et al. 2018); ``n_rand`` draws
    (streams ``key.split(n_rand)``) are averaged and mixed 50/50 with
    it.  ``n_rand=0`` uses the closed form alone, and ``key`` may then
    be None."""
    p, d = xs.shape
    kk = min(k, d)
    agg = xs.sum(0)
    topk_agg = torch.stack([C.topk_dense(x, kk) for x in xs]).sum(0)
    num = ((agg - topk_agg) ** 2).sum()
    den = (1.0 - kk / d) * (agg ** 2).sum()
    if n_rand > 0:
        draws = torch.stack([((agg - C.randk_dense(agg, kk, sub)) ** 2).sum()
                             for sub in key.split(n_rand)])
        den = 0.5 * (draws.mean() + den)
    return num / torch.clamp(den, min=1e-30)


def delta_metric_tree(per_worker_acc, ks, key, n_rand: int = 4):
    """delta^(l) of every leaf (leaves shaped (P, ...)), leaf i's draws
    from ``key.fold_in(i)``; ``n_rand=0`` accepts ``key=None``."""
    flat, treedef = tree.flatten(per_worker_acc)
    flat_k = tree.flatten_up_to(treedef, ks)
    out = []
    for i, (x, k) in enumerate(zip(flat, flat_k)):
        sub = key.fold_in(i) if n_rand > 0 else None
        out.append(delta_metric(x.reshape(x.shape[0], -1), int(k), sub,
                                n_rand=n_rand))
    return tree.unflatten(treedef, out)
