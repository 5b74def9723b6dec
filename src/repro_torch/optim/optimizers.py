"""The optimizers of ``repro.optim.optimizers``.

``SGD`` runs the paper's Algorithm 1 mode: the learning rate is folded
into the update before the exchange, and the optimizer consumes the
exchanged delta.  ``AdamW`` is the "standard" mode: it takes raw
gradients and applies its own lr.  Both return the delta the caller
subtracts (``apply_deltas``); master math in f32, cast back to the
parameter dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class SGD:
    """Consumes pre-scaled deltas (paper mode) or raw grads with lr."""
    momentum: float = 0.0
    nesterov: bool = False

    def init(self, params):
        if self.momentum == 0.0:
            return ()
        return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def update(self, deltas, state, params=None, lr=1.0):
        """Returns (applied_deltas, new_state); the caller applies
        p - applied."""
        scaled = tree.map(lambda d: lr * d.float(), deltas)
        if self.momentum == 0.0:
            return scaled, state
        new_m = tree.map(lambda m, d: self.momentum * m + d, state, scaled)
        if self.nesterov:
            out = tree.map(lambda m, d: self.momentum * m + d, new_m, scaled)
        else:
            out = new_m
        return out, new_m


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Adam with decoupled weight decay; moments in f32, the bias
    corrections from the f32 step count, as the reference computes
    them."""
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"mu": tree.map(zeros, params), "nu": tree.map(zeros, params),
                "count": 0}

    def update(self, grads, state, params, lr=1e-3):
        """Returns (applied_deltas, new_state); the caller applies
        p - applied."""
        c = state["count"] + 1
        mu = tree.map(lambda m, g: self.b1 * m + (1 - self.b1) * g.float(),
                      state["mu"], grads)
        nu = tree.map(lambda v, g: self.b2 * v
                      + (1 - self.b2) * torch.square(g.float()),
                      state["nu"], grads)
        # the reference raises f32 betas to an f32 count
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** torch.tensor(c, dtype=f32)
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** torch.tensor(c, dtype=f32)

        def delta(m, v, p):
            d = (m / bc1.to(m.device)) / (torch.sqrt(v / bc2.to(v.device))
                                          + self.eps)
            if self.weight_decay:
                d = d + self.weight_decay * p.float()
            return lr * d

        return (tree.map(delta, mu, nu, params),
                {"mu": mu, "nu": nu, "count": c})


@torch.no_grad()
def apply_deltas(params, deltas):
    """p <- cast(f32(p) - d) for every leaf, in place (the port updates the
    live parameters rather than building a new tree, which saves one copy
    of the model); returns ``params``."""
    for p, d in zip(tree.leaves(params), tree.leaves(deltas)):
        p.copy_(p.float() - d)
    return params
