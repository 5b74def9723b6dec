"""SGD on parameter deltas (the paper's Algorithm 1 mode), as
``repro.optim.optimizers`` has it: the learning rate is folded into the
update before the exchange, and the optimizer consumes the exchanged
delta.  Master math in f32, cast back to the parameter dtype.

``AdamW`` is not ported yet (ROADMAP.md queue 1 item 13).
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


@torch.no_grad()
def apply_deltas(params, deltas):
    """p <- cast(f32(p) - d) for every leaf, in place (the port updates the
    live parameters rather than building a new tree, which saves one copy
    of the model); returns ``params``."""
    for p, d in zip(tree.leaves(params), tree.leaves(deltas)):
        p.copy_(p.float() - d)
    return params
