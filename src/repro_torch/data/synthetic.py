"""Synthetic learnable data, as ``repro.data.synthetic`` has it:

  * ``MarkovLM``: sequences from a fixed random first-order Markov chain;
  * ``Blobs``: Gaussian-blob classification rendered as (H, W, C) images
    for the CNN (the paper's Cifar analogue);
  * ``lm_input_batch``: uniform-random tokens (throughput, not
    convergence).

Drawn with ``torch.Generator``s derived from (seed, step), so batches are
deterministic per step; they are not the reference's JAX draws (parity
tests feed both packages batches made with numpy).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@dataclasses.dataclass(frozen=True)
class MarkovLM:
    vocab: int
    seed: int = 0
    concentration: float = 0.3  # lower = sharper transitions

    def transition_matrix(self, device="cuda") -> torch.Tensor:
        dev = resolve_device(device)
        logits = torch.randn((self.vocab, self.vocab),
                             generator=_generator(dev, self.seed),
                             device=dev) / self.concentration
        return torch.softmax(logits, dim=-1)

    def sample(self, gen: torch.Generator, batch: int, seq_len: int,
               tm: torch.Tensor) -> torch.Tensor:
        tok = torch.randint(0, self.vocab, (batch,), generator=gen,
                            device=tm.device)
        out = [tok]
        for _ in range(seq_len - 1):
            tok = torch.multinomial(tm[tok], 1, generator=gen)[:, 0]
            out.append(tok)
        return torch.stack(out, dim=1)                       # (B, S)

    def batch(self, step: int, batch: int, seq_len: int,
              device="cuda") -> dict:
        dev = resolve_device(device)
        tm = self.transition_matrix(dev)
        gen = _generator(dev, (self.seed + 1) * 1_000_003 + step)
        toks = self.sample(gen, batch, seq_len + 1, tm)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def worker_batches(self, step: int, n_workers: int, per_worker: int,
                       seq_len: int, device="cuda") -> dict:
        """Leaves shaped (P, per_worker, seq_len): simulation layout."""
        b = self.batch(step, n_workers * per_worker, seq_len, device)
        return {k: v.reshape(n_workers, per_worker, *v.shape[1:])
                for k, v in b.items()}


@dataclasses.dataclass(frozen=True)
class Blobs:
    """K-class Gaussian blobs rendered as (H, W, C) f32 images: class
    ``y``'s image is a fixed random centre plus ``noise`` times a normal
    draw."""
    n_classes: int = 10
    image_size: int = 32
    channels: int = 3
    seed: int = 0
    noise: float = 0.6

    def centers(self, device="cuda") -> torch.Tensor:
        dev = resolve_device(device)
        return torch.randn((self.n_classes, self.image_size, self.image_size,
                            self.channels),
                           generator=_generator(dev, self.seed), device=dev)

    def batch(self, step: int, batch: int, device="cuda") -> dict:
        """{"images" (batch, H, W, C) f32, "labels" (batch,) int64}."""
        dev = resolve_device(device)
        gen = _generator(dev, (self.seed + 7) * 1_000_003 + step)
        y = torch.randint(0, self.n_classes, (batch,), generator=gen,
                          device=dev)
        x = self.centers(dev)[y] + self.noise * torch.randn(
            (batch, self.image_size, self.image_size, self.channels),
            generator=gen, device=dev)
        return {"images": x, "labels": y}

    def worker_batches(self, step: int, n_workers: int, per_worker: int,
                       device="cuda") -> dict:
        """Leaves shaped (P, per_worker, ...): simulation layout."""
        b = self.batch(step, n_workers * per_worker, device)
        return {k: v.reshape(n_workers, per_worker, *v.shape[1:])
                for k, v in b.items()}


def lm_input_batch(seed: int, batch: int, seq_len: int, vocab: int,
                   device="cuda") -> dict:
    """Uniform-random tokens (for throughput, not convergence):
    {"tokens", "labels"} (batch, seq_len), the labels shifted by one."""
    dev = resolve_device(device)
    toks = torch.randint(0, vocab, (batch, seq_len + 1),
                         generator=_generator(dev, seed), device=dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
