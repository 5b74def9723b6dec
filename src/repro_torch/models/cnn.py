"""The paper's own CNN workload (ResNet-20 on Cifar-10 analogue) of
``repro.models.cnn``: a residual conv net of 3 stages × 3 blocks over a
parameter tree in the reference's layout.

    {"head": {"b", "w" (cin, classes)}, "s{s}b{b}": {"proj"?, "scale1",
     "scale2", "w1", "w2"}, "stem": {"w"}}

Weights stay HWIO ``(kh, kw, cin, cout)`` in the tree and images NHWC in
the batch, as in the reference, so a selection over a flattened leaf
picks the reference's entries; the forward permutes them to OIHW and
NCHW for ``F.conv2d`` (cuDNN convolutions on the card).  ``"SAME"``
padding is XLA's: at stride 2 the total pad ``max((ceil(H/s) − 1)·s + k
− H, 0)`` splits low = total // 2, high = the rest.  Each conv is
followed by batch statistics over (N, H, W) with the biased variance
(no running state), a per-channel scale and ReLU.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device, tree


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn-cifar"
    widths: tuple[int, ...] = (16, 32, 64)
    blocks_per_stage: int = 3          # ~ResNet-20: 3 stages x 3 blocks
    n_classes: int = 10
    channels: int = 3
    source: str = "paper §6 (ResNet-20/Cifar-10 analogue)"


def _layout(cfg: CNNConfig) -> dict:
    """Leaf specs ``(shape, init)``: a normal's scale, or "zeros"/"ones",
    in the reference's init order."""
    def conv(kh, kw, cin, cout):
        return (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin))
    out = {"stem": {"w": conv(3, 3, cfg.channels, cfg.widths[0])}}
    cin = cfg.widths[0]
    for s, width in enumerate(cfg.widths):
        for b in range(cfg.blocks_per_stage):
            stride = 2 if (b == 0 and s > 0) else 1
            blk = {"w1": conv(3, 3, cin, width), "w2": conv(3, 3, width, width),
                   "scale1": ((width,), "ones"), "scale2": ((width,), "ones")}
            if cin != width or stride != 1:
                blk["proj"] = conv(1, 1, cin, width)
            out[f"s{s}b{b}"] = blk
            cin = width
    out["head"] = {"w": ((cin, cfg.n_classes), math.sqrt(1.0 / cin)),
                   "b": ((cfg.n_classes,), "zeros")}
    return out


def _map(fn, specs):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in specs.items()}


def init_cnn(cfg: CNNConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random f32 parameters from ``seed`` (a ``torch.Generator`` on the
    device: the reference's distributions, not its draws)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(spec):
        shape, init = spec
        if init == "zeros":
            return torch.zeros(shape, device=dev)
        if init == "ones":
            return torch.ones(shape, device=dev)
        return torch.randn(shape, generator=gen, device=dev).mul_(init)

    return _map(make, _layout(cfg))


def abstract_params(cfg: CNNConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shapes, no storage)."""
    return _map(lambda spec: torch.empty(spec[0], device="meta"),
                _layout(cfg))


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """x (N, C, H, W); w HWIO -> (N, cout, ceil(H/s), ceil(W/s))."""
    kh, kw = w.shape[:2]
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _norm_act(x, scale):
    """Batch statistics over (N, H, W), the biased variance (jnp.var)."""
    mu = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), keepdim=True, correction=0)
    return F.relu((x - mu) * torch.rsqrt(var + 1e-5)
                  * scale[None, :, None, None])


def cnn_forward(params, cfg: CNNConfig, images):
    """images (N, H, W, C) -> logits (N, n_classes)."""
    x = conv2d(images.permute(0, 3, 1, 2), params["stem"]["w"])
    for s, _ in enumerate(cfg.widths):
        for b in range(cfg.blocks_per_stage):
            stride = 2 if (b == 0 and s > 0) else 1
            blk = params[f"s{s}b{b}"]
            h = conv2d(x, blk["w1"], stride)
            h = _norm_act(h, blk["scale1"])
            h = conv2d(h, blk["w2"])
            h = _norm_act(h, blk["scale2"])
            sc = conv2d(x, blk["proj"], stride) if "proj" in blk else x
            x = sc + h
    x = x.mean((2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


def cnn_loss(params, cfg: CNNConfig, batch):
    """Mean cross-entropy over ``batch`` = {"images" (N, H, W, C),
    "labels" (N,)}; aux ``{"acc"}``, the share of argmax == label."""
    logits = cnn_forward(params, cfg, batch["images"])
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"acc": acc}


class CNN(nn.Module):
    """Owns the parameter tree (``self.params``, nested dicts of
    ``nn.Parameter`` in the reference layout).  ``device`` defaults to
    ``cuda`` and raises without a card."""

    def __init__(self, cfg: CNNConfig, *, seed: int = 0, device="cuda",
                 params=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init_cnn(cfg, seed=seed, device=dev)
        self.params = tree.map(
            lambda t: nn.Parameter(t.to(dev), requires_grad=True), params)
        for path, p in zip(tree.leaf_paths(self.params),
                           tree.leaves(self.params)):
            self.register_parameter(path.replace("/", "__"), p)

    def forward(self, images):
        return cnn_forward(self.params, self.cfg, images)


def from_jax_params(np_tree, cfg: CNNConfig, *, device="cuda") -> CNN:
    """A :class:`CNN` holding the reference's parameters, given as a tree
    of numpy arrays (``jax.tree.map(np.asarray, params)``)."""
    return CNN(cfg, device=device, params=tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), np_tree))


def to_numpy_tree(module: CNN) -> dict:
    """The module's parameters as a tree of numpy arrays."""
    return tree.map(lambda p: p.detach().cpu().numpy(), module.params)
