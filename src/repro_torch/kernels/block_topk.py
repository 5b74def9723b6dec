"""Per-row top-r by magnitude: the CUDA ``block_topk`` kernel's wrapper.

Replaces ``repro.kernels.block_topk.block_topk_pallas``: stage 1 of the
hierarchical top-k (``topk_hier`` under the kernel backend) and the
selection of ``topk_block_kernel``.  A CPU tensor runs the plain version
(``ref.block_topk_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: largest dynamic shared memory one block may use on the H100
SMEM_LIMIT = 232_448
DTYPES = (torch.float32, torch.bfloat16)


def check_rows(name: str, t: torch.Tensor, dtypes, shape=None) -> None:
    """Raise unless ``t`` is a contiguous 2-D CUDA tensor of an accepted
    dtype (and ``shape``, when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != 2 or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                         f"{shape or '2-D (rows, bs)'}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def check_k(name: str, k: int, bs: int, smem_bytes: int) -> None:
    if not 1 <= k <= bs:
        raise ValueError(f"{name}: k={k} outside [1, bs={bs}]")
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: a row of bs={bs} needs {smem_bytes} B of "
                         f"shared memory, above the {SMEM_LIMIT} B limit")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def block_topk(blocks: torch.Tensor, r: int):
    """(values (n, r) in ``blocks``' dtype, local indices (n, r) int32) of
    each row's top-``r`` by |x|, descending, ties to the lowest index."""
    if blocks.device.type == "cpu":
        return ref.block_topk_ref(blocks, r)
    check_rows("block_topk x", blocks, DTYPES)
    n, bs = blocks.shape
    check_k("block_topk", r, bs, 4 * bs)
    vals = torch.empty((n, r), dtype=blocks.dtype, device=blocks.device)
    idx = torch.empty((n, r), dtype=torch.int32, device=blocks.device)
    if n:
        with torch.cuda.device(blocks.device):
            err = build.lib().block_topk(
                blocks.data_ptr(), int(blocks.dtype == torch.bfloat16),
                vals.data_ptr(), idx.data_ptr(), n, bs, r, stream_of(blocks))
        build.check("block_topk", err)
        block_topk.launches += 1
    return vals, idx


block_topk.launches = 0
