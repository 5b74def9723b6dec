"""Per-row top-r by magnitude: the CUDA ``block_topk`` kernel's wrapper.

Replaces ``repro.kernels.block_topk.block_topk_pallas``: stage 1 of the
hierarchical top-k (``topk_hier`` under the kernel backend) and the
selection of ``topk_block_kernel``.  A CPU tensor runs the plain version
(``ref.block_topk_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import build, ref

#: largest dynamic shared memory one block may use on the H100
SMEM_LIMIT = 232_448
DTYPES = (torch.float32, torch.bfloat16)
#: the per-row selections take k arg-max passes below this k and a radix
#: select from it on (``csrc/selection.cu``); every wrapper passes it to
#: its kernel.  Set from ``chip_smoke.py``'s pack sweep (61,952 rows of
#: 4096 f32; NVIDIA H100 80GB HBM3, 700.00 W), ms arg-max / radix:
#: ef_select_pack k 6: 1.0888 / 1.0989, k 7: 1.1579 / 1.1064, k 8:
#: 1.2356 / 1.1053; block_topk k 7: 0.8435 / 0.8802, k 8: 0.9538 /
#: 0.8818.  From k 8 on the radix path wins for both.
RADIX_MIN_K = 8
#: the radix path's histogram (the first digit's 11 bits), in ints
HIST_BINS = 2048


def check_rows(name: str, t: torch.Tensor, dtypes, shape=None) -> None:
    """Raise unless ``t`` is a contiguous 2-D CUDA tensor of an accepted
    dtype (and ``shape``, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 2 or (shape is not None and t.shape != shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                         f"{shape or '2-D (rows, bs)'}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def row_smem(k: int, bs: int, argmax_bytes: int, radix_min_k: int) -> int:
    """Dynamic shared memory of one row's block: ``argmax_bytes`` per entry
    on the arg-max path; on the radix path the f32 row (rounded up to 16
    B) and the larger of the sort's 64-bit keys (k rounded up to a power
    of two) and the histogram, which share their room."""
    if isinstance(radix_min_k, bool) or not isinstance(radix_min_k, int) \
            or radix_min_k < 1:
        raise ValueError(f"radix_min_k must be an int >= 1, got "
                         f"{radix_min_k!r}")
    if k < radix_min_k:
        return argmax_bytes * bs
    keys = 8 * (1 << max(0, k - 1).bit_length())
    return -(-4 * bs // 16) * 16 + max(keys, 4 * HIST_BINS)


def check_k(name: str, k: int, bs: int, smem_bytes: int) -> None:
    if not 1 <= k <= bs:
        raise ValueError(f"{name}: k={k} outside [1, bs={bs}]")
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: a row of bs={bs} needs {smem_bytes} B of "
                         f"shared memory, above the {SMEM_LIMIT} B limit")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(dev: torch.device):
    """The launch's device as the current one: a no-op context when it
    already is (entering ``torch.cuda.device`` costs two device switches
    per launch)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def block_topk(blocks: torch.Tensor, r: int, *,
               radix_min_k: int = RADIX_MIN_K):
    """(values (n, r) in ``blocks``' dtype, local indices (n, r) int32) of
    each row's top-``r`` by |x|, descending, ties to the lowest index.
    ``radix_min_k``: the kernel's crossover (the same result on both
    paths)."""
    if blocks.is_cpu:
        return ref.block_topk_ref(blocks, r)
    check_rows("block_topk x", blocks, DTYPES)
    n, bs = blocks.shape
    check_k("block_topk", r, bs, row_smem(r, bs, 4, radix_min_k))
    vals = torch.empty((n, r), dtype=blocks.dtype, device=blocks.device)
    idx = torch.empty((n, r), dtype=torch.int32, device=blocks.device)
    if n:
        with on_device(blocks.device):
            err = build.lib().block_topk(
                blocks.data_ptr(), int(blocks.dtype == torch.bfloat16),
                vals.data_ptr(), idx.data_ptr(), n, bs, r, radix_min_k,
                stream_of(blocks))
        build.check("block_topk", err)
        block_topk.launches += 1
    return vals, idx


block_topk.launches = 0
