"""Hand-written Hopper kernels for gradient selection (``csrc/``), their
plain PyTorch versions (``ref``) and the logic around them (``ops``).

Each wrapper counts its kernel launches in a plain integer attribute
(``wrapper.launches``), so a run can show that its path went through the
kernels; :func:`launch_counts` reads them and :func:`reset_launch_counts`
sets them to 0.
"""
from __future__ import annotations

from repro_torch.kernels.block_topk import block_topk
from repro_torch.kernels.ef_sparsify import (ef_accum_sparsify,
                                             ef_block_candidates,
                                             ef_select_pack)

WRAPPERS = {
    "block_topk": block_topk,
    "ef_select_pack": ef_select_pack,
    "ef_block_candidates": ef_block_candidates,
    "ef_accum_sparsify": ef_accum_sparsify,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
