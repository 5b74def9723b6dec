"""LAGS-SGD — layer-wise adaptive gradient sparsification (Algorithm 1),
simulation surface.

``DenseExchange`` (Dense-SGD baseline) and ``LAGSExchange`` (the paper:
per-layer top-k with per-layer error feedback) share the bucket-stream
interface of ``repro.core.lags``:

    init(updates_like)                     -> state (residual tree)
    exchange(updates, state, axis_names)   -> (mean_update, new_state)
    exchange_bucket(wave, updates, state, axis_names)
                                           -> (means, new_state)

``updates`` are learning-rate-scaled gradients whose leaves carry a
leading P axis (one row per simulated worker); ``axis_names`` must be
None.  ``wave`` is a sequence of global flatten-order leaf ids (or has
``leaf_ids``).  The P workers of a leaf select in one call (one kernel
launch, P·n_blocks rows): rows are independent, so this equals the
reference's per-worker ``vmap``.

Not ported yet: the distributed surface (ROADMAP.md queue 1 item 7),
``SLGSExchange`` (item 8), ``BlockLAGSExchange`` (item 7) and the
hierarchical exchanges (item 9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from repro_torch import tree
from repro_torch.core import compressors as C


def _size(x) -> int:
    return int(math.prod(x.shape))


def ks_from_ratio(params, ratio: float) -> Any:
    """k^(l) = max(1, round(d^(l) / c)) per leaf (Python's ``round``)."""
    c = float(ratio)
    return tree.map(lambda x: max(1, int(round(_size(x) / c))), params)


def local_select(acc: torch.Tensor, k: int, compressor: C.Compressor, **kw):
    """Per worker: top-k of the accumulated update.  ``acc``: (P, ...).
    Returns (values (P, k'), indices (P, k'), residual (P, ...)) with
    residual = acc - TopK(acc)."""
    flat = acc.reshape(acc.shape[0], -1)
    vals, idx = compressor(flat, k, **kw)
    dense_sel = C.decompress(vals, idx, flat.shape[-1])
    return vals, idx, (flat - dense_sel).reshape(acc.shape)


def local_select_ef(u: torch.Tensor, e: torch.Tensor, k: int,
                    compressor: C.Compressor, **kw):
    """EF accumulate + select for the P workers of one leaf, fused when
    the compressor has a ``fused_select`` kernel (``acc = e + u`` never
    materializes); otherwise ``local_select(e + u, ...)``.  Either way

        e + u == scatter(values, indices) + residual
    """
    if compressor.needs_key:
        raise NotImplementedError(
            "key-needing compressors are not ported yet (ROADMAP.md "
            "queue 1 item 10)")
    if compressor.fused_select is not None:
        p = u.shape[0]
        vals, idx, resid = compressor.fused_select(
            u.reshape(p, -1), e.reshape(p, -1), k, **kw)
        return vals, idx, resid.reshape(e.shape)
    return local_select(e + u.to(e.dtype), k, compressor, **kw)


def _gathered_scatter_mean(vals_all, idx_all, d: int, p) -> torch.Tensor:
    """Sum every worker's sparse contribution into a dense d-vector, / P.

    ``index_add_`` sums duplicates in index order on the CPU and with
    atomics on CUDA; a run that claims bitwise results sets
    ``torch.use_deterministic_algorithms(True)``."""
    dense = torch.zeros((d,), dtype=vals_all.dtype, device=vals_all.device)
    dense.index_add_(0, idx_all.reshape(-1), vals_all.reshape(-1))
    return dense / p


def _wave_ids(wave) -> tuple[int, ...]:
    ids = getattr(wave, "leaf_ids", wave)
    return tuple(int(i) for i in ids)


def _sim_only(axis_names) -> None:
    if axis_names is not None:
        raise NotImplementedError(
            "the distributed exchange surface is not ported yet "
            "(ROADMAP.md queue 1 item 7); pass axis_names=None")


@dataclasses.dataclass(frozen=True)
class DenseExchange:
    """Vanilla S-SGD: mean of the dense updates over the P workers."""
    name: str = "dense"
    wave_granularity = "leaf"

    def init(self, updates_like):
        return ()

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Sequence[str] | None, *, key=None):
        _sim_only(axis_names)
        return [u.mean(0) for u in updates], state

    def exchange(self, updates, state, axis_names: Sequence[str] | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, state = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, state, axis_names)
        return tree.unflatten(treedef, means), state


@dataclasses.dataclass(frozen=True)
class LAGSExchange:
    """Layer-wise adaptive gradient sparsification (the paper).

    ``ks``: a tree matching the update tree, of per-leaf k^(l)."""
    ks: Any
    compressor_name: str = "topk_exact"
    residual_dtype: torch.dtype = torch.float32
    name: str = "lags"
    compressor_kwargs: tuple = ()
    wave_granularity = "leaf"

    @property
    def compressor(self) -> C.Compressor:
        return C.get_compressor(self.compressor_name)

    def init(self, updates_like):
        """One residual per simulated worker: leaves (P, ...) of zeros.
        ``updates_like`` leaves need ``shape`` and ``device``."""
        return tree.map(lambda s: torch.zeros(
            tuple(s.shape), dtype=self.residual_dtype, device=s.device),
            updates_like)

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Sequence[str] | None, *, key=None):
        """One wave: flat lists of the wave's leaves, global-id keyed."""
        _sim_only(axis_names)
        kw = dict(self.compressor_kwargs)
        comp = self.compressor
        flat_k = tree.leaves(self.ks)
        means, resids = [], []
        for i, u, e in zip(_wave_ids(wave), updates, state):
            p = u.shape[0]
            vals, idx, resid = local_select_ef(u, e, flat_k[i], comp, **kw)
            mean = _gathered_scatter_mean(vals, idx, _size(u[0]), p)
            means.append(mean.reshape(u.shape[1:]))
            resids.append(resid)
        return means, resids

    def exchange(self, updates, state, axis_names: Sequence[str] | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names)
        return tree.unflatten(treedef, means), tree.unflatten(treedef,
                                                              resids)
