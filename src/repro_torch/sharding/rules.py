"""Logical-axis -> mesh-axis resolution, as ``repro.sharding.rules``
has it for FSDP, without JAX.

Model code names every parameter's dims with logical axes
(``models.transformer.logical_axes``); ``spec_for_leaf`` turns them into
a spec for a mesh: one entry per dim, a mesh axis name or None (the
``PartitionSpec`` of the reference, as a tuple).  FSDP ('data' under
``lags_hier``) takes the first candidate dim, in ``FSDP_CANDIDATES``
order, that divides by the axis size.  Tensor parallelism (a 'model'
axis > 1) is ROADMAP.md queue 1 item 7's tail.

The port keeps its parameters replicated, but the exchange's block
layout follows these specs as the reference's does:
``BlockLAGSExchange`` lays the sharded dims of a leaf first
(``shard_dims_tree``), which decides which entries share a block.
"""
from __future__ import annotations

from typing import Any, Sequence

from repro_torch import tree

FSDP_CANDIDATES = ("embed", "vocab", "ffn", "inner", "expert_ffn", "heads",
                   "head_dim")


def spec_for_leaf(shape: Sequence[int], axes: Sequence[Any],
                  mesh_axis_sizes: dict[str, int], *,
                  fsdp_axis: str | None = None) -> tuple:
    """One leaf's logical axes -> a mesh axis (or None) per dim."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {axes}")
    spec: list[Any] = [None] * len(shape)
    fs = mesh_axis_sizes.get(fsdp_axis, 1) if fsdp_axis else 1
    if fs > 1:
        for name in FSDP_CANDIDATES:
            i = next((i for i, a in enumerate(axes)
                      if a == name and shape[i] % fs == 0), None)
            if i is not None:
                spec[i] = fsdp_axis
                break
    return tuple(spec)


def tree_specs(params, axes_tree, mesh_axis_sizes: dict[str, int],
               **kw) -> Any:
    """``spec_for_leaf`` over a parameter tree (leaves with ``shape``)
    and its logical-axes tree; returns the params' structure with a spec
    tuple at each leaf."""
    leaves, treedef = tree.flatten(params)
    axes = tree.flatten_up_to(treedef, axes_tree)
    return tree.unflatten(treedef, [
        spec_for_leaf(tuple(p.shape), a, mesh_axis_sizes, **kw)
        for p, a in zip(leaves, axes)])


def shard_dims_tree(params, specs, row_axes: tuple) -> Any:
    """Per leaf, the dims its spec shards over ``row_axes`` (in
    ``row_axes`` order): the reference's ``launch.train.shard_dims_tree``,
    what ``BlockLAGSExchange(shard_dims=...)`` takes."""
    treedef = tree.flatten(params)[1]

    def leaf(spec):
        out = [i for ax in row_axes for i, e in enumerate(spec)
               if ax in (e if isinstance(e, tuple) else (e,))]
        return tuple(dict.fromkeys(out))
    return tree.unflatten(treedef, [
        leaf(s) for s in tree.flatten_up_to(treedef, specs)])
