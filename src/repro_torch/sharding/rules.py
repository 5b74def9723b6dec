"""Logical-axis -> mesh-axis resolution, as ``repro.sharding.rules`` has
it, without JAX.

Model code names every parameter's dims with logical axes
(``models.transformer.logical_axes``); ``spec_for_leaf`` turns them into
a spec for a mesh: one entry per dim, a mesh axis name, a tuple of them
or None (the ``PartitionSpec`` of the reference, as a tuple).  Its
passes run in the reference's order:

  * ``cache_batch`` dims over the data axes (caches and activations);
  * tensor parallelism: the first logical axis of ``tp_priority`` on the
    leaf whose dim divides by the ``tp_axis`` size takes ``tp_axis``
    (``TP_PRIORITY``, or ``TP_PRIORITY_EXPERTS`` for a config whose
    ``moe_shard`` is "experts");
  * FSDP ('data' under ``lags_hier``): the first still unsharded dim, in
    ``FSDP_CANDIDATES`` order, that divides by the axis size.

The port lays its parameters out by these specs on a mesh with a 'model'
axis: each leaf is a ``DTensor`` over the mesh's 'model' dim, or under
``lags_hier`` over the pod's ('data', 'model') sub-mesh, with the
placements of :func:`placements` (``sharding.dtensor``).  On a mesh
without a 'model' axis FSDP over 'data' stays a block layout only: the
parameters are replicated over 'data', but the exchange's blocks follow
the FSDP specs, as the reference's do: ``BlockLAGSExchange`` lays the
sharded dims of a leaf first (``shard_dims_tree``), which decides which
entries share a block.
"""
from __future__ import annotations

from typing import Any, Sequence

from repro_torch import tree

# "expert_ffn" outranks "experts": the reference shards expert weights on
# d_ff so that the dispatch buffers stay unsharded
TP_PRIORITY = ("vocab", "expert_ffn", "ffn", "inner", "heads",
               "kv_heads", "head_dim", "cache_seq", "experts")
# the expert-sharded variant (cfg.moe_shard == "experts")
TP_PRIORITY_EXPERTS = ("experts", "vocab", "ffn", "expert_ffn", "inner",
                       "heads", "kv_heads", "head_dim", "cache_seq")
FSDP_CANDIDATES = ("embed", "vocab", "ffn", "inner", "expert_ffn", "heads",
                   "head_dim")


def spec_for_leaf(shape: Sequence[int], axes: Sequence[Any],
                  mesh_axis_sizes: dict[str, int], *, tp_axis: str = "model",
                  fsdp_axis: str | None = None,
                  data_axes: tuple[str, ...] = (),
                  tp_priority: tuple = TP_PRIORITY) -> tuple:
    """One leaf's logical axes -> a mesh axis (a tuple of them, or None)
    per dim: the reference's ``spec_for_leaf``."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {axes}")
    spec: list[Any] = [None] * len(shape)
    used: set[str] = set()
    for i, a in enumerate(axes):
        if a == "cache_batch" and data_axes:
            n = 1
            for ax in data_axes:
                n *= mesh_axis_sizes[ax]
            if shape[i] % n == 0:
                # one axis as its name, as a PartitionSpec normalises it
                spec[i] = (tuple(data_axes) if len(data_axes) > 1
                           else data_axes[0])
                used.update(data_axes)
    tp = mesh_axis_sizes.get(tp_axis, 1)
    if tp > 1 and tp_axis not in used:
        i = _first_dim(shape, axes, spec, tp_priority, tp)
        if i is not None:
            spec[i] = tp_axis
            used.add(tp_axis)
    fs = mesh_axis_sizes.get(fsdp_axis, 1) if fsdp_axis else 1
    if fs > 1 and fsdp_axis not in used:
        i = _first_dim(shape, axes, spec, FSDP_CANDIDATES, fs)
        if i is not None:
            spec[i] = fsdp_axis
    return tuple(spec)


def _first_dim(shape, axes, spec, names, size: int) -> int | None:
    """The first unsharded dim, by ``names`` priority, whose logical axis
    is that name and whose length divides by ``size``."""
    for name in names:
        for i, a in enumerate(axes):
            if a == name and spec[i] is None and shape[i] % size == 0:
                return i
    return None


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


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``size(i)``)."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def sharded_dim(spec, axis: str = "model") -> int | None:
    """The dim a spec shards over ``axis`` (None: replicated over it)."""
    dims = [i for i, e in enumerate(spec) if axis in _names(e)]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards {len(dims)} dims over {axis}")
    return dims[0] if dims else None


def placements(spec, axes="model") -> tuple:
    """The ``DTensor`` placements of a leaf on the sub-mesh of ``axes``
    (one axis name, or a tuple of them in the sub-mesh's dim order): per
    axis, ``Shard(i)`` for the dim the spec shards over it, else
    ``Replicate()``.  Axes of the spec outside ``axes`` are not placed."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in ((axes,) if isinstance(axes, str) else tuple(axes)):
        i = sharded_dim(spec, axis)
        out.append(Replicate() if i is None else Shard(i))
    return tuple(out)


def shard_dims_tree(params, specs, row_axes: tuple) -> Any:
    """Per leaf, the dims its spec shards over ``row_axes`` (in
    ``row_axes`` order): the reference's ``launch.train.shard_dims_tree``,
    what ``BlockLAGSExchange(shard_dims=...)`` takes."""
    treedef = tree.flatten(params)[1]

    def leaf(spec):
        out = [i for ax in row_axes for i, e in enumerate(spec)
               if ax in _names(e)]
        return tuple(dict.fromkeys(out))
    return tree.unflatten(treedef, [
        leaf(s) for s in tree.flatten_up_to(treedef, specs)])
