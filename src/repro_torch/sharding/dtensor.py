"""Parameters laid out over a mesh's 'model' axis as ``DTensor``s: the
port's counterpart of the reference's GSPMD auto axis.

The reference's distributed step is manual over the data axes and
leaves 'model' to GSPMD, which shards each parameter by its
``sharding.rules`` spec.  Here each leaf becomes a ``DTensor`` on the
mesh's 1-D 'model' sub-mesh with the placements of
``rules.placements(spec)``: ``Shard(i)`` on the dim the spec gives
'model', else ``Replicate()``.  Over the data axes the parameters stay
plain replicas, so each data rank takes its own gradient, as the
reference's manual worker does.

:func:`distribute` turns a full parameter tree (the same numbers on
every rank, e.g. ``from_jax_params(...).params``) into that tree with no
communication: each rank keeps its own chunk.  :func:`gather` is its
inverse, a ``full_tensor()`` all-gather per leaf.  Importing this module
touches no device or process group.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import tree
from repro_torch.sharding import rules

#: the mesh axis the parameters are sharded over
MODEL = "model"


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def model_mesh(mesh):
    """The mesh's 1-D 'model' sub-mesh, or None when it has no 'model'
    axis (the data-only layout: plain tensors, no DTensor)."""
    if MODEL not in (mesh.mesh_dim_names or ()):
        return None
    return mesh[MODEL]


def local_shape(shape, spec, tp: int) -> tuple:
    """The shape of one rank's chunk of a leaf of ``shape`` laid out by
    ``spec`` over a 'model' axis of ``tp`` ranks."""
    out = list(shape)
    i = rules.sharded_dim(spec, MODEL)
    if i is not None:
        if out[i] % tp:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {tp} model ranks")
        out[i] //= tp
    return tuple(out)


def distribute(params, specs, mesh):
    """The full tree ``params`` (every rank holding the same numbers, on
    the mesh's device) as ``nn.Parameter`` ``DTensor``s on the mesh's
    'model' sub-mesh, laid out by ``specs`` (``rules.tree_specs``): each
    rank keeps its own contiguous chunk; nothing is communicated."""
    from torch.distributed.tensor import DTensor
    sub = model_mesh(mesh)
    if sub is None:
        raise ValueError(f"the mesh {mesh.mesh_dim_names} has no "
                         f"{MODEL!r} axis")
    tp, m = sub.size(), sub.get_local_rank()
    flat, treedef = tree.flatten(params)

    def leaf(p, spec):
        i = rules.sharded_dim(spec, MODEL)
        chunk = p.detach() if i is None else p.detach().chunk(tp, dim=i)[m]
        return nn.Parameter(DTensor.from_local(
            chunk.contiguous(), sub, rules.placements(spec, MODEL),
            run_check=False), requires_grad=True)
    return tree.unflatten(treedef, [
        leaf(p, s) for p, s in zip(flat, tree.flatten_up_to(treedef, specs))])


def gather(params):
    """The full tensors of a tree of ``DTensor``s (``full_tensor()``: an
    all-gather over the 'model' ranks for each sharded leaf), detached;
    plain leaves pass through detached.  Every rank of the 'model' axis
    must call it, in the same order."""
    def leaf(p):
        with torch.no_grad():
            return p.full_tensor() if is_dtensor(p) else p.detach()
    return tree.map(leaf, params)


def local(x):
    """This rank's chunk of ``x`` (the tensor itself when plain)."""
    return x.to_local() if is_dtensor(x) else x


def grad_to_local(g, p):
    """A parameter's gradient ``g`` in the parameter's own layout, as this
    rank's chunk.  DTensor's backward gives most of them as ``Partial``
    sums over 'model' (a replicated weight, or a sharded one reached
    through a contraction): they are reduced to ``p``'s placements (a
    reduce-scatter to ``Shard``, an all-reduce to ``Replicate``) before
    any update is formed, so that no exchange selects among partial
    sums."""
    if not is_dtensor(g):
        return g
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g.to_local()
