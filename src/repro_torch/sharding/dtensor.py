"""Parameters laid out over a mesh's 'model' axis as ``DTensor``s: the
port's counterpart of the reference's GSPMD auto axes.

The reference's distributed step is manual over the data axes and
leaves 'model' to GSPMD, which shards each parameter by its
``sharding.rules`` spec.  Here each leaf becomes a ``DTensor`` on the
mesh's 1-D 'model' sub-mesh with the placements of
``rules.placements(spec)``: ``Shard(i)`` on the dim the spec gives
'model', else ``Replicate()``.  Over the data axes the parameters stay
plain replicas, so each data rank takes its own gradient, as the
reference's manual worker does.  Under ``lags_hier`` the reference
leaves 'data' to GSPMD too (FSDP): its parameters are ``DTensor``s on
the pod's ('data', 'model') sub-mesh (``axes=PARAM_AXES_FSDP``), each
rank holding one 2-D block of each leaf, or on a mesh without a 'model'
axis on the pod's 'data' sub-mesh (``axes=("data",)``).

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
#: the sub-mesh axes of ``lags_hier``'s parameters (FSDP beside 'model')
PARAM_AXES_FSDP = ("data", MODEL)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_shape(shape, spec, sizes) -> tuple:
    """The shape of one rank's chunk of a leaf of ``shape`` laid out by
    ``spec``: ``sizes`` is the 'model' axis's size, or {axis: size} of
    every axis the leaf is laid out over (each dim the spec gives one of
    them splits by its size)."""
    if not isinstance(sizes, dict):
        sizes = {MODEL: sizes}
    out = list(shape)
    for axis, n in sizes.items():
        i = rules.sharded_dim(spec, axis)
        if i is None:
            continue
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {n} {axis} ranks")
        out[i] //= n
    return tuple(out)


def sub_mesh(mesh, axes=(MODEL,)):
    """The sub-mesh of ``axes`` (``(MODEL,)``; ``PARAM_AXES_FSDP``: the
    pod's ('data', 'model') sub-mesh; ``("data",)``: the pod's 'data'
    sub-mesh)."""
    names = mesh.mesh_dim_names or ()
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"the mesh {names} has no {missing[0]!r} axis")
    return mesh[tuple(axes)] if len(axes) > 1 else mesh[axes[0]]


def chunk_of(x, spec, sub, axes=(MODEL,)):
    """This rank's chunk of the full tensor ``x`` laid out by ``spec`` on
    the sub-mesh ``sub`` of ``axes`` (a view; no communication)."""
    for j, axis in enumerate(axes):
        i = rules.sharded_dim(spec, axis)
        if i is not None:
            x = x.chunk(sub.size(j), dim=i)[sub.get_local_rank(j)]
    return x


def distribute(params, specs, mesh, axes=(MODEL,)):
    """The full tree ``params`` (every rank holding the same numbers, on
    the mesh's device) as ``nn.Parameter`` ``DTensor``s on the mesh's
    sub-mesh of ``axes`` (the 'model' axis, ``PARAM_AXES_FSDP`` or
    'data'), laid
    out by ``specs`` (``rules.tree_specs``): each rank keeps its own
    contiguous chunk; nothing is communicated."""
    from torch.distributed.tensor import DTensor
    axes = tuple(axes)
    sub = sub_mesh(mesh, axes)
    flat, treedef = tree.flatten(params)

    def leaf(p, spec):
        chunk = chunk_of(p.detach(), spec, sub, axes)
        return nn.Parameter(DTensor.from_local(
            chunk.contiguous(), sub, rules.placements(spec, axes),
            run_check=False), requires_grad=True)
    return tree.unflatten(treedef, [
        leaf(p, s) for p, s in zip(flat, tree.flatten_up_to(treedef, specs))])


def gather(params):
    """The full tensors of a tree of ``DTensor``s (``full_tensor()``: an
    all-gather over the ranks of each leaf's sub-mesh, 'model' or the
    pod's ('data', 'model')), detached; plain leaves pass through
    detached.  Every rank of those sub-meshes must call it, in the same
    order."""
    def leaf(p):
        with torch.no_grad():
            return p.full_tensor() if is_dtensor(p) else p.detach()
    return tree.map(leaf, params)


def local(x):
    """This rank's chunk of ``x`` (the tensor itself when plain)."""
    return x.to_local() if is_dtensor(x) else x


def split_ways(x) -> int:
    """The number of ranks that split the work of the ``DTensor`` ``x``:
    the product of its mesh's sizes over the dims it is ``Shard`` or
    ``Partial`` on (1 when replicated over all of them)."""
    n = 1
    for j, pl in enumerate(x.placements):
        if pl.is_shard() or pl.is_partial():
            n *= x.device_mesh.size(j)
    return n


def chunk_bounds(x) -> list:
    """Per dim of the ``DTensor`` ``x`` (split evenly, as
    :func:`distribute` lays leaves out), this rank's chunk as (offset,
    length) in the full tensor."""
    mesh = x.device_mesh
    bounds = [[0, n] for n in x.shape]
    for j, pl in enumerate(x.placements):
        if pl.is_shard():
            b = bounds[pl.dim]
            b[1] //= mesh.size(j)
            b[0] += mesh.get_local_rank(j) * b[1]
    return [tuple(b) for b in bounds]


def local_of(full, like):
    """This rank's chunk of the full tensor ``full`` as the ``DTensor``
    ``like`` lays it out (a view; plain ``like``: ``full`` itself)."""
    if not is_dtensor(like):
        return full
    for d, (off, n) in enumerate(chunk_bounds(like)):
        full = full.narrow(d, off, n)
    return full


def local_entries(vals, idx, like):
    """Of the entries (``vals`` at flat indices ``idx``) into the full
    tensor that the ``DTensor`` ``like`` lays out, those in this rank's
    chunk, each at its flat index in the chunk (int64).  Plain ``like``:
    all of them, as they are."""
    if not is_dtensor(like):
        return vals, idx
    idx = idx.long()
    coords, rest = [], idx
    for n in reversed(like.shape):
        coords.append(rest % n)
        rest = rest // n
    keep = torch.ones_like(idx, dtype=torch.bool)
    flat = torch.zeros_like(idx)
    for c, (off, n) in zip(reversed(coords), chunk_bounds(like)):
        keep &= (c >= off) & (c < off + n)
        flat = flat * n + (c - off)
    return vals[keep], flat[keep]


def like_local(x, like):
    """``x`` (this rank's chunk) as a ``DTensor`` laid out as ``like``
    (plain ``like``: ``x`` itself)."""
    if not is_dtensor(like):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, like.device_mesh, like.placements,
                              run_check=False)


def grad_to_local(g, p):
    """A parameter's gradient ``g`` in the parameter's own layout, as this
    rank's chunk.  DTensor's backward gives many of them as ``Partial``
    sums over 'model' (a replicated weight, or a sharded one reached
    through a contraction; of TinyLlama's 12 leaves 9 on torch 2.13, 4
    on 2.11, the three norms among them; the rest come in their own
    placements or ``Replicate``; ``tests/test_torch_tp_modes.py``
    records them): they are reduced to ``p``'s placements (a
    reduce-scatter to ``Shard``, an all-reduce to ``Replicate``) before
    any update is formed, so that no exchange selects among partial
    sums.  A replicated parameter's ``Partial`` gradient has the
    parameter's local shape, so nothing downstream would catch a skipped
    reduction."""
    if not is_dtensor(g):
        return g
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g.to_local()
