"""The explicit 'model'-axis boundaries of the layers that run on local
tensors under tensor parallelism: the MoE layer (``models.moe``), the
mLSTM and sLSTM (``models.xlstm``) and the Mamba block (``models.ssm``),
in training and in serving (prefill and one-token decode).

DTensor has no sharding rule for these layers' dispatch, sorts, time
loops or scans, so each takes its leaves' local chunks on the 1-D
'model' mesh (:func:`local_leaves`) and crosses the ranks only through
the functions here, each an autograd function whose backward is its
forward's transpose:

  * :func:`tokens_local`: the replicated tokens as this rank's copy, the
    gradient declared ``Partial`` (each rank's share) or ``Replicate``;
  * :func:`model_sum`: each rank's partial output summed, consumed the
    same on every rank, so its gradient passes through;
    :func:`replicated_sum` sums in f32, casts back and returns a
    ``DTensor`` replicated over 'model';
  * :func:`all_sum`, :func:`model_mean`: partial sums summed in f32 and
    consumed by each rank's own share, so the gradient is summed too;
  * :func:`gather_last`: the chunks of the last dim gathered, the
    gradient reduce-scattered;
  * :func:`scatter_sum`: partial sums of tensors split along one dim,
    reduce-scattered to this rank's chunk, the gradients all-gathered;
  * :func:`split_pair`: this rank's chunks of both halves of a
    projection's output ``[a | b]`` whose columns are split over
    'model' as one leaf (``up_proj``, ``in_proj``): rank r holds
    columns r·2c … (r+1)·2c − 1, not a_r and b_r.

Serving adds two that carry the recurrent layers' decode states, held
by the heads or channels each rank computes:

  * :func:`state_local`: this rank's chunk of a state leaf (a
    ``DTensor`` over 'model', or a plain tensor as it is);
  * :func:`state_shard`: a chunk a rank computed, as a ``DTensor``
    split on ``dim`` over 'model' (plain at ``mesh=None``).

One boundary crosses a data axis instead: :func:`gather_rows`, every
rank's rows (dim 0) of a process group concatenated in rank order, the
gradient reduce-scattered back.  The MoE layer gathers an MoE token
group that spans a pod's 'data' ranks with it (``models.moe.TokenSpan``,
``lags_hier``): a redistribute of a ``DTensor`` to ``Replicate`` over
'data' would not do, its backward takes this rank's chunk of the
gradient and sums nothing.

``mesh=None`` (the data-only path) or a 'model' axis of one rank makes
each of them but :func:`model_sum` the identity on its input (the same
tensor, nothing communicated), so the local path runs the data-only
path's products in the same order, bit for bit.  Importing this module
touches no device or process group."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.dtensor import is_dtensor


def _single(mesh) -> bool:
    return mesh is None or mesh.size() == 1


def local_leaves(p, layout: dict, what: str):
    """(the 1-D 'model' mesh, this rank's chunk of each leaf) of a
    layer's ``DTensor`` leaves ``p``.  ``layout[name]``: the dim the
    reference's rules split the leaf on over 'model', or None
    (replicated; every such leaf here feeds only this rank's share of
    the layer, so its local view returns a ``Partial`` gradient).  On
    several ranks any other layout raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = next(iter(p.values())).device_mesh
    if mesh.ndim != 1:
        raise ValueError(f"{what} leaves on a {mesh.ndim}-D mesh: tensor "
                         f"parallelism lays them over one 'model' axis")
    want = {k: (Replicate(),) if d is None else (Shard(d),)
            for k, d in layout.items()}
    got = {k: tuple(v.placements) for k, v in p.items()}
    if mesh.size() > 1 and got != want:
        raise NotImplementedError(
            f"{what} leaves laid out as {got} over 'model': its local path "
            f"takes {want}, the reference's rules where every split width "
            f"divides by the 'model' size")
    return mesh, {k: v.to_local(grad_placements=(Partial(),))
                  if layout[k] is None else v.to_local()
                  for k, v in p.items()}


class _WholeGrad(torch.autograd.Function):
    """The identity on a ``DTensor`` whose gradient is made ``Replicate``
    (summed over the ranks) before it flows on."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate
        return grad.redistribute(grad.device_mesh,
                                 (Replicate(),) * grad.device_mesh.ndim)


def tokens_local(x, mesh, partial: bool):
    """The replicated tokens ``x`` (a ``DTensor``, or a plain tensor the
    same on every rank) as this rank's local copy; their gradient comes
    back as a ``Partial`` sum over 'model' when ``partial`` (each rank's
    share of the layer), else ``Replicate``.  Tokens that arrive
    ``Partial`` (a layer norm over a sharded dim gives ``Partial(avg)``)
    are summed, and their gradient is made whole first: the backward of
    that redistribute cannot take a ``Partial(sum)`` gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    whole = (Replicate(),) * mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, whole, run_check=False)
    elif tuple(x.placements) != whole:
        summed = any(pl.is_partial() for pl in x.placements)
        x = x.redistribute(x.device_mesh, whole)
        if summed:
            x = _WholeGrad.apply(x)
    return x.to_local(grad_placements=(Partial(),) * mesh.ndim if partial
                      else whole)


class _SumOver(torch.autograd.Function):
    """Each rank's partial sum, all-reduced over ``group``; the gradient
    of each partial is the sum's (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_sum(x, mesh):
    """The sum of every 'model' rank's partial output ``x`` (f32), used
    the same on every rank."""
    return _SumOver.apply(x, mesh.get_group())


def replicated_sum(out, mesh):
    """Each rank's partial output ``out``, summed over 'model' in f32
    and cast back, as a ``DTensor`` replicated over 'model'."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(model_sum(out.float(), mesh).to(out.dtype),
                              mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


class _AllSum(torch.autograd.Function):
    """All-reduce forward and backward: the sum of partial sums that each
    rank uses for its own share, so that each rank's gradient of the sum
    is partial too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_sum(x, mesh):
    """The sum over 'model' of the partial sums ``x``, in f32, cast back
    to ``x``'s dtype; each rank uses it for its own share."""
    if _single(mesh):
        return x
    return _AllSum.apply(x.float(), mesh.get_group()).to(x.dtype)


def model_mean(x, mesh):
    """The mean over 'model' of the ranks' ``x`` (means over equal-sized
    chunks: the mean over the whole), used for each rank's share."""
    if _single(mesh):
        return x
    return all_sum(x, mesh) / mesh.size()


class _GatherLast(torch.autograd.Function):
    """Every rank's chunk of the last dim, concatenated in rank order;
    the gradient reduce-scattered back to the chunks."""

    @staticmethod
    def forward(ctx, x, group, n: int):
        ctx.group, ctx.n = group, n
        y = x.movedim(-1, 0).contiguous()
        out = y.new_empty((n * y.shape[0],) + tuple(y.shape[1:]))
        dist.all_gather_into_tensor(out, y, group=group)
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        y = grad.movedim(-1, 0).contiguous()
        out = y.new_empty((y.shape[0] // ctx.n,) + tuple(y.shape[1:]))
        dist.reduce_scatter_tensor(out, y, op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out.movedim(0, -1), None, None


def gather_last(x, mesh):
    """The whole last dim of ``x``, whose chunks the 'model' ranks hold,
    on every rank; each rank's gradient of it is partial."""
    if _single(mesh):
        return x
    return _GatherLast.apply(x, mesh.get_group(), mesh.size())


class _GatherRows(torch.autograd.Function):
    """Every rank's rows (dim 0) of ``group``, concatenated in rank
    order; the gradient reduce-scattered back to the rows."""

    @staticmethod
    def forward(ctx, x, group, n: int):
        ctx.group, ctx.n = group, n
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // ctx.n,)
                             + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad, op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out, None, None


def gather_rows(x, group, n: int):
    """The rows of every one of the ``n`` ranks of ``group`` (a plain
    tensor each, the same shape on every rank), concatenated along dim 0
    in group-rank order, on every rank; each rank's gradient of it flows
    back summed over the ranks to the rows it came from."""
    if n == 1:
        return x
    return _GatherRows.apply(x, group, n)


def split_pair(x, mesh):
    """(a_r, b_r): this rank's chunks of both halves of ``[a | b]``, the
    output of a projection whose columns are split over 'model' (``x``
    holds this rank's columns; at one rank ``torch.chunk(x, 2, -1)``)."""
    if _single(mesh):
        return torch.chunk(x, 2, dim=-1)
    full = gather_last(x, mesh)
    half = full.shape[-1] // 2
    c, r = half // mesh.size(), mesh.get_local_rank()
    return full[..., r * c:(r + 1) * c], full[..., half + r * c:
                                              half + (r + 1) * c]


class _ScatterSum(torch.autograd.Function):
    """Partial sums ``xs``, each split along ``dim`` into n chunks: one
    reduce-scatter gives this rank the sum of its chunk of each; the
    gradients are all-gathered back."""

    @staticmethod
    def forward(ctx, group, n: int, dim: int, *xs):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        ctx.shapes = [x.movedim(dim, 0).shape for x in xs]
        flat = torch.cat([x.movedim(dim, 0).reshape(n, -1) for x in xs],
                         dim=1)
        out = flat.new_empty(flat.shape[1])
        dist.reduce_scatter_tensor(out, flat.reshape(-1),
                                   op=dist.ReduceOp.SUM, group=group)
        sizes = [s.numel() // n for s in ctx.shapes]
        return tuple(o.view((s[0] // n,) + tuple(s[1:])).movedim(0, dim)
                     .contiguous()
                     for o, s in zip(out.split(sizes), ctx.shapes))

    @staticmethod
    def backward(ctx, *grads):
        n, dim = ctx.n, ctx.dim
        flat = torch.cat([g.movedim(dim, 0).reshape(-1) for g in grads])
        out = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=ctx.group)
        sizes = [s.numel() // n for s in ctx.shapes]
        return (None, None, None) + tuple(
            o.reshape(s).movedim(0, dim) for o, s in
            zip(out.view(n, -1).split(sizes, dim=1), ctx.shapes))


def scatter_sum(xs, dim: int, mesh) -> tuple:
    """Partial sums ``xs`` (tensors, each split along ``dim`` into the
    'model' ranks' chunks) -> the sum of this rank's chunk of each."""
    if _single(mesh):
        return tuple(xs)
    return _ScatterSum.apply(mesh.get_group(), mesh.size(), dim, *xs)


def state_local(x):
    """This rank's chunk of a decode state leaf ``x`` (its local tensor
    when a ``DTensor``; a plain tensor as it is)."""
    return x.to_local() if is_dtensor(x) else x


def state_shard(x, mesh, dim: int):
    """``x``, this rank's chunk of a decode state split on ``dim`` over
    'model', as a ``DTensor`` on ``mesh`` (the 1-D 'model' mesh); ``x``
    itself when ``mesh`` is None (the one-device path)."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(x, mesh, (Shard(dim),), run_check=False)
