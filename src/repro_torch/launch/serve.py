"""Serving launch: the prefill and decode steps of
``repro.launch.serve``.

No gradients, so no LAGS here.  Without a mesh everything runs on the
device that holds the parameters.  On a mesh with a ``model`` axis
(``launch.mesh.make_mesh(model=)``: ("data", "model") or ("pod",
"data", "model")) the steps run the reference's tensor-parallel layout
for every family, one process a rank:

  * the parameters are ``DTensor``s over 'model', laid out by the
    rules' tensor-parallel placements (:func:`serve_param_specs`;
    :func:`place_params` lays a full tree out,
    :func:`init_placed_params` builds one from a seed chunk by chunk);
  * FSDP serving: when a copy over 'model' alone would pass half of a
    card (:func:`needs_fsdp_serving`, the reference's rule) the specs
    add 'data' as the FSDP axis and the leaves rest as ('data',
    'model') chunks; each layer's leaves are gathered over 'data' to
    their tensor-parallel chunk just before the layer runs and freed
    after it (:func:`make_fetch`), so FSDP serving computes the
    'model'-only layout's numbers bit for bit;
  * the batch is split over the data axes when it divides by their
    ranks (each data rank its rows: ``cache_batch``), else every data
    rank serves every row; a step takes the global batch (and a VLM's
    patches or an encoder-decoder's frames) on every rank and returns
    the global logits, gathered over the data axes;
  * the decode states hold this rank's rows, each a ``DTensor`` over
    'model' (:func:`place_states`): the attention caches, self and
    cross, split on their slots (``cache_seq``) when their number
    divides by the 'model' size, else whole on every rank; Mamba's
    states on ``d_inner``; the mLSTM's and sLSTM's on their heads (a
    departure from the rules, which split them on ``head_dim``).
    Prefill hands back whole attention caches (every head, every slot)
    as plain tensors, which ``engine.pad_states_for_decode`` pads to the
    capacity, and the recurrent states as this rank's chunks; the decode
    step lays the caches out before its first token.  Decode attention
    runs on this rank's slots and combines the ranks' softmax
    statistics over 'model' (``models.attention.decode_attention``,
    ``cross_decode``); the recurrent layers run this rank's heads or
    channels on its chunk of the state (``models.xlstm``,
    ``models.ssm``).

:func:`check_mesh` refuses an xLSTM whose heads do not split over
'model'.  The steps' argument specs are ``meta`` tensors (shapes and
dtypes, no storage), the counterpart of the reference's
``ShapeDtypeStruct``s: a step applied to them on no mesh returns
``meta`` outputs of the right shapes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import resolve_device, tree
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import engine
from repro_torch.sharding import dtensor as D
from repro_torch.sharding import rules

#: one card's memory (an H100's 80 GB): a model-sharded copy of the
#: parameters past half of it needs FSDP serving
DEVICE_BYTES = 80 * 1024 ** 3


def serve_cfg(cfg, shape_name: str):
    """Long-context serving mode: gemma3's global layers fall back to the
    sliding window (documented deviation) so 500k decode is O(window)."""
    if shape_name == "long_500k" and cfg.local_global_period:
        return dataclasses.replace(cfg, local_global_period=None)
    return cfg


def _model_size(mesh) -> int | None:
    """The size of the mesh's 'model' axis (None: no mesh, or none)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return None
    return mesh.size(names.index("model"))


def needs_fsdp_serving(cfg, mesh) -> bool:
    """Whether a copy of the parameters sharded over 'model' alone would
    pass half of a card's memory (the reference's rule, at the card's
    size), so that serving would have to shard them over 'data' too."""
    tp = _model_size(mesh) or 1
    nbytes = cfg.param_count() * L.DTYPES[cfg.param_dtype].itemsize
    return nbytes / tp > 0.5 * DEVICE_BYTES


def tensor_parallel(cfg, mesh) -> bool:
    """Whether the steps run the tensor-parallel layout: a mesh with a
    'model' axis (every family)."""
    return _model_size(mesh) is not None


def fsdp(cfg, mesh) -> bool:
    """Whether the steps also shard the parameters over 'data' (FSDP
    serving): under :func:`tensor_parallel`, when
    :func:`needs_fsdp_serving`."""
    return tensor_parallel(cfg, mesh) and needs_fsdp_serving(cfg, mesh)


def check_mesh(mesh, cfg=None) -> None:
    """Raise for what serving on ``mesh`` cannot lay out: on a 'model'
    axis larger than one, an xLSTM whose heads do not split over it
    (its layers' local paths hold a rank's heads, and so do their decode
    states: :func:`place_states`), as ``models.xlstm`` raises for it.
    The reference serves such a model (its rules split the states on
    ``head_dim``); the registry's xLSTM configs have 4 heads, which
    split over a 'model' axis of 2."""
    tp = _model_size(mesh)
    if tp is None or tp == 1 or cfg is None or not cfg.xlstm_pattern:
        return
    if cfg.n_heads % tp:
        raise ValueError(
            f"serving {cfg.name} over a model axis of {tp}: its "
            f"{cfg.n_heads} heads do not split over it (the xLSTM layers "
            f"and their decode states hold a rank's heads)")


def _param_axes(cfg, mesh) -> tuple:
    """The sub-mesh axes the parameters are laid out over."""
    return D.PARAM_AXES_FSDP if fsdp(cfg, mesh) else (D.MODEL,)


def serve_param_specs(cfg, mesh, params_like=None):
    """Each parameter's spec on ``mesh`` (the reference's
    ``serve_param_specs``): 'model' by the config's tensor-parallel
    priority, and 'data' as the FSDP axis when
    :func:`needs_fsdp_serving`."""
    if params_like is None:
        params_like = T.abstract_params(cfg)
    return rules.tree_specs(params_like, T.logical_axes(cfg),
                            rules.mesh_axis_sizes(mesh), tp_axis="model",
                            fsdp_axis="data" if fsdp(cfg, mesh) else None,
                            tp_priority=TR._tp_priority(cfg))


def place_params(cfg, mesh, params):
    """The full tree ``params`` (the same numbers on every rank) laid out
    for the steps: under :func:`tensor_parallel` ``DTensor``s over
    'model', or under :func:`fsdp` over the ('data', 'model') sub-mesh
    (each rank keeps its chunk, nothing is communicated); else as it
    is.  Leaves that are already ``DTensor``s pass through."""
    if not tensor_parallel(cfg, mesh) or any(
            D.is_dtensor(p) for p in tree.leaves(params)):
        return params
    with torch.no_grad():
        placed = D.distribute(params, serve_param_specs(cfg, mesh), mesh,
                              _param_axes(cfg, mesh))
    return tree.map(lambda p: p.detach(), placed)


def init_placed_params(cfg, mesh, *, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` laid out as :func:`place_params`
    lays a full tree out, built a leaf at a time on ``device`` (a
    stacked leaf a layer at a time): each rank makes the whole leaf or
    layer, keeps its chunk and frees the rest, so that no card holds
    more than its chunks and one layer of one leaf (a model too large
    for one card: Jamba-v0.1 whole).  The draws are this function's own
    (``models.transformer.init_leaf`` a leaf or a layer at a time), the
    same on every rank and for every layout; without
    :func:`tensor_parallel` the full tree."""
    from torch.distributed.tensor import DTensor
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = L.DTYPES[cfg.param_dtype]
    shapes = T._shapes(cfg)
    like = T.abstract_params(cfg)
    flat, treedef = tree.flatten(like)
    specs = tree.flatten_up_to(treedef, shapes)
    stacked = ["/blocks/" in k for k in tree.leaf_paths(like)]
    tp = tensor_parallel(cfg, mesh)
    axes = _param_axes(cfg, mesh) if tp else ()
    sub = D.sub_mesh(mesh, axes) if tp else None
    pspecs = (tree.flatten_up_to(treedef, serve_param_specs(cfg, mesh))
              if tp else [(None,) * p.ndim for p in flat])

    def chunk(x, spec):
        return x if sub is None else D.chunk_of(x, spec, sub, axes)

    out = []
    with torch.no_grad():
        for (shape, init), spec, layers in zip(specs, pspecs, stacked):
            if layers:
                first = chunk(T.init_leaf((shape[1:], init), gen, dtype, dev),
                              spec[1:])
                local = first.new_empty((shape[0],) + tuple(first.shape))
                local[0] = first
                del first
                for t in range(1, shape[0]):
                    local[t] = chunk(T.init_leaf((shape[1:], init), gen,
                                                 dtype, dev), spec[1:])
            else:
                local = chunk(T.init_leaf((shape, init), gen, dtype, dev),
                              spec).contiguous()
            out.append(local if sub is None else DTensor.from_local(
                local, sub, rules.placements(spec, axes), run_check=False))
    return tree.unflatten(treedef, out)


def place_states(cfg, mesh, states):
    """Decode states (this rank's rows) as the decode step takes them
    under :func:`tensor_parallel`, each a ``DTensor`` over 'model':

      * an attention cache (self or cross) split on its slots when their
        number divides by the 'model' size (the rules' ``cache_seq``),
        else whole on every rank;
      * a Mamba state split on ``d_inner`` (the rules' ``inner``);
      * an mLSTM or sLSTM state split on its heads, where the rules
        split it on ``head_dim``: the local paths compute a rank's heads
        (``models.xlstm``), so holding the state by them needs no
        collective a layer a token; a card holds the same bytes either
        way (``engine.states_axes(by_heads=True)``).

    Plain leaves (prefill's whole caches, ``engine.init_states``' zeros)
    are cut to this rank's chunk; ``DTensor`` leaves (the recurrent
    states prefill hands back, the decode step's own) pass through."""
    if not tensor_parallel(cfg, mesh):
        return states
    flat, treedef = tree.flatten(states)
    if all(D.is_dtensor(x) for x in flat):
        return states
    from torch.distributed.tensor import DTensor
    sub = D.sub_mesh(mesh)
    specs = rules.tree_specs(states, engine.states_axes(cfg, by_heads=True),
                             {"model": sub.size()}, tp_axis="model",
                             tp_priority=TR._tp_priority(cfg))
    return tree.unflatten(treedef, [
        x if D.is_dtensor(x) else
        DTensor.from_local(D.chunk_of(x, spec, sub).contiguous(), sub,
                           rules.placements(spec), run_check=False)
        for x, spec in zip(flat, tree.flatten_up_to(treedef, specs))])


def make_fetch(cfg, mesh):
    """FSDP serving's gather (None without :func:`fsdp`): a tree of
    leaves on the ('data', 'model') sub-mesh -> the same leaves on the
    'model' sub-mesh, each this rank's chunks gathered over 'data' to
    its tensor-parallel chunk, exactly the chunk :func:`place_params`
    keeps without FSDP (``launch.train.DataShards.leaves`` for
    training).  The engine calls it on a layer's leaves just before the
    layer runs and drops the result after it."""
    if not fsdp(cfg, mesh):
        return None
    from torch.distributed.tensor import DTensor
    model_mesh = D.sub_mesh(mesh)
    data = M.worker_axes(mesh, ("data",))

    def leaf(p):
        if not D.is_dtensor(p) or p.device_mesh.ndim == 1:
            return p
        on_data, on_model = p.placements
        x = p.to_local()
        if on_data.is_shard():
            x = TR._gather_dim(x, on_data.dim, data)
        return DTensor.from_local(x, model_mesh, (on_model,),
                                  run_check=False)

    return lambda params: tree.map(leaf, params)


class _Rows:
    """The batch split of a tensor-parallel step: this rank's rows of the
    data axes' ranks when the batch divides by them, and the gather of
    every rank's rows back to the global batch."""

    def __init__(self, mesh):
        self.axes = M.worker_axes(mesh, M.data_axis_names(mesh))
        self.rank = dist.get_rank(self.axes.group)

    def split(self, b: int) -> bool:
        return self.axes.size > 1 and b % self.axes.size == 0

    def local(self, x):
        if not self.split(x.shape[0]):
            return x
        per = x.shape[0] // self.axes.size
        return x[self.rank * per:(self.rank + 1) * per]

    def whole(self, x, b: int):
        """``x`` (this rank's rows) gathered to the global ``b`` rows."""
        x = x.contiguous()
        if not self.split(b):
            return x
        out = x.new_empty((b,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.axes.group)
        return out


def _replicated():
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _plain(x):
    """A replicated ``DTensor``'s full tensor (plain tensors as they
    are)."""
    return x.full_tensor() if D.is_dtensor(x) else x


def state_specs(cfg, mesh, shape):
    """``meta`` stand-ins for decode: ``{"params", "states"}`` at
    ``shape``'s batch and capacity (an audio model's cross caches hold
    ``audio_frames(seq_len)`` slots), and the resolved serving config."""
    check_mesh(mesh, cfg)
    cfg = serve_cfg(cfg, shape.name)
    enc_len = SP.audio_frames(shape.seq_len) if cfg.frontend == "audio" \
        else 0
    states = engine.init_states(cfg, shape.global_batch, shape.seq_len,
                                L.DTYPES[cfg.dtype], enc_len=enc_len,
                                device="meta")
    return {"params": T.abstract_params(cfg), "states": states}, cfg


def make_serve_step(cfg, mesh, shape, *, chunk: int = 2048):
    """One-token decode step against a ``shape.seq_len`` cache.  Returns
    (fn(params, token, states, pos) -> (logits, states), arg specs);
    ``fn`` writes the states in place, as the reference's donated step
    does.  Under :func:`tensor_parallel` ``params`` are
    :func:`place_params`' tree, ``token`` the global (B, 1), ``states``
    this rank's (laid out by :func:`place_states` first, the tree
    returned), and the logits the global (B, V)."""
    sds, cfg2 = state_specs(cfg, mesh, shape)
    batch = SP.decode_batch_specs(cfg2, shape)
    specs = (sds["params"], batch["token"], sds["states"], batch["pos"])
    if not tensor_parallel(cfg2, mesh):
        def fn(params, token, states, pos):
            return engine.serve_step(params, cfg2, token, states, pos,
                                     chunk=chunk)
        return fn, specs
    rows, fetch = _Rows(mesh), make_fetch(cfg2, mesh)

    def fn(params, token, states, pos):
        states = place_states(cfg2, mesh, states)
        with _replicated():
            logits, states = engine.serve_step(
                params, cfg2, rows.local(token), states, pos, chunk=chunk,
                fetch=fetch)
        return rows.whole(_plain(logits), token.shape[0]), states

    return fn, specs


def make_prefill_step(cfg, mesh, shape, *, chunk: int = 1024):
    """Prompt prefill: returns (fn(params, batch) -> (logits, states),
    arg specs).  Resolves the same :func:`serve_cfg` rewrite
    :func:`state_specs` applies, so the caches prefill builds agree with
    the ones decode expects: under ``long_500k`` a gemma3 global layer
    prefills with the window it will decode with.  Under
    :func:`tensor_parallel` the batch is the global one, the logits the
    global (B, V), and the states this rank's rows: whole attention
    caches (plain tensors) and its chunks of the recurrent states
    (module docstring); ``batch["frontend_embeds"]`` (a VLM's patches,
    an encoder-decoder's frames) is the global one, cut to this rank's
    rows as the tokens are."""
    check_mesh(mesh, cfg)
    cfg = serve_cfg(cfg, shape.name)
    specs = (T.abstract_params(cfg), SP.train_batch_specs(cfg, shape))
    tp = tensor_parallel(cfg, mesh)
    rows = _Rows(mesh) if tp else None
    fetch = make_fetch(cfg, mesh)

    def fn(params, batch):
        front = batch.get("frontend_embeds")
        if not tp:
            return engine.prefill(params, cfg, batch["tokens"],
                                  frontend_embeds=front, chunk=chunk)
        with _replicated():
            logits, states = engine.prefill(
                params, cfg, rows.local(batch["tokens"]),
                frontend_embeds=None if front is None else rows.local(front),
                chunk=chunk, fetch=fetch)
        return rows.whole(_plain(logits), batch["tokens"].shape[0]), states

    return fn, specs
