"""Serving launch: the prefill and decode steps of
``repro.launch.serve``.

No gradients, so no LAGS here.  Without a mesh, or on a mesh without a
``model`` axis, everything runs on the device that holds the
parameters.  On a mesh with a ``model`` axis (``launch.mesh.make_mesh(
model=)``: ("data", "model") or ("pod", "data", "model")) the steps run
the reference's tensor-parallel layout, one process a rank:

  * the parameters are ``DTensor``s over 'model', laid out by the
    rules' tensor-parallel placements (:func:`serve_param_specs`, the
    reference's with no FSDP; :func:`place_params` lays a full tree
    out);
  * the batch is split over the data axes when it divides by their
    ranks (each data rank its rows: ``cache_batch``), else every data
    rank serves every row; a step takes the global batch on every rank
    and returns the global logits, gathered over the data axes;
  * the attention caches hold this rank's rows and, over 'model', its
    chunk of the sequence (``cache_seq``, when the capacity divides by
    the 'model' size; else the whole sequence on every 'model' rank):
    ``DTensor``s over 'model' (:func:`place_states`).  Prefill hands
    back whole caches (every head, every slot) as plain tensors, which
    ``engine.pad_states_for_decode`` pads to the capacity; the decode
    step lays them out before its first token, so that the chunks split
    the padded capacity.  Decode attention then runs on this rank's
    slots and combines the ranks' softmax statistics over 'model'
    (``models.attention.decode_attention``).

Serving over a 'model' axis larger than one covers the ``dense`` and
``moe`` families; the others, and FSDP serving (a model whose copy over
'model' would not fit a card: :func:`needs_fsdp_serving`), raise
(:func:`check_mesh`; ROADMAP.md queue 1 item 7f's second part).  The
steps' argument specs are ``meta`` tensors (shapes and dtypes, no
storage), the counterpart of the reference's ``ShapeDtypeStruct``s: a
step applied to them on no mesh returns ``meta`` outputs of the right
shapes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import engine
from repro_torch.sharding import dtensor as D
from repro_torch.sharding import rules

#: the model families served over a 'model' axis larger than one
TP_SERVE_FAMILIES = ("dense", "moe")
#: what is not served there yet
TP_SERVE_NEXT = ("ROADMAP.md queue 1 item 7f's second part, the "
                 "tensor-parallel part for serving the cross caches, the "
                 "recurrent states and FSDP serving")
#: one card's memory (an H100's 80 GB): a model-sharded copy of the
#: parameters past half of it would need FSDP serving
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
    'model' axis and a family of ``TP_SERVE_FAMILIES`` (the others keep
    the one-device path on a 'model' axis of one rank)."""
    return _model_size(mesh) is not None and cfg.family in TP_SERVE_FAMILIES


def check_mesh(mesh, cfg=None) -> None:
    """Raise for what serving on ``mesh`` does not run yet: on a 'model'
    axis larger than one, a family outside ``TP_SERVE_FAMILIES`` (and
    any family when ``cfg`` is None) or a model that would need FSDP
    serving."""
    tp = _model_size(mesh)
    if tp is None or tp == 1:
        return
    what = None
    if cfg is None or cfg.family not in TP_SERVE_FAMILIES:
        what = ("a model of no given family" if cfg is None else
                f"the {cfg.family} family ({cfg.name})")
    elif needs_fsdp_serving(cfg, mesh):
        what = f"{cfg.name}, whose copy over 'model' needs FSDP serving"
    if what is not None:
        raise NotImplementedError(
            f"serving {what} over a model axis of {tp}: tensor-parallel "
            f"serving covers the {', '.join(TP_SERVE_FAMILIES)} families "
            f"({TP_SERVE_NEXT})")


def serve_param_specs(cfg, mesh):
    """Each parameter's spec on ``mesh``: 'model' by the config's
    tensor-parallel priority (the reference's ``serve_param_specs``
    without FSDP, which :func:`check_mesh` refuses)."""
    return TR.param_pspecs(cfg, mesh, "dense")


def place_params(cfg, mesh, params):
    """The full tree ``params`` (the same numbers on every rank) laid out
    for the steps: ``DTensor``s over 'model' under
    :func:`tensor_parallel`, else as it is.  Leaves that are already
    ``DTensor``s pass through."""
    if not tensor_parallel(cfg, mesh) or any(
            D.is_dtensor(p) for p in tree.leaves(params)):
        return params
    with torch.no_grad():
        placed = D.distribute(params, serve_param_specs(cfg, mesh), mesh)
    return tree.map(lambda p: p.detach(), placed)


def place_states(cfg, mesh, states):
    """Decode states (this rank's rows; plain tensors, every slot) as
    the decode step takes them under :func:`tensor_parallel`: each
    attention cache a ``DTensor`` over 'model', split on its sequence dim
    when the capacity divides by the 'model' size (the rules'
    ``cache_seq``), else whole on every rank.  States already laid out
    (the decode step's own) pass through."""
    flat, treedef = tree.flatten(states)
    if not tensor_parallel(cfg, mesh) or D.is_dtensor(flat[0]):
        return states
    from torch.distributed.tensor import DTensor
    sub = D.sub_mesh(mesh)
    specs = rules.tree_specs(states, engine.states_axes(cfg),
                             {"model": sub.size()}, tp_axis="model",
                             tp_priority=TR._tp_priority(cfg))
    return tree.unflatten(treedef, [
        DTensor.from_local(D.chunk_of(x, spec, sub).contiguous(), sub,
                           rules.placements(spec), run_check=False)
        for x, spec in zip(flat, tree.flatten_up_to(treedef, specs))])


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
    rows = _Rows(mesh)

    def fn(params, token, states, pos):
        states = place_states(cfg2, mesh, states)
        with _replicated():
            logits, states = engine.serve_step(
                params, cfg2, rows.local(token), states, pos, chunk=chunk)
        return rows.whole(_plain(logits), token.shape[0]), states

    return fn, specs


def make_prefill_step(cfg, mesh, shape, *, chunk: int = 1024):
    """Prompt prefill: returns (fn(params, batch) -> (logits, states),
    arg specs).  Resolves the same :func:`serve_cfg` rewrite
    :func:`state_specs` applies, so the caches prefill builds agree with
    the ones decode expects: under ``long_500k`` a gemma3 global layer
    prefills with the window it will decode with.  Under
    :func:`tensor_parallel` the batch is the global one, the logits the
    global (B, V), and the states this rank's rows of whole caches
    (plain tensors; module docstring)."""
    check_mesh(mesh, cfg)
    cfg = serve_cfg(cfg, shape.name)
    specs = (T.abstract_params(cfg), SP.train_batch_specs(cfg, shape))
    tp = tensor_parallel(cfg, mesh)
    rows = _Rows(mesh) if tp else None

    def fn(params, batch):
        if not tp:
            return engine.prefill(
                params, cfg, batch["tokens"],
                frontend_embeds=batch.get("frontend_embeds"), chunk=chunk)
        with _replicated():
            logits, states = engine.prefill(
                params, cfg, rows.local(batch["tokens"]), chunk=chunk)
        return rows.whole(_plain(logits), batch["tokens"].shape[0]), states

    return fn, specs
