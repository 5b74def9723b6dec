"""In-backprop wave exchange through autograd hooks — the counterpart of
``repro.pipeline.step``.

``wave_backward`` registers one ``register_post_accumulate_grad_hook``
per parameter leaf and runs ``loss.backward()``.  Each hook forms the
leaf's update ``u = lr·f32(g)`` (the ``off`` step's bits), drops the
leaf's ``.grad`` and, when it was the last leaf of its wave to land,
launches that wave's exchange (``exch.launch_bucket``: select and pack,
then start the collectives with ``async_op=True``).  Nothing waits on a
collective inside backprop, so the compute stream never queues behind
one; after backward every wave is finished in order (the waits, then
the scatter-means).  Exchanges key their per-leaf budgets off GLOBAL
flatten-order leaf ids and run one collective per leaf, so the result is
bitwise equal to the monolithic post-backward ``exchange``.

The hooks are removed when the call returns, and no leaf keeps a
``.grad``: a gradient left there would add into the next step's.

``waved_exchange`` is the same regrouping without hooks, after backprop
(``pipeline="async1"`` launches it before the next forward and finishes
it after the next backward: ``launch_waves`` / ``finish_waves``).

State-shape convention (``ExchangeStrategy.ef_tiers``): ``()`` (dense,
stateless), a tree of residuals (single-tier EF), or a ``{tier: tree}``
dict (two-tier EF).
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from repro_torch import tree
from repro_torch.core.lags import Launched, _wave_ids


# -- flat-state plumbing (the three EF layouts) ------------------------------

def flatten_state(state, tiers: Sequence[str] = ()):
    """Flat-list view of an EF state.  ``tiers`` comes from the exchange
    registration (``ExchangeStrategy.ef_tiers``): non-empty means the
    state is a tier-keyed dict of residual trees (the params tree may
    itself be a dict, so tier-ness is declared, not sniffed)."""
    if tiers:
        return {t: tree.leaves(state[t]) for t in tiers}
    if state == () or state is None:
        return ()
    return tree.leaves(state)


def unflatten_state(flat_state, treedef):
    if isinstance(flat_state, dict):
        return {t: tree.unflatten(treedef, v) for t, v in flat_state.items()}
    if flat_state == () or flat_state is None:
        return ()
    return tree.unflatten(treedef, flat_state)


def _slice_state(flat_state, ids):
    if flat_state == () or flat_state is None:
        return ()
    if isinstance(flat_state, dict):
        return {t: [v[i] for i in ids] for t, v in flat_state.items()}
    return [flat_state[i] for i in ids]


def _scatter_state(out_flat, wave_state, ids) -> None:
    if out_flat == () or out_flat is None:
        return
    if isinstance(out_flat, dict):
        for t in out_flat:
            for j, i in enumerate(ids):
                out_flat[t][i] = wave_state[t][j]
        return
    for j, i in enumerate(ids):
        out_flat[i] = wave_state[j]


def _empty_like(flat_state):
    if flat_state == () or flat_state is None:
        return ()
    if isinstance(flat_state, dict):
        return {t: [None] * len(v) for t, v in flat_state.items()}
    return [None] * len(flat_state)


# -- launch / finish ----------------------------------------------------------

def launch_waves(exch, waves: Sequence, flat_updates, flat_state,
                 axis_names, *, key=None) -> list[Launched]:
    """Launch every wave's exchange, in wave order, on flat lists."""
    out = []
    for w in waves:
        ids = _wave_ids(w)
        out.append(exch.launch_bucket(ids, [flat_updates[i] for i in ids],
                                      _slice_state(flat_state, ids),
                                      axis_names, key=key))
    return out


def finish_waves(launched: Sequence[Launched], waves: Sequence,
                 flat_state) -> tuple[list, object]:
    """Finish launched waves in wave order; returns (flat means, new
    flat state) over all leaves."""
    n = sum(len(_wave_ids(w)) for w in waves)
    flat_means: list = [None] * n
    new_flat = _empty_like(flat_state)
    for w, launch in zip(waves, launched):
        ids = _wave_ids(w)
        means, new_sub = launch.finish()
        for j, i in enumerate(ids):
            flat_means[i] = means[j]
        _scatter_state(new_flat, new_sub, ids)
    return flat_means, new_flat


def waved_exchange(exch, waves: Sequence, updates, state, axis_names, *,
                   key=None, tiers: Sequence[str] = ()):
    """Post-backward per-wave exchange: every wave launched, then every
    wave finished.  Bitwise equal to ``exch.exchange(updates, state,
    ...)``."""
    flat_u, treedef = tree.flatten(updates)
    flat_state = flatten_state(state, tiers)
    launched = launch_waves(exch, waves, flat_u, flat_state, axis_names,
                            key=key)
    flat_means, new_flat = finish_waves(launched, waves, flat_state)
    return (tree.unflatten(treedef, flat_means),
            unflatten_state(new_flat, treedef))


# -- launch marks --------------------------------------------------------------

def _mark(device: torch.device):
    """(host clock, CUDA event recorded on the current stream or None)."""
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
    return time.perf_counter(), event


def launch_leads(marks: Sequence) -> list[dict]:
    """How long before the end of backward each wave launched, from the
    ``marks`` list ``wave_backward`` filled: per wave, ``host_ms`` on the
    host clock (when its hook ran) and ``device_ms`` between CUDA events
    on the stream (None on the CPU).  Read after the step's device sync:
    it waits for the events."""
    (end_t, end_ev), = [m[1:] for m in marks if m[0] == "end"]
    out = []
    for wave, t, ev in (m for m in marks if m[0] != "end"):
        out.append({"wave": wave, "host_ms": (end_t - t) * 1e3,
                    "device_ms": (None if ev is None
                                  else ev.elapsed_time(end_ev))})
    return out


# -- the hooks -------------------------------------------------------------------

def wave_backward(loss_fn: Callable, exch, waves: Sequence, params, state,
                  axis_names, *, lr, key=None, has_aux: bool = False,
                  tiers: Sequence[str] = (), marks: list | None = None):
    """Loss + in-backprop waved exchange.

    ``loss_fn(params) -> loss`` (or ``(loss, aux)`` with ``has_aux``);
    ``params``: a tree of leaf tensors that require grad and hold no
    ``.grad``; ``lr``: an f32 scalar tensor on their device.  Returns
    ``(loss_out, mean_updates_tree, new_state_tree)``: the exchanged f32
    mean update (apply as ``p - mean``) and the post-exchange EF state.
    ``marks``, when given, receives ``(wave index, host time, event)``
    as each wave launches and ``("end", ...)`` after backward (read with
    :func:`launch_leads`)."""
    flat_p, treedef = tree.flatten(params)
    flat_state = flatten_state(state, tiers)
    held = [i for i, p in enumerate(flat_p) if p.grad is not None]
    if held:
        raise ValueError(f"leaves {held} hold a .grad before the step; it "
                         f"would add into this step's gradient")
    wave_ids = [_wave_ids(w) for w in waves]
    wave_of = {i: wi for wi, ids in enumerate(wave_ids) for i in ids}
    left = [len(ids) for ids in wave_ids]
    updates: list = [None] * len(flat_p)
    launched: list = [None] * len(waves)

    def on_grad(i: int):
        def hook(p: torch.Tensor) -> None:
            with torch.no_grad():
                # EXACTLY the off step's update law: lr * f32(grad)
                updates[i] = p.grad.float().mul_(lr)
            p.grad = None
            wi = wave_of[i]
            left[wi] -= 1
            if left[wi]:
                return
            ids = wave_ids[wi]
            with torch.no_grad():
                launched[wi] = exch.launch_bucket(
                    ids, [updates[j] for j in ids],
                    _slice_state(flat_state, ids), axis_names, key=key)
            for j in ids:
                updates[j] = None
            if marks is not None:
                marks.append((wi,) + _mark(p.device))
        return hook

    handles = [p.register_post_accumulate_grad_hook(on_grad(i))
               for i, p in enumerate(flat_p)]
    try:
        out = loss_fn(params)
        loss = out[0] if has_aux else out
        loss.backward()
    finally:
        for h in handles:
            h.remove()
        for p in flat_p:
            p.grad = None
    if marks is not None:
        marks.append(("end",) + _mark(loss.device))
    never = [wi for wi, launch in enumerate(launched) if launch is None]
    if never:
        raise RuntimeError(
            f"waves {never} never launched: leaves "
            f"{[i for wi in never for i in wave_ids[wi] if updates[i] is None]}"
            f" got no gradient")
    flat_means, new_flat = finish_waves(launched, waves, flat_state)
    return (out, tree.unflatten(treedef, flat_means),
            unflatten_state(new_flat, treedef))
