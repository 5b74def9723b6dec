"""Measured profiles of the real train step: the port of
``repro.autotune.profiler``, the same ``ModelProfile`` JSON.

Two kinds of measurement feed the fit and plan stages:

  * **collective micro-steps** — ``torch.distributed`` all-gather and
    all-reduce over the mesh's worker group at a sweep of message sizes,
    timed on the host clock after a device sync: the (nbytes, t) samples
    ``costfit`` turns into (α, β).  NCCL on the card, gloo on the CPU.
  * **train-step micro-steps** — the production step of
    ``launch.train.build_train_step`` (dense and the config's LAGS mode),
    timed over a few steps, each ended by a device sync (the reference's
    ``block_until_ready``).  There is no compiled cost analysis, so one
    more dense step runs under a dispatch mode, :class:`ByteCounterMode`,
    that counts its FLOPs (``torch.utils.flop_counter``'s formulas) and
    its device-memory bytes (``hbm_bytes_per_step``, the counterpart of
    XLA's "bytes accessed", from which ``costfit`` fits the device-memory
    rate).  Both are per card, as the reference's ``cost_analysis()`` of
    its partitioned program is: on a mesh with a 'model' axis the mode
    sees each op on ``DTensor`` operands and counts it on this rank's
    chunks.  The per-kind
    collective bytes of the LAGS step (``collective_bytes_lags``) stay
    empty until ``launch/hlo``'s counterpart (ROADMAP.md queue 1 item
    13e).

Per-leaf backward times are apportioned from the measured step: total
backward ≈ 2/3 of the dense step (fwd:bwd FLOPs 1:2 for matmul-dominated
nets), split across leaves by their analytic backward FLOPs
(4·d·tokens).  A trace (``trace=``: a ``torch.profiler`` capture or
the fake backend, ``repro_torch.observe``) replaces that split with its
measured per-leaf backward times, and the collective sweep with its
per-bucket collective samples, as the reference's ``trace=`` does.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.autotune import schedule as S
from repro_torch.core import lags

BWD_FRACTION = 2.0 / 3.0  # backward share of a fwd+bwd step (1:2 FLOPs)
DEFAULT_COMM_SIZES = (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device, *, warmup: int = 1,
           iters: int = 3) -> float:
    """Median host-clock seconds per call, each ended by a device sync."""
    for _ in range(warmup):
        fn()
        _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


# ---------------------------------------------------------------------------
# device-memory bytes of eager ops
# ---------------------------------------------------------------------------

#: ops that allocate without touching memory
_ALLOCATIONS = frozenset({"aten::empty", "aten::empty_strided",
                          "aten::empty_like", "aten::new_empty",
                          "aten::new_empty_strided"})


def _tensors(tree) -> list:
    """The distinct tensors of a pytree of op arguments or results."""
    return list({id(x): x for x in tree_leaves(tree)
                 if isinstance(x, torch.Tensor)}.values())


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except RuntimeError:    # a wrapper (a collective's result) has none
        return -id(t)


def op_bytes(func, inputs, outputs) -> int:
    """Device-memory bytes of one dispatched op: ``numel · element_size``
    of each distinct tensor among its operands (read) and of each among
    its results (written), so an in-place op's tensor counts twice.  A
    view (``OpOverload.is_view``, or an op that writes nothing and
    returns only storage of its operands, as ``_unsafe_view``) and an
    allocation move nothing: 0."""
    if func._schema.name in _ALLOCATIONS or getattr(func, "is_view", False):
        return 0
    ins, outs = _tensors(inputs), _tensors(outputs)
    if not func._schema.is_mutable and outs and all(
            any(_storage(o) == _storage(i) for i in ins) for o in outs):
        return 0
    return sum(t.numel() * t.element_size() for t in ins + outs)


class ByteCounterMode(TorchDispatchMode):
    """Sums :func:`op_bytes` (``total``) and the FLOPs of
    ``torch.utils.flop_counter``'s formulas (``flops``: ``FlopCounterMode``'s
    count) over every aten op dispatched under it: the eager counterpart
    of XLA's per-op "bytes accessed" and "flops".  XLA counts the ops of
    the fused program, so it leaves out the intermediates that fusion
    keeps in registers; this count has every unfused pass of the eager
    step in it, and is larger.  An op on ``DTensor`` operands (the mode
    sees it before ``DTensor`` runs it) counts the card's own work: the
    bytes of this rank's chunks of its operands and results, and the
    FLOPs of the whole op over the ranks that split it (those its result
    is ``Shard`` or ``Partial`` over; a replicated result is computed
    whole on every rank)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        from repro_torch.sharding import dtensor as D
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out) // max(
                (D.split_ways(x) for x in tree_leaves(out)
                 if D.is_dtensor(x)), default=1)
        self.total += op_bytes(func, *tree_map(D.local,
                                               ((args, kwargs), out)))
        return out


# ---------------------------------------------------------------------------
# sample types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommSample:
    """One timed collective: ``nbytes`` per-worker payload (all-gather) or
    full buffer size (all-reduce), ``t`` seconds per op; ``label`` is
    per-bucket provenance (the α-β fit ignores it)."""
    kind: str
    nbytes: float
    p: int
    t: float
    label: str = ""


@dataclasses.dataclass(frozen=True)
class LeafSample:
    """One leaf's workload: measured ``t_backward`` (0.0 = not measured —
    the planner falls back to the analytic FLOPs estimate)."""
    name: str
    d: int
    backward_flops: float
    t_backward: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Everything ``costfit``/``planner`` need, JSON-serializable."""
    arch: str
    shape: str
    n_workers: int
    mesh_shape: tuple
    tokens_per_worker: float
    leaves: tuple[LeafSample, ...]          # backprop order (deepest first)
    comm_samples: tuple[CommSample, ...]
    t_step_dense: float = 0.0               # measured seconds
    t_step_lags: float = 0.0
    flops_per_step: float = 0.0             # per worker, one dense step
    hbm_bytes_per_step: float = 0.0
    collective_bytes_lags: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "ModelProfile":
        obj = json.loads(text)
        obj["leaves"] = tuple(LeafSample(**l) for l in obj["leaves"])
        obj["comm_samples"] = tuple(CommSample(**c)
                                    for c in obj["comm_samples"])
        obj["mesh_shape"] = tuple(obj["mesh_shape"])
        return ModelProfile(**obj)


# ---------------------------------------------------------------------------
# leaf structure (shared by the measured and analytic paths)
# ---------------------------------------------------------------------------

def backprop_leaves(cfg, tokens_per_worker: float) -> list[LeafSample]:
    """Backprop-ordered (reverse flatten order) leaves of the port's
    parameter tree, with analytic backward FLOPs (4·d·tokens)."""
    from repro_torch.models import transformer as T
    out = []
    for name, leaf in reversed(S.leaf_entries(T.abstract_params(cfg))):
        d = lags._size(leaf)
        out.append(LeafSample(name=name, d=d,
                              backward_flops=4.0 * d * tokens_per_worker))
    return out


def apportion_backward(leaves: Sequence[LeafSample],
                       t_backward_total: float) -> tuple[LeafSample, ...]:
    """Split a measured total backward time across leaves by FLOPs share."""
    total = sum(l.backward_flops for l in leaves) or 1.0
    return tuple(dataclasses.replace(
        l, t_backward=t_backward_total * l.backward_flops / total)
        for l in leaves)


# ---------------------------------------------------------------------------
# collective micro-steps
# ---------------------------------------------------------------------------

def time_collectives(mesh, axes: tuple[str, ...] | None = None,
                     sizes_bytes: Sequence[int] = DEFAULT_COMM_SIZES,
                     iters: int = 5) -> list[CommSample]:
    """Time all-gather and all-reduce over ``axes``' process group at
    each payload size (f32 zeros).  Every rank of the group must call
    it.  Returns [] on a single-worker mesh (nothing to time —
    ``costfit`` then falls back to its base hardware constants)."""
    from repro_torch.launch import mesh as M
    axes = tuple(axes) if axes is not None else M.data_axis_names(mesh)
    p = M.n_workers(mesh, axes)
    if p <= 1:
        return []
    group = M.worker_axes(mesh, axes).group
    dev = M.device_of(mesh)
    samples: list[CommSample] = []
    for nbytes in sizes_bytes:
        n = max(1, int(nbytes) // 4)
        x = torch.zeros((n,), dtype=torch.float32, device=dev)
        gathered = torch.empty((p * n,), dtype=torch.float32, device=dev)
        summed = torch.zeros((n,), dtype=torch.float32, device=dev)
        t_ag = _timed(lambda: dist.all_gather_into_tensor(
            gathered, x, group=group), dev, iters=iters)
        t_ar = _timed(lambda: dist.all_reduce(summed, group=group), dev,
                      iters=iters)
        samples.append(CommSample("allgather", nbytes=4.0 * n, p=p, t=t_ag))
        samples.append(CommSample("allreduce", nbytes=4.0 * n, p=p, t=t_ar))
    return samples


# ---------------------------------------------------------------------------
# train-step micro-steps
# ---------------------------------------------------------------------------

def _time_step(cfg, mesh, batch, *, method, seq: int, iters: int,
               count_flops: bool = False) -> tuple[float, float, int]:
    """Build the production step once, time micro-steps of it; with
    ``count_flops`` also count one more step's FLOPs and device-memory
    bytes.  Returns (t_step, FLOPs, bytes), the counts 0 without
    ``count_flops``."""
    from repro_torch import api
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as TR
    dev = M.device_of(mesh)
    step_fn, _specs, _meta = api.build_train_step(
        cfg, mesh, api.RunConfig(mode=method, donate=False,
                                 chunk=min(1024, seq),
                                 loss_chunk=min(512, seq)))
    box = {"state": TR.init_state(cfg, mesh, method=method)[0]}

    def one():
        box["state"], _ = step_fn(box["state"], batch)

    t = _timed(one, dev, iters=iters)
    flops, nbytes = 0.0, 0
    if count_flops:
        with ByteCounterMode() as moved:
            one()
        _sync(dev)
        flops, nbytes = float(moved.flops), moved.total
    box.clear()
    return t, flops, nbytes


def profile_model(cfg, mesh, *, seq: int = 64, global_batch: int | None = None,
                  iters: int = 3,
                  comm_sizes: Sequence[int] = DEFAULT_COMM_SIZES,
                  arch: str | None = None,
                  shape_name: str = "profile", trace=None) -> ModelProfile:
    """Measured profile of one (cfg × input shape) on ``mesh``: micro-steps
    of the real train step in dense mode (compute calibration) and the
    config's LAGS mode, plus the collective sweep.  Every rank of the
    mesh calls it (the steps and collectives span them all).  On a mesh
    with a 'model' axis the workers are the data ranks (``n_workers``,
    ``tokens_per_worker``), ``mesh_shape`` carries 'model', the sweep
    runs over the data ranks of each model index, and the FLOPs and
    bytes are one card's (:class:`ByteCounterMode`).

    ``trace``: optional ``repro_torch.observe.Trace`` (a real capture or
    the deterministic fake backend).  When given, its per-leaf backward
    events replace the FLOPs-share apportionment (partial coverage
    splits the *remainder* by FLOPs share) and its per-bucket collective
    events replace the micro-benchmark sweep — the sweep only runs when
    the trace carried no usable collective samples (every rank must then
    pass a trace that decides alike, since the sweep spans them all)."""
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    manual = M.data_axis_names(mesh)
    n_w = M.n_workers(mesh, manual)
    global_batch = global_batch if global_batch is not None else 2 * n_w
    batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=0).batch(
        0, global_batch, seq, device=M.device_of(mesh))

    t_dense, flops, nbytes = _time_step(cfg, mesh, batch, method="dense",
                                        seq=seq, iters=iters,
                                        count_flops=True)
    t_lags = 0.0
    if cfg.train_mode != "dense":
        t_lags, _, _ = _time_step(cfg, mesh, batch, method=None, seq=seq,
                                  iters=iters)
    tokens_per_worker = global_batch * seq / n_w
    leaves = apportion_backward(backprop_leaves(cfg, tokens_per_worker),
                                BWD_FRACTION * t_dense)
    comm: tuple[CommSample, ...] = ()
    if trace is not None:
        from repro_torch.observe import attribution as A
        leaves = A.attribute_leaves(leaves, trace,
                                    t_backward_total=BWD_FRACTION * t_dense)
        # one profile fits ONE wire: prefer the flat data-parallel tier;
        # accept a lone other tier; a multi-tier trace with no flat tier
        # is ambiguous (two wires -> meaningless joint fit), so fall back
        # to the micro-benchmark sweep for the comm side
        tiers = A.comm_tiers(trace)
        if "flat" in tiers:
            comm = tuple(A.comm_samples(trace, tier="flat"))
        elif len(tiers) == 1:
            comm = tuple(A.comm_samples(trace, tier=tiers[0]))
    if not comm:
        comm = tuple(time_collectives(mesh, manual, comm_sizes))
    return ModelProfile(
        arch=arch or cfg.name, shape=shape_name, n_workers=n_w,
        mesh_shape=tuple(int(s) for s in mesh.mesh.shape),
        tokens_per_worker=tokens_per_worker, leaves=leaves,
        comm_samples=comm, t_step_dense=t_dense, t_step_lags=t_lags,
        flops_per_step=flops, hbm_bytes_per_step=float(nbytes))
