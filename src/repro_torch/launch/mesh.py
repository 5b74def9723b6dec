"""Data-parallel mesh over ``torch.distributed``: the counterpart of
``repro.launch.mesh``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every
rank of the default process group: 1-D ``("data",)``, or ``("pod",
"data")`` when it has more than one pod (the reference's
``make_host_mesh(pod=...)``), its ranks laid out pod-major.  Given a
``model`` size, the mesh gains a last ``"model"`` axis (``("data",
"model")`` or ``("pod", "data", "model")``), the fastest-varying rank
index, as the reference's ``make_host_mesh`` lays out its devices; the
parameters are then ``DTensor``s over it, or under ``lags_hier`` over
the pod's ("data", "model") sub-mesh (``sharding.dtensor.sub_mesh``),
and the data axes' worker group is that of the ranks of one model index
(:func:`worker_axes`).  A mesh
without a ``"model"`` axis creates no DTensor.  The backend follows the
device: NCCL for ``cuda``, gloo for ``cpu``; a mismatch raises, with no
fallback.

Nothing on a machine tells a program of its cluster, so the caller
starts the group itself (:func:`init_process_group`) with an address, a
world size and a rank.  Importing this module touches no device or
process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device
from repro_torch.core import lags

#: the process-group backend each device type takes
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    return BACKENDS[dev.type]


def init_process_group(init_method: str, world_size: int, rank: int,
                       device="cuda") -> None:
    """Join the default process group (``init_method`` e.g.
    ``tcp://localhost:<port>`` or ``file://<path>``) with the backend of
    ``device``; on ``cuda`` this process takes card ``rank %
    device_count`` first."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=world_size, rank=rank)


def make_mesh(data: int | None = None, model: int | None = None,
              pod: int = 1, *, device="cuda"):
    """The ("data",) mesh over the default process group, or the
    ("pod", "data") mesh when ``pod > 1``; with ``model`` given (1
    included), the same with a last "model" axis of that size.

    ``data`` defaults to the world size over ``pod·model``;
    ``pod·data·model`` must equal the world size.  The group must
    already be initialised with the device's backend."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "launch.mesh.init_process_group first")
    want, got = backend_for(dev), dist.get_backend()
    if got != want:
        raise ValueError(f"a {dev.type} mesh needs the {want} backend; the "
                         f"process group runs {got}")
    world = dist.get_world_size()
    tp = 1 if model is None else int(model)
    if pod < 1 or tp < 1 or world % (pod * tp):
        raise ValueError(f"pod={pod} x model={model} does not divide the "
                         f"world size {world}")
    data = world // (pod * tp) if data is None else data
    if pod * data * tp != world:
        raise ValueError(f"pod={pod} x data={data} x model={model} != world "
                         f"size {world}")
    shape, names = (data,), ("data",)
    if pod > 1:
        shape, names = (pod, data), ("pod", "data")
    if model is not None:
        shape, names = shape + (tp,), names + ("model",)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def device_of(mesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_axis_names(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def inner_axis_names(mesh) -> tuple[str, ...]:
    """The intra-pod ('inner' tier) worker axes: the data axis the
    hierarchical modes reduce (lags_hier) or sparsely exchange
    (lags_hier2) within a pod."""
    return tuple(a for a in mesh.mesh_dim_names if a == "data")


def lags_axis_names(mesh, train_mode: str) -> tuple[str, ...]:
    """Mesh axes acting as LAGS workers (sparse-exchange axes)."""
    if train_mode == "lags_dp":
        return data_axis_names(mesh)
    if train_mode in ("lags_hier", "lags_hier2"):
        return tuple(a for a in mesh.mesh_dim_names if a == "pod")
    return ()


def n_workers(mesh, axes: tuple[str, ...]) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in axes)


def _model_index_group(mesh, names: tuple[str, ...]):
    """The process group of the ranks that share this rank's model index
    over the axes ``names`` (every axis but 'model'), its ranks in the
    reference's worker order (row-major over ``names``: pod-major).  One
    group per model index, made once per mesh with
    ``dist.new_subgroups_by_enumeration`` (every rank makes all of them,
    in one order) and kept on the mesh."""
    groups = mesh.__dict__.setdefault("_worker_groups", {})
    if names not in groups:
        m = mesh.mesh_dim_names.index("model")
        ranks = mesh.mesh.movedim(m, 0).reshape(mesh.size(m), -1)
        groups[names] = dist.new_subgroups_by_enumeration(
            [r.tolist() for r in ranks])[0]
    return groups[names]


def worker_axes(mesh, names: tuple[str, ...]) -> lags.Axes | None:
    """The exchange's :class:`~repro_torch.core.lags.Axes` for ``names``
    (None when empty): one mesh dim and its process group; every dim of
    the mesh, whose group is the default one (``init_device_mesh`` lays
    the ranks out row-major, the reference's outer-major worker order);
    or, on a mesh with a 'model' axis, every other dim: the group of the
    ranks of this rank's model index (``_model_index_group``).  With
    several names, ``parts`` holds one ``Axes`` per name (its dim's
    group of this rank's coordinate)."""
    names = tuple(names)
    if not names:
        return None
    if len(names) == 1:
        return lags.Axes(names, mesh.get_group(names[0]))
    dims = tuple(mesh.mesh_dim_names)
    parts = tuple(worker_axes(mesh, (a,)) for a in names)
    if names == dims:
        if mesh.mesh.flatten().tolist() != list(range(
                dist.get_world_size())):
            raise ValueError("the mesh does not lay out every rank in order")
        return lags.Axes(names, dist.group.WORLD, parts=parts)
    if names == tuple(a for a in dims if a != "model") and "model" in dims:
        return lags.Axes(names, _model_index_group(mesh, names), parts=parts)
    raise NotImplementedError(
        f"axes {names} of the mesh {dims}: the exchange runs over one mesh "
        f"axis, over all of them, or over all but 'model'")
