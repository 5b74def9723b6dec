"""Data-parallel mesh over ``torch.distributed``: the counterpart of
``repro.launch.mesh``.

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` with the
dim name ``"data"`` over every rank of the default process group.  The
backend follows the device: NCCL for ``cuda``, gloo for ``cpu``; a
mismatch raises, with no fallback.  A ``model`` axis larger than 1
(tensor parallelism) is not ported yet.

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


def make_mesh(data: int | None = None, model: int = 1, *, device="cuda"):
    """The ("data",) mesh over the default process group.

    ``data`` defaults to the world size and must equal it; ``model`` must
    be 1.  The group must already be initialised with the device's
    backend."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism is not ported yet "
            f"(ROADMAP.md queue 1 item 7, its tensor-parallel tail)")
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "launch.mesh.init_process_group first")
    want, got = backend_for(dev), dist.get_backend()
    if got != want:
        raise ValueError(f"a {dev.type} mesh needs the {want} backend; the "
                         f"process group runs {got}")
    world = dist.get_world_size()
    data = world if data is None else data
    if data != world:
        raise ValueError(f"data={data} != world size {world}")
    return init_device_mesh(dev.type, (data,), mesh_dim_names=("data",))


def device_of(mesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_axis_names(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


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


def worker_axes(mesh, names: tuple[str, ...]) -> lags.Axes:
    """The exchange's :class:`~repro_torch.core.lags.Axes` for ``names``:
    one mesh dim and its process group."""
    if len(names) != 1:
        raise NotImplementedError(
            f"axes {names}: the exchange runs over exactly one mesh axis; "
            f"several (the pod hierarchy) are not ported yet (ROADMAP.md "
            f"queue 1 item 9)")
    return lags.Axes(tuple(names), mesh.get_group(names[0]))
