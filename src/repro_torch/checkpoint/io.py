"""Checkpointing: tree <-> .npz with a JSON sidecar, the format of
``repro.checkpoint.io``.

One ``<path>.npz`` holds every leaf under its ``/``-joined key path (in
flatten order, the reference's keypaths), and ``<path>.json`` holds
``{"keys": sorted keys, "metadata": ...}``.  Leaves may be tensors (any
device; written from the host), numpy arrays or Python scalars.

numpy has no bfloat16.  The reference writes its bf16 leaves through
``ml_dtypes``, whose arrays land in the ``.npz`` as 2-byte ``'<V2'``
records; the port writes a bf16 tensor's 16 bits the same way (the same
``.npy`` header, the same bytes) and reads a ``'<V2'`` record back
through ``uint16`` into ``torch.bfloat16``, so a checkpoint crosses
between the packages bit for bit.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from repro_torch import tree
from repro_torch.sharding import dtensor as D

#: the ``.npy`` header dtype of a bf16 leaf (``ml_dtypes.bfloat16``'s)
BF16_DESCR = "<V2"


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(leaf) -> np.ndarray:
    """The host array of one leaf; a bf16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree_) -> dict:
    """{key path: leaf} in flatten order (leaves as given)."""
    return dict(zip(tree.leaf_paths(tree_), tree.leaves(tree_)))


def _write_member(zf: zipfile.ZipFile, key: str, leaf) -> None:
    arr = _to_numpy(leaf)
    bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        if not bf16:
            np.lib.format.write_array(f, np.asanyarray(arr),
                                      allow_pickle=False)
            return
        arr = np.ascontiguousarray(arr)
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def save(path: str, tree_, metadata: dict | None = None) -> None:
    """Write ``<path>.npz`` (``np.savez``'s layout: stored, one ``.npy``
    member per leaf) and the ``<path>.json`` sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten_with_paths(tree_)
    with zipfile.ZipFile(_npz(path), "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in flat.items():
            _write_member(zf, key, leaf)
    meta = {"keys": sorted(flat), "metadata": metadata or {}}
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(meta, f)


def load_arrays(path: str) -> dict:
    """Raw {key: np.ndarray} contents of a checkpoint, no ``like`` needed
    (a bf16 leaf comes back as its ``'V2'`` records).

    For variable-shape state (e.g. the runtime telemetry window) where
    ``restore``'s exact shape validation cannot apply."""
    with np.load(_npz(path)) as npz:
        return {k: npz[k] for k in npz.files}


def load_metadata(path: str) -> dict:
    """The JSON sidecar written by ``save`` ({"keys", "metadata"})."""
    with open(path.removesuffix(".npz") + ".json") as f:
        return json.load(f)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A loaded array as a host tensor; 2-byte ``'V2'`` records (a bf16
    leaf) as ``torch.bfloat16``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _as_like(key: str, arr: np.ndarray, like):
    """``arr`` in the type, dtype and device of ``like``; a ``DTensor``
    ``like`` takes this rank's chunk of ``arr``, laid out as it is."""
    if tuple(arr.shape) != tuple(np.shape(like)):
        raise ValueError(f"{key}: shape {arr.shape} != "
                         f"{tuple(np.shape(like))}")
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16 and (arr.dtype.kind != "V"
                                             or arr.dtype.itemsize != 2):
            raise ValueError(f"{key}: a bf16 leaf needs 2-byte records, "
                             f"got {arr.dtype}")
        local = D.local(like)
        chunk = D.local_of(host_tensor(arr), like)
        return D.like_local(chunk.to(device=local.device, dtype=local.dtype)
                            .contiguous(), like)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def restore(path: str, like):
    """Restore into the structure of ``like`` (shape checked; each leaf
    takes ``like``'s dtype and device; a ``DTensor`` leaf, laid out over a
    mesh, is filled with this rank's chunk only)."""
    with np.load(_npz(path)) as npz:
        flat_like = _flatten_with_paths(like)
        missing = set(flat_like) - set(npz.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: "
                             f"{sorted(missing)[:5]}...")
        _, treedef = tree.flatten(like)
        return tree.unflatten(treedef, [_as_like(k, npz[k], leaf)
                                        for k, leaf in flat_like.items()])
