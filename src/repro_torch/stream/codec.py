"""Sparse-delta weight codec, as ``repro.stream.codec`` has it: the LAGS
selection on the parameter stream.

Training moves the weights a little every step; a serving fleet
following the run needs ``params_now - params_published``, the kind of
vector top-k with error feedback was built for.  Per leaf:

    acc       = residual + (now - published)        # nothing is dropped
    selected  = TopK(acc, k)                        # registry compressor
    residual' = acc - selected                      # carried to the next

When a leaf's delta is too dense for sparse coding to win (``k *
payload_bytes_per_elem >= d * itemsize``) the leaf ships its raw bytes
(``kind="full"``): exact, its residual drained to zero.

Bitwise parity: the publisher applies every packet to its own
``published`` copy through the same :meth:`DeltaCodec.apply` the
subscriber runs, so both ends stay bitwise in lockstep, and a flush (an
all-leaves-full packet) equals the live parameters exactly.

Where the reference keeps residuals and payloads in host numpy, the port
keeps them on the parameters' device: a payload is a dict of tensors
there, and only :func:`save_packet` and :func:`host_packet` move its
(values, idx) to the host.
Files are the reference's (``checkpoint.io``'s ``.npz`` + JSON; bf16
leaves as 2-byte ``'<V2'`` records), and :func:`tree_fingerprint` hashes
the reference's dtype names (``'bfloat16'`` as ``ml_dtypes`` names it),
so a packet cut by either package applies in the other.

Compressors resolve by name through ``api.register_compressor``'s
registry (``core.compressors.REGISTRY``): anything the gradient exchange
can use, kernel-backed ones included, codes the stream.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import bucketing
from repro_torch.core import compressors as C
from repro_torch.sharding import dtensor as D

#: int32 index bytes on the wire (the exchange payload's layout).
INDEX_BYTES = 4
#: the numpy dtype name of each torch dtype (the reference hashes these)
DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
               torch.bfloat16: "bfloat16", torch.float16: "float16",
               torch.int32: "int32", torch.int64: "int64",
               torch.int16: "int16", torch.int8: "int8",
               torch.uint8: "uint8", torch.bool: "bool"}
#: wire value dtypes by name
VALUE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def leaf_items(tree_) -> list[tuple[str, Any]]:
    """``[(key, leaf)]`` with ``/``-joined key paths: the keys
    ``checkpoint.io`` writes, so packet payload keys line up with
    checkpoint keys."""
    return list(zip(tree.leaf_paths(tree_), tree.leaves(tree_)))


def _shape_of(v) -> tuple:
    return tuple(int(n) for n in v.shape)


def tree_fingerprint(tree_) -> str:
    """Structure hash (leaf keys, shapes, numpy dtype names): a packet
    applies only to the parameter tree it was cut against."""
    desc = [(k, _shape_of(v), DTYPE_NAMES[v.dtype])
            for k, v in leaf_items(tree_)]
    return hashlib.sha1(json.dumps(desc).encode()).hexdigest()[:16]


@dataclasses.dataclass
class DeltaPacket:
    """One versioned weight update.

    ``payload`` maps leaf key -> {"values": tensor[, "idx": tensor]}:
    entries with "idx" are sparse deltas (values + int32 indices into the
    flat leaf), entries without are the leaf's full raw values.
    ``kind`` is "full" when EVERY leaf is full (baseline, flush, resync),
    else "delta"."""
    version: int
    step: int
    fingerprint: str
    kind: str
    payload: dict[str, dict[str, torch.Tensor]]
    nbytes: int


@torch.no_grad()
def _apply_tree(params, payload, donate: bool):
    """The one update rule both ends run: ``cast(f32(leaf) +
    scatter(values, idx))`` for a sparse entry, the raw values for a full
    one.  ``donate`` writes into the leaves in place; otherwise a new
    tree (the untouched leaves shared with ``params``).

    A leaf laid out over a mesh (a ``DTensor``: a tensor-parallel
    ``ServeSession``) takes the entries that fall in this rank's chunk,
    at their index in it, and its chunk of a full entry's values: the
    same rule on each element, so the chunks land bit for bit on the
    one-device leaf's, and no rank builds a full leaf."""
    flat, treedef = tree.flatten(params)
    out = []
    for key, leaf in zip(tree.leaf_paths(params), flat):
        entry = payload.get(key)
        if entry is None:
            out.append(leaf)
            continue
        local = D.local(leaf)
        vals = entry["values"].to(local.device)
        if "idx" in entry:
            vals, idx = D.local_entries(vals, entry["idx"].to(local.device),
                                        leaf)
            dense = C.decompress(vals, idx, local.numel())
            new = (local.float().reshape(-1) + dense).to(local.dtype)
        else:
            new = D.local_of(vals.reshape(leaf.shape), leaf)
        if donate:
            local.copy_(new.reshape(local.shape))
            out.append(leaf)
        else:
            out.append(D.like_local(torch.empty(
                local.shape, dtype=local.dtype, device=local.device).copy_(
                    new.reshape(local.shape)), leaf))
    return tree.unflatten(treedef, out)


class DeltaCodec:
    """Per-leaf sparse-delta encode/apply over one parameter structure."""

    def __init__(self, params_like, *, compressor: str = "topk_exact",
                 value_dtype: str = "float32"):
        from repro_torch.api import registry
        self.compressor = registry.get_compressor(compressor)
        if self.compressor.needs_key:
            raise ValueError(f"stream codec needs a deterministic "
                             f"compressor; {compressor!r} takes a key")
        self.value_dtype = VALUE_DTYPES[value_dtype]
        self.bpe = bucketing.payload_bytes_per_elem(value_dtype,
                                                    index_bytes=INDEX_BYTES)
        items = leaf_items(params_like)
        self.keys = [k for k, _ in items]
        self.sizes = {k: int(np.prod(_shape_of(v), dtype=np.int64))
                      for k, v in items}
        self.itemsizes = {k: v.element_size() for k, v in items}
        self.devices = {k: v.device for k, v in items}
        # this rank's chunk of a DTensor leaf; the leaf itself otherwise
        self.local_sizes = {k: D.local(v).numel() for k, v in items}
        self.fingerprint = tree_fingerprint(params_like)

    @property
    def full_bytes(self) -> int:
        """One full checkpoint's payload bytes (raw leaf bytes)."""
        return sum(self.sizes[k] * self.itemsizes[k] for k in self.keys)

    def zero_residual(self) -> dict[str, torch.Tensor]:
        """f32 zeros per leaf, flat, on the leaf's device: this rank's
        chunk of a ``DTensor`` leaf."""
        return {k: self._zeros(k) for k in self.keys}

    def _zeros(self, key: str) -> torch.Tensor:
        return torch.zeros(self.local_sizes[key], dtype=torch.float32,
                           device=self.devices[key])

    def dense_bytes(self, key: str) -> int:
        return self.sizes[key] * self.itemsizes[key]

    def sparse_wins(self, key: str, k: int) -> bool:
        return k < self.sizes[key] and k * self.bpe < self.dense_bytes(key)

    # -- encode -------------------------------------------------------------
    @torch.no_grad()
    def encode(self, published, now, residual: dict, ks: dict, *,
               retention: dict | None = None):
        """One delta packet's payload.  Returns ``(payload, residual',
        nbytes, kinds)``; ``residual`` is not mutated.  A leaf missing
        from ``ks`` ships full.  ``retention``, when given, takes each
        leaf's ``||res'||^2 / ||acc||^2`` (0 for a full entry): the
        stream tier of the health plane's EF energy."""
        return self._encode(published, now, residual, ks, retention)

    @torch.no_grad()
    def encode_full(self, now):
        """All-leaves-full payload (baseline, flush): the residual drains
        to zero and :meth:`apply` lands bitwise on ``now``."""
        payload, residual, nbytes, _ = self._encode(None, now, {}, {}, None)
        return payload, residual, nbytes

    def _encode(self, published, now, residual, ks, retention):
        """The one per-leaf encode.  A ``DTensor`` leaf (parameters over
        a mesh) is cut a leaf at a time: the leaf, its published copy and
        this rank's residual chunk gathered whole, encoded as on one
        card (the same bits into the same ops, so every rank cuts the
        one-card packet), and this rank's chunk of the new residual
        kept; one leaf's transients are alive at once."""
        pub = {} if published is None else dict(leaf_items(published))
        payload, new_res, kinds = {}, {}, {}
        nbytes = 0
        for key, leaf in leaf_items(now):
            d = self.sizes[key]
            k = int(ks.get(key, d))
            whole = _whole(leaf)
            if not self.sparse_wins(key, k):
                payload[key] = {"values": whole.reshape(-1).clone()}
                new_res[key] = self._zeros(key)
                kinds[key] = "full"
                nbytes += self.dense_bytes(key)
                if retention is not None:
                    retention[key] = 0.0
                continue
            delta = (whole.float().reshape(-1)
                     - _whole(pub[key]).float().reshape(-1))
            acc = _whole_flat(residual[key], leaf) + delta
            del whole, delta
            vals, idx = self.compressor(acc, k)
            payload[key] = {"values": vals.to(self.value_dtype),
                            "idx": idx.to(torch.int32)}
            acc_sq = (float(torch.sum(torch.square(acc)))
                      if retention is not None else None)
            # acc becomes the residual: acc - scatter(vals, idx), in place
            acc.sub_(C.decompress(vals, idx, d))
            if retention is not None:
                retention[key] = (float(torch.sum(torch.square(acc)))
                                  / max(acc_sq, 1e-30))
            new_res[key] = _chunk_flat(acc, leaf)
            del acc
            kinds[key] = "sparse"
            nbytes += int(vals.shape[0]) * self.bpe  # block modes may ceil
        return payload, new_res, nbytes, kinds

    # -- apply --------------------------------------------------------------
    def apply(self, params, packet: DeltaPacket, *, donate: bool = True):
        """Parameters with ``packet`` applied.  ``donate=True`` writes into
        ``params`` in place (and returns it); pass False when the caller
        must keep the old parameters (guarded applies): a new tree, the
        old one untouched."""
        return _apply_tree(params, packet.payload, donate)

    def materialize(self, packet: DeltaPacket, like):
        """A parameter tree from a full packet alone (subscriber
        bootstrap), in ``like``'s dtypes and devices."""
        if packet.kind != "full":
            raise ValueError("materialize needs a full packet")
        return _apply_tree(like, packet.payload, False)


def _whole(x):
    """The whole leaf of ``x`` (a ``DTensor``'s gathered; detached)."""
    return x.full_tensor() if D.is_dtensor(x) else x.detach()


def _whole_flat(res, like):
    """The whole leaf's flat residual from this rank's chunk ``res`` of
    the leaf ``like``."""
    if not D.is_dtensor(like):
        return res
    return D.like_local(res.reshape(D.local(like).shape),
                        like).full_tensor().reshape(-1)


def _chunk_flat(res, like):
    """This rank's chunk of the whole leaf's flat residual ``res``, flat
    (its own storage)."""
    if not D.is_dtensor(like):
        return res
    return D.local_of(res.reshape(like.shape), like).clone(
        memory_format=torch.contiguous_format).reshape(-1)


# ---------------------------------------------------------------------------
# persistence (checkpoint.io's .npz + JSON sidecar)
# ---------------------------------------------------------------------------

def packet_path(out_dir: str, version: int) -> str:
    return os.path.join(out_dir, f"delta_{version:06d}")


def host_packet(packet: DeltaPacket) -> DeltaPacket:
    """``packet`` with its payload copied to the host (the same packet
    when it is there already)."""
    payload = {key: {f: v.cpu() for f, v in entry.items()}
               for key, entry in packet.payload.items()}
    return dataclasses.replace(packet, payload=payload)


def save_packet(out_dir: str, packet: DeltaPacket) -> str:
    """``delta_<version>.npz`` + ``.json`` sidecar via ``checkpoint.io``
    (the payload's tensors copied to the host there)."""
    from repro_torch.checkpoint import io
    path = packet_path(out_dir, packet.version)
    io.save(path, packet.payload,
            metadata={"version": packet.version, "step": packet.step,
                      "fingerprint": packet.fingerprint,
                      "kind": packet.kind, "nbytes": packet.nbytes})
    return path


def load_packet(path: str) -> DeltaPacket:
    """A packet from disk, its payload as host tensors (a ``'<V2'``
    record array as bf16)."""
    from repro_torch.checkpoint import io
    arrays = io.load_arrays(path)
    meta = io.load_metadata(path)["metadata"]
    payload: dict[str, dict[str, torch.Tensor]] = {}
    for key, arr in arrays.items():
        leaf, field = key.rsplit("/", 1)
        payload.setdefault(leaf, {})[field] = io.host_tensor(arr)
    return DeltaPacket(version=int(meta["version"]), step=int(meta["step"]),
                       fingerprint=meta["fingerprint"], kind=meta["kind"],
                       payload=payload, nbytes=int(meta["nbytes"]))
