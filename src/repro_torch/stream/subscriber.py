"""Serving-side subscriber, as ``repro.stream.subscriber`` has it: a live
model that follows a delta stream.

``ServeSession`` wraps the serving launch path
(``launch/serve.make_serve_step`` / ``make_prefill_step``) around a
parameter tree that delta packets update in place between requests:

  * **ordering**: packet versions must be monotone +1; a gap (a dropped
    packet) breaks the EF alignment, so the session refuses the packet,
    sets ``needs_resync`` and waits for :meth:`ServeSession.resync` from
    a full checkpoint (``StreamPublisher.save_full``);
  * **identity**: the packet's fingerprint must match this parameter
    structure;
  * **safety**: an optional :class:`~repro_torch.stream.guard.RolloutGuard`
    scores every candidate update on held-out data *before* it is
    committed; a quality anomaly leaves the last-good parameters live and
    halts further applies (pinned version).  A guarded apply builds the
    candidate as a new tree, so the live parameters stay untouched until
    the guard commits.

Applies, prefills, decodes, resyncs and guard evals run under
``record_function`` ranges named with the ``serve/`` vocabulary of
``observe.names``, and every :meth:`ServeSession.generate` emits a
:class:`RequestRecord` (prefill latency, decode tokens/s, weight version,
cache regime, step-cache hit/miss) onto the metrics and event plane.
Its times end in a device synchronise.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import block_until_ready, tree
from repro_torch.observe import names
from repro_torch.observe import trace
from repro_torch.stream import codec as CD


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Per-request serving telemetry, one per :meth:`ServeSession.generate`.

    ``prefill_s`` includes the prefill→decode cache handoff
    (``engine.pad_states_for_decode``) and the device sync; ``decode_s``
    covers the whole greedy loop, so ``decode_tok_s`` is generated tokens
    per wall second across the batch (``batch * n_tokens / decode_s``).
    ``version`` is the weight-stream version the request was served from,
    ``cache`` the cache regime (full | ring | ssm | hybrid | xlstm), and
    ``prefill_jit``/``decode_jit`` whether the (kind, len, batch)-keyed
    step cache already held the step (``hit``) or had to build it
    (``miss``)."""
    index: int
    batch: int
    prompt_len: int
    n_tokens: int
    prefill_s: float
    decode_s: float
    decode_tok_s: float
    version: int
    cache: str
    prefill_jit: str
    decode_jit: str


def cache_regime(cfg) -> str:
    """Cache-regime label for :class:`RequestRecord` (which state layout
    the decode loop carries between steps)."""
    if cfg.xlstm_pattern:
        return "xlstm"
    if cfg.attn_period:
        return "hybrid"
    if cfg.family == "ssm":
        return "ssm"
    if cfg.sliding_window or cfg.local_global_period:
        return "ring"
    return "full"


class ServeSession:
    """A served model following a :class:`StreamPublisher`'s packets.
    It runs on the device that holds ``params``; on a mesh with a
    'model' axis (``launch.serve.tensor_parallel``) every rank makes one
    with the same full ``params``, which it lays out over 'model' (and
    'data' under FSDP serving), and ``generate`` returns the same tokens
    on every rank.  There every rank offers itself the same packets and
    resyncs: each applies the entries of its chunks
    (``stream.codec``) and restores its chunks (``checkpoint.io``), so
    its parameters stay bitwise the one-device session's chunks, and a
    guard scores the laid-out candidate."""

    def __init__(self, cfg, shape, params, *, mesh=None, chunk: int = 64,
                 guard=None, metrics=None, events=None):
        from repro_torch.launch import serve as SV
        from repro_torch.observe import events as OE
        from repro_torch.observe import metrics as OM
        SV.check_mesh(mesh, cfg)
        self.mesh = mesh
        self.raw_cfg = cfg
        self.cfg = SV.serve_cfg(cfg, shape.name)
        self.shape = shape
        self.chunk = int(chunk)
        self.codec = CD.DeltaCodec(params)
        self.tensor_parallel = SV.tensor_parallel(self.cfg, mesh)
        self.params = SV.place_params(self.cfg, mesh, params)
        self.fingerprint = self.codec.fingerprint
        self.version = 0
        self.guard = guard
        self.needs_resync = False
        self.log: list[dict] = []      # one row per packet offered
        self.requests: list[RequestRecord] = []
        self._steps: dict = {}         # (kind, len, batch) -> step fn
        reg = metrics if metrics is not None else OM.default_registry()
        self._events = events if events is not None else OE.default_events()
        self._m_requests = reg.counter(
            "serve_requests_total", "Generate requests served.",
            ("cache",))
        self._m_tokens = reg.counter(
            "serve_tokens_total", "Tokens generated (batch x steps).")
        self._m_prefill_s = reg.histogram(
            "serve_prefill_seconds",
            "Prefill latency incl. the decode-cache handoff.")
        self._m_tok_s = reg.gauge(
            "serve_decode_tokens_per_second",
            "Last request's decode throughput (batch-aggregate).")
        self._m_version = reg.gauge(
            "serve_version", "Weight-stream version currently applied.")
        self._m_packets = reg.counter(
            "serve_packets_total", "Packets offered, by outcome.",
            ("status",))
        self._m_jit = reg.counter(
            "serve_jit_cache_total",
            "(kind, len, batch) step-cache lookups.", ("kind", "event"))
        self._m_resyncs = reg.counter(
            "serve_resyncs_total", "Full-checkpoint resyncs.")

    @property
    def device(self) -> torch.device:
        return tree.leaves(self.params)[0].device

    # -- stream ingestion ---------------------------------------------------
    def apply_packet(self, packet: CD.DeltaPacket) -> str:
        """Offer one packet; returns the outcome:

        ``applied`` | ``stale`` (full packet at/behind our version) |
        ``fingerprint`` / ``gap`` (refused, ``needs_resync`` set) |
        ``halted`` (guard veto: params unchanged, last-good pinned).
        """
        status = self._apply_packet(packet)
        self.log.append({"version": packet.version, "kind": packet.kind,
                         "nbytes": packet.nbytes, "status": status})
        self._m_packets.inc(status=status)
        if status == "applied":
            self._m_version.set(self.version)
        self._events.emit("apply", step=int(packet.step),
                          version=int(packet.version),
                          packet_kind=packet.kind, status=status)
        return status

    def _apply_packet(self, packet: CD.DeltaPacket) -> str:
        with trace.annotation(names.serve_name(
                "apply", packet.kind, version=packet.version)):
            if packet.fingerprint != self.fingerprint:
                self.needs_resync = True
                return "fingerprint"
            if self.guard is not None and self.guard.halted:
                return "halted"
            if packet.kind == "full":
                if packet.version <= self.version:
                    return "stale"
            elif packet.version != self.version + 1:
                self.needs_resync = True
                return "gap"
            candidate = self.codec.apply(self.params, packet,
                                         donate=self.guard is None)
        if self.guard is not None:
            with trace.annotation(names.serve_name(
                    "eval", "quality", version=packet.version)):
                anomaly = self.guard.observe(packet.version, candidate)
            if anomaly is not None:
                self.guard.pin(self.version)   # last-good stays live
                return "halted"
        self.params = candidate
        self.version = packet.version
        self.needs_resync = False
        return "applied"

    def apply_packet_file(self, path: str) -> str:
        return self.apply_packet(CD.load_packet(path))

    def resync(self, path: str) -> int:
        """Reload from a full checkpoint (``StreamPublisher.save_full``);
        returns the restored version.  Clears ``needs_resync`` but not a
        guard halt: resuming a halted stream is an operator decision
        (``guard.resume()``)."""
        from repro_torch.checkpoint import io
        with trace.annotation(names.serve_name("resync", "full")):
            meta = io.load_metadata(path)["metadata"]
            if meta.get("fingerprint") not in (None, self.fingerprint):
                raise ValueError("resync checkpoint fingerprint mismatch: "
                                 f"{meta.get('fingerprint')} != "
                                 f"{self.fingerprint}")
            self.params = io.restore(path, {"params": self.params})["params"]
            self.version = int(meta["version"])
            self.needs_resync = False
        self._m_resyncs.inc()
        self._m_version.set(self.version)
        self._events.emit("resync", step=int(meta.get("step", -1)),
                          version=self.version)
        return self.version

    # -- serving ------------------------------------------------------------
    def _cached_step(self, kind: str, key: tuple) -> tuple:
        """(step fn, "hit" | "miss") from the (kind, len, batch) cache."""
        if key in self._steps:
            self._m_jit.inc(kind=kind, event="hit")
            return self._steps[key], "hit"
        from repro_torch.launch import serve as SV
        shape = dataclasses.replace(self.shape, seq_len=key[1],
                                    global_batch=key[2], kind=kind)
        make = SV.make_prefill_step if kind == "prefill" \
            else SV.make_serve_step
        self._steps[key], _ = make(self.raw_cfg, self.mesh, shape,
                                   chunk=self.chunk)
        self._m_jit.inc(kind=kind, event="miss")
        return self._steps[key], "miss"

    def generate(self, prompts, n_tokens: int):
        """Prefill ``prompts`` (B, L) once, hand the caches to decode, and
        greedily generate ``n_tokens``.  Returns (B, n_tokens) int32.

        Appends one :class:`RequestRecord` to :attr:`requests` and emits a
        ``request`` event under ``serve/request/b{B}xn{N}?version=``."""
        from repro_torch.serving import engine
        prompts = torch.as_tensor(prompts, device=self.device).to(
            torch.int32)
        b, prompt_len = prompts.shape
        capacity = prompt_len + n_tokens
        version = self.version
        regime = cache_regime(self.raw_cfg)
        t0 = time.perf_counter()
        prefill, prefill_jit = self._cached_step(
            "prefill", ("prefill", prompt_len, b))
        with trace.annotation(names.serve_name(
                "prefill", f"b{b}xl{prompt_len}", version=version)):
            logits, states = prefill(self.params, {"tokens": prompts})
            states = engine.pad_states_for_decode(self.cfg, states,
                                                  prompt_len, capacity)
            block_until_ready(logits)
        prefill_s = time.perf_counter() - t0
        step, decode_jit = self._cached_step("decode",
                                             ("decode", capacity, b))
        out = []
        t1 = time.perf_counter()
        with trace.annotation(names.serve_name(
                "decode", f"b{b}xn{n_tokens}", version=version)):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            for i in range(n_tokens):
                out.append(tok)
                logits, states = step(self.params, tok, states,
                                      prompt_len + i)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            tokens = torch.cat(out, dim=1)
            block_until_ready(tokens)
        decode_s = time.perf_counter() - t1
        decode_tok_s = (b * n_tokens) / max(decode_s, 1e-9)
        rec = RequestRecord(index=len(self.requests), batch=int(b),
                            prompt_len=int(prompt_len),
                            n_tokens=int(n_tokens),
                            prefill_s=float(prefill_s),
                            decode_s=float(decode_s),
                            decode_tok_s=float(decode_tok_s),
                            version=int(version), cache=regime,
                            prefill_jit=prefill_jit, decode_jit=decode_jit)
        self.requests.append(rec)
        self._m_requests.inc(cache=regime)
        self._m_tokens.inc(b * n_tokens)
        self._m_prefill_s.observe(prefill_s)
        self._m_tok_s.set(decode_tok_s)
        self._events.emit(
            "request", step=rec.index,
            name=names.serve_name("request", f"b{b}xn{n_tokens}",
                                  version=version),
            prefill_s=rec.prefill_s, decode_tok_s=rec.decode_tok_s,
            version=rec.version, cache=regime,
            prefill_jit=prefill_jit, decode_jit=decode_jit,
            batch=rec.batch, prompt_len=rec.prompt_len,
            n_tokens=rec.n_tokens)
        return tokens
