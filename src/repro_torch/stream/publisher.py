"""Training-side delta publisher, as ``repro.stream.publisher`` has it:
hooks ``Session.run`` to a packet directory.

Cadence is in steps (``every``); the per-publish wire budget is in bytes,
given directly (``budget_bytes``) or from a link rate (``bytes_per_sec``
x the publish interval), by default an eighth of a full checkpoint.  The
per-leaf split is Eq. 18's shape on the stream: one compression ratio
``c`` shared by every leaf (``k_l = max(1, d_l / c)``), ``c`` found by
bisection so that the summed payload (sparse where sparse wins, the
leaf's raw bytes where it does not) fits the budget.  Each leaf is also
priced with ``autotune.planner.leaf_comm_time`` against a ``Hardware``
wire model, so a plan records how long the packet takes to reach ``p``
subscribers; with ``time_budget_s`` the bisection solves against that
predicted time instead of bytes.

Packet ``version`` counts from 1; packet 1 is a full baseline, and
``flush_every`` makes every Nth packet a full flush (EF residual
drained: subscribers land bitwise on the live parameters).  The
``published`` copy and the residual live on the parameters' device;
the packets the publisher keeps (``packets``) are host copies, as the
reference keeps numpy ones, so the device holds no packet once the
caller drops the one :meth:`StreamPublisher.publish` returns.

On ``DTensor`` parameters (a mesh with a 'model' axis, or ``lags_hier``'s
FSDP) every rank of a leaf's sub-mesh publishes together: the published
copy is ``DTensor``s laid out as the parameters and the residual holds
this rank's chunk of each leaf, so a card keeps chunks only.  A packet
is cut a leaf at a time: the leaf, its published copy and its residual
are gathered whole (one leaf's transients alive at once), encoded as a
one-card publisher encodes them, and the rank keeps its chunk of the new
residual; every packet, full or delta, is bitwise the packet a one-card
publisher cuts from the gathered parameters.  Rank 0 of the process
group writes ``out_dir`` and :meth:`StreamPublisher.save_full`'s file
(on plain parameters each rank's publisher is its own, and writes).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.sharding import dtensor as D
from repro_torch.stream import codec as CD


@dataclasses.dataclass(frozen=True)
class LeafPlanEntry:
    """One leaf's share of a publish budget."""
    key: str
    d: int
    k: int
    kind: str        # "sparse" | "full"
    nbytes: int
    t_pred: float    # leaf_comm_time pricing (0 without a wire model)


class StreamPublisher:
    """Cuts, prices, persists and self-applies :class:`DeltaPacket`\\ s."""

    def __init__(self, params_like, *, every: int = 10,
                 budget_bytes: int | None = None,
                 bytes_per_sec: float | None = None,
                 step_time_s: float = 1.0,
                 time_budget_s: float | None = None,
                 flush_every: int = 0,
                 compressor: str = "topk_exact",
                 value_dtype: str = "float32",
                 out_dir: str | None = None,
                 hw=None, p: int = 2, c_upper: float = 1e6,
                 metrics=None, events=None):
        from repro_torch.observe import events as OE
        from repro_torch.observe import metrics as OM
        self.codec = CD.DeltaCodec(params_like, compressor=compressor,
                                   value_dtype=value_dtype)
        reg = metrics if metrics is not None else OM.default_registry()
        self._events = events if events is not None else OE.default_events()
        self._m_packets = reg.counter(
            "publish_packets_total", "Published delta/full packets.",
            ("kind",))
        self._m_bytes = reg.counter(
            "publish_bytes_total", "Wire bytes actually streamed.",
            ("kind",))
        self._m_full_equiv = reg.counter(
            "publish_bytes_full_equiv_total",
            "What the same cadence would have cost in full checkpoints.")
        self._m_version = reg.gauge(
            "publish_version", "Latest published packet version.")
        # the health plane's stream tier: per-leaf EF energy retention of
        # the codec residual, the share of weight motion a packet left
        self._m_health = reg.gauge(
            "publish_health_ef_energy",
            "Stream-residual energy retention ||res'||^2 / ||acc||^2 "
            "per leaf.", ("leaf",))
        self.every = int(every)
        self.flush_every = int(flush_every)
        self.out_dir = out_dir
        self.hw, self.p = hw, int(p)
        self.c_upper = float(c_upper)
        self.time_budget_s = time_budget_s
        if budget_bytes is not None:
            self.budget_bytes = int(budget_bytes)
        elif bytes_per_sec is not None:
            self.budget_bytes = int(bytes_per_sec * step_time_s
                                    * max(self.every, 1))
        else:
            self.budget_bytes = self.codec.full_bytes // 8
        self.published = None            # subscriber-visible param tree
        # flat f32, this rank's chunk of each leaf (the whole leaf when
        # the parameters are plain tensors)
        self.residual = self.codec.zero_residual()
        # DTensor parameters: every rank of their mesh publishes one stream
        self._writes = not any(D.is_dtensor(v)
                               for v in tree.leaves(params_like)) or (
            not dist.is_initialized() or dist.get_rank() == 0)
        self.version = 0
        self.last_plan: list[LeafPlanEntry] = []
        self.packets: list[CD.DeltaPacket] = []
        self.packet_paths: list[str] = []
        self.bytes_streamed = 0
        self.n_publishes = 0

    # -- budget split -------------------------------------------------------
    def _leaf_time(self, d: int, k: int) -> float:
        if self.hw is None:
            return 0.0
        from repro_torch.autotune import planner
        # k == d prices as a dense transfer (ratio 1); sparse otherwise
        return planner.leaf_comm_time(d, d / max(k, 1), self.p, self.hw)

    def _plan_at(self, c: float) -> list[LeafPlanEntry]:
        plan = []
        for key in self.codec.keys:
            d = self.codec.sizes[key]
            k = max(1, int(d / c))
            if self.codec.sparse_wins(key, k):
                plan.append(LeafPlanEntry(key, d, k, "sparse",
                                          k * self.codec.bpe,
                                          self._leaf_time(d, k)))
            else:
                plan.append(LeafPlanEntry(key, d, d, "full",
                                          self.codec.dense_bytes(key),
                                          self._leaf_time(d, d)))
        return plan

    def _plan_cost(self, plan: list[LeafPlanEntry]) -> float:
        if self.time_budget_s is not None:
            return sum(e.t_pred for e in plan)
        return float(sum(e.nbytes for e in plan))

    def split_budget(self) -> list[LeafPlanEntry]:
        """Largest per-leaf k (smallest shared ratio c) whose total cost
        fits the budget; bisection over c (cost is monotone in c)."""
        budget = (self.time_budget_s if self.time_budget_s is not None
                  else float(self.budget_bytes))
        lo, hi = 1.0, self.c_upper
        if self._plan_cost(self._plan_at(lo)) <= budget:
            return self._plan_at(lo)
        floor = self._plan_at(hi)
        if self._plan_cost(floor) > budget:
            return floor             # k=1 everywhere still over: best effort
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if self._plan_cost(self._plan_at(mid)) <= budget:
                hi = mid
            else:
                lo = mid
        return self._plan_at(hi)

    # -- publishing ---------------------------------------------------------
    def due(self, step: int) -> bool:
        return self.every > 0 and step % self.every == 0

    def maybe_publish(self, step: int, params) -> CD.DeltaPacket | None:
        if not self.due(step):
            return None
        return self.publish(step, params)

    def publish(self, step: int, params, *,
                full: bool = False) -> CD.DeltaPacket:
        from repro_torch.observe import names as ON
        version = self.version + 1
        retention: dict[str, float] = {}
        if (self.published is None or full
                or (self.flush_every and version % self.flush_every == 0)):
            # exact: the residual drains to zero
            payload, self.residual, nbytes = self.codec.encode_full(params)
            kind = "full"
            self.last_plan = []
        else:
            plan = self.split_budget()
            ks = {e.key: e.k for e in plan}
            payload, self.residual, nbytes, _ = self.codec.encode(
                self.published, params, self.residual, ks,
                retention=retention)
            kind = "delta"
            self.last_plan = plan
        # the stream tier of the health plane: ||res'||^2 / ||acc||^2
        for key in self.codec.keys:
            self._m_health.set(retention.get(key, 0.0),
                               leaf=ON.health_name("ef_energy",
                                                   f"stream/{key}"))
        pkt = CD.DeltaPacket(version=version, step=int(step),
                             fingerprint=self.codec.fingerprint, kind=kind,
                             payload=payload, nbytes=int(nbytes))
        # self-apply through the subscriber's exact update rule so both
        # ends stay bitwise in lockstep (see the codec's docstring)
        if self.published is None:
            self.published = self.codec.materialize(
                pkt, _zeros_like_tree(params))
        else:
            self.published = self.codec.apply(self.published, pkt)
        self.version = version
        self.bytes_streamed += pkt.nbytes
        self.n_publishes += 1
        kept = CD.host_packet(pkt)
        self.packets.append(kept)
        self._m_packets.inc(kind=kind)
        self._m_bytes.inc(pkt.nbytes, kind=kind)
        self._m_full_equiv.inc(self.codec.full_bytes)
        self._m_version.set(version)
        self._events.emit("publish", step=int(step), version=version,
                          packet_kind=kind, nbytes=int(pkt.nbytes))
        if self.out_dir and self._writes:
            self.packet_paths.append(CD.save_packet(self.out_dir, kept))
        return pkt

    def flush(self, step: int, params) -> CD.DeltaPacket:
        """Full packet now: drains the EF residual; subscribers that apply
        it are bitwise equal to ``params``."""
        return self.publish(step, params, full=True)

    # -- resync source ------------------------------------------------------
    def save_full(self, path: str, step: int | None = None) -> str:
        """Full checkpoint of the *published* state + stream metadata:
        what a gapped subscriber resyncs from.  On ``DTensor`` parameters
        every rank gathers it and rank 0 writes it."""
        from repro_torch.checkpoint import io
        full = D.gather(self.published)
        if self._writes:
            io.save(path, {"params": full},
                    metadata={"version": self.version,
                              "step": int(step if step is not None else -1),
                              "fingerprint": self.codec.fingerprint})
        return path

    @property
    def bytes_full_equiv(self) -> int:
        """What the same cadence would have cost in full checkpoints."""
        return self.n_publishes * self.codec.full_bytes


def _zeros_like_tree(params):
    """Zeros laid out as ``params`` (a ``DTensor`` leaf's chunk)."""
    def zeros(x):
        local = D.local(x)
        return D.like_local(torch.zeros(local.shape, dtype=x.dtype,
                                        device=local.device), x)
    return tree.map(zeros, params)
