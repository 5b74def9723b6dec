"""repro_torch.stream: sparse-delta weight streaming from training to
serving, as ``repro.stream`` has it.

The LAGS selection (top-k + error feedback, per-leaf budgets) applied to
``params_now - params_published``: a training ``Session`` publishes
versioned delta packets at a fraction of a full checkpoint's bytes, and
a serving ``ServeSession`` follows them live.

    codec      - per-leaf sparse-delta encode/apply, EF residual,
                 exact-dense fallback, packet (de)serialization
    publisher  - cadence + byte/time budgets, an Eq.-18-style per-leaf
                 split priced by ``planner.leaf_comm_time``
    subscriber - ``ServeSession``: versioned in-place applies over the
                 serving path, resync on a gap
    guard      - ``RolloutGuard``: held-out NLL change-point detection,
                 halts the stream and pins the last-good version
"""
from repro_torch.stream.codec import (DeltaCodec, DeltaPacket, load_packet,
                                      packet_path, save_packet,
                                      tree_fingerprint)
from repro_torch.stream.guard import RolloutGuard, quality_probe
from repro_torch.stream.publisher import StreamPublisher
from repro_torch.stream.subscriber import (RequestRecord, ServeSession,
                                           cache_regime)

__all__ = ["DeltaCodec", "DeltaPacket", "load_packet", "packet_path",
           "save_packet", "tree_fingerprint", "RolloutGuard",
           "quality_probe", "StreamPublisher", "ServeSession",
           "RequestRecord", "cache_regime"]
