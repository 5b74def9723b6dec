"""Gemma-3-27B — 5:1 local:global attention interleave, 128k context.
[hf:google/gemma-3-1b-pt (family card); 27B variant]

local_global_period=6: five sliding-window (1024) layers then one global.
long_500k decode runs in long-context mode where global layers fall back
to the sliding window too (a deviation from the published model) — ring
caches keep decode state O(window), making 500k serveable.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, head_dim=128, activation="gelu", gated_ffn=True,
    norm="rmsnorm", rope_theta=1000000.0, tie_embeddings=True,
    sliding_window=1024, local_global_period=6,
    train_mode="lags_dp", compression_ratio=1000.0,
    supports_long_context=True,  # via window-only long-context serving mode
    source="Gemma 3 technical report / hf:google/gemma-3 family",
)


def long_context_config() -> ModelConfig:
    """All layers sliding-window (global layers fall back) for 500k serving."""
    return dataclasses.replace(CONFIG, local_global_period=None)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, sliding_window=16, local_global_period=2,
        dtype="float32", param_dtype="float32")
