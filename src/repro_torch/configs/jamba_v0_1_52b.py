"""Jamba-v0.1 (52B total) — Mamba+attention 1:7 interleave with MoE 16e
top-2 on every other layer. [arXiv:2403.19887]

attn_period=8: one attention layer per 8 (at offset 4), 7 mamba layers.
moe_period=2: MoE replaces the dense FFN on every 2nd layer.
Hybrid -> long_500k natural (4 attention layers keep full caches,
28 mamba layers keep O(1) state).  52B total: too large for pure
data-parallel LAGS residual state on one pod -> lags_hier.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128, activation="silu", gated_ffn=True,
    norm="rmsnorm", rope_theta=10000.0, tie_embeddings=False,
    n_experts=16, moe_top_k=2, moe_period=2, attn_period=8,
    train_mode="lags_hier", compression_ratio=1000.0,
    supports_long_context=True,
    source="arXiv:2403.19887 (Jamba)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, n_experts=4, moe_top_k=2,
        dtype="float32", param_dtype="float32", train_mode="lags_dp")
