"""OLMoE-1B-7B — 64 experts top-8 MoE. [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, head_dim=128, activation="silu", gated_ffn=True,
    norm="rmsnorm", rope_theta=10000.0, tie_embeddings=False,
    n_experts=64, moe_top_k=8, moe_period=1, moe_shard="experts",
    train_mode="lags_dp", compression_ratio=1000.0,
    source="arXiv:2409.02060 (OLMoE)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=512, head_dim=32, n_experts=4, moe_top_k=2,
        dtype="float32", param_dtype="float32")
