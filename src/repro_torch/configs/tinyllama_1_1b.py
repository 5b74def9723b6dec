"""TinyLlama-1.1B — llama2-architecture small model. [arXiv:2401.02385]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab=32000, head_dim=64, activation="silu", gated_ffn=True,
    norm="rmsnorm", rope_theta=10000.0, tie_embeddings=False,
    train_mode="lags_dp", compression_ratio=1000.0,
    source="arXiv:2401.02385 (TinyLlama)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, dtype="float32", param_dtype="float32")
