"""Llama-3-8B — dense GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, activation="silu", gated_ffn=True,
    norm="rmsnorm", rope_theta=500000.0, tie_embeddings=False,
    train_mode="lags_dp", compression_ratio=1000.0,
    source="arXiv:2407.21783 (Llama 3)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, dtype="float32", param_dtype="float32")
