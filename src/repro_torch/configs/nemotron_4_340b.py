"""Nemotron-4-340B — dense GQA with squared-ReLU MLP. [arXiv:2402.16819]

Largest assigned arch: a single FFN matrix is 18432x73728 = 1.36e9 params,
which is why hierarchical (block-candidate) top-k selection exists.  Too
large for pure data-parallel LAGS state: train_mode defaults to
hierarchical LAGS (sparse across the pod axis, dense reduce within a
pod).  The smoke config trains lags_dp.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab=256000, head_dim=192, activation="squared_relu", gated_ffn=False,
    norm="layernorm", rope_theta=10000.0, tie_embeddings=False,
    train_mode="lags_hier", compression_ratio=1000.0,
    source="arXiv:2402.16819 (Nemotron-4 340B)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=192, n_heads=4, n_kv_heads=2, d_ff=768,
        vocab=512, head_dim=48, dtype="float32", param_dtype="float32",
        train_mode="lags_dp")
