"""xLSTM-1.3B — alternating mLSTM/sLSTM blocks. [arXiv:2405.04517]

Attention-free: LAGS applies unchanged (it only needs the layer-wise
parameter pytree).  O(1) decode state -> natural long_500k architecture.
d_ff=0 per the spec: xLSTM blocks carry their own up/down projections.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=512, activation="gelu", gated_ffn=False,
    norm="rmsnorm", rope_theta=10000.0, tie_embeddings=False,
    xlstm_pattern=("mlstm", "slstm"),
    train_mode="lags_dp", compression_ratio=1000.0,
    supports_long_context=True,
    source="arXiv:2405.04517 (xLSTM)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab=512, head_dim=32, dtype="float32", param_dtype="float32")
