"""The paper's own LSTM workload analogue: 2-layer LSTM, 1500 hidden
(LSTM-PTB, Marcus et al. 1993 dataset in the paper; synthetic here).

We realize it as a 2-layer sLSTM stack (same recurrent family) for the
convergence experiments (Fig. 2/3, Table 1 analogues).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-lstm-ptb", family="ssm",
    n_layers=2, d_model=1500, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=10000, head_dim=375, activation="gelu", gated_ffn=False,
    norm="layernorm", tie_embeddings=True,
    xlstm_pattern=("slstm",),
    train_mode="lags_dp", compression_ratio=250.0,
    dtype="float32", param_dtype="float32",
    source="paper §6 (LSTM-PTB, 2x1500)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, d_model=128, head_dim=32, vocab=512)
