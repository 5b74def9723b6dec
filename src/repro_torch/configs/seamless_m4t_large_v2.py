"""SeamlessM4T-Large v2 — encoder-decoder speech/text model.
[arXiv:2308.11596]

24 layers split 12 encoder + 12 decoder (enc-dec per the spec).  The
mel-spectrogram + conformer feature frontend is a STUB: ``input_specs``
provides precomputed frame embeddings (seq_len // 4 frames, ~4x conv
subsampling) as the encoder input.  n_kv_heads == n_heads (kv=16 = MHA).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=12, n_encoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, head_dim=64, activation="gelu", gated_ffn=False,
    norm="layernorm", rope_theta=10000.0, tie_embeddings=True,
    frontend="audio",
    train_mode="lags_dp", compression_ratio=250.0,
    source="arXiv:2308.11596 (SeamlessM4T v2; 24L total = 12 enc + 12 dec)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512, head_dim=32,
        dtype="float32", param_dtype="float32")
