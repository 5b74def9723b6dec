"""LLaVA-NeXT (Mistral-7B backbone) — anyres tiling VLM.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The vision tower (CLIP/SigLIP) + projector is a STUB per the brief:
``input_specs`` provides precomputed patch embeddings (anyres tiling:
base 576 patches + 4 tiles x 576 = 2880 prepended tokens).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, activation="silu", gated_ffn=True,
    norm="rmsnorm", rope_theta=1e6, tie_embeddings=False,
    frontend="vision", n_frontend_tokens=2880,
    train_mode="lags_dp", compression_ratio=1000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (Mistral-7B LM backbone)",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, n_frontend_tokens=8,
        dtype="float32", param_dtype="float32")
