"""Architecture configuration: a copy of ``repro.configs.base.ModelConfig``
(the port keeps its own so it never imports ``repro``).

Each config module ``repro_torch/configs/<id>.py`` exposes ``CONFIG``
(the exact full-size spec, source cited) and ``smoke_config()`` (a
reduced same-family variant for CPU tests).  The port runs the ``dense``
family; ``models.transformer`` raises for the others.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # default: d_model // n_heads
    activation: str = "silu"
    gated_ffn: bool = True
    norm: str = "rmsnorm"
    rope_theta: float = 500000.0
    # attention pattern
    sliding_window: int | None = None
    local_global_period: int | None = None
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    moe_period: int = 1
    # hybrid (jamba): one attn layer per `attn_period`, rest mamba
    attn_period: int | None = None
    # xlstm: repeating block kinds
    xlstm_pattern: tuple[str, ...] | None = None
    # enc-dec (audio)
    n_encoder_layers: int = 0
    # modality frontend stub
    frontend: str | None = None
    n_frontend_tokens: int = 0
    tie_embeddings: bool = True
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # distribution / LAGS defaults
    train_mode: str = "lags_dp"
    moe_shard: str = "ffn"
    compression_ratio: float = 1000.0
    compressor: str = "topk_hier"
    # provenance
    source: str = ""
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

