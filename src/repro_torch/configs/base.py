"""Architecture configuration and the config registry: a copy of
``repro.configs.base`` (the port keeps its own so it never imports
``repro``).

Each config module ``repro_torch/configs/<id>.py`` exposes ``CONFIG``
(the exact full-size spec, source cited) and ``smoke_config()`` (a
reduced same-family variant for CPU tests), field for field the
reference's.  ``models.transformer`` builds attention decoders (RMS or
layer norm, dense or MoE FFNs, with an audio encoder or a vision
frontend), xLSTM stacks and the Mamba/attention hybrid, ``models.cnn``
the paper's CNN.
"""
from __future__ import annotations

import dataclasses
import importlib
import math


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

    def param_count(self) -> int:
        """Exact parameter count, from the model's own layout as ``meta``
        tensors (no storage)."""
        from repro_torch import tree
        from repro_torch.models import transformer as T
        return sum(math.prod(x.shape)
                   for x in tree.leaves(T.abstract_params(self)))

    def active_param_count(self) -> int:
        """Parameters active per token: an MoE layer runs top_k of its
        n_experts experts, so each leaf with the ``experts`` logical
        axis counts top_k / n_experts of its size (summed in floats and
        truncated, as the reference does)."""
        if not self.n_experts:
            return self.param_count()
        from repro_torch import tree
        from repro_torch.models import transformer as T
        params = T.abstract_params(self)
        axes = tree.flatten_up_to(tree.flatten(params)[1],
                                  T.logical_axes(self))
        total = 0.0
        for x, ax in zip(tree.leaves(params), axes):
            n = math.prod(x.shape)
            if "experts" in ax:
                n = n * self.moe_top_k / self.n_experts
            total += n
        return int(total)


ARCH_IDS = [
    "llava_next_mistral_7b",
    "nemotron_4_340b",
    "seamless_m4t_large_v2",
    "llama3_8b",
    "granite_moe_3b_a800m",
    "gemma3_27b",
    "olmoe_1b_7b",
    "xlstm_1_3b",
    "jamba_v0_1_52b",
    "tinyllama_1_1b",
]

PAPER_IDS = ["paper_cnn_cifar", "paper_lstm_ptb"]


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


# -------------------- input shapes (assigned) ------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

