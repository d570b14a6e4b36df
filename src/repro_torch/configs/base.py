"""Model/run configuration for the pod-scale JAX framework (Half B)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # gemma2-style options
    local_window: int = 0          # >0: alternate local/global attention
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # hybrid (Zamba2): one *shared* attention block every `attn_every`
    # Mamba blocks (the paper's buffer-sharing analogue: one weight copy,
    # many consumers)
    attn_every: int = 0
    # modality frontend: 'token' = token ids; 'embed' = precomputed
    # frame/patch embeddings (audio/vlm stub frontends per the assignment)
    frontend: str = "token"
    # substrate choices
    optimizer: str = "adamw"       # adamw | adafactor
    remat: str = "none"            # none | block  (activation checkpointing)
    seq_shard: bool = False        # sequence-parallel residuals over 'model'
    kv_cache_dtype: str = "bf16"   # bf16 | int8 (quantized decode cache)
    # applicability flags
    subquadratic: bool = False     # can run long_500k
    notes: str = ""

    def __post_init__(self) -> None:
        # pad vocab for clean model-axis sharding (multiple of 256)
        object.__setattr__(self, "padded_vocab", pad_to(self.vocab_size, 256))

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def param_count(self) -> float:
        """Analytic parameter count (embeddings included once)."""
        d, L = self.d_model, self.num_layers
        hd, H, KV = self.head_dim, self.num_heads, self.num_kv_heads
        n = self.padded_vocab * d * 2          # embed + lm_head
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        dense_ffn = 3 * d * self.d_ff
        if self.family == "dense":
            n += L * (attn + dense_ffn)
        elif self.family == "moe":
            routed = 3 * d * self.moe_d_ff * self.num_experts
            shared = 3 * d * self.moe_d_ff * self.num_shared_experts
            router = d * self.num_experts
            n += self.first_dense_layers * (attn + dense_ffn)
            n += (L - self.first_dense_layers) * (attn + routed + shared +
                                                  router)
        elif self.family == "ssm":
            di = self.ssm_expand * d
            mamba = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) \
                + di * d
            n += L * mamba
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            mamba = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) \
                + di * d
            n += L * mamba + (attn + dense_ffn)   # one shared block
        return float(n)

    def active_param_count(self) -> float:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        hd, H, KV = self.head_dim, self.num_heads, self.num_kv_heads
        n = self.padded_vocab * d * 2
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        n += self.first_dense_layers * (attn + 3 * d * self.d_ff)
        act = 3 * d * self.moe_d_ff * (self.top_k + self.num_shared_experts)
        n += (L - self.first_dense_layers) * (attn + act +
                                              d * self.num_experts)
        return float(n)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention (SSM/hybrid only here;
    gemma2's alternating stack still contains global full-attention layers)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention architecture"
    return True, ""
