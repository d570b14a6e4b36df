"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 blocks + one *shared*
attention block invoked every 6 blocks (one weight copy, many consumers —
the paper's buffer-sharing analogue)."""
from .base import ModelConfig
from .registry import register


@register
def zamba2_1_2b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        ssm_state=64, ssm_head_dim=64, attn_every=6, subquadratic=True)
