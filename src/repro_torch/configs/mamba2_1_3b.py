"""Mamba2-1.3B [arXiv:2405.21060; unverified] — attention-free SSD."""
from .base import ModelConfig
from .registry import register


@register
def mamba2_1_3b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280, head_dim=64,
        ssm_state=128, ssm_head_dim=64, subquadratic=True)
