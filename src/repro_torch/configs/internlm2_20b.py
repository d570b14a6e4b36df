"""InternLM2-20B [arXiv:2403.17297; hf] — dense GQA."""
from .base import ModelConfig
from .registry import register


@register
def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92544, head_dim=128)
