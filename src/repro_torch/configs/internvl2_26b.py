"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT + InternLM2 backbone.

Backbone only per the assignment: the ViT frontend is a stub;
``input_specs`` supplies precomputed patch embeddings."""
from .base import ModelConfig
from .registry import register


@register
def internvl2_26b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92553, head_dim=128, frontend="embed")
