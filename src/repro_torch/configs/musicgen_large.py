"""MusicGen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

Backbone only per the assignment: the EnCodec frontend is a stub;
``input_specs`` supplies precomputed frame embeddings."""
from .base import ModelConfig
from .registry import register


@register
def musicgen_large() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="dense",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048, head_dim=64, frontend="embed")
