"""Yi-6B [arXiv:2403.04652; hf] — llama-arch GQA."""
from .base import ModelConfig
from .registry import register


@register
def yi_6b() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, head_dim=128)
