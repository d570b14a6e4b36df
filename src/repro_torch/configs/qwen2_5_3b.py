"""Qwen2.5-3B [hf:Qwen/Qwen2.5; hf] — GQA kv=2, QKV bias."""
from .base import ModelConfig
from .registry import register


@register
def qwen2_5_3b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        d_ff=11008, vocab_size=151936, head_dim=128, qkv_bias=True)
