"""Gemma2-2B [arXiv:2408.00118; hf] — local+global alternating attention,
attention & final logit softcapping, GQA kv=4, head_dim=256."""
from .base import ModelConfig
from .registry import register


@register
def gemma2_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
        d_ff=9216, vocab_size=256000, head_dim=256,
        local_window=4096, attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        notes="even layers local (sliding window 4096), odd layers global")
