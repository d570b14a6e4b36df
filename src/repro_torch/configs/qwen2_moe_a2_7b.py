"""Qwen2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed
experts, top-4 routing."""
from .base import ModelConfig
from .registry import register


@register
def qwen2_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=151936, head_dim=128,
        num_experts=60, num_shared_experts=4, top_k=4, moe_d_ff=1408)
