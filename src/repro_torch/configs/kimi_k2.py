"""Kimi-K2-1T-A32B [arXiv:2501.kimi2; unverified, paper-table] — trillion-
parameter MoE: 384 routed experts top-8 (+1 shared), first layer dense.

AdamW optimizer state (16 B/param) cannot fit 512 x 16 GB HBM for 1e12
params; the config selects the factored Adafactor optimizer and block remat
so the per-chip HBM validity check passes (see autoshard)."""
from .base import ModelConfig
from .registry import register


@register
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        d_ff=18432, vocab_size=163840, head_dim=128,
        num_experts=384, num_shared_experts=1, top_k=8, moe_d_ff=2048,
        first_dense_layers=1, optimizer="adafactor", remat="block",
        seq_shard=True)
