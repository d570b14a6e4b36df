"""GQA attention block (RoPE, optional QKV bias, local window, softcap).

The port of ``repro/models/attention.py``.  Weights keep the JAX layout
(``[in, out]``, applied as ``x @ w``).  ``attn_decode`` writes the new K/V
entry into the caches in place at a tensor position (the JAX version
returns updated copies) and returns the same tensors.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import dense_init, rope


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    dev = generator.device
    p = {
        "wq": dense_init(generator, (d, H * hd), d, dtype),
        "wk": dense_init(generator, (d, KV * hd), d, dtype),
        "wv": dense_init(generator, (d, KV * hd), d, dtype),
        "wo": dense_init(generator, (H * hd, d), H * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    q = rope(q, positions)
    k = rope(k, positions)
    return q, k, v


def attn_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, window: int = 0,
                 collect_kv: bool = False):
    """Full-sequence (prefill) attention.  With ``collect_kv`` also returns
    (k, v) as [B, KV, S, hd] for the cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    o = ops.attention(q.transpose(1, 2), k, v, causal=True, window=window,
                      logit_softcap=cfg.attn_logit_softcap)
    o = o.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    out = o @ p["wo"]
    return (out, (k, v)) if collect_kv else out


def attn_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cache_len: torch.Tensor,
                window: int = 0, k_scale=None, v_scale=None):
    """One-token decode.  x: [B, 1, d]; caches: [B, KV, Smax, hd], written
    at ``cache_len`` (a 0-d int tensor on the caches' device) in place, by
    ``index_copy_`` along the position dim: no host int is read, so the
    step can be captured.  With int8 caches, k_scale/v_scale are
    per-position scale planes [B, KV, Smax, 1] and new entries are
    quantized on write.  Returns (out [B,1,d], caches...) — scales appended
    when present."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, cache_len.reshape(1, 1))
    k_entry = k.transpose(1, 2)                # [B, KV, 1, hd]
    v_entry = v.transpose(1, 2)
    at = cache_len.reshape(1).long()
    quant = k_scale is not None
    if quant:
        k_entry, ks_new = ops.quantize_kv(k_entry)
        v_entry, vs_new = ops.quantize_kv(v_entry)
        k_scale.index_copy_(2, at, ks_new.to(k_scale.dtype))
        v_scale.index_copy_(2, at, vs_new.to(v_scale.dtype))
    k_cache.index_copy_(2, at, k_entry.to(k_cache.dtype))
    v_cache.index_copy_(2, at, v_entry.to(v_cache.dtype))
    o = ops.decode_attention(q.transpose(1, 2), k_cache, v_cache,
                             cache_len + 1, window=window,
                             logit_softcap=cfg.attn_logit_softcap,
                             k_scale=k_scale, v_scale=v_scale)
    o = o.transpose(1, 2).reshape(B, 1, cfg.num_heads * cfg.head_dim)
    out = o @ p["wo"]
    if quant:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


__all__ = ["attn_decode", "attn_forward", "init_attn"]
