"""GQA attention block (RoPE, optional QKV bias, local window, softcap).

The port of ``repro/models/attention.py``.  Weights keep the JAX layout
(``[in, out]``, applied as ``x @ w``).  ``attn_decode`` writes the new K/V
entry into the caches in place at a tensor position (the JAX version
returns updated copies) and returns the same tensors.

With a ``Shards`` (``models/shards.py``) both run on one rank's local
heads: the head counts come from the local ``wq``/``wk`` shards, the
output projection's partial sums are finished over ``model``, and where
the plan replicates K/V (KV heads that do not divide the model axis) each
rank's query heads read their own KV heads (``heads_for``).  A decode
step reads and writes its rank's window of the cache (``Layout``): its KV
heads and, where the cache's positions are sharded, its positions, whose
partial softmax sums are combined over those axes (``decode_partial``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import dense_init, rope
from .shards import Layout, Shards, heads_for, local_share


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
    hd = cfg.head_dim
    # the local heads: all of them on one card
    H, KV = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
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


def _query_heads(q: torch.Tensor, cfg: ModelConfig,
                 sh: Optional[Shards]):
    """(local query heads, the first one's global index)."""
    n = q.shape[1]
    return n, (sh.model_offset(n, cfg.num_heads) if sh is not None else 0)


def attn_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, window: int = 0,
                 collect_kv: bool = False, sh: Optional[Shards] = None,
                 seq: bool = False):
    """Full-sequence (prefill) attention.  With ``collect_kv`` also returns
    (k, v) as [B, KV, S, hd] for the cache (the local KV heads).  With
    ``sh`` the output is finished over ``model`` (``Shards.finish``;
    ``seq``: this rank's chunk of a sequence-sharded residual); a rank's
    query heads enter its input, and K/V's projections where the plan
    keeps them whole (``local_share``)."""
    B, S, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    n = p["wq"].shape[-1] // hd                 # the local query heads
    h0 = sh.model_offset(n, H) if sh is not None else 0
    whole = [k for k in ("wk", "wv", "bk", "bv")
             if k in p and p[k].shape[-1] == KV * hd]
    p, x = local_share(p, x, sh, n < H, seq, whole)
    kv0, kvn = 0, KV
    if whole and n < H and not collect_kv:
        # K/V kept whole: project only the run of KV heads the local
        # query heads read (the cache, when collected, takes them all)
        qpk = H // KV
        kv0 = h0 // qpk
        kvn = (h0 + n - 1) // qpk + 1 - kv0
        p = {k: v[..., kv0 * hd:(kv0 + kvn) * hd] if k in whole else v
             for k, v in p.items()}
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    q = q.transpose(1, 2)
    kq, vq = k, v
    if k.shape[1] == kvn:          # whole KV heads: each query head's own
        kq, vq = (heads_for(t, kvn * (H // KV), kvn, h0 - kv0 * (H // KV),
                            n) for t in (k, v))
    o = ops.attention(q, kq, vq, causal=True, window=window,
                      logit_softcap=cfg.attn_logit_softcap)
    o = o.transpose(1, 2).reshape(B, S, n * cfg.head_dim)
    out = o @ p["wo"]
    if sh is not None:
        out = sh.finish(out, partial=n < cfg.num_heads, seq=seq)
    return (out, (k, v)) if collect_kv else out


def attn_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cache_len: torch.Tensor,
                window: int = 0, k_scale=None, v_scale=None,
                sh: Optional[Shards] = None,
                layout: Optional[Layout] = None):
    """One-token decode.  x: [B, 1, d]; caches: [B, KV, Smax, hd], written
    at ``cache_len`` (a 0-d int tensor on the caches' device) in place, by
    ``index_copy_`` along the position dim: no host int is read, so the
    step can be captured.  With int8 caches, k_scale/v_scale are
    per-position scale planes [B, KV, Smax, 1] and new entries are
    quantized on write.  Returns (out [B,1,d], caches...) — scales appended
    when present.  With ``sh`` the caches are this rank's window of one
    layer's cache, ``layout`` (``Shards.layout`` of the layer-stacked
    cache: dims 2 and 3 are the KV heads and the positions)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, cache_len.reshape(1, 1))
    k_entry = k.transpose(1, 2)                # [B, KV, 1, hd]
    v_entry = v.transpose(1, 2)
    quant = k_scale is not None
    if sh is None:
        at = cache_len.reshape(1).long()
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
    o = _decode_sharded(q.transpose(1, 2), k_entry, v_entry, cfg, k_cache,
                        v_cache, cache_len, window, k_scale, v_scale, sh,
                        layout)
    n = q.shape[2]
    out = o.transpose(1, 2).reshape(B, 1, n * cfg.head_dim) @ p["wo"]
    out = sh.finish(out, partial=n < cfg.num_heads)
    if quant:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


def _write_entry(cache: torch.Tensor, entry: torch.Tensor,
                 cache_len: torch.Tensor, s0: int) -> None:
    """Write ``entry`` [B, KV, 1, X] at global position ``cache_len`` of a
    cache window holding positions ``s0 ..``: in place where the position
    falls in the window, a rewrite of the same row elsewhere (no host
    int is read)."""
    n = cache.shape[2]
    j = (cache_len - s0).reshape(1).long()
    inside = (j >= 0) & (j < n)
    jj = j.clamp(0, n - 1)
    old = cache.index_select(2, jj)
    cache.index_copy_(2, jj, torch.where(inside, entry.to(cache.dtype), old))


def _decode_sharded(q, k_entry, v_entry, cfg: ModelConfig, k_cache,
                    v_cache, cache_len, window, k_scale, v_scale,
                    sh: Shards, layout: Layout) -> torch.Tensor:
    """The decode attention of one rank: writes its window of the cache
    and returns the output [B, n, 1, hd] of its ``n`` local query heads
    (all heads where the output projection is replicated)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    qpk = H // KV
    kv0, s0 = layout.offsets[2], layout.offsets[3]
    kvc = k_cache.shape[1]
    seq_axes = layout.axes[3]
    n, h0 = _query_heads(q, cfg, sh)
    # ---- this rank's KV heads of the new entry, written into its window
    kvw0 = sh.model_offset(k_entry.shape[1], KV)
    if k_entry.shape[1] != kvc or kvw0 != kv0:
        k_entry = k_entry[:, kv0 - kvw0:kv0 - kvw0 + kvc]
        v_entry = v_entry[:, kv0 - kvw0:kv0 - kvw0 + kvc]
    if k_scale is not None:
        k_entry, ks_new = ops.quantize_kv(k_entry)
        v_entry, vs_new = ops.quantize_kv(v_entry)
        _write_entry(k_scale, ks_new, cache_len, s0)
        _write_entry(v_scale, vs_new, cache_len, s0)
    _write_entry(k_cache, k_entry, cache_len, s0)
    _write_entry(v_cache, v_entry, cache_len, s0)
    # ---- which query heads meet this window, and over which KV heads
    kc, vc, ksc, vsc = k_cache, v_cache, k_scale, v_scale
    if "model" in seq_axes:
        # positions over model: every rank attends all heads over its
        # positions, then keeps its own heads
        qa = sh.all_gather(q, 1) if n < H else q
    elif kvc == KV:
        qa = q
        kc, vc = (heads_for(t, H, KV, h0, n) for t in (k_cache, v_cache))
        if k_scale is not None:
            ksc, vsc = (heads_for(t, H, KV, h0, n)
                        for t in (k_scale, v_scale))
    else:                                       # KV heads over model
        qa = q if n < H else q[:, kv0 * qpk:(kv0 + kvc) * qpk]
    if seq_axes:
        o, m, l = ops.decode_partial(
            qa, kc, vc, cache_len + 1, s0, window=window,
            logit_softcap=cfg.attn_logit_softcap, k_scale=ksc,
            v_scale=vsc)
        mx = sh.all_reduce(m, seq_axes, "max")
        w = torch.exp(m - mx)
        o = sh.all_reduce(o * w, seq_axes) / sh.all_reduce(l * w, seq_axes)
        o = o.to(q.dtype)
    else:
        o = ops.decode_attention(qa, kc, vc, cache_len + 1, window=window,
                                 logit_softcap=cfg.attn_logit_softcap,
                                 k_scale=ksc, v_scale=vsc)
    if "model" in seq_axes:
        return o[:, h0:h0 + n] if n < H else o
    if n < H or kvc == KV:
        return o
    return sh.all_gather(o, 1)            # KV over model, wo replicated


__all__ = ["attn_decode", "attn_forward", "init_attn"]
