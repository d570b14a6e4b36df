"""Public kernel API of the model zoo: attention and the SSD scan, through
the hand-written CUDA kernels on the card and their plain PyTorch versions
on the CPU, differentiable for training.

The port of ``repro/kernels/ops.py`` (``:84-322``).  The tensor's device
decides what runs: ``attention`` calls ``flash_attention`` and ``ssd`` calls
``ssd_intra_chunk``, which launch their kernels for CUDA tensors and take
their plain versions for CPU ones.  Where a gradient is wanted,
``attention`` goes through ``flash_attention_vjp`` (the kernel's forward
with its log-sum-exp, and the reference's recomputing backward in PyTorch)
and ``ssd``'s intra-chunk term through ``ssd_scan.ssd_intra_chunk_vjp``;
neither backward launches a kernel, as neither is a Pallas kernel in the
JAX package.  ``decode_attention``, ``quantize_kv`` and ``ssd_decode`` are
plain PyTorch, as they are plain jnp in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as fa
from . import multi_tensor, ref
from . import ssd_scan
from .flash_attention import NEG_INF, flash_attention
from .ssd_scan import ssd_intra_chunk_vjp


def launch_counts() -> Dict[str, int]:
    """Kernel launches of the model zoo's kernels since the last reset:
    the forward's and the train step's multi-tensor AdamW's."""
    return {**fa.LAUNCHES, **ssd_scan.LAUNCHES, **multi_tensor.LAUNCHES}


def reset_launch_counts() -> None:
    for table in (fa.LAUNCHES, ssd_scan.LAUNCHES, multi_tensor.LAUNCHES):
        for k in table:
            table[k] = 0


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's custom VJP
    (``repro/kernels/ops.py:84-165``): the forward saves (q, k, v, out,
    lse) and the backward RECOMPUTES each key chunk's probabilities from
    ``lse``, so no per-chunk intermediate of the forward is kept."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, scale,
                block_k):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, logit_softcap, scale, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, window: int,
                        logit_softcap: float, scale: float,
                        block_k: int = 512):
    """The reference's ``attn_bwd``, in float32 PyTorch: ``delta = Σ do·o``,
    then per key chunk of ``block_k`` the probabilities
    ``p = exp(s - lse)`` under the forward's mask and soft-cap,
    ``ds = p (dp - delta)`` (times ``1 - t²`` when soft-capped), and dk,
    dv folded over the GQA groups.  Returns (dq, dk, dv) in the inputs'
    types."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qpk = H // KV
    bk = min(block_k, Sk)
    if Sk % bk:
        raise ValueError(f"flash_attention_vjp: keys {Sk} are not a "
                         f"multiple of the key chunk {bk} (q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)})")
    qf = q.float()
    dof = do.float()
    delta = (dof * o.float()).sum(-1)                       # [B,H,Sq]
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    dq = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, Sk, bk):
        kc = k[:, :, k0:k0 + bk].repeat_interleave(qpk, dim=1).float()
        vc = v[:, :, k0:k0 + bk].repeat_interleave(qpk, dim=1).float()
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        if logit_softcap > 0:
            t = torch.tanh(s / logit_softcap)
            s = t * logit_softcap
        kpos = torch.arange(k0, k0 + bk, device=q.device)
        mask = torch.ones((Sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dv_c = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vc.transpose(-1, -2))
        ds = p * (dp - delta[..., None])
        if logit_softcap > 0:
            ds = ds * (1.0 - torch.square(t))
        ds = ds * scale
        dq = dq + torch.matmul(ds, kc)
        dk_c = torch.matmul(ds.transpose(-1, -2), qf)
        # GQA: fold q-head groups back onto shared KV heads
        dks.append(dk_c.reshape(B, KV, qpk, bk, D).sum(2))
        dvs.append(dv_c.reshape(B, KV, qpk, bk, D).sum(2))
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0,
                        scale: Optional[float] = None,
                        block_k: int = 512) -> torch.Tensor:
    """Differentiable flash attention: ``flash_attention`` forward (the
    kernel on the card, writing its log-sum-exp), ``flash_attention_bwd``
    backward.  q: [B,H,Sq,D]; k,v: [B,KV,Sk,D], contiguous."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(logit_softcap), float(scale),
                                 int(block_k))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              logit_softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head GQA attention.  q: [B,H,S,D]; k,v: [B,KV,S,D].  With
    grad enabled and any of q, k, v requiring it: ``flash_attention_vjp``;
    otherwise ``flash_attention`` (no log-sum-exp written)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_vjp(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           logit_softcap=logit_softcap, scale=scale)


def quantize_kv(x: torch.Tensor):
    """Per-(batch, head, position) symmetric int8 quantization of a KV
    entry [..., D] -> (int8 payload, f32 scale[..., 1])."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def _decode_scores(q, k_cache, cache_len, pos0, window, logit_softcap,
                   scale, k_scale):
    """The f32 scores [B, KV, qpk, Sw] of one decode query against cache
    positions ``pos0 ..`` (dequantised, soft-capped), and the mask of the
    visible ones: before ``cache_len`` and, with a window, not before
    ``cache_len - window``; a hidden score is -1e30."""
    ref.full_fp32(q)
    B, H, _, D = q.shape
    KV, Sw = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qg = (q.float() * scale).reshape(B, KV, H // KV, D)
    kf = k_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float()
    s = torch.matmul(qg, kf.transpose(-1, -2))            # [B, KV, qpk, Sw]
    if logit_softcap > 0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    kpos = torch.arange(pos0, pos0 + Sw, device=q.device)
    mask = kpos < cache_len
    if window > 0:
        mask = mask & (kpos >= cache_len - window)
    return torch.where(mask, s, NEG_INF), mask


def _dequant(v_cache, v_scale):
    vf = v_cache.float()
    return vf * v_scale.float() if v_scale is not None else vf


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     window: int = 0, logit_softcap: float = 0.0,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token decode vs. a KV cache.

    q: [B, H, 1, D]; caches: [B, KV, Smax, D]; cache_len: [] int tensor,
    the current length (the new token's K/V must already be written at
    cache_len - 1).  With k_scale/v_scale the caches are int8 payloads
    dequantized on the fly (per-position scales [B, KV, Smax, 1]).  As the
    reference, it reads all ``Smax`` positions and masks those at or past
    ``cache_len`` (and, with a window, those before ``cache_len -
    window``), so the length stays on the device and the step can be
    captured; a masked position's softmax weight is exactly 0."""
    s, _ = _decode_scores(q, k_cache, cache_len, 0, window, logit_softcap,
                          scale, k_scale)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, _dequant(v_cache, v_scale))
    return o.reshape(q.shape).to(q.dtype)


def decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, cache_len: torch.Tensor, pos0: int,
                   window: int = 0, logit_softcap: float = 0.0,
                   scale: Optional[float] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None):
    """``decode_attention`` over one window of a cache whose positions are
    sharded: the window holds positions ``pos0 ..``.  Returns the
    unnormalised f32 output [B, H, 1, D], the scores' max m and the
    softmax denominator l [B, H, 1, 1] of this window, which the ranks
    combine (max of m, then the sums of o and l scaled by exp(m - max)).
    A window with no visible position gives m = -1e30, whose weight after
    the combine is exactly 0."""
    s, mask = _decode_scores(q, k_cache, cache_len, pos0, window,
                             logit_softcap, scale, k_scale)
    B, H, _, D = q.shape
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    o = torch.matmul(p, _dequant(v_cache, v_scale))
    return (o.reshape(B, H, 1, D), m.reshape(B, H, 1, 1),
            p.sum(-1, keepdim=True).reshape(B, H, 1, 1))


# ---------------------------------------------------------------------------
# SSD (Mamba2)
# ---------------------------------------------------------------------------

def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int = 128):
    """Chunked SSD forward.

    x: [B,S,H,P]; dt: [B,S,H] (positive); a_log: [H]; b,c: [B,S,N] (one
    group, shared by every head) or [B,S,G,N] (G groups, G dividing H:
    head h reads group h // (H / G)).  Returns (y [B,S,H,P], final_state
    [B,H,P,N]).  The inter-chunk recurrence runs here in f32; the
    intra-chunk term goes to ``ssd_intra_chunk``, one launch for all the
    groups.  [B,S,N] is taken as [B,S,1,N].
    """
    ref.full_fp32(x)
    B, S, H, P = x.shape
    N = b.shape[-1]
    if b.dim() == 3:                          # one group, shared by all
        b, c = b[:, :, None], c[:, :, None]
    G = b.shape[2]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the "
                         f"chunk {chunk}")
    if H % G:
        raise ValueError(f"ssd: {G} groups of B and C for {H} heads")
    NC = S // chunk
    a = -torch.exp(a_log.float())                             # [H]
    dtf = dt.float()
    ad = dtf * a[None, None, :]                               # [B,S,H]

    x_c = x.reshape(B, NC, chunk, H, P)
    dt_c = dtf.reshape(B, NC, chunk, H)
    ad_c = ad.reshape(B, NC, chunk, H)
    b_c = b.reshape(B, NC, chunk, G, N).float()               # [B,NC,Lc,G,N]
    c_c = c.reshape(B, NC, chunk, G, N).float()
    acum = torch.cumsum(ad_c, dim=2)                          # [B,NC,Lc,H]
    a_end = acum[:, :, -1]                                    # [B,NC,H]

    def by_group(t, at: int):
        """``t`` with its heads axis ``at`` split into [G, H / G]."""
        return t.reshape(*t.shape[:at], G, H // G, *t.shape[at + 1:])

    # per-chunk state contributions: sum_j exp(a_end - acum_j) dt_j x_j b_j^T
    w = torch.exp(a_end[:, :, None] - acum) * dt_c            # [B,NC,Lc,H]
    states = torch.einsum(
        "bclgh,bclghp,bclgn->bcghpn", by_group(w, 3),
        by_group(x_c.float(), 3), b_c).reshape(B, NC, H, P, N)

    # inter-chunk recurrence (sequential over NC, cheap)
    decay_chunk = torch.exp(a_end)                            # [B,NC,H]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h0 = []
    for i in range(NC):
        s_prev = states[:, i - 1] if i else torch.zeros_like(h)
        h = h * decay_chunk[:, i, :, None, None] + s_prev
        h0.append(h)
    h0 = torch.stack(h0, dim=1)                               # [B,NC,H,P,N]
    final_state = h0[:, -1] * decay_chunk[:, -1][..., None, None] \
        + states[:, -1]

    # inter-chunk output term
    y_inter = torch.einsum(
        "bclgn,bcghpn,bclgh->bclghp", c_c, by_group(h0, 2),
        by_group(torch.exp(acum), 3)).reshape(B, NC, chunk, H, P)
    # the kernel's B and C: one [Lc, N] slab a (b, chunk, group)
    b_c, c_c = b_c.transpose(2, 3), c_c.transpose(2, 3)

    # intra-chunk quadratic term: the CUDA kernel on the card
    y_intra = ssd_intra_chunk_vjp(
        x_c.permute(0, 3, 1, 2, 4).contiguous(),              # [B,H,NC,Lc,P]
        dt_c.permute(0, 3, 1, 2).contiguous(),
        acum.permute(0, 3, 1, 2).contiguous(), b_c.contiguous(),
        c_c.contiguous())
    y_intra = y_intra.permute(0, 2, 3, 1, 4)                  # [B,NC,Lc,H,P]

    y = (y_inter + y_intra).reshape(B, S, H, P).to(x.dtype)
    return y, final_state


ssd_decode = ref.ssd_decode_ref


__all__ = ["attention", "decode_attention", "decode_partial",
           "flash_attention_bwd", "flash_attention_vjp", "launch_counts",
           "quantize_kv", "reset_launch_counts", "ssd", "ssd_decode"]
