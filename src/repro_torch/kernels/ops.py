"""Public kernel API of the model zoo: attention and the SSD scan, through
the hand-written CUDA kernels on the card and their plain PyTorch versions
on the CPU.

The port of ``repro/kernels/ops.py`` (``:167-322``), serving only (no
autograd).  The tensor's device decides what runs: ``attention`` calls
``flash_attention`` and ``ssd`` calls ``ssd_intra_chunk``, which launch
their kernels for CUDA tensors and take their plain versions for CPU ones.
``decode_attention``, ``quantize_kv`` and ``ssd_decode`` are plain PyTorch,
as they are plain jnp in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as fa
from . import ref
from . import ssd_scan
from .flash_attention import NEG_INF, flash_attention
from .ssd_scan import ssd_intra_chunk


def launch_counts() -> Dict[str, int]:
    """Kernel launches of the model zoo's kernels since the last reset."""
    return {**fa.LAUNCHES, **ssd_scan.LAUNCHES}


def reset_launch_counts() -> None:
    for table in (fa.LAUNCHES, ssd_scan.LAUNCHES):
        for k in table:
            table[k] = 0


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              logit_softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head GQA attention.  q: [B,H,S,D]; k,v: [B,KV,S,D]."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window,
                           logit_softcap=logit_softcap, scale=scale)


def quantize_kv(x: torch.Tensor):
    """Per-(batch, head, position) symmetric int8 quantization of a KV
    entry [..., D] -> (int8 payload, f32 scale[..., 1])."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     window: int = 0, logit_softcap: float = 0.0,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token decode vs. a KV cache.

    q: [B, H, 1, D]; caches: [B, KV, Smax, D]; cache_len: current length
    (the new token's K/V must already be written at cache_len - 1).
    With k_scale/v_scale the caches are int8 payloads dequantized on the
    fly (per-position scales [B, KV, Smax, 1]).  Only the first
    ``cache_len`` positions are read: the rest are masked in the JAX
    version, where their softmax weight is exactly 0."""
    ref.full_fp32(q)
    B, H, _, D = q.shape
    KV = k_cache.shape[1]
    qpk = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = (q.float() * scale).reshape(B, KV, qpk, D)
    kf = k_cache[:, :, :cache_len].float()
    if k_scale is not None:
        kf = kf * k_scale[:, :, :cache_len].float()
    s = torch.matmul(qg, kf.transpose(-1, -2))            # [B, KV, qpk, n]
    if logit_softcap > 0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    if window > 0:
        kpos = torch.arange(cache_len, device=q.device)
        s = torch.where(kpos >= cache_len - window, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vf = v_cache[:, :, :cache_len].float()
    if v_scale is not None:
        vf = vf * v_scale[:, :, :cache_len].float()
    o = torch.matmul(p, vf)
    return o.reshape(B, H, 1, D).to(q.dtype)


# ---------------------------------------------------------------------------
# SSD (Mamba2)
# ---------------------------------------------------------------------------

def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int = 128):
    """Chunked SSD forward.

    x: [B,S,H,P]; dt: [B,S,H] (positive); a_log: [H]; b,c: [B,S,N] (G=1).
    Returns (y [B,S,H,P], final_state [B,H,P,N]).  The inter-chunk
    recurrence runs here in f32; the intra-chunk term goes to
    ``ssd_intra_chunk``.
    """
    ref.full_fp32(x)
    B, S, H, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the "
                         f"chunk {chunk}")
    NC = S // chunk
    a = -torch.exp(a_log.float())                             # [H]
    dtf = dt.float()
    ad = dtf * a[None, None, :]                               # [B,S,H]

    x_c = x.reshape(B, NC, chunk, H, P)
    dt_c = dtf.reshape(B, NC, chunk, H)
    ad_c = ad.reshape(B, NC, chunk, H)
    b_c = b.reshape(B, NC, chunk, N).float()
    c_c = c.reshape(B, NC, chunk, N).float()
    acum = torch.cumsum(ad_c, dim=2)                          # [B,NC,Lc,H]
    a_end = acum[:, :, -1]                                    # [B,NC,H]

    # per-chunk state contributions: sum_j exp(a_end - acum_j) dt_j x_j b_j^T
    w = torch.exp(a_end[:, :, None] - acum) * dt_c            # [B,NC,Lc,H]
    states = torch.einsum("bclh,bclhp,bcln->bchpn",
                          w, x_c.float(), b_c)                # [B,NC,H,P,N]

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
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp",
                           c_c, h0, torch.exp(acum))

    # intra-chunk quadratic term: the CUDA kernel on the card
    y_intra = ssd_intra_chunk(
        x_c.permute(0, 3, 1, 2, 4).contiguous(),              # [B,H,NC,Lc,P]
        dt_c.permute(0, 3, 1, 2).contiguous(),
        acum.permute(0, 3, 1, 2).contiguous(), b_c.contiguous(),
        c_c.contiguous())
    y_intra = y_intra.permute(0, 2, 3, 1, 4)                  # [B,NC,Lc,H,P]

    y = (y_inter + y_intra).reshape(B, S, H, P).to(x.dtype)
    return y, final_state


ssd_decode = ref.ssd_decode_ref


__all__ = ["attention", "decode_attention", "launch_counts", "quantize_kv",
           "reset_launch_counts", "ssd", "ssd_decode"]
