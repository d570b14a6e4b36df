"""Shared model components: norms, RoPE, init helpers.

The port of ``repro/models/common.py`` for serving: ``rms_norm`` needs no
hand-written gradient here, and the chunked cross-entropy comes with
training.  ``dense_init`` draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with statistics in f32 and a ``1 + scale`` gain; the result
    in x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings.  x: [B, S, H, D]; positions: [B, S] or [S]."""
    D = x.shape[-1]
    half = D // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freq = torch.pow(theta, exponent)      # a scalar base: no host copy
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freq            # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               fan_in: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn in f32 from ``generator`` on its
    device, cast to ``dtype``."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 \
        else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)


__all__ = ["dense_init", "rms_norm", "rope"]
