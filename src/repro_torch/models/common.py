"""Shared model components: norms, RoPE, init helpers, the losses.

The port of ``repro/models/common.py``.  ``rms_norm`` is a
``torch.autograd.Function`` with the reference's hand-written backward;
``chunked_cross_entropy`` recomputes each chunk's logits in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
``dense_init`` draws from an explicit ``torch.Generator`` (``generator``
makes one); on the ``meta`` device, which has no generator, it draws
nothing and returns a tensor of the right shape and type.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

RMS_EPS = 1e-6


def _rms_norm_impl(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + RMS_EPS)
    return (y * (1.0 + scale.float())).to(x.dtype)


class _RmsNorm(torch.autograd.Function):
    """The reference's ``custom_vjp``: the saved residuals are x and scale
    in their own types, and the backward recomputes the statistics in f32
    (``repro/models/common.py:33-45``)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return _rms_norm_impl(x, scale)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + RMS_EPS)
        xhat = xf * rstd
        w = 1.0 + scale.float()
        u = dy.float() * w
        dx = rstd * (u - xhat * (u * xhat).mean(-1, keepdim=True))
        dscale = (dy.float() * xhat).sum(dim=tuple(range(dy.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm with statistics in f32 and a ``1 + scale`` gain; the result
    in x's dtype.  Differentiable through the hand-written backward of
    ``_RmsNorm``: the saved residuals stay in x's dtype, so no f32
    [B, S, d] copy is kept for every layer's backward."""
    return _RmsNorm.apply(x, scale)


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


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on ``meta``, which has none:
    ``dense_init`` draws nothing from it."""
    device = torch.device("meta")


def generator(device: torch.device, seed: int):
    """A generator on ``device`` seeded with ``seed`` (a ``MetaGenerator``
    on ``meta``)."""
    if device.type == "meta":
        return MetaGenerator()
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def dense_init(generator: torch.Generator, shape: Sequence[int],
               fan_in: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn in f32 from ``generator`` on its
    device, cast to ``dtype``; on ``meta`` an empty tensor of that shape
    and type, drawing nothing."""
    if generator.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 \
        else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       vocab_size: int, z_loss: float = 1e-4) -> torch.Tensor:
    """Token CE with optional z-loss; logits: [B,S,V], targets: [B,S]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss > 0:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def chunked_cross_entropy(h: torch.Tensor, lm_head: torch.Tensor,
                          targets: torch.Tensor, softcap: float = 0.0,
                          chunk: int = 512,
                          z_loss: float = 1e-4) -> torch.Tensor:
    """CE computed per sequence chunk with rematerialization: the full
    [tokens, vocab] f32 logits tensor never materializes (fwd) and is
    recomputed per chunk (bwd), cutting the vocab projection's working set
    from O(S x V) to O(chunk x V).  The chunks' sums are added in order, as
    the reference's ``lax.scan`` adds them."""
    B, S, d = h.shape
    if S % chunk != 0:
        return cross_entropy_loss(_apply_head(h, lm_head, softcap), targets,
                                  lm_head.shape[-1], z_loss)

    def one(hx, tx):
        logits = _apply_head(hx, lm_head, softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tx[..., None].long())[..., 0]
        return torch.sum(lse - gold) + z_loss * torch.sum(torch.square(lse))

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(one, h[:, sl], targets[:, sl],
                                   use_reentrant=False)
    return total / (B * S)


def _apply_head(h: torch.Tensor, lm_head: torch.Tensor,
                softcap: float) -> torch.Tensor:
    logits = h.float() @ lm_head.float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


__all__ = ["chunked_cross_entropy", "cross_entropy_loss", "dense_init",
           "generator", "rms_norm", "rope"]
