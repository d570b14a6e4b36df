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
        # a gain of several dims (a grouped norm's [G, width]) keeps them
        dscale = (dy.float() * xhat).sum(
            dim=tuple(range(dy.dim() - scale.dim())))
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
                          chunk: int = 512, z_loss: float = 1e-4,
                          sh=None, tokens: Optional[int] = None,
                          vocab: Optional[int] = None) -> torch.Tensor:
    """CE computed per sequence chunk with rematerialization: the full
    [tokens, vocab] f32 logits tensor never materializes (fwd) and is
    recomputed per chunk (bwd), cutting the vocab projection's working set
    from O(S x V) to O(chunk x V).  The chunks' sums are added in order, as
    the reference's ``lax.scan`` adds them.

    Partitioned (``sh``, a ``models/shards.py`` ``Shards``): ``h`` and
    ``targets`` are this rank's data shard, and ``lm_head`` its chunk of
    the vocabulary where the head is sharded over ``model`` (narrower
    than ``vocab``, the whole vocabulary); each chunk's
    log-sum-exp is then a max all-reduce (no gradient) and a sum-of-exp
    all-reduce, the gold logit an all-reduce of each rank's in-shard part
    (a recomputed chunk issues them again).  The loss is this data shard's
    sum over ``tokens``, the global token count, summed over the data
    axes: on one data shard it is the reference's ``total / (B * S)``."""
    B, S, d = h.shape
    if sh is None and S % chunk != 0:
        return cross_entropy_loss(_apply_head(h, lm_head, softcap), targets,
                                  lm_head.shape[-1], z_loss)

    def one(hx, tx):
        lse, gold = _lse_gold(_apply_head(hx, lm_head, softcap), tx,
                              sh if lm_head.shape[-1] != vocab else None)
        return torch.sum(lse - gold) + z_loss * torch.sum(torch.square(lse))

    if S % chunk != 0:
        total = one(h, targets)
    else:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(S // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            total = total + checkpoint(one, h[:, sl], targets[:, sl],
                                       use_reentrant=False)
    if sh is None:
        return total / (B * S)
    return sh.all_reduce(total / tokens, sh.data_axes)


def token_losses(h: torch.Tensor, lm_head: torch.Tensor,
                 targets: torch.Tensor, softcap: float = 0.0,
                 z_loss: float = 1e-4, sh=None,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Each token's term of ``chunked_cross_entropy`` (its cross-entropy
    plus z-loss), [B, S] in f32; ``sh`` and ``vocab`` as there (this
    rank's tokens)."""
    lse, gold = _lse_gold(_apply_head(h, lm_head, softcap), targets,
                          sh if lm_head.shape[-1] != vocab else None)
    return lse - gold + z_loss * torch.square(lse)


def _lse_gold(logits: torch.Tensor, targets: torch.Tensor, sh=None):
    """Each token's log-sum-exp over the vocabulary and its target's
    logit; with ``sh`` ``logits`` are this rank's chunk of the vocabulary,
    sharded over ``model`` (the chunks in rank order)."""
    n = logits.shape[-1]
    if sh is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return lse, gold
    m = sh.all_reduce(logits.detach().amax(-1), op="max")
    lse = m + torch.log(sh.all_reduce(
        torch.exp(logits - m[..., None]).sum(-1)))
    rel = targets.long() - sh.model_rank * n
    ok = (rel >= 0) & (rel < n)
    mine = torch.gather(logits, -1, rel.clamp(0, n - 1)[..., None])[..., 0]
    return lse, sh.all_reduce(mine * ok.to(mine.dtype))


def _apply_head(h: torch.Tensor, lm_head: torch.Tensor,
                softcap: float) -> torch.Tensor:
    logits = h.float() @ lm_head.float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


__all__ = ["chunked_cross_entropy", "cross_entropy_loss", "dense_init",
           "generator", "rms_norm", "rope", "token_losses"]
