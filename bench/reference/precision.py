"""The precisions a plain reference computes in.

``"f32"`` is the reference itself: float32 throughout, TF32 off.  The
two controls are the same arithmetic a step below the precision a
configuration states, for the products that carry the work:

* ``"tf32"`` (below float32): every operand of a product rounded to
  TF32's 10 mantissa bits, to nearest, and summed in float32, as the
  card's TF32 tensor cores compute;
* ``"fp8"`` (below bfloat16): every operand of a product scaled per
  tensor into float8 e4m3's range, rounded to e4m3 and scaled back, the
  products summed in float32; in a backward the incoming gradient is
  rounded the same way before each product.

Rounding is emulated with PyTorch's own types, so a control reads the
same on the CPU and on the card.
"""
from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "fp8")
#: the largest finite float8 e4m3 value
E4M3_MAX = 448.0


def full_fp32() -> None:
    """No TF32 in cuBLAS or cuDNN products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to nearest TF32 (10 mantissa bits)."""
    bits = t.float().contiguous().view(torch.int32)
    # round half away from zero on the 13 dropped bits, then drop them
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor."""
    tf = t.float()
    scale = tf.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (tf / scale).to(torch.float8_e4m3fn).float() * scale


def rounder(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return {"f32": None, "tf32": tf32_round, "fp8": fp8_round}[precision]


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded; the backward rounds the
    incoming gradient and the saved operands before each product."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.rnd(g)
        ga = rg @ rb.transpose(-1, -2)
        gb = ra.transpose(-1, -2) @ rg
        # a broadcast operand's gradient is summed over the broadcast dims
        while gb.dim() > rb.dim():
            gb = gb.sum(0)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32"):
    """``a @ b`` in float32 at ``precision``."""
    rnd = rounder(precision)
    a, b = a.float(), b.float()
    if rnd is None:
        return a @ b
    return _RoundedMatmul.apply(a, b, rnd)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, rnd):
        ctx.rnd = rnd
        return rnd(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def operand(t: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """``t`` in float32 as an operand of a product at ``precision``."""
    rnd = rounder(precision)
    t = t.float()
    return t if rnd is None else _Rounded.apply(t, rnd)
