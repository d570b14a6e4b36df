"""Torch oracles for the network tier's kernels (the ``ref.py`` contract of
``repro/kernels/ref.py``: matmul, VALID conv, max pool, n-ary sum).

These are ground truth, not the main path: they may call ``torch.matmul``,
``F.conv2d`` and ``F.max_pool2d``.  On the card they first switch TF32 off
for matmuls and cuDNN convolutions, so the oracles run in full float32.
``attention_ref``, ``ssd_ref`` and ``ssd_decode_ref`` come with the slices
that port their kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def full_fp32(t: torch.Tensor) -> None:
    """Switch TF32 off for cuBLAS matmuls and cuDNN convolutions when ``t``
    lies on the card (both default to TF32 somewhere in PyTorch)."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """FC-layer oracle: x [N, C] @ w [C, K] -> [N, K] in float32."""
    full_fp32(x)
    return torch.matmul(x.float(), w.float())


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """Conv-layer oracle: x [N, C, XI, YI], w [K, C, R, S] -> [N, K, XO, YO]
    with VALID padding (the layer specs bake the halo into the input)."""
    full_fp32(x)
    return F.conv2d(x.float(), w.float(), stride=stride)


def pool2d_ref(x: torch.Tensor, r: int, s: int,
               stride: int = 2) -> torch.Tensor:
    """Max-pool oracle: x [N, C, XI, YI] -> [N, C, XO, YO], VALID padding."""
    return F.max_pool2d(x.float(), (r, s), stride=stride)


def eltwise_ref(*xs: torch.Tensor) -> torch.Tensor:
    """N-ary element-wise sum oracle, operands added in order."""
    out = xs[0].float()
    for x in xs[1:]:
        out = out + x.float()
    return out


__all__ = ["conv2d_ref", "eltwise_ref", "full_fp32", "matmul_ref",
           "pool2d_ref"]
