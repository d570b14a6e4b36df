"""Torch oracles for every kernel (the ``ref.py`` contract of
``repro/kernels/ref.py``): matmul, VALID conv, max pool and n-ary sum for
the network tier; naive attention, the sequential SSD scan and one SSD
decode step for the model zoo.

These are ground truth, not the main path: they may call ``torch.matmul``,
``F.conv2d`` and ``F.max_pool2d``.  On the card they first switch TF32 off
for matmuls and cuDNN convolutions, so the oracles run in full float32.
``ssd_decode_ref`` is also the model zoo's decode step (``ops.ssd_decode``),
as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

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


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  logit_softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive attention oracle.

    q: [B, H, Sq, D]; k, v: [B, KV, Sk, D] with H a multiple of KV (GQA).
    window > 0: local (sliding-window) attention of that width; queries are
    right-aligned into the keys (decode)."""
    full_fp32(q)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qpk = H // KV
    k = k.repeat_interleave(qpk, dim=1)
    v = v.repeat_interleave(qpk, dim=1)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = softcap(logits, logit_softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Sequential state-space-duality (Mamba2) oracle.

    x:  [B, S, H, P]   per-head inputs
    dt: [B, S, H]      softplus'd step sizes (positive)
    a_log: [H]         per-head decay (A = -exp(a_log) < 0)
    b, c: [B, S, N]    shared-across-heads (G=1) input/output projections
    returns y: [B, S, H, P]
    """
    full_fp32(x)
    Bsz, S, H, P = x.shape
    N = b.shape[-1]
    a = -torch.exp(a_log.float())
    dt = dt.float()
    decay = torch.exp(dt * a[None, None, :])                 # [B, S, H]
    xf, bf, cf = x.float(), b.float(), c.float()
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * decay[:, t, :, None, None] + \
            (dt[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_decode_ref(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                   a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """One SSD decode step.  h: [B,H,P,N]; x: [B,H,P]; dt: [B,H];
    b, c: [B,N].  Returns (h', y [B,H,P])."""
    full_fp32(x)
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt.float() * a[None, :])
    h = h * decay[..., None, None] + \
        (dt[..., None] * x.float())[..., None] * b[:, None, None, :].float()
    y = torch.einsum("bhpn,bn->bhp", h, c.float())
    return h, y.to(x.dtype)


__all__ = ["attention_ref", "conv2d_ref", "eltwise_ref", "full_fp32",
           "matmul_ref", "pool2d_ref", "softcap", "ssd_decode_ref",
           "ssd_ref"]
