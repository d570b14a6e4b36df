"""Mamba2 SSD intra-chunk term: the wrapper of the hand-written CUDA kernel
(``csrc/model_kernels.cu`` ``ssd_intra_kernel``) and its plain PyTorch
version.

The port of ``repro/kernels/ssd_scan.py``.  Per (batch, head, chunk):

    y = tril((C Bᵀ) ⊙ exp(acum_l − acum_m) ⊙ dt_m) @ x

with B and C shared across heads (G = 1).  The inter-chunk recurrence stays
in ``ops.ssd``.  ``ssd_intra_chunk`` launches the kernel for CUDA tensors (or
raises) and takes ``plain_ssd_intra_chunk`` for CPU tensors.  ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import backend, ref

#: kernel launches since the last ``ops.reset_launch_counts()``
LAUNCHES: Dict[str, int] = {"ssd_intra_chunk": 0}

#: the TPU kernel the CUDA kernel replaces (file:line of its definition)
REPLACES = {"ssd_intra_chunk": "src/repro/kernels/ssd_scan.py:40"}

SOURCE = "src/repro_torch/csrc/model_kernels.cu"
#: the kernel's largest chunk length and head dim
MAX_CHUNK, MAX_HEAD_DIM = 128, 64


def plain_ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor,
                          acum: torch.Tensor, b: torch.Tensor,
                          c: torch.Tensor) -> torch.Tensor:
    """The body of ``_ssd_intra_kernel`` batched over (b, h, chunk), in
    f32: ``scores = (c bᵀ) * exp(acum_l - acum_m) * dt_m`` on and below the
    diagonal (the exponent is zeroed above it, so no ``inf`` is formed),
    ``y = scores @ x`` in x's dtype."""
    ref.full_fp32(x)
    Lc = x.shape[3]
    scores = torch.matmul(c.float(), b.float().transpose(-1, -2))
    scores = scores[:, None]                           # [B, 1, NC, Lc, Lc]
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    acum = acum.float()
    diff = torch.where(tri, acum[..., :, None] - acum[..., None, :], 0.0)
    scores = scores * torch.exp(diff) * dt.float()[..., None, :]
    scores = torch.where(tri, scores, 0.0)
    return torch.matmul(scores, x.float()).to(x.dtype)


def _check(x, dt, acum, b, c) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (x, dt, acum, b, c)):
        raise TypeError("ssd_intra_chunk: expected torch.Tensors")
    if x.dim() != 5:
        raise ValueError(f"ssd_intra_chunk x: shape {tuple(x.shape)}, "
                         "expected [B, H, NC, Lc, P]")
    B, H, NC, Lc, P = x.shape
    N = b.shape[-1] if b.dim() == 4 else -1
    want = {"dt": (dt, (B, H, NC, Lc)), "acum": (acum, (B, H, NC, Lc)),
            "b": (b, (B, NC, Lc, N)), "c": (c, (B, NC, Lc, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_intra_chunk {name}: shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_chunk {name}: dtype {t.dtype}, "
                            "expected float32")
    if x.dtype not in backend.DTYPE_CODES:
        raise TypeError(f"ssd_intra_chunk x: dtype {x.dtype}, expected "
                        "float32 or bfloat16")
    for name, t in (("x", x), ("dt", dt), ("acum", acum), ("b", b),
                    ("c", c)):
        if t.device != x.device:
            raise ValueError(f"ssd_intra_chunk {name}: on {t.device}, "
                             f"expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk {name}: must be contiguous")


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, acum: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD term.

    x:    [B, H, NC, Lc, P]   (float32 or bfloat16)
    dt:   [B, H, NC, Lc]      (positive step sizes, float32)
    acum: [B, H, NC, Lc]      (within-chunk cumsum of dt * A, float32)
    b, c: [B, NC, Lc, N]      (G=1: shared across heads, float32)
    returns y_intra: [B, H, NC, Lc, P] in x's dtype.  The CUDA kernel on
    the card (Lc <= 128, P <= 64), the plain version on the CPU.
    """
    _check(x, dt, acum, b, c)
    if x.device.type == "cpu":
        return plain_ssd_intra_chunk(x, dt, acum, b, c)
    if not x.is_cuda:
        raise ValueError(f"ssd_intra_chunk: unsupported device {x.device}")
    B, H, NC, Lc, P = x.shape
    N = b.shape[-1]
    if Lc > MAX_CHUNK or P > MAX_HEAD_DIM:
        raise ValueError(f"ssd_intra_chunk: chunk {Lc} > {MAX_CHUNK} or "
                         f"head dim {P} > {MAX_HEAD_DIM}")
    prm = (ctypes.c_int64 * 7)(B, H, NC, Lc, P, N,
                               backend.DTYPE_CODES[x.dtype])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = backend.library(backend.MODEL_SOURCE).kapla_ssd_intra_chunk
        backend.check_launch("kapla_ssd_intra_chunk", fn(
            x.data_ptr(), dt.data_ptr(), acum.data_ptr(), b.data_ptr(),
            c.data_ptr(), out.data_ptr(), prm,
            backend.stream_handle(x.device)))
    LAUNCHES["ssd_intra_chunk"] += 1
    return out


__all__ = ["LAUNCHES", "MAX_CHUNK", "MAX_HEAD_DIM", "REPLACES", "SOURCE",
           "plain_ssd_intra_chunk", "ssd_intra_chunk"]
