"""Flash attention: the wrapper of the hand-written CUDA kernels
(``csrc/model_kernels.cu``) and their plain PyTorch version.

The port of ``repro/kernels/flash_attention.py``.  Causal or non-causal GQA
attention with an online softmax: GQA head ``h`` reads KV head
``h // (H / KV)``, queries are right-aligned into a longer KV
(``q_offset = Sk - Sq``), with an optional sliding window and a tanh logit
soft-cap (Gemma2).  f32 accumulation, output in q's dtype.

``flash_attention`` launches a kernel for CUDA tensors (or raises) and
takes ``plain_flash_attention`` for CPU tensors.  ``PATHS`` names the kernel
each (dtype, head dim) runs: ``"wgmma"``, the tensor-core kernel
(``flash_wgmma_kernel``: TMA, wgmma, bf16 P in P V), or ``"fma"``, the
f32 FMA tile on the CUDA cores (``flash_kernel``).  ``LAUNCHES`` counts
kernel launches: ``flash_attention`` all of them, ``flash_attention_wgmma``
those of the tensor-core kernel.  With ``return_lse=True`` both kernels
(and the plain version) also return each query row's log-sum-exp,
``m + log(max(l, 1e-30))`` in natural-log units, float32 [B, H, Sq], as
the reference's ``_chunked_attention_jnp(..., return_lse=True)`` does: the
backward of ``ops.flash_attention_vjp`` rebuilds the probabilities from it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import backend, ref

#: kernel launches since the last ``ops.reset_launch_counts()``: all of
#: them, and those of the tensor-core kernel
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_wgmma": 0}

#: the TPU kernel the CUDA kernel replaces (file:line of its definition)
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:80"}

SOURCE = "src/repro_torch/csrc/model_kernels.cu"
NEG_INF = -1e30
#: tile sizes of the kernel, and of the plain version's walk
BLOCK_Q = BLOCK_K = 64
#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the kernel each (dtype, head dim) runs on the card: the tensor-core
#: kernel for bf16 at 64, 128 and 256, the FMA tile for the rest
PATHS = {**{(torch.float32, d): "fma" for d in HEAD_DIMS},
         (torch.bfloat16, 16): "fma", (torch.bfloat16, 32): "fma",
         (torch.bfloat16, 64): "wgmma", (torch.bfloat16, 128): "wgmma",
         (torch.bfloat16, 256): "wgmma"}
#: path codes of ``kapla_flash_attention``
_PATH_CODES = {"fma": 0, "wgmma": 1}


def flash_path(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel ``flash_attention`` runs on the card for q of ``dtype``
    and head dim ``head_dim``; raises for what neither kernel takes."""
    path = PATHS.get((dtype, head_dim))
    if path is None:
        raise ValueError(f"flash_attention: no kernel for {dtype} at head "
                         f"dim {head_dim}; the kernels take float32 and "
                         f"bfloat16 at head dims {HEAD_DIMS}")
    return path


def _mask(q0: int, bq: int, k0: int, bk: int, q_offset: int, causal: bool,
          window: int, device) -> torch.Tensor:
    """[bq, bk] keep-mask of the (q-block, kv-block) tile (absolute
    positions: query row r sits at r + q_offset)."""
    qpos = torch.arange(q0, q0 + bq, device=device)[:, None] + q_offset
    kpos = torch.arange(k0, k0 + bk, device=device)[None, :]
    mask = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          logit_softcap: float = 0.0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Walks (q-block, kv-block) tiles of the kernel's sizes in order with
    the online-softmax update of ``_flash_kernel``: scores in f32, scaled,
    soft-capped, masked to ``NEG_INF``; ``p`` zeroed by the mask;
    ``acc / max(l, 1e-30)``.  Batches and heads are vectorized; GQA groups
    the query heads of a KV head.  Ragged last blocks are allowed.  With
    ``return_lse`` also ``m + log(max(l, 1e-30))`` of the walk, float32
    [B, H, Sq]."""
    ref.full_fp32(q)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qpk = H // KV
    scale = scale if scale is not None else D ** -0.5
    q_offset = Sk - Sq
    qg = q.float().reshape(B, KV, qpk, Sq, D)
    kf = k.float()[:, :, None]                     # [B, KV, 1, Sk, D]
    vf = v.float()[:, :, None]
    out = torch.empty((B, KV, qpk, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, KV, qpk, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, BLOCK_Q):
        qb = qg[:, :, :, q0:q0 + BLOCK_Q]
        bq = qb.shape[3]
        acc = torch.zeros((B, KV, qpk, bq, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KV, qpk, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, Sk, BLOCK_K):
            kb = kf[:, :, :, k0:k0 + BLOCK_K]
            vb = vf[:, :, :, k0:k0 + BLOCK_K]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if logit_softcap > 0:
                s = torch.tanh(s / logit_softcap) * logit_softcap
            mask = _mask(q0, bq, k0, kb.shape[3], q_offset, causal, window,
                         q.device)
            s = torch.where(mask, s, NEG_INF)
            m_cur = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_cur)
            p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            m = m_cur
            acc = acc * alpha[..., None] + torch.matmul(p, vb)
        out[:, :, :, q0:q0 + bq] = (
            acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        lse[:, :, :, q0:q0 + bq] = m + torch.log(torch.clamp(l, min=1e-30))
    out = out.reshape(B, H, Sq, D)
    return (out, lse.reshape(B, H, Sq)) if return_lse else out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention {name}: expected a "
                            f"torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention {name}: shape "
                             f"{tuple(t.shape)}, expected 4 dims")
        if t.device != q.device:
            raise ValueError(f"flash_attention {name}: on {t.device}, "
                             f"expected {q.device}")
        if t.dtype != q.dtype or t.dtype not in backend.DTYPE_CODES:
            raise TypeError(f"flash_attention {name}: dtype {t.dtype}; q, k "
                            "and v must share float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention {name}: must be contiguous")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         "as [B, KV, Sk, D]")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={k.shape[1]}")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention: empty sequence")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """q: [B, H, Sq, D]; k, v: [B, KV, Sk, D], H % KV == 0, contiguous,
    float32 or bfloat16.  The CUDA kernel on the card, the plain version on
    the CPU, outputs of the right shape and type on ``meta`` (nothing
    launched).  With ``return_lse``: (out, lse [B, H, Sq] float32);
    without, the kernel gets a null ``lse`` and writes none.  A cost
    counter (``launch/op_cost.py``) counts the call as one unit."""
    _check(q, k, v)
    with backend.kernel_call("flash_attention", q, k, v, causal=causal,
                             window=window, return_lse=return_lse):
        if q.device.type == "cpu":
            return plain_flash_attention(q, k, v, causal, window,
                                         logit_softcap, scale, return_lse)
        if q.is_meta:            # what the card would take, nothing run
            flash_path(q.dtype, q.shape[3])
            out = torch.empty_like(q)
            return (out, torch.empty(q.shape[:3], dtype=torch.float32,
                                     device=q.device)) if return_lse else out
        return _launch(q, k, v, causal, window, logit_softcap, scale,
                       return_lse)


def _launch(q, k, v, causal, window, logit_softcap, scale, return_lse):
    """One launch of the kernel ``flash_path`` picks, on the card."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    path = flash_path(q.dtype, D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if path == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: the tensor-core kernel's TMA "
                         "needs 16-byte aligned q, k, v and output")
    scale = scale if scale is not None else D ** -0.5
    prm = (ctypes.c_int64 * 10)(B, H, KV, Sq, Sk, D, int(bool(causal)),
                                int(window), backend.DTYPE_CODES[q.dtype],
                                _PATH_CODES[path])
    fprm = (ctypes.c_double * 2)(float(scale), float(logit_softcap))
    with torch.cuda.device(q.device):
        fn = backend.library(backend.MODEL_SOURCE).kapla_flash_attention
        backend.check_launch("kapla_flash_attention", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), prm, fprm,
            backend.stream_handle(q.device)))
    LAUNCHES["flash_attention"] += 1
    if path == "wgmma":
        LAUNCHES["flash_attention_wgmma"] += 1
    return (out, lse) if return_lse else out


__all__ = ["BLOCK_K", "BLOCK_Q", "HEAD_DIMS", "LAUNCHES", "PATHS",
           "REPLACES", "SOURCE", "flash_attention", "flash_path",
           "plain_flash_attention"]
