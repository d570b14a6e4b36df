"""Mamba2 (SSD) block: in-proj -> causal conv -> selective SSM -> gated out.

The port of ``repro/models/ssm.py``.  Prefill uses the chunked SSD path
(``kernels.ops.ssd``, whose intra-chunk term is the CUDA kernel on the
card); decode keeps O(1) per-token state (conv tail + SSM state).
Projections stay separate weights (w_z, w_x, w_b, w_c, w_dt) in the JAX
layout (``[in, out]``, applied as ``x @ w``).

With a ``Shards`` both run on one rank's local heads: the inner width and
the heads come from the local ``w_x``/``w_dt`` shards (the plan shards
them over ``model`` together), the convolution runs on the local
channels, B and C (replicated, one group) are computed on every rank, the
gated norm's statistics are summed over ``model``, and the output
projection's partial sums are finished there.  In training the block's
input, B and C's leaves and the norm's variance enter the local heads
(``Shards.enter``), so their gradients are summed over ``model``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import RMS_EPS, dense_init, rms_norm
from .shards import Shards, local_share

#: the per-layer decode state of a Mamba2 block
STATE_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")
#: leaves kept in f32 whatever the model dtype
F32_LEAVES = ("a_log", "dt_bias", "d_skip")
#: the leaves a plan keeps whole when it shards the heads: B and C's
#: projections and convolutions, read by every local head
WHOLE = ("w_b", "w_c", "conv_b_w", "conv_b_b", "conv_c_w", "conv_c_b")


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    return di, H, cfg.ssm_state


def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di, H, N = ssm_dims(cfg)
    cw = cfg.conv_width
    dev = generator.device
    g = generator
    return {
        "w_z": dense_init(g, (d, di), d, dtype),
        "w_x": dense_init(g, (d, di), d, dtype),
        "w_b": dense_init(g, (d, N), d, dtype),
        "w_c": dense_init(g, (d, N), d, dtype),
        "w_dt": dense_init(g, (d, H), d, dtype),
        "conv_x_w": dense_init(g, (cw, di), cw, dtype),
        "conv_b_w": dense_init(g, (cw, N), cw, dtype),
        "conv_c_w": dense_init(g, (cw, N), cw, dtype),
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_b_b": torch.zeros((N,), dtype=dtype, device=dev),
        "conv_c_b": torch.zeros((N,), dtype=dtype, device=dev),
        "a_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "w_out": dense_init(g, (di, d), di, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  x: [B,S,C]; w: [cw, C]; the taps
    are added in order in x's dtype, as the JAX version does."""
    B, S, C = x.shape
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = xp[:, 0:S] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + S] * w[i]
    return F.silu(y + b)


def _local_dims(p: Mapping[str, torch.Tensor], cfg: ModelConfig
                ) -> Tuple[int, int]:
    """(inner width, heads) of the local shards; a plan that shards the
    inner width but not the heads has no per-head program."""
    di = p["w_x"].shape[-1]
    H = di // cfg.ssm_head_dim
    if p["w_dt"].shape[-1] != H:
        raise ValueError(f"the inner width is sharded to {di} but the "
                         f"heads to {p['w_dt'].shape[-1]}: shard both")
    return di, H


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig,
                sh: Optional[Shards]) -> torch.Tensor:
    """``rms_norm`` over the inner width; where it is sharded the sums of
    squares are summed over ``model`` first."""
    full = ssm_dims(cfg)[0]
    if sh is None or y.shape[-1] == full:
        return rms_norm(y, scale)
    yf = y.float()
    # the variance is read by this rank's channels only: it enters them
    var = sh.enter(sh.all_reduce(yf.square().sum(-1, keepdim=True))) / full
    return (yf * torch.rsqrt(var + RMS_EPS) * (1.0 + scale.float())
            ).to(y.dtype)


def mamba_forward(p: Mapping[str, torch.Tensor], x_in: torch.Tensor,
                  cfg: ModelConfig, sh: Optional[Shards] = None,
                  seq: bool = False) -> torch.Tensor:
    """Full-sequence forward.  x_in: [B, S, d]."""
    B, S, _ = x_in.shape
    di, H = _local_dims(p, cfg)
    p, x_in = local_share(p, x_in, sh, di < ssm_dims(cfg)[0], seq, WHOLE)
    z = x_in @ p["w_z"]
    xs = _causal_conv(x_in @ p["w_x"], p["conv_x_w"], p["conv_x_b"])
    b = _causal_conv(x_in @ p["w_b"], p["conv_b_w"], p["conv_b_b"])
    c = _causal_conv(x_in @ p["w_c"], p["conv_c_w"], p["conv_c_b"])
    dt = F.softplus((x_in @ p["w_dt"]).float() + p["dt_bias"])
    xh = xs.reshape(B, S, H, cfg.ssm_head_dim)
    y, _ = ops.ssd(xh, dt, p["a_log"], b, c)
    y = y + xh * p["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, di)
    y = _gated_norm(y * F.silu(z), p["norm"], cfg, sh)
    out = y @ p["w_out"]
    if sh is not None:
        out = sh.finish(out, partial=di < ssm_dims(cfg)[0], seq=seq)
    return out


def mamba_state_shapes(cfg: ModelConfig, batch: int, dtype: torch.dtype
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of one Mamba layer's decode state: the convolutions'
    tails and the SSM state."""
    di, H, N = ssm_dims(cfg)
    cw = cfg.conv_width
    return {"conv_x": ((batch, cw - 1, di), dtype),
            "conv_b": ((batch, cw - 1, N), dtype),
            "conv_c": ((batch, cw - 1, N), dtype),
            "ssm": ((batch, H, cfg.ssm_head_dim, N), torch.float32)}


def _conv_step(tail: torch.Tensor, xt: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """tail: [B, cw-1, C]; xt: [B, C] -> (y [B, C], new tail)."""
    window = torch.cat([tail, xt[:, None]], dim=1)
    y = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return F.silu(y + b.float()).to(xt.dtype), window[:, 1:]


def mamba_decode(p: Mapping[str, torch.Tensor], x_in: torch.Tensor,
                 state: Mapping[str, torch.Tensor], cfg: ModelConfig,
                 sh: Optional[Shards] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x_in: [B, 1, d].  Returns (out, new state);
    with ``sh`` the state is this rank's shard of it."""
    B = x_in.shape[0]
    di, H = _local_dims(p, cfg)
    xt = x_in[:, 0]
    z = xt @ p["w_z"]
    xs, conv_x = _conv_step(state["conv_x"], xt @ p["w_x"],
                            p["conv_x_w"], p["conv_x_b"])
    b, conv_b = _conv_step(state["conv_b"], xt @ p["w_b"],
                           p["conv_b_w"], p["conv_b_b"])
    c, conv_c = _conv_step(state["conv_c"], xt @ p["w_c"],
                           p["conv_c_w"], p["conv_c_b"])
    dt = F.softplus((xt @ p["w_dt"]).float() + p["dt_bias"])
    xh = xs.reshape(B, H, cfg.ssm_head_dim)
    h, y = ops.ssd_decode(state["ssm"], xh, dt, p["a_log"], b, c)
    y = y + xh * p["d_skip"][None, :, None].to(xh.dtype)
    y = y.reshape(B, di)
    y = _gated_norm(y * F.silu(z), p["norm"], cfg, sh)
    out = (y @ p["w_out"])[:, None]
    if sh is not None:
        out = sh.finish(out, partial=di < ssm_dims(cfg)[0])
    return out, {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                 "ssm": h}


__all__ = ["F32_LEAVES", "STATE_KEYS", "init_mamba", "mamba_decode",
           "mamba_forward", "mamba_state_shapes", "ssm_dims"]
