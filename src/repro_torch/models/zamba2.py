"""Zamba2 as published (Zyphra's Zamba2 models; the ``zamba2`` model of
Hugging Face ``transformers``): Mamba2 layers with B and C in groups, and
at the layers ``hybrid_layers`` one of ``num_mem_blocks`` shared
transformer blocks, whose output enters that layer's Mamba input alone.

With ``x0`` the token embedding (unscaled) and ``h`` the residual stream,
a layer i that is the k-th hybrid site (block ``s = k % num_mem_blocks``)
computes

    a = RMSNorm_2d(concat[h, x0])
    attn = softmax_causal(rope(a Wq_s) rope(a Wk_s)^T / sqrt(hd / 2)) (a Wv_s)
    m = RMSNorm_d(attn Wo_s)
    [g, u] = m Wgu_s + (m A_k) B_k          (the site's rank-r MLP adapter)
    t = (gelu(g) * u) Wdown_s Lin_k          (the site's own linear)
    h <- h + Mamba_i(RMSNorm(h + t))

and every other layer ``h <- h + Mamba_i(RMSNorm(h))``; then the final
RMSNorm and the LM head.  Heads are ``num_heads`` of ``head_dim``
(``attn_hidden / num_heads``, wider than ``d_model / num_heads``), the
rotary embedding spans the whole head, GELU is exact, and no projection
has a bias.  A Mamba layer's B and C are ``ssm_groups`` groups of
``ssm_state`` (``models/ssm.py`` ``mamba_forward``), its gated norm
grouped as they are.  RMSNorm is the program's (``common.rms_norm``: gain
``1 + scale``).  The shared blocks' gradients add up over their sites.

``build(cfg, ...)`` is ``api.build_model``'s path for a ``Zamba2Config``:
``forward`` and ``loss_fn`` (training, through ``launch/steps.py`` as any
model's); serving the published block is not implemented, so
``prefill``, ``decode_step`` and the cache raise.  Parameters:
``blocks[i]`` (``ln``, ``mamba``), ``shared[j]`` (``ln1``, ``attn``
``wq wk wv wo``, ``ln2``, ``mlp`` ``w_gate_up w_down``) and ``sites[k]``
(``adapter_a``, ``adapter_b``, ``linear``).

Tracing: each site's forward is the host span ``hybrid.site`` (site,
block), and while a tracer is installed the API's ``marks`` are marked
``hybrid.<k>.forward`` and ``.forward_end`` at the site's entry and exit,
and, through identity autograd Functions on its input and output,
``hybrid.<k>.backward`` and ``.backward_end`` where its backward starts
and ends (``site_ms`` sums them); a graph captured with tracing off holds
neither the marks nor the identities.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import backend, ops
from ..obs import device as obs_device
from ..obs import trace
from .api import Block, Model, ModelAPI, train_params
from .common import chunked_cross_entropy, dense_init, generator, rms_norm, \
    rope
from .ssm import init_mamba, mamba_forward


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """A published Zamba2: ``family`` "hybrid", ``num_heads`` x ``head_dim``
    = ``attn_hidden`` in the shared blocks, ``d_ff`` their MLP's width."""
    #: the layers that first run a shared block, in order (site k: the k-th)
    hybrid_layers: Tuple[int, ...] = ()
    #: shared blocks; site k runs block k % num_mem_blocks
    num_mem_blocks: int = 2
    #: the attention's input and q/k/v width (2 d_model: [h, x0])
    attn_hidden: int = 0
    #: the rank of each site's MLP adapter
    adapter_rank: int = 0
    #: the gated MLP's activation (exact GELU)
    mlp_act: str = "gelu"
    #: groups of B and C in each Mamba layer
    ssm_groups: int = 1
    rope_theta: float = 10000.0

    def param_count(self) -> float:
        d, F_, r = self.d_model, self.d_ff, self.adapter_rank
        di = self.ssm_expand * d
        gn = self.ssm_groups * self.ssm_state
        mamba = d * (2 * di + 2 * gn + self.ssm_heads) + di * d
        attn = 3 * self.attn_hidden * self.attn_hidden \
            + self.attn_hidden * d
        block = attn + 3 * d * F_
        site = d * r + r * 2 * F_ + d * d
        return float(self.padded_vocab * d * 2 + self.num_layers * mamba
                     + self.num_mem_blocks * block
                     + len(self.hybrid_layers) * site)


def _init_shared(g, cfg: Zamba2Config, dtype) -> Dict:
    d, a, F_ = cfg.d_model, cfg.attn_hidden, cfg.d_ff
    dev = g.device
    return {"ln1": torch.zeros((a,), dtype=dtype, device=dev),
            "attn": {"wq": dense_init(g, (a, a), a, dtype),
                     "wk": dense_init(g, (a, a), a, dtype),
                     "wv": dense_init(g, (a, a), a, dtype),
                     "wo": dense_init(g, (a, d), a, dtype)},
            "ln2": torch.zeros((d,), dtype=dtype, device=dev),
            "mlp": {"w_gate_up": dense_init(g, (d, 2 * F_), d, dtype),
                    "w_down": dense_init(g, (F_, d), F_, dtype)}}


def _init_site(g, cfg: Zamba2Config, dtype) -> Dict:
    d, r = cfg.d_model, cfg.adapter_rank
    return {"adapter_a": dense_init(g, (d, r), d, dtype),
            "adapter_b": dense_init(g, (r, 2 * cfg.d_ff), r, dtype),
            "linear": dense_init(g, (d, d), d, dtype)}


class Zamba2Model(Model):
    """``Model`` with the shared blocks (``shared``, a list) and each
    site's adapter and linear (``sites``)."""

    def __init__(self, embed, final_norm, lm_head, blocks, shared, sites):
        super().__init__(embed, final_norm, lm_head, blocks, None)
        self.shared = nn.ModuleList(shared)
        self.sites = nn.ModuleList(sites)


class _MarkGrad(torch.autograd.Function):
    """The identity; its backward marks ``name`` where the gradient of its
    output reaches it."""

    @staticmethod
    def forward(ctx, x, marks, name):
        ctx.marks, ctx.name = marks, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        ctx.marks.mark(ctx.name)
        return dx, None, None


def site_ms(phases: Mapping[str, float]) -> float:
    """Device ms inside the hybrid sites, forward and backward, of a
    ``Marks.phase_ms`` reading."""
    return sum(v for k, v in phases.items() if k.startswith("hybrid.")
               and k.endswith((".forward", ".backward")))


def build(cfg: Zamba2Config, device=None, dtype: torch.dtype = torch.bfloat16,
          trainable: bool = False, mesh=None) -> ModelAPI:
    """The published Zamba2's API on ``device`` (``api.build_model``)."""
    if mesh is not None:
        raise NotImplementedError("the published Zamba2 runs on one device")
    if cfg.mlp_act != "gelu" or cfg.remat != "none":
        raise ValueError(f"mlp_act {cfg.mlp_act!r}, remat {cfg.remat!r}: "
                         "the published MLP is GELU-gated, and no layer is "
                         "recomputed")
    dev = backend.resolve_device(device)
    site_of = {layer: k for k, layer in enumerate(cfg.hybrid_layers)}
    if any(layer >= cfg.num_layers for layer in site_of):
        raise ValueError(f"hybrid layers {cfg.hybrid_layers} past "
                         f"{cfg.num_layers} layers")
    H, hd = cfg.num_heads, cfg.head_dim
    if H * hd != cfg.attn_hidden or cfg.attn_hidden != 2 * cfg.d_model:
        raise ValueError(f"{H} heads of {hd} for an attention width "
                         f"{cfg.attn_hidden} on [h, x0] of 2 x "
                         f"{cfg.d_model}")
    marks = obs_device.Marks(dev)

    def init(seed: int = 0, place=None) -> Zamba2Model:
        if place is not None:
            raise NotImplementedError("the published Zamba2 is not placed")
        g = generator(dev, seed)
        V, d = cfg.padded_vocab, cfg.d_model
        embed = dense_init(g, (V, d), d, dtype)
        lm_head = dense_init(g, (d, V), d, dtype)
        blocks = [Block({"ln": torch.zeros((d,), dtype=dtype, device=dev),
                         "mamba": init_mamba(g, cfg, dtype,
                                             cfg.ssm_groups)})
                  for _ in range(cfg.num_layers)]
        shared = [Block(_init_shared(g, cfg, dtype))
                  for _ in range(cfg.num_mem_blocks)]
        sites = [Block(_init_site(g, cfg, dtype)) for _ in site_of]
        model = Zamba2Model(embed, torch.zeros((d,), dtype=dtype,
                                               device=dev),
                            lm_head, blocks, shared, sites)
        return train_params(model) if trainable else model

    def attention(p, a: torch.Tensor) -> torch.Tensor:
        B, S, _ = a.shape
        pos = torch.arange(S, device=a.device)
        q = rope((a @ p["wq"]).reshape(B, S, H, hd), pos, cfg.rope_theta)
        k = rope((a @ p["wk"]).reshape(B, S, H, hd), pos, cfg.rope_theta)
        v = (a @ p["wv"]).reshape(B, S, H, hd)
        o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True,
                          scale=(hd / 2) ** -0.5)
        return o.transpose(1, 2).reshape(B, S, H * hd) @ p["wo"]

    def site(params: Zamba2Model, k: int, h: torch.Tensor,
             x0: torch.Tensor) -> torch.Tensor:
        """The shared block of site ``k`` and its linear: ``t``."""
        s = k % cfg.num_mem_blocks
        with obs_device.span("hybrid.site", site=k, block=s):
            traced = trace.enabled() and torch.is_grad_enabled()
            marks.mark(f"hybrid.{k}.forward")
            a_in = torch.cat([h, x0], -1)
            if traced:
                a_in = _MarkGrad.apply(a_in, marks, f"hybrid.{k}.backward_end")
            bp, sp = params.shared[s], params.sites[k]
            m = rms_norm(attention(bp["attn"], rms_norm(a_in, bp["ln1"])),
                         bp["ln2"])
            gu = m @ bp["mlp"]["w_gate_up"] \
                + (m @ sp["adapter_a"]) @ sp["adapter_b"]
            g, u = gu.chunk(2, -1)
            t = ((F.gelu(g) * u) @ bp["mlp"]["w_down"]) @ sp["linear"]
            if traced:
                t = _MarkGrad.apply(t, marks, f"hybrid.{k}.backward")
            marks.mark(f"hybrid.{k}.forward_end")
        return t

    def mamba(bp, h, t=None):
        x = h if t is None else h + t
        return h + mamba_forward(bp["mamba"], rms_norm(x, bp["ln"]), cfg)

    def hidden(params: Zamba2Model, inputs: torch.Tensor) -> torch.Tensor:
        x0 = params.embed[inputs.to(dev)]
        h = x0
        for i, bp in enumerate(params.blocks):
            k = site_of.get(i)
            h = mamba(bp, h, None if k is None else site(params, k, h, x0))
        return rms_norm(h, params.final_norm)

    def forward(params: Zamba2Model, inputs: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V] in float32."""
        return hidden(params, inputs).float() @ params.lm_head.float()

    def loss_fn(params: Zamba2Model, batch: Mapping[str, torch.Tensor]):
        h = hidden(params, batch["inputs"])
        return chunked_cross_entropy(h, params.lm_head,
                                     batch["targets"].to(h.device))

    def no_serving(*args, **kwargs):
        raise NotImplementedError("serving the published Zamba2 (its shared "
                                  "blocks' caches) is not implemented")

    return ModelAPI(cfg, init, forward, no_serving, no_serving, no_serving,
                    loss_fn, device=dev, dtype=dtype, cache_shapes=no_serving,
                    marks=marks)


def config(published: Mapping, name: str = "zamba2") -> Zamba2Config:
    """The ``Zamba2Config`` of a published ``config.json`` (its keys as
    Hugging Face ``transformers`` names them), the hybrid sites among its
    ``num_hidden_layers`` layers kept."""
    L = int(published["num_hidden_layers"])
    d = int(published["hidden_size"])
    return Zamba2Config(
        name=name, family="hybrid", num_layers=L, d_model=d,
        num_heads=int(published["num_attention_heads"]),
        num_kv_heads=int(published["num_key_value_heads"]),
        d_ff=int(published["intermediate_size"]),
        vocab_size=int(published["vocab_size"]),
        head_dim=int(published["attention_head_dim"]),
        ssm_state=int(published["mamba_d_state"]),
        ssm_head_dim=int(published["mamba_headdim"]),
        ssm_expand=int(published["mamba_expand"]),
        conv_width=int(published["mamba_d_conv"]),
        hybrid_layers=tuple(i for i in published["hybrid_layer_ids"]
                            if i < L),
        num_mem_blocks=int(published["num_mem_blocks"]),
        attn_hidden=int(published["attention_hidden_size"]),
        adapter_rank=int(published["adapter_rank"]),
        mlp_act=str(published["hidden_act"]),
        ssm_groups=int(published["mamba_ngroups"]),
        rope_theta=float(published["rope_theta"]))


__all__ = ["Zamba2Config", "Zamba2Model", "build", "config", "site_ms"]
