"""Unified model API of the model zoo, for serving and training.

The port of ``repro/models/api.py`` for the families ``dense`` (Gemma2's
paired local/global windows and both soft-caps included), ``moe`` (first
dense layers, routed and shared experts: ``moe.py``), ``ssm`` and
``hybrid``.  ``build_model(cfg, device, dtype)`` returns a ``ModelAPI``:

  init(seed)                              -> params (a ``Model`` module)
  forward(params, inputs)                 -> logits
  prefill(params, inputs, max_len)        -> (last-token logits, cache)
  init_cache(batch, max_len)              -> cache
  decode_step(params, cache, tok, n)      -> (logits, cache)
  loss_fn(params, batch)                  -> scalar loss (train path)

The JAX package scans over layer-stacked parameters; here every block is an
``nn.Module`` in a ``ModuleList`` and the layers run in a Python loop.
Weights keep the JAX layout (``[in, out]``, applied as ``x @ w``), so
``params_from_reference`` takes the JAX ``api.init`` tree (as numpy arrays)
without transposing anything.  Caches are updated in place by
``decode_step`` (the JAX version returns updated copies).  An MoE model's
blocks are its ``first_dense_layers`` dense blocks (the JAX tree's
``dense_blocks``) followed by its MoE blocks, in layer order.

Serving keeps every leaf frozen (``requires_grad=False``); a model built
with ``trainable=True`` makes them trainable, as ``train_params`` does for
given parameters.  ``cfg.remat == "block"`` wraps each block's forward in
``torch.utils.checkpoint``, as the JAX version wraps its scan body in
``jax.checkpoint``; the hybrid's shared block is not wrapped there either,
and its gradient accumulates over its ``num_layers // attn_every`` calls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import backend, ops
from .attention import attn_decode, attn_forward, init_attn
from .common import chunked_cross_entropy, dense_init, generator, rms_norm
from . import moe, ssm
from .moe import init_moe, moe_ffn, shared_expert_ffn
from .ssm import (STATE_KEYS, init_mamba, mamba_decode, mamba_forward,
                  mamba_init_state)

FAMILIES = ("dense", "moe", "ssm", "hybrid")
#: leaves kept in float32 whatever the model's type
F32_LEAVES = ssm.F32_LEAVES + moe.F32_LEAVES


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# parameters as modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One block's parameters: top-level leaves as ``nn.Parameter``s,
    sub-trees (``attn``, ``mlp``, ``mamba``) as ``nn.ParameterDict``s, and
    a sub-tree that holds sub-trees of its own (``moe`` with its
    ``shared`` experts) as a ``Block``.  Indexed like the JAX tree
    (``bp["attn"]["wq"]``, ``"mlp" in bp``, ``bp["moe"]["shared"]``)."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._names = tuple(tree)
        for name, leaf in tree.items():
            if not isinstance(leaf, Mapping):
                self.register_parameter(name, _frozen(leaf))
            elif any(isinstance(v, Mapping) for v in leaf.values()):
                self.add_module(name, Block(leaf))
            else:
                self.add_module(name, nn.ParameterDict(
                    {k: _frozen(v) for k, v in leaf.items()}))

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._names


class Model(nn.Module):
    """The parameters of one model: embedding, final norm, LM head, the
    blocks in layer order, and (hybrid) the shared attention block."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 lm_head: torch.Tensor, blocks: List[Block],
                 shared: Optional[Block] = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.final_norm = _frozen(final_norm)
        self.lm_head = _frozen(lm_head)
        self.blocks = nn.ModuleList(blocks)
        self.shared = shared


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def train_params(params: Model) -> Model:
    """Make every leaf of ``params`` trainable (``requires_grad``), in
    place; returns ``params``."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def _init_mlp(g: torch.Generator, d: int, f: int, dtype):
    return {"wi": dense_init(g, (d, f), d, dtype),
            "wg": dense_init(g, (d, f), d, dtype),
            "wo": dense_init(g, (f, d), f, dtype)}


def _gated_mlp(p, x):
    h = (x @ p["wi"]) * F.silu(x @ p["wg"])
    return h @ p["wo"]


def _init_dense_block(g: torch.Generator, cfg: ModelConfig, dtype):
    dev = g.device
    return {"ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "attn": init_attn(g, cfg, dtype),
            "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "mlp": _init_mlp(g, cfg.d_model, cfg.d_ff, dtype)}


def _init_moe_block(g: torch.Generator, cfg: ModelConfig, dtype,
                    model_axis_size: int = 1):
    dev = g.device
    return {"ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "attn": init_attn(g, cfg, dtype),
            "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "moe": init_moe(g, cfg, model_axis_size, dtype)}


def _ffn(cfg: ModelConfig, bp: Block, x: torch.Tensor) -> torch.Tensor:
    """A block's FFN: the gated MLP, or the routed experts plus the
    shared ones."""
    if "mlp" in bp:
        return _gated_mlp(bp["mlp"], x)
    out = moe_ffn(bp["moe"], x, cfg)
    if "shared" in bp["moe"]:
        out = out + shared_expert_ffn(bp["moe"], x)
    return out


def _init_mamba_block(g: torch.Generator, cfg: ModelConfig, dtype):
    return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=g.device),
            "mamba": init_mamba(g, cfg, dtype)}


def _leaf(a, name: str, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """A reference leaf (numpy array, any float type, bfloat16 included) as
    a tensor of the port's type for that leaf."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    want = torch.float32 if name in F32_LEAVES else dtype
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(
        device=device, dtype=want)


def _layer(tree: Mapping[str, Any], i: Optional[int], dtype,
           device) -> Dict[str, Any]:
    """Layer ``i`` of a layer-stacked reference sub-tree (``None``: the tree
    is not stacked)."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = _layer(leaf, i, dtype, device)
        else:
            out[name] = _leaf(leaf if i is None else np.asarray(leaf)[i],
                              name, dtype, device)
    return out


def params_from_reference(cfg: ModelConfig, tree: Mapping[str, Any],
                          device=None,
                          dtype: torch.dtype = torch.bfloat16) -> Model:
    """The port's parameters from the JAX ``api.init`` tree, given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``).  The JAX tree
    stacks every block leaf on a leading layer axis (``jax.vmap``); it is
    cut into one ``Block`` per layer.  Gemma2's local/global pairs are the
    even/odd layers of that axis, as the JAX forward reshapes them.  An MoE
    tree's ``dense_blocks`` (its first dense layers) come first, then its
    ``blocks``; the router stays float32."""
    _check_family(cfg)
    dev = backend.resolve_device(device)
    fd = cfg.first_dense_layers if cfg.family == "moe" else 0
    blocks = [Block(_layer(tree["dense_blocks"], i, dtype, dev))
              for i in range(fd)]
    blocks += [Block(_layer(tree["blocks"], i, dtype, dev))
               for i in range(cfg.num_layers - fd)]
    shared = Block(_layer(tree["shared"], None, dtype, dev)) \
        if cfg.family == "hybrid" else None
    return Model(_leaf(tree["embed"], "embed", dtype, dev),
                 _leaf(tree["final_norm"], "final_norm", dtype, dev),
                 _leaf(tree["lm_head"], "lm_head", dtype, dev), blocks,
                 shared)


# ---------------------------------------------------------------------------
# ModelAPI
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable
    loss_fn: Callable
    train_params: Callable = train_params


def build_model(cfg: ModelConfig, device=None,
                dtype: torch.dtype = torch.bfloat16,
                trainable: bool = False, mesh=None) -> ModelAPI:
    """The model's API on ``device`` (the card unless the caller passes
    ``"cpu"``, or ``"meta"`` for shapes only) in ``dtype``; ``init`` gives
    trainable leaves with ``trainable``, frozen ones (serving) without.
    With a ``mesh`` (``launch/mesh.py``) the routed experts are padded to a
    multiple of its ``model`` axis, as the reference pads them for its
    ``shard_map``; every expert still runs on one device."""
    _check_family(cfg)
    dev = backend.resolve_device(device)
    model_axis_size = mesh.shape.get("model", 1) if mesh is not None else 1
    V = cfg.padded_vocab
    d = cfg.d_model
    L = cfg.num_layers
    paired = cfg.local_window > 0          # gemma2: (local, global) pairs
    if paired and L % 2:
        raise ValueError("local/global alternation needs even depth")

    def window_of(i: int) -> int:
        return cfg.local_window if paired and i % 2 == 0 else 0

    # ---- init ---------------------------------------------------------------
    def init(seed: int = 0) -> Model:
        g = generator(dev, seed)
        embed = dense_init(g, (V, d), d, dtype)
        lm_head = dense_init(g, (d, V), d, dtype)
        if cfg.family == "dense":
            blocks = [Block(_init_dense_block(g, cfg, dtype))
                      for _ in range(L)]
        elif cfg.family == "moe":
            fd = cfg.first_dense_layers
            blocks = [Block(_init_dense_block(g, cfg, dtype))
                      for _ in range(fd)]
            blocks += [Block(_init_moe_block(g, cfg, dtype, model_axis_size))
                       for _ in range(L - fd)]
        else:
            blocks = [Block(_init_mamba_block(g, cfg, dtype))
                      for _ in range(L)]
        shared = Block(_init_dense_block(g, cfg, dtype)) \
            if cfg.family == "hybrid" else None
        model = Model(embed, torch.zeros((d,), dtype=dtype, device=dev),
                      lm_head, blocks, shared)
        return train_params(model) if trainable else model

    # ---- helpers --------------------------------------------------------
    # sqrt(d) rounded to the model dtype, as the JAX version casts it; a
    # Python scalar, so no host-to-device copy stalls each step
    embed_scale = float(torch.tensor(d ** 0.5, dtype=dtype))

    def _embed(params: Model, inputs: torch.Tensor) -> torch.Tensor:
        if not inputs.is_floating_point():
            h = params.embed[inputs.to(dev)]     # row gather
        else:
            h = inputs.to(device=dev, dtype=dtype)   # precomputed embeddings
        return h * embed_scale

    def _logits(params: Model, h: torch.Tensor) -> torch.Tensor:
        logits = h.float() @ params.lm_head.float()
        if cfg.final_logit_softcap > 0:
            cap = cfg.final_logit_softcap
            logits = torch.tanh(logits / cap) * cap
        return logits

    def _dense_block_fwd(bp: Block, h, window: int, collect_kv: bool):
        a_in = rms_norm(h, bp["ln1"])
        res = attn_forward(bp["attn"], a_in, cfg, window=window,
                           collect_kv=collect_kv)
        attn_out, kv = res if collect_kv else (res, None)
        h = h + attn_out
        h = h + _ffn(cfg, bp, rms_norm(h, bp["ln2"]))
        return h, kv

    def _mamba_block_fwd(bp: Block, h):
        return h + mamba_forward(bp["mamba"], rms_norm(h, bp["ln"]), cfg)

    def _remat(fn, *args):
        """``fn(*args)``, recomputed in the backward under ``remat ==
        "block"`` when a gradient is being recorded."""
        if cfg.remat == "block" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ---- forward (train / prefill) --------------------------------------
    def forward(params: Model, inputs: torch.Tensor,
                collect_kv: bool = False, last_only: bool = False,
                return_hidden: bool = False):
        """Logits [B, S, V] (``last_only``: [B, 1, V]); with
        ``collect_kv`` also the list of per-attention-layer (k, v); with
        ``return_hidden`` the final-normed hidden state [B, S, d] instead
        of the logits."""
        h = _embed(params, inputs)
        kv_all = []
        if cfg.family in ("dense", "moe"):
            for i, bp in enumerate(params.blocks):
                h, kv = _remat(_dense_block_fwd, bp, h, window_of(i),
                               collect_kv)
                kv_all.append(kv)
        elif cfg.family == "ssm":
            for bp in params.blocks:
                h = _remat(_mamba_block_fwd, bp, h)
        else:                                       # hybrid
            for i, bp in enumerate(params.blocks):
                h = _remat(_mamba_block_fwd, bp, h)
                if (i + 1) % cfg.attn_every == 0:
                    h, kv = _dense_block_fwd(params.shared, h, 0,
                                             collect_kv)
                    kv_all.append(kv)
        if last_only:
            h = h[:, -1:]          # slice before the vocab projection
        h = rms_norm(h, params.final_norm)
        if return_hidden:
            return h
        logits = _logits(params, h)
        return (logits, kv_all) if collect_kv else logits

    # ---- loss ------------------------------------------------------------
    def loss_fn(params: Model, batch: Mapping[str, torch.Tensor]):
        """The mean token cross-entropy (plus z-loss) of ``batch``
        (``inputs``, ``targets``), through the chunked CE: the [tokens,
        vocab] f32 logits never materialize."""
        h = forward(params, batch["inputs"], return_hidden=True)
        return chunked_cross_entropy(h, params.lm_head,
                                     batch["targets"].to(h.device),
                                     softcap=cfg.final_logit_softcap)

    # ---- KV / state caches ----------------------------------------------
    def init_cache(batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        KV, hd = cfg.num_kv_heads, cfg.head_dim

        def zeros(n, shape, dt):
            return torch.zeros((n, batch) + shape, dtype=dt, device=dev)

        if cfg.family in ("dense", "moe"):
            if cfg.kv_cache_dtype == "int8":
                return {"k": zeros(L, (KV, max_len, hd), torch.int8),
                        "v": zeros(L, (KV, max_len, hd), torch.int8),
                        "k_scale": zeros(L, (KV, max_len, 1), torch.float32),
                        "v_scale": zeros(L, (KV, max_len, 1), torch.float32)}
            return {"k": zeros(L, (KV, max_len, hd), dtype),
                    "v": zeros(L, (KV, max_len, hd), dtype)}
        one = mamba_init_state(cfg, batch, dtype, dev)
        cache = {k: torch.zeros((L,) + one[k].shape, dtype=one[k].dtype,
                                device=dev) for k in STATE_KEYS}
        if cfg.family == "hybrid":
            n_sites = L // cfg.attn_every
            cache["k"] = zeros(n_sites, (KV, max_len, hd), dtype)
            cache["v"] = zeros(n_sites, (KV, max_len, hd), dtype)
        return cache

    # ---- prefill ------------------------------------------------------------
    def prefill(params: Model, inputs: torch.Tensor, max_len: int):
        """Run the full prompt, return (last-token logits, filled cache).
        ssm/hybrid return a fresh cache: the serving loop replays the prompt
        through ``decode_step`` to build the state, as the JAX one does."""
        B, S = inputs.shape[0], inputs.shape[1]
        if cfg.family not in ("dense", "moe"):
            return forward(params, inputs, last_only=True), \
                init_cache(B, max_len)
        logits, kv_all = forward(params, inputs, collect_kv=True,
                                 last_only=True)
        cache = init_cache(B, max_len)
        for i, (k, v) in enumerate(kv_all):
            k, v = k.to(dtype), v.to(dtype)
            if cfg.kv_cache_dtype == "int8":
                k, ks = ops.quantize_kv(k)
                v, vs = ops.quantize_kv(v)
                cache["k_scale"][i, :, :, :S] = ks
                cache["v_scale"][i, :, :, :S] = vs
            cache["k"][i, :, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i, :, :, :S] = v.to(cache["v"].dtype)
        return logits[:, -1:], cache

    # ---- decode -------------------------------------------------------------
    def _attn_block_decode(bp: Block, h, cache, i: int, cache_len: int,
                           window: int):
        a_in = rms_norm(h, bp["ln1"])
        scales = (cache["k_scale"][i], cache["v_scale"][i]) \
            if "k_scale" in cache else (None, None)
        a = attn_decode(bp["attn"], a_in, cfg, cache["k"][i], cache["v"][i],
                        cache_len, window=window, k_scale=scales[0],
                        v_scale=scales[1])[0]
        h = h + a
        return h + _ffn(cfg, bp, rms_norm(h, bp["ln2"]))

    def _mamba_block_decode(bp: Block, h, cache, i: int):
        state = {k: cache[k][i] for k in STATE_KEYS}
        out, new = mamba_decode(bp["mamba"], rms_norm(h, bp["ln"]), state,
                                cfg)
        for k in STATE_KEYS:
            cache[k][i].copy_(new[k])
        return h + out

    def decode_step(params: Model, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, cache_len: int):
        """tokens: [B, 1] ids; cache_len: tokens already in the cache.
        Returns (logits [B,1,V], the cache, updated in place)."""
        cache_len = int(cache_len)
        h = _embed(params, tokens)
        if cfg.family in ("dense", "moe"):
            for i, bp in enumerate(params.blocks):
                h = _attn_block_decode(bp, h, cache, i, cache_len,
                                       window_of(i))
        else:
            for i, bp in enumerate(params.blocks):
                h = _mamba_block_decode(bp, h, cache, i)
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    h = _attn_block_decode(params.shared, h, cache,
                                           i // cfg.attn_every, cache_len, 0)
        h = rms_norm(h, params.final_norm)
        return _logits(params, h), cache

    return ModelAPI(cfg, init, forward, prefill, init_cache, decode_step,
                    loss_fn)


__all__ = ["Block", "FAMILIES", "Model", "ModelAPI", "build_model",
           "params_from_reference", "train_params"]
