"""Unified model API of the model zoo, for serving and training.

The port of ``repro/models/api.py`` for the families ``dense`` (Gemma2's
paired local/global windows and both soft-caps included), ``moe`` (first
dense layers, routed and shared experts: ``moe.py``), ``ssm`` and
``hybrid``.  ``build_model(cfg, device, dtype)`` returns a ``ModelAPI``:

  init(seed)                              -> params (a ``Model`` module)
  forward(params, inputs)                 -> logits
  prefill(params, inputs, max_len[, cache]) -> (last-token logits, cache)
  init_cache(batch, max_len)              -> cache
  decode_step(params, cache, tok, n)      -> (logits, cache), n: [] int32
  loss_fn(params, batch)                  -> scalar loss (train path)

The JAX package scans over layer-stacked parameters; here every block is an
``nn.Module`` in a ``ModuleList`` and the layers run in a Python loop.
Weights keep the JAX layout (``[in, out]``, applied as ``x @ w``), so
``params_from_reference`` takes the JAX ``api.init`` tree (as numpy arrays)
without transposing anything.  Caches are updated in place by
``decode_step``, at the 0-d tensor position it is given (the JAX version
returns updated copies), and ``prefill`` fills a given cache in place, so
a serving loop can capture both over one static cache
(``launch/serve.py``).  An MoE model's
blocks are its ``first_dense_layers`` dense blocks (the JAX tree's
``dense_blocks``) followed by its MoE blocks, in layer order.

Serving keeps every leaf frozen (``requires_grad=False``); a model built
with ``trainable=True`` makes them trainable, as ``train_params`` does for
given parameters.  ``cfg.remat == "block"`` wraps each block's forward in
``torch.utils.checkpoint``, as the JAX version wraps its scan body in
``jax.checkpoint``; the hybrid's shared block is not wrapped there either,
and its gradient accumulates over its ``num_layers // attn_every`` calls.
A block's FSDP gathers run inside its checkpoint, so its recompute gathers
again and one block's gathered leaves are live at a time.  Built on a
``DeviceMesh``, ``loss_fn`` is one rank's partitioned loss, whose
backward issues the transposes of its forward's collectives
(``models/shards.py``; ``launch/partition.py`` ``partitioned_train_step``).
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
from .shards import Shards, local_share
from .ssm import (STATE_KEYS, init_mamba, mamba_decode, mamba_forward,
                  mamba_state_shapes)

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


def _ffn(cfg: ModelConfig, bp: Block, x: torch.Tensor,
         sh: Optional[Shards] = None, seq: bool = False) -> torch.Tensor:
    """A block's FFN: the gated MLP, or the routed experts plus the
    shared ones.  With ``sh`` each is finished over ``model``: the routed
    experts by ``moe_ffn``'s own all-reduce, the column/row-sharded MLPs
    by ``Shards.finish`` (``seq``: this rank's chunk of the sequence).
    A sharded part's input enters it, and so does the replicated router,
    whose gates weight the local experts (``local_share``)."""
    if "mlp" in bp:
        sharded = sh is not None and bp["mlp"]["wi"].shape[-1] < cfg.d_ff
        mp, xm = local_share(bp["mlp"], x, sh, sharded, seq)
        out = _gated_mlp(mp, xm)
        if sh is not None:
            out = sh.finish(out, sharded, seq)
        return out
    mp = bp["moe"]
    sharded = sh is not None and mp["wi"].shape[0] < mp["router"].shape[-1]
    routed, xr = local_share({k: mp[k] for k in ("router", "wi", "wg", "wo")},
                             x, sh, sharded, seq, ("router",))
    out = moe_ffn(routed, xr, cfg, model_axis=sh.mesh["model"] if sharded
                  else None)
    if seq:
        out = sh.seq_chunk(out)
    if "shared" in mp:
        full = cfg.moe_d_ff * cfg.num_shared_experts
        both = sh is not None and mp["shared"]["wi"].shape[-1] < full
        # one input entered for both parts where both are sharded
        sp, xs = local_share(mp["shared"], xr if both and sharded else x,
                             sh, both, seq or (both and sharded))
        shared = shared_expert_ffn({"shared": sp}, xs)
        if sh is not None:
            shared = sh.finish(shared, both, seq)
        out = out + shared
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


def layer_stacks(cfg: ModelConfig, params: Model) -> Dict[str, List[str]]:
    """The reference's layer-stacked leaves as the port's parameter names,
    in layer order: ``{"blocks.attn.wq": ["blocks.0.attn.wq", ...]}``.
    The cut is ``params_from_reference``'s: an MoE model's first
    ``first_dense_layers`` blocks are the stack ``dense_blocks``, the rest
    ``blocks`` (Gemma2's local/global pairs included); the top-level leaves
    and the hybrid's ``shared`` block are in no stack."""
    fd = cfg.first_dense_layers if cfg.family == "moe" else 0
    layered = []
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            layered.append((int(parts[1]), ".".join(parts[2:]), name))
    stacks: Dict[str, List[str]] = {}
    for i, rest, name in sorted(layered, key=lambda x: x[0]):
        stack = "dense_blocks" if i < fd else "blocks"
        stacks.setdefault(f"{stack}.{rest}", []).append(name)
    return stacks


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
    device: Optional[torch.device] = None
    dtype: Optional[torch.dtype] = None
    #: one rank's place in the mesh of a partitioned API (None: one device)
    shards: Optional[Shards] = None
    #: ``cache_shapes(batch, max_len)``: (shape, dtype) of every cache leaf
    cache_shapes: Optional[Callable] = None


def _placed(tree: Mapping[str, Any], prefix: str,
            place: Optional[Callable]) -> Mapping[str, Any]:
    """``tree`` with ``place(name, leaf)`` for every leaf (its name as
    ``named_parameters`` gives it); ``place`` None: ``tree``."""
    if place is None:
        return tree
    return {k: _placed(v, f"{prefix}{k}.", place) if isinstance(v, Mapping)
            else place(prefix + k, v) for k, v in tree.items()}


def build_model(cfg: ModelConfig, device=None,
                dtype: torch.dtype = torch.bfloat16,
                trainable: bool = False, mesh=None) -> ModelAPI:
    """The model's API on ``device`` (the card unless the caller passes
    ``"cpu"``, or ``"meta"`` for shapes only) in ``dtype``; ``init`` gives
    trainable leaves with ``trainable``, frozen ones (serving) without.

    ``mesh`` is either the shape-only ``launch/mesh.py`` ``Mesh``, which
    only pads the routed experts to a multiple of its ``model`` axis (as
    the reference pads them for its ``shard_map``; every expert still runs
    on one device), or a ``DeviceMesh`` of the current process group: then
    the API is one rank's partitioned program (``models/shards.py``).
    ``init(seed, place)`` draws every leaf as on one device and hands it to
    ``place`` (``launch/partition.py`` keeps the rank's shard), and
    ``forward``, ``prefill`` and ``decode_step`` take parameters, inputs
    and cache as DTensors at the plan's placements and return DTensors:
    the logits sharded as the batch and (over ``model``) the vocabulary,
    the cache in place.  ``prefill`` then needs the partitioned cache."""
    _check_family(cfg)
    dev = backend.resolve_device(device)
    sh = Shards(mesh) if mesh is not None and not hasattr(mesh, "devices") \
        else None
    if sh is not None:
        model_axis_size = sh.tp
    else:
        model_axis_size = mesh.shape.get("model", 1) if mesh is not None \
            else 1
    V = cfg.padded_vocab
    d = cfg.d_model
    L = cfg.num_layers
    paired = cfg.local_window > 0          # gemma2: (local, global) pairs
    if paired and L % 2:
        raise ValueError("local/global alternation needs even depth")

    def window_of(i: int) -> int:
        return cfg.local_window if paired and i % 2 == 0 else 0

    # ---- init ---------------------------------------------------------------
    def init(seed: int = 0, place: Optional[Callable] = None) -> Model:
        """The parameters drawn from ``seed``; ``place(name, leaf)``, where
        given, replaces each leaf as soon as its block is drawn, so only
        one block's full leaves are ever live."""
        g = generator(dev, seed)

        def leaf(name, t):
            return place(name, t) if place is not None else t

        embed = leaf("embed", dense_init(g, (V, d), d, dtype))
        lm_head = leaf("lm_head", dense_init(g, (d, V), d, dtype))

        def block(i, tree):
            return Block(_placed(tree, f"blocks.{i}.", place))
        if cfg.family == "dense":
            blocks = [block(i, _init_dense_block(g, cfg, dtype))
                      for i in range(L)]
        elif cfg.family == "moe":
            fd = cfg.first_dense_layers
            blocks = [block(i, _init_dense_block(g, cfg, dtype))
                      for i in range(fd)]
            blocks += [block(i, _init_moe_block(g, cfg, dtype,
                                                model_axis_size))
                       for i in range(fd, L)]
        else:
            blocks = [block(i, _init_mamba_block(g, cfg, dtype))
                      for i in range(L)]
        shared = Block(_placed(_init_dense_block(g, cfg, dtype), "shared.",
                               place)) if cfg.family == "hybrid" else None
        model = Model(embed, leaf("final_norm", torch.zeros(
            (d,), dtype=dtype, device=dev)), lm_head, blocks, shared)
        return train_params(model) if trainable else model

    # ---- helpers --------------------------------------------------------
    # sqrt(d) rounded to the model dtype, as the JAX version casts it; a
    # Python scalar, so no host-to-device copy stalls each step
    embed_scale = float(torch.tensor(d ** 0.5, dtype=dtype))

    def _loc(t):
        """A parameter as the program computes with it."""
        return sh.local(t) if sh is not None else t

    def _blk(bp):
        return sh.local_tree(bp) if sh is not None else bp

    def _embed(params: Model, inputs: torch.Tensor,
               seq: bool = False) -> torch.Tensor:
        table = _loc(params.embed)
        if not inputs.is_floating_point():
            if table.shape[0] == V:
                h = table[inputs.to(dev)]        # row gather
            else:                                # vocab-parallel gather
                n = table.shape[0]
                rel = inputs - sh.model_offset(n, V)
                ok = (rel >= 0) & (rel < n)
                h = table[rel.clamp(0, n - 1)] * ok[..., None].to(dtype)
                h = sh.finish(h, partial=True, seq=seq)
                return h * embed_scale
        else:
            h = inputs.to(device=dev, dtype=dtype)   # precomputed embeddings
        if seq:
            h = sh.seq_chunk(h)
        return h * embed_scale

    def _logits(params: Model, h: torch.Tensor) -> torch.Tensor:
        logits = h.float() @ _loc(params.lm_head).float()
        if cfg.final_logit_softcap > 0:
            cap = cfg.final_logit_softcap
            logits = torch.tanh(logits / cap) * cap
        return logits

    def _dense_block_fwd(bp: Block, h, window: int, collect_kv: bool,
                         seq: bool = False):
        bp = _blk(bp)
        ln1, ln2 = bp["ln1"], bp["ln2"]
        if seq:                # the norms read this rank's chunk alone
            ln1, ln2 = sh.enter(ln1), sh.enter(ln2)
        a_in = rms_norm(h, ln1)
        if seq:
            a_in = sh.all_gather(a_in, 1)
        res = attn_forward(bp["attn"], a_in, cfg, window=window,
                           collect_kv=collect_kv, sh=sh, seq=seq)
        attn_out, kv = res if collect_kv else (res, None)
        h = h + attn_out
        f_in = rms_norm(h, ln2)
        if seq:
            f_in = sh.all_gather(f_in, 1)
        h = h + _ffn(cfg, bp, f_in, sh, seq)
        return h, kv

    def _mamba_block_fwd(bp: Block, h):
        bp = _blk(bp)
        return h + mamba_forward(bp["mamba"], rms_norm(h, bp["ln"]), cfg,
                                 sh=sh)

    def vocab_sharded(params: Model) -> bool:
        """The LM head holds this rank's chunk of the vocabulary."""
        return sh is not None and sh.layout(params.lm_head).sizes[-1] < V

    def _remat(fn, *args):
        """``fn(*args)``, recomputed in the backward under ``remat ==
        "block"`` when a gradient is being recorded."""
        if cfg.remat == "block" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _wrap(local: torch.Tensor, like: torch.Tensor, shape,
              vocab_dim: Optional[int] = None):
        """The DTensor of a result sharded as the batch of ``like`` (a
        DTensor input) and, where the vocabulary is, over ``model``."""
        axes = [() for _ in shape]
        axes[0] = sh.layout(like).axes[0]
        if vocab_dim is not None and local.shape[vocab_dim] < V:
            axes[vocab_dim] = ("model",)
        return sh.wrap(local, shape, axes)

    # ---- forward (train / prefill) --------------------------------------
    def _forward(params: Model, inputs: torch.Tensor, collect_kv: bool,
                 last_only: bool, return_hidden: bool):
        seq = sh is not None and cfg.family in ("dense", "moe") \
            and sh.seq_sharded(cfg, inputs.shape[1])
        h = _embed(params, inputs, seq)
        kv_all = []
        if cfg.family in ("dense", "moe"):
            for i, bp in enumerate(params.blocks):
                h, kv = _remat(_dense_block_fwd, bp, h, window_of(i),
                               collect_kv, seq)
                kv_all.append(kv)
        elif cfg.family == "ssm":
            for bp in params.blocks:
                h = _remat(_mamba_block_fwd, bp, h)
        else:                                       # hybrid
            shared = _blk(params.shared)
            for i, bp in enumerate(params.blocks):
                h = _remat(_mamba_block_fwd, bp, h)
                if (i + 1) % cfg.attn_every == 0:
                    h, kv = _dense_block_fwd(shared, h, 0, collect_kv)
                    kv_all.append(kv)
        final_norm = _loc(params.final_norm)
        if seq:      # gathered for the vocabulary-sharded head, as a block
            h = sh.all_gather(h, 1)
            final_norm = sh.enter(final_norm)
        if last_only:
            h = h[:, -1:]          # slice before the vocab projection
        h = rms_norm(h, final_norm)
        if not seq and vocab_sharded(params):
            h = sh.enter(h)        # it enters this rank's vocabulary
        if return_hidden:
            return h
        logits = _logits(params, h)
        return (logits, kv_all) if collect_kv else logits

    def forward(params: Model, inputs: torch.Tensor,
                collect_kv: bool = False, last_only: bool = False,
                return_hidden: bool = False):
        """Logits [B, S, V] (``last_only``: [B, 1, V]); with
        ``collect_kv`` also the list of per-attention-layer (k, v); with
        ``return_hidden`` the final-normed hidden state [B, S, d] instead
        of the logits.  Partitioned: ``inputs`` a DTensor, the logits (or
        hidden state) a DTensor, the (k, v) this rank's."""
        if sh is None:
            return _forward(params, inputs, collect_kv, last_only,
                            return_hidden)
        out = _forward(params, inputs.to_local(), collect_kv, last_only,
                       return_hidden)
        logits = out[0] if collect_kv else out
        B, S = inputs.shape[0], 1 if last_only else inputs.shape[1]
        logits = _wrap(logits, inputs, (B, S, logits.shape[-1]
                                        if return_hidden else V),
                       None if return_hidden else 2)
        return (logits, out[1]) if collect_kv else logits

    # ---- loss ------------------------------------------------------------
    def loss_fn(params: Model, batch: Mapping[str, torch.Tensor]):
        """The mean token cross-entropy (plus z-loss) of ``batch``
        (``inputs``, ``targets``), through the chunked CE: the [tokens,
        vocab] f32 logits never materialize.  Partitioned, ``inputs`` and
        ``targets`` are DTensors at the plan's batch placements: the CE is
        vocabulary-parallel over ``model`` and each data shard's sum over
        the global token count is summed over the data axes, so every
        rank returns the reference's loss, a plain 0-d tensor."""
        inputs, targets = batch["inputs"], batch["targets"]
        if sh is None:
            h = forward(params, inputs, return_hidden=True)
            return chunked_cross_entropy(h, params.lm_head,
                                         targets.to(h.device),
                                         softcap=cfg.final_logit_softcap)
        h = _forward(params, inputs.to_local(), False, False, True)
        return chunked_cross_entropy(h, _loc(params.lm_head),
                                     targets.to_local(),
                                     softcap=cfg.final_logit_softcap, sh=sh,
                                     tokens=inputs.shape[0] * inputs.shape[1],
                                     vocab=V)

    # ---- KV / state caches ----------------------------------------------
    def cache_shapes(batch: int, max_len: int) -> Dict[str, tuple]:
        """(shape, dtype) of every cache leaf, allocating nothing."""
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        kv = (batch, KV, max_len, hd)
        if cfg.family in ("dense", "moe"):
            if cfg.kv_cache_dtype == "int8":
                return {"k": ((L,) + kv, torch.int8),
                        "v": ((L,) + kv, torch.int8),
                        "k_scale": ((L, batch, KV, max_len, 1),
                                    torch.float32),
                        "v_scale": ((L, batch, KV, max_len, 1),
                                    torch.float32)}
            return {"k": ((L,) + kv, dtype), "v": ((L,) + kv, dtype)}
        out = {k: ((L,) + shape, dt) for k, (shape, dt)
               in mamba_state_shapes(cfg, batch, dtype).items()}
        if cfg.family == "hybrid":
            n_sites = L // cfg.attn_every
            out["k"] = out["v"] = ((n_sites,) + kv, dtype)
        return out

    def init_cache(batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """The cache of one device (shapes only with ``"meta"``); the
        partitioned cache is ``launch/partition.py``'s ``init_cache``."""
        return {k: torch.zeros(shape, dtype=dt, device=dev)
                for k, (shape, dt) in cache_shapes(batch, max_len).items()}

    # ---- prefill ------------------------------------------------------------
    def _write_kv(cache, i: int, k, v, S: int, layout) -> None:
        """Layer ``i``'s prompt K/V [B, KV, S, hd] into the cache: on one
        device at positions 0..S; partitioned into this rank's window
        (its KV heads, its positions)."""
        if layout is not None:
            kv0, s0 = layout.offsets[2], layout.offsets[3]
            kvc, sc = layout.sizes[2], layout.sizes[3]
            kvw0 = sh.model_offset(k.shape[1], cfg.num_kv_heads)
            lo, hi = max(0, s0), min(S, s0 + sc)
            if hi <= lo:
                return
            k = k[:, kv0 - kvw0:kv0 - kvw0 + kvc, lo:hi]
            v = v[:, kv0 - kvw0:kv0 - kvw0 + kvc, lo:hi]
            at = slice(lo - s0, hi - s0)
        else:
            at = slice(0, S)
        k, v = k.to(dtype), v.to(dtype)
        if cfg.kv_cache_dtype == "int8":
            k, ks = ops.quantize_kv(k)
            v, vs = ops.quantize_kv(v)
            cache["k_scale"][i, :, :, at] = ks
            cache["v_scale"][i, :, :, at] = vs
        cache["k"][i, :, :, at] = k.to(cache["k"].dtype)
        cache["v"][i, :, :, at] = v.to(cache["v"].dtype)

    def prefill(params: Model, inputs: torch.Tensor, max_len: int,
                cache: Optional[Dict[str, torch.Tensor]] = None):
        """Run the full prompt, return (last-token logits, filled cache).
        With ``cache`` (``init_cache(B, max_len)``'s tensors) the cache is
        zeroed and written in place, never reallocated, so a captured
        prefill and a captured decode step share one set of cache tensors;
        without, a new one is made.  ssm/hybrid leave it zeroed: the
        serving loop replays the prompt through ``decode_step`` to build
        the state, as the JAX one does.  Partitioned, ``cache`` is the
        partitioned cache (DTensors) and is required."""
        B, S = inputs.shape[0], inputs.shape[1]
        layout = None
        if sh is not None:
            if cache is None:
                raise ValueError("a partitioned prefill writes the "
                                 "partitioned cache: pass it")
            local = {k: t.to_local() for k, t in cache.items()}
            if "k" in cache:
                layout = sh.layout(cache["k"])
            for t in local.values():
                t.zero_()
        elif cache is None:
            local = cache = init_cache(B, max_len)
        else:
            local = cache
            for t in cache.values():
                t.zero_()
        if cfg.family not in ("dense", "moe"):
            return forward(params, inputs, last_only=True), cache
        logits, kv_all = forward(params, inputs, collect_kv=True,
                                 last_only=True)
        for i, (k, v) in enumerate(kv_all):
            _write_kv(local, i, k, v, S, layout)
        return (logits if sh is not None else logits[:, -1:]), cache

    # ---- decode -------------------------------------------------------------
    def _attn_block_decode(bp: Block, h, cache, i: int,
                           cache_len: torch.Tensor, window: int, layout):
        a_in = rms_norm(h, bp["ln1"])
        scales = (cache["k_scale"][i], cache["v_scale"][i]) \
            if "k_scale" in cache else (None, None)
        a = attn_decode(bp["attn"], a_in, cfg, cache["k"][i],
                        cache["v"][i], cache_len, window=window,
                        k_scale=scales[0], v_scale=scales[1], sh=sh,
                        layout=layout)[0]
        h = h + a
        return h + _ffn(cfg, bp, rms_norm(h, bp["ln2"]), sh)

    def _mamba_block_decode(bp: Block, h, cache, i: int):
        state = {k: cache[k][i] for k in STATE_KEYS}
        out, new = mamba_decode(bp["mamba"], rms_norm(h, bp["ln"]), state,
                                cfg, sh=sh)
        for k in STATE_KEYS:
            cache[k][i].copy_(new[k])
        return h + out

    def decode_step(params: Model, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, cache_len):
        """tokens: [B, 1] ids; cache_len: [] int32 tensor on the model's
        device, the tokens already in the cache, as the reference's.  The
        step reads no device value on the host, so it can be captured.  A
        Python int (an eager caller's) becomes a device tensor here, once
        a call: never pass one inside a capture.  Returns (logits [B,1,V],
        the cache, updated in place).  Partitioned: ``tokens`` and the
        cache are DTensors, the logits a DTensor."""
        cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=dev)
        layout, local, toks = None, cache, tokens
        if sh is not None:
            local = {k: t.to_local() for k, t in cache.items()}
            toks = tokens.to_local()
            if "k" in cache:
                layout = sh.layout(cache["k"])
        h = _embed(params, toks)
        if cfg.family in ("dense", "moe"):
            for i, bp in enumerate(params.blocks):
                h = _attn_block_decode(_blk(bp), h, local, i, cache_len,
                                       window_of(i), layout)
        else:
            shared = _blk(params.shared) if cfg.family == "hybrid" else None
            for i, bp in enumerate(params.blocks):
                h = _mamba_block_decode(_blk(bp), h, local, i)
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    h = _attn_block_decode(shared, h, local,
                                           i // cfg.attn_every, cache_len, 0,
                                           layout)
        h = rms_norm(h, _loc(params.final_norm))
        logits = _logits(params, h)
        if sh is not None:
            logits = _wrap(logits, tokens, (tokens.shape[0], 1, V), 2)
        return logits, cache

    return ModelAPI(cfg, init, forward, prefill, init_cache, decode_step,
                    loss_fn, device=dev, dtype=dtype, shards=sh,
                    cache_shapes=cache_shapes)


__all__ = ["Block", "FAMILIES", "Model", "ModelAPI", "build_model",
           "layer_stacks", "params_from_reference", "train_params"]
