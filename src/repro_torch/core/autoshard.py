"""KAPLA -> mesh sharding over the port's own parameters.

The port of ``repro/core/autoshard.py``: the paper's solver structure
applied to a device mesh.  ``stack`` over mesh axes = partition-spec axis
assignment; ``shr`` (buffer sharing) = ZeRO-style optimizer-state sharding
over the data axes; validity check = per-chip HBM footprint; efficiency
estimate = the 3-term roofline (compute / HBM / interconnect).

``plan_sharding`` enumerates the reference's candidate set (with/without
ZeRO, attention sharded vs replicated where head counts don't divide the
model axis, FSDP as the fallback tier), runs the conservative validity
check on each, estimates the survivors' cost and returns the best.  Every
rule keeps the reference's meaning; what differs is the tree it reads:

* a leaf's path is its ``named_parameters()`` name split on ``.``
  (``blocks.3.attn.wq`` -> ``("blocks", "3", "attn", "wq")``), an
  optimizer-state leaf's the state tree's keys split the same way (AdamW
  ``("m", "blocks", "3", "attn", "wq")``; Adafactor, whose state is kept
  over the reference's layer stacks, the reference's own path and shape,
  ``("f", "blocks", "attn", "wq", "vr")``), a cache leaf's its key;
* shapes come from ``meta`` tensors, the counterpart of ``jax.eval_shape``;
* the reference stacks every block leaf on a leading layer dim, the port
  keeps one leaf per layer.  Each rule gives the same spec once that layer
  entry is dropped, except ZeRO's (``_zero_spec``): it shards the first
  replicated, divisible dim, which in the reference can be the layer dim
  (mamba2-1.3b's 48 layers over a data axis of 16).  Here it shards the
  first such dim of the per-layer leaf, and nothing where none divides (a
  small per-head vector).  The bytes per chip are the same wherever a dim
  divides.  Adafactor's stacked state keeps the layer dim, so its specs
  are the reference's, layer dim included.

A spec is a ``P``: one entry per dim, ``None``, an axis name or a tuple of
axis names.  ``ShardingPlan.param_shardings(mesh)`` (and
``batch_shardings``, ``cache_shardings``) gives, per leaf, the
``torch.distributed.tensor`` placements (``Shard(d)`` or ``Replicate()``,
one per mesh axis), the counterpart of ``NamedSharding``; no process
group is needed.  Every caller in the port defaults to ``H100Spec()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..hw.gpu import H100Spec

Tree = Any


class P(tuple):
    """A partition spec: one entry per dim, each ``None`` (replicated), a
    mesh axis name, or a tuple of axis names (sharded over their
    product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass
class ShardingPlan:
    cfg_name: str
    shape_name: str
    param_specs: Tree
    opt_specs: Tree
    batch_specs: Dict[str, Any]
    cache_specs: Optional[Tree]
    zero_opt: bool
    attn_sharded: bool
    hbm_gb_per_chip: float
    est_step_seconds: float
    notes: List[str]
    #: the chosen candidate fits the chip's HBM (the over-budget fallback
    #: does not)
    valid: bool = True
    fsdp: bool = False
    #: per-chip bytes of the chosen candidate: params, opt, grads,
    #: activations, cache
    bytes_per_chip: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: per-chip collective bytes a step of the chosen candidate sends, by
    #: kind (``collective_bytes``)
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    def param_shardings(self, mesh) -> Tree:
        return map_specs(lambda s: placements(s, mesh), self.param_specs)

    def opt_shardings(self, mesh) -> Tree:
        return map_specs(lambda s: placements(s, mesh), self.opt_specs)

    def batch_shardings(self, mesh) -> Tree:
        return map_specs(lambda s: placements(s, mesh), self.batch_specs)

    def cache_shardings(self, mesh) -> Tree:
        return map_specs(lambda s: placements(s, mesh), self.cache_specs)


def placements(spec: P, mesh) -> Tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one per axis of
    ``mesh`` (a ``Mesh`` or a ``DeviceMesh``): ``Shard(d)`` for the dim
    the axis shards, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.axis_names if hasattr(mesh, "axis_names") \
        else mesh.mesh_dim_names
    out = []
    for axis in names:
        dim = next((d for d, e in enumerate(spec) if e == axis or
                    (isinstance(e, tuple) and axis in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def map_specs(fn: Callable, specs: Tree) -> Tree:
    """``fn`` over every ``P`` of a spec tree (dicts of specs)."""
    if isinstance(specs, P):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def named_leaves(tree: Tree, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of every leaf: a module's ``named_parameters()``, a
    dict's entries in key order; each name split on ``.``."""
    if isinstance(tree, torch.nn.Module):
        return [(prefix + tuple(n.split(".")), p)
                for n, p in tree.named_parameters()]
    if isinstance(tree, Mapping):
        return [leaf for k, v in tree.items()
                for leaf in named_leaves(v, prefix + tuple(str(k).split(".")))]
    return [(prefix, tree)]


def _spec_tree(fn: Callable, tree: Tree, prefix: Tuple[str, ...] = ()
               ) -> Tree:
    """A tree of ``fn(path, leaf)`` with ``tree``'s structure; a module
    becomes a dict keyed by parameter name."""
    if isinstance(tree, torch.nn.Module):
        return {n: fn(prefix + tuple(n.split(".")), p)
                for n, p in tree.named_parameters()}
    if isinstance(tree, Mapping):
        return {k: _spec_tree(fn, v, prefix + tuple(str(k).split(".")))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _sanitize(spec: P, shape: Tuple[int, ...], axis_sizes: Dict[str, int],
              ) -> P:
    """Drop shardings whose dim is not divisible by the axis size (the
    validity guard: never emit a spec that would have to be padded)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        sz = math.prod(axis_sizes.get(a, 1) for a in axes)
        if sz == 0 or n % sz != 0:
            entries[i] = None
    return P(*entries)


def _param_spec(names: Tuple[str, ...], shape: Tuple[int, ...],
                cfg: ModelConfig, tp: int, attn_sharded: bool) -> P:
    raw = _param_spec_raw(names, shape, cfg, tp, attn_sharded)
    return _sanitize(raw, shape, {"model": tp})


def _param_spec_raw(names: Tuple[str, ...], shape: Tuple[int, ...],
                    cfg: ModelConfig, tp: int, attn_sharded: bool) -> P:
    """Sharding rules per parameter family, on the trailing dims (a
    reference leaf's leading layer dim, which the port's leaves lack, is
    never sharded by them)."""
    name = names[-1]

    def spec(*tail):
        # pad leading unsharded dims so len(spec) == ndim
        pad = (None,) * (len(shape) - len(tail))
        return P(*(pad + tail))

    if name == "embed":
        return P("model", None)            # vocab-parallel embedding
    if name == "lm_head":
        return P(None, "model")            # vocab-parallel logits
    if name in ("wq",):
        return spec(None, "model") if attn_sharded else spec(None, None)
    if name in ("wk", "wv"):
        kv_ok = (cfg.num_kv_heads % tp == 0) and attn_sharded
        return spec(None, "model") if kv_ok else spec(None, None)
    if name in ("bq",):
        return spec("model") if attn_sharded else spec(None)
    if name in ("bk", "bv"):
        kv_ok = (cfg.num_kv_heads % tp == 0) and attn_sharded
        return spec("model") if kv_ok else spec(None)
    if name == "wo" and "attn" in names:
        return spec("model", None) if attn_sharded else spec(None, None)
    if name in ("wi", "wg") and "moe" in names and len(shape) >= 3 \
            and names[-2] != "shared":
        return spec("model", None, None)   # expert-parallel
    if name == "wo" and "moe" in names and names[-2] != "shared":
        return spec("model", None, None)
    if name == "router":
        return spec(None, None)
    if name in ("wi", "wg"):               # dense / shared-expert FFN
        return spec(None, "model")
    if name == "wo":
        return spec("model", None)
    if name in ("w_x", "w_z"):
        return spec(None, "model")         # di (== heads) over model
    if name == "w_dt":
        return spec(None, "model") if cfg.ssm_heads % tp == 0 \
            else spec(None, None)
    if name in ("w_b", "w_c"):
        return spec(None, None)            # small shared projections
    if name == "w_out":
        return spec("model", None)
    if name in ("conv_x_w",):
        return spec(None, "model")
    if name in ("conv_x_b", "norm") and len(shape) >= 1:
        return spec("model")
    if name in ("a_log", "dt_bias", "d_skip"):
        return spec("model") if cfg.ssm_heads % tp == 0 else spec(None)
    return P(*((None,) * len(shape)))      # norms, small biases, misc


def _zero_spec(pspec: P, shape: Tuple[int, ...], dp_axes: Tuple[str, ...],
               dp_size: int) -> P:
    """ZeRO: shard the first still-replicated, divisible dim over data —
    the paper's buffer-sharing `shr` (one copy across sibling buffers)."""
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % dp_size == 0 and n >= dp_size:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            return P(*entries)
    return P(*entries)


def _bytes_of(shape, dtype: torch.dtype) -> float:
    return math.prod(shape) * dtype.itemsize


def _sharded_bytes(shape, dtype, spec: P, mesh_shape: Dict[str, int]
                   ) -> float:
    b = _bytes_of(shape, dtype)
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            b /= mesh_shape[a]
    return b


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig,
                     mesh_shape: Dict[str, int], param_bytes: float,
                     zero: bool, fsdp: bool) -> Dict[str, float]:
    """Per-chip bytes one step sends, by collective kind, under the
    planner's collective model (``plan_sharding``'s ``t_coll`` is their
    sum over ``ici_link_bw * ici_links_per_chip``): the tensor-parallel
    all-reduces of each layer's activations; ZeRO's gradient
    reduce-scatter and parameter all-gather in training, ``param_bytes``
    between them, half each; FSDP's all-gather of the parameters over the
    data axes."""
    tp = mesh_shape.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
    dp_size = math.prod(mesh_shape[a] for a in dp_axes) if dp_axes else 1
    tokens_local = shape.global_batch * (shape.seq_len if shape.mode !=
                                         "decode" else 1) / max(1, dp_size)
    out: Dict[str, float] = {}
    if tp > 1:
        act_bytes = tokens_local * cfg.d_model * 2
        out["all-reduce"] = 2 * act_bytes * 2 * (tp - 1) / tp \
            * cfg.num_layers
    if zero and shape.mode == "train":
        out["reduce-scatter"] = param_bytes / 2
        out["all-gather"] = param_bytes / 2
    if fsdp:
        out["all-gather"] = out.get("all-gather", 0.0) + param_bytes \
            * (dp_size - 1) / max(1, dp_size) * 2.0
    return out


def plan_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  param_shapes: Tree, opt_state_shapes: Tree,
                  cache_shapes: Optional[Tree] = None,
                  pod=H100Spec()) -> ShardingPlan:
    """Pick the sharding plan via conservative validity + cost estimate.
    ``param_shapes``: a ``Model`` or a dict of tensors by parameter name
    (``meta`` tensors suffice); ``opt_state_shapes``: the optimizer's state
    tree (``{}`` outside training); ``cache_shapes``: ``init_cache``'s
    dict."""
    mesh_shape = dict(mesh.shape)
    tp = mesh_shape.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
    dp_size = math.prod(mesh_shape[a] for a in dp_axes) if dp_axes else 1
    chips = math.prod(mesh_shape.values())
    link_bw = pod.ici_link_bw * pod.ici_links_per_chip

    heads_ok = cfg.family in ("dense", "moe") and cfg.num_heads % tp == 0
    candidates = []
    for zero in (True, False):
        for attn_sharded in ((True, False) if heads_ok else (False,)):
            candidates.append((zero, attn_sharded, False))
    if cfg.family in ("ssm", "hybrid"):
        candidates = [(z, cfg.family == "hybrid" and
                       cfg.num_heads % tp == 0, False) for z in (True, False)]
    # FSDP (fully-sharded params over the data axes) is the fallback tier:
    # required for the 1T-param config whose params exceed TP-only HBM.
    candidates += [(True, heads_ok, True)]

    best = None
    notes: List[str] = []
    flat_params = named_leaves(param_shapes)
    flat_opt = named_leaves(opt_state_shapes)
    cache_b = 0.0
    if cache_shapes is not None:
        cache_b = sum(
            _sharded_bytes(l.shape, l.dtype,
                           _cache_spec(p, l.shape, cfg, tp, dp_axes, shape,
                                       mesh_shape), mesh_shape)
            for p, l in named_leaves(cache_shapes))

    for zero, attn_sharded, fsdp in candidates:
        # --- build specs ------------------------------------------------
        def pspec_fn(names, leaf):
            base = _param_spec(names, tuple(leaf.shape), cfg, tp,
                               attn_sharded)
            if fsdp and dp_axes:
                return _zero_spec(base, tuple(leaf.shape), dp_axes, dp_size)
            return base

        def ospec_fn(names, leaf):
            # optimizer state mirrors the param rules on matching suffixes
            nd = len(leaf.shape)
            base = _param_spec(names, tuple(leaf.shape), cfg, tp,
                               attn_sharded)
            base = P(*(list(base) + [None] * (nd - len(base)))) \
                if len(base) < nd else P(*list(base)[:nd])
            if zero and dp_axes:
                return _zero_spec(base, tuple(leaf.shape), dp_axes, dp_size)
            return base
        param_specs = _spec_tree(pspec_fn, param_shapes)
        opt_specs = _spec_tree(ospec_fn, opt_state_shapes)

        # --- conservative validity: per-chip HBM footprint ----------------
        pb = sum(_sharded_bytes(l.shape, l.dtype, pspec_fn(p, l), mesh_shape)
                 for p, l in flat_params)
        ob = sum(_sharded_bytes(l.shape, l.dtype, ospec_fn(p, l), mesh_shape)
                 for p, l in flat_opt)
        grad_b = pb if shape.mode == "train" else 0.0
        # activation working set (one block live; remat shrinks the
        # saved-residual term)
        tokens_local = shape.global_batch * (shape.seq_len if shape.mode !=
                                             "decode" else 1) / max(1, dp_size)
        act_mult = 4 if cfg.remat == "block" else 12
        act_b = tokens_local * cfg.d_model * 2 * act_mult \
            * (1 if shape.mode != "train" else cfg.num_layers ** 0.5)
        if cfg.seq_shard and tp > 1:
            act_b /= tp        # sequence-parallel residuals
        hbm = pb + ob + grad_b + act_b + cache_b
        valid = hbm <= pod.hbm_bytes * 0.92
        # --- cost estimate: 3-term roofline -------------------------------
        flops = 6.0 * cfg.active_param_count() * shape.global_batch \
            * (shape.seq_len if shape.mode == "train" else
               (shape.seq_len if shape.mode == "prefill" else 1))
        if shape.mode != "train":
            flops /= 3.0                   # no backward
        t_compute = flops / (chips * pod.peak_flops_bf16)
        t_memory = (pb + ob + cache_b) / pod.hbm_bw
        coll = collective_bytes(cfg, shape, mesh_shape, pb, zero, fsdp)
        t_coll = sum(coll.values()) / link_bw
        est = max(t_compute, t_memory, t_coll)
        tag = f"zero={zero} attn_sharded={attn_sharded} fsdp={fsdp}: " \
              f"hbm={hbm / 2**30:.1f}GiB valid={valid} est={est * 1e3:.1f}ms"
        notes.append(tag)
        # FSDP is fallback-only: pick it when nothing else fits
        if valid and (best is None or
                      (est < best[0] and fsdp == best[6]) or
                      (not fsdp and best[6])):
            best = (est, zero, attn_sharded, param_specs, opt_specs,
                    hbm / 2 ** 30, fsdp, True,
                    {"params": pb, "opt": ob, "grads": grad_b,
                     "activations": act_b, "cache": cache_b}, coll)

    if best is None:
        # fall back to the most aggressive sharding even if over budget —
        # report the overflow rather than refusing to plan
        zero, attn_sharded = True, heads_ok
        fsdp = True

        def max_fn(names, leaf):
            base = _param_spec(names, tuple(leaf.shape), cfg, tp,
                               attn_sharded)
            return _zero_spec(base, tuple(leaf.shape), dp_axes, dp_size) \
                if dp_axes else base
        param_specs = _spec_tree(max_fn, param_shapes)
        opt_specs = _spec_tree(max_fn, opt_state_shapes)
        pb = sum(_sharded_bytes(l.shape, l.dtype, max_fn(p, l), mesh_shape)
                 for p, l in flat_params)
        ob = sum(_sharded_bytes(l.shape, l.dtype, max_fn(p, l), mesh_shape)
                 for p, l in flat_opt)
        notes.append("WARNING: no candidate fits HBM; using max sharding")
        best = (float("inf"), zero, attn_sharded, param_specs, opt_specs,
                float("nan"), fsdp, False,
                {"params": pb, "opt": ob, "cache": cache_b},
                collective_bytes(cfg, shape, mesh_shape, pb, zero, fsdp))

    (est, zero, attn_sharded, param_specs, opt_specs, hbm_gb, fsdp, valid,
     per_chip, coll) = best

    # --- data / cache specs ---------------------------------------------
    dp = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    batchable = shape.global_batch >= dp_size
    bspec = dp if batchable else None
    if cfg.frontend == "embed" and shape.mode != "decode":
        in_spec = P(bspec, None, None)
    else:
        in_spec = P(bspec, None)
    batch_specs = {"inputs": in_spec, "targets": P(bspec, None)}

    cache_specs = None
    if cache_shapes is not None:
        cache_specs = _spec_tree(
            lambda p, l: _cache_spec(p, tuple(l.shape), cfg, tp, dp_axes,
                                     shape, mesh_shape), cache_shapes)

    return ShardingPlan(cfg.name, shape.name, param_specs, opt_specs,
                        batch_specs, cache_specs, zero, attn_sharded,
                        hbm_gb, est, notes, valid, fsdp, per_chip, coll)


def _cache_spec(names: Tuple[str, ...], shape_t: Tuple[int, ...],
                cfg: ModelConfig, tp: int, dp_axes: Tuple[str, ...],
                shape: ShapeConfig, mesh_shape: Dict[str, int]) -> P:
    dp_size = math.prod(mesh_shape[a] for a in dp_axes) if dp_axes else 1
    name = names[-1]
    B = shape.global_batch
    dp = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    bspec = dp if B >= dp_size else None
    seq_spec = None if B >= dp_size or not dp_axes else "data"
    if name in ("k", "v", "k_scale", "v_scale"):
        kv_ok = cfg.num_kv_heads % tp == 0
        if kv_ok:
            return P(None, bspec, "model", seq_spec, None)
        # KV heads don't divide the model axis: shard the cache SEQUENCE
        # over 'model' instead (sequence-parallel decode attention); never
        # replicate a multi-GiB cache
        return P(None, bspec, None, "model", None)
    if name == "ssm":
        h_ok = cfg.ssm_heads % tp == 0
        return P(None, bspec, "model" if h_ok else None, None, None)
    if name == "conv_x":
        return P(None, bspec, None, "model")
    if name in ("conv_b", "conv_c"):
        return P(None, bspec, None, None)
    return P(*((None,) * len(shape_t)))


__all__ = ["P", "ShardingPlan", "collective_bytes", "map_specs",
           "named_leaves", "placements", "plan_sharding"]
