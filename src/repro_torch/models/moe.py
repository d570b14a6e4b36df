"""Mixture-of-Experts FFN, on one card or expert-parallel.

The port of ``repro/models/moe.py``.  The JAX package shards the experts
over a ``model`` mesh axis inside ``shard_map`` and combines the shards'
partial outputs with one ``psum``.  ``moe_ffn`` with ``model_axis`` (the
``model`` sub-mesh, a one-dimensional ``DeviceMesh``) is that
``shard_map`` body: it runs on one rank's shards, ``wi``/``wg``/``wo`` as
its ``E_local`` experts, the router replicated and ``x`` the rank's data
shard of tokens; routing and capacity (from the local token count) are
computed on every model rank alike, each rank fills capacity buffers for
its expert window only (from ``get_local_rank() * E_local``), and one
all-reduce (sum) of the f32 [T, d] output over ``model`` combines them.
Without ``model_axis`` every expert is local and there is no collective.
The rest is the reference's arithmetic, step for step:

  * the router is float32 and the logits are computed in float32;
  * softmax, top-k, the top-k gates renormalised;
  * capacity positions: the (token, slot) pairs stably sorted by expert
    (``argsort(stable=True)``, as ``jnp.argsort`` is stable), each pair's
    rank within its expert by ``searchsorted(side="left")``, and the pairs
    at rank ``C`` or beyond dropped, so exactly the reference's pairs are
    dropped;
  * the gated expert FFN as batched products over the capacity buffers
    ([E, C, d]; a library call, since the reference computes it outside
    any Pallas kernel);
  * the combine without atomics: each pair's gated output goes back to its
    (token, slot) place through the inverse permutation and the k slots
    are summed in slot order in float32, so the result is the same on
    every run (``index_add_`` on the card adds in any order).

FLOPs stay the reference's: only the capacity buffers are computed, never
a dense all-experts pass.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Mapping

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, pad_to
from .common import dense_init
from .shards import all_reduce

#: leaves kept in float32 whatever the model's type (``init_moe``)
F32_LEAVES = ("router",)


def padded_experts(cfg: ModelConfig, model_axis_size: int) -> int:
    """Experts padded up so the model axis divides them evenly (padding
    experts receive -inf router logits and are never selected)."""
    return pad_to(cfg.num_experts, max(1, model_axis_size))


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             model_axis_size: int = 1,
             dtype: torch.dtype = torch.bfloat16) -> Dict:
    d, f = cfg.d_model, cfg.moe_d_ff
    E = padded_experts(cfg, model_axis_size)
    p = {
        "router": dense_init(generator, (d, E), d, torch.float32),
        "wi": dense_init(generator, (E, d, f), d, dtype),
        "wg": dense_init(generator, (E, d, f), d, dtype),
        "wo": dense_init(generator, (E, f, d), f, dtype),
    }
    if cfg.num_shared_experts > 0:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "wi": dense_init(generator, (d, fs), d, dtype),
            "wg": dense_init(generator, (d, fs), d, dtype),
            "wo": dense_init(generator, (fs, d), fs, dtype),
        }
    return p


def _capacity(tokens: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(tokens * top_k * capacity_factor / num_experts) + 1
    return max(4, pad_to(c, 4))


class DropCount:
    """The (token, slot) pairs routed, and those capacity dropped, by the
    ``moe_ffn`` calls of one ``counting_drops`` block on this thread."""

    def __init__(self):
        self.pairs = 0
        self._dropped: List[torch.Tensor] = []

    @property
    def dropped(self) -> int:
        return sum(int(t) for t in self._dropped)


_counting = threading.local()


@contextlib.contextmanager
def counting_drops() -> Iterator[DropCount]:
    """Count the routed and dropped pairs of the ``moe_ffn`` calls made in
    the block, on this thread (the dropped count is kept on the device
    until read, so counting adds no synchronisation).  A call captured into
    a CUDA graph raises: its count tensor would be rewritten by every
    replay, so only eager steps are counted."""
    outer = getattr(_counting, "count", None)
    _counting.count = count = DropCount()
    try:
        yield count
    finally:
        _counting.count = outer


def _route(p: Mapping, xt: torch.Tensor, cfg: ModelConfig):
    """The reference's routing of tokens ``xt`` [T, d]: (order, expert,
    rank within the expert, kept, token, gate) of every (token, slot)
    pair, in expert-sorted order; ``order`` maps a sorted pair back to its
    flat (token, slot) index (slots in descending gate order)."""
    T = xt.shape[0]
    E = p["router"].shape[-1]
    k = cfg.top_k
    logits = xt.float() @ p["router"].float()                 # [T, E]
    if E > cfg.num_experts:                     # mask padding experts
        logits[:, cfg.num_experts:] = -1e30
    gates_all = torch.softmax(logits, dim=-1)
    top_gates, top_e = torch.topk(gates_all, k, dim=-1)       # [T, k]
    top_gates = top_gates / torch.clamp(
        top_gates.sum(-1, keepdim=True), min=1e-9)
    e_flat = top_e.reshape(-1)                                # [T*k]
    order = torch.argsort(e_flat, stable=True)                # by expert
    e_sorted = e_flat[order]
    # rank within the expert group = index - first occurrence of it
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos = torch.arange(T * k, device=xt.device) - first
    keep = pos < _capacity(T, E, k, cfg.capacity_factor)
    tok_sorted = order // k
    gate_sorted = top_gates.reshape(-1)[order]
    return order, e_sorted, pos, keep, tok_sorted, gate_sorted


def moe_ffn(p: Mapping, x: torch.Tensor, cfg: ModelConfig,
            model_axis=None) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d], the routed experts' gated FFN.  ``p``
    holds ``router``, ``wi``, ``wg`` and ``wo`` (a ``shared`` entry is
    ignored: ``shared_expert_ffn`` computes it).  With ``model_axis`` (the
    ``model`` sub-mesh) ``p``'s experts are this rank's window and the
    result is summed over the axis."""
    B, S, d = x.shape
    T = B * S
    E = p["wi"].shape[0]                        # the local experts
    k = cfg.top_k
    C = _capacity(T, p["router"].shape[-1], k, cfg.capacity_factor)
    xt = x.reshape(T, d)
    order, e_sorted, pos, keep, tok_sorted, gate_sorted = _route(p, xt, cfg)
    count = getattr(_counting, "count", None)
    if count is not None:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "counting_drops while capturing a CUDA graph: every replay "
                "would rewrite the captured count; count an eager step")
        count.pairs += T * k
        if not keep.is_meta:         # a meta trace has no routing to count
            count._dropped.append((~keep).sum())

    # ---- capacity buffers: each kept pair's token at (expert, rank); a
    # dropped pair (and, expert-parallel, a pair routed to another rank's
    # expert) writes the spare last row, which is cut off.  Masks stay
    # multiplications, not boolean indexing, so nothing waits for the card
    if model_axis is not None:
        e_start = model_axis.get_local_rank() * E
        keep = keep & (e_sorted >= e_start) & (e_sorted < e_start + E)
        e_sorted = e_sorted - e_start
    dest = torch.where(keep, e_sorted * C + pos, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xt[tok_sorted]
    buf = buf[:E * C].reshape(E, C, d)

    # ---- batched expert FFN (gated) ----------------------------------------
    h = torch.bmm(buf, p["wi"]) * F.silu(torch.bmm(buf, p["wg"]))
    y = torch.bmm(h, p["wo"]).reshape(E * C, d)               # [E*C, d]

    # ---- combine: slot by slot, in float32, no atomics ---------------------
    y = torch.cat([y, y.new_zeros((1, d))])
    contrib = y[dest] * (gate_sorted * keep)[:, None].to(y.dtype)
    per_slot = torch.empty_like(contrib)
    per_slot[order] = contrib                   # back to (token, slot)
    per_slot = per_slot.reshape(T, k, d).float()
    out = per_slot[:, 0]
    for j in range(1, k):
        out = out + per_slot[:, j]
    if model_axis is not None:
        out = all_reduce(out, model_axis.get_group())
    return out.to(x.dtype).reshape(B, S, d)


def shared_expert_ffn(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Always-on shared experts: a plain gated FFN."""
    sp = p["shared"]
    h = (x @ sp["wi"]) * F.silu(x @ sp["wg"])
    return h @ sp["wo"]


__all__ = ["DropCount", "F32_LEAVES", "counting_drops", "init_moe",
           "moe_ffn", "padded_experts", "shared_expert_ffn"]
