"""Optimizers: AdamW and Adafactor (factored second moment), in PyTorch.

The port of ``repro/optim/optimizers.py``, line for line: float32 state
(``m``, ``v``; Adafactor's ``vr`` and ``vc`` for leaves of two or more
dims, ``v`` for the rest), the update computed in float32 and cast to the
parameter's type.  A tree is a dict keyed by parameter name (the order of
``Model.named_parameters()``), its leaves tensors; nested dicts are walked
in key order.  ``update(grads, state, params)`` returns new tensors and a
new state and leaves its arguments as they are; the train step writes the
new parameters into the model in place.  The step count is a tensor on the
parameters' device, so an update never waits for the host.

Adafactor exists because AdamW's 16 B/param state cannot hold the 1T-param
Kimi-K2 config; factored second moments cut optimizer state to ~4 B/param
+ O(rows+cols).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    # update(grads, state, params) -> (new_params, new_state)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a tree, dicts walked in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``,
    trees of ``tree``'s structure (a place may hold a sub-tree there, which
    ``fn`` then gets whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _unzip(tree: Tree, n: int) -> List[Tree]:
    """A tree whose leaves are n-tuples as n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(tree)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def _step0(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params):
        if clip_norm > 0:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        t = step.float()
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            new_p = p.float() - lr * (
                mh / (torch.sqrt(vh) + eps) + weight_decay * p.float())
            return new_p.to(p.dtype), m, v

        new_params, new_m, new_v = _unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_params, {"m": new_m, "v": new_v, "step": step}

    return Optimizer("adamw", init, update)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def state_for(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"f": tree_map(state_for, params), "step": _step0(params)}

    def update(grads, state, params):
        if clip_norm > 0:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - torch.pow(t, -decay)

        def upd(p, g, s):
            g = g.float()
            g2 = torch.square(g) + eps
            if p.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                   min=eps)
                prec = (vr[..., None] / rfac[..., None]) * vc[..., None, :]
                u = g / torch.sqrt(torch.clamp(prec, min=eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / torch.sqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            # relative-scale update clipping (Adafactor's d=1.0)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u, min=1.0)
            new_p = p.float() - lr * u - lr * weight_decay * p.float()
            return new_p.to(p.dtype), new_s

        new_params, new_f = _unzip(
            tree_map(upd, params, grads, state["f"]), 2)
        return new_params, {"f": new_f, "step": step}

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")


__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "global_norm", "make_optimizer", "tree_leaves", "tree_map"]
