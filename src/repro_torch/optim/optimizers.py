"""Optimizers: AdamW and Adafactor (factored second moment), in PyTorch.

The port of ``repro/optim/optimizers.py``: float32 state (``m``, ``v``;
Adafactor's ``vr`` and ``vc`` for leaves of two or more dims, ``v`` for
the rest), the update computed in float32 and cast to the parameter's
type.  A tree is a dict keyed by parameter name (the order of
``Model.named_parameters()``), its leaves tensors; AdamW walks nested
dicts in key order, Adafactor takes the flat dict.  ``update(grads,
state, params)`` writes each leaf's new parameter and state into the
given tensors as soon as that leaf is done, and returns the same ``params`` and ``state``: the counterpart of the
reference's train step, which donates both (``donate_argnums=(0, 1)``),
so no second copy of either is ever held.  The gradients are left as they
are.  The step count is a tensor on the parameters' device, so an update
never waits for the host.

The reference stacks every block leaf on a layer axis; the port keeps one
leaf per layer.  AdamW is elementwise, so that is all the same to it.
Adafactor's statistics are not: given the stacks
(``models.api.layer_stacks``), it factors and clips over each stack as
the reference does over the stacked array.

Adafactor exists because AdamW's 16 B/param state cannot hold the 1T-param
Kimi-K2 config; factored second moments cut optimizer state to ~4 B/param
+ O(rows+cols).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]
    # update(grads, state, params) -> (params, state), written in place


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
        step = state["step"].add_(1)
        t = step.float()
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(p, g, m, v):
            # the reference's formulas, each op rounding as it does there
            # (``m.mul_(b1)`` is ``b1 * m``); every temporary dropped once
            # read, so one leaf's few f32 temporaries are all it adds
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            step_dir = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.float()
            p.copy_(pf - lr * (step_dir + weight_decay * pf))  # cast: .to

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer("adamw", init, update)


def _factored_state(shape: Tuple[int, ...], device) -> dict:
    """Adafactor's state of a leaf of ``shape``: ``vr`` and ``vc`` for two
    or more dims, else ``v``."""
    f32 = dict(dtype=torch.float32, device=device)
    if len(shape) >= 2:
        return {"vr": torch.zeros(shape[:-1], **f32),
                "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)}
    return {"v": torch.zeros(shape, **f32)}


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0, weight_decay: float = 0.0,
              stacks: Optional[Mapping[str, Sequence[str]]] = None
              ) -> Optimizer:
    """Adafactor over leaves as the reference sees them.  ``stacks`` maps
    the name of a reference leaf stacked on a layer axis to the names of
    its layers' leaves in a flat tree, in layer order
    (``models.api.layer_stacks``): such a leaf's state has the stacked
    shape (a stack of ``[d]`` vectors gets ``vr [L]`` and ``vc [d]``) and
    one clip RMS over all its layers, as the reference computes over the
    stacked array; its state sits under the stack's name, where its first
    layer's leaf stands.  Every other leaf is its own."""
    stacks = {k: list(v) for k, v in (stacks or {}).items()}
    first = {names[0]: key for key, names in stacks.items()}
    member = {n for names in stacks.values() for n in names}

    def init(params):
        f = {}
        for name, p in params.items():
            if name in first:
                shape = (len(stacks[first[name]]),) + tuple(p.shape)
                f[first[name]] = _factored_state(shape, p.device)
            elif name not in member:
                f[name] = _factored_state(tuple(p.shape), p.device)
        return {"f": f, "step": _step0(params)}

    def leaf_update(ps: List[torch.Tensor], gs: List[torch.Tensor],
                    s: dict, beta: torch.Tensor, stacked: bool) -> None:
        """One reference leaf, given as its layers ``ps`` (one unless
        ``stacked``) and their gradients; parameters and state written in
        place, layer by layer."""
        vectors = stacked and ps[0].ndim == 1   # [L, d]: vc across layers
        layers = [{k: t[i] for k, t in s.items()} for i in range(len(ps))] \
            if stacked and not vectors else [s]
        # the second moments, folded into the state
        if vectors:
            g2_sum = None
            for i, g in enumerate(gs):
                g2 = torch.square(g.float()) + eps
                s["vr"][i].mul_(beta).add_((1 - beta) * torch.mean(g2))
                g2_sum = g2 if g2_sum is None else g2_sum + g2
            s["vc"].mul_(beta).add_((1 - beta) * (g2_sum / len(gs)))
        else:
            for g, sl in zip(gs, layers):
                g2 = torch.square(g.float()) + eps
                if "vr" in sl:
                    sl["vr"].mul_(beta).add_(
                        (1 - beta) * torch.mean(g2, dim=-1))
                    sl["vc"].mul_(beta).add_(
                        (1 - beta) * torch.mean(g2, dim=-2))
                else:
                    sl["v"].mul_(beta).add_((1 - beta) * g2)
        # the update direction of each layer
        us = []
        for i, g in enumerate(gs):
            g = g.float()
            if vectors:
                rfac = torch.clamp(torch.mean(s["vr"]), min=eps)
                prec = (s["vr"][i] / rfac) * s["vc"]
            elif "vr" in layers[i]:
                vr, vc = layers[i]["vr"], layers[i]["vc"]
                rfac = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                   min=eps)
                prec = (vr[..., None] / rfac[..., None]) * vc[..., None, :]
            else:
                prec = layers[i]["v"]
            us.append(g / torch.sqrt(torch.clamp(prec, min=eps)))
        # relative-scale update clipping (Adafactor's d=1.0), one RMS for
        # the whole leaf
        if len(us) == 1:
            ms = torch.mean(torch.square(us[0]))
        else:
            ms = sum(torch.sum(torch.square(u)) for u in us) \
                / sum(u.numel() for u in us)
        rms_u = torch.sqrt(ms + 1e-30)
        for p, u in zip(ps, us):
            u = u / torch.clamp(rms_u, min=1.0)
            pf = p.float()
            p.copy_(pf - lr * u - lr * weight_decay * pf)   # cast: .to

    def update(grads, state, params):
        if clip_norm > 0:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state["step"].add_(1)
        t = step.float()
        beta = 1.0 - torch.pow(t, -decay)
        for key, s in state["f"].items():
            names = stacks.get(key, [key])
            leaf_update([params[n] for n in names], [grads[n] for n in names],
                        s, beta, key in stacks)
        return params, state

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, stacks: Optional[Mapping[str, Sequence[str]]]
                   = None, **kw) -> Optimizer:
    """The optimizer ``name``; ``stacks`` (``models.api.layer_stacks``)
    reaches Adafactor only, since AdamW is elementwise."""
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(stacks=stacks, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "global_norm", "make_optimizer", "tree_leaves", "tree_map"]
