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
never waits for the host.  AdamW's update and the global norm go through
``kernels/multi_tensor.py``: on the card a few launches over every leaf (a
rank's windows too), the clip inside the update; on the CPU leaf by leaf.

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
import math
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import torch

from ..kernels import multi_tensor

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]
    # update(grads, state, params, shards=None) -> (params, state), written
    # in place; ``shards`` (``TreeShards``): the trees are one rank's
    # windows
    #: the state sub-tree that mirrors the parameters leaf for leaf
    #: (AdamW's ``m``): on shards each gradient is reduced to its window
    mirror: Optional[str] = None


class TreeShards:
    """One rank's windows of the trees an update reads, for a partitioned
    train step (``launch/partition.py``): ``sh``, the rank's
    ``models/shards.py`` ``Shards``; ``params``, each parameter's
    ``Layout`` by name; ``state``, the ``Layout`` of every
    optimizer-state leaf, a tree of the state's structure; ``grads``, each
    gradient's (``reduce`` gives it).  Every tensor the update is given is
    the local window;
    statistics over a whole leaf are all-reduced over the axes that shard
    it, and a leaf replicated over an axis is counted once."""

    def __init__(self, sh, params: Mapping[str, Any], state: Tree,
                 mirror: Optional[str] = None):
        self.sh, self.params, self.state = sh, params, state
        #: each gradient's window as the update reads it: its parameter's,
        #: or that of ``mirror``'s leaf (ZeRO: narrower over the data axes)
        self.grads = dict(state[mirror]) if mirror else dict(params)

    def reduce(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A gradient's window, this rank's part summed over the data
        ranks: reduce-scattered where its window narrows the parameter's
        (ZeRO), all-reduced over the other data axes that do not shard
        the parameter (a data-sharded leaf's arrives summed through
        ``Shards.local``'s reduce-scatter); contiguous, as the
        multi-tensor kernels take it (a chunk of a dim past the first
        arrives as a strided view)."""
        lay, glay = self.params[name], self.grads[name]
        for d, _, _, axes in self.narrower(lay, glay):
            g = self.sh.reduce_scatter(g, d, axes)
        return self.sh.all_reduce(g, [a for a in self.sh.data_axes
                                      if a not in self.axes(glay)]
                                  ).contiguous()

    def axes(self, lay, dims: Optional[Sequence[int]] = None
             ) -> Tuple[str, ...]:
        """The mesh axes of more than one rank that shard ``dims`` of a
        window (every dim by default)."""
        dims = range(len(lay.axes)) if dims is None else dims
        return tuple(dict.fromkeys(a for d in dims for a in lay.axes[d]
                                   if self.sh.size[a] > 1))

    def full_shape(self, lay) -> Tuple[int, ...]:
        return tuple(n * math.prod(self.sh.size[a] for a in ax)
                     for n, ax in zip(lay.sizes, lay.axes))

    def gather(self, t: torch.Tensor, lay, dims: Sequence[Optional[int]]
               ) -> torch.Tensor:
        """``t`` whole along each dim ``j`` that is the window's dim
        ``dims[j]`` (None: ``t`` is whole there already)."""
        for j, d in enumerate(dims):
            if d is not None:
                t = self.sh.all_gather(t, j, lay.axes[d])
        return t

    def window(self, t: torch.Tensor, lay, dims: Sequence[Optional[int]]
               ) -> torch.Tensor:
        """The window of ``t`` (whole along each ``dims[j]`` not None)
        that ``lay`` holds."""
        for j, d in enumerate(dims):
            if d is not None and t.shape[j] != lay.sizes[d]:
                t = t.narrow(j, lay.offsets[d], lay.sizes[d])
        return t

    def whole(self, t: torch.Tensor, lay) -> torch.Tensor:
        """A state leaf gathered whole on every rank (``t`` itself where
        nothing shards it)."""
        return self.gather(t, lay, range(t.dim())) if self.axes(lay) else t

    def put(self, local: torch.Tensor, whole: torch.Tensor, lay) -> None:
        """Write this rank's window of ``whole`` into ``local``."""
        if whole is not local:
            local.copy_(self.window(whole, lay, range(whole.dim())))

    def narrower(self, lay, state_lay) -> List[Tuple[int, int, int,
                                                     Tuple[str, ...]]]:
        """Where a state leaf's window narrows its parameter's (ZeRO: the
        moments sharded over the data axes, the parameter not): (dim,
        start within the parameter's window, size, the axes)."""
        out = []
        for d, (n, m) in enumerate(zip(lay.sizes, state_lay.sizes)):
            if m != n:
                out.append((d, state_lay.offsets[d] - lay.offsets[d], m,
                            tuple(a for a in state_lay.axes[d]
                                  if a not in lay.axes[d])))
        return out


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


def global_norm(tree: Tree, shards: Optional[TreeShards] = None
                ) -> torch.Tensor:
    """The norm of every leaf together (``kernels/multi_tensor.py``: its
    kernels on the card, a sum of squares a leaf on the CPU).  With
    ``shards`` ``tree`` is a flat dict of parameter windows by name: each
    leaf's sum of squares is summed over the axes that shard it (the
    leaves grouped by those axes, a sum and one all-reduce a group), so a
    mesh of one rank gives the unsharded norm's bits."""
    if shards is None:
        return multi_tensor.norm(tree_leaves(tree))
    groups: dict = {}
    for name, leaf in tree.items():
        groups.setdefault(shards.axes(shards.grads[name]), []).append(leaf)
    return torch.sqrt(sum(shards.sh.all_reduce(multi_tensor.sumsq(leaves),
                                               ax)
                          for ax, leaves in groups.items()))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that clips gradients of global norm ``norm`` to
    ``max_norm`` (1 below it)."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float,
                        shards: Optional[TreeShards] = None) -> Tree:
    scale = clip_scale(global_norm(grads, shards), max_norm)
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

    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def corrections(state):
        """The step count advanced, and the bias corrections (0-d, on the
        step's device)."""
        t = state["step"].add_(1).float()
        return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)

    def update(grads, state, params, shards=None):
        # the norm, then the clip inside the update: no clipped tree
        scale = clip_scale(global_norm(grads, shards), clip_norm) \
            if clip_norm > 0 else None
        bc1, bc2 = corrections(state)
        if shards is None:
            leaves = []        # (param, grad, m, v) of each leaf, by name
            tree_map(lambda *x: leaves.append(x), params, grads,
                     state["m"], state["v"])
            multi_tensor.adamw(*(zip(*leaves) if leaves else ((),) * 4),
                               bc1, bc2, scale, **hp)
            return params, state
        # ZeRO: each rank updates its window of a parameter, taken
        # contiguous, and gathers it whole again after
        names = list(params)
        wins = [shards.narrower(shards.params[n], shards.grads[n])
                for n in names]
        pws = []
        for name, win in zip(names, wins):
            pw = params[name]
            for d, start, n, _ in win:
                pw = pw.narrow(d, start, n)
            pws.append(pw.contiguous())
        multi_tensor.adamw(pws, [grads[n] for n in names],
                           [state["m"][n] for n in names],
                           [state["v"][n] for n in names], bc1, bc2, scale,
                           **hp)
        for name, win, pw in zip(names, wins, pws):
            for d, _, _, axes in reversed(win):
                pw = shards.sh.all_gather(pw, d, axes)
            if pw is not params[name]:
                params[name].copy_(pw)
        return params, state

    return Optimizer("adamw", init, update, mirror="m")


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
                    s: dict, beta: torch.Tensor, stacked: bool,
                    shards: Optional[TreeShards], lay, slay) -> None:
        """One reference leaf, given as its layers ``ps`` (one unless
        ``stacked``) and their gradients; parameters and state written in
        place, layer by layer.  With ``shards`` the layers are windows
        (``lay``, one for all), and ``s`` windows of the state (``slay``):
        each mean over a sharded dim is all-reduced over its axes, the
        new state is made whole on every rank (it is O(rows + cols)),
        each rank keeps its window of it and reads its parameter's."""
        nd = ps[0].ndim
        vectors = stacked and nd == 1           # [L, d]: vc across layers

        def mean(t, dim=None, keepdim=False):
            """The mean over the leaf's ``dim`` (every dim: None)."""
            ax = () if shards is None else shards.axes(
                lay, None if dim is None else [dim % nd])
            if not ax:
                return torch.mean(t) if dim is None else \
                    torch.mean(t, dim=dim, keepdim=keepdim)
            full = shards.full_shape(lay)
            n = math.prod(full) if dim is None else full[dim]
            tot = torch.sum(t) if dim is None else \
                torch.sum(t, dim=dim, keepdim=keepdim)
            return shards.sh.all_reduce(tot, ax) / n

        def gather(t, dims):
            return t if shards is None else shards.gather(t, lay, dims)

        def window(t, dims):
            return t if shards is None else shards.window(t, lay, dims)
        rows = list(range(nd - 1))              # the dims of vr's layer
        cols = list(range(nd - 2)) + [nd - 1]   # the dims of vc's layer
        ss = s if shards is None else \
            {k: shards.whole(t, slay[k]) for k, t in s.items()}
        layers = [{k: t[i] for k, t in ss.items()} for i in range(len(ps))] \
            if stacked and not vectors else [ss]
        # the second moments, folded into the state
        if vectors:
            g2_sum = None
            for i, g in enumerate(gs):
                g2 = torch.square(g.float()) + eps
                ss["vr"][i].mul_(beta).add_((1 - beta) * mean(g2))
                g2_sum = g2 if g2_sum is None else g2_sum + g2
            ss["vc"].mul_(beta).add_(gather(
                (1 - beta) * (g2_sum / len(gs)), [0]))
        else:
            for g, sl in zip(gs, layers):
                g2 = torch.square(g.float()) + eps
                if "vr" in sl:
                    sl["vr"].mul_(beta).add_(gather(
                        (1 - beta) * mean(g2, dim=-1), rows))
                    sl["vc"].mul_(beta).add_(gather(
                        (1 - beta) * mean(g2, dim=-2), cols))
                else:
                    sl["v"].mul_(beta).add_(gather((1 - beta) * g2,
                                                   range(nd)))
        if shards is not None:
            for k, t in s.items():
                shards.put(t, ss[k], slay[k])
        # the update direction of each layer
        us = []
        for i, g in enumerate(gs):
            g = g.float()
            if vectors:
                rfac = torch.clamp(torch.mean(ss["vr"]), min=eps)
                prec = (ss["vr"][i] / rfac) * window(ss["vc"], [0])
            elif "vr" in layers[i]:
                vr, vc = layers[i]["vr"], layers[i]["vc"]
                rfac = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                   min=eps)
                vr, vc = window(vr, rows), window(vc, cols)
                rfac = window(rfac, rows[:-1] + [None])
                prec = (vr[..., None] / rfac[..., None]) * vc[..., None, :]
            else:
                prec = window(layers[i]["v"], range(nd))
            us.append(g / torch.sqrt(torch.clamp(prec, min=eps)))
        # relative-scale update clipping (Adafactor's d=1.0), one RMS for
        # the whole leaf
        ax = () if shards is None else shards.axes(lay)
        if not ax:
            if len(us) == 1:
                ms = torch.mean(torch.square(us[0]))
            else:
                ms = sum(torch.sum(torch.square(u)) for u in us) \
                    / sum(u.numel() for u in us)
        else:
            ms = shards.sh.all_reduce(
                sum(torch.sum(torch.square(u)) for u in us), ax) \
                / (len(us) * math.prod(shards.full_shape(lay)))
        rms_u = torch.sqrt(ms + 1e-30)
        for p, u in zip(ps, us):
            u = u / torch.clamp(rms_u, min=1.0)
            pf = p.float()
            p.copy_(pf - lr * u - lr * weight_decay * pf)   # cast: .to

    def update(grads, state, params, shards=None):
        if clip_norm > 0:
            grads = clip_by_global_norm(grads, clip_norm, shards)
        step = state["step"].add_(1)
        t = step.float()
        beta = 1.0 - torch.pow(t, -decay)
        for key, s in state["f"].items():
            names = stacks.get(key, [key])
            leaf_update([params[n] for n in names], [grads[n] for n in names],
                        s, beta, key in stacks, shards,
                        shards.params[names[0]] if shards else None,
                        shards.state["f"][key] if shards else None)
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


__all__ = ["Optimizer", "TreeShards", "adafactor", "adamw",
           "clip_by_global_norm", "clip_scale", "global_norm",
           "make_optimizer", "tree_leaves", "tree_map"]
