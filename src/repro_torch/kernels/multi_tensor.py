"""Multi-tensor AdamW: the wrappers of the hand-written CUDA kernels
(``csrc/model_kernels.cu`` ``mt_sumsq_kernel``, ``mt_total_kernel`` and
``mt_adamw_kernel``) and their plain PyTorch versions.

``sumsq`` is the sum of squares of a list of tensors in float32 and
``norm`` its root (the gradients' global norm before clipping); ``adamw``
the clipped AdamW update of every leaf, written in place into the
parameters and both moments.  On the card each takes a few launches over
all the leaves, where the plain versions issue about 30 PyTorch kernels a
leaf.  The device alone chooses: the plain versions on the CPU, a result
of the right shape on ``meta`` (nothing run), the kernels on the card,
which raise for tensors they do not take (``_check``).  The plain versions
are the per-leaf code, and the kernels round every operation as it does:
given the same clip scale, ``adamw`` on the card equals ``plain_adamw`` bit
for bit.  The sum of squares adds in another order, within 1e-6 of the
plain one, and gives the same bits on every run.  A cost counter
(``launch/op_cost.py``) counts each call as one unit.

``plan`` packs the leaves into launches.  ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from . import backend

#: kernel launches since the last ``ops.reset_launch_counts()``: the sum of
#: squares' (a launch a pack of leaves, and the final sum) and the update's
LAUNCHES = {"multi_tensor_sumsq": 0, "multi_tensor_adamw": 0}

#: elements a block takes (``MT_CHUNK``), and the most leaves a launch of
#: the sum of squares and of the update holds (``MT_SUMSQ_LEAVES``,
#: ``MT_ADAMW_LEAVES``: what fits 4 KB of kernel arguments)
CHUNK = 16384
SUMSQ_LEAVES, ADAMW_LEAVES = 160, 80


@dataclasses.dataclass(frozen=True)
class Pack:
    """The leaves of one launch: their places in the list given to
    ``plan`` (``leaves``), the first block of each within the launch and
    then the launch's blocks (``starts``), and the launch's first block
    over all the launches of the list (``first``: where its partial sums
    go)."""

    leaves: Tuple[int, ...]
    starts: Tuple[int, ...]
    first: int

    @property
    def blocks(self) -> int:
        return self.starts[-1]

    def chunks(self, numels: Sequence[int]) -> List[Tuple[int, int, int]]:
        """(leaf, first element, end) of each block of the launch, as the
        kernels map a block: to the last leaf whose first block is at most
        its own (``mt_leaf``'s binary search), ``CHUNK`` elements of it."""
        out = []
        for b in range(self.blocks):
            lo, hi = 0, len(self.leaves) - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if self.starts[mid] <= b:
                    lo = mid
                else:
                    hi = mid - 1
            leaf = self.leaves[lo]
            start = (b - self.starts[lo]) * CHUNK
            out.append((leaf, start, min(numels[leaf], start + CHUNK)))
        return out


def plan(numels: Sequence[int], per_launch: int) -> List[Pack]:
    """The launches over leaves of ``numels`` elements, in leaf order, at
    most ``per_launch`` leaves each; a leaf of no element is in none."""
    packs: List[Pack] = []
    leaves: List[int] = []
    starts: List[int] = []
    first = 0

    def close():
        nonlocal leaves, starts, first
        if leaves:
            blocks = starts[-1] + -(-numels[leaves[-1]] // CHUNK)
            if blocks >= 1 << 31:
                raise ValueError(f"multi_tensor: {blocks} blocks in a launch")
            packs.append(Pack(tuple(leaves), tuple(starts) + (blocks,),
                              first))
            first += blocks
        leaves, starts = [], []

    for i, n in enumerate(numels):
        if n <= 0:
            continue
        if len(leaves) == per_launch:
            close()
        starts.append(starts[-1] + -(-numels[leaves[-1]] // CHUNK)
                      if leaves else 0)
        leaves.append(i)
    close()
    return packs


def _check(name: str, dev: torch.device,
           *lists: Sequence[torch.Tensor]) -> None:
    """Raise unless the kernel ``name`` takes these tensors: every one a
    plain tensor on ``dev``, contiguous, float32 or bfloat16."""
    for ts in lists:
        for t in ts:
            if type(t) not in (torch.Tensor, torch.nn.Parameter):
                raise TypeError(f"{name}: expected plain tensors, got "
                                f"{type(t).__name__}")
            if t.device != dev:
                raise ValueError(f"{name}: a tensor on {t.device}, "
                                 f"expected {dev}")
            if t.dtype not in backend.DTYPE_CODES:
                raise TypeError(f"{name}: dtype {t.dtype}, expected "
                                f"float32 or bfloat16")
            if not t.is_contiguous():
                raise ValueError(f"{name}: a tensor of shape "
                                 f"{tuple(t.shape)} is not contiguous")


def _vec(*ts: torch.Tensor) -> int:
    """1 where 16-byte loads reach every tensor's elements."""
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def _table(pack: Pack, numels: Sequence[int], fields) -> ctypes.Array:
    """A launch's host table (``mt_fill``): the leaf count, the blocks, then
    per leaf its elements, first block, bf16, vec and ``fields(leaf)``'s
    addresses."""
    vals = [len(pack.leaves), pack.blocks]
    for leaf, start in zip(pack.leaves, pack.starts):
        bf16, vec, ptrs = fields(leaf)
        vals += [numels[leaf], start, bf16, vec, *ptrs]
    return (ctypes.c_int64 * len(vals))(*vals)


# ---------------------------------------------------------------------------
# the sum of squares and the global norm
# ---------------------------------------------------------------------------

def plain_sumsq(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of every tensor together, in f32, a leaf at a
    time."""
    return sum(torch.sum(torch.square(t.float())) for t in tensors)


def sumsq(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of every tensor together, a 0-d float32 tensor:
    ``plain_sumsq`` on the CPU, the kernels on the card."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("multi_tensor.sumsq: no tensors")
    with backend.kernel_call("multi_tensor_sumsq", tensors):
        dev = tensors[0].device
        if dev.type == "cpu":
            return plain_sumsq(tensors)
        if dev.type == "meta":           # what the card gives, nothing run
            return torch.empty((), dtype=torch.float32, device=dev)
        return _sumsq_launch(dev, tensors)


def norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The norm of every tensor together, a 0-d float32 tensor."""
    return torch.sqrt(sumsq(tensors))


def _sumsq_launch(dev: torch.device, tensors: List[torch.Tensor]
                  ) -> torch.Tensor:
    """``mt_sumsq_kernel`` over each pack of leaves, then
    ``mt_total_kernel`` over every block's partial."""
    if dev.type != "cuda":
        raise ValueError(f"multi_tensor.sumsq: unsupported device {dev}")
    _check("multi_tensor.sumsq", dev, tensors)
    numels = [t.numel() for t in tensors]
    packs = plan(numels, SUMSQ_LEAVES)
    if not packs:                        # every tensor empty
        return torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty(packs[-1].first + packs[-1].blocks,
                           dtype=torch.float32, device=dev)

    def fields(i):
        t = tensors[i]
        return int(t.dtype == torch.bfloat16), _vec(t), (t.data_ptr(),)
    with torch.cuda.device(dev):
        lib = backend.library(backend.MODEL_SOURCE)
        stream = backend.stream_handle(dev)
        for pack in packs:
            backend.check_launch("kapla_mt_sumsq", lib.kapla_mt_sumsq(
                _table(pack, numels, fields),
                partials.data_ptr() + 4 * pack.first, stream))
        n = (ctypes.c_int64 * 1)(partials.numel())
        backend.check_launch("kapla_mt_total", lib.kapla_mt_total(
            partials.data_ptr(), n, out.data_ptr(), stream))
    backend.count_launch(LAUNCHES, "multi_tensor_sumsq", len(packs) + 1)
    return out


# ---------------------------------------------------------------------------
# the AdamW update
# ---------------------------------------------------------------------------

def plain_adamw_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                     *, lr: float, b1: float, b2: float, eps: float,
                     weight_decay: float) -> None:
    """One leaf's AdamW update, written into ``p``, ``m`` and ``v``: the
    reference's formulas, each op rounding as it does there (``m.mul_(b1)``
    is ``b1 * m``); every temporary dropped once read, so one leaf's few
    f32 temporaries are all it adds."""
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    del g
    step_dir = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    pf = p.float()
    p.copy_(pf - lr * (step_dir + weight_decay * pf))  # cast: .to


def plain_adamw(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], bc1: torch.Tensor,
                bc2: torch.Tensor, scale: Optional[torch.Tensor] = None,
                **hp: float) -> None:
    """``plain_adamw_leaf`` on each leaf, its gradient first clipped
    (``(g.float() * scale).to(g.dtype)``) where ``scale`` is given."""
    for p, g, m, v in zip(params, grads, ms, vs):
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        plain_adamw_leaf(p, g, m, v, bc1, bc2, **hp)


def adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
          ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
          bc1: torch.Tensor, bc2: torch.Tensor,
          scale: Optional[torch.Tensor] = None, *, lr: float, b1: float,
          b2: float, eps: float, weight_decay: float) -> None:
    """AdamW's update of every leaf (parameter, gradient, first and second
    moment) in place, each gradient clipped by the 0-d ``scale`` where it
    is given; ``bc1`` and ``bc2`` are the bias corrections, 0-d float32.
    ``plain_adamw`` on the CPU, nothing on ``meta`` (the update is in
    place), the kernel on the card."""
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    params, grads, ms, vs = (list(x) for x in (params, grads, ms, vs))
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"multi_tensor.adamw: {len(params)} parameters, "
                         f"{len(grads)} gradients, {len(ms)} and {len(vs)} "
                         f"moments")
    if not params:
        return
    with backend.kernel_call("multi_tensor_adamw", params, grads,
                             clip=scale is not None):
        dev = params[0].device
        if dev.type == "cpu":
            plain_adamw(params, grads, ms, vs, bc1, bc2, scale, **hp)
        elif dev.type != "meta":
            _adamw_launch(dev, params, grads, ms, vs, bc1, bc2, scale, hp)


def _adamw_launch(dev, params, grads, ms, vs, bc1, bc2, scale, hp) -> None:
    """``mt_adamw_kernel`` over each pack of leaves."""
    if dev.type != "cuda":
        raise ValueError(f"multi_tensor.adamw: unsupported device {dev}")
    scalars = [bc1, bc2] + ([scale] if scale is not None else [])
    _check("multi_tensor.adamw", dev, params, grads, ms, vs, scalars)
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if not (g.dtype == p.dtype and m.dtype == v.dtype == torch.float32
                and p.shape == g.shape == m.shape == v.shape):
            raise ValueError(
                f"multi_tensor.adamw: leaf {i}: parameter {p.dtype} "
                f"{tuple(p.shape)}, gradient {g.dtype} {tuple(g.shape)}, "
                f"moments {m.dtype} {tuple(m.shape)} and {v.dtype} "
                f"{tuple(v.shape)}; expected the gradient of the "
                f"parameter's type and float32 moments, all of one shape")
    if not all(s.numel() == 1 and s.dtype == torch.float32
               for s in scalars):
        raise ValueError("multi_tensor.adamw: the bias corrections and the "
                         "clip scale must be one float32 each")
    numels = [p.numel() for p in params]
    packs = plan(numels, ADAMW_LEAVES)
    # rounded to float32 in the entry point, as PyTorch rounds a Python
    # float for a float32 tensor
    f = (ctypes.c_double * 7)(hp["lr"], hp["b1"], 1 - hp["b1"], hp["b2"],
                              1 - hp["b2"], hp["eps"], hp["weight_decay"])

    def fields(i):
        p, g, m, v = params[i], grads[i], ms[i], vs[i]
        return (int(p.dtype == torch.bfloat16), _vec(p, g, m, v),
                (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()))
    with torch.cuda.device(dev):
        lib = backend.library(backend.MODEL_SOURCE)
        stream = backend.stream_handle(dev)
        for pack in packs:
            backend.check_launch("kapla_mt_adamw", lib.kapla_mt_adamw(
                _table(pack, numels, fields), f, bc1.data_ptr(),
                bc2.data_ptr(), None if scale is None else scale.data_ptr(),
                stream))
    backend.count_launch(LAUNCHES, "multi_tensor_adamw", len(packs))


__all__ = ["ADAMW_LEAVES", "CHUNK", "LAUNCHES", "Pack", "SUMSQ_LEAVES",
           "adamw", "norm", "plan", "plain_adamw", "plain_adamw_leaf",
           "plain_sumsq", "sumsq"]
