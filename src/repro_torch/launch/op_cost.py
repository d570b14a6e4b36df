"""Op-level FLOP, byte and peak-memory counting of a PyTorch step.

The counterpart of ``repro/launch/hlo_cost.py``.  The port has no HLO: a
PyTorch step is a sequence of dispatched ops, so the count is taken at
dispatch, by a ``TorchDispatchMode`` (``OpCounter``), as
``torch.utils.flop_counter.FlopCounterMode`` is built.  The rules are the
reference's:

* dot-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``;
  ``matmul``, ``einsum`` and ``linear`` lower to them): 2 x prod(result) x
  prod(contracted);
* convolution: 2 x prod(result) x (input channels / groups x kernel
  window), and the same for each gradient its backward computes;
* elementwise ops and reductions: 1 flop per output element;
* bytes: each op's operands plus its results.  Views, reshapes and
  metadata are free (``hlo_cost.py:326-330``); so is a slice, which in
  PyTorch is a view whose window the op reading it counts.  A reshape is
  free even where it has to copy (the ``clone`` that ``reshape`` and
  ``matmul`` make of a non-contiguous input before their
  ``_unsafe_view``): an op's output layout is not always the same on
  ``meta`` as on the card (``softplus_backward``'s is not), and the count
  must not depend on it (``free_copy_bytes`` keeps what the rule left
  out).  Ops that copy a
  window (``index``, ``gather``, ``index_select``, ``embedding``) count it
  read and written (``:331-333``); in-place updates of a window
  (``index_put_``, ``scatter``, ``index_add_``, ``copy_``) their update
  read and written (``:334-341``); copies, casts, concatenations and pads
  move their bytes with no flops (``:342-346``); fills write their
  result.

The hand kernels count as one unit each, by the formulas below, which
``chip_smoke.py`` also uses for their bound: ``flash_ops``/``flash_bytes``
and ``ssd_ops``/``ssd_bytes``.  Their wrappers mark each call
(``kernels/backend.py`` ``kernel_call``), and the aten ops inside a wrapper
(the CPU's plain version, allocations) are not counted, so a step counts
the same on ``meta``, on the CPU and on the card.

There are no trip counts to find: an eager Python loop dispatches every
iteration (the counterpart of ``HloCostModel.trip_count``).  A
single-process step issues no collective; ``CompCost`` keeps
``coll_bytes`` and ``coll_by_kind`` for the dry-run to fill in from the
sharding plan.  ``peak_bytes`` is the high-water mark of the bytes held by
the step's inputs and by every storage created under the counter, frees
included: the counterpart of ``compiled.memory_analysis()``.
``held_bytes`` is the inputs' part of it, so ``peak_bytes - held_bytes``
is what the step holds beyond its arguments.  ``by_op`` splits the flops
and bytes by aten op (and hand kernel).  Only ops
that touch the counted device are counted (a card step's host-side
bookkeeping is not).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class CompCost:
    flops: int = 0
    bytes: int = 0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    #: hand-kernel calls counted as units, by kernel
    kernel_units: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: aten ops counted (outside the kernels' wrappers)
    ops: int = 0
    #: bytes of the storages ``hold`` counted: the step's arguments
    held_bytes: int = 0
    #: [flops, bytes] by aten op name or hand kernel
    by_op: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    #: bytes of the copying reshapes counted free
    free_copy_bytes: int = 0


# ---------------------------------------------------------------------------
# the hand kernels' formulas
# ---------------------------------------------------------------------------

def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: query row r sits at
    r + Sk - Sq and sees keys in [lo, hi]."""
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_ops(B: int, H: int, Sq: int, Sk: int, D: int, causal: bool,
              window: int) -> int:
    """Multiply-adds x 2 of Q Kᵀ and P V over the unmasked pairs."""
    return 4 * B * H * D * attention_pairs(Sq, Sk, causal, window)


def flash_bytes(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
                elem: int, lse: bool = False) -> int:
    """q and the output, k and v, each once; the f32 log-sum-exp when it
    is written."""
    return elem * (2 * B * H * Sq * D + 2 * B * KV * Sk * D) \
        + (4 * B * H * Sq if lse else 0)


def ssd_ops(B: int, H: int, NC: int, Lc: int, P: int, N: int) -> int:
    """C Bᵀ once per (b, chunk) and its decay-masked product with x per
    head, over the pairs l >= m of a chunk."""
    tri = Lc * (Lc + 1) // 2
    return 2 * B * NC * tri * N + 2 * B * H * NC * tri * P


def ssd_bytes(B: int, H: int, NC: int, Lc: int, P: int, N: int,
              elem: int) -> int:
    """x and the output in x's type; dt and acum, B and C in float32."""
    return 2 * elem * B * H * NC * Lc * P + 4 * 2 * B * H * NC * Lc \
        + 4 * 2 * B * NC * Lc * N


def _flash_unit(q, k, v, causal=True, window=0, return_lse=False):
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    return (flash_ops(B, H, Sq, Sk, D, causal, window),
            flash_bytes(B, H, KV, Sq, Sk, D, q.element_size(), return_lse))


def _ssd_unit(x, b):
    B, H, NC, Lc, P = x.shape
    N = b.shape[-1]
    return (ssd_ops(B, H, NC, Lc, P, N),
            ssd_bytes(B, H, NC, Lc, P, N, x.element_size()))


#: a wrapper's name -> (flops, bytes) of one call from its arguments
KERNEL_UNITS: Dict[str, Callable[..., Tuple[int, int]]] = {
    "flash_attention": _flash_unit, "ssd_intra_chunk": _ssd_unit}


# ---------------------------------------------------------------------------
# the aten rules
# ---------------------------------------------------------------------------

#: views, reshapes, allocations without a write, metadata
FREE = frozenset("""
view _unsafe_view reshape _reshape_alias expand permute transpose t squeeze
unsqueeze select slice narrow alias as_strided detach unbind split
split_with_sizes chunk diagonal view_as_real view_as_complex lift_fresh
empty empty_like empty_strided new_empty new_empty_strided
_local_scalar_dense unfold resolve_conj resolve_neg _conj conj set_
""".split())
#: dot-like ops: the operand whose last dim is contracted
DOTS = {"mm": 0, "bmm": 0, "mv": 0, "addmm": 1, "baddbmm": 1, "addmv": 1}
#: ops that copy a window out of their source
GATHERS = frozenset("index index_select gather embedding take "
                    "_unsafe_index".split())
#: in-place window updates: the index of their update operand
UPDATES = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
           "scatter_": 3, "scatter": 3, "scatter_add_": 3, "scatter_add": 3,
           "index_add_": 3, "index_add": 3, "index_copy_": 3,
           "slice_scatter": 1, "select_scatter": 1}
#: data movement without flops
MOVES = frozenset("""
clone _to_copy copy cat stack constant_pad_nd repeat flip roll
slice_backward select_backward _reshape_copy
""".split())
#: fills: write their result, read nothing
FILLS = frozenset("""
fill_ fill zero_ zeros ones full zeros_like ones_like full_like new_zeros
new_ones new_full scalar_tensor arange linspace normal_ uniform_
""".split())


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_cost(func, args: tuple, kwargs: dict, out) -> Tuple[int, int]:
    """(flops, bytes) of one dispatched aten op by the rules above."""
    name = func.overloadpacket.__name__
    if name in FREE:
        return 0, 0
    outs = _tensors(out)
    out_b = sum(_nbytes(t) for t in outs)
    if name in GATHERS:
        return 0, 2 * out_b
    if name == "copy_":
        return 0, _nbytes(args[0]) + _nbytes(args[1])
    if name in UPDATES:
        upd = args[UPDATES[name]] if len(args) > UPDATES[name] else None
        upd = upd if isinstance(upd, torch.Tensor) else None
        return 0, 2 * (_nbytes(upd) if upd is not None else out_b)
    if name in FILLS:
        return 0, out_b
    in_b = sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs))
    if name in MOVES:
        return 0, in_b + out_b
    if name in DOTS or name in ("dot", "vdot"):
        k = args[DOTS.get(name, 0)].shape[-1]
        return 2 * sum(t.numel() for t in outs) * k, in_b + out_b
    if name == "convolution":
        x, w = args[0], args[1]
        transposed = bool(args[6]) if len(args) > 6 else False
        per = int(np.prod(w.shape[1:]))
        return 2 * (x.numel() if transposed else outs[0].numel()) * per, \
            in_b + out_b
    if name == "convolution_backward":
        x, w = args[1], args[2]
        n_out = args[0].numel()
        per = int(np.prod(w.shape[1:]))
        mask = args[-1] if isinstance(args[-1], (list, tuple)) else (1, 1)
        grads = sum(bool(m) for m in mask[:2])
        return 2 * n_out * per * grads, in_b + out_b
    return sum(t.numel() for t in outs), in_b + out_b


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

class OpCounter(TorchDispatchMode):
    """Counts the flops and bytes of every aten op dispatched under it on
    ``device`` (by type; None: every op), each hand-kernel call as one unit
    (``kernel_call``), and the peak of the bytes held by ``hold``'s tensors
    and by every storage created under it.  ``cost()`` reads the counts."""

    def __init__(self, device=None):
        super().__init__()
        self.device_type = None if device is None else \
            torch.device(device).type
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernel_units: Dict[str, int] = {}
        self.by_op: Dict[str, List[int]] = {}
        self.free_copy_bytes = 0
        self._paused = 0
        #: the last counted op: name, its output's storage, flops, bytes
        self._last: Tuple[str, int, int, int] = ("", 0, 0, 0)
        #: live storages: key -> (bytes, weak reference)
        self._live: Dict[int, Tuple[int, weakref.ref]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.held_bytes = 0

    # ---- memory -----------------------------------------------------------
    def _free(self, key: int) -> None:
        nbytes, _ = self._live.pop(key, (0, None))
        self.live_bytes -= nbytes

    def _hold_storage(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live; returns its bytes if it is new."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        nbytes = st.nbytes()
        self._live[key] = (nbytes, weakref.ref(
            st, lambda _, key=key: self._free(key)))
        self.live_bytes += nbytes
        if not self._paused:
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return nbytes

    def hold(self, *trees) -> None:
        """Count the storages of ``trees``' tensors (modules: parameters
        and buffers; dicts, lists, tuples) as held from now on."""
        for t in leaf_tensors(trees):
            self.held_bytes += self._hold_storage(t)

    # ---- dispatch ---------------------------------------------------------
    def _on_device(self, tensors: List[torch.Tensor]) -> bool:
        return self.device_type is None or any(
            t.device.type == self.device_type for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        if not self._paused and self._on_device(ins + outs):
            f, b = op_cost(func, args, kwargs, out)
            name = by = func.overloadpacket.__name__
            last, last_key, last_f, last_b = self._last
            if name == "_unsafe_view" and last == "clone" \
                    and last_key in in_keys:
                f, b = -last_f, -last_b      # a copying reshape is free
                self.ops -= 1             # counted as the one view
                self.free_copy_bytes += last_b
                by = "clone"
            self._add(by, f, b)
            self.ops += 1
            self._last = (name, outs[0].untyped_storage()._cdata
                          if outs else 0, f, b)
        for t in outs:                   # new storages, not views/in-place
            if t.untyped_storage()._cdata not in in_keys:
                self._hold_storage(t)
        return out

    @contextlib.contextmanager
    def kernel_call(self, name: str, *args, **params) -> Iterator[None]:
        """One call of hand kernel ``name``: the ops inside are not
        counted; the call adds ``KERNEL_UNITS[name]``'s flops and bytes.
        What the call leaves allocated (its outputs) joins the peak; what
        it frees before returning (the CPU plain version's temporaries)
        does not."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1
        if not self._paused:
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._add(name, *KERNEL_UNITS[name](*args, **params))
            self.kernel_units[name] = self.kernel_units.get(name, 0) + 1

    def _add(self, name: str, flops: int, nbytes: int) -> None:
        if not (flops or nbytes):
            return
        self.flops += flops
        self.bytes += nbytes
        by = self.by_op.setdefault(name, [0, 0])
        by[0] += flops
        by[1] += nbytes

    def cost(self) -> CompCost:
        return CompCost(flops=self.flops, bytes=self.bytes,
                        peak_bytes=self.peak_bytes,
                        kernel_units=dict(self.kernel_units), ops=self.ops,
                        held_bytes=self.held_bytes,
                        by_op={k: list(v) for k, v in self.by_op.items()},
                        free_copy_bytes=self.free_copy_bytes)


def leaf_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of arguments or results: modules' parameters
    and buffers, dicts, lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaf_tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaf_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages behind ``tree``'s tensors."""
    sts = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
           for t in leaf_tensors(tree)}
    return sum(sts.values())


def analyze_step(fn: Callable, *args: Any, **kwargs: Any) -> CompCost:
    """Run ``fn(*args, **kwargs)`` once under an ``OpCounter`` on the
    device of its first tensor argument, the arguments held from the
    start; returns the counts."""
    held = leaf_tensors((args, kwargs))
    with OpCounter(held[0].device if held else None) as counter:
        counter.hold(args, kwargs)
        fn(*args, **kwargs)
    return counter.cost()


__all__ = ["CompCost", "KERNEL_UNITS", "OpCounter", "analyze_step",
           "attention_pairs", "flash_bytes", "flash_ops", "leaf_tensors",
           "op_cost", "ssd_bytes", "ssd_ops", "storage_bytes"]
