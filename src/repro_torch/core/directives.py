"""Tensor-centric dataflow directives (KAPLA §III-B).

Three directives describe a scheme, inside-out along the memory hierarchy:

  tensor(dim=size, ..., shr)   -- a (sub)tensor allocated in a buffer
  stack(dim+=shift, ..., repl) -- spatial replication/sharding across buffers
  update(dim+=step, ...)       -- ordered temporal iteration in a buffer

The pragmatic payoff is that buffer footprints, spatial parallelism and
inter-level access counts are all direct functions of the directives — no
recursive nested-loop analysis.  The solver works on a compact equivalent
(`LevelBlocking`: per-level temporal factors + order, spatial factors, and
per-tensor sharing factors) that compiles to directives via
``LayerScheme.to_directives()``.

Approximations (documented; trends preserved, as in analytical models like
nn-dataflow/Interstellar):
  * halo of sliding-window inputs folded into a per-tensor ``unit`` multiplier;
  * filter dims R,S pinned at the PE/unit level;
  * a tensor tile is refetched whenever any loop relevant to it, at any outer
    position, advances (single-resident-tile model);
  * partial sums: output traffic doubles for revisits driven by reduction
    loops placed outside the output's residency level.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

from ..workloads.layers import DIMS, LayerSpec

# ---------------------------------------------------------------------------
# Formal directive objects (representation layer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorDecl:
    name: str
    dims: Mapping[str, float]      # dim -> size at this level (may be halo'd)
    shr: int = 1

    def size(self) -> float:
        sz = 1.0
        for v in self.dims.values():
            sz *= v
        return sz / self.shr

    def __str__(self) -> str:
        body = ", ".join(f"{d}={int(math.ceil(v))}" for d, v in self.dims.items())
        if self.shr > 1:
            body += f", shr={self.shr}"
        return f"tensor{{{self.name}}}({body})"


@dataclasses.dataclass(frozen=True)
class Stack:
    shifts: Mapping[str, int]      # dim -> shift (empty = pure replication)
    repl: int

    def __str__(self) -> str:
        parts = [f"{d}+={s}" for d, s in self.shifts.items()]
        parts.append(str(self.repl))
        return f"stack({', '.join(parts)})"


@dataclasses.dataclass(frozen=True)
class Update:
    steps: Mapping[str, int]

    def __str__(self) -> str:
        return f"update({', '.join(f'{d}+={s}' for d, s in self.steps.items())})"


@dataclasses.dataclass(frozen=True)
class LevelDirectives:
    level_name: str
    tensors: Tuple[TensorDecl, ...]
    stacks: Tuple[Stack, ...]
    updates: Tuple[Update, ...]    # outer iteration order: listed inner->outer

    def __str__(self) -> str:
        lines = [f"{self.level_name}:"]
        lines += [f"  {t}" for t in self.tensors]
        lines += [f"  {s}" for s in self.stacks]
        lines += [f"  {u}" for u in self.updates]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Solver-side compact scheme
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LevelBlocking:
    """Blocking of one memory level.

    t:     temporal blocking factor per dim at this level's buffer.
    s:     spatial unrolling factor per dim across this level's unit array
           (PE array for level 0, node array for level 1, ...).
    order: temporal loop order at this level, outer -> inner (dims with
           t[d] > 1 participate; others are ignored).
    shr:   per-tensor sharing factor (buffer sharing / systolic) — each of the
           ``shr`` sibling buffers holds 1/shr of the tensor's tile.
    """

    t: Dict[str, int] = dataclasses.field(default_factory=dict)
    s: Dict[str, int] = dataclasses.field(default_factory=dict)
    order: Tuple[str, ...] = ("N", "X", "Y", "K", "C")
    shr: Dict[str, int] = dataclasses.field(default_factory=dict)

    def tf(self, d: str) -> int:
        return int(self.t.get(d, 1))

    def sf(self, d: str) -> int:
        return int(self.s.get(d, 1))

    def t_product(self) -> int:
        p = 1
        for v in self.t.values():
            p *= int(v)
        return p

    def s_product(self) -> int:
        p = 1
        for v in self.s.values():
            p *= int(v)
        return p

    def copy(self) -> "LevelBlocking":
        return LevelBlocking(dict(self.t), dict(self.s), tuple(self.order),
                             dict(self.shr))

    def to_json_dict(self) -> Dict:
        return {"t": dict(self.t), "s": dict(self.s),
                "order": list(self.order), "shr": dict(self.shr)}

    @staticmethod
    def from_json_dict(d: Mapping) -> "LevelBlocking":
        return LevelBlocking(
            t={k: int(v) for k, v in d.get("t", {}).items()},
            s={k: int(v) for k, v in d.get("s", {}).items()},
            order=tuple(d.get("order", LevelBlocking().order)),
            shr={k: int(v) for k, v in d.get("shr", {}).items()})


@dataclasses.dataclass
class LayerScheme:
    """A complete intra-layer scheme: one LevelBlocking per memory level,
    inner -> outer.  The outermost level's t factors are implied leftovers
    (kept explicit for clarity and checked by `validate_factors`)."""

    layer: LayerSpec
    levels: List[LevelBlocking]

    # -- factor bookkeeping ---------------------------------------------------
    def cum_factor(self, d: str, upto: int, include_own_t: bool = True) -> int:
        """Product of t and s factors of dim ``d`` for levels <= upto."""
        p = 1
        for i, lv in enumerate(self.levels[: upto + 1]):
            if i < upto or include_own_t:
                p *= lv.tf(d)
            if i <= upto:
                p *= lv.sf(d)
        return p

    def allocated(self, d: str) -> int:
        p = 1
        for lv in self.levels:
            p *= lv.tf(d) * lv.sf(d)
        return p

    def validate_factors(self) -> bool:
        return all(self.allocated(d) == self.layer.dim(d) for d in DIMS)

    # -- footprints -----------------------------------------------------------
    def tile_elems(self, tname: str, level: int) -> float:
        """Per-buffer element count of tensor ``tname`` at ``level``
        (includes this level's temporal factors, excludes its spatial ones,
        divided by the sharing factor)."""
        rel = self.layer.tensors[tname]
        sz = self.layer.inner_unit(tname) if level == 0 \
            else self.layer.unit.get(tname, 1.0)
        for d in rel:
            sz *= self.cum_factor(d, level, include_own_t=True)
            # own-level spatial factors shard across sibling buffers:
            sz /= self.levels[level].sf(d) if d in rel else 1
        sz /= max(1, self.levels[level].shr.get(tname, 1))
        return sz

    def level_footprint_bytes(self, level: int) -> float:
        return sum(self.tile_elems(t, level) for t in self.layer.tensors) \
            * self.layer.bytes_per_elem

    def parallelism(self, level: int) -> int:
        return self.levels[level].s_product()

    # -- access counting ------------------------------------------------------
    def _outer_nest(self, level: int) -> List[Tuple[str, int]]:
        """Concatenated temporal loops of all levels outer than ``level``,
        ordered outermost first."""
        nest: List[Tuple[str, int]] = []
        for i in range(len(self.levels) - 1, level, -1):
            lv = self.levels[i]
            for d in lv.order:
                if lv.tf(d) > 1:
                    nest.append((d, lv.tf(d)))
        return nest

    @staticmethod
    def _iters_to_innermost_relevant(nest: Sequence[Tuple[str, int]],
                                     rel: FrozenSet[str]) -> int:
        """Product of loop factors from the outermost loop down to (and
        including) the innermost loop whose dim is in ``rel``."""
        total = 1
        for _, f in nest:
            total *= f
        trailing = 1
        for d, f in reversed(nest):
            if d in rel:
                break
            trailing *= f
        return total // trailing

    def fetches_into(self, tname: str, level: int) -> float:
        """Elements moved from level+1 into the level-``level`` buffers under
        ONE level-(level+1) buffer, counting multicast replicas once.

        For the output tensor, reduction loops outside this level force
        partial-sum read+write revisits (2x traffic on revisits)."""
        layer = self.layer
        rel = layer.tensors[tname]
        nest = self._outer_nest(level)
        tile = self.tile_elems(tname, level)
        shards = 1
        for d in rel:
            shards *= self.levels[level].sf(d)
        rounds = self._iters_to_innermost_relevant(nest, rel)
        base = tile * shards * rounds
        if tname == "O" and layer.reduction_dims:
            rw_rel = rel | layer.reduction_dims
            rounds_rw = self._iters_to_innermost_relevant(nest, rw_rel)
            if rounds_rw > rounds:
                # each extra revisit reads + writes the partial-sum tile
                base = tile * shards * (2 * rounds_rw - rounds)
        return base

    def replication(self, tname: str, level: int) -> int:
        """How many copies of each element live across this level's array."""
        rel = self.layer.tensors[tname]
        r = 1
        for d, f in self.levels[level].s.items():
            if d not in rel:
                r *= f
        return r

    # -- compilation to formal directives -------------------------------------
    def to_directives(self, level_names: Sequence[str]) -> List[LevelDirectives]:
        out: List[LevelDirectives] = []
        for i, lv in enumerate(self.levels):
            tds = []
            for tname, rel in self.layer.tensors.items():
                dims = {}
                for d in sorted(rel):
                    dims[d] = (self.cum_factor(d, i) / lv.sf(d)) \
                        * self.layer.unit.get(tname, 1.0) ** (1 / max(1, len(rel)))
                tds.append(TensorDecl(tname, dims, shr=lv.shr.get(tname, 1)))
            stacks = []
            for d, f in lv.s.items():
                if f > 1:
                    shift = self.cum_factor(d, i) // lv.sf(d)
                    stacks.append(Stack({d: shift}, f))
            updates = []
            for d in reversed(lv.order):     # inner -> outer
                if lv.tf(d) > 1:
                    step = self.cum_factor(d, i - 1) if i > 0 else 1
                    updates.append(Update({d: step}))
            out.append(LevelDirectives(level_names[i], tuple(tds),
                                       tuple(stacks), tuple(updates)))
        return out

    # -- factor-table export --------------------------------------------------
    def factor_rows(self, dims: Sequence[str], tensor_names: Sequence[str],
                    order_packer) -> Tuple[List[List[int]], List[List[int]],
                                           List[List[int]], List[List[bool]],
                                           List[List[int]]]:
        """Flatten this scheme into per-level integer rows for batched
        scoring: (t, s, order indices, order mask, shr) — one row per level.
        ``order_packer`` maps a loop-order tuple to (dim indices, mask) of
        length ``len(dims)`` (see ``cost_batch.pack_order``)."""
        t_rows, s_rows, o_rows, m_rows, shr_rows = [], [], [], [], []
        for lv in self.levels:
            t_rows.append([lv.tf(d) for d in dims])
            s_rows.append([lv.sf(d) for d in dims])
            idx, mask = order_packer(lv.order)
            o_rows.append(list(idx))
            m_rows.append(list(mask))
            shr_rows.append([int(lv.shr.get(t, 1)) for t in tensor_names])
        return t_rows, s_rows, o_rows, m_rows, shr_rows

    # -- JSON (de)serialization ----------------------------------------------
    def to_json(self) -> Dict:
        """Stable serializable form: the layer spec plus one blocking dict
        per level (inner -> outer).  Round-trips via ``from_json`` with
        bit-identical cost-model scores (see tests/test_lowering.py)."""
        return {"layer": self.layer.to_json_dict(),
                "levels": [lv.to_json_dict() for lv in self.levels]}

    @staticmethod
    def from_json(d: Mapping, layer: Optional[LayerSpec] = None
                  ) -> "LayerScheme":
        """Rebuild a scheme; pass ``layer`` to re-bind to an existing graph's
        spec instead of reconstructing one from the embedded JSON."""
        lay = layer if layer is not None \
            else LayerSpec.from_json_dict(d["layer"])
        return LayerScheme(lay, [LevelBlocking.from_json_dict(lv)
                                 for lv in d["levels"]])

    def top_level_granularity(self) -> Dict[str, int]:
        """Tile sizes of the output tensor at the outermost on-chip level —
        used to check inter-layer forwarding compatibility (matched tensor
        sizes + matched update steps)."""
        top = len(self.levels) - 2           # outermost on-chip level
        rel = self.layer.tensors["O"]
        return {d: self.cum_factor(d, top) for d in sorted(rel)}

    def forward_bytes(self, granule_frac: float = 1.0) -> float:
        """Bytes of the output-fmap granule a pipelined consumer receives
        on-chip (§III-A fine-grained forwarding): the per-segment footprint
        accounting hook the network lowering tier validates against the
        segment's node-region alloc share.  Callers apply their own
        double-buffering factor (cf. ``estimate.min_buffer_requirement_bytes``)."""
        return self.layer.ofmap_size() * granule_frac \
            * self.layer.bytes_per_elem


# ---------------------------------------------------------------------------
# small utilities shared by solvers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _divisors_cached(n: int) -> Tuple[int, ...]:
    out = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            out.append(i)
            if i != n // i:
                out.append(n // i)
        i += 1
    return tuple(sorted(out))


def divisors(n: int) -> List[int]:
    """Sorted divisors of ``n`` (memoized; a fresh list is returned so
    callers may mutate it)."""
    return list(_divisors_cached(n))


@functools.lru_cache(maxsize=None)
def smallest_prime_factor(n: int) -> int:
    if n <= 1:
        return 1
    i = 2
    while i * i <= n:
        if n % i == 0:
            return i
        i += 1
    return n


@functools.lru_cache(maxsize=1)
def _canonical_orders_cached() -> Tuple[Tuple[str, ...], ...]:
    orders = []
    for perm in itertools.permutations(("C", "K", "N")):
        order: List[str] = []
        for p in perm:
            if p == "N":
                order.extend(("N", "X", "Y"))
            else:
                order.append(p)
        orders.append(tuple(order))
    return tuple(orders)


def canonical_orders() -> List[Tuple[str, ...]]:
    """Loop orders that matter: permutations of which tensor class is
    outermost; X, Y travel with N (fmap dims)."""
    return list(_canonical_orders_cached())
