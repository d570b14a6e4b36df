"""Intra-layer bottom-up greedy cost descending (KAPLA §IV-C, Algorithm 1).

Work through the memory hierarchy inner -> outer.  At each level, run a
*stacking* pass (spatial — parallelize tensors across the level's unit array)
then a *caching* pass (temporal — enlarge the per-buffer tensors), each time
greedily choosing a dimension that helps the currently most-accessed tensor,
tie-broken by the second most accessed.  Dimensions grow one smallest prime
step at a time ("next smallest blocked size"), so buffer-capacity validity
holds *by construction* — no top-down factorization retries.

Loop orders and same-level-sharing toggles are enumerated at the end and
scored with the detailed cost model.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ...hw.template import HWTemplate
from ...workloads.layers import DIMS, LayerSpec
from ..cost_batch import score_schemes
from ..cost_model import CostBreakdown, evaluate_layer, invalid
from ..directives import (LayerScheme, LevelBlocking, canonical_orders,
                          smallest_prime_factor)
from .memo import intra_cache, solve_key


@dataclasses.dataclass
class Constraints:
    """Constraints imposed by the chosen inter-layer scheme."""

    nodes: Tuple[int, int] = (16, 16)      # node region assigned to the layer
    src_onchip: bool = False
    dst_onchip: bool = False
    # pipelined producers must finish accumulation on-chip so granules can be
    # forwarded as soon as produced (matched access patterns, §III-A):
    full_reduction_onchip: bool = False
    # forwarding granularity: the outermost DRAM loop must be over these dims
    outer_dims: Tuple[str, ...] = ()

    @property
    def num_nodes(self) -> int:
        return self.nodes[0] * self.nodes[1]


def _pe_axis_dims(hw: HWTemplate) -> Tuple[Sequence[str], Sequence[str]]:
    """Dims allowed on each PE-array axis per the hardware's PE dataflow."""
    if hw.pe_dataflow == "systolic":
        return ("C",), ("K", "N")          # weight-stationary MXU-style
    # row-stationary: cols <- fmap rows (Y), rows <- filter rows folded with
    # channels/filters (K, C); X slides within the PE.
    return ("K", "C"), ("Y", "X", "N")


def _helps(layer: LayerSpec, tname: str) -> List[str]:
    """Dims whose blocking at this level reduces ``tname``'s outer traffic
    (dims NOT indexing the tensor; reduction dims for the output)."""
    rel = set(layer.tensors[tname])
    if tname == "O":
        # partial-sum revisit traffic is driven by the reduction loops:
        # keeping them inside the output's residency level is what helps
        return [d for d in layer.reduction_dims if layer.dim(d) > 1]
    return [d for d in DIMS if d not in rel and layer.dim(d) > 1]


class _State:
    """Mutable solver state: factors allocated so far, per dim."""

    def __init__(self, layer: LayerSpec, n_levels: int):
        self.layer = layer
        self.levels = [LevelBlocking() for _ in range(n_levels)]
        self.scheme = LayerScheme(layer, self.levels)

    def remaining(self, d: str) -> int:
        return self.layer.dim(d) // self.scheme.allocated(d)

    def traffic_metric(self, tname: str) -> float:
        """Optimistic outer traffic for a tensor: total size x refetch factor
        from still-unallocated irrelevant dims."""
        m = self.layer.tensor_size(tname)
        rel = self.layer.tensors[tname]
        for d in DIMS:
            if d not in rel:
                m *= self.remaining(d)
        if tname == "O":
            m *= 1.5 if any(self.remaining(d) > 1
                            for d in self.layer.reduction_dims) else 1.0
        return m

    def ranked_tensors(self) -> List[str]:
        return sorted(self.layer.tensors,
                      key=lambda t: -self.traffic_metric(t))

    def finalize_leftovers(self) -> None:
        """Assign all remaining factors to the outermost level temporally."""
        top = self.levels[-1]
        for d in DIMS:
            r = self.remaining(d)
            if r > 1:
                top.t[d] = top.tf(d) * r


def _stacking_pass(st: _State, level: int, hw: HWTemplate,
                   axis_budgets: List[int],
                   allowed_axis_dims: Tuple[Sequence[str], Sequence[str]],
                   ) -> None:
    """Spatially unroll dims across this level's unit array (greedy)."""
    lv = st.levels[level]
    while True:
        grew = False
        for tname in st.ranked_tensors():
            cands = [d for d in _helps(st.layer, tname) if st.remaining(d) > 1]
            # fallback: pure sharding still buys parallelism
            if not cands:
                cands = [d for d in DIMS if st.remaining(d) > 1]
            for d in cands:
                p = smallest_prime_factor(st.remaining(d))
                for ax in (0, 1):
                    if d not in allowed_axis_dims[ax] or axis_budgets[ax] < p:
                        continue
                    lv.s[d] = lv.sf(d) * p
                    axis_budgets[ax] //= p
                    grew = True
                    break
                if grew:
                    break
            if grew:
                break
        if not grew:
            return


def _caching_pass(st: _State, level: int, hw: HWTemplate,
                  first_dims: Sequence[str] = ()) -> None:
    """Temporally enlarge per-buffer tensors until capacity is used up.

    ``first_dims`` are exhausted first (used to keep reduction dims fully
    on-chip for pipelined producers)."""
    lv = st.levels[level]
    cap = hw.levels[level].capacity_bytes
    blocked: set = set()
    for d in first_dims:
        while st.remaining(d) > 1 and (level, d) not in blocked:
            p = smallest_prime_factor(st.remaining(d))
            lv.t[d] = lv.tf(d) * p
            if st.scheme.level_footprint_bytes(level) > cap:
                lv.t[d] //= p
                blocked.add((level, d))
    while True:
        grew = False
        for tname in st.ranked_tensors():
            cands = [d for d in _helps(st.layer, tname)
                     if st.remaining(d) > 1 and (level, d) not in blocked]
            if not cands:
                cands = [d for d in DIMS
                         if st.remaining(d) > 1 and (level, d) not in blocked]
            for d in cands:
                p = smallest_prime_factor(st.remaining(d))
                lv.t[d] = lv.tf(d) * p
                if st.scheme.level_footprint_bytes(level) > cap:
                    lv.t[d] //= p          # revert, mark dim done here
                    blocked.add((level, d))
                    continue
                grew = True
                break
            if grew:
                break
        if not grew:
            return


def _order_candidates(constr: Constraints) -> List[Tuple[str, ...]]:
    orders = canonical_orders()
    if constr.outer_dims:
        orders = [o for o in orders
                  if o[: len(constr.outer_dims)] == tuple(constr.outer_dims)] \
            or orders
    return orders


def solve_intra_layer(layer: LayerSpec, hw: HWTemplate,
                      constr: Optional[Constraints] = None,
                      use_cache: bool = True,
                      ) -> Tuple[Optional[LayerScheme], CostBreakdown]:
    """Algorithm 1: returns (best scheme, its detailed cost).

    Results are memoized on the canonical layer signature + hardware
    fingerprint + constraints (``use_cache=False`` forces a cold solve)."""
    constr = constr or Constraints(nodes=hw.node_array)
    key = solve_key(layer, hw, constr)
    if use_cache:
        hit = intra_cache.get(key, layer)
        if hit is not None:
            return hit
    n_levels = len(hw.levels)
    st = _State(layer, n_levels)

    # Level 0 (REGF): spatial mapping constrained by the PE dataflow template.
    pe_axes = _pe_axis_dims(hw)
    _stacking_pass(st, 0, hw, list(hw.pe_array), pe_axes)
    _caching_pass(st, 0, hw)

    # Level 1 (GBUF): free node parallelization within the assigned region.
    if n_levels >= 3:
        all_dims = tuple(d for d in DIMS)
        _stacking_pass(st, 1, hw, list(constr.nodes), (all_dims, all_dims))
        first = tuple(layer.reduction_dims) if constr.full_reduction_onchip \
            else ()
        _caching_pass(st, 1, hw, first_dims=first)

    st.finalize_leftovers()
    if constr.full_reduction_onchip:
        top = st.levels[-1]
        for d in layer.reduction_dims:
            if top.tf(d) > 1:   # pull reduction leftovers into GBUF caching
                st.levels[-2].t[d] = st.levels[-2].tf(d) * top.tf(d)
                top.t[d] = 1
        cap = hw.levels[-2].capacity_bytes
        if st.scheme.level_footprint_bytes(n_levels - 2) > cap:
            bad = invalid("cannot keep reduction on-chip")
            if use_cache:
                intra_cache.put(key, None, bad)
            return None, bad

    # ---- enumerate loop orders (GBUF x DRAM) and sharing toggles ------------
    # The whole order x order x shr cross product is scored as ONE batch with
    # the vectorized cost model; candidates share the greedy factors and only
    # vary in order/shr, so they are packed without per-candidate dict copies.
    orders_top = _order_candidates(constr)
    orders_mid = canonical_orders()
    shr_opts: List[Dict[str, int]] = [{}]
    if hw.levels[-1].same_level_transfer and n_levels >= 3:
        for tname in layer.tensors:
            repl = st.scheme.replication(tname, 1)
            if repl > 1:
                shr_opts.append({tname: repl})
    variants = list(itertools.product(orders_top, orders_mid, shr_opts))

    def materialize(o_top, o_mid, shr) -> LayerScheme:
        cand_levels = [lv.copy() for lv in st.levels]
        cand_levels[-1].order = o_top
        cand_levels[1].order = o_mid
        cand_levels[1].shr = dict(shr)
        return LayerScheme(layer, cand_levels)

    best: Tuple[Optional[LayerScheme], CostBreakdown] = (None, invalid("none"))
    if n_levels >= 3:
        # zero-copy candidate views: levels share the greedy factor dicts,
        # only order/shr differ; evaluation never mutates them
        cands = [LayerScheme(layer, [
            st.levels[0],
            LevelBlocking(t=st.levels[1].t, s=st.levels[1].s,
                          order=o_mid, shr=dict(shr)),
            *st.levels[2:-1],
            LevelBlocking(t=st.levels[-1].t, s=st.levels[-1].s,
                          order=o_top)])
            for o_top, o_mid, shr in variants]
        res = score_schemes(cands, hw, nodes_assigned=constr.num_nodes,
                            src_onchip=constr.src_onchip,
                            dst_onchip=constr.dst_onchip)
        bi = res.best("energy")
        if bi >= 0:
            best = (materialize(*variants[bi]), res.breakdown(bi))
    else:
        for o_top, o_mid, shr in variants:
            cand = materialize(o_top, o_mid, shr)
            cost = evaluate_layer(cand, hw, nodes_assigned=constr.num_nodes,
                                  src_onchip=constr.src_onchip,
                                  dst_onchip=constr.dst_onchip)
            if cost.valid and cost.energy_pj < best[1].energy_pj:
                best = (cand, cost)
    if use_cache:
        intra_cache.put(key, best[0], best[1])
    return best
