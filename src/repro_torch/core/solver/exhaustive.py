"""Baseline S: exhaustive search over the directive scheme space (§V).

Enumerates, per layer: node-parallel spatial splits, per-level temporal
factorizations (divisor ladders), loop orders and sharing toggles.  The
enumeration is *batched*: temporal combos are generated directly as flat
factor tables (mixed-radix index decoding, no per-candidate ``LayerScheme``
or dict copies), capacity-pruned in-array, expanded with the order/sharing
variants, and scored with the vectorized cost model in large chunks.
A ``budget`` caps the enumeration for very large layers (reported when hit);
within budget the search is exhaustive over the same space KAPLA navigates.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ...hw.template import HWTemplate
from ...workloads.layers import DIMS, LayerGraph, LayerSpec
from ..cost_batch import FactorTable, evaluate_batch, pack_order
from ..cost_model import CostBreakdown, combine_segment, evaluate_layer, invalid
from ..directives import (LayerScheme, LevelBlocking, canonical_orders,
                          divisors)
from .interlayer import io_flags, _consumer_map
from .intralayer import Constraints, _pe_axis_dims, solve_intra_layer
from .memo import exhaustive_cache, solve_key

# expanded (temporal-combo x order/shr-variant) lanes scored per numpy call
_MAX_LANES = 65536


def _axis_splits(total: int, budget: int) -> List[int]:
    """Divisors of ``total`` that fit within a spatial axis ``budget``."""
    return [f for f in divisors(total) if f <= budget]


def _spatial_blocks(layer: LayerSpec, hw: HWTemplate, constr: Constraints,
                    ) -> Tuple[List[Dict[str, int]], List[Dict[str, int]]]:
    """PE-level and node-level spatial unrolling options, seeded with
    KAPLA's own stacking point so the exhaustive space is a superset of what
    the fast solver reaches (the directive space is shared; only the walk
    differs)."""
    pe_axes = _pe_axis_dims(hw)
    pe_opts: List[Dict[str, int]] = []
    for d0 in list(pe_axes[0]) + [None]:
        for d1 in list(pe_axes[1]) + [None]:
            if d0 == d1:
                continue
            for f0 in (_axis_splits(layer.dim(d0), hw.pe_array[0])
                       if d0 else [1]):
                for f1 in (_axis_splits(layer.dim(d1), hw.pe_array[1])
                           if d1 else [1]):
                    s = {}
                    if d0 and f0 > 1:
                        s[d0] = f0
                    if d1 and f1 > 1:
                        s[d1] = f1
                    pe_opts.append(s)
    node_opts: List[Dict[str, int]] = [{}]
    H, W = constr.nodes
    for d0, d1 in itertools.permutations(DIMS, 2):
        for f0 in _axis_splits(layer.dim(d0), H):
            for f1 in _axis_splits(layer.dim(d1), W):
                if f0 * f1 > 1:
                    node_opts.append({k: v for k, v in
                                      ((d0, f0), (d1, f1)) if v > 1})
    seen_nodes = set()
    node_uniq = []
    for o in node_opts:
        key = tuple(sorted(o.items()))
        if key not in seen_nodes:
            seen_nodes.add(key)
            node_uniq.append(o)

    seed, _ = solve_intra_layer(layer, hw, constr)
    if seed is not None:
        pe_opts.insert(0, {d: f for d, f in seed.levels[0].s.items() if f > 1})
        node_uniq.insert(0,
                         {d: f for d, f in seed.levels[1].s.items() if f > 1})
    return pe_opts, node_uniq


def _order_shr_variants(layer: LayerSpec, hw: HWTemplate,
                        constr: Constraints, node_s: Dict[str, int],
                        ) -> List[Tuple[Tuple[str, ...], Tuple[str, ...],
                                        Dict[str, int]]]:
    """(o_mid, o_top, shr) cross product for one node-spatial block, in the
    same iteration order as the historical scalar enumeration."""
    orders = canonical_orders()
    shr_opts: List[Dict[str, int]] = [{}]
    if hw.levels[-1].same_level_transfer:
        for tname, rel in layer.tensors.items():
            repl = 1
            for d, f in node_s.items():
                if d not in rel:
                    repl *= f
            if repl > 1:
                shr_opts.append({tname: repl})
    out = []
    for o_mid, o_top, shr in itertools.product(orders, orders, shr_opts):
        if constr.outer_dims and \
                o_top[: len(constr.outer_dims)] != tuple(constr.outer_dims):
            continue
        out.append((o_mid, o_top, shr))
    return out


def _footprint_mask(layer: LayerSpec, hw: HWTemplate, t: np.ndarray,
                    s_col: np.ndarray) -> np.ndarray:
    """Early capacity pruning at REGF and GBUF, vectorized over the combo
    axis (shr = 1 at this stage, mirroring the scalar enumeration which
    pruned before applying sharing toggles)."""
    cum = np.cumprod(t * s_col[:, :, None], axis=0)       # [L, ND, C]
    ratio = cum / s_col[:, :, None]
    mask = np.ones(t.shape[-1], dtype=bool)
    for level in (0, 1):
        fp = np.zeros(t.shape[-1])
        for tname, rel in layer.tensors.items():
            relvec = np.array([d in rel for d in DIMS])
            tl = np.prod(np.where(relvec[:, None], ratio[level], 1.0), axis=0)
            unit = layer.inner_unit(tname) if level == 0 \
                else layer.unit.get(tname, 1.0)
            fp += tl * unit
        mask &= fp * layer.bytes_per_elem <= hw.levels[level].capacity_bytes
    return mask


def iter_scheme_tables(layer: LayerSpec, hw: HWTemplate,
                       constr: Constraints,
                       budget: int = 50000) -> Iterator[FactorTable]:
    """Yield capacity-pruned candidate batches as factor tables.

    Covers the same candidate space as the historical per-scheme generator:
    each yielded table is (surviving temporal combos) x (order/shr variants)
    for one spatial block, combo-major / variant-minor."""
    n_levels = len(hw.levels)
    if n_levels < 3:
        raise ValueError("exhaustive table enumeration needs >= 3 levels")
    pe_opts, node_uniq = _spatial_blocks(layer, hw, constr)
    remaining = budget
    for pe_s in pe_opts:
        for node_s in node_uniq:
            if remaining <= 0:
                return
            leftover = {}
            for d in DIMS:
                tot = layer.dim(d)
                tot //= pe_s.get(d, 1) * node_s.get(d, 1)
                leftover[d] = tot
            # per-dim (t0, t1, t2) options as arrays
            opts: List[np.ndarray] = []
            for d in DIMS:
                o = [(t0, t1, leftover[d] // t0 // t1)
                     for t0 in divisors(leftover[d])
                     for t1 in divisors(leftover[d] // t0)]
                opts.append(np.asarray(o, dtype=np.int64))
            radix = [len(o) for o in opts]
            n_combos = int(np.prod(radix))
            take = min(n_combos, remaining)
            remaining -= take

            variants = _order_shr_variants(layer, hw, constr, node_s)
            if not variants:
                continue
            V = len(variants)
            # pre-pack the per-variant order/shr columns [levels, ., V]
            tnames = list(layer.tensors)
            var_order = np.empty((n_levels, len(DIMS), V), dtype=np.int8)
            var_omask = np.empty((n_levels, len(DIMS), V), dtype=bool)
            d_idx, d_mask = pack_order(LevelBlocking().order)
            var_order[:] = np.asarray(d_idx, dtype=np.int8)[None, :, None]
            var_omask[:] = np.asarray(d_mask)[None, :, None]
            var_shr = np.ones((n_levels, len(tnames), V), dtype=np.int64)
            for v, (o_mid, o_top, shr) in enumerate(variants):
                for lvl, o in ((1, o_mid), (n_levels - 1, o_top)):
                    idx, msk = pack_order(o)
                    var_order[lvl, :, v] = idx
                    var_omask[lvl, :, v] = msk
                for tname, f in shr.items():
                    var_shr[1, tnames.index(tname), v] = f

            s_col = np.ones((n_levels, len(DIMS)), dtype=np.int64)
            for d, f in pe_s.items():
                s_col[0, DIMS.index(d)] = f
            for d, f in node_s.items():
                s_col[1, DIMS.index(d)] = f

            chunk = max(1, _MAX_LANES // max(1, V))
            strides = np.ones(len(DIMS), dtype=np.int64)
            for i in range(len(DIMS) - 2, -1, -1):
                strides[i] = strides[i + 1] * radix[i + 1]
            done = 0
            while done < take:
                c = min(chunk, take - done)
                lin = np.arange(done, done + c, dtype=np.int64)
                done += c
                t = np.ones((n_levels, len(DIMS), c), dtype=np.int64)
                for di in range(len(DIMS)):
                    digits = (lin // strides[di]) % radix[di]
                    picked = opts[di][digits]            # [c, 3]
                    t[0, di] = picked[:, 0]
                    t[1, di] = picked[:, 1]
                    t[2, di] = picked[:, 2]
                keep = _footprint_mask(layer, hw, t, s_col)
                S = int(keep.sum())
                if S == 0:
                    continue
                t = t[:, :, keep]
                # expand combos x variants, combo-major
                B = S * V
                ft = FactorTable(
                    layer,
                    t=np.repeat(t, V, axis=2),
                    s=np.repeat(s_col[:, :, None], B, axis=2),
                    order=np.tile(var_order, (1, 1, S)),
                    omask=np.tile(var_omask, (1, 1, S)),
                    shr=np.tile(var_shr, (1, 1, S)))
                yield ft


def enumerate_intra_schemes(layer: LayerSpec, hw: HWTemplate,
                            constr: Constraints,
                            budget: int = 50000) -> Iterator[LayerScheme]:
    """Compatibility wrapper: materialize each table lane as a
    ``LayerScheme`` (prefer ``iter_scheme_tables`` + ``evaluate_batch``)."""
    for ft in iter_scheme_tables(layer, hw, constr, budget):
        for b in range(ft.batch):
            yield ft.scheme_at(b)


def solve_layer_exhaustive(layer: LayerSpec, hw: HWTemplate,
                           constr: Optional[Constraints] = None,
                           budget: int = 50000, use_cache: bool = True,
                           ) -> Tuple[Optional[LayerScheme], CostBreakdown]:
    constr = constr or Constraints(nodes=hw.node_array)
    key = solve_key(layer, hw, constr, extra=("budget", budget))
    if use_cache:
        hit = exhaustive_cache.get(key, layer)
        if hit is not None:
            return hit
    best: Tuple[Optional[LayerScheme], CostBreakdown] = (None, invalid("none"))
    for ft in iter_scheme_tables(layer, hw, constr, budget):
        res = evaluate_batch(ft, hw, nodes_assigned=constr.num_nodes,
                             src_onchip=constr.src_onchip,
                             dst_onchip=constr.dst_onchip)
        bi = res.best("energy")
        if bi >= 0 and res.energy_pj[bi] < best[1].energy_pj:
            best = (ft.scheme_at(bi), res.breakdown(bi))
    if best[0] is None:     # budget exhausted before a valid point: fall back
        best = solve_intra_layer(layer, hw, constr)
    if use_cache:
        exhaustive_cache.put(key, best[0], best[1])
    return best


def solve(graph: LayerGraph, hw: HWTemplate, budget_per_layer: int = 50000,
          max_seg_len: int = 4):
    """Exhaustive inter+intra search: every segment option is solved in full
    detail (no estimate-based pruning), then an exact DP over segmentation
    picks the globally optimal chain (optimal because detailed segment costs
    compose additively)."""
    from .interlayer import segment_pool
    from .kapla import NetworkSchedule, solve_segment

    t0 = time.perf_counter()
    consumers = _consumer_map(graph)
    n = len(graph.layers)

    def layer_solver(layer, hw_, constr):
        return solve_layer_exhaustive(layer, hw_, constr, budget_per_layer)

    # narrow alloc family: every candidate here is detail-solved in full, so
    # the widened 2-D region splits would blow up the exhaustive budget;
    # one multi-start batched shot covers all start indices
    seg_cands = segment_pool(graph, hw, range(n), max_seg_len, wide=False)
    INF = float("inf")
    best_cost = [INF] * (n + 1)
    best_prev: List[Optional[Tuple[int, float, Dict, Dict]]] = [None] * (n + 1)
    best_cost[0] = 0.0
    detail_cache: Dict = {}
    for i in range(1, n + 1):
        for start in range(max(0, i - max_seg_len), i):
            if best_cost[start] == INF:
                continue
            for seg in seg_cands[start]:
                if seg.stop != i:
                    continue
                key = seg.key
                if key not in detail_cache:
                    tot, schemes, costs, _pipe = solve_segment(
                        graph, hw, seg, consumers, layer_solver)
                    detail_cache[key] = None if tot is None else \
                        (tot.energy_pj, tot.latency_cycles, schemes, costs)
                entry = detail_cache[key]
                if entry is None:
                    continue
                e, lat, schemes, costs = entry
                if best_cost[start] + e < best_cost[i]:
                    best_cost[i] = best_cost[start] + e
                    best_prev[i] = (start, lat, schemes, costs)

    schemes_all: Dict[str, LayerScheme] = {}
    costs_all: Dict[str, CostBreakdown] = {}
    latency = 0.0
    i = n
    while i > 0 and best_prev[i] is not None:
        start, lat, schemes, costs = best_prev[i]
        schemes_all.update(schemes)
        costs_all.update(costs)
        latency += lat
        i = start
    return NetworkSchedule(graph.name, None, schemes_all, costs_all,
                           best_cost[n], latency,
                           time.perf_counter() - t0)
