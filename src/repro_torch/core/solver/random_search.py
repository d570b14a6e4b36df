"""Baseline R: Timeloop-style random sampling of the scheme space (§V).

Each candidate at each level is evaluated with probability ``p`` (segment
slicing is never skipped, since skipping segments may leave incomplete
chains — exactly the paper's caveat)."""
from __future__ import annotations

import random
import time
from typing import Dict, Optional, Tuple

from ...hw.template import HWTemplate
from ...workloads.layers import DIMS, LayerGraph, LayerSpec
from ..cost_batch import score_schemes
from ..cost_model import CostBreakdown, combine_segment, evaluate_layer, invalid
from ..directives import (LayerScheme, LevelBlocking, canonical_orders,
                          divisors)
from .interlayer import enumerate_segments, io_flags, _consumer_map
from .intralayer import Constraints, _pe_axis_dims, solve_intra_layer


def _random_scheme(layer: LayerSpec, hw: HWTemplate, constr: Constraints,
                   rng: random.Random) -> LayerScheme:
    pe_axes = _pe_axis_dims(hw)
    lv0, lv1, lv2 = LevelBlocking(), LevelBlocking(), LevelBlocking()
    # PE spatial
    for ax in (0, 1):
        d = rng.choice(list(pe_axes[ax]))
        opts = [f for f in divisors(layer.dim(d)) if f <= hw.pe_array[ax]]
        f = rng.choice(opts)
        if f > 1:
            lv0.s[d] = lv0.sf(d) * f
    # node spatial
    H, W = constr.nodes
    for budget in (H, W):
        d = rng.choice(DIMS)
        rem = layer.dim(d) // (lv0.sf(d) * lv1.sf(d))
        opts = [f for f in divisors(rem) if f <= budget]
        f = rng.choice(opts)
        if f > 1:
            lv1.s[d] = lv1.sf(d) * f
    # temporal splits
    for d in DIMS:
        rem = layer.dim(d) // (lv0.sf(d) * lv1.sf(d))
        t0 = rng.choice(divisors(rem))
        t1 = rng.choice(divisors(rem // t0))
        t2 = rem // t0 // t1
        if t0 > 1:
            lv0.t[d] = t0
        if t1 > 1:
            lv1.t[d] = t1
        if t2 > 1:
            lv2.t[d] = t2
    orders = canonical_orders()
    lv1.order = rng.choice(orders)
    top_orders = [o for o in orders
                  if not constr.outer_dims
                  or o[: len(constr.outer_dims)] == constr.outer_dims]
    lv2.order = rng.choice(top_orders or orders)
    return LayerScheme(layer, [lv0, lv1, lv2])


def solve_layer_random(layer: LayerSpec, hw: HWTemplate,
                       constr: Optional[Constraints] = None,
                       samples: int = 2000, p: float = 0.1,
                       seed: int = 0,
                       ) -> Tuple[Optional[LayerScheme], CostBreakdown]:
    constr = constr or Constraints(nodes=hw.node_array)
    rng = random.Random(seed ^ hash(layer.name) & 0xFFFF)
    best: Tuple[Optional[LayerScheme], CostBreakdown] = (None, invalid("none"))
    sampled = []
    for _ in range(samples):
        if rng.random() > p:
            continue                      # candidate skipped
        sampled.append(_random_scheme(layer, hw, constr, rng))
    if sampled:
        # score the whole sample set as one vectorized batch
        res = score_schemes(sampled, hw, nodes_assigned=constr.num_nodes,
                            src_onchip=constr.src_onchip,
                            dst_onchip=constr.dst_onchip)
        bi = res.best("energy")
        if bi >= 0:
            best = (sampled[bi], res.breakdown(bi))
    if best[0] is None:
        return solve_intra_layer(layer, hw, constr)
    return best


def solve(graph: LayerGraph, hw: HWTemplate, samples: int = 2000,
          p: float = 0.1, max_seg_len: int = 4, seed: int = 0):
    """Random search: random intra-layer sampling within the shared
    inter-layer machinery (segments are never skipped, per the paper)."""
    from .kapla import solve as kapla_solve

    def layer_solver(layer, hw_, constr):
        return solve_layer_random(layer, hw_, constr, samples, p, seed)

    return kapla_solve(graph, hw, k_s=1, max_seg_len=max_seg_len,
                       layer_solver=layer_solver)
