"""Baseline M: AutoTVM-style ML-guided search (§V).

Simulated annealing over intra-layer scheme encodings, guided by a learned
surrogate (ridge regression over log-features, standing in for XGBoost —
no offline xgboost wheel in this container).  Batch-tune loop: propose a
batch of neighbors, rank with the surrogate, evaluate the top fraction with
the detailed model, refit.  Inter-layer options are taken from the same
chain enumeration as the other solvers (AutoTVM handles intra-layer only).
"""
from __future__ import annotations

import math
import random
import time
from typing import Dict, List, Optional, Tuple

from ...hw.template import HWTemplate
from ...workloads.layers import DIMS, LayerGraph, LayerSpec
from ..cost_batch import score_schemes
from ..cost_model import CostBreakdown, combine_segment, evaluate_layer, invalid
from ..directives import LayerScheme, canonical_orders, divisors
from .interlayer import dp_prioritize, io_flags, _consumer_map
from .intralayer import Constraints, solve_intra_layer
from .random_search import _random_scheme


def _features(scheme: LayerScheme) -> List[float]:
    f: List[float] = []
    for lv in scheme.levels:
        for d in DIMS:
            f.append(math.log1p(lv.tf(d)))
            f.append(math.log1p(lv.sf(d)))
    return f + [1.0]


class _Ridge:
    """Tiny ridge regression on-line surrogate (normal equations)."""

    def __init__(self, dim: int, lam: float = 1.0):
        self.dim = dim
        self.lam = lam
        self.X: List[List[float]] = []
        self.y: List[float] = []
        self.w: Optional[List[float]] = None

    def fit(self) -> None:
        n, d = len(self.X), self.dim
        if n < d // 2:
            self.w = None
            return
        # solve (X^T X + lam I) w = X^T y with Gaussian elimination
        A = [[self.lam if i == j else 0.0 for j in range(d)] for i in range(d)]
        b = [0.0] * d
        for xi, yi in zip(self.X, self.y):
            for i in range(d):
                b[i] += xi[i] * yi
                for j in range(d):
                    A[i][j] += xi[i] * xi[j]
        for col in range(d):
            piv = max(range(col, d), key=lambda r: abs(A[r][col]))
            if abs(A[piv][col]) < 1e-12:
                self.w = None
                return
            A[col], A[piv] = A[piv], A[col]
            b[col], b[piv] = b[piv], b[col]
            for r in range(col + 1, d):
                m = A[r][col] / A[col][col]
                for j in range(col, d):
                    A[r][j] -= m * A[col][j]
                b[r] -= m * b[col]
        w = [0.0] * d
        for i in range(d - 1, -1, -1):
            s = b[i] - sum(A[i][j] * w[j] for j in range(i + 1, d))
            w[i] = s / A[i][i]
        self.w = w

    def predict(self, x: List[float]) -> float:
        if self.w is None:
            return 0.0
        return sum(wi * xi for wi, xi in zip(self.w, x))

    def add(self, x: List[float], y: float) -> None:
        self.X.append(x)
        self.y.append(y)


def solve_layer_annealing(layer: LayerSpec, hw: HWTemplate,
                          constr: Optional[Constraints] = None,
                          iters: int = 64, batch: int = 32,
                          eval_frac: float = 0.25, seed: int = 0,
                          ) -> Tuple[Optional[LayerScheme], CostBreakdown]:
    constr = constr or Constraints(nodes=hw.node_array)
    rng = random.Random(seed ^ (hash(layer.name) & 0xFFFF))
    surrogate = _Ridge(dim=len(DIMS) * 2 * len(hw.levels) + 1)
    best: Tuple[Optional[LayerScheme], CostBreakdown] = (None, invalid("none"))
    cur: Optional[LayerScheme] = None
    cur_cost = float("inf")
    T = 1.0
    for it in range(iters):
        cands = [_random_scheme(layer, hw, constr, rng) for _ in range(batch)]
        if surrogate.w is not None:
            cands.sort(key=lambda s: surrogate.predict(_features(s)))
        n_eval = max(1, int(len(cands) * eval_frac))
        # detailed-model scoring of the surrogate-selected top fraction is
        # one vectorized batch; the SA walk below consumes the results in
        # the original order so the rng stream is untouched
        res = score_schemes(cands[:n_eval], hw,
                            nodes_assigned=constr.num_nodes,
                            src_onchip=constr.src_onchip,
                            dst_onchip=constr.dst_onchip)
        for bi, scheme in enumerate(cands[:n_eval]):
            cost = res.breakdown(bi)
            y = math.log1p(cost.energy_pj) if cost.valid else 60.0
            surrogate.add(_features(scheme), y)
            if not cost.valid:
                continue
            if cost.energy_pj < best[1].energy_pj:
                best = (scheme, cost)
            # SA accept/step
            if cost.energy_pj < cur_cost or \
                    rng.random() < math.exp(-(cost.energy_pj - cur_cost)
                                            / max(1e-9, cur_cost * T)):
                cur, cur_cost = scheme, cost.energy_pj
        surrogate.fit()
        T *= 0.95
    if best[0] is None:
        return solve_intra_layer(layer, hw, constr)
    return best


def solve(graph: LayerGraph, hw: HWTemplate, iters: int = 64,
          batch: int = 32, max_seg_len: int = 4, seed: int = 0):
    """ML-guided search: SA+surrogate intra-layer tuning within the shared
    inter-layer machinery (AutoTVM explores inter-layer exhaustively)."""
    from .kapla import solve as kapla_solve

    def layer_solver(layer, hw_, constr):
        return solve_layer_annealing(layer, hw_, constr, iters, batch,
                                     seed=seed)

    return kapla_solve(graph, hw, k_s=1, max_seg_len=max_seg_len,
                       layer_solver=layer_solver)
