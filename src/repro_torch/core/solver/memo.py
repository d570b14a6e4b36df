"""Solver-wide memoization (layer-signature caches).

Real networks repeat identical layer shapes (ResNet blocks, LSTM cells,
MobileNet's stacked dw/pw pairs), and the inter-layer DP re-solves the same
(layer, constraints) pair across many candidate chains.  A *canonical layer
signature* — the layer's shape/tensor structure with the identity stripped
(name, graph edges) — plus the hardware fingerprint and the inter-layer
constraints fully determine an intra-layer solve, so repeated layers are
solved exactly once per process.

Cached values store the scheme's levels detached from any particular
``LayerSpec`` so a hit can be re-bound to the requesting layer object.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Hashable, Optional, Tuple

from ...hw.template import HWTemplate
from ...obs import metrics
from ...workloads.layers import LayerSpec
from ..cost_model import CostBreakdown
from ..directives import LayerScheme

_m_memo = metrics.counter(
    "solver_memo_total", "layer-signature memo lookups",
    ("cache", "outcome"))


def _freeze_mapping(m) -> Tuple:
    if m is None:
        return ()
    return tuple(sorted((k, v if not isinstance(v, frozenset)
                         else tuple(sorted(v))) for k, v in m.items()))


def layer_signature(layer: LayerSpec) -> Hashable:
    """Canonical shape signature: everything that feeds the cost model,
    nothing that identifies the layer within a graph (name, src edges)."""
    return (layer.kind,
            _freeze_mapping(layer.dims),
            _freeze_mapping({t: tuple(sorted(rel))
                             for t, rel in layer.tensors.items()}),
            _freeze_mapping(layer.unit),
            _freeze_mapping(layer.unit_inner),
            layer.macs_per_point,
            tuple(sorted(layer.reduction_dims)),
            layer.bytes_per_elem,
            layer.has_weights)


def constraints_key(constr) -> Hashable:
    return (tuple(constr.nodes), constr.src_onchip, constr.dst_onchip,
            constr.full_reduction_onchip, tuple(constr.outer_dims))


def solve_key(layer: LayerSpec, hw: HWTemplate, constr,
              extra: Hashable = None) -> Hashable:
    """Full memo key for one intra-layer solve.  ``hw`` is a frozen
    dataclass and hashes by value, i.e. equal presets share entries."""
    return (layer_signature(layer), hw, constraints_key(constr), extra)


class SolveCache:
    """Bounded dict cache for (scheme, cost) solve results.

    Schemes are stored as detached level lists and re-bound to the caller's
    layer on lookup; costs are copied so callers can never corrupt an entry.

    Thread-safe: ``kapla.solve`` fans segment solves out to a thread pool,
    so concurrent get/put on the same key must be benign (both threads
    compute the same value; last put wins).
    """

    def __init__(self, max_entries: int = 4096, name: str = "anon"):
        self.max_entries = max_entries
        self.name = name
        self._store: Dict[Hashable, Tuple[Optional[list], CostBreakdown]] = {}
        self._lock = threading.Lock()
        # plain ints (tests read them directly); lookups are also
        # mirrored into solver_memo_total{cache,outcome} (repro.obs)
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = 0
            self.misses = 0

    def get(self, key: Hashable, layer: LayerSpec
            ) -> Optional[Tuple[Optional[LayerScheme], CostBreakdown]]:
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self.misses += 1
                _m_memo.inc(cache=self.name, outcome="miss")
                return None
            self.hits += 1
        _m_memo.inc(cache=self.name, outcome="hit")
        # entries are never mutated after insertion, so the defensive
        # copies can be built outside the lock (keeps the hit path of
        # concurrent segment solves from serializing)
        levels, cost = entry
        scheme = None if levels is None else \
            LayerScheme(layer, [lv.copy() for lv in levels])
        return scheme, dataclasses.replace(cost)

    def put(self, key: Hashable, scheme: Optional[LayerScheme],
            cost: CostBreakdown) -> None:
        levels = None if scheme is None else [lv.copy()
                                              for lv in scheme.levels]
        with self._lock:
            if len(self._store) >= self.max_entries:
                self._store.clear()         # simple epoch eviction
            self._store[key] = (levels, dataclasses.replace(cost))


# process-wide caches, one per solver family
intra_cache = SolveCache(name="intra")
exhaustive_cache = SolveCache(name="exhaustive")


def clear_all() -> None:
    """Reset every process-wide solver cache, including the lru_cached pure
    helpers and the graph-attached pack / candidate-batch caches, so 'cold'
    timings really are cold."""
    from .. import cost_batch, directives
    from . import interlayer
    intra_cache.clear()
    exhaustive_cache.clear()
    directives._divisors_cached.cache_clear()
    directives.smallest_prime_factor.cache_clear()
    directives._canonical_orders_cached.cache_clear()
    cost_batch.pack_order.cache_clear()
    interlayer.clear_graph_caches()


def stats() -> Dict[str, Any]:
    return {"intra": {"entries": len(intra_cache),
                      "hits": intra_cache.hits,
                      "misses": intra_cache.misses},
            "exhaustive": {"entries": len(exhaustive_cache),
                           "hits": exhaustive_cache.hits,
                           "misses": exhaustive_cache.misses}}
