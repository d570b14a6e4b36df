"""Inter-layer scheduling: segment slicing + layer pipelining (KAPLA §IV-B).

Validity  -> conservative pruning (min aggregated-buffer requirement).
Efficiency -> optimistic lower-bound cost, Pareto pruning, and
              dynamic-programming prioritization keeping top-k_S chains.

The hot path is fully vectorized: all (segment range, alloc option, granule
fraction) candidates are estimated in one batched shot
(``core/estimate_batch.py``), Pareto dominance is a single padded 3-D
broadcast across every (start, stop) group at once, and the DP keeps
top-k_S chains with ``argpartition`` over flat cost arrays — per-candidate
``SegmentScheme`` objects are only materialized for Pareto survivors (the
public pool API) or the winning chains (the DP).  The scalar reference path
(``enumerate_segments_scalar`` / ``dp_prioritize_scalar``) is kept for
parity tests and as the benchmark baseline; both paths are bit-exact equal.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ...hw.template import HWTemplate
from ...obs import trace
from ...workloads.layers import LayerGraph, LayerSpec
from ..estimate import estimate_layer, min_buffer_requirement_bytes
from ..estimate_batch import GraphPack, estimate_segments, pack_graph


@dataclasses.dataclass(frozen=True)
class SegmentScheme:
    """One inter-layer candidate for a contiguous run of layers."""

    start: int
    stop: int                              # [start, stop)
    alloc: Tuple[Tuple[int, int], ...]     # node region (h, w) per layer
    granule_frac: float                    # forwarded fmap fraction
    est_energy: float = 0.0
    est_latency: float = 0.0
    est_dram: float = 0.0

    @property
    def length(self) -> int:
        return self.stop - self.start

    @property
    def key(self) -> Tuple:
        """Identity of the detail-solve this segment induces (estimates
        excluded): the dedup key for segment caches within and across
        chains (``kapla.solve`` / ``solve_many``)."""
        return (self.start, self.stop, self.alloc, self.granule_frac)


@dataclasses.dataclass
class PruneStats:
    total: int = 0
    after_validity: int = 0
    after_pareto: int = 0


# ---------------------------------------------------------------------------
# node-region allocation options
# ---------------------------------------------------------------------------

def _axis_splits(budget: int, macs: Sequence[float]) -> List[Tuple[int, ...]]:
    """Partition ``budget`` units of one grid axis across ``len(macs)``
    layers: proportional to MACs and equal split, rounded to whole units
    with every layer getting >= 1."""
    n = len(macs)
    total = sum(macs)
    outs: List[Tuple[int, ...]] = []
    for mode in ("prop", "equal"):
        cols: List[int] = []
        left = budget
        for i in range(n):
            if i == n - 1:
                c = left
            else:
                share = macs[i] / total if mode == "prop" else 1.0 / n
                c = max(1, min(left - (n - 1 - i), round(budget * share)))
            cols.append(c)
            left -= c
        if left != 0 or min(cols) < 1:
            continue
        outs.append(tuple(cols))
    return outs


@functools.lru_cache(maxsize=16384)
def _alloc_options_cached(hw_grid: Tuple[int, int], macs: Tuple[float, ...],
                          wide: bool) -> Tuple[Tuple[Tuple[int, int], ...],
                                               ...]:
    """Partition the node grid into per-layer regions.

    Base family: full-height column strips (proportional to MACs, equal).
    ``wide`` adds 2-D (row x col) region splits: full-width row strips and
    a two-row-block layout with column strips inside each block — a
    strictly larger option space that the batched estimator prices at
    negligible cost.  Cached on (grid, MAC profile): real nets repeat layer
    runs (ResNet blocks, transformer stacks) heavily.
    """
    H, W = hw_grid
    n = len(macs)
    if n == 1:
        return (((H, W),),)
    outs: List[Tuple[Tuple[int, int], ...]] = []
    if n <= W:
        outs += [tuple((H, c) for c in cs) for cs in _axis_splits(W, macs)]
    if wide:
        if n <= H:
            outs += [tuple((r, W) for r in rs) for rs in _axis_splits(H, macs)]
        if H >= 2 and n >= 2:
            m = (n + 1) // 2
            ht, hb = H // 2, H - H // 2
            if m <= W and 1 <= n - m <= W:
                for top in _axis_splits(W, macs[:m]):
                    for bot in _axis_splits(W, macs[m:]):
                        outs.append(tuple((ht, c) for c in top) +
                                    tuple((hb, c) for c in bot))
    seen, uniq = set(), []
    for o in outs:
        if o not in seen:
            seen.add(o)
            uniq.append(o)
    return tuple(uniq)


def _alloc_options(hw: HWTemplate, layers: Sequence[LayerSpec],
                   wide: bool = True,
                   ) -> List[Tuple[Tuple[int, int], ...]]:
    macs = tuple(max(1.0, l.total_macs()) for l in layers)
    return list(_alloc_options_cached(hw.node_array, macs, wide))


# ---------------------------------------------------------------------------
# graph helpers
# ---------------------------------------------------------------------------

def _consumer_map(graph: LayerGraph) -> Dict[str, List[str]]:
    cons: Dict[str, List[str]] = {l.name: [] for l in graph.layers}
    for l in graph.layers:
        for s in l.src:
            if s in cons:
                cons[s].append(l.name)
    return cons


def io_flags(graph: LayerGraph, seg_names: set, layer: LayerSpec,
             consumers: Dict[str, List[str]]) -> Tuple[bool, bool]:
    src_onchip = bool(layer.src) and all(s in seg_names for s in layer.src)
    cons = consumers.get(layer.name, [])
    dst_onchip = bool(cons) and all(c in seg_names for c in cons)
    return src_onchip, dst_onchip


# graphs carrying attached caches, so memo.clear_all() can reach them
# (id-keyed: LayerGraph is unhashable, weak values avoid leaking graphs)
_CACHED_GRAPHS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def clear_graph_caches() -> None:
    """Drop every graph-attached pack / candidate-batch cache (for cold
    benchmarking; called by ``memo.clear_all``)."""
    for g in list(_CACHED_GRAPHS.values()):
        g.__dict__.pop("_estimate_pack_cache", None)
        g.__dict__.pop("_segment_batch_cache", None)
    _alloc_options_cached.cache_clear()


def graph_pack(graph: LayerGraph, hw: HWTemplate) -> GraphPack:
    """Per-(graph, hw) memoized ``pack_graph`` — the pack is immutable and
    graphs are not mutated after construction, so cache it on the graph."""
    cache = graph.__dict__.setdefault("_estimate_pack_cache", {})
    _CACHED_GRAPHS[id(graph)] = graph
    gp = cache.get(hw)
    if gp is None:
        gp = cache[hw] = pack_graph(graph, hw)
    return gp


# ---------------------------------------------------------------------------
# candidate enumeration + batched estimation
# ---------------------------------------------------------------------------

CandidateMeta = Tuple[int, int, Tuple[Tuple[int, int], ...], float]


@dataclasses.dataclass
class CandidateBatch:
    """All candidates of an enumeration, as parallel columns, plus their
    batch-estimated bounds.  Enumeration order is (start asc, stop asc,
    alloc order, granule order) — candidates of one (start, stop) group are
    contiguous."""

    starts: np.ndarray          # [C] int64
    stops: np.ndarray           # [C] int64
    gfs: np.ndarray             # [C] float64
    allocs: List[Tuple[Tuple[int, int], ...]]
    valid: np.ndarray           # [C] bool
    energy: np.ndarray          # [C]
    latency: np.ndarray         # [C]
    dram: np.ndarray            # [C]
    kept: np.ndarray            # [K] int64 indices surviving Pareto
    # lazily-built DP index caches (plain lists: fast scalar indexing)
    _starts_list: Optional[List[int]] = None
    _by_stop: Optional[List[List[int]]] = None

    def __len__(self) -> int:
        return len(self.starts)

    def scheme_at(self, c: int) -> SegmentScheme:
        return SegmentScheme(int(self.starts[c]), int(self.stops[c]),
                             self.allocs[c], float(self.gfs[c]),
                             float(self.energy[c]), float(self.latency[c]),
                             float(self.dram[c]))


def _enumerate_columns(graph: LayerGraph, hw: HWTemplate,
                       starts: Iterable[int], max_len: int, wide: bool,
                       ) -> Tuple[List[int], List[int], List, List[float]]:
    max_len = max_len if hw.spatial_layer_pipe else 1
    layers = graph.layers
    n = len(layers)
    grid = hw.node_array
    macs_all = [max(1.0, l.total_macs()) for l in layers]
    starts_l: List[int] = []
    stops_l: List[int] = []
    allocs_l: List = []
    gfs_l: List[float] = []
    for start in starts:
        gf_small = 1.0 / layers[start].dim("N")
        for stop in range(start + 1, min(start + max_len, n) + 1):
            allocs = _alloc_options_cached(
                grid, tuple(macs_all[start:stop]), wide)
            if not allocs:
                continue
            gfs = (1.0,) if stop - start == 1 else (gf_small, 1.0)
            k = len(allocs) * len(gfs)
            starts_l += [start] * k
            stops_l += [stop] * k
            allocs_l += [a for a in allocs for _ in gfs]
            gfs_l += list(gfs) * len(allocs)
    return starts_l, stops_l, allocs_l, gfs_l


def candidate_metas(graph: LayerGraph, hw: HWTemplate,
                    starts: Iterable[int], max_len: int = 4,
                    wide: bool = True) -> List[CandidateMeta]:
    """Enumerate every (start, stop, alloc, granule_frac) candidate for the
    given start indices, in deterministic order."""
    s, e, a, g = _enumerate_columns(graph, hw, starts, max_len, wide)
    return list(zip(s, e, a, g))


def estimate_candidates(graph: LayerGraph, hw: HWTemplate,
                        metas: Sequence[CandidateMeta],
                        gp: Optional[GraphPack] = None,
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Batch-estimate candidate metas: (valid, energy, latency, dram)."""
    cols = ([m[0] for m in metas], [m[1] for m in metas],
            [m[2] for m in metas], [m[3] for m in metas])
    return _estimate_columns(graph, hw, cols, gp)


def _estimate_columns(graph: LayerGraph, hw: HWTemplate, cols,
                      gp: Optional[GraphPack] = None,
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    starts_l, stops_l, allocs_l, gfs_l = cols
    if gp is None:
        gp = graph_pack(graph, hw)
    starts = np.asarray(starts_l, dtype=np.int64)
    stops = np.asarray(stops_l, dtype=np.int64)
    gfs = np.asarray(gfs_l, dtype=np.float64)
    # alloc tuples repeat heavily: pack node counts once per distinct alloc
    alloc_ids: Dict[Tuple, int] = {}
    uniq_rows: List[List[int]] = []
    ids = np.empty(len(allocs_l), dtype=np.int64)
    for c, alloc in enumerate(allocs_l):
        aid = alloc_ids.get(alloc)
        if aid is None:
            aid = alloc_ids[alloc] = len(uniq_rows)
            uniq_rows.append([h * w for h, w in alloc])
        ids[c] = aid
    lmax = max(len(r) for r in uniq_rows)
    mat = np.ones((len(uniq_rows), lmax))
    for i, r in enumerate(uniq_rows):
        mat[i, :len(r)] = r
    return estimate_segments(gp, hw, starts, stops, gfs, mat[ids])


# ---------------------------------------------------------------------------
# Pareto pruning (vectorized dominance on stacked cost arrays)
# ---------------------------------------------------------------------------

def _pareto_keep_mask(e: np.ndarray, lat: np.ndarray,
                      d: np.ndarray) -> np.ndarray:
    """Dominance check within one candidate group; exact-cost duplicates
    are all kept (mirrors the scalar rule)."""
    le = (e[None, :] <= e[:, None]) & (lat[None, :] <= lat[:, None]) \
        & (d[None, :] <= d[:, None])
    neq = (e[None, :] != e[:, None]) | (lat[None, :] != lat[:, None]) \
        | (d[None, :] != d[:, None])
    return ~np.any(le & neq, axis=1)


def _grouped_pareto_kept(key: np.ndarray, valid: np.ndarray, e: np.ndarray,
                         lat: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Indices of candidates surviving per-group Pareto pruning, where
    ``key`` is nondecreasing and identifies the (start, stop) group.  All
    groups are checked in one padded [G, M, M] broadcast; padding lanes are
    +inf and can never dominate a real candidate."""
    vidx = np.flatnonzero(valid)
    if len(vidx) == 0:
        return vidx
    g = key[vidx]
    bounds = np.flatnonzero(np.diff(g)) + 1
    group_start = np.concatenate([[0], bounds])
    sizes = np.diff(np.concatenate([group_start, [len(g)]]))
    G, M = len(group_start), int(sizes.max())
    pos = np.arange(len(g)) - np.repeat(group_start, sizes)
    gix = np.repeat(np.arange(G), sizes)
    inf = float("inf")
    eg = np.full((G, M), inf)
    lg = np.full((G, M), inf)
    dg = np.full((G, M), inf)
    eg[gix, pos] = e[vidx]
    lg[gix, pos] = lat[vidx]
    dg[gix, pos] = d[vidx]
    le = (eg[:, None, :] <= eg[:, :, None]) \
        & (lg[:, None, :] <= lg[:, :, None]) \
        & (dg[:, None, :] <= dg[:, :, None])
    neq = (eg[:, None, :] != eg[:, :, None]) \
        | (lg[:, None, :] != lg[:, :, None]) \
        | (dg[:, None, :] != dg[:, :, None])
    keep = ~np.any(le & neq, axis=2)            # [G, M]
    return vidx[keep[gix, pos]]


def _build_candidate_batch(graph: LayerGraph, hw: HWTemplate,
                           starts: List[int], max_len: int,
                           gp: Optional[GraphPack],
                           wide: bool) -> CandidateBatch:
    """Enumerate + batch-estimate + Pareto-prune in three vectorized shots."""
    cols = _enumerate_columns(graph, hw, starts, max_len, wide)
    if not cols[0]:
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return CandidateBatch(zi, zi, z, [], np.zeros(0, dtype=bool),
                              z, z, z, zi)
    valid, energy, latency, dram = _estimate_columns(graph, hw, cols, gp)
    sarr = np.asarray(cols[0], dtype=np.int64)
    earr = np.asarray(cols[1], dtype=np.int64)
    key = sarr * np.int64(len(graph.layers) + 1) + earr
    kept = _grouped_pareto_kept(key, valid, energy, latency, dram)
    return CandidateBatch(sarr, earr, np.asarray(cols[3]), cols[2],
                          valid, energy, latency, dram, kept)


def _candidate_batch(graph: LayerGraph, hw: HWTemplate,
                     starts: Iterable[int], max_len: int,
                     stats: Optional[PruneStats] = None,
                     wide: bool = True) -> CandidateBatch:
    """Memoized candidate batch: the enumeration/estimates are a pure
    function of (graph, hw, starts, max_len, wide), and graphs are not
    mutated after construction, so repeated DP calls (annealing restarts,
    repeated solves) reuse the packed arrays."""
    # ascending unique starts: grouped Pareto needs a monotone group key,
    # and duplicates would double-enumerate candidates
    starts = sorted(set(starts))
    key = (hw, max_len, wide, tuple(starts))
    cache = graph.__dict__.setdefault("_segment_batch_cache", {})
    _CACHED_GRAPHS[id(graph)] = graph
    cb = cache.get(key)
    if cb is None:
        while len(cache) >= 8:              # FIFO eviction: keep hot entries
            cache.pop(next(iter(cache)))
        cb = cache[key] = _build_candidate_batch(graph, hw, starts, max_len,
                                                 None, wide)
    if stats:
        stats.total += len(cb)
        stats.after_validity += int(cb.valid.sum())
        stats.after_pareto += len(cb.kept)
    return cb


# ---------------------------------------------------------------------------
# explain: the candidate funnel as a first-class record (obs.explain)
# ---------------------------------------------------------------------------

def _classify_invalid(graph: LayerGraph, hw: HWTemplate,
                      cb: CandidateBatch,
                      idx: np.ndarray) -> Dict[str, Dict]:
    """Attribute each validity-pruned candidate to its failing rule.

    The batched validity check has exactly one rule — the conservative
    min-buffer bound (``min_buffer_requirement_bytes`` vs the segment's
    aggregated GBUF).  Recompute it for the invalid lanes to name the
    *first* overflowing layer per candidate, so the explain report can
    say which layer killed the candidates, not just how many died."""
    out: Dict[str, Dict] = {
        "gbuf_min_buffer": {"count": int(len(idx)), "layers": {}}}
    if len(idx) == 0:
        return out
    gp = graph_pack(graph, hw)
    starts = cb.starts[idx]
    stops = cb.stops[idx]
    gfs = cb.gfs[idx]
    lengths = stops - starts
    lmax = int(lengths.max())
    pos = np.arange(lmax, dtype=np.int64)
    mask = pos[None, :] < lengths[:, None]
    lidx = np.minimum(starts[:, None] + pos[None, :], gp.n_layers - 1)
    src_on = gp.src_ok[lidx] & (gp.min_src[lidx] >= starts[:, None]) \
        & (gp.max_src[lidx] < stops[:, None])
    dst_on = gp.has_cons[lidx] & (gp.min_cons[lidx] >= starts[:, None]) \
        & (gp.max_cons[lidx] < stops[:, None])
    B = gp.bytes_per_elem[lidx]
    gf_c = gfs[:, None]
    need = np.where(src_on, 2.0 * gp.ifmap[lidx] * gf_c * B, 0.0) \
        + np.where(dst_on, 2.0 * gp.ofmap[lidx] * gf_c * B, 0.0)
    nodes = np.ones((len(idx), lmax))
    for r, c in enumerate(idx):
        for p, (h, w) in enumerate(cb.allocs[int(c)]):
            nodes[r, p] = h * w
    over = (need > nodes * hw.gbuf.capacity_bytes) & mask
    first = np.argmax(over, axis=1)
    layers: Dict[str, int] = {}
    for r in range(len(idx)):
        li = int(lidx[r, first[r]])
        name = graph.layers[li].name
        layers[name] = layers.get(name, 0) + 1
    out["gbuf_min_buffer"]["layers"] = layers
    return out


def funnel_from_batch(graph: LayerGraph, hw: HWTemplate,
                      cb: CandidateBatch) -> Dict:
    """One enumeration batch's candidate funnel as a JSON-safe record:
    per-(start, stop) group enumerated/valid/Pareto-kept counts, overall
    totals, and per-rule pruning attribution.

    The totals equal the ``PruneStats`` deltas a DP run records for the
    same starts *by construction* — both are computed from the same
    memoized ``CandidateBatch`` — which is what lets the Table VI bench
    and the flight recorder agree without reconciliation."""
    totals = {"enumerated": int(len(cb)),
              "after_validity": int(cb.valid.sum()),
              "after_pareto": int(len(cb.kept))}
    if len(cb) == 0:
        return {"groups": [], "totals": totals, "pruned_by_rule": {}}
    kept_mask = np.zeros(len(cb), dtype=bool)
    kept_mask[cb.kept] = True
    key = cb.starts * np.int64(len(graph.layers) + 1) + cb.stops
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(key)) + 1,
                             [len(cb)]])
    groups = []
    for gi in range(len(bounds) - 1):
        a, b = int(bounds[gi]), int(bounds[gi + 1])
        groups.append({"start": int(cb.starts[a]),
                       "stop": int(cb.stops[a]),
                       "enumerated": b - a,
                       "valid": int(cb.valid[a:b].sum()),
                       "kept": int(kept_mask[a:b].sum())})
    rules = _classify_invalid(graph, hw, cb, np.flatnonzero(~cb.valid))
    return {"groups": groups, "totals": totals, "pruned_by_rule": rules}


def funnel_report(graph: LayerGraph, hw: HWTemplate,
                  starts: Optional[Iterable[int]] = None,
                  max_len: int = 4, wide: bool = True) -> Dict:
    """The candidate funnel for these start indices (every layer when
    None) — a cache hit on the memoized batch right after a solve of the
    same shape, so extracting the funnel costs ~nothing."""
    if starts is None:
        starts = range(len(graph.layers))
    cb = _candidate_batch(graph, hw, starts, max_len, None, wide)
    return funnel_from_batch(graph, hw, cb)


def segment_pool(graph: LayerGraph, hw: HWTemplate,
                 starts: Iterable[int], max_len: int = 4,
                 stats: Optional[PruneStats] = None,
                 wide: bool = True) -> Dict[int, List[SegmentScheme]]:
    """Valid, Pareto-pruned segment candidates per start index, computed in
    one batched estimation shot across all starts."""
    starts = list(starts)
    cb = _candidate_batch(graph, hw, starts, max_len, stats, wide)
    out: Dict[int, List[SegmentScheme]] = {s: [] for s in starts}
    for c in cb.kept:
        out[int(cb.starts[c])].append(cb.scheme_at(c))
    return out


def enumerate_segments(graph: LayerGraph, hw: HWTemplate, start: int,
                       max_len: int = 4,
                       stats: Optional[PruneStats] = None,
                       wide: bool = True) -> List[SegmentScheme]:
    """All (conservatively) valid segment candidates starting at ``start``
    — a thin wrapper over the batched estimator."""
    return segment_pool(graph, hw, [start], max_len, stats,
                        wide=wide)[start]


# ---------------------------------------------------------------------------
# scalar reference path (parity tests + benchmark baseline)
# ---------------------------------------------------------------------------

def estimate_segment_scalar(graph: LayerGraph, hw: HWTemplate, start: int,
                            stop: int, alloc, gf: float, names: set,
                            consumers) -> Optional[SegmentScheme]:
    """One ``estimate_layer`` call per layer: the PR-1 scalar upper level."""
    e = lat = dram = 0.0
    for i, layer in enumerate(graph.layers[start:stop]):
        src_on, dst_on = io_flags(graph, names, layer, consumers)
        nodes = alloc[i][0] * alloc[i][1]
        need = min_buffer_requirement_bytes(layer, gf, src_on, dst_on)
        if need > nodes * hw.gbuf.capacity_bytes:
            return None                      # conservative validity pruning
        est = estimate_layer(layer, hw, nodes, gf, src_on, dst_on)
        if not est.valid:
            return None
        e += est.energy_lb_pj
        lat = max(lat, est.latency_lb_cycles)
        dram += est.dram_bytes_lb
    # fine-grained forwarding: fill cost of one granule per stage
    lat = lat + lat * gf * max(0, stop - start - 1)
    return SegmentScheme(start, stop, alloc, gf, e, lat, dram)


_estimate_segment = estimate_segment_scalar        # back-compat alias


def enumerate_segments_scalar(graph: LayerGraph, hw: HWTemplate, start: int,
                              max_len: int = 4,
                              stats: Optional[PruneStats] = None,
                              wide: bool = True) -> List[SegmentScheme]:
    out: List[SegmentScheme] = []
    consumers = _consumer_map(graph)
    names: set = set()
    last_range = None
    for start_, stop, alloc, gf in candidate_metas(graph, hw, [start],
                                                   max_len, wide=wide):
        if stats:
            stats.total += 1
        if (start_, stop) != last_range:    # one name-set per (start, stop)
            names = {l.name for l in graph.layers[start_:stop]}
            last_range = (start_, stop)
        cand = estimate_segment_scalar(graph, hw, start_, stop, alloc, gf,
                                       names, consumers)
        if cand is None:
            continue
        if stats:
            stats.after_validity += 1
        out.append(cand)
    out = _pareto_prune(out)
    if stats:
        stats.after_pareto += len(out)
    return out


def _pareto_prune(cands: List[SegmentScheme]) -> List[SegmentScheme]:
    """Drop candidates dominated on (energy, latency, dram) within the same
    [start, stop) range."""
    out: List[SegmentScheme] = []
    by_range: Dict[Tuple[int, int], List[SegmentScheme]] = {}
    for c in cands:
        by_range.setdefault((c.start, c.stop), []).append(c)
    for group in by_range.values():
        e = np.array([c.est_energy for c in group])
        lat = np.array([c.est_latency for c in group])
        d = np.array([c.est_dram for c in group])
        keep = _pareto_keep_mask(e, lat, d)
        out.extend(c for c, k in zip(group, keep) if k)
    return out


# ---------------------------------------------------------------------------
# DP prioritization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Chain:
    segments: Tuple[SegmentScheme, ...]
    est_cost: float

    @property
    def key(self) -> Tuple:
        """Segmentation identity (per-segment keys): equal keys mean the
        same detail solve — chain dedup across DP results and warm-start
        seeds."""
        return tuple(s.key for s in self.segments)


def _seg_cost_fn(objective: str):
    def seg_cost(s: SegmentScheme) -> float:
        return s.est_energy if objective == "energy" else \
            s.est_energy * s.est_latency if objective == "edp" else \
            s.est_latency
    return seg_cost


def dp_prioritize(graph: LayerGraph, hw: HWTemplate, k_s: int = 4,
                  max_seg_len: int = 4, objective: str = "energy",
                  stats: Optional[PruneStats] = None,
                  explain=None) -> List[Chain]:
    """DP over the (topologically ordered) layer list: best segment chains
    ending at each layer, keeping top-k_S everywhere (§IV-B).

    Array-based: per layer index, all (segment, predecessor-chain) costs
    are formed with one broadcast per predecessor start and the top-k_S
    selected with argpartition over the flat array — ``SegmentScheme`` /
    ``Chain`` objects exist only for the returned chains.

    ``explain``, when an ``obs.explain.ExplainSink``, receives the
    candidate funnel of this run (``funnel_from_batch`` over the same
    memoized batch the DP consumed, so counts match ``stats`` exactly).
    """
    n = len(graph.layers)
    with trace.span("dp.enumerate", graph=graph.name, layers=n):
        cb = _candidate_batch(graph, hw, range(n), max_seg_len, stats)
    if explain is not None:
        explain.set_funnel(funnel_from_batch(graph, hw, cb))
    if objective == "energy":
        costv = cb.energy
    elif objective == "edp":
        costv = cb.energy * cb.latency
    else:
        costv = cb.latency
    # kept candidates bucketed by stop; order within a bucket is (start asc,
    # enumeration order) because kept indices are ascending
    if cb._by_stop is None:
        stops_l = cb.stops.tolist()
        buckets: List[List[int]] = [[] for _ in range(n + 1)]
        for c in cb.kept.tolist():
            buckets[stops_l[c]].append(c)
        cb._by_stop = buckets
        cb._starts_list = cb.starts.tolist()
    by_stop = cb._by_stop
    starts_l = cb._starts_list

    best_costs: List[Optional[np.ndarray]] = [None] * (n + 1)
    # back[i][r] = (candidate index in cb, predecessor rank at its start)
    back: List[List[Tuple[int, int]]] = [[] for _ in range(n + 1)]
    best_costs[0] = np.zeros(1)
    back[0] = [(-1, -1)]
    with trace.span("dp.select", graph=graph.name, k_s=k_s):
        for i in range(1, n + 1):
            ids = by_stop[i]
            parts: List[np.ndarray] = []
            groups: List[Tuple[List[int], int, int]] = []   # (cands, k, offset)
            off = 0
            j = 0
            n_ids = len(ids)
            while j < n_ids:
                s = starts_l[ids[j]]
                j2 = j
                while j2 < n_ids and starts_l[ids[j2]] == s:
                    j2 += 1
                prev = best_costs[s]
                if prev is not None and len(prev):
                    cands = ids[j:j2]
                    # [m, k] candidate-major: same order as the scalar loops
                    parts.append((costv[cands][:, None] + prev[None, :]).ravel())
                    groups.append((cands, len(prev), off))
                    off += len(cands) * len(prev)
                j = j2
            if not parts:
                raise RuntimeError(f"no valid segment chain up to layer {i}")
            costs = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if len(costs) > k_s:
                sel = np.argpartition(costs, k_s - 1)[:k_s]
                # tie-break on the flat index so the kept order matches the
                # scalar DP's stable sort (up to equal-cost boundary members)
                sel = sel[np.lexsort((sel, costs[sel]))]
            else:
                sel = np.argsort(costs, kind="stable")
            best_costs[i] = costs[sel]
            back_i: List[Tuple[int, int]] = []
            for jf in sel:
                jf = int(jf)
                for cands, k, goff in groups:
                    if jf < goff + len(cands) * k:
                        local = jf - goff
                        back_i.append((cands[local // k], local % k))
                        break
            back[i] = back_i

    def build(i: int, rank: int) -> Tuple[SegmentScheme, ...]:
        segs: List[SegmentScheme] = []
        while True:                     # iterative: chains can be ~n long
            c, rank = back[i][rank]
            if c < 0:
                return tuple(reversed(segs))
            segs.append(cb.scheme_at(c))
            i = starts_l[c]

    return [Chain(build(n, r), float(best_costs[n][r]))
            for r in range(len(best_costs[n]))]


def dp_prioritize_scalar(graph: LayerGraph, hw: HWTemplate, k_s: int = 4,
                         max_seg_len: int = 4, objective: str = "energy",
                         stats: Optional[PruneStats] = None) -> List[Chain]:
    """The PR-1 scalar DP: per-index Python sort over Chain objects, fed by
    the scalar per-candidate estimator.  Kept as the parity reference and
    benchmark baseline for the array DP above."""
    n = len(graph.layers)
    seg_cache: Dict[int, List[SegmentScheme]] = {
        i: enumerate_segments_scalar(graph, hw, i, max_seg_len, stats)
        for i in range(n)}
    seg_cost = _seg_cost_fn(objective)

    best: List[List[Chain]] = [[] for _ in range(n + 1)]
    best[0] = [Chain((), 0.0)]
    for i in range(1, n + 1):
        cands: List[Chain] = []
        for seg_start in range(max(0, i - max_seg_len), i):
            for seg in seg_cache[seg_start]:
                if seg.stop != i:
                    continue
                for prev in best[seg_start]:
                    cands.append(Chain(prev.segments + (seg,),
                                       prev.est_cost + seg_cost(seg)))
        cands.sort(key=lambda c: c.est_cost)
        best[i] = cands[:k_s]
        if not best[i]:
            raise RuntimeError(f"no valid segment chain up to layer {i}")
    return best[n]
