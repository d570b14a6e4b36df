"""KAPLA top-level solve: inter-layer DP prioritization + intra-layer
bottom-up cost descent, then final scoring with the detailed model (§IV).

Beyond the single argmin ``solve``, this module exposes the entry points
the schedule service (``repro.service``) is built on:

  * ``solve_topk`` — the k best valid chains, each detail-solved into a
    full ``NetworkSchedule`` (measured re-ranking picks among them);
  * ``seed_chains_from`` + ``solve(..., seed_chains=, use_dp=False)`` —
    warm-starting a solve from a previously solved schedule of the same
    graph family (e.g. a different batch size), skipping the DP;
  * ``solve_many`` — several graphs solved together, with the distinct
    segments of *all* requests pooled into one ThreadPoolExecutor pass
    (the server's request-coalescing batch path).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ...hw.template import HWTemplate
from ...obs import metrics, trace
from ...runtime import inject
from ...workloads.layers import LayerGraph, LayerSpec
from ..cost_model import CostBreakdown, attribute_costs, combine_segment, \
    cycle_terms, evaluate_layer
from ..directives import LayerScheme
from .interlayer import Chain, PruneStats, dp_prioritize, io_flags, \
    _consumer_map
from .intralayer import Constraints, solve_intra_layer

# -- telemetry (repro.obs) ---------------------------------------------------
_m_segments = metrics.counter(
    "solver_segments_total", "detail-solved segments, by outcome",
    ("outcome",))
_m_segcache = metrics.counter(
    "solver_segcache_total",
    "per-solve segment-cache lookups during chain scoring", ("outcome",))
_m_candidates = metrics.counter(
    "solver_candidates_total",
    "inter-layer segment candidates, by pruning stage", ("stage",))
_m_chains = metrics.counter(
    "solver_chains_total", "candidate chains, by scoring outcome",
    ("outcome",))
_m_solve_seconds = metrics.histogram(
    "solver_solve_seconds", "end-to-end network solve wall clock",
    ("entry",))


@dataclasses.dataclass
class NetworkSchedule:
    graph_name: str
    chain: Optional[Chain]
    layer_schemes: Dict[str, LayerScheme]
    layer_costs: Dict[str, CostBreakdown]
    total_energy_pj: float
    total_latency_cycles: float
    solve_seconds: float
    prune_stats: Optional[PruneStats] = None
    # per-chain-segment fine-grained-pipelining flags (aligned with
    # chain.segments): whether the segment runs overlapped (granule
    # forwarding) or degraded to coarse time-sharing.  Recorded so a
    # deserialized schedule can be re-scored bit-identically without
    # re-running the intra-layer solver (``rescore``).
    seg_pipelined: Optional[Tuple[bool, ...]] = None
    # the solver flight-recorder block (obs.explain): candidate funnel,
    # per-term cost attribution, runners-up.  A plain JSON-safe dict so
    # it round-trips through to_json/from_json and therefore persists
    # inside ScheduleStore records untouched.  None unless the solve ran
    # with explain enabled — the default keeps solves overhead-free.
    explain: Optional[Dict] = None

    @property
    def valid(self) -> bool:
        return self.total_energy_pj != float("inf")

    def scheme(self, layer_name: str) -> LayerScheme:
        """The solved intra-layer scheme for one layer (KeyError if the
        layer was not scheduled)."""
        return self.layer_schemes[layer_name]

    def lower(self, graph: LayerGraph, hw: HWTemplate, repair: bool = True):
        """Compile this schedule into an executable ``NetworkPlan`` (the
        network lowering tier; see ``repro.lower.netplan``).  Imported
        lazily so the numpy-only solver core never pulls in jax."""
        from ...lower.netplan import lower_network
        return lower_network(self, graph, hw, repair=repair)

    def to_graph(self) -> LayerGraph:
        """Rebuild a ``LayerGraph`` from the layer specs embedded in the
        schemes, in schedule order — lets a store-loaded schedule be
        re-scored or lowered without the original graph object (the
        schemes' dict order is the solve's topological order)."""
        return LayerGraph(self.graph_name,
                          [s.layer for s in self.layer_schemes.values()])

    # -- re-scoring ----------------------------------------------------------
    def rescore(self, graph: Optional[LayerGraph] = None,
                hw: Optional[HWTemplate] = None
                ) -> Tuple[float, float, Dict[str, CostBreakdown]]:
        """Recompute (total_energy_pj, total_latency_cycles, layer_costs)
        from the stored schemes by replaying the chain's segment context —
        io flags, the recorded pipelined/coarse choice, granule combining.
        Bit-identical to the original solve for schedules produced by
        ``solve`` (the store's parity gate).  ``hw`` is required; ``graph``
        defaults to ``to_graph()``."""
        if hw is None:
            raise ValueError("rescore needs the HWTemplate the schedule "
                             "was solved for")
        graph = graph if graph is not None else self.to_graph()
        consumers = _consumer_map(graph)
        if self.chain is None or not self.chain.segments:
            costs = {n: evaluate_layer(s, hw)
                     for n, s in self.layer_schemes.items()}
            e = sum(c.energy_pj for c in costs.values())
            lat = sum(c.latency_cycles for c in costs.values())
            return e, lat, costs
        pipe = self.seg_pipelined if self.seg_pipelined is not None \
            else tuple(False for _ in self.chain.segments)
        energy = 0.0
        latency = 0.0
        costs: Dict[str, CostBreakdown] = {}
        for seg, pipelined in zip(self.chain.segments, pipe):
            seg_layers = graph.layers[seg.start:seg.stop]
            names = {l.name for l in seg_layers}
            seg_costs: List[CostBreakdown] = []
            for i, layer in enumerate(seg_layers):
                src_on, dst_on = io_flags(graph, names, layer, consumers)
                nodes = seg.alloc[i][0] * seg.alloc[i][1]
                c = evaluate_layer(
                    self.layer_schemes[layer.name], hw,
                    nodes_assigned=nodes,
                    src_onchip=src_on if pipelined else False,
                    dst_onchip=dst_on if pipelined else False)
                costs[layer.name] = c
                seg_costs.append(c)
            granules = max(1, int(round(1.0 / seg.granule_frac))) \
                if pipelined else 1
            total = combine_segment(seg_costs, granules=granules)
            if not pipelined and seg.length > 1:
                total.latency_cycles = sum(c.latency_cycles
                                           for c in seg_costs)
            energy += total.energy_pj
            latency += total.latency_cycles
        return energy, latency, costs

    # -- JSON (de)serialization ----------------------------------------------
    def to_json(self) -> Dict:
        """Serializable form of the whole solved schedule: per-layer schemes
        (with embedded layer specs), per-layer cost breakdowns, and the
        chosen inter-layer chain — enough to cache a solve or ship it to an
        executor without re-running the solver."""
        chain = None
        if self.chain is not None:
            pipe = self.seg_pipelined if self.seg_pipelined is not None \
                else tuple(None for _ in self.chain.segments)
            chain = [{"start": s.start, "stop": s.stop,
                      "alloc": [list(a) for a in s.alloc],
                      "granule_frac": s.granule_frac,
                      "pipelined": p}
                     for s, p in zip(self.chain.segments, pipe)]
        return {
            "graph_name": self.graph_name,
            "chain": chain,
            "chain_est_cost": None if self.chain is None
            else self.chain.est_cost,
            "layer_schemes": {n: s.to_json()
                              for n, s in self.layer_schemes.items()},
            "layer_costs": {n: dataclasses.asdict(c)
                            for n, c in self.layer_costs.items()},
            "total_energy_pj": self.total_energy_pj,
            "total_latency_cycles": self.total_latency_cycles,
            "solve_seconds": self.solve_seconds,
            "prune_stats": None if self.prune_stats is None
            else dataclasses.asdict(self.prune_stats),
            "explain": self.explain,
        }

    @staticmethod
    def from_json(d: Dict, graph: Optional[LayerGraph] = None
                  ) -> "NetworkSchedule":
        """Rebuild a schedule; pass ``graph`` to re-bind schemes to existing
        ``LayerSpec`` objects (names must match) instead of reconstructing
        them from the embedded JSON.  Fully functional without a live graph
        (store reads): ``to_graph``/``rescore``/``lower`` all work off the
        embedded specs."""
        from .interlayer import SegmentScheme
        chain = None
        pipelined: Optional[Tuple[bool, ...]] = None
        if d.get("chain") is not None:
            chain = Chain(segments=tuple(
                SegmentScheme(start=s["start"], stop=s["stop"],
                              alloc=tuple(tuple(a) for a in s["alloc"]),
                              granule_frac=s["granule_frac"])
                for s in d["chain"]),
                est_cost=d.get("chain_est_cost") or 0.0)
            flags = [s.get("pipelined") for s in d["chain"]]
            if all(f is not None for f in flags):
                pipelined = tuple(bool(f) for f in flags)
        schemes = {}
        for name, sj in d["layer_schemes"].items():
            layer = graph.by_name[name] if graph is not None else None
            schemes[name] = LayerScheme.from_json(sj, layer=layer)
        costs = {n: CostBreakdown(**c)
                 for n, c in d.get("layer_costs", {}).items()}
        stats = d.get("prune_stats")
        return NetworkSchedule(
            graph_name=d["graph_name"], chain=chain, layer_schemes=schemes,
            layer_costs=costs,
            total_energy_pj=d["total_energy_pj"],
            total_latency_cycles=d["total_latency_cycles"],
            solve_seconds=d.get("solve_seconds", 0.0),
            prune_stats=None if stats is None else PruneStats(**stats),
            seg_pipelined=pipelined, explain=d.get("explain"))


def solve_segment(graph: LayerGraph, hw: HWTemplate, seg, consumers,
                  layer_solver=solve_intra_layer,
                  ) -> Tuple[Optional[CostBreakdown],
                             Dict[str, LayerScheme],
                             Dict[str, CostBreakdown], bool]:
    """Solve every layer of one segment with ``layer_solver``.

    If fine-grained pipelining turns out infeasible at the intra-layer level
    (the conservative inter-layer check is allowed false positives, §IV-B),
    the segment degrades to coarse time-sharing of the same node regions.
    Returns (total, schemes, costs, pipelined)."""
    with trace.span("solve.segment", graph=graph.name,
                    seg=f"{seg.start}:{seg.stop}") as sp:
        total, schemes, costs, pipelined = _solve_segment_impl(
            graph, hw, seg, consumers, layer_solver)
        outcome = "infeasible" if total is None else \
            "pipelined" if pipelined else "coarse"
        sp.set(outcome=outcome)
    _m_segments.inc(outcome=outcome)
    return total, schemes, costs, pipelined


def _solve_segment_impl(graph: LayerGraph, hw: HWTemplate, seg, consumers,
                        layer_solver):
    # chaos hook: a seeded injector can crash ("error") or stall ("slow")
    # this segment solve — thread-pool workers inherit the global injector
    inject.maybe_fault("solve.segment",
                       key=f"{graph.name}:{seg.start}:{seg.stop}")
    seg_layers = graph.layers[seg.start:seg.stop]
    names = {l.name for l in seg_layers}
    for pipelined in ((True, False) if seg.length > 1 else (False,)):
        schemes: Dict[str, LayerScheme] = {}
        costs: Dict[str, CostBreakdown] = {}
        seg_costs: List[CostBreakdown] = []
        ok = True
        for i, layer in enumerate(seg_layers):
            src_on, dst_on = io_flags(graph, names, layer, consumers)
            if pipelined:
                constr = Constraints(
                    nodes=seg.alloc[i], src_onchip=src_on, dst_onchip=dst_on,
                    full_reduction_onchip=dst_on and seg.length > 1,
                    outer_dims=("N",) if seg.length > 1 else ())
            else:
                constr = Constraints(nodes=seg.alloc[i])
            scheme, cost = layer_solver(layer, hw, constr)
            if scheme is None or not cost.valid:
                ok = False
                break
            schemes[layer.name] = scheme
            costs[layer.name] = cost
            seg_costs.append(cost)
        if not ok:
            continue
        granules = max(1, int(round(1.0 / seg.granule_frac))) if pipelined \
            else 1
        total = combine_segment(seg_costs, granules=granules)
        if not pipelined and seg.length > 1:
            # coarse time-sharing: stages run back-to-back, not overlapped
            total.latency_cycles = sum(c.latency_cycles for c in seg_costs)
        return total, schemes, costs, pipelined
    return None, {}, {}, False


def _seg_key(seg) -> Tuple:
    return seg.key


def _chain_key(chain: Chain) -> Tuple:
    return chain.key


def seed_chains_from(schedule: NetworkSchedule, graph: LayerGraph
                     ) -> List[Chain]:
    """Warm-start candidate chains derived from a previously solved
    schedule of the same graph *family* (identical layer structure, any
    batch size): the stored segment slicing and node allocations are
    reused, with pipelined granule fractions re-derived for the new
    graph's batch dimension.  Returns [] when the stored chain does not
    tile this graph's layer list."""
    from .interlayer import SegmentScheme
    if schedule.chain is None or not schedule.chain.segments:
        return []
    segs = schedule.chain.segments
    n = len(graph.layers)
    expect = 0
    for s in segs:
        if s.start != expect or s.stop > n:
            return []
        expect = s.stop
    if expect != n:
        return []
    out = []
    for s in segs:
        gf = 1.0 if s.granule_frac >= 1.0 \
            else 1.0 / graph.layers[s.start].dim("N")
        out.append(SegmentScheme(s.start, s.stop, s.alloc, gf))
    return [Chain(segments=tuple(out), est_cost=0.0)]


def rebatch_scheme(stored: LayerScheme,
                   layer: LayerSpec) -> Optional[LayerScheme]:
    """Adapt a stored intra-layer scheme to a layer identical except in
    batch (N): spatial N unrolling is preserved exactly, temporal N
    factors are re-fit inner -> outer (each level keeps the largest
    divisor of the remaining batch it held before — shrinking a temporal
    tile only shrinks footprints, so capacity validity is preserved), and
    the outermost level absorbs the leftover.  Returns None when the new
    batch does not cover the stored spatial unrolling — the caller falls
    back to a real intra-layer solve; the judge re-scores the result
    either way."""
    levels = [lv.copy() for lv in stored.levels]
    spatial = 1
    for lv in levels:
        spatial *= lv.sf("N")
    new_n = layer.dim("N")
    if spatial <= 0 or new_n % spatial:
        return None
    r = new_n // spatial
    for lv in levels[:-1]:
        keep = math.gcd(lv.tf("N"), r)
        if keep > 1:
            lv.t["N"] = keep
        else:
            lv.t.pop("N", None)
        r //= keep
    levels[-1].t["N"] = r
    return LayerScheme(layer, levels)


def scheme_transfers(scheme: LayerScheme, layer: LayerSpec,
                     constr: Constraints) -> bool:
    """Whether a rebatched scheme satisfies the *solver-side* constraints
    the judge does not check: forwarding granularity (outer_dims leading
    the DRAM order) and full on-chip reduction for pipelined producers."""
    top = scheme.levels[-1]
    if constr.full_reduction_onchip and \
            any(top.tf(d) > 1 for d in layer.reduction_dims):
        return False
    if constr.outer_dims and \
            tuple(top.order[:len(constr.outer_dims)]) \
            != tuple(constr.outer_dims):
        return False
    return True


def warm_layer_solver(stored_schemes: Dict[str, LayerScheme],
                      layer_solver=solve_intra_layer):
    """An intra-layer solver that *transfers* stored schemes first: the
    stored scheme for the layer's name is rebatched to the requested
    layer, checked against the inter-layer constraints, and scored with
    the detailed judge — replacing a greedy solve + order enumeration
    with a single evaluation.  Layers without a transferable scheme fall
    through to ``layer_solver``.  This is what makes a family near-miss
    (same graph, different batch) a *warm* start rather than a re-solve.
    """
    def solver(layer: LayerSpec, hw: HWTemplate, constr: Constraints):
        stored = stored_schemes.get(layer.name)
        if stored is not None:
            cand = rebatch_scheme(stored, layer)
            if cand is not None and scheme_transfers(cand, layer, constr):
                cost = evaluate_layer(cand, hw,
                                      nodes_assigned=constr.num_nodes,
                                      src_onchip=constr.src_onchip,
                                      dst_onchip=constr.dst_onchip)
                if cost.valid:
                    return cand, cost
        return layer_solver(layer, hw, constr)
    return solver


def _invalid_schedule(graph: LayerGraph,
                      stats: Optional[PruneStats]) -> NetworkSchedule:
    return NetworkSchedule(graph.name, None, {}, {}, float("inf"),
                           float("inf"), 0.0, stats)


def _chain_score(energy: float, latency: float, objective: str) -> float:
    return energy if objective == "energy" else energy * latency \
        if objective == "edp" else latency


def _pool_solve_segments(jobs: Sequence[Tuple], hw: HWTemplate,
                         max_workers: Optional[int]) -> None:
    """Detail-solve distinct segments, possibly spanning several graphs, in
    one shared ThreadPoolExecutor (the intra-layer judge is numpy-bound and
    releases the GIL; the memo layer is thread-safe).  ``jobs`` are
    (graph, consumers, seg_cache, distinct, layer_solver) tuples; results
    land in each job's seg_cache dict."""
    flat = []
    for graph, consumers, seg_cache, distinct, solver in jobs:
        for key, seg in distinct.items():
            flat.append((graph, consumers, seg_cache, key, seg, solver))
    workers = max_workers if max_workers is not None else \
        min(8, os.cpu_count() or 1)
    workers = max(1, min(workers, len(flat) or 1))
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs = [(seg_cache, key,
                     ex.submit(solve_segment, graph, hw, seg, consumers,
                               solver))
                    for graph, consumers, seg_cache, key, seg, solver
                    in flat]
            for seg_cache, key, f in futs:
                seg_cache[key] = f.result()
    else:
        for graph, consumers, seg_cache, key, seg, solver in flat:
            seg_cache[key] = solve_segment(graph, hw, seg, consumers,
                                           solver)


def _solve_chain(graph: LayerGraph, hw: HWTemplate, chain: Chain,
                 layer_solver=solve_intra_layer,
                 seg_cache: Optional[Dict] = None,
                 consumers: Optional[Dict] = None,
                 ) -> Tuple[float, float, Dict[str, LayerScheme],
                            Dict[str, CostBreakdown], Tuple[bool, ...]]:
    consumers = consumers if consumers is not None else _consumer_map(graph)
    energy = 0.0
    latency = 0.0
    schemes: Dict[str, LayerScheme] = {}
    costs: Dict[str, CostBreakdown] = {}
    pipelined: List[bool] = []
    for seg in chain.segments:
        # k_S candidate chains share most of their segments: solve each
        # distinct (range, alloc, granule) segment once per solve() call
        key = _seg_key(seg)
        if seg_cache is not None and key in seg_cache:
            _m_segcache.inc(outcome="hit")
            seg_total, seg_schemes, seg_costs, pipe = seg_cache[key]
        else:
            if seg_cache is not None:
                _m_segcache.inc(outcome="miss")
            seg_total, seg_schemes, seg_costs, pipe = solve_segment(
                graph, hw, seg, consumers, layer_solver)
            if seg_cache is not None:
                seg_cache[key] = (seg_total, seg_schemes, seg_costs, pipe)
        if seg_total is None:
            return float("inf"), float("inf"), {}, {}, ()
        schemes.update(seg_schemes)
        costs.update(seg_costs)
        pipelined.append(pipe)
        energy += seg_total.energy_pj
        latency += seg_total.latency_cycles
    return energy, latency, schemes, costs, tuple(pipelined)


def _record_prune(stats: PruneStats, before: Tuple[int, int, int]
                  ) -> None:
    """Publish one DP run's candidate funnel (enumerated -> validity ->
    Pareto-kept) as counter deltas against the pre-run snapshot."""
    _m_candidates.inc(stats.total - before[0], stage="enumerated")
    _m_candidates.inc(stats.after_validity - before[1], stage="valid")
    _m_candidates.inc(stats.after_pareto - before[2], stage="kept")


def _candidate_chains(graph: LayerGraph, hw: HWTemplate, k_s: int,
                      max_seg_len: int, objective: str,
                      stats: PruneStats,
                      seed_chains: Optional[Sequence[Chain]],
                      use_dp: bool, explain=None) -> List[Chain]:
    """DP-prioritized chains plus deduplicated warm-start seeds (seeds
    first, so ties between a seed and an identical DP chain keep the
    seed's detail solve)."""
    chains: List[Chain] = list(seed_chains or ())
    if use_dp or not chains:
        chains = chains + dp_prioritize(graph, hw, k_s=k_s,
                                        max_seg_len=max_seg_len,
                                        objective=objective, stats=stats,
                                        explain=explain)
    seen = set()
    uniq = []
    for c in chains:
        key = _chain_key(c)
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    return uniq


#: runners-up captured into an explain record (cost deltas only — the
#: losing chains' detail solves are not persisted)
EXPLAIN_MAX_RUNNERS_UP = 8


def _finish_explain(sink, graph: LayerGraph, hw: HWTemplate,
                    objective: str,
                    scored: Sequence[Tuple[float, int, "NetworkSchedule"]],
                    best: "NetworkSchedule") -> Dict:
    """Fill the winner / runners-up sections of an explain sink from one
    ``solve_topk`` scoring pass and return the finished record."""
    sink.set("graph", graph.name)
    sink.set("objective", objective)
    pipe = best.seg_pipelined or ()
    segments: List[Dict] = []
    if best.chain is not None:
        for i, seg in enumerate(best.chain.segments):
            seg_layers = graph.layers[seg.start:seg.stop]
            seg_attr = attribute_costs(
                best.layer_costs[l.name] for l in seg_layers
                if l.name in best.layer_costs)
            segments.append({
                "start": seg.start, "stop": seg.stop,
                "alloc": [list(a) for a in seg.alloc],
                "granule_frac": seg.granule_frac,
                "pipelined": bool(pipe[i]) if i < len(pipe) else None,
                "attribution": seg_attr})
    costs = list(best.layer_costs.values())
    cyc = {"cyc_compute": 0.0, "cyc_dram": 0.0, "cyc_gbuf": 0.0}
    for name, c in best.layer_costs.items():
        macs = best.layer_schemes[name].layer.total_macs()
        for k_, v in cycle_terms(c, macs, hw).items():
            cyc[k_] += v
    grid_h, grid_w = hw.node_array
    n_costs = max(1, len(costs))
    winner = {
        "score": _chain_score(best.total_energy_pj,
                              best.total_latency_cycles, objective),
        "energy_pj": best.total_energy_pj,
        "latency_cycles": best.total_latency_cycles,
        "segments": segments,
        "attribution": attribute_costs(costs),
        "cycle_terms": cyc,
        "occupancy": {
            "avg_pes_used": sum(c.pes_used for c in costs) / n_costs,
            "avg_nodes_used": sum(c.nodes_used for c in costs) / n_costs,
            "grid_nodes": grid_h * grid_w,
            "pes_per_node": hw.num_pes_per_node,
        },
    }
    sink.set_winner(winner)
    runners: List[Dict] = []
    for rank, (score, _, sched) in enumerate(
            scored[1:1 + EXPLAIN_MAX_RUNNERS_UP], start=2):
        delta = score - winner["score"]
        runners.append({
            "rank": rank, "score": score, "delta": delta,
            "delta_frac": delta / winner["score"] if winner["score"]
            else 0.0,
            "segments": [] if sched.chain is None else
            [{"start": s.start, "stop": s.stop,
              "granule_frac": s.granule_frac}
             for s in sched.chain.segments]})
    sink.set_runners_up(runners)
    # the funnel groups of the winning chain, for the rendered table
    funnel = sink.record.get("funnel")
    if funnel and best.chain is not None:
        want = {(s.start, s.stop) for s in best.chain.segments}
        funnel["winner_groups"] = [
            g for g in funnel.get("groups", ())
            if (g["start"], g["stop"]) in want]
    return sink.to_json()


def solve_topk(graph: LayerGraph, hw: HWTemplate, k: int = 1,
               k_s: int = 4, max_seg_len: int = 4,
               objective: str = "energy", layer_solver=solve_intra_layer,
               max_workers: Optional[int] = None,
               seed_chains: Optional[Sequence[Chain]] = None,
               use_dp: bool = True,
               stats_out: Optional[PruneStats] = None,
               explain=False) -> List[NetworkSchedule]:
    """The k best valid chains, each detail-solved into a full
    ``NetworkSchedule``, best first (detailed-model score under
    ``objective``).  ``solve`` is the ``k=1`` argmin special case; the
    autotuner re-ranks the returned candidates by *measured* runtime.

    ``seed_chains`` prepends warm-start candidate chains (see
    ``seed_chains_from``); ``use_dp=False`` skips the DP entirely and
    detail-solves only the seeds — the store's warm path, trading
    optimality for speed.  ``stats_out``, when given, receives the prune
    counters even when no valid schedule exists (the returned list is
    then empty).

    ``explain`` turns on the solver flight recorder: pass ``True`` (or
    an ``obs.explain.ExplainSink`` to share across tiers) and the best
    schedule's ``.explain`` carries the candidate funnel, per-term cost
    attribution and runners-up — persisted through ``to_json`` into
    store records.  Off by default: the disabled path adds nothing."""
    t0 = time.perf_counter()
    stats = stats_out if stats_out is not None else PruneStats()
    sink = None
    if explain:
        from ...obs.explain import ExplainSink
        sink = explain if isinstance(explain, ExplainSink) \
            else ExplainSink()
    k_eff = max(k_s, k)
    before = (stats.total, stats.after_validity, stats.after_pareto)
    with trace.span("solve.dp", graph=graph.name, k_s=k_eff):
        chains = _candidate_chains(graph, hw, k_eff, max_seg_len,
                                   objective, seed_chains=seed_chains,
                                   stats=stats, use_dp=use_dp,
                                   explain=sink)
    _record_prune(stats, before)
    consumers = _consumer_map(graph)
    # the chains share most of their segments: collect the distinct ones up
    # front and solve them in parallel before the (cheap) chain scoring
    distinct: Dict[Tuple, object] = {}
    for chain in chains:
        for seg in chain.segments:
            distinct.setdefault(_seg_key(seg), seg)
    seg_cache: Dict = {}
    with trace.span("solve.segments_pool", graph=graph.name,
                    n=len(distinct)):
        _pool_solve_segments([(graph, consumers, seg_cache, distinct,
                               layer_solver)], hw, max_workers)
    scored: List[Tuple[float, int, NetworkSchedule]] = []
    with trace.span("solve.chain_score", graph=graph.name,
                    n=len(chains)):
        for ci, chain in enumerate(chains):
            e, lat, schemes, costs, pipe = _solve_chain(
                graph, hw, chain, layer_solver, seg_cache, consumers)
            score = _chain_score(e, lat, objective)
            if score == float("inf"):
                _m_chains.inc(outcome="infeasible")
                continue
            _m_chains.inc(outcome="scored")
            scored.append((score, ci, NetworkSchedule(
                graph.name, chain, schemes, costs, e, lat, 0.0, stats,
                pipe)))
    scored.sort(key=lambda t: (t[0], t[1]))     # stable: DP order on ties
    out = [s for _, _, s in scored[:max(1, k)]]
    if sink is not None and out:
        out[0].explain = _finish_explain(sink, graph, hw, objective,
                                         scored, out[0])
    elapsed = time.perf_counter() - t0
    _m_solve_seconds.observe(elapsed, entry="topk")
    for s in out:
        s.solve_seconds = elapsed
    return out


def solve(graph: LayerGraph, hw: HWTemplate, k_s: int = 4,
          max_seg_len: int = 4, objective: str = "energy",
          layer_solver=solve_intra_layer,
          max_workers: Optional[int] = None,
          seed_chains: Optional[Sequence[Chain]] = None,
          use_dp: bool = True, explain=False) -> NetworkSchedule:
    """Two-level solve: batched inter-layer DP prioritization on top, then
    the k_S candidate chains' distinct segments detail-solved concurrently
    (the intra-layer judge is numpy-bound and releases the GIL, and the
    memo layer is thread-safe).  ``max_workers=1`` forces a serial solve.

    Pre-solving every distinct segment trades the old per-chain early-abort
    for parallelism; that abort was nearly dead code, since the coarse
    time-sharing fallback in ``solve_segment`` is valid by construction and
    segments therefore almost never fail outright."""
    t0 = time.perf_counter()
    stats = PruneStats()
    res = solve_topk(graph, hw, k=1, k_s=k_s, max_seg_len=max_seg_len,
                     objective=objective, layer_solver=layer_solver,
                     max_workers=max_workers, seed_chains=seed_chains,
                     use_dp=use_dp, stats_out=stats, explain=explain)
    if not res:
        best = _invalid_schedule(graph, stats)
        best.solve_seconds = time.perf_counter() - t0
        return best
    return res[0]


def greedy_chain(graph: LayerGraph, hw: HWTemplate) -> Chain:
    """The trivial chain: every layer alone in its own segment on the
    full node array, no pipelining.  Always tiles the graph, never needs
    the DP, and its segments are valid whenever *any* schedule is — the
    first-valid floor of the service's degradation ladder."""
    from .interlayer import SegmentScheme
    H, W = hw.node_array
    return Chain(segments=tuple(
        SegmentScheme(i, i + 1, ((H, W),), 1.0)
        for i in range(len(graph.layers))), est_cost=0.0)


def solve_greedy(graph: LayerGraph, hw: HWTemplate,
                 objective: str = "energy",
                 layer_solver=solve_intra_layer,
                 max_workers: Optional[int] = None,
                 **_opts) -> NetworkSchedule:
    """First-valid greedy solve: detail-solve only the trivial chain
    (``greedy_chain``), skipping the DP and the k_S candidate
    enumeration.  The cheapest answer the solver can produce — what a
    deadline-blown service request degrades to rather than timing out
    empty-handed.  Extra solver options (k_s, max_seg_len) are accepted
    and ignored so request options can be passed through unchanged."""
    return solve(graph, hw, k_s=1, max_seg_len=1, objective=objective,
                 layer_solver=layer_solver, max_workers=max_workers,
                 seed_chains=[greedy_chain(graph, hw)], use_dp=False)


def solve_many(items: Sequence[Tuple[LayerGraph, HWTemplate]],
               k_s: int = 4, max_seg_len: int = 4,
               objective: str = "energy", layer_solver=solve_intra_layer,
               max_workers: Optional[int] = None,
               seed_chains: Optional[Sequence[Optional[Sequence[Chain]]]]
               = None, seeds_only: bool = True,
               layer_solvers: Optional[Sequence] = None,
               ) -> List[NetworkSchedule]:
    """Solve several (graph, hw) requests together: each request's DP runs
    first (vectorized, cheap), then the distinct detail-solve segments of
    *all* requests are pooled into one ThreadPoolExecutor pass — the
    schedule server's coalescing batch path.  Layers repeated across
    requests (same canonical signature + hw) additionally collapse in the
    intra-layer memo.  ``seed_chains[i]``, when given, warm-starts request
    ``i``; with ``seeds_only`` (the default, matching ``LocalClient``'s
    warm path) a seeded request skips its DP entirely and detail-solves
    just the seeds.  ``layer_solvers[i]`` overrides the intra-layer solver
    per request (e.g. ``warm_layer_solver`` transferring stored schemes)."""
    t0 = time.perf_counter()
    per: List[Tuple] = []
    jobs = []
    for i, (graph, hw) in enumerate(items):
        stats = PruneStats()
        seeds = seed_chains[i] if seed_chains is not None else None
        solver = layer_solvers[i] if layer_solvers is not None \
            and layer_solvers[i] is not None else layer_solver
        with trace.span("solve.dp", graph=graph.name, k_s=k_s):
            chains = _candidate_chains(graph, hw, k_s, max_seg_len,
                                       objective, stats, seeds,
                                       use_dp=not (seeds and seeds_only))
        _record_prune(stats, (0, 0, 0))
        consumers = _consumer_map(graph)
        distinct: Dict[Tuple, object] = {}
        for chain in chains:
            for seg in chain.segments:
                distinct.setdefault(_seg_key(seg), seg)
        seg_cache: Dict = {}
        per.append((graph, hw, chains, consumers, seg_cache, stats,
                    solver))
        jobs.append((graph, consumers, seg_cache, distinct, solver))
    # hw is shared per pooled pass in practice; solve per-request hw anyway
    # by grouping jobs on hw identity
    by_hw: Dict[HWTemplate, List] = {}
    for (graph, hw, *_), job in zip(per, jobs):
        by_hw.setdefault(hw, []).append(job)
    for hw_key, hw_jobs in by_hw.items():
        with trace.span("solve.segments_pool", n=len(hw_jobs)):
            _pool_solve_segments(hw_jobs, hw_key, max_workers)
    out: List[NetworkSchedule] = []
    elapsed = time.perf_counter() - t0
    for graph, hw, chains, consumers, seg_cache, stats, solver in per:
        best: Optional[Tuple[float, int, NetworkSchedule]] = None
        for ci, chain in enumerate(chains):
            e, lat, schemes, costs, pipe = _solve_chain(
                graph, hw, chain, solver, seg_cache, consumers)
            score = _chain_score(e, lat, objective)
            if score == float("inf"):
                _m_chains.inc(outcome="infeasible")
                continue
            _m_chains.inc(outcome="scored")
            if best is None or (score, ci) < (best[0], best[1]):
                best = (score, ci, NetworkSchedule(
                    graph.name, chain, schemes, costs, e, lat, elapsed,
                    stats, pipe))
        sched = best[2] if best is not None else \
            _invalid_schedule(graph, stats)
        sched.solve_seconds = elapsed
        out.append(sched)
    _m_solve_seconds.observe(elapsed, entry="many")
    return out
