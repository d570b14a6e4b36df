"""Multi-node tier: place a solved segment chain onto an N-node mesh.

KAPLA's scope is *scalable multi-node* accelerators; the intra-layer
(dataflow) and inter-layer (segment chain) tiers solve one node.  This
module is the third tier above them: given a solved ``NetworkSchedule``
it decides which node of an N-node mesh runs each chain segment, using
node-granular directives —

  ``stack``      consecutive chain segments grouped onto one node group
                 (a *part*); parts form a node-level pipeline;
  ``replicate``  a part duplicated across ``width`` nodes for
                 request-level throughput (round-robin dispatch; every
                 replica runs the identical full-batch kernels, so
                 results stay bit-identical wherever a request lands).

The tier has the same pragmatic prune-then-prioritize shape as the
inter-layer solver:

  validity   -> conservative pruning: a replicate width must divide the
                batch, parts must fit the node budget, and a boundary
                granule that overflows a node's aggregate GBUF demotes
                the link transfer to DRAM staging (a cost penalty, not
                a crash);
  efficiency -> inter-node link bandwidth and hop count are first-class
                cost terms (MAESTRO-style communication-aware costing:
                nodes are not free parallelism), and a top-k DP over
                (segments placed, nodes used) prioritizes candidates.

Per-segment intra/inter-layer schemes are **reused verbatim** from the
solved schedule — this tier only places them.  That is what makes
``repartition`` after a node loss incremental: parts whose nodes all
survive keep their assignments untouched, and only the dead nodes'
segments (the *dirty* set) are re-placed and re-scored.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ...hw.template import HWTemplate
from ...workloads.layers import LayerGraph
from ...runtime.fault import NodeFailure
from ..cost_model import combine_segment
from .interlayer import _consumer_map
from .kapla import NetworkSchedule

TOPOLOGIES = ("ring", "chain", "full")

OBJECTIVES = ("throughput", "latency", "energy")


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """The inter-node fabric: N identical nodes (each an ``HWTemplate``
    accelerator) joined by links of finite bandwidth.  ``hops`` is the
    routing distance the cost model charges per transferred byte."""

    nodes: int = 4
    link_bandwidth_bytes_per_cycle: float = 16.0
    link_energy_pj_per_byte: float = 2.0
    topology: str = "ring"

    def __post_init__(self):
        if self.nodes < 1:
            raise ValueError(f"mesh needs >= 1 node, got {self.nodes}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"one of {TOPOLOGIES}")
        if self.link_bandwidth_bytes_per_cycle <= 0:
            raise ValueError("link bandwidth must be positive")

    def hops(self, a: int, b: int) -> int:
        if a == b:
            return 0
        if self.topology == "full":
            return 1
        d = abs(a - b)
        return min(d, self.nodes - d) if self.topology == "ring" else d


@dataclasses.dataclass(frozen=True)
class SegmentCost:
    """One chain segment's solved cost + the byte totals the node tier
    charges to links: resident weights and boundary output size."""

    index: int
    start: int
    stop: int                              # [start, stop) into the order
    latency_cycles: float
    energy_pj: float
    weight_bytes: float
    out_bytes: float


@dataclasses.dataclass(frozen=True)
class NodeAssignment:
    """One part: a ``stack`` of consecutive chain segments on a node
    group, ``replicate``d across ``len(node_ids)`` nodes."""

    part: int
    seg_start: int                         # [seg_start, seg_stop) chain
    seg_stop: int                          # segment indices
    node_ids: Tuple[int, ...]
    compute_cycles: float
    energy_pj: float
    inbound_bytes: float
    inbound_hops: int                      # worst inbound routing distance
    link_cycles: float
    onchip_staged: bool

    @property
    def width(self) -> int:
        return len(self.node_ids)

    @property
    def stage_cycles(self) -> float:
        """Steady-state cycles this part adds per request: compute is
        amortized over replicas, link transfer is not."""
        return self.compute_cycles / max(1, self.width) + self.link_cycles


@dataclasses.dataclass
class MultiNodePruneStats:
    total: int = 0
    after_validity: int = 0
    kept: int = 0


@dataclasses.dataclass
class MultiNodePlan:
    """A solved placement of one schedule's chain onto a ``NodeMesh``."""

    graph_name: str
    mesh: NodeMesh
    parts: Tuple[NodeAssignment, ...]
    bottleneck_cycles: float               # slowest pipeline stage
    latency_cycles: float                  # one request end-to-end
    total_energy_pj: float                 # compute + link energy
    link_bytes: float
    est_cost: float
    objective: str = "throughput"
    prune: Optional[MultiNodePruneStats] = None

    @property
    def nodes_used(self) -> int:
        return len({n for p in self.parts for n in p.node_ids})

    @property
    def n_segments(self) -> int:
        return self.parts[-1].seg_stop if self.parts else 0

    def part_of_segment(self, seg_index: int) -> NodeAssignment:
        for p in self.parts:
            if p.seg_start <= seg_index < p.seg_stop:
                return p
        raise KeyError(f"segment {seg_index} is not placed "
                       f"(plan covers [0, {self.n_segments}))")

    def to_json(self) -> Dict:
        return {
            "graph": self.graph_name,
            "mesh": dataclasses.asdict(self.mesh),
            "objective": self.objective,
            "bottleneck_cycles": self.bottleneck_cycles,
            "latency_cycles": self.latency_cycles,
            "total_energy_pj": self.total_energy_pj,
            "link_bytes": self.link_bytes,
            "nodes_used": self.nodes_used,
            "parts": [{
                "segments": [p.seg_start, p.seg_stop],
                "node_ids": list(p.node_ids),
                "compute_cycles": p.compute_cycles,
                "link_cycles": p.link_cycles,
                "inbound_bytes": p.inbound_bytes,
                "inbound_hops": p.inbound_hops,
                "onchip_staged": p.onchip_staged,
            } for p in self.parts],
        }

    def describe(self) -> str:
        lines = [f"meshplan[{self.graph_name}] {len(self.parts)} parts "
                 f"on {self.nodes_used}/{self.mesh.nodes} nodes "
                 f"({self.mesh.topology}), "
                 f"bottleneck {self.bottleneck_cycles:.0f} cyc"]
        for p in self.parts:
            lines.append(
                f"  part{p.part} segs[{p.seg_start}:{p.seg_stop}) "
                f"nodes {list(p.node_ids)} "
                f"stage {p.stage_cycles:.0f} cyc "
                f"in {p.inbound_bytes:.0f}B/{p.inbound_hops}hop"
                + ("" if p.onchip_staged else " (DRAM-staged)"))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# solved per-segment costs + cross-segment tensor flows
# ---------------------------------------------------------------------------

def _chain_ranges(schedule: NetworkSchedule,
                  graph: LayerGraph) -> List[Tuple[int, int]]:
    """[start, stop) per chain segment — the same fallback rule as
    ``lower.netplan._segments`` (singletons without a chain), so part
    indices align with ``NetworkPlan.segments``."""
    if schedule.chain is not None and schedule.chain.segments:
        return [(s.start, s.stop) for s in schedule.chain.segments]
    return [(i, i + 1) for i in range(len(graph.layers))]


def segment_costs(schedule: NetworkSchedule,
                  graph: LayerGraph) -> List[SegmentCost]:
    """Per-chain-segment solved latency/energy (recomposed from the
    schedule's ``layer_costs`` via ``combine_segment`` — the schemes are
    reused, never re-solved) plus weight/output byte totals."""
    ranges = _chain_ranges(schedule, graph)
    segs = schedule.chain.segments \
        if schedule.chain is not None and schedule.chain.segments else None
    pipe = schedule.seg_pipelined or (True,) * len(ranges)
    consumers = _consumer_map(graph)
    out: List[SegmentCost] = []
    for i, (start, stop) in enumerate(ranges):
        layers = graph.layers[start:stop]
        costs = [schedule.layer_costs.get(l.name) for l in layers]
        if all(c is not None and c.valid for c in costs):
            gfrac = segs[i].granule_frac if segs else 1.0
            granules = max(1, round(1.0 / gfrac)) \
                if (i < len(pipe) and pipe[i] and gfrac > 0) else 1
            total = combine_segment(costs, granules)
            lat, en = total.latency_cycles, total.energy_pj
        elif segs is not None:
            lat, en = segs[i].est_latency, segs[i].est_energy
        else:
            lat, en = 0.0, 0.0
        wbytes = sum(l.tensor_size("W") * l.bytes_per_elem
                     for l in layers if "W" in l.tensors)
        names = {l.name for l in layers}
        obytes = sum(l.tensor_size("O") * l.bytes_per_elem for l in layers
                     if not consumers[l.name]
                     or any(c not in names for c in consumers[l.name]))
        out.append(SegmentCost(i, start, stop, lat, en, wbytes, obytes))
    return out


def cross_segment_bytes(graph: LayerGraph,
                        ranges: Sequence[Tuple[int, int]]
                        ) -> Dict[Tuple[int, int], float]:
    """``(src_seg, dst_seg) -> bytes`` for every tensor produced in one
    chain segment and consumed in a later one (the traffic that crosses
    inter-node links when the segments land on different parts)."""
    seg_of: Dict[str, int] = {}
    for i, (start, stop) in enumerate(ranges):
        for l in graph.layers[start:stop]:
            seg_of[l.name] = i
    consumers = _consumer_map(graph)
    flows: Dict[Tuple[int, int], float] = {}
    for l in graph.layers:
        si = seg_of[l.name]
        ob = l.tensor_size("O") * l.bytes_per_elem
        for dst in {seg_of[c] for c in consumers[l.name] if c in seg_of}:
            if dst != si:
                flows[(si, dst)] = flows.get((si, dst), 0.0) + ob
    return flows


# ---------------------------------------------------------------------------
# candidate scoring (shared by the DP and incremental repartition)
# ---------------------------------------------------------------------------

#: raw candidate: (seg_start, seg_stop, node_ids) per part
_RawParts = Tuple[Tuple[int, int, Tuple[int, ...]], ...]


def _score_parts(raw: _RawParts, segcosts: Sequence[SegmentCost],
                 flows: Dict[Tuple[int, int], float], mesh: NodeMesh,
                 hw: HWTemplate) -> Tuple[Tuple[NodeAssignment, ...],
                                          float, float, float, float]:
    """-> (parts, bottleneck, latency, energy, link_bytes) for a raw
    placement.  Link transfer is charged bytes x hops / bandwidth; a
    boundary granule too large for the destination node's aggregate
    GBUF (double-buffered) is DRAM-staged: same traffic at half the
    effective link bandwidth plus a DRAM touch per byte."""
    seg_part = {}
    for pi, (s0, s1, _) in enumerate(raw):
        for s in range(s0, s1):
            seg_part[s] = pi
    gbuf_budget = hw.gbuf.capacity_bytes * hw.num_nodes
    parts: List[NodeAssignment] = []
    energy = 0.0
    link_bytes = 0.0
    for pi, (s0, s1, node_ids) in enumerate(raw):
        compute = sum(segcosts[s].latency_cycles for s in range(s0, s1))
        en = sum(segcosts[s].energy_pj for s in range(s0, s1))
        # replicate directive: weights broadcast once per extra replica
        wbytes = sum(segcosts[s].weight_bytes for s in range(s0, s1))
        en += wbytes * (len(node_ids) - 1) * mesh.link_energy_pj_per_byte
        inbound = 0.0
        worst_hops = 0
        for (src, dst), b in flows.items():
            if seg_part.get(dst) != pi or seg_part.get(src) == pi:
                continue
            inbound += b
            src_node = raw[seg_part[src]][2][0]
            worst_hops = max(worst_hops,
                             mesh.hops(src_node, node_ids[0]))
        staged = 2.0 * inbound <= gbuf_budget
        bw = mesh.link_bandwidth_bytes_per_cycle * (1.0 if staged else 0.5)
        link_cycles = inbound * max(1, worst_hops) / bw
        en += inbound * max(1, worst_hops) * mesh.link_energy_pj_per_byte
        if not staged:
            en += inbound * hw.dram.access_energy_pj_per_byte * 2.0
        link_bytes += inbound
        energy += en
        parts.append(NodeAssignment(
            part=pi, seg_start=s0, seg_stop=s1, node_ids=node_ids,
            compute_cycles=compute, energy_pj=en, inbound_bytes=inbound,
            inbound_hops=worst_hops, link_cycles=link_cycles,
            onchip_staged=staged))
    bottleneck = max((p.stage_cycles for p in parts), default=0.0)
    latency = sum(p.compute_cycles + p.link_cycles for p in parts)
    return tuple(parts), bottleneck, latency, energy, link_bytes


def _cost_key(objective: str, bottleneck: float, latency: float,
              energy: float) -> Tuple[float, float]:
    if objective == "latency":
        return (latency, energy)
    if objective == "energy":
        return (energy, bottleneck)
    return (bottleneck, energy)


def _finish_plan(schedule: NetworkSchedule, raw: _RawParts,
                 segcosts: Sequence[SegmentCost],
                 flows: Dict[Tuple[int, int], float], mesh: NodeMesh,
                 hw: HWTemplate, objective: str,
                 prune: Optional[MultiNodePruneStats]) -> MultiNodePlan:
    parts, bottleneck, latency, energy, link_bytes = _score_parts(
        raw, segcosts, flows, mesh, hw)
    cost = _cost_key(objective, bottleneck, latency, energy)[0]
    return MultiNodePlan(
        graph_name=schedule.graph_name, mesh=mesh, parts=parts,
        bottleneck_cycles=bottleneck, latency_cycles=latency,
        total_energy_pj=energy, link_bytes=link_bytes, est_cost=cost,
        objective=objective, prune=prune)


# ---------------------------------------------------------------------------
# prune-then-prioritize DP (the inter-layer tier's shape, node-granular)
# ---------------------------------------------------------------------------

def plan_multinode(schedule: NetworkSchedule, graph: LayerGraph,
                   hw: HWTemplate, mesh: Optional[NodeMesh] = None,
                   k: int = 4,
                   objective: str = "throughput",
                   explain=None) -> MultiNodePlan:
    """Place ``schedule``'s chain segments onto ``mesh``.

    A DP over (chain segments placed, nodes consumed) enumerates every
    contiguous ``stack`` split and ``replicate`` width, prunes invalid
    candidates conservatively (width must divide the batch; parts must
    fit the node budget) and keeps the top-``k`` prefixes per state —
    the inter-layer tier's prune-then-prioritize shape, one level up.

    ``explain``, when an ``obs.explain.ExplainSink``, receives this
    tier's placement funnel (width candidates enumerated -> batch-
    divisibility valid -> DP-frontier kept) plus the winning placement
    and its frontier runners-up with cost deltas.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {OBJECTIVES}")
    mesh = mesh if mesh is not None else NodeMesh()
    if not graph.layers:
        raise ValueError(f"graph {graph.name!r} has no layers to place")
    segcosts = segment_costs(schedule, graph)
    ranges = [(c.start, c.stop) for c in segcosts]
    flows = cross_segment_bytes(graph, ranges)
    batch = graph.layers[0].dim("N")
    S = len(segcosts)
    stats = MultiNodePruneStats()

    # frontier[s] = top-k (cost_key, raw_parts, next_free_node) with the
    # first s chain segments placed; parts claim nodes left to right so
    # hop distances are concrete during the DP
    frontier: Dict[int, List[Tuple[Tuple[float, float],
                                   _RawParts, int]]] = {0: [((0.0, 0.0),
                                                             (), 0)]}
    for stop in range(1, S + 1):
        cands: List[Tuple[Tuple[float, float], _RawParts, int]] = []
        for start in range(stop):
            for _, raw, free in frontier.get(start, ()):
                avail = mesh.nodes - free
                if avail < 1:
                    continue
                for width in range(1, avail + 1):
                    stats.total += 1
                    if batch % width:
                        continue            # replicate validity: the
                    stats.after_validity += 1  # batch must split evenly
                    node_ids = tuple(range(free, free + width))
                    new_raw = raw + ((start, stop, node_ids),)
                    _, bottleneck, latency, energy, _ = _score_parts(
                        new_raw, segcosts, flows, mesh, hw)
                    cands.append((_cost_key(objective, bottleneck,
                                            latency, energy),
                                  new_raw, free + width))
        cands.sort(key=lambda c: (c[0], len(c[1]), c[2]))
        frontier[stop] = cands[:max(1, k)]
        stats.kept += len(frontier[stop])
    if not frontier.get(S):
        raise NodeFailure(
            f"no valid placement of {S} segments on {mesh.nodes} "
            f"node(s) for graph {graph.name!r}", permanent=True)
    _, best_raw, _ = frontier[S][0]
    if explain is not None:
        best_cost = float(frontier[S][0][0][0])
        runners = []
        for rank, (ck, raw, _) in enumerate(frontier[S][1:], start=2):
            delta = float(ck[0]) - best_cost
            runners.append({
                "rank": rank, "cost": float(ck[0]), "delta": delta,
                "delta_frac": delta / best_cost if best_cost else 0.0,
                "parts": [[s0, s1, list(nodes)]
                          for s0, s1, nodes in raw]})
        explain.set_multinode({
            "mesh": dataclasses.asdict(mesh),
            "objective": objective,
            "funnel": {"total": stats.total,
                       "after_validity": stats.after_validity,
                       "kept": stats.kept},
            "winner": {"cost": best_cost,
                       "parts": [[s0, s1, list(nodes)]
                                 for s0, s1, nodes in best_raw]},
            "runners_up": runners,
        })
    return _finish_plan(schedule, best_raw, segcosts, flows, mesh, hw,
                        objective, stats)


# ---------------------------------------------------------------------------
# incremental repartition after node loss
# ---------------------------------------------------------------------------

def repartition(plan: MultiNodePlan, schedule: NetworkSchedule,
                graph: LayerGraph, hw: HWTemplate,
                survivors: Sequence[int]
                ) -> Tuple[MultiNodePlan, List[int]]:
    """Re-place ``plan`` onto the surviving nodes, **incrementally**.

    Parts whose nodes all survive keep their assignments verbatim; a
    part that lost replicas shrinks its width (largest batch divisor of
    the survivors); a part that lost every node moves whole to the
    least-loaded survivor.  Only the moved/shrunk parts' chain segments
    are returned as *dirty* — their per-segment schemes are still reused
    from the schedule; nothing below this tier is re-solved.

    -> (new plan, sorted dirty chain-segment indices).  Raises
    ``NodeFailure`` (permanent) when no nodes survive.
    """
    surv = sorted(set(survivors))
    if not surv:
        raise NodeFailure("no surviving nodes to repartition onto",
                          lost_devices=plan.mesh.nodes, permanent=True)
    bad = [n for n in surv if not 0 <= n < plan.mesh.nodes]
    if bad:
        raise ValueError(f"survivors {bad} outside mesh "
                         f"[0, {plan.mesh.nodes})")
    batch = graph.layers[0].dim("N")
    sset = set(surv)
    load = {n: 0.0 for n in surv}
    for p in plan.parts:
        alive = [n for n in p.node_ids if n in sset]
        for n in alive:
            load[n] += p.compute_cycles / len(alive)
    raw: List[Tuple[int, int, Tuple[int, ...]]] = []
    dirty: List[int] = []
    for p in plan.parts:
        alive = [n for n in p.node_ids if n in sset]
        if tuple(alive) == p.node_ids:
            raw.append((p.seg_start, p.seg_stop, p.node_ids))
            continue
        if alive:
            width = len(alive)
            while batch % width:
                width -= 1                  # keep replicate validity
            node_ids = tuple(alive[:width])
        else:
            target = min(surv, key=lambda n: load[n])
            load[target] += p.compute_cycles
            node_ids = (target,)
        raw.append((p.seg_start, p.seg_stop, node_ids))
        dirty.extend(range(p.seg_start, p.seg_stop))
    segcosts = segment_costs(schedule, graph)
    flows = cross_segment_bytes(graph, [(c.start, c.stop)
                                        for c in segcosts])
    new_plan = _finish_plan(schedule, tuple(raw), segcosts, flows,
                            plan.mesh, hw, plan.objective, plan.prune)
    return new_plan, sorted(set(dirty))


__all__ = ["NodeMesh", "SegmentCost", "NodeAssignment", "MultiNodePlan",
           "MultiNodePruneStats", "segment_costs", "cross_segment_bytes",
           "plan_multinode", "repartition", "TOPOLOGIES", "OBJECTIVES"]
