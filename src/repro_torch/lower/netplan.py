"""Network-tier lowering: compile a whole solved ``NetworkSchedule`` into
an executable ``NetworkPlan``.

The layer tier (``plan.py``) turns one ``LayerScheme`` into one
``KernelPlan``; this module composes those per-layer plans along the
solver's *inter-layer* decisions — the chain's segment slicing, per-layer
node-region allocations and forwarding granularity — into an ordered plan
for the full graph plus a **buffer schedule**:

  * outputs of **segment-internal** layers (every consumer lives in the
    same chain segment) are *forwarded on-chip*: the executor hands the
    producing kernel's output directly to the consumer kernel, never
    materializing it through a host round-trip — the execution analogue of
    the directive model replacing DRAM traffic with NoC forwarding
    (``evaluate_layer(src_onchip/dst_onchip)``);
  * **segment-boundary** tensors round-trip through host arrays, the
    execution analogue of a DRAM store + reload.

A forwarded tensor is only scheduled on-chip when its double-buffered
granule (``LayerScheme.forward_bytes``) fits the *spare* aggregated GBUF
capacity of the producer's node region — capacity minus the footprint the
scheme itself already occupies.  Tensors that do not fit are demoted to a
host round-trip with the reason recorded, mirroring how the solver's
conservative inter-layer validity check is allowed false positives
(§IV-B): the network plan stays executable, just less pipelined.

This module is numpy-only (no jax); execution lives in ``netexec.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..hw.template import HWTemplate
from ..workloads.layers import LayerGraph
from ..core.solver.interlayer import _consumer_map
from .plan import KernelPlan, lower_scheme

#: kinds the network executor can feed from predecessor outputs (attention
#: layers take Q/K/V triples, which layer graphs do not model as edges)
NETWORK_EXEC_KINDS = ("conv", "fc", "pool", "eltwise")


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One chain segment resolved to layer names + node regions."""

    index: int
    start: int
    stop: int                              # [start, stop) into the order
    layer_names: Tuple[str, ...]
    alloc: Tuple[Tuple[int, int], ...]     # node region (h, w) per layer
    granule_frac: float

    @property
    def length(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class TensorPlacement:
    """Where one layer's output tensor lives between producer and
    consumers: forwarded on-chip within a segment, or round-tripped
    through a host array (the DRAM analogue)."""

    producer: str
    consumers: Tuple[str, ...]
    segment: int
    forwarded: bool
    granule_bytes: float = 0.0             # double-buffered forwarded bytes
    spare_bytes: float = 0.0               # producer region's spare GBUF
    reason: str = ""                       # why not forwarded


@dataclasses.dataclass
class NetworkPlan:
    """A fully-resolved execution recipe for one solved network: ordered
    kernel plans, the segment structure, and the buffer schedule."""

    graph_name: str
    order: Tuple[str, ...]                 # topological layer order
    plans: Dict[str, KernelPlan]
    segments: Tuple[SegmentPlan, ...]
    placements: Dict[str, TensorPlacement]
    predicted_latency_cycles: float
    predicted_energy_pj: float

    @property
    def executable(self) -> bool:
        return not self.invalid_layers()

    def invalid_layers(self) -> List[Tuple[str, str]]:
        """(layer name, reason) for every layer that cannot execute."""
        out = [(n, self.plans[n].invalid_reason) for n in self.order
               if not self.plans[n].valid]
        out += [(n, f"kind {self.plans[n].kind!r} has no network-exec "
                 "input feed") for n in self.order
                if self.plans[n].valid
                and self.plans[n].kind not in NETWORK_EXEC_KINDS]
        for n in self.order:
            src = self.plans[n].layer.src
            in_graph = sum(1 for s in src if s in self.plans)
            if 0 < in_graph < len(src):
                # the executor feeds a layer EITHER from its in-graph
                # producers OR from one external input — a mix would
                # silently drop the external operand
                out.append((n, "mix of in-graph and external sources "
                            f"{tuple(src)} is not executable"))
        return out

    def forwarded(self) -> Tuple[str, ...]:
        """Names of outputs handed on-chip (never host round-tripped)."""
        return tuple(n for n in self.order if self.placements[n].forwarded)

    def segment_of(self, name: str) -> SegmentPlan:
        return self.segments[self.placements[name].segment]

    def describe(self) -> str:
        lines = [f"netplan[{self.graph_name}] {len(self.order)} layers, "
                 f"{len(self.segments)} segments, "
                 f"{len(self.forwarded())} forwarded tensors"]
        for seg in self.segments:
            marks = []
            for n in seg.layer_names:
                p = self.placements[n]
                marks.append(n + (" ->onchip" if p.forwarded else ""))
            lines.append(f"  seg{seg.index} gf={seg.granule_frac:g} "
                         f"[{', '.join(marks)}]")
        bad = self.invalid_layers()
        if bad:
            lines.append("  NOT EXECUTABLE: " +
                         "; ".join(f"{n}: {r}" for n, r in bad))
        return "\n".join(lines)


def _segments(schedule, graph: LayerGraph) -> List[SegmentPlan]:
    """Chain segments resolved to names; without a chain (deserialized or
    degenerate schedules) every layer becomes its own singleton segment."""
    names = [l.name for l in graph.layers]
    if schedule.chain is not None and schedule.chain.segments:
        return [SegmentPlan(i, s.start, s.stop,
                            tuple(names[s.start:s.stop]), s.alloc,
                            s.granule_frac)
                for i, s in enumerate(schedule.chain.segments)]
    return [SegmentPlan(i, i, i + 1, (n,), ((1, 1),), 1.0)
            for i, n in enumerate(names)]


def lower_network(schedule, graph: LayerGraph, hw: HWTemplate,
                  repair: bool = True) -> NetworkPlan:
    """Compile a solved ``NetworkSchedule`` into a ``NetworkPlan``.

    Layers missing a scheme (partial schedules) and unsupported kinds come
    back as invalid kernel plans with reasons — the plan reports them via
    ``invalid_layers()`` instead of raising, so callers can see exactly
    what is and is not executable.
    """
    consumers = _consumer_map(graph)
    segs = _segments(schedule, graph)
    seg_of: Dict[str, int] = {}
    for seg in segs:
        for n in seg.layer_names:
            seg_of[n] = seg.index

    plans: Dict[str, KernelPlan] = {}
    for layer in graph.layers:
        scheme = schedule.layer_schemes.get(layer.name)
        if scheme is None:
            from .plan import _invalid
            from ..core.directives import LayerScheme
            plans[layer.name] = _invalid(
                LayerScheme(layer, []), layer.kind, "no solved scheme")
        else:
            plans[layer.name] = lower_scheme(scheme, hw, repair=repair)

    gbuf_top = len(hw.levels) - 2          # outermost on-chip level
    cap = hw.levels[gbuf_top].capacity_bytes
    placements: Dict[str, TensorPlacement] = {}
    for li, layer in enumerate(graph.layers):
        name = layer.name
        cons = tuple(consumers.get(name, ()))
        seg = segs[seg_of[name]]
        common = dict(producer=name, consumers=cons, segment=seg.index)
        if not cons:
            placements[name] = TensorPlacement(
                forwarded=False, reason="network output", **common)
            continue
        if seg.length <= 1 or any(seg_of[c] != seg.index for c in cons):
            placements[name] = TensorPlacement(
                forwarded=False, reason="consumer crosses segment boundary",
                **common)
            continue
        plan = plans[name]
        if not plan.valid or any(not plans[c].valid for c in cons):
            placements[name] = TensorPlacement(
                forwarded=False, reason="producer/consumer plan invalid",
                **common)
            continue
        # double-buffered forwarded granule vs the producer region's spare
        # aggregated GBUF (capacity minus the scheme's own footprint)
        i = li - seg.start
        nodes = seg.alloc[i][0] * seg.alloc[i][1]
        need = 2.0 * plan.scheme.forward_bytes(seg.granule_frac)
        spare = nodes * max(0.0, cap
                            - plan.scheme.level_footprint_bytes(gbuf_top))
        if need > spare:
            placements[name] = TensorPlacement(
                forwarded=False, granule_bytes=need, spare_bytes=spare,
                reason=f"granule {need:.0f}B > spare GBUF {spare:.0f}B",
                **common)
            continue
        placements[name] = TensorPlacement(
            forwarded=True, granule_bytes=need, spare_bytes=spare, **common)

    return NetworkPlan(
        graph_name=schedule.graph_name,
        order=tuple(l.name for l in graph.layers),
        plans=plans, segments=tuple(segs), placements=placements,
        predicted_latency_cycles=schedule.total_latency_cycles,
        predicted_energy_pj=schedule.total_energy_pj)


def lower_cached(schedule, hw: HWTemplate,
                 graph: Optional[LayerGraph] = None,
                 repair: bool = True) -> NetworkPlan:
    """Lower a schedule that came back from the schedule store
    (``repro.service``): when no live ``graph`` is supplied, the layer
    graph is rebuilt from the specs embedded in the schedule's schemes
    (``NetworkSchedule.to_graph``) — cached schedules compile to
    executable plans without re-running the solver or keeping the
    original graph object around."""
    graph = graph if graph is not None else schedule.to_graph()
    return lower_network(schedule, graph, hw, repair=repair)
