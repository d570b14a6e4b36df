"""KAPLA's fast, optimistic cost estimation (§IV-B).

These estimators deliberately ignore lower-level details and "approximate to
the optimistic cases if there is insufficient information", producing
(relatively tight) lower bounds used only to *prioritize* candidates — the
detailed model in ``cost_model.py`` is the judge.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..hw.template import HWTemplate
from ..workloads.layers import LayerSpec


@dataclasses.dataclass(frozen=True)
class LayerEstimate:
    valid: bool
    energy_lb_pj: float = float("inf")
    latency_lb_cycles: float = float("inf")
    dram_bytes_lb: float = float("inf")
    reason: str = ""


def min_buffer_requirement_bytes(layer: LayerSpec, granule_frac: float,
                                 src_onchip: bool, dst_onchip: bool) -> float:
    """Conservative minimum aggregated on-chip bytes for a pipelined layer.

    Only the forwarded fmap granules must be resident (double-buffered);
    weights may stream from DRAM.  Never overestimates => never rejects a
    valid inter-layer scheme (conservative pruning).
    """
    B = layer.bytes_per_elem
    req = 0.0
    if src_onchip:
        req += 2.0 * layer.ifmap_size() * granule_frac * B
    if dst_onchip:
        req += 2.0 * layer.ofmap_size() * granule_frac * B
    return req


def estimate_layer(layer: LayerSpec, hw: HWTemplate, nodes_assigned: int,
                   granule_frac: float = 1.0,
                   src_onchip: bool = False,
                   dst_onchip: bool = False) -> LayerEstimate:
    """Optimistic per-layer bound given only the inter-layer decisions."""
    B = layer.bytes_per_elem
    agg_gbuf = nodes_assigned * hw.gbuf.capacity_bytes
    need = min_buffer_requirement_bytes(layer, granule_frac, src_onchip,
                                        dst_onchip)
    if need > agg_gbuf:
        return LayerEstimate(False, reason=f"needs {need:.0f}B > "
                                           f"{agg_gbuf:.0f}B aggregated GBUF")

    macs = layer.total_macs()
    # DRAM lower bound: every non-forwarded tensor moves exactly once.
    dram_elems = 0.0
    gbuf_elems = 0.0
    for t in layer.tensors:
        sz = layer.tensor_size(t)
        gbuf_elems += sz
        if t == "I" and src_onchip:
            continue
        if t == "O" and dst_onchip:
            continue
        dram_elems += sz
    dram_bytes = dram_elems * B

    e = 0.0
    op_e = hw.mac_energy_pj if layer.has_weights else 0.2 * hw.mac_energy_pj
    e += macs * op_e
    e += macs * 3 * B * hw.levels[0].access_energy_pj_per_byte
    e += gbuf_elems * B * hw.levels[1].access_energy_pj_per_byte
    e += dram_bytes * hw.levels[-1].access_energy_pj_per_byte

    # optimistic utilization: all PEs of all assigned nodes are busy
    pes = nodes_assigned * hw.num_pes_per_node
    lat = max(macs / max(1, pes),
              dram_bytes / hw.levels[-1].bandwidth_bytes_per_cycle /
              max(1, hw.dram_ports))
    return LayerEstimate(True, energy_lb_pj=e, latency_lb_cycles=lat,
                         dram_bytes_lb=dram_bytes)
