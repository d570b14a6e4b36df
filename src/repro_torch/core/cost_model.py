"""Detailed analytical cost model (the stand-in for the nn-dataflow simulator).

Given a complete ``LayerScheme`` on an ``HWTemplate``, produce energy (pJ) and
latency (cycles) with per-component breakdowns.  This model is the *judge*:
all solvers (KAPLA, exhaustive, random, annealing) are scored with it.
KAPLA's internal guidance uses the cheaper optimistic estimates in
``estimate.py`` — mirroring the paper's separation of the two models.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..hw.template import HWTemplate
from .directives import LayerScheme


#: the per-term energy attribution order: these five fields sum to
#: ``energy_pj`` exactly (``evaluate_layer`` computes the total as their
#: sum), which is what lets the explain record's attribution reconcile
#: against a schedule's scored cost.
ENERGY_TERMS = ("mac_energy", "regf_energy", "gbuf_energy", "noc_energy",
                "dram_energy")


@dataclasses.dataclass
class CostBreakdown:
    valid: bool
    energy_pj: float = float("inf")
    latency_cycles: float = float("inf")
    mac_energy: float = 0.0
    regf_energy: float = 0.0
    gbuf_energy: float = 0.0
    noc_energy: float = 0.0
    dram_energy: float = 0.0
    dram_traffic_bytes: float = 0.0
    gbuf_traffic_bytes: float = 0.0       # per-node fill traffic
    pes_used: int = 0
    nodes_used: int = 0
    reason: str = ""

    def edp(self) -> float:
        return self.energy_pj * self.latency_cycles

    def attribution(self) -> Dict[str, float]:
        """Per-term energy attribution; values sum to ``energy_pj``."""
        return {t: getattr(self, t) for t in ENERGY_TERMS}


def attribute_costs(costs) -> Dict[str, float]:
    """Aggregate per-term attribution across breakdowns (a segment's or
    a whole schedule's ``layer_costs``).  The returned terms sum to the
    summed ``energy_pj`` up to float association order — the explain
    record's reconciliation invariant; ``total_pj`` carries the summed
    ``energy_pj`` for cross-checking."""
    out = {t: 0.0 for t in ENERGY_TERMS}
    total = 0.0
    for c in costs:
        for t in ENERGY_TERMS:
            out[t] += getattr(c, t)
        total += c.energy_pj
    out["total_pj"] = total
    return out


def invalid(reason: str) -> CostBreakdown:
    return CostBreakdown(valid=False, reason=reason)


# ---------------------------------------------------------------------------
# Measured-runtime calibration (fit by repro.lower.calibrate against real
# kernel executions; optional — nothing in the solver path requires it).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-term scale coefficients mapping model cycle terms to measured
    seconds:  seconds ~= a_compute*cyc_compute + a_dram*cyc_dram
    + a_gbuf*cyc_gbuf + a_step*grid_steps + intercept.

    Fitted by ``repro.lower.calibrate.fit_calibration`` from a sweep of
    executed kernel plans; ``spearman`` records the rank correlation of the
    *uncalibrated* model against the measurements it was fitted on."""

    a_compute: float = 0.0
    a_dram: float = 0.0
    a_gbuf: float = 0.0
    a_step: float = 0.0
    intercept: float = 0.0
    spearman: float = 0.0
    n_pairs: int = 0
    backend: str = "interpret"     # execution backend the fit measured

    def to_json_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json_dict(d: Dict) -> "Calibration":
        fields = {f.name for f in dataclasses.fields(Calibration)}
        return Calibration(**{k: v for k, v in d.items() if k in fields})


# One fitted Calibration per execution backend (interpreter seconds and
# compiled-XLA seconds are different units — a fit from one must never
# price the other), plus the *active* backend ``predicted_seconds``
# consults by default.
_calibrations: Dict[str, Calibration] = {}
_active_backend: Optional[str] = None


def set_calibration(cal: Optional[Calibration],
                    backend: Optional[str] = None) -> None:
    """Install a calibration for its backend and make that backend the
    active one (or clear everything, with None).  The cycle-level model
    and all parity paths are unaffected — calibration only rescales
    cycles into wall seconds."""
    global _active_backend
    if cal is None:
        if backend is None:
            _calibrations.clear()
            _active_backend = None
        else:
            _calibrations.pop(backend, None)
            if _active_backend == backend:
                _active_backend = None
        return
    backend = backend if backend is not None else cal.backend
    _calibrations[backend] = cal
    _active_backend = backend


def get_calibration(backend: Optional[str] = None) -> Optional[Calibration]:
    """The installed calibration for ``backend`` (the active backend's
    when None)."""
    if backend is None:
        backend = _active_backend
    return _calibrations.get(backend) if backend is not None else None


def load_calibration(path: str,
                     backend: Optional[str] = None) -> Calibration:
    """Load a calibration record (``BENCH_calibration.json`` shape) and
    install it under its backend — the record's ``backend`` field wins
    unless overridden, so a compiled-backend sweep loads as compiled
    coefficients, never mislabeled as interpreter ones."""
    import json
    with open(path) as f:
        d = json.load(f)
    cal = Calibration.from_json_dict({
        "backend": d.get("backend", "interpret"),
        **d.get("calibration", d)})
    if backend is not None:
        cal = dataclasses.replace(cal, backend=backend)
    set_calibration(cal)
    return cal


def cycle_terms(cb: "CostBreakdown", macs: float, hw: HWTemplate
                ) -> Dict[str, float]:
    """Recover the roofline's component cycle counts from a breakdown (the
    stored ``latency_cycles`` keeps only their max)."""
    thruput = max(1, cb.pes_used * cb.nodes_used)
    return {
        "cyc_compute": macs / thruput,
        "cyc_dram": cb.dram_traffic_bytes
        / hw.levels[-1].bandwidth_bytes_per_cycle,
        "cyc_gbuf": cb.gbuf_traffic_bytes
        / hw.levels[1].bandwidth_bytes_per_cycle,
    }


def predicted_seconds(cb: "CostBreakdown", macs: float, hw: HWTemplate,
                      grid_steps: int = 0,
                      cal: Optional[Calibration] = None,
                      backend: Optional[str] = None) -> float:
    """Wall-clock latency prediction: calibrated when a ``Calibration`` is
    installed (or passed), otherwise raw cycles over the clock.  With
    ``backend`` the per-backend fit is consulted (e.g. compiled-backend
    coefficients instead of interpreter ones); invalid breakdowns predict
    inf (mirroring the batched path's valid-lane mask)."""
    if not cb.valid:
        return float("inf")
    cal = cal if cal is not None else get_calibration(backend)
    if cal is None:
        return cb.latency_cycles / hw.freq_hz
    t = cycle_terms(cb, macs, hw)
    return (cal.a_compute * t["cyc_compute"] + cal.a_dram * t["cyc_dram"]
            + cal.a_gbuf * t["cyc_gbuf"] + cal.a_step * grid_steps
            + cal.intercept)


def evaluate_layer(scheme: LayerScheme, hw: HWTemplate,
                   nodes_assigned: Optional[int] = None,
                   src_onchip: bool = False,
                   dst_onchip: bool = False) -> CostBreakdown:
    """Energy + latency for one layer under one intra-layer scheme.

    src_onchip / dst_onchip: the layer's input / output fmap tensor is
    forwarded on-chip from/to a pipelined neighbor layer (inter-layer spatial
    pipelining), replacing its DRAM traffic with NoC forwarding.
    """
    layer = scheme.layer
    B = layer.bytes_per_elem
    n_levels = len(hw.levels)
    if len(scheme.levels) != n_levels:
        return invalid("level count mismatch")
    if not scheme.validate_factors():
        return invalid("dim factors do not multiply to layer dims")

    # ---- validity: capacity & parallelism ----------------------------------
    for i in range(n_levels - 1):
        cap = hw.levels[i].capacity_bytes
        fp = scheme.level_footprint_bytes(i)
        if fp > cap:
            return invalid(f"{hw.levels[i].name} overflow {fp:.0f}B > {cap}B")
        s_prod = scheme.levels[i].s_product()
        avail = hw.levels[i + 1].num_units
        if s_prod > avail:
            return invalid(f"spatial {s_prod} > {avail} units at level {i}")
    nodes_used = scheme.levels[1].s_product() if n_levels >= 3 else 1
    if nodes_assigned is not None and nodes_used > nodes_assigned:
        return invalid(f"uses {nodes_used} nodes > {nodes_assigned} assigned")
    pes_used = scheme.levels[0].s_product()

    macs = layer.total_macs()
    cb = CostBreakdown(valid=True, energy_pj=0.0, pes_used=pes_used,
                       nodes_used=nodes_used)

    # ---- MAC + REGF compute-operand energy ---------------------------------
    op_e = hw.mac_energy_pj if layer.has_weights else 0.2 * hw.mac_energy_pj
    cb.mac_energy = macs * op_e
    e_regf = hw.levels[0].access_energy_pj_per_byte
    cb.regf_energy = macs * 3 * B * e_regf     # 2 operand reads + psum rw

    # ---- boundary REGF <- GBUF ---------------------------------------------
    e_gbuf = hw.levels[1].access_energy_pj_per_byte
    gbuf_fill = 0.0            # per-node elements read out of one GBUF
    for t in layer.tensors:
        f = scheme.fetches_into(t, 0)
        repl = scheme.replication(t, 0)
        mc = hw.levels[1].multicast
        reads = f if mc else f * repl
        delivered = f * repl
        gbuf_fill += reads
        cb.gbuf_energy += reads * B * e_gbuf
        cb.regf_energy += delivered * B * e_regf
        shr = scheme.levels[0].shr.get(t, 1)
        if shr > 1:            # systolic same-level forwarding between PEs
            cb.regf_energy += f * (shr - 1) * B * 2 * e_regf
    cb.gbuf_traffic_bytes = gbuf_fill * B

    # ---- boundary GBUF <- DRAM (or on-chip neighbor) ------------------------
    e_dram = hw.levels[-1].access_energy_pj_per_byte
    hops = hw.avg_noc_hops(nodes_used)
    e_hop = hw.noc_hop_energy_pj_per_byte
    dram_elems = 0.0
    for t in layer.tensors:
        f = scheme.fetches_into(t, 1)
        repl = scheme.replication(t, 1)
        delivered = f * repl
        onchip = (t == "I" and src_onchip) or (t == "O" and dst_onchip)
        if onchip:
            # forwarded between neighbor node GBUFs: one extra gbuf access +
            # short NoC path instead of a DRAM round trip
            cb.gbuf_energy += f * B * e_gbuf
            cb.noc_energy += delivered * B * e_hop * 2.0
        else:
            dram_elems += f
            cb.dram_energy += f * B * e_dram
            cb.noc_energy += delivered * B * e_hop * hops
        shr = scheme.levels[1].shr.get(t, 1)
        if shr > 1:            # buffer sharing rotation between node GBUFs
            cb.gbuf_energy += f * (shr - 1) * B * 2 * e_gbuf
            cb.noc_energy += f * (shr - 1) * B * e_hop
    cb.dram_traffic_bytes = dram_elems * B

    # ---- node-level spatial reduction (all-reduce of partial outputs) ------
    red_repl = 1
    for d in layer.reduction_dims:
        red_repl *= scheme.levels[1].sf(d)
    if red_repl > 1 and "O" in layer.tensors:
        psum = scheme.fetches_into("O", 1) * (red_repl - 1)
        cb.gbuf_energy += psum * B * 2 * e_gbuf
        cb.noc_energy += psum * B * e_hop

    cb.energy_pj = (cb.mac_energy + cb.regf_energy + cb.gbuf_energy +
                    cb.noc_energy + cb.dram_energy)

    # ---- latency: roofline over compute and each bandwidth ------------------
    mac_thruput = max(1, pes_used * nodes_used)
    cyc_compute = macs / mac_thruput
    cyc_dram = cb.dram_traffic_bytes / hw.levels[-1].bandwidth_bytes_per_cycle
    cyc_gbuf = cb.gbuf_traffic_bytes / hw.levels[1].bandwidth_bytes_per_cycle
    cyc_regf = (macs / mac_thruput) * B / hw.levels[0].bandwidth_bytes_per_cycle
    cb.latency_cycles = max(cyc_compute, cyc_dram, cyc_gbuf, cyc_regf)
    return cb


def combine_segment(costs, granules: int = 1) -> CostBreakdown:
    """Compose per-layer costs of one spatially-pipelined segment.

    Layers run concurrently on disjoint node regions; the segment latency is
    the slowest layer plus a pipeline-fill term of one forwarding granule per
    stage (finer granules => smaller fill, per the paper §III-A).
    """
    total = CostBreakdown(valid=True, energy_pj=0.0, latency_cycles=0.0)
    slowest = 0.0
    for c in costs:
        if not c.valid:
            return invalid("segment contains invalid layer: " + c.reason)
        total.energy_pj += c.energy_pj
        total.mac_energy += c.mac_energy
        total.regf_energy += c.regf_energy
        total.gbuf_energy += c.gbuf_energy
        total.noc_energy += c.noc_energy
        total.dram_energy += c.dram_energy
        total.dram_traffic_bytes += c.dram_traffic_bytes
        total.nodes_used += c.nodes_used
        slowest = max(slowest, c.latency_cycles)
    fill = slowest / max(1, granules) * max(0, len(list(costs)) - 1)
    total.latency_cycles = slowest + fill
    return total
