"""Batched, vectorized detailed cost model.

Scores a whole *batch* of intra-layer scheme candidates for one
(layer, hardware, inter-layer context) at once with NumPy array math,
numerically identical (within fp tolerance) to the scalar reference judge
``cost_model.evaluate_layer``.  Candidates are packed into flat *factor
tables* — per-dim temporal/spatial factors per level, loop orders as
dim-index permutations, per-tensor sharing factors — instead of one
``LayerScheme`` object (with per-level dict copies) per candidate.

This is the hot path of every solver: KAPLA's final order x order x shr
enumeration, the exhaustive baseline's divisor-ladder sweep, and the
random/annealing baselines' sample batches all funnel through
``evaluate_batch``.  The scalar model remains the reference; parity is
enforced by ``tests/test_cost_batch.py``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..hw.template import HWTemplate
from ..workloads.layers import DIMS, LayerSpec
from .cost_model import CostBreakdown, invalid
from .directives import LayerScheme, LevelBlocking

DIM_IDX: Dict[str, int] = {d: i for i, d in enumerate(DIMS)}
ND = len(DIMS)


@functools.lru_cache(maxsize=None)
def pack_order(order: Sequence[str]) -> Tuple[Tuple[int, ...],
                                              Tuple[bool, ...]]:
    """Encode a loop order as (dim indices outer->inner, participation mask).

    Dims absent from ``order`` are appended as padding with mask False so
    every encoded order has exactly ``len(DIMS)`` positions; padded positions
    contribute factor 1 to the loop nest (mirroring the scalar model, which
    drops dims not listed in the order).
    """
    idx: List[int] = []
    seen = set()
    for d in order:
        di = DIM_IDX.get(d)
        if di is not None and di not in seen:
            idx.append(di)
            seen.add(di)
    mask = [True] * len(idx)
    for di in range(ND):
        if di not in seen:
            idx.append(di)
            mask.append(False)
    return tuple(idx), tuple(mask)


@dataclasses.dataclass
class FactorTable:
    """A batch of candidate schemes for one layer as flat integer arrays.

    All arrays share the trailing batch axis ``B``:

      t     [L, ND, B]  temporal blocking factor per level per dim
      s     [L, ND, B]  spatial unrolling factor per level per dim
      order [L, ND, B]  loop order as dim indices, outermost first
      omask [L, ND, B]  True where the order position is a real entry
      shr   [L, NT, B]  per-tensor sharing factor per level

    Tensor axis order is ``tensor_names`` (= iteration order of
    ``layer.tensors``).
    """

    layer: LayerSpec
    t: np.ndarray
    s: np.ndarray
    order: np.ndarray
    omask: np.ndarray
    shr: np.ndarray

    @property
    def n_levels(self) -> int:
        return self.t.shape[0]

    @property
    def batch(self) -> int:
        return self.t.shape[-1]

    @property
    def tensor_names(self) -> List[str]:
        return list(self.layer.tensors)

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_schemes(schemes: Sequence[LayerScheme]) -> "FactorTable":
        """Pack a list of ``LayerScheme`` (same layer shape, same level
        count) into one table via ``LayerScheme.factor_rows``."""
        if not schemes:
            raise ValueError("empty scheme batch")
        layer = schemes[0].layer
        tnames = list(layer.tensors)
        t_all, s_all, o_all, m_all, shr_all = [], [], [], [], []
        for sch in schemes:
            t_r, s_r, o_r, m_r, shr_r = sch.factor_rows(DIMS, tnames,
                                                        pack_order)
            t_all.append(t_r)
            s_all.append(s_r)
            o_all.append(o_r)
            m_all.append(m_r)
            shr_all.append(shr_r)
        # one bulk conversion [B, L, .] -> [L, ., B]
        return FactorTable(
            layer,
            t=np.asarray(t_all, dtype=np.int64).transpose(1, 2, 0),
            s=np.asarray(s_all, dtype=np.int64).transpose(1, 2, 0),
            order=np.asarray(o_all, dtype=np.int8).transpose(1, 2, 0),
            omask=np.asarray(m_all, dtype=bool).transpose(1, 2, 0),
            shr=np.asarray(shr_all, dtype=np.int64).transpose(1, 2, 0))

    def scheme_at(self, b: int) -> LayerScheme:
        """Materialize candidate ``b`` back into a ``LayerScheme``."""
        tnames = self.tensor_names
        levels = []
        for lv in range(self.n_levels):
            t = {DIMS[d]: int(self.t[lv, d, b]) for d in range(ND)
                 if self.t[lv, d, b] > 1}
            s = {DIMS[d]: int(self.s[lv, d, b]) for d in range(ND)
                 if self.s[lv, d, b] > 1}
            order = tuple(DIMS[int(self.order[lv, p, b])]
                          for p in range(ND) if self.omask[lv, p, b])
            shr = {tnames[ti]: int(self.shr[lv, ti, b])
                   for ti in range(len(tnames)) if self.shr[lv, ti, b] > 1}
            levels.append(LevelBlocking(t=t, s=s, order=order or
                                        LevelBlocking().order, shr=shr))
        return LayerScheme(self.layer, levels)


@dataclasses.dataclass
class BatchResult:
    """Vectorized ``CostBreakdown``: one entry per batch lane."""

    valid: np.ndarray              # bool
    energy_pj: np.ndarray          # inf on invalid lanes
    latency_cycles: np.ndarray     # inf on invalid lanes
    mac_energy: np.ndarray
    regf_energy: np.ndarray
    gbuf_energy: np.ndarray
    noc_energy: np.ndarray
    dram_energy: np.ndarray
    dram_traffic_bytes: np.ndarray
    gbuf_traffic_bytes: np.ndarray
    pes_used: np.ndarray
    nodes_used: np.ndarray

    def __len__(self) -> int:
        return len(self.valid)

    def breakdown(self, b: int) -> CostBreakdown:
        """Materialize lane ``b`` as a scalar ``CostBreakdown``."""
        if not self.valid[b]:
            return invalid("invalid candidate (batched)")
        return CostBreakdown(
            valid=True,
            energy_pj=float(self.energy_pj[b]),
            latency_cycles=float(self.latency_cycles[b]),
            mac_energy=float(self.mac_energy[b]),
            regf_energy=float(self.regf_energy[b]),
            gbuf_energy=float(self.gbuf_energy[b]),
            noc_energy=float(self.noc_energy[b]),
            dram_energy=float(self.dram_energy[b]),
            dram_traffic_bytes=float(self.dram_traffic_bytes[b]),
            gbuf_traffic_bytes=float(self.gbuf_traffic_bytes[b]),
            pes_used=int(self.pes_used[b]),
            nodes_used=int(self.nodes_used[b]))

    def best(self, objective: str = "energy") -> int:
        """Index of the first-best valid lane under ``objective``; -1 if no
        lane is valid."""
        if not self.valid.any():
            return -1
        score = self.energy_pj if objective == "energy" else \
            self.energy_pj * self.latency_cycles if objective == "edp" else \
            self.latency_cycles
        return int(np.argmin(score))

    def predicted_seconds(self, macs: float, hw: HWTemplate,
                          grid_steps=0, cal=None) -> np.ndarray:
        """Vectorized ``cost_model.predicted_seconds`` over all lanes:
        calibrated wall-clock predictions when a measured-runtime
        ``Calibration`` is installed (see ``repro.lower.calibrate``),
        otherwise raw cycles over the clock.  ``grid_steps`` may be a
        scalar or a per-lane array.  Invalid lanes stay inf."""
        from .cost_model import get_calibration
        cal = cal if cal is not None else get_calibration()
        if cal is None:
            return self.latency_cycles / hw.freq_hz
        thruput = np.maximum(1, self.pes_used * self.nodes_used)
        sec = (cal.a_compute * macs / thruput
               + cal.a_dram * self.dram_traffic_bytes
               / hw.levels[-1].bandwidth_bytes_per_cycle
               + cal.a_gbuf * self.gbuf_traffic_bytes
               / hw.levels[1].bandwidth_bytes_per_cycle
               + cal.a_step * np.asarray(grid_steps)
               + cal.intercept)
        return np.where(self.valid, sec, float("inf"))


def _nest_arrays(ft: FactorTable, level: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated temporal loop nest of all levels outer than ``level``,
    outermost position first: (factors [P, B], dim indices [P, B]).

    Positions whose dim is not part of the level's order contribute factor 1
    (exactly like the scalar ``_outer_nest`` which drops them)."""
    fs, ds = [], []
    for i in range(ft.n_levels - 1, level, -1):
        f = np.take_along_axis(ft.t[i], ft.order[i].astype(np.int64), axis=0)
        f = np.where(ft.omask[i], f, 1)
        fs.append(f)
        ds.append(ft.order[i])
    if not fs:
        B = ft.batch
        return (np.ones((0, B), dtype=np.int64),
                np.zeros((0, B), dtype=np.int8))
    return np.concatenate(fs, axis=0), np.concatenate(ds, axis=0)


def _rounds(nest_f: np.ndarray, nest_d: np.ndarray,
            relvec: np.ndarray) -> np.ndarray:
    """Vectorized ``_iters_to_innermost_relevant``: total nest iterations
    divided by the product of loops strictly inside the innermost loop over a
    relevant dim (factor-1 loops never count as relevant)."""
    if nest_f.shape[0] == 0:
        return np.ones(nest_f.shape[1], dtype=np.int64)
    rel_at = relvec[nest_d.astype(np.int64)] & (nest_f > 1)
    total = np.prod(nest_f, axis=0)
    # walking inner -> outer, keep multiplying while no relevant loop seen yet
    not_seen = np.logical_and.accumulate(~rel_at[::-1], axis=0)
    trailing = np.prod(np.where(not_seen, nest_f[::-1], 1), axis=0)
    return total // trailing


def evaluate_batch(ft: FactorTable, hw: HWTemplate,
                   nodes_assigned: Optional[int] = None,
                   src_onchip: bool = False,
                   dst_onchip: bool = False) -> BatchResult:
    """Vectorized mirror of ``cost_model.evaluate_layer`` over a batch.

    Requires a >= 3-level hierarchy (REGF / GBUF / DRAM shape), matching the
    boundary structure hard-coded in the scalar model.
    """
    layer = ft.layer
    n_levels = ft.n_levels
    if n_levels < 3:
        raise ValueError("evaluate_batch needs >= 3 memory levels")
    if len(hw.levels) != n_levels:
        raise ValueError("level count mismatch between table and hardware")
    B = layer.bytes_per_elem
    batch = ft.batch
    tnames = ft.tensor_names
    relmask = np.zeros((len(tnames), ND), dtype=bool)
    for ti, tn in enumerate(tnames):
        for d in layer.tensors[tn]:
            if d in DIM_IDX:
                relmask[ti, DIM_IDX[d]] = True

    ts = ft.t * ft.s                                  # [L, ND, B]
    cum = np.cumprod(ts, axis=0)                      # prod over levels <= l
    dims_total = np.array([layer.dim(d) for d in DIMS],
                          dtype=np.int64)[:, None]
    valid = np.all(cum[-1] == dims_total, axis=0)

    # per-level per-tensor tile sizes (own temporal in, own spatial out)
    ratio = cum / ft.s                                # float64 [L, ND, B]
    tile = np.empty((n_levels, len(tnames), batch))
    for ti, tn in enumerate(tnames):
        rel = relmask[ti]
        per_dim = np.where(rel[None, :, None], ratio, 1.0)
        tl = np.prod(per_dim, axis=1)                 # [L, B]
        tl = tl / np.maximum(1, ft.shr[:, ti, :])
        tl[0] *= layer.inner_unit(tn)
        tl[1:] *= layer.unit.get(tn, 1.0)
        tile[:, ti, :] = tl

    # ---- validity: capacity & parallelism ----------------------------------
    s_prod = np.prod(ft.s, axis=1)                    # [L, B]
    for i in range(n_levels - 1):
        fp = tile[i].sum(axis=0) * B
        valid &= fp <= hw.levels[i].capacity_bytes
        valid &= s_prod[i] <= hw.levels[i + 1].num_units
    nodes_used = s_prod[1]
    if nodes_assigned is not None:
        valid &= nodes_used <= nodes_assigned
    pes_used = s_prod[0]

    macs = layer.total_macs()
    zeros = np.zeros(batch)
    mac_e = np.empty(batch)
    regf_e = np.zeros(batch)
    gbuf_e = np.zeros(batch)
    noc_e = np.zeros(batch)
    dram_e = np.zeros(batch)

    # ---- MAC + REGF compute-operand energy ---------------------------------
    op_e = hw.mac_energy_pj if layer.has_weights else 0.2 * hw.mac_energy_pj
    mac_e[:] = macs * op_e
    e_regf = hw.levels[0].access_energy_pj_per_byte
    regf_e += macs * 3 * B * e_regf

    nest0_f, nest0_d = _nest_arrays(ft, 0)
    nest1_f, nest1_d = _nest_arrays(ft, 1)

    def fetches(ti: int, level: int) -> np.ndarray:
        nest_f, nest_d = (nest0_f, nest0_d) if level == 0 else \
            (nest1_f, nest1_d)
        rel = relmask[ti]
        shards = np.prod(np.where(rel[:, None], ft.s[level], 1), axis=0)
        rounds = _rounds(nest_f, nest_d, rel)
        base = tile[level, ti] * shards * rounds
        if tnames[ti] == "O" and layer.reduction_dims:
            rw_rel = rel.copy()
            for d in layer.reduction_dims:
                if d in DIM_IDX:
                    rw_rel[DIM_IDX[d]] = True
            rounds_rw = _rounds(nest_f, nest_d, rw_rel)
            base = np.where(rounds_rw > rounds,
                            tile[level, ti] * shards *
                            (2 * rounds_rw - rounds), base)
        return base

    def replication(ti: int, level: int) -> np.ndarray:
        rel = relmask[ti]
        return np.prod(np.where(rel[:, None], 1, ft.s[level]), axis=0)

    # ---- boundary REGF <- GBUF ---------------------------------------------
    e_gbuf = hw.levels[1].access_energy_pj_per_byte
    mc = hw.levels[1].multicast
    gbuf_fill = np.zeros(batch)
    for ti in range(len(tnames)):
        f = fetches(ti, 0)
        repl = replication(ti, 0)
        reads = f if mc else f * repl
        delivered = f * repl
        gbuf_fill += reads
        gbuf_e += reads * B * e_gbuf
        regf_e += delivered * B * e_regf
        shr = ft.shr[0, ti]
        regf_e += np.where(shr > 1, f * (shr - 1) * B * 2 * e_regf, zeros)
    gbuf_traffic = gbuf_fill * B

    # ---- boundary GBUF <- DRAM (or on-chip neighbor) ------------------------
    e_dram = hw.levels[-1].access_energy_pj_per_byte
    hops = hw.avg_noc_hops(nodes_used)
    e_hop = hw.noc_hop_energy_pj_per_byte
    dram_elems = np.zeros(batch)
    for ti, tn in enumerate(tnames):
        f = fetches(ti, 1)
        repl = replication(ti, 1)
        delivered = f * repl
        onchip = (tn == "I" and src_onchip) or (tn == "O" and dst_onchip)
        if onchip:
            gbuf_e += f * B * e_gbuf
            noc_e += delivered * B * e_hop * 2.0
        else:
            dram_elems += f
            dram_e += f * B * e_dram
            noc_e += delivered * B * e_hop * hops
        shr = ft.shr[1, ti]
        extra = shr > 1
        gbuf_e += np.where(extra, f * (shr - 1) * B * 2 * e_gbuf, zeros)
        noc_e += np.where(extra, f * (shr - 1) * B * e_hop, zeros)
    dram_traffic = dram_elems * B

    # ---- node-level spatial reduction (all-reduce of partial outputs) ------
    if "O" in layer.tensors and layer.reduction_dims:
        redvec = np.zeros(ND, dtype=bool)
        for d in layer.reduction_dims:
            if d in DIM_IDX:
                redvec[DIM_IDX[d]] = True
        red_repl = np.prod(np.where(redvec[:, None], ft.s[1], 1), axis=0)
        oi = tnames.index("O")
        psum = np.where(red_repl > 1,
                        fetches(oi, 1) * (red_repl - 1), zeros)
        gbuf_e += psum * B * 2 * e_gbuf
        noc_e += psum * B * e_hop

    energy = mac_e + regf_e + gbuf_e + noc_e + dram_e

    # ---- latency: roofline over compute and each bandwidth ------------------
    mac_thruput = np.maximum(1, pes_used * nodes_used)
    cyc_compute = macs / mac_thruput
    cyc_dram = dram_traffic / hw.levels[-1].bandwidth_bytes_per_cycle
    cyc_gbuf = gbuf_traffic / hw.levels[1].bandwidth_bytes_per_cycle
    cyc_regf = (macs / mac_thruput) * B / \
        hw.levels[0].bandwidth_bytes_per_cycle
    latency = np.maximum.reduce([cyc_compute, cyc_dram, cyc_gbuf, cyc_regf])

    inf = float("inf")
    return BatchResult(
        valid=valid,
        energy_pj=np.where(valid, energy, inf),
        latency_cycles=np.where(valid, latency, inf),
        mac_energy=mac_e, regf_energy=regf_e, gbuf_energy=gbuf_e,
        noc_energy=noc_e, dram_energy=dram_e,
        dram_traffic_bytes=dram_traffic, gbuf_traffic_bytes=gbuf_traffic,
        pes_used=pes_used, nodes_used=nodes_used)


def score_schemes(schemes: Sequence[LayerScheme], hw: HWTemplate,
                  nodes_assigned: Optional[int] = None,
                  src_onchip: bool = False,
                  dst_onchip: bool = False) -> BatchResult:
    """Pack + evaluate a list of schemes in one shot."""
    return evaluate_batch(FactorTable.from_schemes(schemes), hw,
                          nodes_assigned=nodes_assigned,
                          src_onchip=src_onchip, dst_onchip=dst_onchip)
