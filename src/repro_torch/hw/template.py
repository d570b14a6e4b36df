"""Generic hardware configuration template (KAPLA §III-C).

A machine is a hierarchy of memory levels (inner -> outer).  Each level has a
per-buffer capacity, bandwidth, per-byte access energy, a spatial array of
units *below* it (the PE array below GBUF, the node array below DRAM), and a
flag for whether same-level (neighbor) transfers are supported (systolic flow
at the PE level, buffer sharing at the node level).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MemLevel:
    name: str
    capacity_bytes: float          # per-buffer capacity (inf for DRAM)
    access_energy_pj_per_byte: float
    bandwidth_bytes_per_cycle: float
    # spatial array of units at this level (units each holding one buffer of
    # the *previous* (inner) level); (1, 1) for the innermost level.
    array: Tuple[int, int] = (1, 1)
    same_level_transfer: bool = False   # systolic / buffer-sharing support
    multicast: bool = True              # next-level bus/tree multicast

    @property
    def num_units(self) -> int:
        return self.array[0] * self.array[1]


@dataclasses.dataclass(frozen=True)
class HWTemplate:
    """levels are ordered inner -> outer, e.g. (REGF, GBUF, DRAM).

    ``levels[i].array`` is the fan-out of level-(i-1) buffers under one
    level-i buffer; e.g. GBUF.array = PE array shape, DRAM.array = node grid.
    """

    name: str
    levels: Tuple[MemLevel, ...]
    mac_energy_pj: float
    noc_hop_energy_pj_per_byte: float
    freq_hz: float
    pe_dataflow: str                    # 'row_stationary' | 'systolic'
    temporal_layer_pipe: bool = True
    spatial_layer_pipe: bool = True
    bytes_per_elem: int = 2
    # independent DRAM channels/ports. Estimator-only: the optimistic
    # lower bounds (estimate.py / estimate_batch.py) see an aggregate
    # off-chip bandwidth of dram.bandwidth_bytes_per_cycle * dram_ports;
    # the detailed judges keep modeling a single port pool.
    dram_ports: int = 1

    def __post_init__(self) -> None:
        if self.pe_dataflow not in ("row_stationary", "systolic"):
            raise ValueError(f"unknown pe_dataflow {self.pe_dataflow!r}")

    @property
    def regf(self) -> MemLevel:
        return self.levels[0]

    @property
    def gbuf(self) -> MemLevel:
        return self.levels[1]

    @property
    def dram(self) -> MemLevel:
        return self.levels[-1]

    @property
    def pe_array(self) -> Tuple[int, int]:
        return self.levels[1].array

    @property
    def node_array(self) -> Tuple[int, int]:
        return self.levels[-1].array

    @property
    def num_pes_per_node(self) -> int:
        return self.levels[1].num_units

    @property
    def num_nodes(self) -> int:
        return self.levels[-1].num_units

    @property
    def total_pes(self) -> int:
        return self.num_pes_per_node * self.num_nodes

    def avg_noc_hops(self, nodes_used):
        """Mean Manhattan hop count within a roughly-square region.

        Accepts a scalar or an array of node counts (the batched cost model
        scores many candidates at once) — keep this the single definition of
        the NoC hop formula for both the scalar and vectorized judges."""
        side = np.maximum(1.0, np.asarray(nodes_used, dtype=float) ** 0.5)
        hops = 2.0 * side / 3.0
        return float(hops) if np.ndim(nodes_used) == 0 else hops

    def with_(self, **updates) -> "HWTemplate":
        return dataclasses.replace(self, **updates)


# ---------------------------------------------------------------------------
# TPU-pod abstraction used by the JAX half of the framework (Half B).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPUPodSpec:
    """Roofline constants for the production target (per grading spec)."""

    name: str = "tpu_v5e_pod"
    peak_flops_bf16: float = 197e12          # per chip
    hbm_bw: float = 819e9                    # bytes/s per chip
    hbm_bytes: float = 16 * 2 ** 30          # per chip
    ici_link_bw: float = 50e9                # bytes/s per link
    ici_links_per_chip: int = 4              # 2D torus (v5e)
    dci_bw: float = 25e9                     # bytes/s per chip, pod-to-pod
    vmem_bytes: float = 128 * 2 ** 20 / 8    # ~16 MiB usable VMEM
    mxu_tile: Tuple[int, int] = (128, 128)
