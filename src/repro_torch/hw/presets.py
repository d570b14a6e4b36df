"""Hardware presets from KAPLA §V (Methodology) + the TPU-pod target.

Energy numbers follow the paper's modeling choices (16-bit MAC = 1 pJ, NoC =
0.61 pJ/bit/hop, McPAT-style SRAM/regfile energies, LPDDR4 DRAM).  Per-byte
figures are representative of the 28 nm magnitudes; relative ordering
(REGF << GBUF << NoC << DRAM) is what the solver comparisons depend on.
"""
from __future__ import annotations

from .template import HWTemplate, MemLevel, TPUPodSpec


def eyeriss_multinode(nodes: int = 16, pe: int = 8, regf_bytes: int = 64,
                      gbuf_bytes: int = 32 * 1024,
                      dram_ports: int = 1) -> HWTemplate:
    """16x16 nodes, each 8x8 PEs, 64 B REGF/PE, 32 kB GBUF/node (paper Fig 1).

    Row-stationary PE mapping, buffer sharing enabled at the node level.
    """
    return HWTemplate(
        name=f"eyeriss_{nodes}x{nodes}",
        levels=(
            MemLevel("REGF", regf_bytes, 0.06, 4.0),
            MemLevel("GBUF", gbuf_bytes, 0.6, 16.0, array=(pe, pe),
                     same_level_transfer=True),       # systolic-ish PE links
            MemLevel("DRAM", float("inf"), 32.0, 12.8, array=(nodes, nodes),
                     same_level_transfer=True),       # buffer sharing
        ),
        mac_energy_pj=1.0,
        noc_hop_energy_pj_per_byte=0.61 * 8,
        freq_hz=500e6,
        pe_dataflow="row_stationary",
        dram_ports=dram_ports)


def tpu_like_edge() -> HWTemplate:
    """Single node, 16x16 systolic PE array, 512 B REGF/PE, 256 kB GBUF."""
    return HWTemplate(
        name="tpu_edge",
        levels=(
            MemLevel("REGF", 512, 0.06, 4.0),
            MemLevel("GBUF", 256 * 1024, 1.2, 32.0, array=(16, 16),
                     same_level_transfer=True),
            MemLevel("DRAM", float("inf"), 32.0, 12.8, array=(1, 1)),
        ),
        mac_energy_pj=1.0,
        noc_hop_energy_pj_per_byte=0.61 * 8,
        freq_hz=500e6,
        pe_dataflow="systolic")


def tpu_v5e_pod() -> TPUPodSpec:
    return TPUPodSpec()


PRESETS = {
    "eyeriss_multinode": eyeriss_multinode,
    "tpu_like_edge": tpu_like_edge,
}
