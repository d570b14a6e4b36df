"""Roofline-term extraction from compiled dry-run artifacts.

compute term    = per-device HLO FLOPs / peak_FLOP/s
memory term     = per-device HLO bytes accessed / HBM bandwidth
collective term = per-device collective operand bytes / (links x link bw)

``cost_analysis()`` on the partitioned module is already per-device; the
collective bytes come from parsing the compiled HLO text and summing operand
sizes of all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute ops (they are NOT in cost_analysis).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from ..hw.template import TPUPodSpec

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\([^)]*\)|(?:[a-z0-9_]+\[[^\]]*\][^ ]*))\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_SHAPE_RE = re.compile(r"(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|"
                       r"u64|c64|c128)\[([0-9,]*)\]")


def _shape_bytes(text: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Tuple[float, Dict[str, float]]:
    """Sum of result-shape bytes for every collective op in the (per-device)
    HLO module, by op kind."""
    per_kind: Dict[str, float] = {}
    total = 0.0
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue                      # avoid double counting start/done
        kind = m.group(1)
        lhs = line.split("=", 1)[0] + "=" + \
            line.split("=", 1)[1].split("(", 1)[0]
        b = _shape_bytes(lhs)
        per_kind[kind] = per_kind.get(kind, 0.0) + b
        total += b
    return total, per_kind


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    coll_by_kind: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float                  # 6*N*D (or 6*N_active*D)
    hlo_useful_ratio: float             # MODEL_FLOPS / (chips*HLO_FLOPs)
    bottleneck: str
    arg_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline the projected step achieves."""
        if self.step_time <= 0:
            return 0.0
        return self.t_compute / self.step_time

    def row(self) -> str:
        return (f"{self.arch:18s} {self.shape:12s} {self.mesh:10s} "
                f"{self.t_compute * 1e3:10.2f} {self.t_memory * 1e3:10.2f} "
                f"{self.t_collective * 1e3:10.2f} {self.bottleneck:10s} "
                f"{self.hlo_useful_ratio:8.3f} "
                f"{self.roofline_fraction * 100:7.1f}%")


HEADER = (f"{'arch':18s} {'shape':12s} {'mesh':10s} {'compute_ms':>10s} "
          f"{'memory_ms':>10s} {'coll_ms':>10s} {'bottleneck':10s} "
          f"{'useful':>8s} {'rl_frac':>8s}")


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            cost: Dict[str, float], hlo_text: str, model_flops: float,
            pod: TPUPodSpec = TPUPodSpec(),
            mem_stats=None, coll=None) -> RooflineReport:
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    if coll is not None:
        coll_dev, by_kind = coll      # while-aware counts from hlo_cost
    else:
        coll_dev, by_kind = collective_bytes(hlo_text)
    t_c = flops_dev / pod.peak_flops_bf16
    t_m = bytes_dev / pod.hbm_bw
    t_x = coll_dev / (pod.ici_link_bw * pod.ici_links_per_chip)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / max(1.0, flops_dev * chips)
    rep = RooflineReport(arch, shape_name, mesh_name, flops_dev, bytes_dev,
                         coll_dev, by_kind, t_c, t_m, t_x, model_flops,
                         useful, bottleneck)
    if mem_stats is not None:
        rep.arg_bytes_per_device = getattr(mem_stats,
                                           "argument_size_in_bytes", 0)
        rep.temp_bytes_per_device = getattr(mem_stats,
                                            "temp_size_in_bytes", 0)
    return rep


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens
    processed; decode processes global_batch tokens; backward adds 2x."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch
