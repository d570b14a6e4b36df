"""Operations and bytes that the work needs, counted from shapes alone,
and the data sheet's peaks they are held against (``peaks.json``).

Nothing here reads the program: the shapes come from a configuration's
file and a traffic mix.  A product of an [m, k] and a [k, n] operand is
2 m k n operations; a kernel's bytes count each input read once and each
output written once; causal work counts only the entries at or below the
diagonal.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

from ..reference import mamba2, resnet

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks() -> Dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def bound_s(ops: float, nbytes: float, rate: float, bw: float) -> float:
    """The least time: the larger of the operations at ``rate`` and the
    bytes at ``bw``."""
    return max(ops / rate, nbytes / bw)


# ---------------------------------------------------------------------------
# the network tier
# ---------------------------------------------------------------------------

def conv_counts(layer: Mapping, elem: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of one convolution layer: 2 N K C X Y R S;
    its input at the extent it reads, its weights and its output."""
    N, C, K = layer["N"], layer["C"], layer["K"]
    X, Y, R, S = layer["X"], layer["Y"], layer["R"], layer["S"]
    _, _, XI, YI = resnet.input_shape(layer)
    ops = 2.0 * N * K * C * X * Y * R * S
    nbytes = elem * (N * C * XI * YI + K * C * R * S + N * K * X * Y)
    return ops, float(nbytes)


def network_flops(cfg: Mapping) -> float:
    """A forward pass's operations in its products: every convolution and
    the classifier (pools and sums are not counted)."""
    total = 0.0
    for l in resnet.layers(cfg):
        if l["kind"] == "conv":
            total += conv_counts(l)[0]
        elif l["kind"] == "fc":
            total += 2.0 * l["N"] * l["C"] * l["K"]
    return total


def conv_bound_s(cfg: Mapping, rate: float, bw: float) -> float:
    """The least time of all a forward pass's convolutions, each bounded
    by itself."""
    return sum(bound_s(*conv_counts(l), rate, bw)
               for l in resnet.layers(cfg) if l["kind"] == "conv")


# ---------------------------------------------------------------------------
# the Mamba2 language model
# ---------------------------------------------------------------------------

def matmul_params(cfg: Mapping) -> float:
    """The weights a token is multiplied by once: each block's
    projections and the LM head (the embedding's gather is no product)."""
    k = mamba2.dims(cfg)
    d, di, H, N = k["d"], k["di"], k["H"], k["N"]
    return float(k["L"] * (d * (2 * di + 2 * N + H) + di * d) + d * k["V"])


def ssd_chunk_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """One Mamba layer's scan over ``seq`` positions in chunks of 128: the
    causal C B^T and its product with the inputs within each chunk, each
    chunk's state and the states' products with C."""
    k = mamba2.dims(cfg)
    H, P, N = k["H"], k["P"], k["N"]
    Lc = min(mamba2.SSD_CHUNK, seq)
    chunks = -(-seq // Lc)
    tri = Lc * (Lc + 1) / 2
    intra = 2 * tri * N + H * 2 * tri * P
    state = 2 * Lc * H * P * N * 2
    return float(batch * chunks * (intra + state))


def forward_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """A forward pass over ``batch`` sequences of ``seq`` tokens."""
    return (2 * matmul_params(cfg) * batch * seq
            + int(cfg["num_layers"]) * ssd_chunk_flops(cfg, batch, seq))


def train_step_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """A training step: the forward and a backward of twice its work."""
    return 3 * forward_flops(cfg, batch, seq)
