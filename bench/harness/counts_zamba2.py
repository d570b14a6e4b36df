"""Operations and bytes of the published Zamba2's training step, counted
from its configuration's shapes alone (``counts.py``'s rules: a product
of an [m, k] and a [k, n] operand is 2 m k n operations; causal work
counts only the entries at or below the diagonal; a kernel's bytes count
each input read once and each output written once)."""
from __future__ import annotations

from typing import Mapping

from ..reference import zamba2
from .counts import bound_s, peaks

__all__ = ["attention_flops", "flash_bound_s", "flash_counts",
           "forward_flops", "matmul_params", "peaks", "ssd_chunk_flops",
           "train_step_flops"]


def matmul_params(cfg: Mapping) -> float:
    """The weights a token is multiplied by once: each Mamba layer's
    projections, every use of a shared block (its attention and gated MLP)
    with its site's adapter and linear, and the LM head (the embedding's
    gather is no product)."""
    k = zamba2.dims(cfg)
    d, di, H, A, F_, r = k["d"], k["di"], k["H"], k["A"], k["F"], k["r"]
    GN = k["G"] * k["N"]
    mamba = d * (2 * di + 2 * GN + H) + di * d
    site = 3 * A * A + A * d + d * 2 * F_ + F_ * d + d * r + r * 2 * F_ \
        + d * d
    return float(k["L"] * mamba + k["sites"] * site + d * k["V"])


def ssd_chunk_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """One Mamba layer's scan in chunks of 128: each group's causal C B^T
    and each head's product of it with the inputs within a chunk, each
    chunk's state and the states' products with C."""
    k = zamba2.dims(cfg)
    H, P, N, G = k["H"], k["P"], k["N"], k["G"]
    Lc = min(128, seq)
    chunks = -(-seq // Lc)
    tri = Lc * (Lc + 1) / 2
    intra = G * 2 * tri * N + H * 2 * tri * P
    state = 2 * Lc * H * P * N * 2
    return float(batch * chunks * (intra + state))


def attention_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """One site's causal attention: q k^T and p v over the key positions
    at or below each query's."""
    k = zamba2.dims(cfg)
    tri = seq * (seq + 1) / 2
    return float(batch * k["heads"] * 2 * 2 * tri * k["hd"])


def forward_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """A forward pass over ``batch`` sequences of ``seq`` tokens."""
    k = zamba2.dims(cfg)
    return (2 * matmul_params(cfg) * batch * seq
            + k["L"] * ssd_chunk_flops(cfg, batch, seq)
            + k["sites"] * attention_flops(cfg, batch, seq))


def train_step_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """A training step: the forward and a backward of twice its work."""
    return 3 * forward_flops(cfg, batch, seq)


def flash_counts(cfg: Mapping, batch: int, seq: int):
    """(operations, bytes) of one flash forward of a site: the causal
    products, and q, k, v and the output in bfloat16 read or written once
    with the float32 log-sum-exp a row."""
    k = zamba2.dims(cfg)
    qkvo = 4 * batch * k["heads"] * seq * k["hd"] * 2
    return attention_flops(cfg, batch, seq), \
        float(qkvo + 4 * batch * k["heads"] * seq)


def flash_bound_s(cfg: Mapping, batch: int, seq: int) -> float:
    """The flash forward's least time a call: its operations at the bf16
    dense peak or its bytes at the HBM peak, the larger."""
    p = peaks()
    return bound_s(*flash_counts(cfg, batch, seq), p["bf16_flops_s"],
                   p["hbm_bytes_s"])
