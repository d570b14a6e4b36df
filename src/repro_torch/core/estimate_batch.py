"""Batched, vectorized inter-layer segment estimation (KAPLA §IV-B).

The scalar upper level evaluates one Python ``estimate_layer`` call per
(segment range, alloc option, granule fraction, layer) candidate.  On deep
graphs (ResNet-50, transformer stacks) that scalar loop dominates the solve
now that the intra-layer judge is vectorized (``cost_batch.py``).  Here the
whole candidate set is packed into flat numpy arrays instead:

  * ``pack_graph`` precomputes every per-layer scalar the optimistic
    estimator needs (MACs, tensor sizes, candidate-independent energy
    terms, producer/consumer index ranges) once per graph;
  * ``estimate_segments`` evaluates validity masks
    (``min_buffer_requirement_bytes``), energy / latency / DRAM lower
    bounds, and the pipelining fill term for *all* candidates in one
    vectorized shot.

The math is arranged to be **bit-exact** with the scalar reference path
(``estimate.estimate_layer`` + ``interlayer.estimate_segment_scalar``):
per-layer partial sums are precomputed in the scalar accumulation order,
per-candidate reductions run sequentially over the (short) segment axis,
and the four (src_onchip, dst_onchip) DRAM variants are tabulated rather
than derived by subtraction.  Parity is enforced by
``tests/test_interlayer_batch.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np

from ..hw.template import HWTemplate
from ..workloads.layers import LayerGraph


@dataclasses.dataclass(frozen=True)
class GraphPack:
    """Per-layer scalars of a ``LayerGraph`` packed as flat arrays.

    ``dram_variants[i, v]`` holds layer *i*'s DRAM lower-bound element count
    for on-chip flag combination ``v = src_onchip + 2 * dst_onchip``.
    Producer/consumer layer-index ranges let segment-membership io flags be
    computed with pure comparisons: for a contiguous segment [start, stop),
    ``src_onchip = src_ok & (min_src >= start) & (max_src < stop)`` and
    ``dst_onchip = has_cons & (min_cons >= start) & (max_cons < stop)``.
    """

    n_layers: int
    macs: np.ndarray            # [n] float64
    bytes_per_elem: np.ndarray  # [n] float64
    ifmap: np.ndarray           # [n] ifmap_size()
    ofmap: np.ndarray           # [n] ofmap_size()
    base_energy: np.ndarray     # [n] MAC + REGF + GBUF energy terms
    dram_variants: np.ndarray   # [n, 4] DRAM elems per (src, dst) combo
    src_ok: np.ndarray          # [n] bool: has srcs and all exist in graph
    min_src: np.ndarray         # [n] int64
    max_src: np.ndarray         # [n] int64
    has_cons: np.ndarray        # [n] bool
    min_cons: np.ndarray        # [n] int64
    max_cons: np.ndarray        # [n] int64


def pack_graph(graph: LayerGraph, hw: HWTemplate) -> GraphPack:
    idx = {l.name: i for i, l in enumerate(graph.layers)}
    n = len(graph.layers)
    macs = np.empty(n)
    bpe = np.empty(n)
    ifmap = np.empty(n)
    ofmap = np.empty(n)
    base_e = np.empty(n)
    dram_var = np.empty((n, 4))
    src_ok = np.zeros(n, dtype=bool)
    min_src = np.zeros(n, dtype=np.int64)
    max_src = np.zeros(n, dtype=np.int64)
    has_cons = np.zeros(n, dtype=bool)
    min_cons = np.zeros(n, dtype=np.int64)
    max_cons = np.zeros(n, dtype=np.int64)

    cons: list = [[] for _ in range(n)]
    for j, l in enumerate(graph.layers):
        for s in l.src:
            si = idx.get(s)
            if si is not None:
                cons[si].append(j)

    e_regf = hw.levels[0].access_energy_pj_per_byte
    e_gbuf = hw.levels[1].access_energy_pj_per_byte
    for i, l in enumerate(graph.layers):
        B = float(l.bytes_per_elem)
        m = l.total_macs()
        macs[i] = m
        bpe[i] = B
        ifmap[i] = l.ifmap_size()
        ofmap[i] = l.ofmap_size()
        # candidate-independent energy, accumulated exactly like the scalar
        # estimator: MAC ops, REGF operand traffic, one GBUF pass
        op_e = hw.mac_energy_pj if l.has_weights else 0.2 * hw.mac_energy_pj
        gbuf_elems = 0.0
        for t in l.tensors:
            gbuf_elems += l.tensor_size(t)
        e = 0.0
        e += m * op_e
        e += m * 3 * B * e_regf
        e += gbuf_elems * B * e_gbuf
        base_e[i] = e
        # DRAM lower bound per on-chip combo, same accumulation order as the
        # scalar loop (terms omitted, never subtracted)
        for v in range(4):
            s_on, d_on = bool(v & 1), bool(v & 2)
            acc = 0.0
            for t in l.tensors:
                if t == "I" and s_on:
                    continue
                if t == "O" and d_on:
                    continue
                acc += l.tensor_size(t)
            dram_var[i, v] = acc
        if l.src and all(s in idx for s in l.src):
            src_ok[i] = True
            sidx = [idx[s] for s in l.src]
            min_src[i] = min(sidx)
            max_src[i] = max(sidx)
        if cons[i]:
            has_cons[i] = True
            min_cons[i] = min(cons[i])
            max_cons[i] = max(cons[i])
    return GraphPack(n, macs, bpe, ifmap, ofmap, base_e, dram_var,
                     src_ok, min_src, max_src, has_cons, min_cons, max_cons)


def pack_fingerprint(gp: GraphPack) -> bytes:
    """Deterministic digest of a ``GraphPack``'s arrays — the per-layer
    numeric content the inter-layer solver actually consumes, with layer
    *identity* (names) already stripped by construction.  Renaming layers
    leaves the digest unchanged; reordering, reshaping or re-batching any
    layer changes it.  The schedule store's content signatures
    (``repro.service.signature``) are built on this."""
    h = hashlib.sha256()
    h.update(str(gp.n_layers).encode())
    for arr in (gp.macs, gp.bytes_per_elem, gp.ifmap, gp.ofmap,
                gp.base_energy, gp.dram_variants, gp.src_ok, gp.min_src,
                gp.max_src, gp.has_cons, gp.min_cons, gp.max_cons):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.digest()


def estimate_segments(gp: GraphPack, hw: HWTemplate,
                      starts: np.ndarray, stops: np.ndarray,
                      gfs: np.ndarray, nodes: np.ndarray,
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Estimate a batch of segment candidates in one vectorized shot.

    starts/stops/gfs: [C] candidate arrays; nodes: [C, Lmax] node counts per
    segment position (padded past each candidate's length with 1).

    Returns (valid, energy_lb_pj, latency_lb_cycles, dram_bytes_lb), each
    [C], with inf on invalid lanes.  Numerically identical to running the
    scalar ``estimate_segment_scalar`` per candidate.
    """
    C, Lmax = nodes.shape
    lengths = stops - starts
    pos = np.arange(Lmax, dtype=np.int64)
    mask = pos[None, :] < lengths[:, None]                   # [C, Lmax]
    lidx = np.minimum(starts[:, None] + pos[None, :], gp.n_layers - 1)

    starts_c = starts[:, None]
    stops_c = stops[:, None]
    src_on = gp.src_ok[lidx] & (gp.min_src[lidx] >= starts_c) \
        & (gp.max_src[lidx] < stops_c)
    dst_on = gp.has_cons[lidx] & (gp.min_cons[lidx] >= starts_c) \
        & (gp.max_cons[lidx] < stops_c)

    B = gp.bytes_per_elem[lidx]
    gf_c = gfs[:, None]
    # min_buffer_requirement_bytes, src term added before dst term
    need = np.where(src_on, 2.0 * gp.ifmap[lidx] * gf_c * B, 0.0) \
        + np.where(dst_on, 2.0 * gp.ofmap[lidx] * gf_c * B, 0.0)
    agg_gbuf = nodes * hw.gbuf.capacity_bytes
    valid = np.all((need <= agg_gbuf) | ~mask, axis=1)

    variant = src_on.astype(np.int64) + 2 * dst_on.astype(np.int64)
    dram_bytes_cp = gp.dram_variants[lidx, variant] * B       # [C, Lmax]
    energy_cp = gp.base_energy[lidx] + dram_bytes_cp * \
        hw.levels[-1].access_energy_pj_per_byte

    pes = nodes * hw.num_pes_per_node
    lat_cp = np.maximum(
        gp.macs[lidx] / np.maximum(1, pes),
        dram_bytes_cp / hw.levels[-1].bandwidth_bytes_per_cycle /
        max(1, hw.dram_ports))

    # sequential reductions over the (short) segment axis: same association
    # order as the scalar per-layer accumulation loop, so sums are bit-exact
    energy = np.zeros(C)
    latency = np.zeros(C)
    dram = np.zeros(C)
    for p in range(Lmax):
        m = mask[:, p]
        energy = np.where(m, energy + energy_cp[:, p], energy)
        latency = np.where(m, np.maximum(latency, lat_cp[:, p]), latency)
        dram = np.where(m, dram + dram_bytes_cp[:, p], dram)
    # fine-grained forwarding: fill cost of one granule per extra stage
    latency = latency + latency * gfs * np.maximum(0, lengths - 1)

    inf = float("inf")
    return (valid,
            np.where(valid, energy, inf),
            np.where(valid, latency, inf),
            np.where(valid, dram, inf))
