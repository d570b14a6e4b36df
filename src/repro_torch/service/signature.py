"""Canonical content signatures for (LayerGraph, HWTemplate, options).

A signature addresses one solve: two requests with the same signature are
guaranteed to see the same solver inputs, so the store can answer the
second from the first's schedule.  The signature is built from

  * the packed per-layer arrays the inter-layer solver actually consumes
    (``estimate_batch.pack_fingerprint`` — MACs, tensor sizes, energy
    terms, DRAM variants, producer/consumer index ranges);
  * each layer's canonical intra-layer signature
    (``memo.layer_signature`` — shape/tensor structure with the identity
    stripped) plus its exact source-edge *indices*;
  * every ``HWTemplate`` field, and the solver options.

It is insensitive exactly where the solver is: layer *names* never enter
(renaming a graph's layers reuses the cache), while layer *order* does
(the DP walks the topological list), as do batch size, hardware fields
and options.

The *family* signature additionally strips the batch dimension (every
layer's N pinned to 1, packed arrays dropped) — two requests in the same
family differ only in batch size, so a family near-miss can seed a
warm-start solve (``kapla.seed_chains_from``)."""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Mapping, Optional

from ..core.estimate_batch import pack_fingerprint
from ..core.solver.interlayer import graph_pack
from ..core.solver.memo import layer_signature
from ..hw.template import HWTemplate
from ..workloads.layers import LayerGraph

#: options that change what ``kapla.solve`` computes (defaults mirror it)
DEFAULT_OPTIONS: Dict = {"k_s": 4, "max_seg_len": 4, "objective": "energy"}


def solver_options(**overrides) -> Dict:
    """Normalized solver-option dict: unknown keys rejected, defaults
    filled in, insertion order fixed — the canonical form both signatures
    and store records use."""
    bad = set(overrides) - set(DEFAULT_OPTIONS)
    if bad:
        raise ValueError(f"unknown solver options {sorted(bad)}")
    return {k: overrides.get(k, v) for k, v in DEFAULT_OPTIONS.items()}


def _hw_blob(hw: HWTemplate) -> bytes:
    return json.dumps(dataclasses.asdict(hw), sort_keys=True).encode()


def _edge_indices(graph: LayerGraph) -> list:
    idx = {l.name: i for i, l in enumerate(graph.layers)}
    return [sorted(idx[s] for s in l.src if s in idx)
            for l in graph.layers]


def schedule_signature(graph: LayerGraph, hw: HWTemplate,
                       options: Optional[Mapping] = None) -> str:
    """Content address of one solve request (hex sha256)."""
    opts = solver_options(**dict(options or {}))
    h = hashlib.sha256()
    h.update(pack_fingerprint(graph_pack(graph, hw)))
    for l in graph.layers:
        h.update(repr(layer_signature(l)).encode())
    h.update(json.dumps(_edge_indices(graph)).encode())
    h.update(_hw_blob(hw))
    h.update(json.dumps(opts, sort_keys=True).encode())
    return h.hexdigest()


def family_signature(graph: LayerGraph, hw: HWTemplate,
                     options: Optional[Mapping] = None) -> str:
    """Batch-insensitive signature: identical for two graphs that differ
    only in every layer's N dimension (the warm-start near-miss key)."""
    opts = solver_options(**dict(options or {}))
    h = hashlib.sha256()
    for l in graph.layers:
        dims = dict(l.dims)
        dims["N"] = 1
        nobatch = dataclasses.replace(l, dims=dims)
        h.update(repr(layer_signature(nobatch)).encode())
    h.update(json.dumps(_edge_indices(graph)).encode())
    h.update(_hw_blob(hw))
    h.update(json.dumps(opts, sort_keys=True).encode())
    return h.hexdigest()


__all__ = ["DEFAULT_OPTIONS", "solver_options", "schedule_signature",
           "family_signature"]
