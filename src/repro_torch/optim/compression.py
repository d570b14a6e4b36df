"""Gradient compression with error feedback (int8 quantization).

The port of ``repro/optim/compression.py``.  For cross-node gradient
reduction the wire bytes dominate; int8 with a per-tensor scale cuts them
4x vs f32 (2x vs bf16).  Error feedback keeps the quantization noise from
biasing convergence: the residual of each round is added back before the
next quantization (Seide et al. / EF-SGD).

``compress -> (payload, scale)`` / ``decompress`` are pure functions over
tensors; the tree functions walk dicts keyed by parameter name.  Off the
train path, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .optimizers import tree_leaves, tree_map

Tree = Any


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: Tree) -> Tree:
    return tree_map(compress, grads)


def ef_round(grads: Tree, error: Tree) -> Tuple[Tree, Tree]:
    """One error-feedback round: (compensated-compressed grads, new error).

    Returns the dequantized gradients (what the optimizer consumes after
    the wire trip) and the residual to carry into the next step.
    """
    def one(g, e):
        comp = g.float() + e
        q, s = compress(comp)
        deq = decompress(q, s)
        return deq.to(g.dtype), comp - deq

    out = tree_map(one, grads, error)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def init_error(grads_template: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)


def wire_bytes_saved(grads: Tree) -> Tuple[int, int]:
    """(bf16 wire bytes, int8 wire bytes) for reporting."""
    leaves = tree_leaves(grads)
    n = sum(x.numel() for x in leaves)
    return 2 * n, n + 4 * len(leaves)


__all__ = ["compress", "compress_tree", "decompress", "ef_round",
           "init_error", "wire_bytes_saved"]
