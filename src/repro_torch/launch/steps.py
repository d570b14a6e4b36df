"""The step functions of train.py and serve.py (the port of
``repro/launch/steps.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.api import Model, ModelAPI
from ..optim.optimizers import Optimizer, global_norm


def build_train_step(api: ModelAPI, optimizer: Optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (``backward``), the gradients
    in ``named_parameters()`` order, ``optimizer.update``, which writes the
    new parameters and optimizer state into ``params`` and ``opt_state``
    in place (the reference returns new arrays and donates the old ones),
    and the metrics ``loss`` and ``grad_norm``, the global norm of the
    gradients before clipping.  The update runs inside a
    ``record_function("optimizer")`` range, which a profile reads."""
    def train_step(params: Model, opt_state, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        loss = api.loss_fn(params, batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        with torch.no_grad(), torch.profiler.record_function("optimizer"):
            optimizer.update(grads, opt_state,
                             {n: p.detach() for n, p in named.items()})
            metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        for p in named.values():
            p.grad = None
        return params, opt_state, metrics
    return train_step


def build_serve_step(api: ModelAPI):
    """``serve_step(params, cache, tokens, cache_len) -> (next tokens
    [B, 1], cache)``: one decode step and its greedy token; ``cache_len``
    is a 0-d int32 tensor on the model's device (or an eager caller's
    Python int), so the step can be captured."""
    def serve_step(params, cache, tokens, cache_len):
        logits, cache = api.decode_step(params, cache, tokens, cache_len)
        next_tok = logits[:, -1].argmax(-1).to(tokens.dtype)
        return next_tok[:, None], cache
    return serve_step


def build_prefill_step(api: ModelAPI, max_len: int):
    """``prefill_step(params, inputs, cache=None) -> (logits, cache)``;
    with ``cache`` the prefill fills that cache in place."""
    def prefill_step(params, inputs, cache=None):
        return api.prefill(params, inputs, max_len, cache=cache)
    return prefill_step


def input_structs(cfg: ModelConfig, shape: ShapeConfig
                  ) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of one cell, with the reference's
    shapes and types, on the ``meta`` device: no memory is allocated."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    if shape.mode == "decode":
        return {"tokens": meta((B, 1), torch.int32),
                "cache_len": meta((), torch.int32)}
    if cfg.frontend == "embed":
        inputs = meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        inputs = meta((B, S), torch.int32)
    batch = {"inputs": inputs}
    if shape.mode == "train":
        batch["targets"] = meta((B, S), torch.int32)
    return batch


__all__ = ["build_prefill_step", "build_serve_step", "build_train_step",
           "input_structs"]
