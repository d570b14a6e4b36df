"""The step functions of train.py and serve.py (the port of
``repro/launch/steps.py``)."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.graph import CapturedStep
from ..models.api import Model, ModelAPI
from ..obs import device as obs_device
from ..optim.optimizers import (Optimizer, TreeShards, global_norm,
                                tree_map)

#: the host span around the optimizer's update, which a profile reads
OPTIMIZER_SPAN = "train.optimizer"


def build_train_step(api: ModelAPI, optimizer: Optimizer,
                     marks: Optional[obs_device.Marks] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (``backward``), the gradients
    in ``named_parameters()`` order, ``optimizer.update``, which writes the
    new parameters and optimizer state into ``params`` and ``opt_state``
    in place (the reference returns new arrays and donates the old ones),
    and the metrics ``loss`` and ``grad_norm``, the global norm of the
    gradients before clipping.  The update runs inside the host span
    ``OPTIMIZER_SPAN``, which a profile reads.  ``marks`` (``obs/device.py``)
    are marked ``forward``, ``backward``, ``optimizer`` and ``end`` at the
    phases' boundaries.

    On a partitioned API (``api.shards``) parameters, state and batch are
    DTensors (``launch/partition.py`` ``partitioned_train_step``): the
    update reads their local windows (``TreeShards``), after each
    gradient is summed over the data axes that do not shard its leaf
    (``TreeShards.reduce``)."""
    sh = api.shards
    mark = marks.mark if marks is not None else (lambda name: None)

    def train_step(params: Model, opt_state, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        mark("forward")
        loss = api.loss_fn(params, batch)
        mark("backward")
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        mark("optimizer")
        with torch.no_grad(), obs_device.span(OPTIMIZER_SPAN):
            shards, state = None, opt_state
            if sh is not None:
                shards = TreeShards(
                    sh, {n: sh.layout(p) for n, p in named.items()},
                    tree_map(sh.layout, opt_state), optimizer.mirror)
                grads = {n: shards.reduce(n, g.to_local())
                         for n, g in grads.items()}
                state = tree_map(lambda t: t.to_local(), opt_state)
            optimizer.update(grads, state, {
                n: p.detach() if sh is None else p.to_local()
                for n, p in named.items()}, *([shards] if shards else []))
            metrics = {"loss": loss.detach(),
                       "grad_norm": global_norm(grads, shards)}
        mark("end")
        for p in named.values():
            p.grad = None
        return params, opt_state, metrics
    return train_step


class CompiledTraining:
    """``build_train_step``'s step over static batch buffers, captured as
    one CUDA graph on the card: the counterpart of the reference's
    ``jax.jit(train_step, donate_argnums=(0, 1))``.  The buffers
    ``batch`` take the shapes and types of ``batch_like`` (tensors on any
    device, ``input_structs``'s meta ones too; embeddings in the model's
    type) on the parameters' device.
    The forward, the backward and the update all run inside the graph:
    the gradients are set to None before the backward, so the backward
    allocates them from the graph's pool and every replay rewrites them
    at the same addresses; ``update`` writes ``params`` and ``opt_state``
    in place, so a replay reads and writes the caller's own tensors (a
    restore must write into them too, ``checkpoint/ckpt.py``).

    The capture is built at the first ``step``: ``CapturedStep``'s
    warm-up call is that step, its metrics are that step's, and the
    capture itself executes nothing; every later ``step`` is one replay.
    On the CPU every ``step`` runs the body.  A failed capture raises.

    Each ``step`` is the host spans ``train.copy_in`` and ``train.replay``
    (``obs/device.py``), carrying ``step=<n>``; with a tracer installed
    across the capture, the graph holds the step's marks and ``phase_ms``
    reads the device ms of each phase of the last replay."""

    def __init__(self, api: ModelAPI, params: Model, opt_state,
                 optimizer: Optimizer, batch_like: Mapping[str, torch.Tensor]):
        self.device = params.embed.device
        # the body closes over the buffers, not over ``self``; embeddings
        # in the model's type, into which its ``_embed`` casts them anyway
        self.batch = batch = {
            k: torch.zeros(tuple(v.shape), device=self.device,
                           dtype=params.embed.dtype if v.is_floating_point()
                           else v.dtype)
            for k, v in batch_like.items()}
        self.marks = obs_device.Marks(self.device)
        train_step = build_train_step(api, optimizer, self.marks)

        def body():
            return train_step(params, opt_state, batch)[2]
        self._body = body
        self.captured: Optional[CapturedStep] = None
        self.steps = 0

    @property
    def capture_seconds(self) -> float:
        """The warm-up step and the capture (0 before the first step and
        on the CPU)."""
        return self.captured.capture_seconds if self.captured else 0.0

    @property
    def pool_bytes(self) -> int:
        """The card's memory the graph's private pool took."""
        return self.captured.pool_bytes if self.captured else 0

    def phase_ms(self) -> Dict[str, float]:
        """``{forward, backward, optimizer}``: device ms of each phase of
        the last step (empty unless a tracer was installed across the
        capture, or on the CPU across the step)."""
        return self.marks.phase_ms()

    def step(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One train step on the host ``batch``: copied into the buffers,
        then replayed (the first: the warm-up step and the capture).
        Returns ``loss`` and ``grad_norm``, the graph's static outputs,
        rewritten by the next step."""
        n = self.steps + 1
        with obs_device.span("train.copy_in", step=n):
            for k, buf in self.batch.items():
                v = torch.as_tensor(batch[k])
                if tuple(v.shape) != tuple(buf.shape):
                    raise ValueError(f"batch {k} {tuple(v.shape)}: the "
                                     f"graph holds {tuple(buf.shape)}")
                buf.copy_(v)
        self.steps = n
        if self.captured is None:
            self.captured = CapturedStep(self._body, self.device,
                                         keep_warmup=True, owner="train")
            if self.captured.warmup_outputs is not None:
                return self.captured.warmup_outputs
        with obs_device.span("train.replay", step=n):
            return self.captured()


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


__all__ = ["OPTIMIZER_SPAN", "CompiledTraining", "build_prefill_step",
           "build_serve_step", "build_train_step", "input_structs"]
