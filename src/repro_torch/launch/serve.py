"""Batched serving driver: prefill + greedy decode on a shared KV cache.

The port of ``repro/launch/serve.py``.  Runs on the card unless the caller
passes ``device="cpu"``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --device cpu --requests 8 --prompt-len 32 --gen 16

The reference jits its prefill and its decode step; here both are CUDA
graphs (``CompiledServing``) over one static cache, allocated once: the
prefill at the request's fixed prompt shape, which fills that cache in
place, and one decode step, whose token buffer, ``cache_len`` tensor and
cache are static.  The decode graph takes its argmax, writes the next
token into its own input buffer and advances ``cache_len`` on the device,
so a decode loop is one replay a token.  The SSM/hybrid prompt replay
copies each prompt column into the token buffer and replays the same
decode graph.  On the CPU the same step bodies run each time
(``kernels/graph.py``); on the card a failed capture raises, and nothing
falls back to the eager loop.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..kernels import backend
from ..kernels.graph import CapturedStep
from ..models.api import Model, ModelAPI, build_model
from .steps import build_prefill_step, build_serve_step
from .train import tiny_config


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray             # [requests, gen] int32, greedy
    logits: torch.Tensor           # prefill's last-token logits [B, 1, V]
    #: the prefill graph's replay (on the CPU: the prefill); unlike the
    #: reference's, whose first jitted call compiles, no capture inside
    prefill_seconds: float
    decode_seconds: float
    #: the warm-up calls and captures of both graphs (0 on the CPU)
    capture_seconds: float = 0.0
    #: the SSM/hybrid prompt replay through the decode step (0 otherwise)
    prompt_seconds: float = 0.0
    #: the two graphs' private pools on the card (0 on the CPU)
    pool_bytes: int = 0

    @property
    def decode_tokens_per_second(self) -> float:
        n = self.tokens.shape[0] * max(1, self.tokens.shape[1] - 1)
        return n / max(self.decode_seconds, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class CompiledServing:
    """The prefill and the decode step of ``api`` over one static cache,
    each a ``CapturedStep`` on the card.  ``inputs`` gives the prompt
    shape and type (token ids [B, S] or embeddings [B, S, d]); the static
    buffers are ``inputs`` (a copy), ``tokens`` [B, 1] int32,
    ``cache_len`` [] int32 and ``cache``.  Built under
    ``torch.inference_mode``; the warm-up calls write the buffers, and
    ``start`` sets them all anew.  A prompt of another shape raises: the
    graphs hold this one's."""

    def __init__(self, api: ModelAPI, params: Model, inputs: torch.Tensor,
                 max_len: int):
        dev = params.embed.device
        B = inputs.shape[0]
        self.family = api.cfg.family
        self.max_len = max_len
        # the steps close over the buffers, not over ``self``: no cycle
        # keeps the graphs and their pools alive once this goes
        self.cache = cache = api.init_cache(B, max_len)
        self.inputs = static = torch.zeros_like(inputs, device=dev)
        self.tokens = tokens = torch.zeros((B, 1), dtype=torch.int32,
                                           device=dev)
        self.cache_len = cache_len = torch.zeros((), dtype=torch.int32,
                                                 device=dev)
        prefill_step = build_prefill_step(api, max_len)
        serve_step = build_serve_step(api)

        def prefill():
            logits, _ = prefill_step(params, static, cache)
            return {"logits": logits}

        def decode():
            nxt, _ = serve_step(params, cache, tokens, cache_len)
            tokens.copy_(nxt)
            cache_len.add_(1)
            return {"tokens": tokens}

        self.prefill_graph = CapturedStep(prefill, dev, owner="prefill")
        self.decode_graph = CapturedStep(decode, dev, owner="decode")
        self.capture_seconds = self.prefill_graph.capture_seconds \
            + self.decode_graph.capture_seconds
        self.pool_bytes = self.prefill_graph.pool_bytes \
            + self.decode_graph.pool_bytes

    def prefill(self, inputs: torch.Tensor) -> torch.Tensor:
        """Replay the prefill on ``inputs``: the cache is zeroed and (dense,
        MoE) filled; returns the last-token logits (the graph's static
        output, rewritten by the next replay)."""
        if inputs.shape != self.inputs.shape:
            raise ValueError(f"prompt inputs {tuple(inputs.shape)}: the "
                             f"graphs hold {tuple(self.inputs.shape)}")
        self.inputs.copy_(inputs)
        return self.prefill_graph()["logits"]

    def start(self, logits: torch.Tensor, prompt: torch.Tensor) -> None:
        """After ``prefill``: the first generated token into ``tokens`` and
        the prompt length into ``cache_len``.  SSM/hybrid: the prompt
        [B, S] replayed column by column through the decode graph, which
        builds the state and leaves the next token in ``tokens``."""
        if tuple(prompt.shape) != tuple(self.inputs.shape[:2]):
            raise ValueError(f"prompt {tuple(prompt.shape)}: the graphs "
                             f"hold {tuple(self.inputs.shape[:2])}")
        if self.family in ("ssm", "hybrid"):
            self.cache_len.zero_()
            for t in range(prompt.shape[1]):
                self.tokens.copy_(prompt[:, t:t + 1])
                self.decode_graph()
        else:
            self.tokens.copy_(
                logits[:, -1].argmax(-1).to(torch.int32)[:, None])
            self.cache_len.fill_(prompt.shape[1])

    def decode(self) -> torch.Tensor:
        """One decode step: returns the next tokens [B, 1] (the static
        buffer, rewritten by the next step)."""
        return self.decode_graph()["tokens"]


def serve(arch: str, requests: int = 8, prompt_len: int = 32, gen: int = 16,
          tiny: bool = True, seed: int = 0, device=None,
          params: Optional[Model] = None,
          dtype: torch.dtype = torch.bfloat16) -> ServeResult:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens each, greedily.  The prompts (and, for an ``embed``
    frontend, the prompt embeddings) come from numpy's
    ``default_rng(seed)`` exactly as in the JAX driver; the weights are
    ``params`` or drawn from ``seed``."""
    dev = backend.resolve_device(device)
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_config(cfg)
    api = build_model(cfg, device=dev, dtype=dtype)
    max_len = prompt_len + gen
    with torch.inference_mode():
        params = params if params is not None else api.init(seed)

        rng = np.random.default_rng(seed)
        prompts = rng.integers(1, min(cfg.vocab_size, 1000),
                               size=(requests, prompt_len)).astype(np.int32)
        prompt_t = torch.from_numpy(prompts).to(dev)
        if cfg.frontend == "embed":
            # audio/vlm stub: prompts arrive as precomputed embeddings
            emb = rng.standard_normal(
                (requests, prompt_len, cfg.d_model)).astype(np.float32) \
                * 0.02
            inputs = torch.from_numpy(emb).to(dev)
        else:
            inputs = prompt_t
        steps = CompiledServing(api, params, inputs, max_len)

        # --- prefill (batched) -------------------------------------------
        _sync(dev)
        t0 = time.perf_counter()
        logits = steps.prefill(inputs).clone()
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        # SSM/hybrid prefill returns fresh state; replay the prompt through
        # decode to build it, as the JAX driver does
        t0 = time.perf_counter()
        steps.start(logits, prompt_t)
        _sync(dev)
        t_prompt = time.perf_counter() - t0 \
            if cfg.family in ("ssm", "hybrid") else 0.0

        # --- decode loop --------------------------------------------------
        outs = [steps.tokens.clone()]
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            outs.append(steps.decode().clone())
        gen_tokens = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)
        t_decode = time.perf_counter() - t0
    res = ServeResult(gen_tokens, logits, t_prefill, t_decode,
                      steps.capture_seconds, t_prompt, steps.pool_bytes)
    print(f"prefill: {requests} x {prompt_len} tok in {t_prefill:.2f}s "
          f"(capture of both steps {steps.capture_seconds:.2f}s apart); "
          f"decode: {requests} x {gen} tok in {t_decode:.2f}s "
          f"({res.decode_tokens_per_second:.1f} tok/s)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    serve(args.arch, args.requests, args.prompt_len, args.gen,
          device=args.device)


if __name__ == "__main__":
    main()
