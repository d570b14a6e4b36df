"""Batched serving driver: prefill + greedy decode on a shared KV cache.

The port of ``repro/launch/serve.py``.  Runs on the card unless the caller
passes ``device="cpu"``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --device cpu --requests 8 --prompt-len 32 --gen 16
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
from ..models.api import Model, build_model
from .steps import build_prefill_step, build_serve_step
from .train import tiny_config


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray             # [requests, gen] int32, greedy
    logits: torch.Tensor           # prefill's last-token logits [B, 1, V]
    prefill_seconds: float
    decode_seconds: float

    @property
    def decode_tokens_per_second(self) -> float:
        n = self.tokens.shape[0] * max(1, self.tokens.shape[1] - 1)
        return n / max(self.decode_seconds, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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

        # --- prefill (batched) -------------------------------------------
        prefill_step = build_prefill_step(api, max_len)
        if cfg.frontend == "embed":
            # audio/vlm stub: prompts arrive as precomputed embeddings
            emb = rng.standard_normal(
                (requests, prompt_len, cfg.d_model)).astype(np.float32) \
                * 0.02
            inputs = torch.from_numpy(emb).to(dev)
        else:
            inputs = prompt_t
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, inputs)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        # SSM/hybrid prefill returns fresh state; replay the prompt through
        # decode to build it, as the JAX driver does
        serve_step = build_serve_step(api)
        if cfg.family in ("ssm", "hybrid"):
            for t in range(prompt_len):
                tok, cache = serve_step(params, cache,
                                        prompt_t[:, t:t + 1], t)
            next_tok = tok
        else:
            next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

        # --- decode loop --------------------------------------------------
        outs = [next_tok]
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(gen - 1):
            next_tok, cache = serve_step(params, cache, next_tok,
                                         prompt_len + i)
            outs.append(next_tok)
        gen_tokens = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)
        t_decode = time.perf_counter() - t0
    res = ServeResult(gen_tokens, logits, t_prefill, t_decode)
    print(f"prefill: {requests} x {prompt_len} tok in {t_prefill:.2f}s; "
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
