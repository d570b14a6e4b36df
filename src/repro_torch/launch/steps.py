"""Step builders for serving (the port of ``repro/launch/steps.py``'s
``build_serve_step`` and ``build_prefill_step``; the train step comes with
training)."""
from __future__ import annotations

from ..models.api import ModelAPI


def build_serve_step(api: ModelAPI):
    def serve_step(params, cache, tokens, cache_len):
        logits, cache = api.decode_step(params, cache, tokens, cache_len)
        next_tok = logits[:, -1].argmax(-1).to(tokens.dtype)
        return next_tok[:, None], cache
    return serve_step


def build_prefill_step(api: ModelAPI, max_len: int):
    def prefill_step(params, inputs):
        return api.prefill(params, inputs, max_len)
    return prefill_step


__all__ = ["build_prefill_step", "build_serve_step"]
