"""Registry of the 10 assigned architectures (exact configs from the
assignment, sources noted inline) — selectable via ``--arch <id>``."""
from __future__ import annotations

from typing import Callable, Dict

from .base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)


# --- import all arch modules so they self-register --------------------------
from . import (gemma2_2b, internlm2_20b, internvl2_26b, kimi_k2,        # noqa
               mamba2_1_3b, musicgen_large, qwen2_5_3b, qwen2_moe_a2_7b,
               yi_6b, zamba2_1_2b)
