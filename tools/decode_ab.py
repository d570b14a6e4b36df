#!/usr/bin/env python3
"""Profile the eager decode step of the ``repro_torch`` package of any
source tree, so that two trees compare on one card:

    python3 tools/decode_ab.py --src OTHER_CHECKOUT/src --label before
    python3 tools/decode_ab.py --src src --label after

Run them as A, B, B, A on the same card.  For each of Qwen2.5-3B,
Zamba2-1.2B and Qwen2-MoE-A2.7B at full width and depth in bf16 (random
weights from seed 0): one prefill of 8 x 512 tokens into a cache of 544
positions, then 8 decode steps through ``build_serve_step`` with a Python
length (the eager loop both trees run), once unprofiled (host clock,
ending in a synchronise) and once under ``torch.profiler``: the device
time by group, the busy ms a step, the device kernels a step and the idle
share, ``chip_smoke.py``'s ``device_profile_of``.  Prints one JSON line
with the card's name and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-3b", "zamba2-1.2b", "qwen2-moe-a2.7b")
B, PROMPT, GEN, STEPS = 8, 512, 32, 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src/ directory that holds repro_torch")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_ab.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.api import build_model

    dev = torch.device("cuda", 0)
    res = {"label": args.label, "card": cs.card_power()}
    for arch in ARCHS:
        cfg = get_config(arch)
        api = build_model(cfg, device=dev)
        step = build_serve_step(api)
        with torch.inference_mode():
            params = api.init(0)
            prompts = torch.from_numpy(np.random.default_rng(0).integers(
                1, min(cfg.vocab_size, 1000), size=(B, PROMPT)).astype(
                np.int32)).to(dev)
            logits, cache = api.prefill(params, prompts, PROMPT + GEN)
            first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            start = {k: t.clone() for k, t in cache.items()}

            def run():
                c = {k: t.clone() for k, t in start.items()}
                tok = first
                for i in range(STEPS):
                    tok, c = step(params, c, tok, PROMPT + i)
                return tok

            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof = cs.device_profile_of(run)
        res[arch] = {"decode_tok_s": B * STEPS / wall,
                     "busy_ms_a_step": prof["device_busy_ms"] / STEPS,
                     "kernels_a_step": prof["device_kernels"] / STEPS,
                     "idle_share": prof["idle_share"],
                     "device_ms": prof["device_ms"],
                     "top_kernels_ms": prof["top_kernels_ms"]}
        del api, params, cache, start
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
