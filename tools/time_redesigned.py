#!/usr/bin/env python3
"""Time the two kernels redesigned for the H100, and the bf16 prefills that
run flash attention, for the ``repro_torch`` package of any source tree,
with ``chip_smoke.py``'s methods, so that two trees compare on one card:

    python3 tools/time_redesigned.py --src OTHER_CHECKOUT/src --label before
    python3 tools/time_redesigned.py --src src --label after

Run them as A, B, B, A on the same card.  Each run measures fc at ResNet-50
b64's plan (16x16 Eyeriss template; ``cold_copies`` of its inputs, so the
weights come from device memory as in a network forward) beside
``torch.matmul``; flash attention at the Qwen2.5-3B and Zamba2-1.2B prefill
shapes (bf16, causal) beside ``F.scaled_dot_product_attention``, and per
serve prefill of both (36 and 6 launches); and the wall time of one prefill
of each model at full width (8 x 512 tokens, random weights from seed 0),
the median of 3 after one warm-up, without a profiler.  Prints one JSON
line.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src/ directory that holds repro_torch")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_redesigned.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.solver import solve
    from repro_torch.hw.presets import eyeriss_multinode
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.lower import exec as lx
    from repro_torch.lower import lower_network
    from repro_torch.models.api import build_model
    from repro_torch.workloads.nets import get_net

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {"label": args.label, "device": torch.cuda.get_device_name(0)}

    hw, net = eyeriss_multinode(), get_net("resnet", batch=64)
    nplan = lower_network(solve(net, hw), net, hw)
    (plan,) = [nplan.plans[n] for n in nplan.order
               if nplan.plans[n].kind == "fc"]
    copies = cs.cold_copies(lx.make_inputs(plan, seed=0, device=dev))
    res["fc_ms"] = cs.stream_ms([functools.partial(lx.run_fc, plan, c["I"],
                                                   c["W"]) for c in copies])
    res["fc_matmul_ms"] = cs.stream_ms([functools.partial(
        torch.matmul, c["I"], c["W"]) for c in copies])
    del copies

    g = torch.Generator(device=dev).manual_seed(0)
    per_prefill = {"flash": 0.0, "sdpa": 0.0}
    for case, B, H, KV, Sq, Sk, D, *_ in cs.FLASH_CASES[:2]:
        q = torch.randn((B, H, Sq, D), generator=g, device=dev).bfloat16()
        k = torch.randn((B, KV, Sk, D), generator=g, device=dev).bfloat16()
        v = torch.randn((B, KV, Sk, D), generator=g, device=dev).bfloat16()
        ms = {"flash": cs.stream_ms(
            lambda: fa.flash_attention(q, k, v, True, 0, 0.0)),
              "sdpa": cs.stream_ms(lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True))}
        for what, t in ms.items():
            res[f"{what}_{case}_ms"] = t
            per_prefill[what] += t * cs.SERVE[case]["flash_attention"]
    for what, t in per_prefill.items():
        res[f"{what}_per_prefill_ms"] = t
    del q, k, v

    for arch in cs.SERVE:
        cfg = get_config(arch)
        api = build_model(cfg, device=dev)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            1, min(cfg.vocab_size, 1000),
            size=(cs.SERVE_REQUESTS, cs.SERVE_PROMPT)).astype(np.int32)).to(
                dev)
        times = []
        with torch.inference_mode():
            params = api.init(0)
            for _ in range(4):
                times.append(cs.host_ms(lambda: api.prefill(
                    params, prompts, cs.SERVE_PROMPT + cs.SERVE_GEN))[1])
        res[f"prefill_{arch}_ms"] = statistics.median(times[1:])
        del api, params
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
