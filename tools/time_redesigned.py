#!/usr/bin/env python3
"""Time the kernels redesigned for the H100, and the bf16 prefills that run
flash attention, for the ``repro_torch`` package of any source tree, with
``chip_smoke.py``'s methods, so that two trees compare on one card:

    python3 tools/time_redesigned.py --src OTHER_CHECKOUT/src --label before
    python3 tools/time_redesigned.py --src src --label after

Run them as A, B, B, A on the same card.  Each run measures, with
``cold_copies`` of the inputs (the weights come from device memory as in a
network forward) and 20 calls back to back (``stream_ms``):
- conv per ResNet-50 b64 forward (16x16 Eyeriss template): every distinct
  conv plan, its time times its uses summed, beside ``F.conv2d`` (TF32
  off); each plan's time is in ``conv_plans``;
- layer-tier attention at the Zamba2-1.2B shared block's plan (16x16)
  beside ``F.scaled_dot_product_attention`` in float32;
- fc at ResNet-50 b64's plan beside ``torch.matmul``;
- eltwise per ResNet-50 b64 forward: every distinct eltwise plan (two
  operands), its time times its uses summed, beside ``torch.add``;
- the SSD intra-chunk term at the Mamba2-1.3B and Zamba2-1.2B prefill
  shapes (bf16, 8 requests), per Zamba2-1.2B serve prefill (38 launches),
  and at Zamba2-1.2B's shape with 1, 2 and 4 requests;
- flash attention at the Qwen2.5-3B and Zamba2-1.2B prefill shapes (bf16,
  causal) beside SDPA, and per serve prefill of both (36 and 6 launches);
- the wall time of one prefill of each model at full width (8 x 512
  tokens, random weights from seed 0), the median of 3 after one warm-up,
  without a profiler (skipped with ``--no-prefill``).
Prints one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
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
    ap.add_argument("--no-prefill", action="store_true",
                    help="skip the two model prefills")
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
    from repro_torch.kernels import ssd_scan
    from repro_torch.lower import calibrate as cal
    from repro_torch.lower import exec as lx
    from repro_torch.lower import lower_network, lower_scheme
    from repro_torch.models.api import build_model
    from repro_torch.workloads.layers import attention
    from repro_torch.workloads.nets import get_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {"label": args.label, "device": torch.cuda.get_device_name(0)}

    hw, net = eyeriss_multinode(), get_net("resnet", batch=64)
    nplan = lower_network(solve(net, hw), net, hw)

    # conv, per ResNet-50 b64 forward
    uses, plans = collections.Counter(), {}
    for n in nplan.order:
        plan = nplan.plans[n]
        if plan.kind == "conv":
            k = cs.plan_key(plan)
            uses[k] += 1
            plans.setdefault(k, (n, plan))
    # the kernel's own input layout, where the tree has one (channels-last
    # since the wgmma conv), converted outside the calls timed
    layout = getattr(lx, "kernel_inputs", lambda plan, c, dev: c)
    per_plan, fwd = {}, {"conv": 0.0, "conv2d": 0.0}
    for k, (n, plan) in plans.items():
        stride = int(plan.layer.meta["stride"])
        copies = cs.cold_copies(lx.make_inputs(plan, seed=0, device=dev))
        feeds = [layout(plan, c, dev) for c in copies]
        ms = {"conv": cs.stream_ms([functools.partial(
            lx.run_conv, plan, c["I"], c["W"]) for c in feeds]),
              "conv2d": cs.stream_ms([functools.partial(
                  F.conv2d, c["I"], c["W"], stride=stride) for c in copies])}
        del copies, feeds
        per_plan[n] = {**ms, "uses": uses[k]}
        for what, t in ms.items():
            fwd[what] += t * uses[k]
    res["conv_per_forward_ms"] = fwd["conv"]
    res["conv2d_per_forward_ms"] = fwd["conv2d"]
    res["conv_plans"] = per_plan

    # eltwise, per ResNet-50 b64 forward
    uses, plans = collections.Counter(), {}
    for n in nplan.order:
        plan = nplan.plans[n]
        if plan.kind == "eltwise":
            k = cs.plan_key(plan)
            uses[k] += 1
            plans.setdefault(k, plan)
    fwd = {"eltwise": 0.0, "add": 0.0}
    for k, plan in plans.items():
        copies = cs.cold_copies(lx.make_inputs(plan, seed=0, device=dev))
        fwd["eltwise"] += uses[k] * cs.stream_ms([functools.partial(
            lx.run_eltwise, plan, [c["A"], c["B"]]) for c in copies])
        fwd["add"] += uses[k] * cs.stream_ms([functools.partial(
            torch.add, c["A"], c["B"]) for c in copies])
        del copies
    res["eltwise_per_forward_ms"] = fwd["eltwise"]
    res["add_per_forward_ms"] = fwd["add"]

    # layer-tier attention at the Zamba2-1.2B plan, 16x16 template
    plan = lower_scheme(cal.scheme_variants(
        attention("zamba2.attn", 8, 32, 512, 64), hw, 0)[0], hw)
    copies = cs.cold_copies(lx.make_inputs(plan, seed=0, device=dev))
    res["attention_ms"] = cs.stream_ms([functools.partial(
        lx.run_attention, plan, c["Q"], c["K"], c["V"]) for c in copies])
    res["attention_sdpa_ms"] = cs.stream_ms([functools.partial(
        lambda c: F.scaled_dot_product_attention(
            c["Q"][:, None], c["K"][:, None], c["V"][:, None]), c)
        for c in copies])
    del copies

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

    # the SSD intra-chunk term at the serve prefills' shapes (bf16), and
    # at Zamba2-1.2B's with fewer requests
    zamba = cs.SSD_CASES[1]
    assert zamba[0] == "zamba2-1.2b"
    cases = [*cs.SSD_CASES[:2],
             *((f"{zamba[0]}_b{B}", B, *zamba[2:]) for B in (1, 2, 4))]
    for case, B, S, H, P, N, Lc, dtype in cases:
        NC = S // Lc
        x = torch.randn((B, H, NC, Lc, P), generator=g,
                        device=dev).to(torch.bfloat16)
        dt = torch.rand((B, H, NC, Lc), generator=g, device=dev) * 0.1 \
            + 1e-3
        a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.5)
        acum = torch.cumsum(dt * a[None, :, None, None], dim=-1)
        b = torch.randn((B, NC, Lc, N), generator=g, device=dev) * 0.5
        c = torch.randn((B, NC, Lc, N), generator=g, device=dev) * 0.5
        res[f"ssd_{case}_ms"] = cs.stream_ms(
            lambda: ssd_scan.ssd_intra_chunk(x, dt, acum, b, c))
        del x, dt, acum, b, c
    res["ssd_per_prefill_ms"] = res["ssd_zamba2-1.2b_ms"] * \
        cs.SERVE["zamba2-1.2b"]["ssd_intra_chunk"]

    for arch in () if args.no_prefill else cs.SERVE:
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
