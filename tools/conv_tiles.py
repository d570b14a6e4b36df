#!/usr/bin/env python3
"""Time every candidate geometry of the conv kernel on every distinct conv
plan of ResNet-50 b64 (16x16 Eyeriss template; ``--alexnet`` adds AlexNet
b64 on both templates), beside the one ``conv_launch`` picks:

    python3 tools/conv_tiles.py [--alexnet] [--out FILE]

The candidates are ``lower/exec.py`` ``conv_candidates`` at every
shared-memory cap of ``CONV_SMEM_CAPS``.  Each is held against
``plain_conv`` (max rel error <= 1e-5) and timed with ``chip_smoke.py``'s
``stream_ms`` on ``cold_copies`` of the inputs.  Prints one JSON line
per plan (its candidates sorted by time) and a last line with the sum
over ResNet-50's uses of the chosen and of the fastest candidate.  Needs
a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alexnet", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("conv_tiles.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core.solver import solve
    from repro_torch.hw.presets import eyeriss_multinode
    from repro_torch.kernels import backend
    from repro_torch.lower import exec as lx
    from repro_torch.lower import lower_network
    from repro_torch.workloads.nets import get_net

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    configs = [("resnet", eyeriss_multinode())]
    if args.alexnet:
        configs += [("alexnet", eyeriss_multinode()),
                    ("alexnet", eyeriss_multinode(nodes=4, pe=8))]
    plans, uses = {}, collections.Counter()
    for net_name, hw in configs:
        net = get_net(net_name, batch=64)
        nplan = lower_network(solve(net, hw), net, hw)
        for n in nplan.order:
            plan = nplan.plans[n]
            if plan.kind != "conv":
                continue
            k = cs.plan_key(plan)
            plans.setdefault(k, (f"{net_name}/{hw.name}/{n}", plan))
            if net_name == "resnet":
                uses[k] += 1
    lib = backend.library()
    out_lines, chosen_fwd, best_fwd = [], 0.0, 0.0
    for k, (where, plan) in plans.items():
        L = plan.layer
        XI, YI = lx.input_extent(L)
        dims = (*(L.dim(d) for d in "NCKXY"),)
        N, C, K, XO, YO = dims
        R, S, st = (int(L.meta[m]) for m in ("R", "S", "stride"))
        b = plan.block
        chosen = lx.conv_launch(plan, XI, YI)
        cands = {chosen}
        for cap in lx.CONV_SMEM_CAPS:
            cands |= {launch for _, launch in lx.conv_candidates(
                N, C, K, XI, YI, XO, YO, R, S, st, b["N"], b["C"], b["K"],
                b["X"], b["Y"], cap)}
        inputs = lx.make_inputs(plan, seed=0, device=dev)
        want = lx.plain_conv(plan, inputs["I"], inputs["W"])
        copies = cs.cold_copies(inputs)
        rows = []
        for launch in cands:
            def run(c, launch=launch):
                out = torch.empty((N, K, XO, YO), device=dev)
                prm = lx._conv_params(launch, launch.vec)
                backend.check_launch("kapla_conv", lib.kapla_conv(
                    c["I"].data_ptr(), c["W"].data_ptr(), out.data_ptr(),
                    prm, backend.stream_handle(dev)))
                return out
            got = run(inputs)
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= cs.KERNEL_TOL:
                raise AssertionError(f"{where} {launch}: rel err {err}")
            ms = cs.stream_ms([lambda c=c: run(c) for c in copies])
            rows.append({"ms": ms, "chosen": launch == chosen,
                         "mt": launch.mt, "nt": launch.nt, "wm": launch.wm,
                         "wn": launch.wn, "box": [launch.tn, launch.tx,
                                                  launch.ty],
                         "tk": launch.tk, "cc": launch.cc,
                         "smem": launch.smem, "blocks": launch.grid,
                         "rel_err": err})
        del copies, inputs, want
        rows.sort(key=lambda r: r["ms"])
        mine = next(r for r in rows if r["chosen"])
        chosen_fwd += mine["ms"] * uses[k]
        best_fwd += rows[0]["ms"] * uses[k]
        line = {"plan": where, "describe": plan.describe(),
                "uses": uses[k], "chosen_ms": mine["ms"],
                "best_ms": rows[0]["ms"], "candidates": rows}
        out_lines.append(line)
        print(json.dumps({k2: v for k2, v in line.items()
                          if k2 != "candidates"} | {"best": rows[0]}),
              flush=True)
    summary = {"device": torch.cuda.get_device_name(0),
               "resnet_chosen_per_forward_ms": chosen_fwd,
               "resnet_best_per_forward_ms": best_fwd}
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x)
                                            for x in out_lines) + "\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
