#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build ``src/repro_torch/csrc/lower_kernels.cu`` for sm_90a with nvcc;
2. hold each of the four kernels (fc, conv, pool, eltwise) against its
   plain PyTorch version on the card, at every distinct (kind, shape, grid
   order) among the plans of ResNet-50 b64 and AlexNet b64 on the 16x16
   Eyeriss template and AlexNet b64 on the 4x4 one: max rel error <= 1e-5
   (both float32, only the summation order differs); time the kernel, the
   plain version and one PyTorch library call on the same inputs;
3. ResNet-50 b64 end to end: solve -> lower_network -> network_runner on
   the card, with the launch counters set to 0 just before the run and
   read just after (each must equal the plan's layer count of its kind);
   every layer within 1e-3 of the torch oracles; measure_network;
4. the same for AlexNet b64;
5. print ``{"kernels": [...]}``, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json`` beside this script.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 1e-5
NETWORK_TOL = 1e-3

#: published peaks (NVIDIA H100 data sheet, dense, no sparsity): FP32 on
#: the CUDA cores, and device-memory bandwidth
PEAKS = {"PCIe": (51.2e12, 2.0e12), "SXM": (67e12, 3.35e12)}


def peaks(name: str):
    return PEAKS["PCIe"] if "PCIe" in name else PEAKS["SXM"]


def log(*a) -> None:
    print(*a, flush=True)


def work(plan):
    """(operations, bytes) the layer needs: each input read once, each
    output written once; conv/fc count 2 per multiply-add."""
    L = plan.layer
    d = {k: L.dim(k) for k in "NCKXY"}
    if plan.kind == "fc":
        return (2 * d["N"] * d["C"] * d["K"],
                4 * (d["N"] * d["C"] + d["C"] * d["K"] + d["N"] * d["K"]))
    out = d["N"] * d["X"] * d["Y"]
    if plan.kind == "eltwise":
        n = out * d["C"]
        return n, 4 * 3 * n                  # two operands, one output
    R, S, st = (int(L.meta[k]) for k in ("R", "S", "stride"))
    xin = ((d["X"] - 1) * st + R) * ((d["Y"] - 1) * st + S) * d["N"]
    if plan.kind == "pool":
        return out * d["C"] * R * S, 4 * (xin + out) * d["C"]
    return (2 * out * d["K"] * d["C"] * R * S,
            4 * (xin * d["C"] + d["K"] * d["C"] * R * S + out * d["K"]))


def device_profile(runner):
    """One run under ``torch.profiler``: device time by kernel family,
    host<->device copies and the rest, against the run's wall clock."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ex = runner()
    groups = collections.Counter()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        k = e.key
        group = next((f for f in ("fc", "conv", "pool", "eltwise")
                      if f"{f}_kernel" in k), None)
        if group is None:
            group = "memcpy_dtoh" if "DtoH" in k else \
                "memcpy_htod" if "HtoD" in k else "other"
        groups[group] += us / 1e3
    wall_ms = ex.seconds * 1e3
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_ms": dict(groups),
            "device_busy_ms": busy,
            "idle_share": None if not busy else 1.0 - busy / wall_ms}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc"
            / "lower_kernels.cu").is_file():
        print("chip_smoke.py: src/repro_torch is missing; run it from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch.core.solver import solve
    from repro_torch.hw.presets import eyeriss_multinode
    from repro_torch.kernels import backend
    from repro_torch.lower import (compare_network, lower_network,
                                   make_network_inputs, measure_network,
                                   network_runner)
    from repro_torch.lower import exec as lx
    from repro_torch.workloads.nets import get_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peak_ops, peak_bw = peaks(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | {name}")
    detail = {"device": name, "peaks": {"fp32_ops_s": peak_ops,
                                        "bytes_s": peak_bw}}

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = backend.build()
    backend.library()
    build_s = time.perf_counter() - t0
    log(f"[build] {lib_path.name} in {build_s:.1f} s")
    log(lib_path.with_name(lib_path.stem + ".ptxas.txt").read_text().strip())
    detail["build_seconds"] = build_s

    # solve + lower the three configurations --------------------------------
    configs = [("resnet", eyeriss_multinode()),
               ("alexnet", eyeriss_multinode()),
               ("alexnet", eyeriss_multinode(nodes=4, pe=8))]
    nplans = {}
    for net_name, hw in configs:
        net = get_net(net_name, batch=64)
        t0 = time.perf_counter()
        sched = solve(net, hw)
        nplan = lower_network(sched, net, hw)
        if not nplan.executable:
            raise RuntimeError(f"{net_name}/{hw.name}: "
                               f"{nplan.invalid_layers()}")
        nplans[(net_name, hw.name)] = nplan
        log(f"[solve] {net_name} b64 on {hw.name}: "
            f"{time.perf_counter() - t0:.2f} s, {len(nplan.order)} layers, "
            f"{len(nplan.segments)} segments, "
            f"{len(nplan.forwarded())} forwarded, energy "
            f"{sched.total_energy_pj!r} pJ, latency "
            f"{sched.total_latency_cycles!r} cycles")

    def key(plan):
        L = plan.layer
        return (plan.kind, tuple(L.dim(d) for d in "NCKXY"),
                tuple(sorted(L.meta.items())),
                tuple((a.dim, a.steps) for a in plan.grid),
                tuple(sorted(plan.block.items())))

    distinct = {}
    resnet_uses = collections.Counter()
    for (net_name, hw_name), nplan in nplans.items():
        for n in nplan.order:
            k = key(nplan.plans[n])
            distinct.setdefault(k, (f"{net_name}/{hw_name}/{n}",
                                    nplan.plans[n]))
            if net_name == "resnet":
                resnet_uses[k] += 1

    # 2. kernels vs plain versions ------------------------------------------
    def events_ms(fn, reps):
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    run = {"fc": lambda p, i: lx.run_fc(p, i["I"], i["W"]),
           "conv": lambda p, i: lx.run_conv(p, i["I"], i["W"]),
           "pool": lambda p, i: lx.run_pool(p, i["I"]),
           "eltwise": lambda p, i: lx.run_eltwise(p, [i["A"], i["B"]])}
    plain = {"fc": lambda p, i: lx.plain_fc(p, i["I"], i["W"]),
             "conv": lambda p, i: lx.plain_conv(p, i["I"], i["W"]),
             "pool": lambda p, i: lx.plain_pool(p, i["I"]),
             "eltwise": lambda p, i: lx.plain_eltwise(p, [i["A"], i["B"]])}

    def library(p, i):
        L = p.layer
        if p.kind == "fc":
            return torch.matmul(i["I"], i["W"])
        if p.kind == "conv":
            return F.conv2d(i["I"], i["W"], stride=int(L.meta["stride"]))
        if p.kind == "pool":
            return F.max_pool2d(i["I"], (int(L.meta["R"]),
                                         int(L.meta["S"])),
                                stride=int(L.meta["stride"]))
        return torch.add(i["A"], i["B"])

    rows = []
    t_phase = time.perf_counter()
    for k, (where, plan) in distinct.items():
        inputs = lx.make_inputs(plan, seed=0, device=dev)
        out = run[plan.kind](plan, inputs)
        t0 = time.perf_counter()
        want = plain[plan.kind](plan, inputs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if out.shape != want.shape:
            raise AssertionError(f"{plan.describe()}: kernel shape "
                                 f"{tuple(out.shape)} vs {tuple(want.shape)}")
        abs_err = float((out - want).abs().max())
        rel_err = abs_err / (float(want.abs().max()) + 1e-9)
        if not rel_err <= KERNEL_TOL:
            raise AssertionError(f"{plan.kind} kernel disagrees with its "
                                 f"plain version on {plan.describe()}: "
                                 f"rel err {rel_err:.3e}")
        del want
        for _ in range(2):
            run[plan.kind](plan, inputs)
            library(plan, inputs)
        ms = events_ms(lambda: run[plan.kind](plan, inputs), 10)
        lib_ms = events_ms(lambda: library(plan, inputs), 10)
        ops, nbytes = work(plan)
        row = {"plan": where, "kind": plan.kind,
               "describe": plan.describe(), "resnet_uses": resnet_uses[k],
               "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "ops": ops, "bytes": nbytes,
               "ops_ms": ops / peak_ops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3}
        rows.append(row)
        log(f"[kernel] {plan.kind:7s} {where:32s} rel {rel_err:.2e} | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, library "
            f"{lib_ms:.4f} ms, bound "
            f"{max(row['ops_ms'], row['bytes_ms']):.4f} ms | "
            f"{plan.describe()}")
        del inputs, out
    log(f"[kernels] {len(rows)} distinct plans checked in "
        f"{time.perf_counter() - t_phase:.1f} s")
    detail["plans"] = rows

    # 3./4. end to end -------------------------------------------------------
    e2e = {}
    for net_name, hw_name in (("resnet", "eyeriss_16x16"),
                              ("alexnet", "eyeriss_16x16")):
        nplan = nplans[(net_name, hw_name)]
        inputs = make_network_inputs(nplan, seed=0, device=dev)
        runner = network_runner(nplan, inputs, device=dev)
        torch.cuda.synchronize()
        lx.reset_launch_counts()
        ex = runner()
        launches = dict(lx.LAUNCHES)
        expect = collections.Counter(nplan.plans[n].kind
                                     for n in nplan.order)
        for kind, count in launches.items():
            if count != expect.get(kind, 0):
                raise AssertionError(f"{net_name}: {kind} launched {count} "
                                     f"times, plan has {expect.get(kind, 0)}")
        ver = compare_network(nplan, ex, inputs, tol=NETWORK_TOL)
        if not ver.ok:
            raise AssertionError(f"{net_name}: layer {ver.worst_layer} rel "
                                 f"err {ver.max_rel_err:.3e} > {NETWORK_TOL}")
        for n in nplan.order:
            if not bool(torch.isfinite(ex.outputs[n]).all()):
                raise AssertionError(f"{net_name}: {n} has non-finite values")
        del ex
        ms = measure_network(nplan, runner=runner, warmup=1, iters=3) * 1e3
        profile = device_profile(runner)
        log(f"[profile] {net_name}: {json.dumps(profile)}")
        e2e[net_name] = {"hw": hw_name, "launches": launches,
                         "worst_layer": ver.worst_layer,
                         "max_rel_err": ver.max_rel_err,
                         "n_forwarded": ver.n_forwarded,
                         "n_roundtrips": len(nplan.order) - ver.n_forwarded,
                         "measure_network_ms": ms, "profile": profile}
        log(f"[e2e] {net_name} b64 on {hw_name}: launches {launches}, worst "
            f"layer {ver.worst_layer} rel err {ver.max_rel_err:.3e}, "
            f"{ver.n_forwarded} forwarded, measure_network {ms:.2f} ms")
        del runner, inputs
        torch.cuda.empty_cache()
    detail["e2e"] = e2e

    # 5. the kernels line ----------------------------------------------------
    kernels = []
    for kind in ("fc", "conv", "pool", "eltwise"):
        mine = [r for r in rows if r["kind"] == kind]
        res = [r for r in mine if r["resnet_uses"]]

        def per_forward(field):
            return sum(r[field] * r["resnet_uses"] for r in res)
        ops_ms, bytes_ms = per_forward("ops_ms"), per_forward("bytes_ms")
        kernels.append({
            "name": kind, "route": "cuda", "source": lx.SOURCE,
            "replaces": lx.REPLACES[kind],
            "launches": e2e["resnet"]["launches"][kind],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": sum(max(r["ops_ms"], r["bytes_ms"]) * r["resnet_uses"]
                            for r in res),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": per_forward("library_ms")})
    detail["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log("(times of the kernels line: per ResNet-50 b64 forward, summed over "
        "its layers at their plans' shapes)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
