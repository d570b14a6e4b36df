#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py               # every phase below
    python3 chip_smoke.py --check-only  # phases 1-2, untimed, then stop

Phases, in order; any failure exits non-zero:

1. build ``src/repro_torch/csrc/lower_kernels.cu`` and ``model_kernels.cu``
   for sm_90a, one nvcc each, both started together; print ptxas's report
   and each redesigned kernel's registers and spills (``[ptxas]``);
2. hold each of the five layer-tier kernels (fc, conv, pool, eltwise,
   attention, the last on both of its paths) against its plain PyTorch
   version on the card, at every distinct (kind, shape, grid order) among
   the plans of ResNet-50 b64 and AlexNet b64 on the 16x16 Eyeriss
   template and the 4x4 one, and the attention plans: the Zamba2-1.2B
   shared block on both templates, a 4096-token sequence whose plan puts C
   outermost, head dims 16, 32, 128 and 256, and every attention plan of
   the full calibration sweep.  Max rel error <= 1e-5 (both float32, only
   the summation order differs; fc, conv and attention in 3xTF32 on the
   tensor cores hold the same limit; eltwise bit for bit, at two operands
   and at ``ELTWISE_MANY`` (chained launches)); time the kernel, the plain
   version and one PyTorch library call on the same inputs;
3. ResNet-50 b64 end to end: solve -> lower_network -> network_runner on
   the card, with the launch counters set to 0 just before the run and
   read just after (each must equal the plan's layer count of its kind);
   every layer within 1e-3 of the torch oracles; measure_network, its
   predicted latency recorded as drift;
4. the same for AlexNet b64;
4b. the fused tier (``lower/fuse.py``: the whole plan replayed as one CUDA
   graph over the same kernels) for ResNet-50 b64 and AlexNet b64: a
   replay with ``keep="all"`` bit for bit equal to the per-layer run of
   phases 3-4, within 1e-3 of the torch oracles; the launch counters set
   to 0 just before one replay and read just after (each must equal the
   plan's layer count of its kind); the capture's seconds; the
   ``keep="boundary"`` variant (the one measured) bit for bit equal to the
   per-layer run on what it returns; three ``measure_network`` calls
   (fused, each the min of 3 after 1 warm-up) beside phase 3-4's
   per-layer time; one replay under ``torch.profiler``; peak memory; a
   fresh lowering of the same schedule served from the cache with zero
   recaptures; the memory after ``clear_cache()``, which must be back
   within ``MEMORY_SLACK`` of the allocation before the capture (the
   inputs alone);
4c. ``autotune_network`` on AlexNet b64 (k=3) on the card, every
   candidate verified within 1e-3 on the fused tier, its report printed;
   then the quickstart's steps (``repro_torch.quickstart``): the service
   solve and its store hit, random search, conv3 and AlexNet b1 verified
   and measured on both tiers, and the reference's headline (AlexNet b64:
   162.82 mJ, 66.56 ms);
4d. the mesh executor (``lower/meshexec.py``): ResNet-50 b64 on the 16x16
   template over ``plan_multinode(..., NodeMesh(nodes=4))``, as segment
   tasks of both tiers (per-layer; fused: each segment's CUDA graph,
   captured when the tasks are built): every request's outputs bit for
   bit equal to the per-layer run of phase 3 on the same tensors; the
   launch counters set to 0 just before the first request and read just
   after (each kind equal to the plan's layer count); that request is the
   warm-up of three timed ones; one more under ``torch.profiler``
   (``[profile] mesh``); a chaos request with ``node.crash`` injected on
   the node it lands on (failures and re-partitions >= 1, not degraded,
   outputs still bit for bit equal, no capture after the tasks were
   built); one ``[mesh]`` line: request seconds of both tiers (min of 3
   after 1 warm-up) beside phase 3's per-layer and phase 4b's fused
   ``measure_network``, the boundary bytes a request copies to the host
   and each executor's ``stats()``;
5. the calibration sweep on the card, 4x4 template: ``run_calibration``
   (full sweep; every pair verified within 1e-3, >= 20 pairs, launches per
   kind = (1 + iters) x its pairs, counters set to 0 just before and read
   just after) and ``run_network_calibration`` (full: mlp b4,
   transformer2 b8, lstm b64, alexnet b1; launches = 3 x each net's
   layers of the kind); then the drift watchdog over the record and the
   live ``latency_drift_ratio`` histogram.  The record's stored
   ``spearman_calibrated`` must match its pairs (0.05); R^2, rank
   correlation and drift quantiles are printed, not gated.  Records go to
   ``chiprun_out/calibration_torch.json`` and
   ``network_calibration_torch.json``;
6. the solver flight recorder: AlexNet b64 solved with ``explain=True``
   on the 16x16 template, its render's first lines printed;
7. hold the two model-zoo kernels against their plain versions on the
   card: flash attention at the Qwen2.5-3B, Zamba2-1.2B and Qwen2-MoE-A2.7B
   serve prefill shapes (bf16), a Gemma2-like case (D=256, window,
   soft-cap), a right-aligned case (Sq < Sk), all five on the tensor-core
   path, and a
   non-causal float32 case on the FMA tile; the SSD
   intra-chunk term (tensor cores, 3xTF32) at the Mamba2-1.3B and
   Zamba2-1.2B shapes in bf16, Zamba2-1.2B's in float32, and a chunk of
   256 with head dim 128 in float32.  float32
   within 1e-5 max rel error, bf16 within 8e-3 x max|plain| (one bf16
   ulp); time the kernel, the plain version and, where one PyTorch call
   computes the same function, ``F.scaled_dot_product_attention``; at the
   three serve prefill shapes and the f32 case, also the kernel's
   log-sum-exp output (``return_lse=True``, which the training path's
   backward reads) against the plain version's, max abs error <=
   ``LSE_TOL`` (both f32 from the same operands), its output within the
   same limits, and the kernel's time with the lse store;
8. serve Qwen2.5-3B, Zamba2-1.2B and Qwen2-MoE-A2.7B at full width in bf16
   (8 requests, 512-token prompts, 32 generated tokens) through ``serve``,
   with the launch counters set to 0 just before and read just after:
   flash 36 for Qwen; flash 6 and SSD 38 for Zamba2; flash 24 for
   Qwen2-MoE, every flash launch on the tensor-core path (decode runs no
   kernel); finite
   logits, tokens [8, 32]; then one prefill and 8 decode steps under
   ``torch.profiler``;
9. consistency, float32, full width, reduced depth (Qwen 4 layers, Zamba2
   12): the prefill's last-token logits (through the kernels) against a
   replay of the prompt through ``decode_step`` (no kernel), max rel error
   <= 1e-3; Qwen2-MoE at 2 layers (4 x 64 tokens): the card's prefill
   against the same prefill through the plain versions on the host's CPU,
   same weights, <= 1e-3, and the (token, slot) pairs capacity dropped,
   equal on both;
10. train Zamba2-1.2B at full width and depth in bf16 through
   ``launch/train.py`` ``train`` (4 steps, 8 x 512 tokens, AdamW, no
   checkpoints), with the launch counters set to 0 just before and read
   just after: flash 24 (all ``wgmma``) and SSD 152, 6 and 38 a step, all
   in the forward (the backwards are PyTorch, as the reference's are jnp);
   every loss finite; the step seconds (min of steps 2-4), tokens/s and
   peak memory; then one step of a fresh model under ``torch.profiler``:
   device ms by group (the two kernels, matmul, the optimizer's
   ``record_function`` range, the rest) and the idle share;
11. the f32 training path on the card against the host's CPU: Zamba2 at
   full width cut to 6 layers (one shared-attention call), 2 x 128
   tokens, the same weights, TF32 off: the loss within 1e-4 relative,
   every gradient leaf within 1e-3 of its leaf's max |g| (the FMA flash
   kernel with its lse, the f32 SSD kernel and both backwards against the
   plain versions);
12. checkpoints at full width cut to 6 layers (2 x 256 tokens): ``train``
   with a checkpoint every 2 steps and a failure injected at step 3 must
   recover once (``restarts == 1``) with finite losses; 2 more steps
   resumed from its directory must match the same steps of one
   uninterrupted run within 1e-3 relative (the embedding gather's
   backward adds with atomics on the card, so not bit for bit);
13. the dry-run (``launch/dryrun.py``, ``[dryrun]``): (a) every cell, 10
   archs x 4 shapes x both production meshes, traced on meta with the
   H100's roofline (``H100Spec()``), 0 failures, skips only the
   reference's (``python -m repro_torch.launch.dryrun --both-meshes`` run
   in process), records to ``chiprun_out/dryrun_torch.json``, its output
   to ``chiprun_out/dryrun_torch.log``; (b) ``[dryrun-check]``: the
   Zamba2-1.2B train step (phase 10's configuration) and the Qwen2.5-3B
   prefill, 8 x 512 in bf16 at full width and depth, each traced on meta
   and then run once on the card under the same counter
   (``launch/op_cost.py``), the launch counters set to 0 just before and
   read just after: the FLOPs, bytes and kernel units counted on the card
   equal the meta trace's; the meta trace's peak within
   ``DRYRUN_PEAK_TOL`` of the card's peak allocation over the step; the
   plan (``core/autoshard.py`` on the one-card mesh) beside the measured
   peak; the roofline step time beside the measured step seconds (min of
   ``DRYRUN_TIMED`` steps after the counted one), the roofline fraction
   and the model FLOPs over the step at 989 TFLOP/s, with the card's name
   and power limit;
14. print ``{"kernels": [...]}`` (flash and SSD count phase 8's, phase
   10's and phase 13's launches), the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Every ``[kernel]`` line and ``kernels`` entry names the path that ran:
``wgmma`` (flash attention's tensor-core kernel, bf16), ``mma-3xtf32`` (fc,
conv, attention at head dims up to 128 and the SSD intra-chunk term on the
tensor cores) or ``fma`` (the CUDA cores: pool, eltwise, attention at head
dim 256).  ``ms`` and
``library_ms`` are ``stream_ms``: 20 calls back to back between two CUDA
events, the median of 5 such means.  A layer-tier kernel and its library
call cycle through copies of their inputs (``cold_copies``) that together
pass twice the L2, so each call reads its operands from device memory, as a
layer of a network forward finds its weights; the model-zoo kernels reuse
one set, since in a prefill the operation just before writes q, k and v.
``plain_ms`` is one call on the host clock.  The ``[kernel]`` summary lines
of the redesigned kernels (fc, flash, conv, attention, eltwise, SSD) quote
their time before the redesign, copied from PERF.md and not measured here.
A bound is read at the rate of the path: bf16 on the tensor cores for
``wgmma``; for ``mma-3xtf32`` the TF32 rate over 3, since every
multiply-add is three TF32 products (hi*hi + hi*lo + lo*hi) that keep the
float32 contract; the FP32 rate of the CUDA cores for ``fma``; bytes at
the device-memory rate for all.

Details go to ``chiprun_out/chip_smoke.json`` beside this script.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 1e-5
BF16_TOL = 8e-3
NETWORK_TOL = 1e-3
MEMORY_SLACK = 8 << 20      # bytes clear_cache() may leave allocated
CONSISTENCY_TOL = 1e-3

#: published peaks (NVIDIA H100 data sheet, dense, no sparsity): FP32 on
#: the CUDA cores, device-memory bandwidth, bf16 on the tensor cores
#: (989 TFLOP/s SXM, 756 TFLOP/s PCIe) and TF32 on the tensor cores (495
#: SXM, 378 PCIe)
PEAKS = {"PCIe": (51.2e12, 2.0e12, 756e12, 378e12),
         "SXM": (67e12, 3.35e12, 989e12, 495e12)}
#: the path each kernel runs (flash: its serve path, bf16)
#: (attention: at the kernels line's case, head dim 64; the path by head
#: dim is ``lower/exec.py`` ``ATTN_PATHS``)
PATHS = {"fc": "mma-3xtf32", "conv": "mma-3xtf32", "pool": "fma",
         "eltwise": "fma", "attention": "mma-3xtf32",
         "flash_attention": "wgmma", "ssd_intra_chunk": "mma-3xtf32"}
#: the redesigned kernels' times before the redesign, per the kernels
#: line's unit (copied from PERF.md's kernel table, "earlier ms"; NVIDIA
#: H100 80GB HBM3, 700.00 W; fc and flash one call between two CUDA events,
#: the others this script's method).  Logged beside this run's times, never
#: put in the kernels line.
EARLIER_MS = {"fc": 0.3468, "conv": 91.81,
              "attention": 1.1872, "eltwise": 1.823,
              "ssd_intra_chunk": 14.25}
#: the kernels whose ptxas registers and spills ``[ptxas]`` reports
REDESIGNED = ("flash_wgmma_kernel", "fc_kernel", "fc_reduce_kernel",
              "conv_kernel", "attention_mma_kernel", "eltwise_kernel",
              "ssd_intra_kernel")
#: the eltwise case past one launch's operands (chained launches)
ELTWISE_MANY = 9

#: the serve phase: arch -> kernel launches per prefill
SERVE = {"qwen2.5-3b": {"flash_attention": 36, "flash_attention_wgmma": 36,
                        "ssd_intra_chunk": 0},
         "zamba2-1.2b": {"flash_attention": 6, "flash_attention_wgmma": 6,
                         "ssd_intra_chunk": 38},
         "qwen2-moe-a2.7b": {"flash_attention": 24,
                             "flash_attention_wgmma": 24,
                             "ssd_intra_chunk": 0}}
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
#: the consistency phase: arch -> depth
CONSISTENCY = {"qwen2.5-3b": 4, "zamba2-1.2b": 12}
#: the MoE consistency row: arch, depth, requests and prompt length (short
#: enough for the plain versions on the host's CPU)
MOE_CONSISTENCY = ("qwen2-moe-a2.7b", 2, 4, 64)
#: phase 7's flash cases whose log-sum-exp output is held against the plain
#: version's (the three serve prefills on the tensor-core path, the f32 FMA
#: case), and its limit: both are f32 from the same operands
LSE_CASES = ("qwen2.5-3b", "zamba2-1.2b", "qwen2-moe-a2.7b", "non-causal-f32")
LSE_TOL = 1e-4
#: the training phase: arch, steps, batch, sequence, full width and depth
#: in bf16, and the kernel launches over its steps (6 flash, all on the
#: tensor cores, and 38 SSD a step, all in the forward: remat is "none",
#: so the backward runs no kernel)
TRAIN = ("zamba2-1.2b", 4, 8, 512)
TRAIN_LAUNCHES = {"flash_attention": 24, "flash_attention_wgmma": 24,
                  "ssd_intra_chunk": 152}
#: the f32 training row, card against the host CPU: depth, batch,
#: sequence; the loss's limit (relative) and each gradient leaf's (of its
#: max |g|)
TRAIN_CONSISTENCY = (6, 2, 128)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
#: the checkpoint row: depth, batch, sequence, and the limit (relative) on
#: a resumed step's loss against the same step of an uninterrupted run
CKPT_RUN = (6, 2, 256)
RESUME_TOL = 1e-3
#: the dry-run phase (``launch/dryrun.py``): (a) every cell, 10 archs x 4
#: shapes x both meshes, traced on meta with ``H100Spec()``; (b) two steps
#: held against the card at full width and depth in bf16 on the one-card
#: mesh: arch, mode, batch, sequence and the kernel launches of one step
#: (Zamba2's is phase 10's configuration: AdamW, remat "none")
DRYRUN_CHECKS = (
    ("zamba2-1.2b", "train", 8, 512,
     {"flash_attention": 6, "flash_attention_wgmma": 6,
      "ssd_intra_chunk": 38}),
    ("qwen2.5-3b", "prefill", 8, 512,
     {"flash_attention": 36, "flash_attention_wgmma": 36,
      "ssd_intra_chunk": 0}))
#: the meta trace's peak against the card's peak allocation over the step
#: (relative), and the timed steps after the counted one
DRYRUN_PEAK_TOL = 0.25
DRYRUN_TIMED = 3
#: attention plans held against the plain version besides the calibration
#: sweep's: layer name, (batch, heads, sequence, head dim), template.  The
#: first (the Zamba2-1.2B shared block on the 16x16 template) times the
#: kernels line's attention entry.
ATTENTION_CASES = [("zamba2.attn", (8, 32, 512, 64), "16x16"),
                   ("zamba2.attn", (8, 32, 512, 64), "4x4"),
                   ("long4k", (1, 8, 4096, 64), "4x4"),
                   ("d16", (2, 8, 256, 16), "4x4"),
                   ("d32", (2, 8, 256, 32), "4x4"),
                   ("d128", (1, 4, 256, 128), "16x16"),
                   ("d256", (1, 4, 256, 256), "16x16")]
#: the calibration phase: the watchdog's limit on the stored vs recomputed
#: rank correlation of a record, and the sweep's timed iterations
STALE_TOL = 0.05
CAL_ITERS = 2


def peaks(name: str):
    return PEAKS["PCIe"] if "PCIe" in name else PEAKS["SXM"]


def log(*a) -> None:
    print(*a, flush=True)


def calibration_phase(dev, out_dir: Path):
    """Phase 5: both calibration sweeps on the card, then the watchdog."""
    from repro_torch.core.solver import solve
    from repro_torch.lower import calibrate as cal
    from repro_torch.lower import exec as lx
    from repro_torch.lower import lower_network
    from repro_torch.obs import metrics, watch

    t0 = time.perf_counter()
    lx.reset_launch_counts()
    rec = cal.run_calibration(quick=False, device=dev, iters=CAL_ITERS)
    launches = dict(lx.LAUNCHES)
    cal_s = time.perf_counter() - t0
    numerics = [s for s in rec["skipped"] if "numerics" in s["reason"]]
    if numerics or rec["n_pairs"] < 20 or rec["backend"] != "cuda":
        raise AssertionError(f"calibration: {rec['n_pairs']} pairs, backend "
                             f"{rec['backend']}, numerics skips {numerics}")
    pairs = collections.Counter(p["kind"] for p in rec["pairs"])
    head_dim = {layer.name: layer.dim("K")
                for layer in cal.default_sweep(False)}
    pairs["attention_mma"] = sum(
        1 for p in rec["pairs"] if p["kind"] == "attention"
        and lx.ATTN_PATHS[lx.attention_head_dim(head_dim[p["layer"]])]
        == "mma-3xtf32")
    for kind, count in launches.items():
        if count != (1 + CAL_ITERS) * pairs.get(kind, 0):
            raise AssertionError(f"calibration: {kind} launched {count} "
                                 f"times for {pairs.get(kind, 0)} pairs")
    worst = max(rec["pairs"], key=lambda p: p["rel_err"])
    log(f"[calibrate] {rec['n_pairs']} pairs ({dict(pairs)}) on {rec['hw']} "
        f"in {cal_s:.1f} s, launches {launches}, skipped {rec['skipped']}, "
        f"worst rel err {worst['rel_err']:.2e} ({worst['layer']}), "
        f"spearman raw {rec['spearman_raw']!r} calibrated "
        f"{rec['spearman_calibrated']!r}, fit {rec['calibration']}")

    t0 = time.perf_counter()
    hw = cal.default_hw()
    nets = cal.default_network_sweep(quick=False)
    lx.reset_launch_counts()
    net_rec = cal.run_network_calibration(quick=False, device=dev,
                                          iters=CAL_ITERS)
    net_launches = dict(lx.LAUNCHES)
    net_s = time.perf_counter() - t0
    if net_rec["skipped"] or net_rec["n_nets"] != len(nets):
        raise AssertionError(f"network calibration: {net_rec['skipped']}")
    expect = collections.Counter()
    for net in nets:                         # solves are memoized
        nplan = lower_network(solve(net, hw), net, hw)
        for n in nplan.order:
            plan = nplan.plans[n]
            expect[plan.kind] += 1 + CAL_ITERS
            if plan.kind == "attention" and lx.ATTN_PATHS[
                    lx.attention_head_dim(plan.layer.dim("K"))] \
                    == "mma-3xtf32":
                expect["attention_mma"] += 1 + CAL_ITERS
    if net_launches != {k: expect.get(k, 0) for k in net_launches}:
        raise AssertionError(f"network calibration: launches {net_launches}"
                             f", plans {dict(expect)}")
    log(f"[calibrate] network sweep {[e['net'] for e in net_rec['nets']]} "
        f"in {net_s:.1f} s, launches {net_launches}, worst rel err "
        f"{max(e['max_rel_err'] for e in net_rec['nets']):.2e}, "
        f"spearman_network {net_rec.get('spearman_network')!r}, measured "
        f"ms {[e['measured_seconds'] * 1e3 for e in net_rec['nets']]}")

    report = watch.run_watch(calibrations=[("cuda", rec)],
                             snapshot=metrics.REGISTRY.snapshot())
    log("[watch] " + watch.render_report(report).replace("\n", "\n[watch] "))
    health = report["calibration"]["cuda"]
    if abs(health["stored_rank_corr"] - health["rank_corr"]) > STALE_TOL:
        raise AssertionError(f"calibration record is malformed: stored "
                             f"spearman {health['stored_rank_corr']} vs "
                             f"recomputed {health['rank_corr']}")
    out_dir.mkdir(exist_ok=True)
    cal.save_record(rec, str(out_dir / "calibration_torch.json"))
    cal.save_record(net_rec, str(out_dir / "network_calibration_torch.json"))
    return {"seconds": cal_s, "network_seconds": net_s,
            "n_pairs": rec["n_pairs"], "pairs_by_kind": dict(pairs),
            "launches": launches, "network_launches": net_launches,
            "spearman_raw": rec["spearman_raw"],
            "spearman_calibrated": rec["spearman_calibrated"],
            "calibration": rec["calibration"],
            "spearman_network": net_rec.get("spearman_network"),
            "watch": {"ok": report["ok"], "calibration": health,
                      "drift": report.get("drift"),
                      "samples": report.get("samples")}}


def fused_phase(dev, nplans, scheds, predicted, e2e):
    """Phase 4b: the fused tier for ResNet-50 b64 and AlexNet b64 on the
    16x16 template (see the module docstring)."""
    import torch
    from repro_torch.lower import (cache_stats, clear_cache, compare_network,
                                   fused_runner, lower_network,
                                   make_network_inputs, measure_network,
                                   network_runner)
    from repro_torch.lower import exec as lx
    out = {}
    clear_cache()
    for net_name in ("resnet", "alexnet"):
        key = (net_name, "eyeriss_16x16")
        nplan = nplans[key]
        inputs = make_network_inputs(nplan, seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()     # the inputs alone
        want = {n: v.to(dev) for n, v in
                network_runner(nplan, inputs, device=dev)().outputs.items()}
        torch.cuda.reset_peak_memory_stats()
        run = network_runner(nplan, inputs, device=dev, fused=True)
        first_ms = host_ms(run)[1]
        net = fused_runner(nplan, device=dev)
        capture_s = net.capture_seconds[("net", "all")]
        torch.cuda.synchronize()
        lx.reset_launch_counts()
        ex = run()
        launches = dict(lx.LAUNCHES)
        expect = collections.Counter(nplan.plans[n].kind
                                     for n in nplan.order)
        for kind, count in launches.items():
            if count != expect.get(kind, 0):
                raise AssertionError(f"fused {net_name}: {kind} launched "
                                     f"{count} times a replay, plan has "
                                     f"{expect.get(kind, 0)}")
        unequal = [n for n in nplan.order
                   if not torch.equal(ex.outputs[n], want[n])]
        if unequal:
            raise AssertionError(f"fused {net_name}: {len(unequal)} layer "
                                 f"outputs differ from the per-layer run, "
                                 f"first {unequal[0]}")
        ver = compare_network(nplan, ex, inputs, tol=NETWORK_TOL)
        if not ver.ok:
            raise AssertionError(f"fused {net_name}: layer "
                                 f"{ver.worst_layer} rel err "
                                 f"{ver.max_rel_err:.3e} > {NETWORK_TOL}")
        del ex
        # the variant measure_network times: equal on what it returns
        bound = network_runner(nplan, inputs, device=dev, keep="boundary",
                               fused=True)
        got = bound().outputs
        unequal = [n for n, v in got.items() if not torch.equal(v, want[n])]
        if not got or unequal:
            raise AssertionError(f"fused {net_name}: the boundary variant "
                                 f"returned {len(got)} outputs, "
                                 f"{len(unequal)} differ from the per-layer "
                                 f"run")
        n_boundary = len(got)
        del got, want
        ms = [measure_network(nplan, inputs, device=dev, iters=3, warmup=1,
                              predicted_seconds=predicted[key]) * 1e3
              for _ in range(3)]
        profile = device_profile(bound)
        log(f"[profile] fused {net_name}: {json.dumps(profile)}")
        peak = torch.cuda.max_memory_allocated()
        # a fresh lowering of the same schedule: a cache hit, no capture
        traces, hits = net.traces, cache_stats()["hits"]
        sched, graph, hw = scheds[key]
        again = lower_network(sched, graph, hw)
        if fused_runner(again, device=dev) is not net:
            raise AssertionError(f"fused {net_name}: a fresh lowering "
                                 "missed the cache")
        network_runner(again, inputs, device=dev, keep="boundary",
                       fused=True)()
        if net.traces != traces or cache_stats()["hits"] != hits + 2:
            raise AssertionError(f"fused {net_name}: the cache hit "
                                 f"captured again ({net.traces} captures, "
                                 f"{traces} before)")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        net_bytes = net.nbytes
        del run, bound, net, again
        clear_cache()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        if after > base + MEMORY_SLACK:
            raise AssertionError(f"fused {net_name}: clear_cache() left "
                                 f"{after - base} bytes above the "
                                 "allocation before the capture")
        del inputs
        per_ms = e2e[net_name]["measure_network_ms"]
        out[net_name] = {
            "launches": launches, "max_rel_err": ver.max_rel_err,
            "bitwise_equal_layers": len(nplan.order),
            "first_call_ms": first_ms, "capture_seconds": capture_s,
            "captures": traces, "measure_network_ms": ms,
            "measure_network_spread_ms": max(ms) - min(ms),
            "per_layer_measure_network_ms": per_ms, "profile": profile,
            "boundary_outputs": n_boundary, "peak_bytes": peak,
            "base_bytes": base, "held_bytes": held, "net_bytes": net_bytes,
            "after_clear_bytes": after,
            "reserved_after_clear_bytes": torch.cuda.memory_reserved()}
        log(f"[fused] {net_name} b64: {len(nplan.order)} layers bit for bit "
            f"equal to the per-layer run ({n_boundary} in the boundary "
            f"variant), rel err {ver.max_rel_err:.3e}, "
            f"launches a replay {launches}, capture {capture_s:.3f} s "
            f"(first call {first_ms:.1f} ms), measure_network "
            f"{', '.join(f'{m:.3f}' for m in ms)} ms (spread "
            f"{max(ms) - min(ms):.3f}; per-layer {per_ms:.2f} ms), peak "
            f"{peak / 2**30:.2f} GiB, held {held / 2**30:.2f} GiB (the "
            f"network {net_bytes / 2**30:.2f}), after clear_cache() "
            f"{after} B (before the capture, the inputs alone: {base} B)")
    return out


def service_phase(dev):
    """Phase 4c: autotune AlexNet b64 (k=3) on the card, then the
    quickstart's steps."""
    import tempfile
    from repro_torch import quickstart
    from repro_torch.hw.presets import eyeriss_multinode
    from repro_torch.lower import clear_cache
    from repro_torch.service import ScheduleStore, autotune_network
    from repro_torch.workloads.nets import get_net

    with tempfile.TemporaryDirectory(prefix="chip-smoke-store-") as root:
        report = autotune_network(get_net("alexnet", batch=64),
                                  eyeriss_multinode(),
                                  store=ScheduleStore(root), k=3, iters=3,
                                  device=dev)
    clear_cache()
    log(f"[autotune] {json.dumps(report)}")
    if report["skipped"] or report["n_executed"] != 3:
        raise AssertionError(f"autotune: {report['n_executed']} of 3 "
                             f"candidates ran: {report['skipped']}")
    worst = max(e["max_rel_err"] for e in report["candidates"])
    if not worst <= NETWORK_TOL or not report.get("promoted"):
        raise AssertionError(f"autotune: rel err {worst:.3e}, promoted "
                             f"{report.get('promoted')}")
    q = quickstart.run(dev)
    clear_cache()
    if (f"{q['energy_mj']:.2f}", f"{q['latency_ms']:.2f}") != \
            ("162.82", "66.56"):
        raise AssertionError(f"quickstart: headline {q['energy_mj']} mJ, "
                             f"{q['latency_ms']} ms")
    if q["sources"] != ("cold", "cached") or not (q["plan_ok"]
                                                  and q["network_ok"]):
        raise AssertionError(f"quickstart: {q}")
    log(f"[quickstart] {json.dumps(q)}")
    return report, q


def mesh_phase(dev, nplans, scheds, e2e, fused_res):
    """Phase 4d: ResNet-50 b64 (16x16 template) as mesh segment tasks of
    both tiers over ``plan_multinode(..., NodeMesh(nodes=4))``."""
    import numpy as np
    import torch
    from repro_torch.core.solver.multinode import NodeMesh, plan_multinode
    from repro_torch.lower import (clear_cache, fused_runner,
                                   make_network_inputs, network_runner)
    from repro_torch.lower import exec as lx
    from repro_torch.lower.meshexec import MeshExecutor, build_segment_tasks
    from repro_torch.runtime.inject import FaultPlan, FaultSpec, inject

    key = ("resnet", "eyeriss_16x16")
    nplan = nplans[key]
    sched, graph, hw = scheds[key]
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    weights = {k: v for k, v in inputs.items() if k.endswith(".W")}
    ext = {k: v.cpu().numpy() for k, v in inputs.items()
           if k.endswith(".I")}
    # phase 3's per-layer run of the same tensors, kept on the host
    want = {n: v.cpu().numpy() for n, v in network_runner(
        nplan, inputs, device=dev)().outputs.items()}
    expect = collections.Counter(nplan.plans[n].kind for n in nplan.order)
    mplan = plan_multinode(sched, graph, hw, NodeMesh(nodes=4))
    # a fresh executor's first request lands on the first node of
    # segment 0's part: the chaos request's victim
    victim = mplan.part_of_segment(0).node_ids[0]

    def check(tier, what, r):
        if r.degraded or not r.outputs:
            raise AssertionError(f"mesh {tier} {what}: degraded "
                                 f"{r.degraded}, {len(r.outputs)} outputs")
        unequal = [n for n, v in r.outputs.items()
                   if not np.array_equal(v, want[n])]
        if unequal:
            raise AssertionError(f"mesh {tier} {what}: {len(unequal)} "
                                 f"outputs differ from the per-layer run, "
                                 f"first {unequal[0]}")

    out = {"nodes": 4, "victim": victim,
           "parts": [[a.seg_start, a.seg_stop, list(a.node_ids)]
                     for a in mplan.parts],
           "fused_measure_network_ms":
               fused_res["resnet"]["measure_network_ms"],
           "per_layer_measure_network_ms":
               e2e["resnet"]["measure_network_ms"]}
    for tier, backend in (("per-layer", None), ("fused", "compiled")):
        clear_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tasks = build_segment_tasks(nplan, weights, backend=backend,
                                    device=dev)
        build_s = time.perf_counter() - t0
        net = fused_runner(nplan, device=dev) if backend else None
        traces = net.traces if net else 0
        with MeshExecutor(mplan, tasks, schedule=sched, graph=graph,
                          hw=hw) as ex:
            torch.cuda.synchronize()
            lx.reset_launch_counts()
            r = ex.run(ext, "count")
            launches = dict(lx.LAUNCHES)
            for kind, count in launches.items():
                if count != expect.get(kind, 0):
                    raise AssertionError(
                        f"mesh {tier}: {kind} launched {count} times a "
                        f"request, plan has {expect.get(kind, 0)}")
            # the count request is the executor's first: the warm-up
            check(tier, "count request", r)
            host_bytes = sum(v.nbytes for v in r.outputs.values())
            n_out = len(r.outputs)
            seconds = []
            for i in range(3):
                r = ex.run(ext, f"timed{i}")
                seconds.append(r.seconds)
                check(tier, f"request {i}", r)
            stats = ex.stats()
            profile = device_profile(lambda: ex.run(ext, "profiled"))
        log(f"[profile] mesh {tier}: {json.dumps(profile)}")
        faults = FaultPlan.make(4, {"node.crash": FaultSpec(
            rate=1.0, match=f"node{victim}")})
        with MeshExecutor(mplan, tasks, schedule=sched, graph=graph,
                          hw=hw) as ex:
            with inject(faults) as inj:
                r = ex.run(ext, "chaos")
            chaos = ex.stats()
        check(tier, "chaos request", r)
        if chaos["failures"] < 1 or chaos["repartitions"] < 1 \
                or not inj.fired.get("node.crash"):
            raise AssertionError(f"mesh {tier}: the chaos request did not "
                                 f"fail over: {chaos}")
        recaptures = (net.traces - traces) if net else 0
        if recaptures:
            raise AssertionError(f"mesh {tier}: {recaptures} captures after "
                                 "build_segment_tasks")
        out[tier] = {"build_seconds": build_s, "captures": traces,
                     "launches": launches, "request_seconds": seconds,
                     "min_request_seconds": min(seconds),
                     "outputs": n_out, "host_bytes_per_request": host_bytes,
                     "stats": stats, "profile": profile, "chaos": {
                         "replays": r.replays, "seconds": r.seconds,
                         "recaptures": recaptures, **chaos}}
        log(f"[mesh-check] resnet b64 {tier} tasks on 4 nodes ({len(tasks)} "
            f"segments, built in {build_s:.2f} s, {traces} captures): "
            f"{n_out} outputs bit for bit equal to the per-layer run, "
            f"launches a request {launches}; chaos: node{victim} crashed, "
            f"failures {chaos['failures']}, repartitions "
            f"{chaos['repartitions']}, replays {r.replays}, not degraded, "
            f"{recaptures} captures after the build")
        del tasks, net
        clear_cache()
    del inputs, weights, want
    torch.cuda.empty_cache()
    per, fus = out["per-layer"], out["fused"]
    log(f"[mesh] resnet b64 request s (min of 3 after 1 warm-up): per-layer "
        f"tasks {per['min_request_seconds']:.4f} "
        f"({', '.join(f'{x:.4f}' for x in per['request_seconds'])}), fused "
        f"tasks {fus['min_request_seconds']:.4f} "
        f"({', '.join(f'{x:.4f}' for x in fus['request_seconds'])}); fused "
        f"measure_network (phase 4b) "
        f"{', '.join(f'{m:.3f}' for m in out['fused_measure_network_ms'])}"
        f" ms, per-layer (phase 3) "
        f"{out['per_layer_measure_network_ms']:.2f} ms; boundary bytes to "
        f"the host a request: per-layer "
        f"{per['host_bytes_per_request']}, fused "
        f"{fus['host_bytes_per_request']}; stats per-layer "
        f"{json.dumps(per['stats'])}, fused {json.dumps(fus['stats'])}")
    return out


def explain_phase():
    """Phase 6: the solver flight recorder on AlexNet b64."""
    from repro_torch.core.solver import solve
    from repro_torch.hw.presets import eyeriss_multinode
    from repro_torch.obs import explain
    from repro_torch.workloads.nets import get_net

    sched = solve(get_net("alexnet", batch=64), eyeriss_multinode(),
                  explain=True)
    if not sched.explain or not sched.explain.get("funnel"):
        raise AssertionError("explain: no flight-recorder record")
    lines = explain.render(sched.explain).splitlines()
    for line in lines[:24]:
        log(f"[explain] {line}")
    return {"lines": len(lines), "segments": len(sched.explain["funnel"])}


def plan_key(plan):
    """What makes two plans the same kernel case: kind, dims, meta, grid
    order and block."""
    L = plan.layer
    return (plan.kind, tuple(L.dim(d) for d in "NCKXY"),
            tuple(sorted(L.meta.items())),
            tuple((a.dim, a.steps) for a in plan.grid),
            tuple(sorted(plan.block.items())))


def work(plan):
    """(operations, bytes) the layer needs: each input read once, each
    output written once; conv/fc count 2 per multiply-add, attention 4 per
    (query, key, head-dim) point (Q K^T and P V)."""
    L = plan.layer
    d = {k: L.dim(k) for k in "NCKXY"}
    if plan.kind == "attention":
        return (4 * d["N"] * d["X"] * d["C"] * d["K"],
                4 * (2 * d["N"] * d["X"] * d["K"] + 2 * d["N"] * d["C"]
                     * d["K"]))
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
        group = "fc" if "fc_reduce_kernel" in k else \
            "attention" if "attention_mma_kernel" in k else next(
                (f for f in ("fc", "conv", "pool", "eltwise", "attention")
                 if f"{f}_kernel" in k), None)
        if group is None:
            group = "memcpy_dtoh" if "DtoH" in k else \
                "memcpy_htod" if "HtoD" in k else \
                "memcpy_dtod" if "DtoD" in k else "other"
        groups[group] += us / 1e3
    wall_ms = ex.seconds * 1e3
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_ms": dict(groups),
            "device_busy_ms": busy,
            "idle_share": None if not busy else 1.0 - busy / wall_ms}


def host_ms(fn):
    """``fn()`` and its time on the host clock, the card synchronised
    before and after (ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def cold_copies(inputs: dict, max_copies: int = 64) -> list:
    """``inputs`` and copies of it, as many as together pass twice the
    card's L2 (at most ``max_copies``): cycled through, each call reads its
    operands from device memory.  Below 1/32 of the L2 the copies may stay
    cached, but there a read from device memory takes under a
    microsecond."""
    import torch
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", 50 << 20)
    nbytes = sum(t.numel() * t.element_size() for t in inputs.values())
    n = min(max_copies, max(1, -(-2 * l2 // nbytes)))
    return [inputs] + [{k: v.clone() for k, v in inputs.items()}
                       for _ in range(n - 1)]


def stream_ms(fns, launches: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``launches`` back-to-back
    calls between two CUDA events (ms), after a warm-up; ``fns`` is one
    callable or a list of them, called in turn (one per set of
    ``cold_copies``).  The queue stays full, so this is the card's time a
    call where the card is slower than the host, else the host's time a
    call."""
    import torch
    fns = fns if isinstance(fns, list) else [fns]
    for i in range(3):
        fns[i % len(fns)]()
    times, i = [], 3
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fns[i % len(fns)]()
            i += 1
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


#: mangled template arguments: an int, a bool, float, __nv_bfloat16
_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|(f)|13(__nv_bfloat16)")


def _redesigned(mangled: str):
    """The ``REDESIGNED`` kernel a mangled name is (with its template
    arguments, e.g. the head dim or the element type, where it is a
    template), or None."""
    for k in REDESIGNED:
        at = mangled.find(f"{len(k)}{k}")
        if at < 0:
            continue
        rest = mangled[at + len(str(len(k))) + len(k):]
        if not rest.startswith("I"):
            return k
        args, i = [], 1
        while i < len(rest) and rest[i] != "E":
            m = _TEMPLATE_ARG.match(rest, i)
            if not m:
                return k
            arg = next(v for v in m.groups() if v is not None)
            args.append("float" if arg == "f" else arg)
            i = m.end()
        return f"{k}<{','.join(args)}>"
    return None


def ptxas_usage(report: str):
    """Registers and spill bytes of each redesigned kernel in an ``nvcc
    -Xptxas -v`` report."""
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = _redesigned(m.group(1))
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(current, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
            current = None
    return out


def eltwise_many_case(plan, dev, timed: bool):
    """eltwise at ``ELTWISE_MANY`` operands (chained launches, the running
    sum as operand 0 of the second) against plain_eltwise, bit for bit;
    timed beside the same sum as a chain of ``torch.add``."""
    import torch
    from repro_torch.lower import exec as lx
    shape = tuple(plan.layer.dim(d) for d in "NCXY")
    g = torch.Generator(device=dev).manual_seed(ELTWISE_MANY)
    xs = [torch.randn(shape, generator=g, device=dev)
          for _ in range(ELTWISE_MANY)]
    lx.reset_launch_counts()
    out = lx.run_eltwise(plan, xs)
    launches = lx.LAUNCHES["eltwise"]
    chain = len(lx.eltwise_chain(ELTWISE_MANY))
    if launches != chain:
        raise AssertionError(f"eltwise at {ELTWISE_MANY} operands counted "
                             f"{launches} launches, its chain has {chain}")
    want, plain_ms = host_ms(lambda: lx.plain_eltwise(plan, xs))
    if not torch.equal(out, want):
        raise AssertionError(f"eltwise at {ELTWISE_MANY} operands is not "
                             f"bit for bit its plain version on "
                             f"{plan.describe()}")
    res = {"plan": plan.describe(), "operands": ELTWISE_MANY,
           "launches": launches, "bitwise": True, "plain_ms": plain_ms}
    if timed:
        def library():
            acc = xs[0]
            for x in xs[1:]:
                acc = torch.add(acc, x)
            return acc
        res["ms"] = stream_ms(lambda: lx.run_eltwise(plan, xs))
        res["library_ms"] = stream_ms(library)
    log(f"[kernel] eltwise {ELTWISE_MANY} operands ({res['launches']} "
        f"launches) bitwise equal to plain | {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# the model zoo: kernels, serving, consistency
# ---------------------------------------------------------------------------

#: flash cases: name, B, H, KV, Sq, Sk, D, causal, window, softcap, dtype,
#: whether one PyTorch call (SDPA) computes the same function
FLASH_CASES = [
    ("qwen2.5-3b", 8, 16, 2, 512, 512, 128, True, 0, 0.0, "bf16", True),
    ("zamba2-1.2b", 8, 32, 32, 512, 512, 64, True, 0, 0.0, "bf16", True),
    ("gemma2-like", 8, 8, 4, 512, 512, 256, True, 128, 50.0, "bf16", False),
    ("right-aligned", 8, 16, 2, 128, 512, 128, True, 0, 0.0, "bf16", False),
    ("non-causal-f32", 8, 16, 2, 512, 512, 128, False, 0, 0.0, "f32", True),
    ("qwen2-moe-a2.7b", 8, 16, 16, 512, 512, 128, True, 0, 0.0, "bf16",
     True),
]
#: SSD cases: name, B, S, H, P, N, chunk, dtype (the first two are the
#: serve prefills' shapes; then Zamba2-1.2B's in float32, and a chunk of 256
#: with head dim 128: two row tiles, two P tiles)
SSD_CASES = [("mamba2-1.3b", 8, 512, 64, 64, 128, 128, "bf16"),
             ("zamba2-1.2b", 8, 512, 64, 64, 64, 128, "bf16"),
             ("zamba2-1.2b-f32", 8, 512, 64, 64, 64, 128, "f32"),
             ("lc256-p128", 4, 1024, 32, 128, 64, 256, "f32")]


def kernel_row(name, path, out, want, ms, plain_ms, library_ms, ops, nbytes,
               peak_ops, peak_bw, dtype):
    """One checked and timed kernel case on ``path``; raises past the
    tolerance.  ``ms`` and ``library_ms`` are ``stream_ms``."""
    abs_err = float((out.float() - want.float()).abs().max())
    rel_err = abs_err / (float(want.float().abs().max()) + 1e-9)
    tol = KERNEL_TOL if dtype == "f32" else BF16_TOL
    if out.shape != want.shape or not rel_err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: rel err {rel_err:.3e} > {tol} "
                             f"(shapes {tuple(out.shape)}, "
                             f"{tuple(want.shape)})")
    row = {"case": name, "path": path, "dtype": dtype,
           "max_abs_err": abs_err,
           "max_rel_err": rel_err, "tol": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "ops": ops,
           "bytes": nbytes, "ops_ms": ops / peak_ops * 1e3,
           "bytes_ms": nbytes / peak_bw * 1e3}
    row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
    lib = "-" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"[kernel] {name:24s} {dtype} {path} rel {rel_err:.2e} | kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, library {lib}, bound "
        f"{row['bound_ms']:.4f} ms "
        f"({'operations' if row['ops_ms'] >= row['bytes_ms'] else 'bytes'})")
    return row


def model_kernel_phase(dev, path_ops, peak_bw):
    """Phase 7: both model-zoo kernels against their plain versions
    (``path_ops``: each path's rate of operations)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.op_cost import (flash_bytes, flash_ops,
                                            ssd_bytes, ssd_ops)

    g = torch.Generator(device=dev).manual_seed(0)
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    flash, ssd = [], []
    for (case, B, H, KV, Sq, Sk, D, causal, window, cap, dtype,
         has_lib) in FLASH_CASES:
        t = types[dtype]
        q = torch.randn((B, H, Sq, D), generator=g, device=dev).to(t)
        k = torch.randn((B, KV, Sk, D), generator=g, device=dev).to(t)
        v = torch.randn((B, KV, Sk, D), generator=g, device=dev).to(t)

        with_lse = case in LSE_CASES

        def kern():
            return fa.flash_attention(q, k, v, causal, window, cap)

        def kern_lse():
            return fa.flash_attention(q, k, v, causal, window, cap,
                                      return_lse=True)

        def plain():
            return fa.plain_flash_attention(q, k, v, causal, window, cap,
                                            return_lse=with_lse)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        out = kern()
        want, plain_ms = host_ms(plain)
        lse_row = {}
        if with_lse:
            want, want_lse = want
            out_l, lse = kern_lse()
            lse_err = float((lse - want_lse).abs().max())
            out_err = float((out_l.float() - want.float()).abs().max()
                            / (want.float().abs().max() + 1e-9))
            tol = KERNEL_TOL if dtype == "f32" else BF16_TOL
            if not (lse_err <= LSE_TOL and out_err <= tol):
                raise AssertionError(f"flash {case} with lse: lse abs err "
                                     f"{lse_err:.3e} (limit {LSE_TOL}), "
                                     f"out rel err {out_err:.3e} ({tol})")
            lse_row = {"lse_max_abs_err": lse_err,
                       "lse_out_max_rel_err": out_err,
                       "lse_ms": stream_ms(kern_lse)}
            log(f"[kernel] flash {case} with lse: lse abs err "
                f"{lse_err:.3e}, out rel err {out_err:.3e}, kernel with lse "
                f"{lse_row['lse_ms']:.4f} ms")
            del out_l, lse, want_lse
        ms = stream_ms(kern)
        library_ms = None
        if has_lib:
            lib_err = float((library().float() - want.float()).abs().max())
            if lib_err > 0.05 * float(want.float().abs().max()):
                raise AssertionError(f"{case}: SDPA does not compute the "
                                     f"same function (abs err {lib_err})")
            library_ms = stream_ms(library)
        elem = 2 if dtype == "bf16" else 4
        ops = flash_ops(B, H, Sq, Sk, D, causal, window)
        nbytes = flash_bytes(B, H, KV, Sq, Sk, D, elem)
        path = fa.flash_path(t, D)
        flash.append({**kernel_row(
            f"flash {case}", path, out, want, ms, plain_ms, library_ms, ops,
            nbytes, path_ops[path], peak_bw, dtype), **lse_row})
        del q, k, v, out, want
    for case, B, S, H, P, N, Lc, dtype in SSD_CASES:
        NC = S // Lc
        x = torch.randn((B, H, NC, Lc, P), generator=g,
                        device=dev).to(types[dtype])
        dt = torch.rand((B, H, NC, Lc), generator=g, device=dev) * 0.1 \
            + 1e-3
        a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.5)
        acum = torch.cumsum(dt * a[None, :, None, None], dim=-1)
        b = torch.randn((B, NC, Lc, N), generator=g, device=dev) * 0.5
        c = torch.randn((B, NC, Lc, N), generator=g, device=dev) * 0.5

        def kern():
            return ssd_scan.ssd_intra_chunk(x, dt, acum, b, c)

        def plain():
            return ssd_scan.plain_ssd_intra_chunk(x, dt, acum, b, c)
        out = kern()
        want, plain_ms = host_ms(plain)
        ms = stream_ms(kern)
        ops = ssd_ops(B, H, NC, Lc, P, N)
        nbytes = ssd_bytes(B, H, NC, Lc, P, N, x.element_size())
        path = PATHS["ssd_intra_chunk"]
        ssd.append(kernel_row(f"ssd {case}", path, out, want, ms, plain_ms,
                              None, ops, nbytes, path_ops[path], peak_bw,
                              dtype))
        del x, dt, acum, b, c, out, want
    torch.cuda.empty_cache()
    return {"flash_attention": flash, "ssd_intra_chunk": ssd}


def kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_kernel" in n or "flash_wgmma_kernel" in n:
        return "flash_attention"
    if "ssd_intra_kernel" in n:
        return "ssd_intra_chunk"
    if any(w in n for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                            "cublas", "wgmma", "matmul")):
        return "matmul"
    if "memcpy" in n:
        return "memcpy"
    return "other"


def profile_serving(api, params, prompts, max_len: int, steps: int):
    """One prefill and ``steps`` decode steps under ``torch.profiler``:
    device time by group (the two kernels, matmuls, the rest) and the
    number of device kernels and copies, against the wall clock of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import build_serve_step
    step = build_serve_step(api)
    out = {}
    with torch.inference_mode():
        for what in ("prefill", "decode"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if what == "prefill":
                    logits, cache = api.prefill(params, prompts, max_len)
                else:
                    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                    for i in range(steps):
                        tok, cache = step(params, cache, tok,
                                          prompts.shape[1] + i)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            groups = collections.Counter()
            top = collections.Counter()
            launched = 0
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0)
                if not us or "cuda" not in str(
                        getattr(e, "device_type", "")).lower():
                    continue
                groups[kernel_group(e.key)] += us / 1e3
                top[e.key[:80]] += us / 1e3
                launched += e.count
            busy = sum(groups.values())
            out[what] = {"wall_ms": wall_ms, "device_ms": dict(groups),
                         "device_busy_ms": busy,
                         "device_kernels": launched,
                         "idle_share": None if not busy
                         else 1.0 - busy / wall_ms,
                         "top_kernels_ms": dict(top.most_common(8))}
            if what == "decode":
                out[what]["steps"] = steps
    return out


def serve_phase(dev):
    """Phase 8: every arch of ``SERVE`` at full width in bf16."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import build_model

    results = {}
    for arch, expect in SERVE.items():
        cfg = get_config(arch)
        api = build_model(cfg, device=dev)
        with torch.inference_mode():
            params = api.init(0)
        n_params = sum(p.numel() for p in params.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = serve(arch, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                    gen=SERVE_GEN, tiny=False, seed=0, device=dev,
                    params=params)
        launches = ops.launch_counts()
        if launches != expect:
            raise AssertionError(f"{arch}: launches {launches}, the model "
                                 f"has {expect}")
        if res.tokens.shape != (SERVE_REQUESTS, SERVE_GEN):
            raise AssertionError(f"{arch}: tokens {res.tokens.shape}")
        if not bool(torch.isfinite(res.logits).all()):
            raise AssertionError(f"{arch}: non-finite prefill logits")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            1, min(cfg.vocab_size, 1000),
            size=(SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)).to(dev)
        prof = profile_serving(api, params, prompts,
                               SERVE_PROMPT + SERVE_GEN, 8)
        results[arch] = {
            "params": n_params, "weights_gb": n_params * 2 / 1e9,
            "launches": launches, "prefill_s": res.prefill_seconds,
            "decode_s": res.decode_seconds,
            "decode_tok_s": res.decode_tokens_per_second,
            "peak_memory_gb": peak_gb, "tokens_head": res.tokens[:2].tolist(),
            "profile": prof}
        log(f"[serve] {arch} bf16 full width ({n_params / 1e9:.3f} B "
            f"params): {SERVE_REQUESTS} x {SERVE_PROMPT} prefill "
            f"{res.prefill_seconds:.4f} s, decode "
            f"{res.decode_tokens_per_second:.2f} tok/s, launches {launches}, "
            f"peak memory {peak_gb:.2f} GB")
        log(f"[profile] {arch}: {json.dumps(prof)}")
        del api, params, res
        torch.cuda.empty_cache()
    return results


def consistency_phase(dev):
    """Phase 9: f32 prefill (the kernels) vs a decode replay (no kernel),
    and the MoE row (``moe_consistency``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    results = {}
    for arch, layers in CONSISTENCY.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        api = build_model(cfg, device=dev, dtype=torch.float32)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            1, min(cfg.vocab_size, 1000),
            size=(SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)).to(dev)
        with torch.inference_mode():
            params = api.init(0)
            ops.reset_launch_counts()
            logits, _ = api.prefill(params, prompts, SERVE_PROMPT)
            launches = ops.launch_counts()
            cache = api.init_cache(SERVE_REQUESTS, SERVE_PROMPT)
            for t in range(SERVE_PROMPT):
                step_logits, cache = api.decode_step(
                    params, cache, prompts[:, t:t + 1], t)
            replay = ops.launch_counts()
        if replay != launches:
            raise AssertionError(f"{arch}: the decode replay launched a "
                                 "kernel")
        want = step_logits.float()
        err = float((logits.float() - want).abs().max()
                    / want.abs().max())
        results[arch] = {"layers": layers, "max_rel_err": err,
                         "launches": launches}
        log(f"[consistency] {arch} f32 {layers} layers: prefill vs decode "
            f"replay max rel err {err:.3e}, prefill launches {launches}")
        if not err <= CONSISTENCY_TOL:
            raise AssertionError(f"{arch}: prefill vs replay rel err "
                                 f"{err:.3e} > {CONSISTENCY_TOL}")
        del api, params, cache
        torch.cuda.empty_cache()
    results[MOE_CONSISTENCY[0]] = moe_consistency(dev)
    return results


def moe_consistency(dev):
    """Phase 9's MoE row: an f32 prefill on the card (the kernels) against
    the same prefill through the plain versions on the host's CPU, with the
    same weights.  A decode replay is no reference here: a prefill and a
    decode step see other token counts, so other capacities, and may drop
    other (token, slot) pairs, as the reference's own model does."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import counting_drops

    arch, layers, requests, prompt = MOE_CONSISTENCY
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    api = build_model(cfg, device=dev, dtype=torch.float32)
    host_api = build_model(cfg, device="cpu", dtype=torch.float32)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        1, min(cfg.vocab_size, 1000),
        size=(requests, prompt)).astype(np.int32))
    with torch.inference_mode():
        params = api.init(0)
        host_params = copy.deepcopy(params).cpu()
        ops.reset_launch_counts()
        with counting_drops() as drops:
            logits, _ = api.prefill(params, prompts.to(dev), prompt)
        launches = ops.launch_counts()
        t0 = time.perf_counter()
        with counting_drops() as host_drops:
            want, _ = host_api.prefill(host_params, prompts, prompt)
        host_s = time.perf_counter() - t0
    got = logits.float().cpu()
    err = float((got - want).abs().max() / want.abs().max())
    res = {"layers": layers, "requests": requests, "prompt": prompt,
           "max_rel_err": err, "launches": launches,
           "pairs": drops.pairs, "dropped_pairs": drops.dropped,
           "host_dropped_pairs": host_drops.dropped,
           "host_prefill_seconds": host_s}
    log(f"[consistency] {arch} f32 {layers} layers, {requests} x {prompt} "
        f"tokens: card prefill vs the plain versions on the host max rel "
        f"err {err:.3e}, prefill launches {launches}, capacity dropped "
        f"{drops.dropped} of {drops.pairs} (token, slot) pairs (host "
        f"{host_drops.dropped}; host prefill {host_s:.2f} s)")
    if launches["flash_attention"] != layers:
        raise AssertionError(f"{arch}: {launches} flash launches for "
                             f"{layers} layers")
    if drops.dropped != host_drops.dropped:
        raise AssertionError(f"{arch}: the card dropped {drops.dropped} "
                             f"pairs, the host {host_drops.dropped}")
    if not err <= CONSISTENCY_TOL:
        raise AssertionError(f"{arch}: card vs host prefill rel err "
                             f"{err:.3e} > {CONSISTENCY_TOL}")
    del api, params, host_params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_groups(prof, wall_ms):
    """Device ms of a profiled train step by group (the two kernels,
    matmuls, the optimizer's kernels, the rest), the device kernels
    launched and the idle share.  The optimizer's kernels are those of the
    ops under its ``record_function`` range on the host; the range's own
    span on the device timeline (a user annotation, first to last kernel,
    gaps included) is reported apart and kept out of the kernel sums."""
    from torch.autograd import DeviceType
    groups = collections.Counter()
    launched = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.key == "optimizer" or \
                "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        groups[kernel_group(e.key)] += us / 1e3
        launched += e.count
    busy = sum(groups.values())
    opt = [e for e in prof.events() if e.name == "optimizer"]
    opt_ms = sum(e.device_time_total for e in opt
                 if e.device_type == DeviceType.CPU) / 1e3
    span_ms = sum(e.device_time_total for e in opt
                  if e.device_type != DeviceType.CPU) / 1e3
    groups["optimizer"] = opt_ms
    groups["other"] = groups.get("other", 0.0) - opt_ms
    return {"wall_ms": wall_ms, "device_ms": dict(groups),
            "device_busy_ms": busy, "device_kernels": launched,
            "optimizer_span_ms": span_ms,
            "idle_share": None if not busy else 1.0 - busy / wall_ms}


def profile_train_step(dev, cfg, batch_size: int, seq: int):
    """One warm-up train step, then one under ``torch.profiler``, of a
    fresh model of ``cfg`` (the pieces ``train`` builds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import make_optimizer
    api = build_model(cfg, device=dev, trainable=True)
    params = api.init(1)
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    state = opt.init(dict(params.named_parameters()))
    step = build_train_step(api, opt)
    shape = ShapeConfig("train", seq, batch_size, "train")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                synth_batch(cfg, shape, i, DataConfig(seed=1)).items()}
               for i in range(2)]
    params, state, _ = step(params, state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError("profiled train step: non-finite loss")
    return _train_groups(prof, wall_ms)


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(dev):
    """Phase 10: ``train`` Zamba2-1.2B at full width and depth in bf16,
    with the launch counters set to 0 just before and read just after;
    then one step under the profiler."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    arch, steps, batch, seq = TRAIN
    cfg = get_config(arch)
    _free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, stats = train(arch, steps=steps, batch=batch, seq=seq,
                          tiny=False, device=dev, log_every=1)
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"train {arch}: launches {launches}, the "
                             f"forward has {TRAIN_LAUNCHES}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: losses {losses}")
    step_s = min(stats.step_seconds[1:])
    res = {"arch": arch, "steps": steps, "batch": batch, "seq": seq,
           "launches": launches, "losses": losses,
           "step_seconds": stats.step_seconds, "step_s": step_s,
           "tokens_per_s": batch * seq / step_s, "peak_memory_gb": peak_gb}
    log(f"[train] {arch} bf16 full width and depth, {batch} x {seq} tokens "
        f"a step, AdamW: step {step_s:.4f} s (min of steps 2-{steps}; all "
        f"{[round(x, 4) for x in stats.step_seconds]}), "
        f"{res['tokens_per_s']:.1f} tokens/s, peak memory {peak_gb:.2f} GB, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}")
    _free_card()
    res["profile"] = profile_train_step(dev, cfg, batch, seq)
    log(f"[profile] train {arch}: {json.dumps(res['profile'])}")
    _free_card()
    return res


def train_consistency(dev):
    """Phase 11: the f32 training path on the card (the FMA flash kernel
    with its lse, the f32 SSD kernel, both backwards) against the same
    loss and gradients through the plain versions on the host's CPU, same
    weights and batch, TF32 off."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    layers, batch, seq = TRAIN_CONSISTENCY
    cfg = dataclasses.replace(get_config(TRAIN[0]), num_layers=layers)
    api = build_model(cfg, device=dev, dtype=torch.float32, trainable=True)
    host_api = build_model(cfg, device="cpu", dtype=torch.float32)
    params = api.init(0)
    host_params = copy.deepcopy(params).cpu()
    data = synth_batch(cfg, ShapeConfig("c", seq, batch, "train"), 0,
                       DataConfig(seed=0))
    ops.reset_launch_counts()
    loss = api.loss_fn(params, {k: torch.from_numpy(v).to(dev)
                                for k, v in data.items()})
    loss.backward()
    launches = ops.launch_counts()
    t0 = time.perf_counter()
    host_loss = host_api.loss_fn(host_params, {k: torch.from_numpy(v)
                                               for k, v in data.items()})
    host_loss.backward()
    host_s = time.perf_counter() - t0
    loss, host_loss = float(loss.detach()), float(host_loss.detach())
    loss_err = abs(loss - host_loss) / abs(host_loss)
    host = dict(host_params.named_parameters())
    worst, worst_leaf = 0.0, None
    for name, p in params.named_parameters():
        want = host[name].grad
        err = float((p.grad.cpu() - want).abs().max()
                    / (want.abs().max() + 1e-30))
        if err > worst:
            worst, worst_leaf = err, name
    res = {"layers": layers, "batch": batch, "seq": seq,
           "loss": loss, "host_loss": host_loss,
           "loss_rel_err": loss_err, "worst_grad_err": worst,
           "worst_leaf": worst_leaf, "launches": launches,
           "host_seconds": host_s}
    log(f"[consistency] train {TRAIN[0]} f32 {layers} layers, {batch} x "
        f"{seq} tokens: card vs host CPU loss rel err {loss_err:.3e}, worst "
        f"gradient leaf {worst_leaf} {worst:.3e} of its max |g|, launches "
        f"{launches} (host forward + backward {host_s:.2f} s)")
    if launches != {"flash_attention": layers // cfg.attn_every,
                    "flash_attention_wgmma": 0, "ssd_intra_chunk": layers}:
        raise AssertionError(f"train consistency: launches {launches}")
    if not (loss_err <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"train consistency: loss rel err "
                             f"{loss_err:.3e} (limit {TRAIN_LOSS_TOL}), "
                             f"gradient {worst_leaf} {worst:.3e} (limit "
                             f"{TRAIN_GRAD_TOL})")
    del api, params, host_params
    _free_card()
    return res


def checkpoint_phase(dev):
    """Phase 12: checkpoint, an injected failure and its recovery, and a
    resume, at full width cut in depth: the resumed steps' losses against
    the same steps of one uninterrupted run."""
    import math
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    layers, batch, seq = CKPT_RUN
    cfg = dataclasses.replace(get_config(TRAIN[0]), num_layers=layers)
    run = dict(batch=batch, seq=seq, tiny=False, device=dev, log_every=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        t0 = time.perf_counter()
        failed, stats = train(cfg, steps=6, ckpt_dir=d, ckpt_every=2,
                              fail_at=3, **run)
        recovery_s = time.perf_counter() - t0
        resumed, _ = train(cfg, steps=8, ckpt_dir=d, resume=True, **run)
        on_disk = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(d) for f in fs)
    whole, _ = train(cfg, steps=8, **run)
    errs = [abs(a - b) / abs(b) for a, b in zip(resumed, whole[6:])]
    res = {"layers": layers, "batch": batch, "seq": seq,
           "restarts": stats.restarts, "failed_run_losses": failed,
           "resumed_losses": resumed, "uninterrupted_losses": whole,
           "resume_rel_errs": errs, "recovery_run_s": recovery_s,
           "checkpoint_bytes_on_disk": on_disk}
    log(f"[checkpoint] {TRAIN[0]} {layers} layers bf16: restarts "
        f"{stats.restarts}, losses {[round(x, 4) for x in failed]}; resumed "
        f"steps 6-7 {resumed} vs uninterrupted {whole[6:]} (rel err "
        f"{max(errs):.3e}); {on_disk} bytes of checkpoints kept; the "
        f"failing run {recovery_s:.1f} s")
    if stats.restarts != 1 or not all(math.isfinite(x) for x in failed):
        raise AssertionError(f"checkpoint: restarts {stats.restarts}, "
                             f"losses {failed}")
    if len(resumed) != 2 or not max(errs) <= RESUME_TOL:
        raise AssertionError(f"checkpoint: resumed {resumed} vs "
                             f"uninterrupted {whole[6:]}")
    _free_card()
    return res


def card_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def dryrun_cells(out_dir: Path):
    """Phase 13a: ``python -m repro_torch.launch.dryrun --both-meshes`` in
    process: every arch and shape on both production meshes, on meta, with
    the H100's roofline; its output to ``chiprun_out/dryrun_torch.log``,
    its records to ``chiprun_out/dryrun_torch.json``."""
    import contextlib
    from repro_torch.launch import dryrun

    out_dir.mkdir(exist_ok=True)
    path = out_dir / "dryrun_torch.json"
    t0 = time.perf_counter()
    with open(out_dir / "dryrun_torch.log", "w") as f, \
            contextlib.redirect_stdout(f):
        rc = dryrun.main(["--both-meshes", "--out", str(path)])
    seconds = time.perf_counter() - t0
    if rc:
        raise AssertionError(f"dryrun: main returned {rc} "
                             f"(chiprun_out/dryrun_torch.log)")
    records = json.loads(path.read_text())
    n_ok = sum(r["status"] == "ok" for r in records)
    log(f"[dryrun] {len(records)} cells (every arch x shape x both meshes):"
        f" {n_ok} traced, {len(records) - n_ok} skipped, 0 failed, in "
        f"{seconds:.1f} s (chiprun_out/dryrun_torch.json, .log)")
    return {"cells": len(records), "ok": n_ok, "seconds": seconds}


def dryrun_check(dev, arch, mode, batch, seq, expect, smi):
    """Phase 13b: one step of ``arch`` traced on meta and run on the card
    under the same counter: the counts equal, the meta peak within
    ``DRYRUN_PEAK_TOL`` of the card's, the plan beside the measured peak,
    the roofline beside the measured step seconds."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.autoshard import plan_sharding
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.hw.gpu import H100Spec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.roofline import analyze, model_flops_for
    from repro_torch.launch.steps import build_prefill_step, build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import make_optimizer

    pod = H100Spec()
    cfg = get_config(arch)
    shape = ShapeConfig(f"{mode}_{batch}x{seq}", seq, batch, mode)
    train = mode == "train"
    meta = dryrun.trace_step(cfg, shape)
    plan = plan_sharding(cfg, shape, make_local_mesh(device=dev),
                         meta.params, meta.opt_state,
                         cache_shapes=meta.cache, pod=pod)
    _free_card()
    base = torch.cuda.memory_allocated()
    api = build_model(cfg, device=dev, trainable=train)
    params = api.init(0)
    if train:
        opt = make_optimizer(cfg.optimizer, lr=1e-3)
        carry = [params, opt.init(dict(params.named_parameters()))]
        step = build_train_step(api, opt)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
            cfg, shape, i, DataConfig(seed=0)).items()}
            for i in range(1 + DRYRUN_TIMED)]

        def run(i):
            carry[0], carry[1], m = step(carry[0], carry[1], batches[i])
            return m["loss"]
        args = lambda i: (carry[0], carry[1], batches[i])   # noqa: E731
    else:
        step = build_prefill_step(api, seq)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            1, min(cfg.vocab_size, 32000), size=(batch, seq)).astype(
            np.int32)).to(dev)

        def run(i):
            with torch.no_grad():
                return step(params, prompts)[0]
        args = lambda i: (params, prompts)                   # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with OpCounter(dev) as counter:
        counter.hold(args(0))
        out = run(0)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    card = counter.cost()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"dryrun {arch} {mode}: non-finite output")
    del out
    units = {k: v for k, v in launches.items()
             if k != "flash_attention_wgmma" and v}
    if launches != expect or card.kernel_units != units:
        raise AssertionError(f"dryrun {arch} {mode}: launches {launches} "
                             f"(expected {expect}), counted units "
                             f"{card.kernel_units}")
    if (card.flops, card.bytes, card.kernel_units) != \
            (meta.cost.flops, meta.cost.bytes, meta.cost.kernel_units):
        raise AssertionError(
            f"dryrun {arch} {mode}: card counts flops {card.flops} bytes "
            f"{card.bytes} units {card.kernel_units}, meta flops "
            f"{meta.cost.flops} bytes {meta.cost.bytes} units "
            f"{meta.cost.kernel_units}")
    peak_err = (meta.cost.peak_bytes - peak) / peak
    trace_b = dryrun.trace_hbm_bytes(meta, plan, 1)
    if not abs(peak_err) <= DRYRUN_PEAK_TOL:
        raise AssertionError(f"dryrun {arch} {mode}: meta peak "
                             f"{meta.cost.peak_bytes} B vs the card's "
                             f"{peak} B ({peak_err:+.3f})")
    times = []
    for i in range(1, 1 + DRYRUN_TIMED):
        _, ms = host_ms(lambda: run(i))
        times.append(ms / 1e3)
    step_s = min(times)
    rep = analyze(arch, shape.name, "1x1", 1,
                  {"flops": card.flops, "bytes accessed": card.bytes}, "",
                  model_flops_for(cfg, shape), pod=pod, coll=(0.0, {}))
    roof_s = max(rep.t_compute, rep.t_memory)
    useful = rep.model_flops / (step_s * pod.peak_flops_bf16)
    res = {"arch": arch, "mode": mode, "batch": batch, "seq": seq,
           "flops": card.flops, "bytes": card.bytes,
           "kernel_units": card.kernel_units, "ops": card.ops,
           "launches": launches, "meta_ops": meta.cost.ops,
           "meta_peak_bytes": meta.cost.peak_bytes, "card_peak_bytes": peak,
           "peak_rel_err": peak_err, "held_bytes": card.held_bytes,
           "meta_held_bytes": meta.cost.held_bytes,
           "free_copy_bytes": card.free_copy_bytes,
           "meta_free_copy_bytes": meta.cost.free_copy_bytes,
           "by_op": card.by_op, "plan_hbm_gib": plan.hbm_gb_per_chip,
           "trace_hbm_bytes": trace_b,
           "plan_valid": plan.valid, "plan_bytes": plan.bytes_per_chip,
           "t_compute": rep.t_compute, "t_memory": rep.t_memory,
           "roofline_s": roof_s, "roofline_fraction": rep.roofline_fraction,
           "bottleneck": rep.bottleneck, "model_flops": rep.model_flops,
           "useful_ratio": rep.hlo_useful_ratio, "step_seconds": times,
           "step_s": step_s, "model_flops_share": useful,
           "trace_s": meta.seconds, "card": smi}
    log(f"[dryrun-check] {arch} {mode} {batch} x {seq} bf16 full width: "
        f"counts on the card equal the meta trace's: {card.flops} flops, "
        f"{card.bytes} bytes, units {card.kernel_units} (launches "
        f"{launches})")
    top = sorted(card.by_op.items(), key=lambda kv: -kv[1][1])[:10]
    shares = ", ".join(f"{k} {b / card.bytes:.1%}" for k, (_, b) in top)
    log(f"[dryrun-check] {arch} {mode}: bytes by op (card counts): "
        f"{shares}; copying "
        f"reshapes counted free: {card.free_copy_bytes / 1e9:.3f} GB "
        f"({card.free_copy_bytes / card.bytes:.2%} of the counted bytes; "
        f"meta {meta.cost.free_copy_bytes / 1e9:.3f} GB)")
    log(f"[dryrun-check] {arch} {mode}: memory: meta peak "
        f"{meta.cost.peak_bytes / 1e9:.3f} GB (arguments "
        f"{meta.cost.held_bytes / 1e9:.3f}), card peak over the step "
        f"{peak / 1e9:.3f} GB ({peak_err:+.3f}, limit {DRYRUN_PEAK_TOL})")
    log(f"[dryrun-check] {arch} {mode}: plan: {plan.hbm_gb_per_chip:.3f} "
        f"GiB a chip ({plan.hbm_gb_per_chip * 2**30 / 1e9:.3f} GB: "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                    plan.bytes_per_chip.items())
        + f"), valid {plan.valid}; the trace's {trace_b / 1e9:.3f} GB; "
        f"beside the measured peak {peak / 1e9:.3f} GB")
    log(f"[dryrun-check] {arch} {mode}: time: roofline "
        f"{roof_s * 1e3:.3f} ms (compute {rep.t_compute * 1e3:.3f}, memory "
        f"{rep.t_memory * 1e3:.3f}; {rep.bottleneck}), measured step "
        f"{step_s * 1e3:.3f} ms (min of {DRYRUN_TIMED}), roofline_fraction "
        f"{rep.roofline_fraction:.4f}, model flops / (step x 989 TFLOP/s) "
        f"{useful:.4f} | {smi}")
    if not all(math.isfinite(x) for x in times):
        raise AssertionError(f"dryrun {arch} {mode}: step times {times}")
    del params, api, step, run, args
    if train:
        del carry, batches
    _free_card()
    return res


def model_kernel_entry(name, rows, uses, serve_res, source, replaces):
    """The kernels-line entry of a model-zoo kernel: times summed over the
    launches of the two serve prefills, at their shapes."""
    by_case = {r["case"].split(" ", 1)[1]: r for r in rows}
    launches = {arch: serve_res[arch]["launches"][name] for arch in SERVE}

    def per_run(field):
        return sum(by_case[arch][field] * n for arch, n in uses.items())
    libs = [by_case[arch]["library_ms"] for arch in uses]
    ops_ms, bytes_ms = per_run("ops_ms"), per_run("bytes_ms")
    return {"name": name, "route": "cuda", "path": PATHS[name],
            "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_arch": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": per_run("ms"), "plain_ms": per_run("plain_ms"),
            "bound_ms": per_run("bound_ms"),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None if None in libs else per_run("library_ms")}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the "
                                 "PyTorch/CUDA port (see the module "
                                 "docstring).")
    ap.add_argument("--check-only", action="store_true",
                    help="build, print ptxas's report, hold every "
                    "layer-tier kernel against its plain version once per "
                    "distinct plan (phases 1-2, untimed) and stop without "
                    "a result line")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()
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
    from repro_torch.lower import calibrate as cal
    from repro_torch.lower import (compare_network, lower_network,
                                   lower_scheme, make_network_inputs,
                                   measure_network, network_runner)
    from repro_torch.lower import exec as lx
    from repro_torch.workloads.layers import attention
    from repro_torch.workloads.nets import get_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peak_ops, peak_bw, peak_bf16, peak_tf32 = peaks(name)
    #: each path's rate of the kernels' operations (3xTF32: three TF32
    #: products a multiply-add)
    path_ops = {"fma": peak_ops, "wgmma": peak_bf16,
                "mma-3xtf32": peak_tf32 / 3}
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | {name}")
    detail = {"device": name, "peaks": {"fp32_ops_s": peak_ops,
                                        "bytes_s": peak_bw,
                                        "bf16_ops_s": peak_bf16,
                                        "tf32_ops_s": peak_tf32}}

    # 1. build: one nvcc per source, started together ------------------------
    t0 = time.perf_counter()
    sources = (backend.SOURCE, backend.MODEL_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        lib_paths = list(pool.map(backend.build, sources))
    for src in sources:
        backend.library(src)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(p.name for p in lib_paths)} in {build_s:.1f} s")
    ptxas = {}
    for lib_path in lib_paths:
        report = lib_path.with_name(lib_path.stem + ".ptxas.txt").read_text()
        log(report.strip())
        ptxas.update(ptxas_usage(report))
    for kern, use in sorted(ptxas.items()):
        log(f"[ptxas] {kern}: {use['registers']} registers, spill stores "
            f"{use['spill_stores']} B, spill loads {use['spill_loads']} B")
    detail["build_seconds"] = build_s
    detail["ptxas"] = ptxas

    # solve + lower the three configurations --------------------------------
    configs = [("resnet", eyeriss_multinode()),
               ("alexnet", eyeriss_multinode()),
               ("resnet", eyeriss_multinode(nodes=4, pe=8)),
               ("alexnet", eyeriss_multinode(nodes=4, pe=8))]
    nplans, predicted, scheds = {}, {}, {}
    for net_name, hw in configs:
        net = get_net(net_name, batch=64)
        t0 = time.perf_counter()
        sched = solve(net, hw)
        nplan = lower_network(sched, net, hw)
        if not nplan.executable:
            raise RuntimeError(f"{net_name}/{hw.name}: "
                               f"{nplan.invalid_layers()}")
        nplans[(net_name, hw.name)] = nplan
        scheds[(net_name, hw.name)] = (sched, net, hw)
        predicted[(net_name, hw.name)] = sched.total_latency_cycles \
            / hw.freq_hz
        log(f"[solve] {net_name} b64 on {hw.name}: "
            f"{time.perf_counter() - t0:.2f} s, {len(nplan.order)} layers, "
            f"{len(nplan.segments)} segments, "
            f"{len(nplan.forwarded())} forwarded, energy "
            f"{sched.total_energy_pj!r} pJ, latency "
            f"{sched.total_latency_cycles!r} cycles")

    distinct = {}
    resnet_uses = collections.Counter()
    for (net_name, hw_name), nplan in nplans.items():
        for n in nplan.order:
            k = plan_key(nplan.plans[n])
            distinct.setdefault(k, (f"{net_name}/{hw_name}/{n}",
                                    nplan.plans[n]))
            if (net_name, hw_name) == ("resnet", "eyeriss_16x16"):
                resnet_uses[k] += 1
    # attention: the named cases (the solver's plan) and every plan of the
    # full calibration sweep (the plans run_calibration executes)
    hws = {"16x16": eyeriss_multinode(), "4x4": cal.default_hw()}
    attn = [(attention(n, *shape), hws[t], 0)
            for n, shape, t in ATTENTION_CASES]
    attn += [(layer, hws["4x4"], 3) for layer in cal.default_sweep(False)
             if layer.kind == "attention"]
    for layer, hw, n_variants in attn:
        for vi, scheme in enumerate(cal.scheme_variants(layer, hw,
                                                        n_variants)):
            plan = lower_scheme(scheme, hw)
            if not plan.valid:
                raise RuntimeError(f"{layer.name}/{hw.name}: {plan.reason}")
            distinct.setdefault(plan_key(plan),
                                (f"{layer.name}/{hw.name}/v{vi}", plan))
    zamba_key = next(k for k, (w, _) in distinct.items()
                     if w == "zamba2.attn/eyeriss_16x16/v0")

    # 2. kernels vs plain versions ------------------------------------------
    run = {"fc": lambda p, i: lx.run_fc(p, i["I"], i["W"]),
           "conv": lambda p, i: lx.run_conv(p, i["I"], i["W"]),
           "pool": lambda p, i: lx.run_pool(p, i["I"]),
           "eltwise": lambda p, i: lx.run_eltwise(p, [i["A"], i["B"]]),
           "attention": lambda p, i: lx.run_attention(p, i["Q"], i["K"],
                                                      i["V"])}
    plain = {"fc": lambda p, i: lx.plain_fc(p, i["I"], i["W"]),
             "conv": lambda p, i: lx.plain_conv(p, i["I"], i["W"]),
             "pool": lambda p, i: lx.plain_pool(p, i["I"]),
             "eltwise": lambda p, i: lx.plain_eltwise(p, [i["A"], i["B"]]),
             "attention": lambda p, i: lx.plain_attention(p, i["Q"], i["K"],
                                                          i["V"])}

    def library(p, i):
        L = p.layer
        if p.kind == "attention":
            return F.scaled_dot_product_attention(
                i["Q"][:, None], i["K"][:, None], i["V"][:, None])[:, 0]
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
        want, plain_ms = host_ms(lambda: plain[plan.kind](plan, inputs))
        if out.shape != want.shape:
            raise AssertionError(f"{plan.describe()}: kernel shape "
                                 f"{tuple(out.shape)} vs {tuple(want.shape)}")
        abs_err = float((out - want).abs().max())
        rel_err = abs_err / (float(want.abs().max()) + 1e-9)
        if not rel_err <= KERNEL_TOL:
            raise AssertionError(f"{plan.kind} kernel disagrees with its "
                                 f"plain version on {plan.describe()}: "
                                 f"rel err {rel_err:.3e}")
        if plan.kind == "eltwise" and not torch.equal(out, want):
            raise AssertionError(f"eltwise kernel is not bit for bit its "
                                 f"plain version on {plan.describe()}")
        lib_err = float((library(plan, inputs) - want).abs().max())
        if lib_err > NETWORK_TOL * float(want.abs().max()):
            raise AssertionError(f"{plan.describe()}: the library call does "
                                 f"not compute the same function ({lib_err})")
        del want
        if args.check_only:
            log(f"[check] {plan.kind:9s} {where:32s} rel {rel_err:.2e} | "
                f"{plan.describe()}")
            rows.append(rel_err)
            continue
        copies = cold_copies(inputs)
        ms = stream_ms([functools.partial(run[plan.kind], plan, c)
                        for c in copies])
        lib_ms = stream_ms([functools.partial(library, plan, c)
                            for c in copies])
        del copies
        ops, nbytes = work(plan)
        path = lx.ATTN_PATHS[lx.attention_head_dim(plan.layer.dim("K"))] \
            if plan.kind == "attention" else PATHS[plan.kind]
        row = {"plan": where, "kind": plan.kind, "path": path,
               "describe": plan.describe(), "resnet_uses": resnet_uses[k],
               "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "ops": ops,
               "bytes": nbytes,
               "ops_ms": ops / path_ops[path] * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3}
        rows.append(row)
        log(f"[kernel] {plan.kind:7s} {path:10s} {where:32s} rel "
            f"{rel_err:.2e} | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, library "
            f"{lib_ms:.4f} ms, bound "
            f"{max(row['ops_ms'], row['bytes_ms']):.4f} ms | "
            f"{plan.describe()}")
        del inputs, out
    log(f"[kernels] {len(rows)} distinct plans checked in "
        f"{time.perf_counter() - t_phase:.1f} s")
    detail["eltwise_many"] = eltwise_many_case(
        next(p for _, p in distinct.values() if p.kind == "eltwise"), dev,
        not args.check_only)
    if args.check_only:
        log(f"[check] worst rel err {max(rows):.2e}; stopping (--check-only)")
        return 0
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
        ms = measure_network(nplan, runner=runner, warmup=1, iters=3,
                             predicted_seconds=predicted[(net_name, hw_name)]
                             ) * 1e3
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

    # 4b.-4d. the fused tier; autotune and the quickstart; the mesh --------
    detail["fused"] = fused_phase(dev, nplans, scheds, predicted, e2e)
    detail["autotune"], detail["quickstart"] = service_phase(dev)
    # 4d. the mesh executor ----------------------------------------------------
    t_phase = time.perf_counter()
    detail["mesh"] = mesh_phase(dev, nplans, scheds, e2e, detail["fused"])
    log(f"[mesh-check] phase in {time.perf_counter() - t_phase:.1f} s")

    # 5./6. calibration, the watchdog, the flight recorder -------------------
    out_dir = ROOT / "chiprun_out"
    detail["calibration"] = calibration_phase(dev, out_dir)
    detail["explain"] = explain_phase()

    # 7.-9. the model zoo ----------------------------------------------------
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    t_phase = time.perf_counter()
    model_rows = model_kernel_phase(dev, path_ops, peak_bw)
    log(f"[kernels] model zoo checked in "
        f"{time.perf_counter() - t_phase:.1f} s")
    detail["model_kernels"] = model_rows
    serve_res = serve_phase(dev)
    detail["serve"] = serve_res
    detail["consistency"] = consistency_phase(dev)

    # 10.-12. training ---------------------------------------------------------
    t_phase = time.perf_counter()
    train_res = train_phase(dev)
    detail["train"] = train_res
    detail["train_consistency"] = train_consistency(dev)
    detail["checkpoint"] = checkpoint_phase(dev)
    log(f"[train] phases 10-12 in {time.perf_counter() - t_phase:.1f} s")

    # 13. the dry-run: cells on meta; two steps held against the card ------
    t_phase = time.perf_counter()
    smi = card_power()
    detail["dryrun"] = {"cells": dryrun_cells(out_dir), "checks": [
        dryrun_check(dev, *check, smi) for check in DRYRUN_CHECKS]}
    dry_launches = collections.Counter()
    for check in detail["dryrun"]["checks"]:
        dry_launches.update(check["launches"])
    log(f"[dryrun] phase 13 in {time.perf_counter() - t_phase:.1f} s")

    # 14. the kernels line ---------------------------------------------------
    kernels = []
    fused_launches = detail["fused"]["resnet"]["launches"]
    for kind in ("fc", "conv", "pool", "eltwise"):
        mine = [r for r in rows if r["kind"] == kind]
        res = [r for r in mine if r["resnet_uses"]]

        def per_forward(field):
            return sum(r[field] * r["resnet_uses"] for r in res)
        ops_ms, bytes_ms = per_forward("ops_ms"), per_forward("bytes_ms")
        kernels.append({
            "name": kind, "route": "cuda", "path": PATHS[kind],
            "source": lx.SOURCE, "replaces": lx.REPLACES[kind],
            "launches": e2e["resnet"]["launches"][kind],
            "launches_fused": fused_launches[kind],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            "ms": per_forward("ms"),
            "plain_ms": per_forward("plain_ms"),
            "bound_ms": sum(max(r["ops_ms"], r["bytes_ms"]) * r["resnet_uses"]
                            for r in res),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": per_forward("library_ms")})
    zamba = next(r for r in rows if r["plan"] == distinct[zamba_key][0])
    cal_launches = detail["calibration"]["launches"]
    kernels.append({
        "name": "attention", "route": "cuda", "path": zamba["path"],
        "paths_by_head_dim": {str(d): p for d, p in lx.ATTN_PATHS.items()},
        "launches_mma": cal_launches["attention_mma"],
        "source": lx.SOURCE, "replaces": lx.REPLACES["attention"],
        "launches": cal_launches["attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["kind"] == "attention"),
        "max_rel_err": max(r["max_rel_err"] for r in rows
                           if r["kind"] == "attention"),
        "ms": zamba["ms"], "plain_ms": zamba["plain_ms"],
        "bound_ms": max(zamba["ops_ms"], zamba["bytes_ms"]),
        "bound_by": "operations" if zamba["ops_ms"] >= zamba["bytes_ms"]
        else "bytes",
        "library_ms": zamba["library_ms"]})
    uses = {arch: counts["flash_attention"] for arch, counts in
            SERVE.items()}
    kernels.append(model_kernel_entry(
        "flash_attention", model_rows["flash_attention"], uses, serve_res,
        fa.SOURCE, fa.REPLACES["flash_attention"]))
    kernels[-1]["launches_wgmma"] = sum(
        serve_res[arch]["launches"]["flash_attention_wgmma"] for arch in SERVE)
    kernels.append(model_kernel_entry(
        "ssd_intra_chunk", model_rows["ssd_intra_chunk"],
        {"zamba2-1.2b": SERVE["zamba2-1.2b"]["ssd_intra_chunk"]}, serve_res,
        ssd_scan.SOURCE, ssd_scan.REPLACES["ssd_intra_chunk"]))
    # the training path's launches (phase 10) and the dry-run's counted
    # steps (phase 13) join the serve prefills'
    for k in kernels[-2:]:
        k["uses"] = ["serve", "train", "dryrun"]
        k["launches_train"] = train_res["launches"][k["name"]]
        k["launches_dryrun"] = dry_launches[k["name"]]
        k["launches"] += k["launches_train"] + k["launches_dryrun"]
    kernels[-2]["launches_wgmma"] += \
        train_res["launches"]["flash_attention_wgmma"] \
        + dry_launches["flash_attention_wgmma"]
    detail["kernels"] = kernels
    for k in kernels:
        if k["name"] in EARLIER_MS:
            lib = "-" if k["library_ms"] is None else \
                f"{k['library_ms']:.4f} ms"
            log(f"[kernel] {k['name']} ({k['path']}), per the kernels line's "
                f"unit: {k['ms']:.4f} ms, library {lib}, bound "
                f"{k['bound_ms']:.4f} ms; before the redesign "
                f"{EARLIER_MS[k['name']]} ms (PERF.md's kernel table, "
                f"copied, not measured in this run)")
    detail["seconds"] = time.perf_counter() - t_main
    log(f"[total] every phase in {detail['seconds']:.1f} s")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log("(times of the kernels line: fc/conv/pool/eltwise per ResNet-50 b64 "
        "forward, summed over its layers at their plans' shapes; attention "
        "at the Zamba2-1.2B shared block's plan on the 16x16 template, "
        "launches per full calibration sweep; flash_attention per serve "
        "prefill of Qwen2.5-3B, Zamba2-1.2B and Qwen2-MoE-A2.7B together, "
        "ssd_intra_chunk per serve prefill of Zamba2-1.2B; each summed "
        "over its launches; their launches count phase 8's serve prefills, "
        "phase 10's training steps and phase 13's counted steps)")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
