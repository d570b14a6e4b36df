#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Runs on one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py               # every phase below
    python3 chip_smoke.py --check-only  # phases 1-2, untimed, then stop
    python3 chip_smoke.py --partition-only  # the build and phase 15
    python3 chip_smoke.py --partition-train-only  # the build and phase 16

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
8. serve Qwen2.5-3B, Zamba2-1.2B and Qwen2-MoE-A2.7B at full width and
   depth in bf16 (8 requests, 512-token prompts, 32 generated tokens)
   through ``serve``, which captures the prefill and one decode step as
   CUDA graphs over one static cache and replays them
   (``launch/serve.py`` ``CompiledServing``), with the launch counters
   set to 0 just before and read just after: twice a prefill's kernels
   (its warm-up call before the capture, and its replay), a prefill being
   flash 36 for Qwen; flash 6 and SSD 38 for Zamba2; flash 24 for
   Qwen2-MoE, every flash launch on the tensor-core path; the captured
   prefill graph holds exactly those launches and the decode graph none
   (decode runs no kernel); finite logits, tokens [8, 32]; the prefill's
   seconds, the capture's apart, the SSM prompt replay's, decode tok/s and
   the peak memory with the graph pools.  Then, from one prefill, the same
   8 decode steps as graph replays and through the eager step
   (``build_serve_step``, from a copy of the same cache), each timed and
   once under ``torch.profiler`` (idle share, device kernels): every run's
   tokens equal; and the captured prefill's logits against the eager
   prefill's (max abs difference printed), both profiled;
9. consistency, float32, full width, reduced depth (Qwen 4 layers, Zamba2
   12): the prefill's last-token logits (through the kernels) against a
   replay of the prompt through ``decode_step`` (no kernel), max rel error
   <= 1e-3; Qwen2-MoE at 2 layers (4 x 64 tokens): the card's prefill
   against the same prefill through the plain versions on the host's CPU,
   same weights, <= 1e-3, and the (token, slot) pairs capacity dropped,
   equal on both;
10. train Zamba2-1.2B at full width and depth in bf16 through
   ``launch/train.py`` ``train`` (4 steps, 8 x 512 tokens, AdamW, no
   checkpoints), whose step is one CUDA graph (``launch/steps.py``
   ``CompiledTraining``: step 1 is the capture's warm-up call, steps 2-4
   replays; a failed capture fails the run, nothing falls back to the
   eager step), with the launch counters set to 0 just before and read
   just after: flash 24 (all ``wgmma``) and SSD 152, 6 and 38 a step, all
   in the forward (the backwards are PyTorch, as the reference's are jnp);
   one optimizer update a step; every loss finite; the step seconds (min
   of steps 2-4), tokens/s, peak memory, the capture's seconds and its
   pool's bytes; then, on a fresh model, one eager step under
   ``torch.profiler`` (device ms by group: the two kernels, matmul, the
   optimizer's ``record_function`` range, the rest; the idle share) and
   one replay of the captured step (busy, idle share, kernels);
11. the f32 training path on the card against the host's CPU: Zamba2 at
   full width cut to 6 layers (one shared-attention call), 2 x 128
   tokens, the same weights, TF32 off: the loss within 1e-4 relative,
   every gradient leaf within 1e-3 of its leaf's max |g| (the FMA flash
   kernel with its lse, the f32 SSD kernel and both backwards against the
   plain versions);
12. checkpoints at full width cut to 6 layers (2 x 256 tokens), through
   the captured step: ``train`` with a checkpoint every 2 steps and a
   failure injected at step 3 must recover once (``restarts == 1``; the
   restore writes into the graph's own tensors) with finite losses and
   one update a step; 2 more steps resumed from its directory must match
   the same steps of one uninterrupted run within 1e-3 relative (the
   embedding gather's backward adds with atomics on the card, so not bit
   for bit); (b) ``python -m repro_torch.train_tiny_lm`` at its defaults,
   in process (tiny Qwen2.5-3B, 200 steps of 8 x 128, a checkpoint every
   50, a failure at step 100): ``restarts=1``, finite losses, 200
   updates, two flash launches a step run;
13. the dry-run (``launch/dryrun.py``, ``[dryrun]``): (a) every cell, 10
   archs x 4 shapes x both production meshes, traced on meta with the
   H100's roofline (``H100Spec()``), 0 failures, skips only the
   reference's 16 (``python -m repro_torch.launch.dryrun --both-meshes
   --arch``, an arch in each of ``DRYRUN_WORKERS`` processes at a time),
   every record partitioned (one rank's train, prefill or decode step
   under a fake group), records to ``chiprun_out/dryrun_torch.json``, the
   output to ``chiprun_out/dryrun_torch.log``; (b) ``[dryrun-check]``: the
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
   and power limit; ``[train-compare]``: the Zamba2 step eager (13b's
   timed steps) beside phase 10's replays and both profiles;
15. the partitioned serving step (``launch/partition.py``,
   ``[partition]``), after the kernels are built once in this process:
   ``PART_RANKS`` ranks on the one card, each a process of its own, in
   one gloo group (NCCL refuses two ranks on one device), mesh
   ``PART_MESH`` (data 1, model 4): (a) Qwen2-MoE-A2.7B in bf16 at full
   width and depth, seed 0, each rank drawing the one-card model's leaves
   and keeping its shard (15 of 60 experts, 4 of 16 heads): a prefill of
   8 x 512 and 8 greedy decode steps, eager; per rank the prefill
   seconds, decode tokens/s, peak memory, flash launches (every rank must
   launch it) and the collectives of a prefill and a decode step by kind
   with their bytes (counted under ``launch/op_cost.py``'s counter in an
   untimed call); then, the ranks gone, the same model unpartitioned in
   this process prefills the same prompt in bf16 and, with the same
   weights, in f32: rank 0's gathered last-position logits must lie no
   farther from the f32 ones than ``PART_BF16_FACTOR`` times the one-card
   bf16 ones (phase 7 holds the flash kernel at a rank's local heads, and
   the SSD kernel at Zamba2's, against their plain versions); (b) f32 parity at full width, Qwen2-MoE at 4 layers and
   Zamba2-1.2B at 6 (its SSD kernel on each rank's heads), 2 x 128 and 4
   greedy steps: rank 0 runs the same model unpartitioned on the card,
   the logits within ``PART_TOL`` (max relative), the greedy tokens and
   the dropped (token, slot) pairs equal; (c) a group of one rank in this
   process, the 1 x 1 mesh: the partitioned Qwen2.5-3B bf16 prefill of
   phase 8's shape bit for bit the unpartitioned one, launches equal.
   Each group is destroyed also on failure;
16. the partitioned train step (``launch/partition.py``
   ``partitioned_train_step``, ``[partition-train]``): first, in this
   process, the f32 parity rows' unpartitioned steps on the card (AdamW,
   their first batch's gradients saved whole to the host, the card freed
   before the ranks start); then ``PART_RANKS`` ranks on the one card,
   gloo, mesh ``PT_MESH`` (data 2, model 2): (a) Zamba2-1.2B in bf16 at
   full width and depth, ``PT_TRAIN``'s eager steps of 8 x 512 (phase
   10's configuration, seed 0), the first under ``launch/op_cost.py``'s
   counter: per rank the step seconds, tokens/s, peak memory, the plan's
   ZeRO/FSDP, the first step's collectives by kind, flash and SSD
   launches (every rank must launch both) and finite losses, equal on
   every rank; (b) f32 parity at full width (``PT_PARITY``: Zamba2-1.2B
   at 6 layers, Qwen2-MoE-A2.7B at 2 on (1, 4), whose capacity is then
   the unpartitioned step's, and Zamba2 again with a small HBM spec that
   forces FSDP), 2 x 128, 3 steps: the first step's loss and grad_norm
   within ``PT_LOSS_TOL`` of the unpartitioned step's, every step's
   within ``PT_STEPS_TOL``, each rank's window of
   every gradient leaf (reduced as the step reduces it) within
   ``PT_GRAD_TOL`` of the leaf's max |g|, and after each update every
   rank holding the same window of a leaf holding the same bytes; the
   FSDP row again with AdamW's eps at ``PT_WITNESS_EPS``, every step
   within ``PT_LOSS_TOL`` (the witness that the later steps' offset is
   the first gradient's sign flips); (c) the bf16 loss of each token of
   the first ``PT_WITNESS_BATCHES`` batches, forward only, on
   ``PT_MESH`` and on a data-only and a model-only mesh
   (``PT_WITNESS``); then, the ranks gone, the same losses unpartitioned
   in bf16 and, with the same weights, in f32: the first batch's
   partitioned losses no farther from the f32 ones than
   ``PART_BF16_FACTOR`` times the one-card bf16 ones, and on each mesh
   the scalar loss within ``PT_BIAS_Z`` standard errors of the one-card
   bf16 one; and rank 0's step traced on meta under a fake group of 4:
   its FLOPs, bytes, kernel units and collective bytes by kind equal to
   rank 0's counted step (phase 7 holds flash and SSD at a rank's local
   shapes, ``zamba2-1.2b-tp2``).  The 4 ranks share one card and stage
   every collective through the host: the step time is a correctness
   cell's, not a multi-GPU training speed;
14. print ``{"kernels": [...]}`` (flash and SSD count phase 8's serves'
   prefills, warm-up and replay, phase 10's, phase 13's, phase 15's and
   phase 16's launches), the card's name and power limit, and
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
import math
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
#: the Zamba2 train step's peaks (GB) while the optimizer returned new
#: state beside the old: phase 10's and phase 13b's (meta trace and
#: card), copied from PERF.md (NVIDIA H100 80GB HBM3, 700.00 W), logged
#: beside this run's and not measured here
EARLIER_PEAK_GB = {"train": 50.01, "dryrun-meta": 40.574, "dryrun": 40.577}
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
#: prefills a serve runs: the warm-up call before its capture, and the
#: replay; the decode steps held captured against eager, and profiled
SERVE_PREFILLS = 2
SERVE_PROFILE_STEPS = 8
#: the consistency phase: arch -> depth
CONSISTENCY = {"qwen2.5-3b": 4, "zamba2-1.2b": 12}
#: the MoE consistency row: arch, depth, requests and prompt length (short
#: enough for the plain versions on the host's CPU)
MOE_CONSISTENCY = ("qwen2-moe-a2.7b", 2, 4, 64)
#: phase 7's flash cases whose log-sum-exp output is held against the plain
#: version's (the three serve prefills on the tensor-core path, the f32 FMA
#: case, a rank's heads in phase 16's train step), and its limit: both are
#: f32 from the same operands
LSE_CASES = ("qwen2.5-3b", "zamba2-1.2b", "qwen2-moe-a2.7b", "non-causal-f32",
             "zamba2-1.2b-tp2")
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
#: the partition phase (``launch/partition.py``): ranks on the one card
#: (``gloo``: NCCL refuses two ranks on one device) and their mesh
#: (data, model); the full-size bf16 serve: arch, requests, prompt, decode
#: steps, and the limit on its prefill's last-position logits: no farther
#: from the same weights' f32 prefill than this factor times the one-card
#: bf16 prefill (both bf16 programs round differently, and a rounding can
#: flip a token's top-4 experts among 60 near-tied random-router logits,
#: so the two bf16 programs differ from each other by as much as either
#: differs from f32; a wrong kernel or collective on a rank is O(1)); the
#: f32 parity rows (arch, depth) at full width, requests,
#: prompt and greedy steps, and their limit (the same measure); the 1 x 1
#: row's arch (phase 8's shape, bit for bit)
PART_RANKS, PART_MESH = 4, (1, 4)
PART_SERVE = ("qwen2-moe-a2.7b", 8, 512, 8)
PART_BF16_FACTOR = 2.0
PART_PARITY = (("qwen2-moe-a2.7b", 4), ("zamba2-1.2b", 6))
PART_PARITY_SHAPE = (2, 128, 4)
PART_TOL = 1e-4
PART_ONE = "qwen2.5-3b"
#: the partitioned train phase (phase 16, ``launch/partition.py``
#: ``partitioned_train_step``): its ranks' mesh (data 2, model 2: the data
#: reduction, ZeRO/FSDP and the model axis all run); the full-size bf16
#: row: arch, steps, batch, sequence (phase 10's: AdamW, remat "none",
#: seed 0, eager), its first batch's loss of each token held as phase
#: 15's serve is: no farther from the same weights' f32 losses than
#: ``PART_BF16_FACTOR`` times the one-card bf16 ones; the meshes of the
#: scalar loss's witness (data only, model only), the limit, on each and
#: on ``PT_MESH``, of the scalar loss's offset from the one-card bf16 one
#: in standard errors of its rows' means (the rows are independent draws
#: of the rounding noise; a fault's bias moves them alike), and the
#: batches it reads (forward only, the initial weights); the f32 parity
#: rows (name, arch, depth,
#: mesh, "fsdp" where a small HBM spec forces FSDP, and AdamW's eps where
#: not its default), their batch, sequence and steps, and the limits
#: against the unpartitioned step on the card: the first step's loss and
#: grad_norm (relative), every step's (the CPU tests' three-step limit: a
#: few hundred elements of the first gradient change sign between two
#: f32 summation orders, AdamW moves each by 2 x lr either way, and later
#: steps part by ~1e-5; with ``PT_WITNESS_EPS`` far above those elements'
#: |g| they move by lr |g| / eps instead, and every step is held to the
#: first step's limit), each gradient leaf (of its max |g|)
PT_MESH = (2, 2)
PT_TRAIN = ("zamba2-1.2b", 3, 8, 512)
PT_WITNESS = ((4, 1), (1, 4))
PT_BIAS_Z = 5.0
PT_WITNESS_BATCHES = 4
PT_WITNESS_EPS = 1e-3
PT_PARITY = (("zamba2-6", "zamba2-1.2b", 6, (2, 2), None, None),
             ("qwen2-moe-2", "qwen2-moe-a2.7b", 2, (1, 4), None, None),
             ("zamba2-6-fsdp", "zamba2-1.2b", 6, (2, 2), "fsdp", None),
             ("zamba2-6-fsdp-eps", "zamba2-1.2b", 6, (2, 2), "fsdp",
              PT_WITNESS_EPS))
PT_PARITY_SHAPE = (2, 128, 3)
PT_LOSS_TOL, PT_STEPS_TOL, PT_GRAD_TOL = 1e-5, 1e-4, 1e-4
#: the dry-run's skips: long_500k of the 8 pure full-attention archs on
#: both meshes (the reference's)
DRYRUN_SKIPS = 16
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
#: the processes phase 13a runs ``main`` in, an arch each
DRYRUN_WORKERS = 4
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
#: whether one PyTorch call (SDPA) computes the same function; the "-tp4"
#: case is one rank's local heads in phase 15's partitioned bf16 serve,
#: the "-tp2" one a rank's in phase 16's partitioned train step
FLASH_CASES = [
    ("qwen2.5-3b", 8, 16, 2, 512, 512, 128, True, 0, 0.0, "bf16", True),
    ("zamba2-1.2b", 8, 32, 32, 512, 512, 64, True, 0, 0.0, "bf16", True),
    ("gemma2-like", 8, 8, 4, 512, 512, 256, True, 128, 50.0, "bf16", False),
    ("right-aligned", 8, 16, 2, 128, 512, 128, True, 0, 0.0, "bf16", False),
    ("non-causal-f32", 8, 16, 2, 512, 512, 128, False, 0, 0.0, "f32", True),
    ("qwen2-moe-a2.7b", 8, 16, 16, 512, 512, 128, True, 0, 0.0, "bf16",
     True),
    ("qwen2-moe-a2.7b-tp4", 8, 4, 4, 512, 512, 128, True, 0, 0.0, "bf16",
     True),
    ("zamba2-1.2b-tp2", 4, 16, 16, 512, 512, 64, True, 0, 0.0, "bf16",
     True),
]
#: SSD cases: name, B, S, H, P, N, chunk, dtype (the first two are the
#: serve prefills' shapes; then Zamba2-1.2B's in float32, a chunk of 256
#: with head dim 128: two row tiles, two P tiles, one rank's 16 local
#: heads of Zamba2-1.2B in phase 15's f32 parity row, and one rank's 32
#: in phase 16's bf16 train step)
SSD_CASES = [("mamba2-1.3b", 8, 512, 64, 64, 128, 128, "bf16"),
             ("zamba2-1.2b", 8, 512, 64, 64, 64, 128, "bf16"),
             ("zamba2-1.2b-f32", 8, 512, 64, 64, 64, 128, "f32"),
             ("lc256-p128", 4, 1024, 32, 128, 64, 256, "f32"),
             ("zamba2-1.2b-tp4", 2, 128, 16, 64, 64, 128, "f32"),
             ("zamba2-1.2b-tp2", 4, 512, 32, 64, 64, 128, "bf16")]


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


def device_profile_of(fn):
    """``fn()`` under ``torch.profiler``, ending in a synchronise: device
    time by group (the two kernels, matmuls, the rest), the device kernels
    and copies counted, and the idle share against the wall clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return {"wall_ms": wall_ms, "device_ms": dict(groups),
            "device_busy_ms": busy, "device_kernels": launched,
            "idle_share": None if not busy else 1.0 - busy / wall_ms,
            "top_kernels_ms": dict(top.most_common(8))}


def profile_serving(api, params, steps, inputs, prompt, n_steps: int):
    """From one prefill, ``n_steps`` decode steps twice: replays of the
    captured decode graph (``steps``, ``launch/serve.py``
    ``CompiledServing``) and the eager step (``build_serve_step``) from a
    copy of the same cache; each timed unprofiled (host clock, ending in a
    synchronise) and once under ``torch.profiler``.  The prefill too: the
    captured replay and the eager ``api.prefill``.  Returns the numbers,
    the prefill logits' max abs difference and whether every run gave the
    same tokens."""
    import torch
    from repro_torch.launch.steps import build_serve_step
    out = {"captured": {}, "eager": {}}
    max_len = steps.max_len
    with torch.inference_mode():
        # the prefill, captured and eager
        out["captured"]["prefill"] = device_profile_of(
            lambda: steps.prefill(inputs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, cache = api.prefill(params, inputs, max_len)
        torch.cuda.synchronize()
        out["eager"]["prefill_s"] = time.perf_counter() - t0
        out["eager"]["prefill"] = device_profile_of(
            lambda: api.prefill(params, inputs, max_len))
        logits = steps.prefill(inputs).clone()
        out["prefill_logits_max_abs_diff"] = float(
            (logits.float() - want.float()).abs().max())
        del cache, want
        # the first token (and the SSM/hybrid prompt replay), then a copy
        # of the state both runs start from
        steps.start(logits, prompt)
        start = ({k: t.clone() for k, t in steps.cache.items()},
                 steps.tokens.clone(), int(steps.cache_len))

        def captured():
            for k, t in steps.cache.items():
                t.copy_(start[0][k])
            steps.tokens.copy_(start[1])
            steps.cache_len.fill_(start[2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = [steps.decode().clone() for _ in range(n_steps)]
            torch.cuda.synchronize()
            return time.perf_counter() - t0, torch.cat(toks, 1)

        serve_step = build_serve_step(api)

        def eager():
            cache = {k: t.clone() for k, t in start[0].items()}
            tok = start[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = []
            for i in range(n_steps):
                tok, cache = serve_step(params, cache, tok, start[2] + i)
                toks.append(tok)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, torch.cat(toks, 1)

        tokens = []
        for what, fn in (("captured", captured), ("eager", eager)):
            secs, toks = fn()
            profiled = []
            out[what]["decode"] = device_profile_of(
                lambda: profiled.append(fn()[1]))
            tokens += [toks, profiled[0]]
            out[what]["decode"]["steps"] = n_steps
            out[what]["decode_s"] = secs
            out[what]["decode_tok_s"] = toks.numel() / secs
        out["tokens_equal"] = all(torch.equal(t, tokens[0])
                                  for t in tokens[1:])
        out["tokens_head"] = tokens[0][:2].tolist()
        del start
    return out


def serve_phase(dev):
    """Phase 8: every arch of ``SERVE`` at full width in bf16, through the
    captured prefill and decode; then the same 8 decode steps captured and
    eager from one prefill."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CompiledServing, serve
    from repro_torch.models.api import build_model

    smi = card_power()
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
        # the prefill's warm-up call before its capture, and its replay
        want = {k: SERVE_PREFILLS * n for k, n in expect.items()}
        if launches != want:
            raise AssertionError(f"{arch}: launches {launches}, the serve "
                                 f"makes {want}")
        if res.tokens.shape != (SERVE_REQUESTS, SERVE_GEN):
            raise AssertionError(f"{arch}: tokens {res.tokens.shape}")
        if not bool(torch.isfinite(res.logits).all()):
            raise AssertionError(f"{arch}: non-finite prefill logits")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            1, min(cfg.vocab_size, 1000),
            size=(SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)).to(dev)
        # serve's graphs went with its return: the same steps anew, for
        # the graphs' launches and the profile
        with torch.inference_mode():
            steps = CompiledServing(api, params, prompts,
                                    SERVE_PROMPT + SERVE_GEN)
        if steps.prefill_graph.graph is None or \
                steps.decode_graph.graph is None:
            raise AssertionError(f"{arch}: a step was not captured")
        if steps.prefill_graph.launches != \
                {k: n for k, n in expect.items() if n} or \
                steps.decode_graph.launches:
            raise AssertionError(
                f"{arch}: captured prefill launches "
                f"{steps.prefill_graph.launches}, decode "
                f"{steps.decode_graph.launches}; the model has {expect} "
                "and no decode kernel")
        prof = profile_serving(api, params, steps, prompts, prompts,
                               SERVE_PROFILE_STEPS)
        if not prof["tokens_equal"]:
            raise AssertionError(f"{arch}: captured and eager decode steps "
                                 "gave different tokens")
        results[arch] = {
            "params": n_params, "weights_gb": n_params * 2 / 1e9,
            "launches": launches,
            "captured_prefill_launches": steps.prefill_graph.launches,
            "prefill_s": res.prefill_seconds,
            "capture_s": res.capture_seconds,
            "prompt_replay_s": res.prompt_seconds,
            "decode_s": res.decode_seconds,
            "decode_tok_s": res.decode_tokens_per_second,
            "peak_memory_gb": peak_gb, "pool_gb": res.pool_bytes / 1e9,
            "tokens_head": res.tokens[:2].tolist(), "profile": prof,
            "card": smi}
        cap, eag = prof["captured"], prof["eager"]
        log(f"[serve] {arch} bf16 full width ({n_params / 1e9:.3f} B "
            f"params), captured: {SERVE_REQUESTS} x {SERVE_PROMPT} prefill "
            f"{res.prefill_seconds:.4f} s (capture of both steps "
            f"{res.capture_seconds:.2f} s apart; prompt replay "
            f"{res.prompt_seconds:.3f} s), decode "
            f"{res.decode_tokens_per_second:.2f} tok/s over "
            f"{SERVE_GEN - 1} steps, launches {launches}, peak memory "
            f"{peak_gb:.2f} GB with the graph pools "
            f"({res.pool_bytes / 1e9:.3f} GB) ({smi})")
        log(f"[serve-compare] {arch}, {SERVE_PROFILE_STEPS} decode steps "
            f"from one prefill: captured {cap['decode_tok_s']:.2f} tok/s, "
            f"idle {cap['decode']['idle_share']:.3f}, "
            f"{cap['decode']['device_kernels']} device kernels; eager "
            f"{eag['decode_tok_s']:.2f} tok/s, idle "
            f"{eag['decode']['idle_share']:.3f}, "
            f"{eag['decode']['device_kernels']} device kernels; tokens "
            f"equal; prefill captured {res.prefill_seconds:.4f} s (idle "
            f"{cap['prefill']['idle_share']:.3f}) vs eager "
            f"{eag['prefill_s']:.4f} s (idle "
            f"{eag['prefill']['idle_share']:.3f}), logits max abs diff "
            f"{prof['prefill_logits_max_abs_diff']:.3e} ({smi})")
        log(f"[profile] {arch}: {json.dumps(prof)}")
        del api, params, res, steps
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
    """A fresh model of ``cfg`` (the pieces ``train`` builds): one eager
    warm-up step, then one eager step under ``torch.profiler``
    (``build_train_step``: the groups of ``_train_groups``, the
    optimizer's range among them); then the same state through
    ``CompiledTraining``: its first step (the warm-up call and the
    capture), one replay, and one replay under the profiler (busy, idle
    share, kernels; a replay has no optimizer range on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.steps import (CompiledTraining, build_train_step,
                                          input_structs)
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import make_optimizer
    api = build_model(cfg, device=dev, trainable=True)
    params = api.init(1)
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    state = opt.init(dict(params.named_parameters()))
    step = build_train_step(api, opt)
    shape = ShapeConfig("train", seq, batch_size, "train")
    host = [synth_batch(cfg, shape, i, DataConfig(seed=1)) for i in range(5)]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in host[:2]]

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(m["loss"])):
            raise AssertionError("profiled train step: non-finite loss")
        return _train_groups(prof, wall_ms)

    step(params, state, batches[0])
    eager = profiled(lambda: step(params, state, batches[1])[2])
    del batches
    compiled = CompiledTraining(api, params, state, opt,
                                input_structs(cfg, shape))
    compiled.step(host[2])
    compiled.step(host[3])
    replay = profiled(lambda: compiled.step(host[4]))
    replay["capture_seconds"] = compiled.capture_seconds
    replay["pool_bytes"] = compiled.pool_bytes
    if int(state["step"]) != 5:
        raise AssertionError(f"profiled train steps: {int(state['step'])} "
                             f"updates, 5 steps")
    return {"eager": eager, "replay": replay}


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
    if stats.updates != steps or not stats.capture_seconds > 0:
        raise AssertionError(f"train {arch}: {stats.updates} updates over "
                             f"{steps} steps, capture "
                             f"{stats.capture_seconds} s: not one graph")
    step_s = min(stats.step_seconds[1:])
    res = {"arch": arch, "steps": steps, "batch": batch, "seq": seq,
           "launches": launches, "losses": losses,
           "step_seconds": stats.step_seconds, "step_s": step_s,
           "tokens_per_s": batch * seq / step_s, "peak_memory_gb": peak_gb,
           "capture_seconds": stats.capture_seconds,
           "pool_bytes": stats.pool_bytes, "updates": stats.updates}
    log(f"[train] {arch} bf16 full width and depth, {batch} x {seq} tokens "
        f"a step, AdamW, captured (step 1: the warm-up step and the "
        f"capture, {stats.capture_seconds:.3f} s; steps 2-{steps}: "
        f"replays): step {step_s:.4f} s (min of steps 2-{steps}; all "
        f"{[round(x, 4) for x in stats.step_seconds]}), "
        f"{res['tokens_per_s']:.1f} tokens/s, peak memory {peak_gb:.2f} GB "
        f"(with the update's new state beside the old: "
        f"{EARLIER_PEAK_GB['train']} GB), pool {stats.pool_bytes} B, "
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
           "restarts": stats.restarts, "updates": stats.updates,
           "capture_seconds": stats.capture_seconds,
           "failed_run_losses": failed,
           "resumed_losses": resumed, "uninterrupted_losses": whole,
           "resume_rel_errs": errs, "recovery_run_s": recovery_s,
           "checkpoint_bytes_on_disk": on_disk}
    log(f"[checkpoint] {TRAIN[0]} {layers} layers bf16, captured (one "
        f"graph a run, restored into in place; capture "
        f"{stats.capture_seconds:.3f} s): restarts "
        f"{stats.restarts}, losses {[round(x, 4) for x in failed]}; resumed "
        f"steps 6-7 {resumed} vs uninterrupted {whole[6:]} (rel err "
        f"{max(errs):.3e}); {on_disk} bytes of checkpoints kept; the "
        f"failing run {recovery_s:.1f} s")
    if stats.restarts != 1 or not all(math.isfinite(x) for x in failed):
        raise AssertionError(f"checkpoint: restarts {stats.restarts}, "
                             f"losses {failed}")
    if stats.updates != 6 or not stats.capture_seconds > 0:
        raise AssertionError(f"checkpoint: {stats.updates} updates, "
                             f"capture {stats.capture_seconds} s")
    if len(resumed) != 2 or not max(errs) <= RESUME_TOL:
        raise AssertionError(f"checkpoint: resumed {resumed} vs "
                             f"uninterrupted {whole[6:]}")
    _free_card()
    return res


def tiny_lm_phase():
    """Phase 12b: ``python -m repro_torch.train_tiny_lm`` at its defaults
    (tiny Qwen2.5-3B, 200 steps of 8 x 128, a checkpoint every 50 steps, a
    failure at step 100), in process, with the launch counters set to 0
    just before and read just after: one recovery, finite losses, one
    flash launch per layer a step run."""
    import contextlib
    import io
    import math
    from repro_torch import train_tiny_lm
    from repro_torch.kernels import ops

    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses, stats = train_tiny_lm.main([])
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    last = out.getvalue().strip().splitlines()[-1]
    res = {"steps_run": len(losses), "restarts": stats.restarts,
           "updates": stats.updates, "first_loss": losses[0],
           "last_loss": losses[-1], "launches": launches,
           "capture_seconds": stats.capture_seconds, "seconds": seconds,
           "step_s": statistics.median(stats.step_seconds[1:]),
           "last_line": last}
    log(f"[train_tiny_lm] {last} | {len(losses)} steps run, "
        f"{stats.updates} updates, launches {launches}, capture "
        f"{stats.capture_seconds:.3f} s, median step "
        f"{res['step_s'] * 1e3:.3f} ms, {seconds:.1f} s in all")
    if stats.restarts != 1 or "(restarts=1)" not in out.getvalue() \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_tiny_lm: restarts {stats.restarts}, "
                             f"{last}")
    if stats.updates != 200 or launches["flash_attention"] \
            != 2 * len(losses):
        raise AssertionError(f"train_tiny_lm: {stats.updates} updates, "
                             f"launches {launches} over {len(losses)} "
                             f"steps")
    _free_card()
    return res


def card_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def dryrun_cells(out_dir: Path):
    """Phase 13a: ``python -m repro_torch.launch.dryrun --both-meshes``,
    one process an arch (``--arch``), ``DRYRUN_WORKERS`` at a time: every
    arch and shape on both production meshes, on meta, with the H100's
    roofline; the processes' output, in arch order, to
    ``chiprun_out/dryrun_torch.log``, their records, in ``main``'s order
    (mesh, arch, shape), to ``chiprun_out/dryrun_torch.json``."""
    from repro_torch.configs import SHAPES, list_archs

    out_dir.mkdir(exist_ok=True)
    path = out_dir / "dryrun_torch.json"
    archs = list_archs()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def one(arch):
        part = out_dir / f"dryrun_torch.{arch}.json"
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--both-meshes", "--arch", arch, "--out", str(part)],
            env=env, capture_output=True, text=True, timeout=900)
        records = json.loads(part.read_text()) if part.is_file() else []
        part.unlink(missing_ok=True)
        return run.returncode, run.stdout + run.stderr, records
    t0 = time.perf_counter()
    with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
        runs = list(pool.map(one, archs))
    seconds = time.perf_counter() - t0
    (out_dir / "dryrun_torch.log").write_text(
        "".join(text for _, text, _ in runs))
    n = len(SHAPES)                   # each run: its shapes, a mesh each
    records = [r for m in range(2) for _, _, recs in runs
               for r in recs[m * n:(m + 1) * n]]
    path.write_text(json.dumps(records, indent=1))
    failed = [a for a, (rc, _, _) in zip(archs, runs) if rc]
    if failed:
        raise AssertionError(f"dryrun: main failed for {failed} "
                             f"(chiprun_out/dryrun_torch.log)")
    n_ok = sum(r["status"] == "ok" for r in records)
    per = collections.Counter(r["per_device"] for r in records
                              if r["status"] == "ok")
    n_skip = sum(r["status"] == "skipped" for r in records)
    modes = {r["mode"] for r in records if r["status"] == "ok"}
    log(f"[dryrun] {len(records)} cells (every arch x shape x both meshes,"
        f" {DRYRUN_WORKERS} processes): {n_ok} traced, {per['partitioned']}"
        f" partitioned (one rank's train, prefill or decode step under a "
        f"fake group), {n_skip} skipped, 0 failed, in {seconds:.1f} s "
        f"(chiprun_out/dryrun_torch.json, .log)")
    if n_ok + n_skip != len(records) or n_skip != DRYRUN_SKIPS \
            or per != {"partitioned": n_ok} \
            or modes != {"train", "prefill", "decode"}:
        raise AssertionError(f"dryrun: {per}, {n_skip} skipped")
    return {"cells": len(records), "ok": n_ok, "seconds": seconds,
            "partitioned": per["partitioned"], "skipped": n_skip}


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
    trace_b = dryrun.trace_hbm_bytes(meta, plan)
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
        f"{peak / 1e9:.3f} GB ({peak_err:+.3f}, limit {DRYRUN_PEAK_TOL})"
        + (f"; with the update's new state beside the old: meta "
           f"{EARLIER_PEAK_GB['dryrun-meta']} GB, card "
           f"{EARLIER_PEAK_GB['dryrun']} GB" if train else ""))
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


def part_prompt(cfg, B: int, S: int, seed: int):
    """Phase 15's prompt ids [B, S] (int64, on the host) from ``seed``."""
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)))


def partition_rank(rank: int, world: int, args: dict) -> dict:
    """Phase 15 on one rank, in a process of its own (``run_ranks``): the
    full-size bf16 serve (prefill, then greedy decode steps, eager), then
    the f32 parity rows, rank 0 also running each row unpartitioned.
    ``args``: device, mesh, serve, parity, parity_shape; ``tiny`` cuts the
    configurations to ``tiny_config`` (the CPU check of this function)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as pt
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.train import tiny_config
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import counting_drops

    dev = torch.device(args["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh(args["mesh"], ("data", "model"))
    dm = device_mesh(mesh, dev.type)

    def config(arch, depth=None):
        cfg = get_config(arch)
        if args.get("tiny"):
            cfg = tiny_config(cfg)
        return cfg if depth is None else \
            dataclasses.replace(cfg, num_layers=depth)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def prompt(cfg, B, S, seed):
        return part_prompt(cfg, B, S, seed).to(dev)

    out = {"rank": rank}
    # ---- the full-size serve, bf16 -------------------------------------
    arch, B, S, steps = args["serve"]
    cfg = config(arch)
    max_len = S + steps + 1            # the counted step, then the timed
    plan = pt.plan_for(cfg, ShapeConfig("serve", max_len, B, "prefill"),
                       mesh)
    api = build_model(cfg, device=dev, mesh=dm)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = pt.init_params(api, plan, seed=0)
    sync()
    init_s = time.perf_counter() - t0
    inputs = pt.distribute(prompt(cfg, B, S, 0), plan.batch_specs["inputs"],
                           api)
    cache = pt.init_cache(api, plan, B, max_len)
    prefill = pt.partitioned_prefill_step(api, max_len, plan)
    serve = pt.partitioned_serve_step(api, plan)
    with OpCounter(dev) as counter:       # untimed: collectives by kind
        logits, cache = prefill(params, inputs, cache)
    colls_prefill = counter.cost().coll_by_kind
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs, cache)
    sync()
    prefill_s = time.perf_counter() - t0
    launches_prefill = ops.launch_counts()
    last = api.shards.full(logits)[:, -1].float().cpu()
    if not bool(torch.isfinite(last).all()):
        raise AssertionError(f"rank {rank}: non-finite prefill logits")
    tok = pt.next_tokens(api, logits)
    with OpCounter(dev) as counter:
        tok, cache = serve(params, cache, tok, S)
    colls_decode = counter.cost().coll_by_kind
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        tok, cache = serve(params, cache, tok, S + 1 + i)
    sync()
    decode_s = time.perf_counter() - t0
    out["serve"] = {
        "arch": arch, "init_s": init_s, "prefill_s": prefill_s,
        "decode_s": decode_s, "tok_s": B * steps / decode_s,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
        else 0.0,
        "launches": launches_prefill,
        "launches_decode": ops.launch_counts(),
        "colls_prefill": colls_prefill, "colls_decode": colls_decode,
        "tokens": tok.to_local().cpu().tolist(),
        "last_logits": last if rank == 0 else None,
        "local_params": sum(p.to_local().numel()
                            for p in params.parameters())}
    del params, cache, logits, inputs, tok, api, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- f32 parity, full width, cut depth ------------------------------
    B, S, steps = args["parity_shape"]
    out["parity"] = []
    for arch, depth in args["parity"]:
        cfg = config(arch, depth)
        plan = pt.plan_for(cfg, ShapeConfig("parity", S + steps, B,
                                            "prefill"), mesh, torch.float32)
        ids = prompt(cfg, B, S, 1)

        def run(api, params, prefill, dist):
            ops.reset_launch_counts()
            logits_all, toks = [], []
            with counting_drops() as count:
                if dist:
                    logits, cache = prefill(
                        params, pt.distribute(
                            ids, plan.batch_specs["inputs"], api))
                    full = api.shards.full(logits)
                    tok = pt.next_tokens(api, logits)
                else:
                    logits, cache = prefill(params, ids)
                    full = logits
                    tok = logits[:, -1].argmax(-1)[:, None]
                logits_all.append(full.float().cpu())
                for i in range(steps):
                    toks.append((api.shards.full(tok) if dist else tok).cpu())
                    logits, cache = api.decode_step(params, cache, tok,
                                                    S + i)
                    full = api.shards.full(logits) if dist else logits
                    logits_all.append(full.float().cpu())
                    tok = pt.next_tokens(api, logits) if dist else \
                        logits[:, -1].argmax(-1)[:, None]
                dropped = count.dropped
            sync()
            return logits_all, toks, dropped, ops.launch_counts()

        api = build_model(cfg, device=dev, dtype=torch.float32, mesh=dm)
        params = pt.init_params(api, plan, seed=0)
        got = run(api, params, pt.partitioned_prefill_step(
            api, S + steps, plan), True)
        del params, api
        row = {"arch": arch, "depth": depth, "launches": got[3],
               "dropped": got[2]}
        if rank == 0:
            api1 = build_model(cfg, device=dev, dtype=torch.float32)
            p1 = api1.init(0)
            want = run(api1, p1, lambda p, x: api1.prefill(p, x, S + steps),
                       False)
            del p1, api1
            row["max_rel_err"] = max(
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got[0], want[0]))
            row["tokens_equal"] = all(torch.equal(a, b)
                                      for a, b in zip(got[1], want[1]))
            row["dropped_ref"] = want[2]
            row["launches_ref"] = want[3]
        out["parity"].append(row)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def partition_one(dev, smi) -> dict:
    """Phase 15d: a group of one rank in this process, the 1 x 1 mesh:
    the partitioned bf16 prefill of ``PART_ONE`` at phase 8's shape equal
    bit for bit to the unpartitioned one (the same kernels in the same
    order).  The group is destroyed also on failure."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as pt
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models.api import build_model

    cfg = get_config(PART_ONE)
    B, S, max_len = SERVE_REQUESTS, SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    api1 = build_model(cfg, device=dev)
    params = api1.init(0)
    ops.reset_launch_counts()
    want, want_cache = api1.prefill(params, ids, max_len)
    launches_ref = ops.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            mesh = Mesh((1, 1), ("data", "model"))
            api = build_model(cfg, device=dev, mesh=device_mesh(mesh,
                                                                "cuda"))
            plan = pt.plan_for(cfg, ShapeConfig("one", max_len, B,
                                                "prefill"), mesh)
            pt.distribute_params(params, plan, api)   # views, no copy
            ops.reset_launch_counts()
            got, cache = pt.partitioned_prefill_step(api, max_len, plan)(
                params, pt.distribute(ids, plan.batch_specs["inputs"], api))
            launches = ops.launch_counts()
            torch.cuda.synchronize(dev)
            equal = torch.equal(got.to_local(), want) and all(
                torch.equal(cache[k].to_local(), want_cache[k])
                for k in want_cache)
        finally:
            dist.destroy_process_group()
    res = {"arch": PART_ONE, "equal": equal, "launches": launches,
           "launches_ref": launches_ref}
    log(f"[partition] 1x1 mesh {PART_ONE} bf16 prefill {B} x {S}: "
        f"partitioned {'==' if equal else '!='} unpartitioned (logits and "
        f"cache, bit for bit), launches {launches} vs {launches_ref} | {smi}")
    if not equal or launches != launches_ref:
        raise AssertionError(f"partition 1x1: {res}")
    return res


def partition_serve_ref(dev, smi, last) -> dict:
    """Phase 15a's check: the full-size model of the ranks' bf16 serve
    (``PART_SERVE``, seed 0) prefills the same prompt in this process,
    unpartitioned, twice: in bf16, and in f32 with the bf16 model's
    weights (each bf16 leaf rounded to bf16, held in f32).  Rank 0's
    gathered last-position logits ``last`` [B, V] and the unpartitioned
    bf16 ones each lie at some distance from the f32 ones (the norm of the
    difference over the norm, all requests); the partitioned program's
    must be within ``PART_BF16_FACTOR`` times the one-card program's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    arch, B, S, steps = PART_SERVE
    cfg = get_config(arch)
    ids = part_prompt(cfg, B, S, 0).to(dev)

    def last_logits(dtype):
        api = build_model(cfg, device=dev, dtype=dtype)
        with torch.inference_mode():
            params = api.init(0)
            if dtype == torch.float32:
                like = build_model(cfg, device="meta").init(0)
                for p, q in zip(params.parameters(), like.parameters()):
                    if q.dtype == torch.bfloat16:
                        p.copy_(p.to(torch.bfloat16))
            out = api.prefill(params, ids, S + steps + 1)[0][:, -1]
            out = out.float().cpu()
        del params, api
        _free_card()
        return out

    one = last_logits(torch.bfloat16)
    f32 = last_logits(torch.float32)

    def dist(a, b, dim=None):
        return ((a - b).norm(dim=dim) / b.norm(dim=dim)).tolist()
    res = {"arch": arch, "part_vs_f32": dist(last, f32),
           "one_vs_f32": dist(one, f32),
           "part_vs_f32_by_request": dist(last, f32, -1),
           "one_vs_f32_by_request": dist(one, f32, -1),
           "part_vs_one_max_rel": float((last - one).abs().max()
                                        / one.abs().max()),
           "greedy_agree_one": int((last.argmax(-1) == one.argmax(-1)).sum()),
           "greedy_agree_f32": [int((x.argmax(-1) == f32.argmax(-1)).sum())
                                for x in (last, one)],
           "factor": PART_BF16_FACTOR, "requests": B}
    log(f"[partition] {arch} bf16 full size, prefill {B} x {S}, last "
        f"position's logits against the model unpartitioned in f32: rank "
        f"0's gathered {res['part_vs_f32']:.4e}, the one-card bf16 "
        f"{res['one_vs_f32']:.4e} (|a - b| / |b| over all requests; limit "
        f"{PART_BF16_FACTOR} x the one-card's); by request "
        f"{[round(x, 4) for x in res['part_vs_f32_by_request']]} against "
        f"{[round(x, 4) for x in res['one_vs_f32_by_request']]}; "
        f"partitioned vs one-card bf16 max rel "
        f"{res['part_vs_one_max_rel']:.3e}; greedy tokens equal to the "
        f"one-card bf16's on {res['greedy_agree_one']} of {B}, to f32's on "
        f"{res['greedy_agree_f32'][0]} (one-card bf16: "
        f"{res['greedy_agree_f32'][1]}) | {smi}")
    if last.shape != f32.shape or \
            not res["part_vs_f32"] <= PART_BF16_FACTOR * res["one_vs_f32"]:
        raise AssertionError(f"partition bf16 serve vs f32: {res} (shapes "
                             f"{tuple(last.shape)}, {tuple(f32.shape)})")
    return res


def partition_phase(dev, smi) -> dict:
    """Phase 15 (``[partition]``): ``PART_RANKS`` ranks on the one card
    (``launch/partition.py`` ``run_ranks``, gloo), mesh ``PART_MESH``:
    the full-size serve, the f32 parity rows; then the serve's logits
    against the model unpartitioned and the 1 x 1 mesh, in this process.  The kernels are built here, once, before the ranks start
    (the build's guard is a thread lock, not a process lock)."""
    from repro_torch.kernels import backend
    from repro_torch.launch.partition import run_ranks

    backend.library(backend.MODEL_SOURCE)
    _free_card()
    t0 = time.perf_counter()
    ranks = run_ranks(f"{Path(__file__).resolve()}:partition_rank",
                      PART_RANKS, "gloo", {
                          "device": "cuda:0", "mesh": PART_MESH,
                          "serve": PART_SERVE, "parity": PART_PARITY,
                          "parity_shape": PART_PARITY_SHAPE}, timeout=900)
    ranks_s = time.perf_counter() - t0
    arch, B, S, steps = PART_SERVE
    bad = []
    for r in ranks:
        sv = r["serve"]
        colls = ", ".join(f"{k} {v:.4g} B" for k, v in
                          sorted(sv["colls_prefill"].items()))
        dcolls = ", ".join(f"{k} {v:.4g} B" for k, v in
                           sorted(sv["colls_decode"].items()))
        log(f"[partition] rank {r['rank']} of {PART_RANKS} (mesh "
            f"{PART_MESH[0]}x{PART_MESH[1]}, gloo, one card) {arch} bf16 "
            f"full width and depth, {sv['local_params'] / 1e9:.3f} B local "
            f"parameters: prefill {B} x {S} {sv['prefill_s']:.4f} s, "
            f"decode {steps} steps {sv['tok_s']:.2f} tok/s, peak "
            f"{sv['peak_gb']:.2f} GB, flash launches "
            f"{sv['launches']['flash_attention']} (wgmma "
            f"{sv['launches']['flash_attention_wgmma']}); prefill "
            f"collectives: {colls}; decode step: {dcolls} | {smi}")
        if sv["launches"]["flash_attention"] == 0:
            bad.append(f"rank {r['rank']}: no flash launch")
        for row in r["parity"]:
            if row["arch"] == "zamba2-1.2b" and \
                    row["launches"]["ssd_intra_chunk"] == 0:
                bad.append(f"rank {r['rank']}: no SSD launch")
            if row["launches"]["flash_attention"] == 0:
                bad.append(f"rank {r['rank']} {row['arch']}: no flash")
    if any(r["serve"]["tokens"] != ranks[0]["serve"]["tokens"]
           for r in ranks):
        bad.append("the ranks' decoded tokens differ")
    Bp, Sp, steps_p = PART_PARITY_SHAPE
    for row, *others in zip(ranks[0]["parity"],
                            *(r["parity"] for r in ranks[1:])):
        log(f"[partition] f32 parity {row['arch']} at {row['depth']} "
            f"layers, full width, {Bp} x {Sp} + {steps_p} greedy steps: "
            f"logits max rel err {row['max_rel_err']:.3e} (limit "
            f"{PART_TOL}), tokens equal {row['tokens_equal']}, dropped "
            f"pairs {row['dropped']} vs {row['dropped_ref']} "
            f"unpartitioned; launches per rank "
            f"{[o['launches'] for o in [row] + others]}, unpartitioned "
            f"{row['launches_ref']} | {smi}")
        if not (row["max_rel_err"] <= PART_TOL and row["tokens_equal"]
                and row["dropped"] == row["dropped_ref"]):
            bad.append(f"parity {row['arch']}: {row}")
    if bad:
        raise AssertionError("partition: " + "; ".join(bad))
    serve_ref = partition_serve_ref(dev, smi, ranks[0]["serve"]["last_logits"])
    one = partition_one(dev, smi)
    seconds = time.perf_counter() - t0
    log(f"[partition] phase 15 in {seconds:.1f} s ({ranks_s:.1f} s the "
        f"{PART_RANKS} ranks, start-up included)")
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["serve"]["launches"])
        launches.update(r["serve"]["launches_decode"])
        for row in r["parity"]:
            launches.update(row["launches"])
    launches.update(one["launches"])
    for r in ranks:
        r["serve"].pop("last_logits")
    return {"ranks": ranks, "serve_ref": serve_ref, "one": one,
            "seconds": seconds, "launches": dict(launches)}


# ---------------------------------------------------------------------------
# 16. the partitioned train step on ranks of the one card
# ---------------------------------------------------------------------------

def fsdp_budget(cfg, shape, mesh, dtype):
    """An HBM budget at which the planner picks FSDP for ``cfg``'s
    ``shape`` on ``mesh``: between the least at which FSDP fits and the
    least at which a candidate without it does (geometric mean)."""
    from repro_torch.hw.gpu import H100Spec
    from repro_torch.launch import partition as pt

    def plan(hbm):
        return pt.plan_for(cfg, shape, mesh, dtype,
                           pod=dataclasses.replace(H100Spec(),
                                                   hbm_bytes=hbm))

    def least(fits):
        lo, hi = 1.0, 1e13
        while hi / lo > 1.0001:
            mid = (lo * hi) ** 0.5
            lo, hi = (lo, mid) if fits(plan(mid)) else (mid, hi)
        return hi
    hbm = (least(lambda p: p.valid) * least(lambda p: not p.fsdp)) ** 0.5
    if not plan(hbm).fsdp:
        raise AssertionError(f"{cfg.name}: no budget forces FSDP")
    return hbm


def pt_config(arch, depth=None, tiny=False):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_config(cfg)
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         num_layers=depth)


def pt_batches(cfg, B, S, steps):
    """Phase 16's batches: ``launch/train.py``'s synthetic ones, seed 0."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    shape = ShapeConfig("pt", S, B, "train")
    return [synth_batch(cfg, shape, i, DataConfig(seed=0))
            for i in range(steps)]


def partition_train_rank(rank: int, world: int, args: dict) -> dict:
    """Phase 16 on one rank, in a process of its own (``run_ranks``): the
    full-size bf16 train steps (the first counted under the op counter,
    the launch counters set to 0 just before it and read after the last),
    then the f32 parity rows, each rank's gradient windows of the first
    batch held against the unpartitioned step's, which the parent saved
    (``refs``: per row a file of whole gradients, read a window at a
    time).  ``args``: device, mesh, train, parity, parity_shape, refs and
    budgets; ``tiny`` cuts the configurations to ``tiny_config`` (the CPU
    check of this function)."""
    import gc

    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.hw.gpu import H100Spec
    from repro_torch.kernels import ops
    from repro_torch.launch import partition as pt
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models.api import build_model
    from repro_torch.models.common import token_losses
    from repro_torch.optim.optimizers import TreeShards, tree_map

    dev = torch.device(args["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    tiny = args.get("tiny", False)
    axes = ("data", "model")
    dms = {m: device_mesh(Mesh(m, axes), dev.type)
           for m in {tuple(args["mesh"])} | {tuple(r[3])
                                             for r in args["parity"]}
           | {tuple(m) for m in args["witness"]}}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def setup(cfg, mesh, B, S, dtype, pod=H100Spec(), eps=None):
        api = build_model(cfg, device=dev, dtype=dtype, mesh=dms[mesh],
                          trainable=True)
        plan = pt.plan_for(cfg, ShapeConfig("pt", S, B, "train"),
                           Mesh(mesh, axes), dtype, pod=pod)
        params = pt.init_params(api, plan, seed=0)
        opt = pt.default_optimizer(cfg, params, lr=1e-3,
                                   **({} if eps is None else {"eps": eps}))
        return api, opt, plan, params, pt.init_opt_state(api, opt, plan)

    def first_tokens(cfg, api, plan, params, bs):
        """The loss of each token of the batches ``bs`` (forward only),
        gathered over the data axes: [len(bs) x B, S] on the host."""
        sh, out = api.shards, []
        with torch.no_grad():
            for b in bs:
                b = pt.distribute_batch({k: torch.from_numpy(v).to(dev)
                                         for k, v in b.items()}, plan, api)
                h = api.forward(params, b["inputs"], return_hidden=True)
                out.append(sh.all_gather(token_losses(
                    h.to_local(), sh.local(params.lm_head),
                    b["targets"].to_local(), cfg.final_logit_softcap,
                    sh=sh, vocab=cfg.padded_vocab), 0, sh.data_axes).cpu())
                del h
        return torch.cat(out)

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def equal_windows(sh, params) -> bool:
        """Every rank holding the same window of a leaf holds its bytes."""
        bad = torch.zeros((), device=dev)
        with torch.no_grad():
            for p in params.parameters():
                lay = sh.layout(p)
                peers = [a for a in sh.axis_names
                         if not any(a in ax for ax in lay.axes)]
                x = p.to_local().reshape(1, -1)
                bad += (sh.all_gather(x, 0, peers) != x).any().float()
        return float(sh.all_reduce(bad, sh.axis_names)) == 0.0

    out = {"rank": rank}
    # ---- the full-size train steps, bf16 --------------------------------
    arch, steps, B, S = args["train"]
    cfg = pt_config(arch, tiny=tiny)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    api, opt, plan, params, state = setup(cfg, tuple(args["mesh"]), B, S,
                                          torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t0
    step = pt.partitioned_train_step(api, opt, plan)
    losses, seconds = [], []
    batches = pt_batches(cfg, B, S, steps)
    witness_batches = pt_batches(cfg, B, S, PT_WITNESS_BATCHES)
    tokens = first_tokens(cfg, api, plan, params, witness_batches)
    ops.reset_launch_counts()
    for i, b in enumerate(batches):
        batch = pt.distribute_batch({k: torch.from_numpy(v).to(dev)
                                     for k, v in b.items()}, plan, api)
        sync()
        t0 = time.perf_counter()
        if i == 0:                     # untimed: counted
            with OpCounter(dev) as counter:
                counter.hold(params, state, batch)
                params, state, m = step(params, state, batch)
            cost = counter.cost()
        else:
            params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        sync()
        seconds.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    step_s = min(seconds[1:])
    out["train"] = {
        "arch": arch, "init_s": init_s, "losses": losses,
        "token_losses": tokens if rank == 0 else None,
        "grad_norm": float(m["grad_norm"]), "step_seconds": seconds,
        "step_s": step_s, "tokens_per_s": B * S / step_s,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
        else 0.0, "launches": launches,
        "plan": {"zero": plan.zero_opt, "fsdp": plan.fsdp,
                 "attn_sharded": plan.attn_sharded},
        "flops": cost.flops, "bytes": cost.bytes,
        "coll_by_kind": cost.coll_by_kind, "kernel_units": cost.kernel_units,
        "local_params": sum(p.to_local().numel()
                            for p in params.parameters())}
    del api, params, state, step, batch, m
    free()

    # ---- f32 parity, full width, cut depth --------------------------------
    Bp, Sp, steps_p = args["parity_shape"]
    out["parity"] = []
    for name, arch_p, depth, mesh, force, eps in args["parity"]:
        cfg_p = pt_config(arch_p, depth, tiny)
        pod = dataclasses.replace(H100Spec(), hbm_bytes=args["budgets"][
            name]) if force else H100Spec()
        api, opt, plan, params, state = setup(cfg_p, tuple(mesh), Bp, Sp,
                                              torch.float32, pod, eps)
        sh = api.shards
        refs = torch.load(args["refs"][name], mmap=True)
        step = pt.partitioned_train_step(api, opt, plan)
        ops.reset_launch_counts()
        row = {"name": name, "plan": {"zero": plan.zero_opt,
                                      "fsdp": plan.fsdp},
               "loss": [], "grad_norm": [], "equal": []}
        for i, b in enumerate(pt_batches(cfg_p, Bp, Sp, steps_p)):
            batch = pt.distribute_batch({k: torch.from_numpy(v).to(dev)
                                         for k, v in b.items()}, plan, api)
            if i == 0:            # the first batch's gradients, as reduced
                api.loss_fn(params, batch).backward()
                named = dict(params.named_parameters())
                view = TreeShards(sh, {n: sh.layout(p)
                                       for n, p in named.items()},
                                  tree_map(sh.layout, state), opt.mirror)
                errs, flips = {}, torch.zeros((), device=dev)
                with torch.no_grad():
                    for n, p in named.items():
                        lay = view.grads[n]
                        g = view.reduce(n, p.grad.to_local())
                        want = refs[n][tuple(
                            slice(o, o + k) for o, k in
                            zip(lay.offsets, lay.sizes))].to(dev)
                        # elements whose gradient changes sign: AdamW's
                        # first update moves them by 2 lr apart; the
                        # largest |g| among them, beside the leaf's error
                        flip = (g > 0) != (want > 0)
                        flips += flip.sum()
                        errs[n] = torch.stack([
                            (g.float() - want).abs().max(),
                            torch.where(flip, want.abs(), 0.0).max()])
                    # the largest over the ranks, a leaf at a time
                    errs = dict(zip(errs, sh.all_reduce(
                        torch.stack(list(errs.values())), sh.axis_names,
                        "max").tolist()))
                row["sign_flips"] = int(sh.all_reduce(flips, sh.axis_names))
                for p in named.values():
                    p.grad = None
                row["grad_abs_err"] = {n: e for n, (e, _) in errs.items()}
                row["flip_max_abs"] = {n: f for n, (_, f) in errs.items()}
            params, state, m = step(params, state, batch)
            row["loss"].append(float(m["loss"]))
            row["grad_norm"].append(float(m["grad_norm"]))
            row["equal"].append(equal_windows(sh, params))
        sync()
        row["launches"] = ops.launch_counts()
        out["parity"].append(row)
        del api, params, state, step, refs, batch
        free()

    # ---- the witness batches' bf16 loss on a data-only and a model-only
    # mesh
    out["witness"] = {}
    for mesh in args["witness"]:
        api = build_model(cfg, device=dev, dtype=torch.bfloat16,
                          mesh=dms[tuple(mesh)], trainable=True)
        plan = pt.plan_for(cfg, ShapeConfig("pt", S, B, "train"),
                           Mesh(tuple(mesh), axes))
        params = pt.init_params(api, plan, seed=0)
        t = first_tokens(cfg, api, plan, params, witness_batches)
        out["witness"]["x".join(map(str, mesh))] = t if rank == 0 else None
        del api, params
        free()
    return out


def pt_reference(dev, arch, depth, tiny, path, eps=None) -> dict:
    """The unpartitioned f32 step of a parity row on ``dev`` (AdamW's
    ``eps`` where given): its first batch's gradients to ``path`` (whole,
    on the host), each leaf's max |g|, and the losses and gradient norms
    of ``PT_PARITY_SHAPE``'s steps."""
    import torch
    from repro_torch.launch import partition as pt
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model

    cfg = pt_config(arch, depth, tiny)
    B, S, steps = PT_PARITY_SHAPE
    api = build_model(cfg, device=dev, dtype=torch.float32, trainable=True)
    params = api.init(0)
    opt = pt.default_optimizer(cfg, params, lr=1e-3,
                               **({} if eps is None else {"eps": eps}))
    state = opt.init(dict(params.named_parameters()))
    step = build_train_step(api, opt)
    res = {"loss": [], "grad_norm": [], "path": path}
    for i, b in enumerate(pt_batches(cfg, B, S, steps)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if i == 0:
            api.loss_fn(params, batch).backward()
            grads = {n: p.grad.detach().cpu()
                     for n, p in params.named_parameters()}
            res["grad_max"] = {n: float(g.abs().max())
                               for n, g in grads.items()}
            torch.save(grads, path)
            del grads
            for p in params.parameters():
                p.grad = None
        params, state, m = step(params, state, batch)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
    del api, params, state, step
    if dev.type == "cuda":
        _free_card()
    return res


def pt_loss_ref(dev, arch, B, S, tiny=False) -> dict:
    """Phase 16a's check: the loss of each token of the first
    ``PT_WITNESS_BATCHES`` batches of the full-size model, seed 0,
    unpartitioned in this process, forward only: in bf16, and in f32 with
    the bf16 model's weights (each bf16 leaf rounded to bf16, held in
    f32); [batches x B, S] each."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.models.common import token_losses
    cfg = pt_config(arch, tiny=tiny)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in pt_batches(cfg, B, S, PT_WITNESS_BATCHES)]
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        api = build_model(cfg, device=dev, dtype=dtype)
        with torch.inference_mode():
            params = api.init(0)
            if dtype == torch.float32:
                like = build_model(cfg, device="meta").init(0)
                for p, q in zip(params.parameters(), like.parameters()):
                    if q.dtype == torch.bfloat16:
                        p.copy_(p.to(torch.bfloat16))
            out[name] = torch.cat([token_losses(
                api.forward(params, b["inputs"], return_hidden=True),
                params.lm_head, b["targets"], cfg.final_logit_softcap).cpu()
                for b in batches])
        del params, api
        _free_card()
    return out


def pt_meta_count(arch, B, S, mesh, tiny=False) -> dict:
    """Rank 0's step of phase 16a traced on ``meta`` under a fake group of
    the mesh's size: its FLOPs, bytes and collective bytes by kind."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import partition as pt
    from repro_torch.launch.mesh import Mesh, device_mesh, fake_group
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.steps import input_structs
    from repro_torch.models.api import build_model

    cfg = pt_config(arch, tiny=tiny)
    shape = ShapeConfig("pt", S, B, "train")
    m = Mesh(mesh, ("data", "model"))
    t0 = time.perf_counter()
    plan = pt.plan_for(cfg, shape, m)
    with fake_group(m.size):
        api = build_model(cfg, device="meta", mesh=device_mesh(m, "cpu"),
                          trainable=True)
        params = pt.init_params(api, plan)
        opt = pt.default_optimizer(cfg, params, lr=1e-3)
        state = pt.init_opt_state(api, opt, plan)
        batch = pt.distribute_batch(input_structs(cfg, shape), plan, api)
        with OpCounter("meta") as counter:
            counter.hold(params, state, batch)
            pt.partitioned_train_step(api, opt, plan)(params, state, batch)
    c = counter.cost()
    return {"flops": c.flops, "bytes": c.bytes,
            "coll_by_kind": c.coll_by_kind, "kernel_units": c.kernel_units,
            "peak_bytes": c.peak_bytes, "seconds": time.perf_counter() - t0}


def pt_ref_key(arch, eps) -> str:
    """The name of a parity row's unpartitioned reference."""
    return arch if eps is None else f"{arch}-eps{eps:g}"


def partition_train_phase(dev, smi, tiny=False) -> dict:
    """Phase 16 (``[partition-train]``): the unpartitioned f32 parity
    steps in this process first (their gradients saved to the host, the
    card freed), then ``PART_RANKS`` ranks on the one card, mesh
    ``PT_MESH``: the full-size bf16 train steps and the f32 parity rows;
    then, the ranks gone, the full-size model's first loss unpartitioned
    in bf16 and f32, and rank 0's step traced on meta.  A rank that fails
    fails the phase.  ``tiny`` cuts every configuration to
    ``tiny_config`` (the CPU check of this function, ``dev`` the CPU)."""
    import tempfile

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import backend
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.partition import run_ranks

    import torch
    if dev.type == "cuda":        # built once, before the ranks start
        backend.library(backend.MODEL_SOURCE)
    _free_card()
    t0 = time.perf_counter()
    Bp, Sp, steps_p = PT_PARITY_SHAPE
    with tempfile.TemporaryDirectory(prefix="pt_refs_") as tmp:
        refs, ref_paths, budgets = {}, {}, {}
        for name, arch, depth, mesh, force, eps in PT_PARITY:
            key = pt_ref_key(arch, eps)
            if key not in refs:
                refs[key] = pt_reference(dev, arch, depth, tiny,
                                         str(Path(tmp) / f"{key}.pt"), eps)
            ref_paths[name] = refs[key]["path"]
            if force:
                budgets[name] = fsdp_budget(
                    pt_config(arch, depth, tiny), ShapeConfig("pt", Sp, Bp,
                                                              "train"),
                    Mesh(mesh, ("data", "model")), torch.float32)
        ref_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        ranks = run_ranks(
            f"{Path(__file__).resolve()}:partition_train_rank", PART_RANKS,
            "gloo", {"device": str(dev), "mesh": PT_MESH, "train": PT_TRAIN,
                     "parity": PT_PARITY, "parity_shape": PT_PARITY_SHAPE,
                     "witness": PT_WITNESS, "refs": ref_paths,
                     "budgets": budgets, "tiny": tiny},
            timeout=1000)
        ranks_s = time.perf_counter() - t1
    arch, steps, B, S = PT_TRAIN
    losses = pt_loss_ref(dev, arch, B, S, tiny)
    meta = pt_meta_count(arch, B, S, PT_MESH, tiny)
    bad = []
    for r in ranks:
        tr = r["train"]
        colls = ", ".join(f"{k} {v:.4g} B" for k, v in
                          sorted(tr["coll_by_kind"].items()))
        log(f"[partition-train] rank {r['rank']} of {PART_RANKS} (mesh "
            f"{PT_MESH[0]}x{PT_MESH[1]}, gloo, one card) {arch} bf16 full "
            f"width and depth, {tr['local_params'] / 1e9:.3f} B local "
            f"parameters, AdamW, plan zero={tr['plan']['zero']} "
            f"fsdp={tr['plan']['fsdp']}: {steps} eager steps of {B} x {S} "
            f"(step 1 counted), step {tr['step_s']:.4f} s (min of steps "
            f"2-{steps}; all {[round(x, 4) for x in tr['step_seconds']]}), "
            f"{tr['tokens_per_s']:.1f} tokens/s, peak {tr['peak_gb']:.2f} "
            f"GB, losses {[round(x, 5) for x in tr['losses']]}, launches "
            f"{tr['launches']}; step 1's collectives: {colls} | {smi}")
        if not all(math.isfinite(x) for x in tr["losses"]):
            bad.append(f"rank {r['rank']}: losses {tr['losses']}")
        for k in ("flash_attention", "ssd_intra_chunk"):
            if not tr["launches"].get(k):
                bad.append(f"rank {r['rank']}: no {k} launch")
    tr0 = ranks[0]["train"]
    if any(r["train"]["losses"] != tr0["losses"] for r in ranks):
        bad.append("the ranks' losses differ")
    tokens, f32 = tr0.pop("token_losses"), losses["f32"]

    def dist(a, rows=None):
        return float((a[:rows] - f32[:rows]).norm() / f32[:rows].norm())
    part, one = dist(tokens, B), dist(losses["bf16"], B)
    log(f"[partition-train] {arch} first batch's loss of each of its "
        f"{f32[:B].numel()} tokens against the same weights' f32 ones (|a - "
        f"b| / |b|): the partitioned bf16 {part:.4e}, the one-card bf16 "
        f"{one:.4e} (limit {PART_BF16_FACTOR} x the one-card's); the "
        f"means: f32 {float(f32[:B].mean()):.6f}, partitioned "
        f"{float(tokens[:B].mean()):.6f}, one-card "
        f"{float(losses['bf16'][:B].mean()):.6f}, the partitioned step's "
        f"first loss {tr0['losses'][0]:.6f} | {smi}")
    if tokens.shape != f32.shape or not part <= PART_BF16_FACTOR * one:
        bad.append(f"token losses {part:.3e} from f32, one-card {one:.3e}")
    # the scalar loss's offset from f32, by mesh: each row's mean is an
    # independent draw of the rounding noise (rows share no prefix), so
    # the offset is held against its standard error over the rows, not
    # against one other draw; a fault's bias moves every row alike
    witness = {f"{PT_MESH[0]}x{PT_MESH[1]}": tokens,
               **ranks[0].pop("witness")}

    def offset(a, b):
        """The mean over the rows of ``a - b``'s row means, its standard
        error, and their ratio."""
        d = (a.double() - b.double()).mean(1)
        mean, se = float(d.mean()), float(d.std() / math.sqrt(d.numel()))
        return {"mean": mean, "se": se,
                "z": 0.0 if mean == 0 else mean / se}
    one_off = offset(losses["bf16"], f32)
    offsets = {m: {"vs_f32": offset(t, f32),
                   "vs_one_card": offset(t, losses["bf16"]),
                   "per_token": dist(t)} for m, t in witness.items()}
    log(f"[partition-train] {arch} the first {PT_WITNESS_BATCHES} batches' "
        f"scalar loss by mesh (data x model), same (initial) weights, forward "
        f"only, mean of the {f32.shape[0]} rows' offsets "
        f"+- its standard error: one-card bf16 from f32 "
        f"{one_off['mean']:+.4e} +- {one_off['se']:.2e}; "
        + "; ".join(f"{m} from f32 {o['vs_f32']['mean']:+.4e} +- "
                    f"{o['vs_f32']['se']:.2e}, from the one-card bf16 "
                    f"{o['vs_one_card']['mean']:+.4e} +- "
                    f"{o['vs_one_card']['se']:.2e} (z {o['vs_one_card']['z']:+.2f},"
                    f" limit {PT_BIAS_Z}), per token {o['per_token']:.4e}"
                    for m, o in offsets.items()) + f" | {smi}")
    for m, o in offsets.items():
        if not abs(o["vs_one_card"]["z"]) <= PT_BIAS_Z:
            bad.append(f"{m}: the scalar loss is {o['vs_one_card']['z']:+.2f}"
                       f" standard errors from the one-card bf16's")
    same = {k: (tr0[k], meta[k]) for k in ("flops", "bytes",
                                            "coll_by_kind", "kernel_units")}
    log(f"[partition-train] rank 0's counted step against its meta trace "
        f"under a fake group of {PART_RANKS} ({meta['seconds']:.1f} s): "
        + ", ".join(f"{k} {a} vs {b}" for k, (a, b) in same.items())
        + f"; meta peak {meta['peak_bytes'] / 1e9:.2f} GB, the card's "
        f"{tr0['peak_gb']:.2f} GB")
    if any(a != b for a, b in same.values()):
        bad.append(f"rank 0's counts differ from the meta trace's: {same}")
    for (name, arch_p, depth, mesh, force, eps), row, *others in zip(
            PT_PARITY, ranks[0]["parity"],
            *(r["parity"] for r in ranks[1:])):
        ref = refs[pt_ref_key(arch_p, eps)]
        loss_errs = [abs(a - b) / abs(b) for a, b in zip(row["loss"],
                                                         ref["loss"])]
        norm_errs = [abs(a - b) / abs(b) for a, b in zip(
            row["grad_norm"], ref["grad_norm"])]
        first = max(loss_errs[0], norm_errs[0])
        steps_err = max(loss_errs + norm_errs)
        steps_tol = PT_STEPS_TOL if eps is None else PT_LOSS_TOL

        def rel(d):
            return {n: e / max(ref["grad_max"][n], 1e-30)
                    for n, e in d.items()}
        errs, flip = rel(row["grad_abs_err"]), rel(row["flip_max_abs"])
        worst = max(errs, key=errs.get)
        worst_flip = max(flip, key=flip.get)
        equal = all(all(o["equal"]) for o in [row] + others)
        log(f"[partition-train] f32 parity {name}: {arch_p} at {depth} "
            f"layers, full width, mesh {mesh[0]}x{mesh[1]}, plan "
            f"{row['plan']}, AdamW eps {1e-8 if eps is None else eps:g}, "
            f"{Bp} x {Sp}, {steps_p} steps: the first step's "
            f"loss and grad_norm rel err {first:.3e} (limit {PT_LOSS_TOL}), "
            f"every step's {steps_err:.3e} (limit {steps_tol}; by step: "
            f"losses {row['loss']} vs {ref['loss']}, grad_norm "
            f"{row['grad_norm']} vs {ref['grad_norm']}); gradient leaves "
            f"max err over max |g| "
            f"{errs[worst]:.3e} ({worst}; limit {PT_GRAD_TOL}), "
            f"{row['sign_flips']} elements of the ranks' windows of the first "
            f"gradient with the other sign, the largest |g| among them "
            f"{max(row['flip_max_abs'].values()):.3e} ("
            f"{flip[worst_flip]:.3e} of its leaf's max |g|, {worst_flip}); "
            f"data ranks' parameters equal bit "
            f"for bit after each update: {equal}; launches per rank "
            f"{[o['launches'] for o in [row] + others]} | {smi}")
        if force and not row["plan"]["fsdp"]:
            bad.append(f"parity {name}: the plan is not FSDP")
        if not (first <= PT_LOSS_TOL and steps_err <= steps_tol and
                errs[worst] <= PT_GRAD_TOL and equal):
            bad.append(f"parity {name}: first step {first:.3e}, steps "
                       f"{steps_err:.3e}, leaf {errs[worst]:.3e}, equal "
                       f"{equal}")
    if bad:
        raise AssertionError("partition-train: " + "; ".join(bad))
    seconds = time.perf_counter() - t0
    log(f"[partition-train] phase 16 in {seconds:.1f} s ({ref_s:.1f} s the "
        f"unpartitioned references, {ranks_s:.1f} s the {PART_RANKS} ranks, "
        f"start-up included)")
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["train"]["launches"])
        for row in r["parity"]:
            launches.update(row["launches"])
    return {"ranks": ranks, "references": refs,
            "token_losses": {"partitioned_vs_f32": part,
                             "one_card_vs_f32": one,
                             "scalar_offsets_by_mesh": offsets,
                             "one_card_scalar_offset": one_off,
                             "means": {k: float(v[:B].mean())
                                       for k, v in losses.items()}},
            "meta": meta, "seconds": seconds, "launches": dict(launches)}


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
    ap.add_argument("--partition-only", action="store_true",
                    help="build, run phase 15 (the partitioned serve on "
                    "ranks of the one card) and stop without a result line")
    ap.add_argument("--partition-train-only", action="store_true",
                    help="build, run phase 16 (the partitioned train step "
                    "on ranks of the one card) and stop without a result "
                    "line")
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
    if args.partition_only:
        partition_phase(dev, card_power())
        log("[partition] stopping (--partition-only)")
        return 0
    if args.partition_train_only:
        partition_train_phase(dev, card_power())
        log("[partition-train] stopping (--partition-train-only)")
        return 0

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
    detail["train_tiny_lm"] = tiny_lm_phase()
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
    # 15. the partitioned serve on ranks of the one card -----------------
    detail["partition"] = partition_phase(dev, smi)
    # 16. the partitioned train step on ranks of the one card ------------
    detail["partition_train"] = partition_train_phase(dev, smi)
    # the same step eager (phase 13b) and replayed (phase 10), one run
    eager = next(c for c in detail["dryrun"]["checks"]
                 if c["mode"] == "train")
    prof = train_res["profile"]
    log(f"[train-compare] {TRAIN[0]} {TRAIN[2]} x {TRAIN[3]} bf16: eager "
        f"step (phase 13b) {eager['step_s']:.4f} s (min of "
        f"{[round(x, 4) for x in eager['step_seconds']]}), replayed (phase "
        f"10) {train_res['step_s']:.4f} s (min of "
        f"{[round(x, 4) for x in train_res['step_seconds'][1:]]}); "
        f"profiled: eager busy {prof['eager']['device_busy_ms']:.2f} of "
        f"{prof['eager']['wall_ms']:.2f} ms (idle "
        f"{prof['eager']['idle_share']:.3f}, "
        f"{prof['eager']['device_kernels']} kernels), replay busy "
        f"{prof['replay']['device_busy_ms']:.2f} of "
        f"{prof['replay']['wall_ms']:.2f} ms (idle "
        f"{prof['replay']['idle_share']:.3f}, "
        f"{prof['replay']['device_kernels']} kernels) | {smi}")

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
    # phase 15's ranks (serve, parity) and its 1 x 1 prefill join them
    part_launches = detail["partition"]["launches"]
    for k in kernels[-2:]:
        k["uses"].append("partition")
        k["launches_partition"] = part_launches.get(k["name"], 0)
        k["launches"] += k["launches_partition"]
    kernels[-2]["launches_wgmma"] += \
        part_launches.get("flash_attention_wgmma", 0)
    # phase 16's ranks (the bf16 train steps, the f32 parity rows)
    pt_launches = detail["partition_train"]["launches"]
    for k in kernels[-2:]:
        k["uses"].append("partition-train")
        k["launches_partition_train"] = pt_launches.get(k["name"], 0)
        k["launches"] += k["launches_partition_train"]
    kernels[-2]["launches_wgmma"] += \
        pt_launches.get("flash_attention_wgmma", 0)
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
        "over its launches; their launches count phase 8's serve prefills "
        "(each serve's warm-up call and its captured replay), phase 10's "
        "training steps, phase 13's counted steps and phase 15's and 16's "
        "ranks)")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
