"""Dry-run of every (architecture x input shape x mesh) cell on ``meta``
tensors: no memory is allocated and nothing is computed.

The port of ``repro/launch/dryrun.py``.  Per cell: the reference's config
edits (``remat="block"`` for training, the int8 KV cache with
``--kv-int8``), the ``shape_applicable`` skip with the reference's reason,
meta parameters, optimizer state and cache, ``launch/steps.py``
``input_structs``, ``plan_sharding`` (``core/autoshard.py``), and the step
traced on ``meta`` under ``launch/op_cost.py``'s counter.  A decode step
is traced with ``input_structs``' meta ``cache_len``, as the reference's
is compiled with an abstract one: it attends over all ``seq_len``
positions of the static cache and masks those at or past the length on
the device, as the reference's program does.

Prefill and decode cells are traced partitioned (``"per_device":
"partitioned"``), as the reference compiles them with the plan's
``in_shardings``: one rank of the mesh, under ``launch/mesh.py``
``fake_group`` of the mesh's size, runs ``launch/partition.py``'s step
on its meta shards (``init_params``, ``init_cache``, the inputs at the
plan's batch placements).  The record's per-device FLOPs, bytes, peak,
arguments and collective bytes by kind are that rank's trace's: its
local ops, its FSDP gathers and its collectives as issued, not a formula.
One trace per (arch, shape, mesh), since the local batch differs between
the meshes.  A cell whose partitioned trace fails is a failed cell; it is
never divided by the chips instead.

Train cells are still traced once on one device, shared by both meshes,
and divided by the chips (``"per_device": "global/chips"``: the
partitioned train step, with its backward and ZeRO/FSDP state as
placements, is not ported yet).  Their collective bytes are the plan's
collective model (``autoshard.collective_bytes``); their memory record's
arguments are the plan's per-chip parameters, optimizer state and cache,
its outputs the step's results over the chips, its temporaries what the
trace's peak holds beyond the arguments and the new results, over the
chips.  The roofline reads ``pod``, the
H100 unless the caller passes another spec.  The records keep the reference's keys
(``xla_cost_analysis`` has no counterpart), so
``benchmarks/roofline_table.py`` reads them unchanged.

Usage (``-m repro_torch.launch.dryrun`` with ``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun                   # all cells, 16x16
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --multi-pod       # 512 chips
  python -m repro_torch.launch.dryrun --both-meshes --out results.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import types
from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..core.autoshard import plan_sharding
from ..hw.gpu import H100Spec
from ..models.api import build_model, layer_stacks
from ..optim.optimizers import make_optimizer
from . import partition
from .mesh import device_mesh, fake_group, make_production_mesh
from .op_cost import CompCost, OpCounter, leaf_tensors, storage_bytes
from .roofline import HEADER, analyze, model_flops_for
from .steps import (build_prefill_step, build_serve_step, build_train_step,
                    input_structs)


@dataclasses.dataclass
class Trace:
    """One step of one (arch, shape) traced on ``meta``: the counts, the
    bytes of its results (and of those not among its arguments, which an
    in-place update returns), the trace's seconds, and the meta trees the
    planner reads."""
    cost: CompCost
    output_bytes: int
    new_output_bytes: int
    #: the new results the plan counts as arguments: a prefill's cache
    planned_output_bytes: int
    seconds: float
    params: Any
    opt_state: Any
    cache: Optional[Dict[str, torch.Tensor]]


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> Trace:
    """Build the model, its inputs and (training) optimizer state on
    ``meta`` and trace one step of ``shape.mode`` under an ``OpCounter``."""
    t0 = time.perf_counter()
    train = shape.mode == "train"
    api = build_model(cfg, device="meta", trainable=train, mesh=mesh)
    params = api.init(0)
    batch = input_structs(cfg, shape)
    opt_state, cache = {}, None
    if train:
        optimizer = make_optimizer(cfg.optimizer,
                                   stacks=layer_stacks(cfg, params))
        opt_state = optimizer.init(dict(params.named_parameters()))
        step, args = build_train_step(api, optimizer), (params, opt_state,
                                                        batch)
    elif shape.mode == "prefill":
        cache = api.init_cache(shape.global_batch, shape.seq_len)
        step = build_prefill_step(api, shape.seq_len)
        args = (params, batch["inputs"])
    else:
        cache = api.init_cache(shape.global_batch, shape.seq_len)
        step = build_serve_step(api)
        args = (params, cache, batch["tokens"], batch["cache_len"])
    with OpCounter("meta") as counter:
        counter.hold(args)
        out = step(*args)
    held = {t.untyped_storage()._cdata for t in leaf_tensors(args)}
    new = [t for t in leaf_tensors(out)
           if t.untyped_storage()._cdata not in held]
    planned = storage_bytes(cache) if shape.mode == "prefill" else 0
    return Trace(counter.cost(), storage_bytes(out), storage_bytes(new),
                 planned, time.perf_counter() - t0, params, opt_state, cache)


@dataclasses.dataclass
class PartTrace:
    """One rank's partitioned step of one (arch, shape, mesh): its plan,
    its counts, and its local bytes of parameters and cache, of the
    step's results (and of those not among its arguments)."""
    plan: Any
    cost: CompCost
    argument_bytes: int
    output_bytes: int
    new_output_bytes: int
    seconds: float


def trace_partitioned(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      pod=H100Spec(),
                      dtype: torch.dtype = torch.bfloat16) -> PartTrace:
    """Plan ``shape`` on ``mesh`` (shape-only), then trace rank 0's
    prefill or decode step on its meta shards under a fake group of the
    mesh's size."""
    t0 = time.perf_counter()
    api = build_model(cfg, device="meta", mesh=mesh, dtype=dtype)
    cache = api.init_cache(shape.global_batch, shape.seq_len)
    plan = plan_sharding(cfg, shape, mesh, api.init(0), {},
                         cache_shapes=cache, pod=pod)
    del api, cache
    batch = input_structs(cfg, shape)
    with fake_group(mesh.size):
        papi = build_model(cfg, device="meta", dtype=dtype,
                           mesh=device_mesh(mesh, "cpu"))
        params = partition.init_params(papi, plan)
        if shape.mode == "prefill":
            step = partition.partitioned_prefill_step(papi, shape.seq_len,
                                                      plan)
            args = (params, partition.distribute(
                batch["inputs"], plan.batch_specs["inputs"], papi))
        else:
            cache = partition.init_cache(papi, plan, shape.global_batch,
                                         shape.seq_len)
            step = partition.partitioned_serve_step(papi, plan)
            args = (params, cache, partition.distribute(
                batch["tokens"], partition.token_spec(plan), papi),
                batch["cache_len"])
        with OpCounter("meta") as counter:
            counter.hold(args)
            out = step(*args)
        held = {t.untyped_storage()._cdata for t in leaf_tensors(args)}
        new = [t for t in leaf_tensors(out)
               if t.untyped_storage()._cdata not in held]
        cache_out = out[1]
        arg_b = storage_bytes(params) + storage_bytes(cache_out)
        return PartTrace(plan, counter.cost(), arg_b, storage_bytes(out),
                         storage_bytes(new), time.perf_counter() - t0)


def trace_hbm_bytes(tr: Trace, plan, chips: int) -> float:
    """A chip's bytes at the trace's peak: the plan's per-chip arguments
    (parameters, optimizer state, cache) and the rest of the peak (new
    results, temporaries) over the chips.  On one chip it is the meta
    peak, which the card's peak allocation matches; the planner's
    ``hbm_gb_per_chip`` (the reference's rule, which ``valid`` reads)
    counts activations by a formula instead."""
    rest = tr.cost.peak_bytes - tr.cost.held_bytes - tr.planned_output_bytes
    return argument_bytes(plan) + max(0, rest) / chips


def argument_bytes(plan) -> float:
    """The plan's per-chip parameters, optimizer state and cache."""
    b = plan.bytes_per_chip
    return b.get("params", 0.0) + b.get("opt", 0.0) + b.get("cache", 0.0)


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               verbose: bool = True, kv_int8: bool = False,
               pod=H100Spec(), traces: Optional[Dict] = None
               ) -> Dict[str, Any]:
    """Trace + plan one (arch x shape x mesh) cell; return its record.
    ``traces`` (a dict the caller keeps) holds the traces made: a train
    cell's (arch, shape) trace serves the other mesh too, a partitioned
    one is the mesh's own."""
    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    shape = SHAPES[shape_name]
    if shape.mode == "train" and cfg.remat == "none":
        # activation checkpointing is mandatory at these batch x depth
        # scales (non-remat residuals exceed HBM)
        cfg = dataclasses.replace(cfg, remat="block")
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.devices.shape)
    chips = mesh.size
    traces = {} if traces is None else traces
    if shape.mode != "train":
        # one rank of the partitioned step: its own counts, per device
        key = (arch, shape_name, kv_int8, mesh_name)
        if key not in traces:
            traces[key] = trace_partitioned(cfg, shape, mesh, pod=pod)
        pt = traces[key]
        plan, cost, per_device = pt.plan, pt.cost, "partitioned"
        new_out = pt.new_output_bytes
        temp = max(0, cost.peak_bytes - cost.held_bytes - new_out)
        trace_b = cost.peak_bytes
        mem = types.SimpleNamespace(argument_size_in_bytes=pt.argument_bytes,
                                    output_size_in_bytes=pt.output_bytes,
                                    temp_size_in_bytes=temp)
        per_dev = {"flops": cost.flops, "bytes accessed": cost.bytes}
        coll = dict(cost.coll_by_kind)
        seconds = pt.seconds
    else:
        # one trace on one device serves both meshes, divided by the chips
        key = (arch, shape_name, kv_int8, mesh.shape.get("model", 1))
        if key not in traces:
            traces[key] = trace_step(cfg, shape, mesh)
        tr = traces[key]
        plan = plan_sharding(cfg, shape, mesh, tr.params, tr.opt_state,
                             cache_shapes=tr.cache, pod=pod)
        cost, per_device, new_out = tr.cost, "global/chips", \
            tr.new_output_bytes
        temp = max(0, cost.peak_bytes - cost.held_bytes - new_out)
        trace_b = trace_hbm_bytes(tr, plan, chips)
        mem = types.SimpleNamespace(
            argument_size_in_bytes=argument_bytes(plan),
            output_size_in_bytes=tr.output_bytes / chips,
            temp_size_in_bytes=temp / chips)
        per_dev = {"flops": cost.flops / chips,
                   "bytes accessed": cost.bytes / chips}
        coll = dict(plan.coll_by_kind)
        seconds = tr.seconds
    rep = analyze(arch, shape_name, mesh_name, chips, per_dev, "",
                  model_flops_for(cfg, shape), pod=pod, mem_stats=mem,
                  coll=(sum(coll.values()), coll))
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": shape.mode, "status": "ok",
        "compile_seconds": round(seconds, 3),
        "per_device": per_device,
        "plan": {"zero": plan.zero_opt, "attn_sharded": plan.attn_sharded,
                 "fsdp": plan.fsdp, "valid": plan.valid,
                 "hbm_gb": round(plan.hbm_gb_per_chip, 2),
                 "trace_hbm_gb": round(trace_b / 2**30, 2),
                 "trace_valid": trace_b <= pod.hbm_bytes * 0.92,
                 "notes": plan.notes},
        "memory": {"argument_bytes": mem.argument_size_in_bytes,
                   "output_bytes": mem.output_size_in_bytes,
                   "temp_bytes": mem.temp_size_in_bytes},
        "trace": {"flops": cost.flops, "bytes": cost.bytes,
                  "peak_bytes": cost.peak_bytes,
                  "held_bytes": cost.held_bytes,
                  "new_output_bytes": new_out,
                  "free_copy_bytes": cost.free_copy_bytes,
                  "ops": cost.ops,
                  "kernel_units": cost.kernel_units},
        "roofline": {
            "flops_per_device": rep.flops_per_device,
            "bytes_per_device": rep.bytes_per_device,
            "collective_bytes_per_device": rep.collective_bytes_per_device,
            "coll_by_kind": rep.coll_by_kind,
            "t_compute": rep.t_compute,
            "t_memory": rep.t_memory,
            "t_collective": rep.t_collective,
            "bottleneck": rep.bottleneck,
            "model_flops": rep.model_flops,
            "useful_ratio": rep.hlo_useful_ratio,
            "roofline_fraction": rep.roofline_fraction,
        },
    }
    if verbose:
        print(f"  memory: args="
              f"{record['memory']['argument_bytes'] / 2**30:.2f}GiB "
              f"temp={record['memory']['temp_bytes'] / 2**30:.2f}GiB "
              f"per device")
        print(f"  op_cost: flops/dev={rep.flops_per_device:.3e} "
              f"bytes/dev={rep.bytes_per_device:.3e} "
              f"coll/dev={rep.collective_bytes_per_device:.3e}")
        print("  " + rep.row())
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 (512-chip) mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--kv-int8", action="store_true",
                    help="quantized int8 decode KV cache (perf variant)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.perf_counter()
    records = []
    failures = 0
    traces: Dict = {}
    print(HEADER)
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                print(f"== {tag}", flush=True)
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp,
                                     kv_int8=args.kv_int8, traces=traces)
                except Exception as e:  # a failure here is a port bug
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "FAILED", "error": repr(e)}
                    failures += 1
                if rec.get("status") == "skipped":
                    print(f"  skipped: {rec['reason']}")
                records.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    print(f"{len(records)} cells, {failures} failures in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
