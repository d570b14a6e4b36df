#!/usr/bin/env python3
"""Read the device phases of a benchmark cell's program step with the
port's marks (``src/repro_torch/obs/device.py``), on the card:

    python3 tools/trace_phases.py --workload <cell> --seed <n> \\
        --seconds <s> [--tracer 0|1] [--phase-calls 5]

The run is the cell's own: ``bench/harness/runner.py``'s context and the
cell's driver, traced, with the program's tracer installed before the
set-up under ``--tracer 1`` so that the captured train step holds its
marks.  When the driver's traced part ends, the program object it last
called there (``CompiledTraining.step`` or ``FusedNetwork``) makes
``--phase-calls`` more calls on that call's inputs, each read with
``phase_ms`` and timed by two events outside the program, behind a ~10 ms
spin of the card so that the host's issue is queued ahead of it.
``--tracer 0`` runs the same with no tracer, for the tracer's cost (no
phases then).

Prints one JSON line, also written under ``chiprun_out/``: the card's
name and power limit, the window's rate and its device ms a step
(``bench/harness/device.py`` ``Inflight``), each extra call's phases and
outer ms, the capture's seconds as the ``capture_s`` metrics read them,
the traced part's idle gaps, each named by the innermost host event
around it, and the check's numbers.  Nothing is compared.  Needs a card.

It lasts until the drivers read ``phase_ms`` in their traced branch
themselves (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the card's spin before an extra call, cycles (~10 ms at 1.98 GHz)
SPIN_CYCLES = 20_000_000
#: the capture the ``capture_s`` metric of each driver reads
OWNERS = {"train": "train", "network": "net.boundary"}


@contextlib.contextmanager
def _wrapped(obj, name, wrap):
    old = getattr(obj, name)
    setattr(obj, name, wrap(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _outer_ms(call):
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def run_cell(ctx, phase_calls: int):
    """(the driver's records, each extra call's phases and outer ms, the
    window's device ms a step)."""
    from bench.harness import cells, profile
    from bench.harness import device as hd
    from repro_torch.launch.steps import CompiledTraining
    from repro_torch.lower.fuse import FusedNetwork
    got = {"calls": [], "window_ms": []}

    def keep_last(old):
        def call(self, *a, **k):
            got["last"] = (self, functools.partial(old, self, *a, **k))
            return old(self, *a, **k)
        return call

    def then_phases(old):
        def traced(fn, cards=(0,)):
            with _wrapped(CompiledTraining, "step", keep_last), \
                    _wrapped(FusedNetwork, "__call__", keep_last):
                out = old(fn, cards)
            obj, call = got.pop("last")
            for _ in range(phase_calls):
                ms = _outer_ms(call)
                got["calls"].append({"outer_ms": ms,
                                     "phases": obj.phase_ms()})
            return out
        return traced

    def keep_ms(old):
        def step_ms(self):
            got["window_ms"] = ms = old(self)
            return ms
        return step_ms

    with _wrapped(profile, "traced", then_phases), \
            _wrapped(hd.Inflight, "step_ms", keep_ms):
        rec = cells.driver(ctx.cell.driver, ctx.root).run(ctx)
    return rec, got["calls"], got["window_ms"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--phase-calls", type=int, default=5)
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import cells, program, runner
    os.environ.update(runner.cache_env(ROOT))   # the benchmark's builds
    import torch
    if not torch.cuda.is_available():
        print("trace_phases.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.obs import trace
    tracer = trace.enable() if args.tracer else None
    ctx = runner.Context(cell=cells.load_cell(args.workload),
                         seed=args.seed, seconds=args.seconds, trace=True,
                         t_start=t_start)
    rec, calls, window_ms = run_cell(ctx, args.phase_calls)
    phases = [c["phases"] for c in calls if c["phases"]]
    owner = OWNERS[ctx.cell.driver]
    out = {"workload": ctx.cell.name, "seed": args.seed,
           "tracer": args.tracer, "card": runner.card_power(),
           "torch": torch.__version__, "e2e": rec["e2e"],
           "setup_s": rec["setup_s"],
           "window_step_ms_median": statistics.median(window_ms)
           if window_ms else None,
           "phase_ms_median": {k: statistics.median(p[k] for p in phases)
                               for k in phases[0]} if phases else {},
           "calls": calls,
           "capture_s": program.capture_seconds(owner),
           "capture_spans_s": {
               n: [e["dur"] for e in tracer.find(n)]
               for n in ("graph.warmup", "graph.capture")}
           if tracer else None,
           "idle_gaps": rec["trace"]["idle_gaps"],
           "idle_share": 1 - rec["trace"]["busy_s"]
           / rec["trace"]["window_s"],
           "checks": {c["name"]: c["value"] for c in rec["checks"]},
           "memory_peak_bytes": rec["memory_peak_bytes"],
           "seconds": time.monotonic() - t_start}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with open(ROOT / "chiprun_out" / f"trace_phases.{ctx.cell.name}."
              f"{args.tracer}.{args.seed}.json", "w") as f:
        json.dump(dict(out, window_ms=window_ms), f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
