"""One run of one cell: the driver's set-up, window and check, and the
result line.

The driver named by the cell's traffic mix (``bench/drivers/<name>.py``)
gets a ``Context`` and returns its records: the set-up seconds, the
window's end-to-end numbers, what was attempted and failed, the numbers
compared with the cell's limits, the card's peak memory and, in a traced
run, the trace's summary and whatever its per-layer metrics read.  This
module turns them into the result line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

from . import cells

#: top-level modules the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    cell: cells.Cell
    seed: int
    seconds: float
    trace: bool
    #: ``time.monotonic()`` when the process started
    t_start: float
    device: str = "cuda"
    root: Path = cells.ROOT
    #: keys of the configuration replaced for this run (tests only)
    overrides: Optional[Dict[str, Any]] = None
    log: Any = sys.stderr

    def config(self) -> Dict:
        cfg = dict(self.cell.config)
        cfg.update(self.overrides or {})
        return cfg

    def say(self, msg: str) -> None:
        print(msg, file=self.log, flush=True)

    def phase(self, name: str) -> None:
        """Log the seconds since the process started at the end of a
        set-up phase."""
        self.say(f"[setup] {name} at {time.monotonic() - self.t_start:.2f} s")


def cache_env(root: Path) -> Dict[str, str]:
    """The program's build and kernel caches, at fixed paths inside the
    checkout: only a checkout's first run builds."""
    base = root / ".bench_cache"
    return {"REPRO_TORCH_BUILD_DIR": str(base / "build"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "CUDA_CACHE_PATH": str(base / "cuda"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def result_line(ctx: Context, rec: Mapping, device: Mapping) -> Dict:
    """The result's JSON object; ``checks`` last."""
    checks = rec["checks"]
    correct = bool(checks) and rec["failed"] == 0 and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks)
    if ctx.trace:
        metrics = cells.read_metrics(ctx.cell, rec, ctx.root)
    else:
        metrics = {"setup_s": {"value": rec["setup_s"], "unit": "s"}}
        for m in ctx.cell.end_to_end:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": rec["e2e"][m["name"]],
                                      "unit": m["unit"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if ctx.trace and rec.get("trace"):
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def run(ctx: Context) -> int:
    """Set up, measure and check one cell; print the result line last on
    standard output.  Returns the exit code."""
    import torch
    drv = cells.driver(ctx.cell.driver, ctx.root)
    if ctx.device != "cpu":
        ctx.say(f"[bench] {ctx.cell.name} seed {ctx.seed} on "
                f"{card_power()}; torch {torch.__version__} "
                f"cuda {torch.version.cuda}")
    rec = drv.run(ctx)
    bad = forbidden_modules()
    if bad:
        ctx.say(f"[bench] the run loaded {bad}: no result")
        return 4
    device = {"platform": "gpu" if ctx.device != "cpu" else "cpu",
              "kind": torch.cuda.get_device_name(0)
              if ctx.device != "cpu" else "cpu",
              "count": ctx.cell.chips,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if ctx.trace and rec.get("trace"):
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    line = result_line(ctx, rec, device)
    for name, c in line["checks"].items():
        ctx.say(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None, require_device: bool = True, device: str = "cuda",
         overrides: Optional[Dict[str, Any]] = None,
         root: Path = cells.ROOT, benchmark: Optional[Mapping] = None,
         t_start: Optional[float] = None) -> int:
    """``run.py``'s command line.  ``require_device``, ``device``,
    ``overrides`` and ``benchmark`` are for tests, which drive a run on the
    CPU at a small size."""
    import argparse
    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in cache_env(root).items():
        os.environ[k] = v
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if not (root / "src" / "repro_torch").is_dir():
        print("bench: src/repro_torch is missing: this is not a checkout "
              "of the program", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload, root, benchmark)
    import torch
    if require_device:
        if not torch.cuda.is_available():
            print("bench: no CUDA device: no result", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"bench: {cell.name} needs {cell.chips} cards, this host "
                  f"has {torch.cuda.device_count()}: no result",
                  file=sys.stderr)
            return 3
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t_start=t_start, device=device,
                  root=root, overrides=overrides)
    return run(ctx)
