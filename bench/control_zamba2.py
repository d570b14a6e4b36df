"""The readings the published Zamba2 cell's correctness limits are set
from, beside the program's own (which the cell's runs print):

    python3 bench/control_zamba2.py --workload zamba2-7b.train.1x4096 \
        --seeds 11,12,13

``control.py``'s contract for this configuration: for each seed, in one
process and at the cell's own sizes, the control (the plain reference of
``bench/reference/zamba2.py`` put in the program's place, its products in
float8 e4m3, a step below the configuration's bfloat16) and the faults of
a training step (the state left unchanged; half of the batch left out and
the mean taken over the rest), each read by the cell's check exactly as
the program is.  A batch of one sequence is halved along the sequence:
its first half of the tokens.  Each seed prints one JSON line.  Without a
CUDA card it exits non-zero.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import cells, runner  # noqa: E402
from bench.reference import mamba2, zamba2  # noqa: E402


def _half(batch):
    """Half of a batch: half its rows, or of one row half its tokens."""
    rows = batch["inputs"].shape[0]
    if rows > 1:
        return {k: v[:rows // 2] for k, v in batch.items()}
    cols = batch["inputs"].shape[1]
    return {k: v[:, :cols // 2] for k, v in batch.items()}


def readings(ctx, dev) -> dict:
    from bench.drivers import _lm
    drv = cells.driver("train_zamba2", ctx.root)
    cfg, tr = ctx.config(), ctx.cell.traffic
    pool = drv.train.batch_pool(cfg, tr, ctx.seed, dev)
    batches = [drv.train.batch(pool[k])
               for k in range(int(tr["checked_steps"]))]
    hp, micro = dict(cfg["optimizer"]), int(tr["reference_rows"])
    w0 = zamba2.make_weights(cfg, ctx.seed, dev, _lm.DTYPES[cfg["dtype"]])
    want = zamba2.train_readings(cfg, w0, batches, hp, micro=micro)
    low = zamba2.train_readings(cfg, w0, batches, hp, "fp8", micro=micro)
    halved = zamba2.train_readings(cfg, w0, [_half(b) for b in batches], hp,
                                   micro=micro)
    still = dict(want, change={n: 0.0 for n in want["change"]})
    return {"control": mamba2.train_numbers(low, want),
            "faults": {"half_batch": mamba2.train_numbers(halved, want),
                       "state_unchanged": mamba2.train_numbers(still, want)},
            "steps": {"control": mamba2.step_gaps(low, want),
                      "half_batch": mamba2.step_gaps(halved, want)},
            "worst_first_grad": {
                "control": mamba2.worst(mamba2.norm_gaps(
                    low["first_grad"], want["first_grad"])),
                "half_batch": mamba2.worst(mamba2.norm_gaps(
                    halved["first_grad"], want["first_grad"]))}}


def main(argv=None, require_device: bool = True, device: str = "cuda",
         overrides=None, seconds: float = 1.0, benchmark=None) -> list:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one reading each")
    args = ap.parse_args(argv)
    root = cells.ROOT
    for k, v in runner.cache_env(root).items():
        os.environ[k] = v
    sys.path.insert(0, str(root / "src"))
    if require_device and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        raise SystemExit(3)
    cell = cells.load_cell(args.workload, root, benchmark)
    if cell.driver != "train_zamba2":
        raise SystemExit(f"control_zamba2: {cell.name} runs {cell.driver}; "
                         "bench/control.py reads it")
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = runner.Context(cell=cell, seed=seed, seconds=seconds,
                             trace=False, t_start=time.monotonic(),
                             device=device, overrides=overrides)
        t0 = time.monotonic()
        reading = readings(ctx, dev)
        reading.update(seed=seed, seconds=time.monotonic() - t0)
        print(json.dumps(reading), flush=True)
        out.append(reading)
    return out


if __name__ == "__main__":
    main()
