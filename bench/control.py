"""The readings a cell's correctness limits are set from, beside the
program's own (which the cell's runs print):

    python3 bench/control.py --workload <cell> --seeds 11,12,13

For each seed, in one process and at the cell's own sizes:

* the control: the plain reference put in the program's place, computed
  a step below the precision the configuration states (TF32 products for
  a float32 network, float8 e4m3 products for a bfloat16 model;
  ``bench/reference/precision.py``), read by the cell's check exactly as
  the program is;
* each fault the cell can have, planted in the reference put in the
  program's place: a network's answer altered where it is produced (two
  images' outputs swapped); a training step that leaves its state
  unchanged, and one that leaves out half of the batch and takes the
  mean over the rest.

Each seed prints one JSON line.  Without a CUDA card it exits non-zero,
as ``run.py`` does.
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
from bench.reference import mamba2, resnet  # noqa: E402


def network(ctx, dev) -> dict:
    cfg = ctx.config()
    w = resnet.make_weights(cfg, ctx.seed, dev)
    image = resnet.make_images(cfg, ctx.seed, dev, 1)[0]
    last = resnet.layers(cfg)[-1]["name"]
    ref = resnet.forward(cfg, w, image, keep=(last,))[last]
    low = resnet.forward(cfg, w, image, "tf32", keep=(last,))[last]
    swapped = ref.clone()
    swapped[[0, 1]] = ref[[1, 0]]
    return {"control": {"out_rel_err": resnet.rel_error(low, ref)},
            "faults": {"answer_altered": {
                "out_rel_err": resnet.rel_error(swapped, ref)}}}


def train(ctx, dev) -> dict:
    from bench.drivers import _lm
    drv = cells.driver("train", ctx.root)
    cfg, tr = ctx.config(), ctx.cell.traffic
    dtype = _lm.DTYPES[cfg["dtype"]]
    pool = drv.batch_pool(cfg, tr, ctx.seed, dev)
    batches = [drv.batch(pool[k]) for k in range(int(tr["checked_steps"]))]
    hp, micro = dict(cfg["optimizer"]), int(tr["reference_rows"])
    w0 = mamba2.make_weights(cfg, ctx.seed, dev, dtype)
    want = mamba2.train_readings(cfg, w0, batches, hp, micro=micro)
    low = mamba2.train_readings(cfg, w0, batches, hp, "fp8", micro=micro)
    half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    halved = mamba2.train_readings(cfg, w0, half, hp, micro=micro)
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


READERS = {"network": network, "train": train}


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
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = runner.Context(cell=cell, seed=seed, seconds=seconds,
                             trace=False, t_start=time.monotonic(),
                             device=device, overrides=overrides)
        t0 = time.monotonic()
        reading = READERS[cell.driver](ctx, dev)
        reading.update(seed=seed, seconds=time.monotonic() - t0)
        print(json.dumps(reading), flush=True)
        out.append(reading)
    return out


if __name__ == "__main__":
    main()
