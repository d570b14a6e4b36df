"""``examples/train_tiny_lm.py`` on the port: a
reduced Qwen2.5-family model trained for a few hundred steps with
checkpoints every 50 steps, a node failure injected at mid-run and the
automatic recovery, through ``launch/train.py`` ``train`` (on the card its
step is one CUDA graph, ``launch/steps.py`` ``CompiledTraining``).

    python -m repro_torch.train_tiny_lm [--steps 200] [--arch qwen2.5-3b]
    python -m repro_torch.train_tiny_lm --device cpu     # plain versions

Prints the first and last loss and the failures recovered from.
"""
from __future__ import annotations

import argparse
import tempfile

from .launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        losses, stats = train(
            args.arch, steps=args.steps, batch=8, seq=128, tiny=True,
            ckpt_dir=ckpt_dir, ckpt_every=50,
            fail_at=args.steps // 2,       # inject a node failure mid-run
            log_every=20, device=args.device)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"recovered from {stats.restarts} injected failure(s)")
    return losses, stats


if __name__ == "__main__":
    main()
