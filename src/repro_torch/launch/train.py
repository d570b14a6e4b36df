"""End-to-end training loop.

The port of ``repro/launch/train.py``.  Runs on the card unless the caller
passes ``device="cpu"`` (where every kernel takes its plain version); at a
reduced config it trains on the CPU, at full width on one H100:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 20 --device cpu

The reference jits its train step and donates the parameters and the
optimizer state; here the step is ``CompiledTraining`` (``launch/steps.py``):
on the card one CUDA graph over static batch buffers, the parameters and
the optimizer state, captured at the first step the loop runs (that
step is the capture's warm-up call) and replayed at every later one; a
restore after a failure writes into the same tensors
(``checkpoint/ckpt.py``), so the graph goes on.  On the CPU the same step
body runs each time.

It keeps the reference's two quirks: the ``Prefetcher`` is started but its
batches are never read (each step draws its own ``synth_batch``), and
``--tiny`` cannot be turned off from the command line.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Union

import torch

from ..checkpoint import ckpt
from ..configs import ShapeConfig, get_config
from ..configs.base import ModelConfig
from ..data.pipeline import DataConfig, Prefetcher, synth_batch
from ..kernels import backend
from ..models.api import build_model, layer_stacks
from ..optim.optimizers import make_optimizer
from ..runtime.fault import (NodeFailure, RecoveryPolicy, RecoveryStats,
                             StepHeartbeat, run_with_recovery)
from ..runtime.straggler import StragglerDetector
from .steps import CompiledTraining, input_structs


def tiny_config(cfg: ModelConfig) -> ModelConfig:
    over = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=1024,
                head_dim=32)
    if cfg.num_heads:
        over.update(num_heads=4,
                    num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads
                    else 4)
    if cfg.family == "moe":
        over.update(num_experts=8, top_k=2, moe_d_ff=64,
                    num_shared_experts=min(1, cfg.num_shared_experts),
                    first_dense_layers=min(1, cfg.first_dense_layers))
    if cfg.family in ("ssm", "hybrid"):
        over.update(ssm_state=16, ssm_head_dim=32)
    if cfg.attn_every:
        over.update(attn_every=1)
    if cfg.local_window:
        over.update(local_window=32)
    return dataclasses.replace(cfg, **over)


@dataclasses.dataclass
class TrainStats(RecoveryStats):
    """``run_with_recovery``'s stats plus the host seconds of every step
    run, in order (a re-run step counts again), each ending when its loss
    reached the host (the first holds the capture), the capture's seconds
    and pool bytes (``CompiledTraining``; 0 on the CPU), and the
    optimizer's step count at the end: the updates the parameters hold."""
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    capture_seconds: float = 0.0
    pool_bytes: int = 0
    updates: int = 0


def train(arch: Union[str, ModelConfig], steps: int = 50, batch: int = 8,
          seq: int = 128,
          tiny: bool = True, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, resume: bool = False,
          fail_at: Optional[int] = None, log_every: int = 10,
          seed: int = 0, device=None,
          dtype: torch.dtype = torch.bfloat16):
    """Train ``arch`` (a registered name, or a ``ModelConfig`` such as one
    cut in depth) for ``steps`` steps on ``synth_batch`` batches; returns
    (the loss of every step run, ``TrainStats``)."""
    dev = backend.resolve_device(device)
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if tiny:
        cfg = tiny_config(cfg)
    shape = ShapeConfig(f"train_{seq}", seq, batch, "train")
    api = build_model(cfg, device=dev, dtype=dtype, trainable=True)
    params = api.init(seed)
    optimizer = make_optimizer(cfg.optimizer, lr=1e-3,
                               stacks=layer_stacks(cfg, params))
    opt_state = optimizer.init(dict(params.named_parameters()))
    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        params, opt_state, manifest = ckpt.restore(ckpt_dir, params,
                                                   opt_state)
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    compiled = CompiledTraining(api, params, opt_state, optimizer,
                                input_structs(cfg, shape))
    prefetch = Prefetcher(cfg, shape, DataConfig(seed=seed),
                          start_step=start_step)
    detector = StragglerDetector()
    heartbeat = StepHeartbeat(deadline_seconds=300.0)
    losses: List[float] = []
    step_seconds: List[float] = []

    state = {"failed_once": False}

    def restore_fn() -> int:
        if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
            # in place: the compiled step's own tensors take the values
            return ckpt.restore(ckpt_dir, params, opt_state)[2]["step"]
        return start_step

    def one_step(step: int):
        if fail_at is not None and step == fail_at \
                and not state["failed_once"]:
            state["failed_once"] = True        # one-shot injection
            raise NodeFailure(f"injected failure at step {step}")
        t0 = time.perf_counter()
        heartbeat.arm()
        batch_np = synth_batch(cfg, shape, step, DataConfig(seed=seed))
        metrics = compiled.step(batch_np)
        heartbeat.disarm()
        loss = float(metrics["loss"])
        losses.append(loss)
        step_seconds.append(time.perf_counter() - t0)
        detector.record("host0", time.perf_counter() - t0)
        if step % log_every == 0 or step == start_step:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, params, opt_state,
                      extra={"loss": loss})

    try:
        stats = run_with_recovery(one_step, start_step, steps - start_step,
                                  restore_fn,
                                  policy=RecoveryPolicy(backoff_seconds=0.01),
                                  sleep=lambda s: None)
    finally:
        prefetch.close()
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"(restarts={stats.restarts})")
    return losses, TrainStats(**dataclasses.asdict(stats),
                              step_seconds=step_seconds,
                              capture_seconds=compiled.capture_seconds,
                              pool_bytes=compiled.pool_bytes,
                              updates=int(opt_state["step"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          tiny=args.tiny, ckpt_dir=args.ckpt_dir, resume=args.resume,
          fail_at=args.fail_at, device=args.device)


if __name__ == "__main__":
    main()
