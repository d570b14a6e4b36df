"""The compiled train step on the card (``launch/steps.py``
``CompiledTraining``): one CUDA graph over static batch buffers, the
parameters and the optimizer state, whose first step is the capture's
warm-up call.  Tiny Zamba2-1.2B (hybrid: flash and SSD), Qwen2.5-3B
(dense), Qwen2-MoE-A2.7B (MoE) and Kimi-K2 (MoE, ``remat="block"``,
Adafactor over its layer stacks), in bf16 at head dim 64 (flash's
tensor-core path): the captured steps against the eager
``build_train_step`` on the same weights and batches, the launch counters
counting the kernels that ran, a restore between replays, ``train``
through a failure, and a failed capture raising.  The card's embedding
and MoE backwards add with atomics, so captured and eager agree within
limits, not bit for bit.  On the CPU the same class runs its body each
step (``tests/test_torch_train_models.py``).  The file imports no JAX, so
the card's machine runs it too."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels import backend, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.steps import (CompiledTraining, build_train_step,
                                      input_structs)
from repro_torch.launch.train import tiny_config, train
from repro_torch.models.api import build_model, layer_stacks
from repro_torch.optim.optimizers import make_optimizer

ARCHS = ["zamba2-1.2b", "qwen2.5-3b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
B, S, STEPS = 2, 64, 3
LOSS_TOL, PARAM_TOL = 1e-4, 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(arch, dev):
    """Tiny ``arch`` at head dim 64 in bf16: (cfg, api, params, optimizer,
    state), the weights from seed 0."""
    cfg = dataclasses.replace(tiny_config(get_config(arch)), head_dim=64)
    api = build_model(cfg, device=dev, trainable=True)
    params = api.init(0)
    opt = make_optimizer(cfg.optimizer, lr=1e-3,
                         stacks=layer_stacks(cfg, params))
    state = opt.init(dict(params.named_parameters()))
    return cfg, api, params, opt, state


def _batches(cfg, n=STEPS):
    shape = ShapeConfig("t", S, B, "train")
    return [synth_batch(cfg, shape, i, DataConfig(seed=0)) for i in range(n)]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _compiled(cfg, api, params, opt, state):
    return CompiledTraining(api, params, state, opt,
                            input_structs(cfg, ShapeConfig("t", S, B,
                                                           "train")))


def test_recording_launches_holds_the_capture_streams_tally():
    """While a graph is captured, its tally is found by the capture
    stream's handle too (autograd's device thread launches a captured
    backward there), and only until the capture ends."""
    with backend.recording_launches(12345) as tally:
        assert backend._stream_tallies == {12345: tally}
        with backend.recording_launches() as inner:
            assert backend._stream_tallies == {12345: tally}
        before = dict(fa.LAUNCHES)
        backend.count_launch(fa.LAUNCHES, "flash_attention")
        assert inner == {} and tally["flash_attention"] == 1
        assert fa.LAUNCHES == before
    assert backend._stream_tallies == {}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_train_steps_equal_the_eager_step(arch):
    dev = _card()
    cfg, api, params, opt, state = _setup(arch, dev)
    batches = _batches(cfg)
    step = build_train_step(api, opt)
    ops.reset_launch_counts()
    want = []
    for b in batches:
        m = step(params, state, {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()})[2]
        want.append(float(m["loss"]))
    torch.cuda.synchronize()
    eager = ops.launch_counts()
    want_params = {n: p.detach().float().clone()
                   for n, p in params.named_parameters()}
    del params, state, step

    cfg, api, params, opt, state = _setup(arch, dev)
    ptrs = {n: p.data_ptr() for n, p in params.named_parameters()}
    ctrain = _compiled(cfg, api, params, opt, state)
    ops.reset_launch_counts()
    got = [float(ctrain.step(b)["loss"]) for b in batches]
    torch.cuda.synchronize()
    assert ctrain.captured.graph is not None
    assert ctrain.capture_seconds > 0 and ctrain.pool_bytes > 0
    # the warm-up call was the first step: one update a step
    assert int(state["step"]) == STEPS
    # the warm-up step's launches and two replays' are three steps'
    assert ops.launch_counts() == eager
    assert {k: n * STEPS for k, n in ctrain.captured.launches.items()} \
        == {k: n for k, n in eager.items() if n}
    assert eager["flash_attention"] >= STEPS
    assert {n: p.data_ptr() for n, p in params.named_parameters()} == ptrs
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g) and _rel(g, w) <= LOSS_TOL, (i, g, w)
    for n, p in params.named_parameters():
        w = want_params[n]
        err = float((p.detach().float() - w).abs().max())
        assert err <= PARAM_TOL * float(w.abs().max()), (n, err)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_a_restore_between_replays_gives_the_restored_runs_losses(
        arch, tmp_path):
    """A checkpoint after the first step, two replays, a restore into the
    graph's own tensors and the same two replays again: the same losses,
    and the optimizer's step count back where the checkpoint had it."""
    dev = _card()
    cfg, api, params, opt, state = _setup(arch, dev)
    batches = _batches(cfg)
    ctrain = _compiled(cfg, api, params, opt, state)
    ctrain.step(batches[0])
    ckpt.save(str(tmp_path), 1, params, state)
    first = [float(ctrain.step(b)["loss"]) for b in batches[1:]]
    graph = ctrain.captured.graph
    p2, s2, manifest = ckpt.restore(str(tmp_path), params, state)
    assert p2 is params and manifest["step"] == 1
    assert s2["step"] is state["step"] and int(state["step"]) == 1
    again = [float(ctrain.step(b)["loss"]) for b in batches[1:]]
    assert ctrain.captured.graph is graph       # no second capture
    assert int(state["step"]) == STEPS
    for g, w in zip(again, first):
        assert np.isfinite(g) and _rel(g, w) <= LOSS_TOL, (again, first)


@pytest.mark.gpu
def test_train_recovers_through_the_graph(tmp_path):
    """``train`` on the card: a failure after a checkpoint, recovered
    once; the re-run steps replay the same graph on the restored state
    and give the first run's losses; one update a step."""
    _card()
    losses, stats = train("qwen2.5-3b", steps=8, batch=B, seq=S,
                          tiny=True, ckpt_dir=str(tmp_path), ckpt_every=4,
                          fail_at=6, device="cuda")
    assert stats.restarts == 1 and stats.updates == 8
    assert stats.capture_seconds > 0 and stats.pool_bytes > 0
    assert len(losses) == 10 and np.isfinite(losses).all()
    for g, w in zip(losses[6:8], losses[4:6]):     # steps 4-5 again
        assert _rel(g, w) <= LOSS_TOL, losses


@pytest.mark.gpu
def test_a_failed_capture_raises():
    """A step that reads a device value on the host cannot be captured:
    the first step raises, and nothing runs the step eagerly in its
    place."""
    dev = _card()
    cfg, api, params, opt, state = _setup("qwen2.5-3b", dev)
    loss_fn = api.loss_fn

    def host_read(p, batch):
        loss = loss_fn(p, batch)
        float(loss)                      # a host read inside the step
        return loss
    api.loss_fn = host_read
    ctrain = _compiled(cfg, api, params, opt, state)
    with pytest.raises(RuntimeError):
        ctrain.step(_batches(cfg, 1)[0])
    torch.cuda.synchronize()
    assert ctrain.captured is None
