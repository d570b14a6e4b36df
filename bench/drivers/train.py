"""Driver of the captured training step (``launch/steps.py``
``CompiledTraining``) on one card.

Set-up: the program's model holds the benchmark's weights (drawn from the
seed on the card, ``bench/reference/mamba2.py``); the program's AdamW
(``optim/optimizers.py``) with the configuration's hyper-parameters; a
pool of token batches drawn from the seed on the card.  The step's first
call is its warm-up and capture; it runs on a batch of its own, and the
weights and AdamW's state (zeros, as its ``init`` makes them) are then
written back in place, so that every checked step is a replay of the
graph the window replays.  That one step object then runs the first
``checked_steps`` steps, on batches whose rows all differ.  Their losses
and gradient norms, each leaf's norm of the first gradient as AdamW holds
it (its first moment over 1 - b1) and each leaf's change after them are
read for the check; reading them is not counted in ``setup_s``.

Window: the same object's steps on the next batches of the pool, each
copied into the graph's batch buffers, at most ``inflight`` steps queued
ahead of the card.  Tokens per second are every step's tokens over the
whole window.

Check: the float32 reference follows the same first steps from the same
weights on the same batches (``train_readings``), after the window with
the program's memory freed.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from bench.drivers import _lm
from bench.harness import counts
from bench.harness import device as hd
from bench.harness import profile
from bench.reference import mamba2 as ref


def batch_pool(cfg, tr, seed: int, dev: torch.device):
    """[pool, batch, seq + 1] token rows; a batch's inputs are a row's
    first ``seq`` tokens, its targets the last ``seq``."""
    vocab = min(int(tr["vocab_limit"]), int(cfg["vocab_size"]))
    return _lm.tokens(seed, dev, (int(tr["pool"]), int(tr["batch"]),
                                  int(tr["seq"]) + 1), vocab, salt=1)


def batch(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"inputs": rows[:, :-1], "targets": rows[:, 1:]}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def program_step(cfg, weights, dev, tr):
    """The program's model, optimizer, state and captured step."""
    from repro_torch.launch.steps import CompiledTraining
    from repro_torch.models.api import build_model, train_params
    from repro_torch.optim.optimizers import make_optimizer
    dtype = _lm.DTYPES[cfg["dtype"]]
    api = build_model(_lm.model_config(cfg), device=dev, dtype=dtype,
                      trainable=True)
    params = train_params(_lm.port_model(cfg, weights))
    _lm.check_shapes(cfg, api, params)
    hp = {k: v for k, v in cfg["optimizer"].items() if k != "name"}
    opt = make_optimizer(cfg["optimizer"]["name"], **hp)
    state = opt.init(dict(params.named_parameters()))
    if any(bool(t.any()) for t in _leaves(state)):
        raise ValueError("the optimizer's initial state is not all zeros: "
                         "the driver's restore would not give it back")
    like = {"inputs": torch.empty((int(tr["batch"]), int(tr["seq"])),
                                  dtype=torch.int32, device="meta"),
            "targets": torch.empty((int(tr["batch"]), int(tr["seq"])),
                                   dtype=torch.int32, device="meta")}
    step = CompiledTraining(api, params, state, opt, like)
    return api, params, opt, state, step


def restore(cfg, params, state, weights) -> None:
    """Write the seed's weights back into the program's parameters and
    zero AdamW's state, in place: the graph holds their addresses."""
    named = dict(params.named_parameters())
    with torch.no_grad():
        for one, st, i in ref.leaf_names(cfg):
            named[one].copy_(ref.layer_leaf(weights, st, i))
        for t in _leaves(state):
            t.zero_()


def run(ctx) -> Dict:
    from repro_torch.kernels import backend
    cfg, tr = ctx.config(), ctx.cell.traffic
    dev = torch.device(ctx.device, 0) if ctx.device == "cuda" \
        else torch.device(ctx.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend.library(backend.MODEL_SOURCE)    # built once a checkout
    clock = hd.Clock()
    dtype = _lm.DTYPES[cfg["dtype"]]
    ctx.phase("kernels loaded")
    weights = ref.make_weights(cfg, ctx.seed, dev, dtype)
    api, params, opt, state, step = program_step(cfg, weights, dev, tr)
    pool = batch_pool(cfg, tr, ctx.seed, dev)
    ctx.phase("weights, model and optimizer state")
    checked = int(tr["checked_steps"])
    capture_at = pool.shape[0] - 1          # no checked step's batch
    if capture_at < checked:
        raise ValueError(f"a pool of {pool.shape[0]} batches leaves none "
                         f"apart from the {checked} checked ones")
    step.step(batch(pool[capture_at]))
    restore(cfg, params, state, weights)
    del weights
    ctx.phase("captured, weights and optimizer state written back")
    b1 = float(cfg["optimizer"]["b1"])
    losses, gnorms, first = [], [], None
    for k in range(checked):
        m = step.step(batch(pool[k]))
        with clock:
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if k == 0:
                first = {n: float(state["m"][n].norm()) / (1 - b1)
                         for n in state["m"]}
    ctx.phase("checked steps, replays")
    with clock:
        w0 = ref.make_weights(cfg, ctx.seed, dev, dtype)
        named = dict(params.named_parameters())
        with torch.no_grad():
            change = {one: float((named[one].float()
                                  - ref.layer_leaf(w0, st, i).float()).norm())
                      for one, st, i in ref.leaf_names(cfg)}
        del w0
        hd.free(dev)
    hd.sync(dev)

    # ---- the window --------------------------------------------------------
    setup_s = time.monotonic() - ctx.t_start - clock.excluded
    q = hd.Inflight(dev, int(tr["inflight"]))
    q.start()
    n, k = 0, checked
    t0 = time.perf_counter()
    while True:
        step.step(batch(pool[k % pool.shape[0]]))
        n, k = n + 1, k + 1
        q.step()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    hd.sync(dev)
    window_s = time.perf_counter() - t0
    ms = q.step_ms()
    ctx.say(f"[window] device ms a step: {hd.describe(ms)}; each: "
            f"{[round(x, 2) for x in ms]}")
    tokens = n * int(tr["batch"]) * int(tr["seq"])
    rec = {"setup_s": setup_s, "attempted": n, "failed": 0,
           "e2e": {"train_tokens_per_s": tokens / window_s},
           "train": {"steps": n, "window_s": window_s, "chips": 1,
                     "flops_per_step": counts.train_step_flops(
                         cfg, int(tr["batch"]), int(tr["seq"])),
                     "peak_flops_s": counts.peaks()["bf16_flops_s"]}}
    if not all(v == v for v in losses):
        rec["failed"] = n
    if ctx.trace and dev.type == "cuda":
        traced_steps = int(tr["traced"])

        def traced():
            for j in range(traced_steps):
                with torch.profiler.record_function("train_step"):
                    step.step(batch(pool[(k + j) % pool.shape[0]]))
        rec["trace"] = profile.summary(profile.traced(traced, (dev.index,)))
        rec["trace"]["steps"] = traced_steps
    rec["memory_peak_bytes"] = hd.peak_bytes([dev])

    # ---- the check ---------------------------------------------------------
    del step, state, params, opt, api
    hd.free(dev)
    w0 = ref.make_weights(cfg, ctx.seed, dev, dtype)
    hp = dict(cfg["optimizer"])
    want = ref.train_readings(cfg, w0, [batch(pool[k])
                                        for k in range(checked)], hp,
                              micro=int(tr["reference_rows"]))
    rec["checks"] = compare(ctx, losses, gnorms, first, change, want)
    return rec


def compare(ctx, losses, gnorms, first, change, want):
    """The training check's numbers beside the cell's limits."""
    got = {"losses": losses, "grad_norms": gnorms, "first_grad": first,
           "change": change}
    numbers = ref.train_numbers(got, want)
    worst_first, first_at = ref.worst(ref.norm_gaps(first,
                                                    want["first_grad"]))
    changes = ref.norm_gaps(change, want["change"],
                            ref.still_leaves(want["first_grad"]))
    worst_change, change_at = ref.worst(changes)
    steps = ref.step_gaps(got, want)
    ctx.say(f"[train] losses {losses} (reference {want['losses']}); grad "
            f"norms {gnorms} (reference {want['grad_norms']}); gaps a step:"
            f" loss {steps['losses']}, grad norm {steps['grad_norms']}; "
            f"first gradient: worst leaf {first_at} {worst_first!r}; "
            f"change: worst leaf {change_at} "
            f"{worst_change!r} (bf16 storage rounds an update below a "
            f"weight's ulp); {len(want['change']) - len(changes)} leaves "
            f"left out of the change")
    # a number the cell's limits do not name is read, not compared
    # (PERF.md section 2: no control or fault separates it)
    for k, v in numbers.items():
        if k not in ctx.cell.limits:
            ctx.say(f"[reading] {k} {v!r} (not compared)")
    return [{"name": k, "value": v, "limit": ctx.cell.limits[k]}
            for k, v in numbers.items() if k in ctx.cell.limits]

