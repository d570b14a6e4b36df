"""Driver of the captured training step (``launch/steps.py``
``CompiledTraining``) of the published Zamba2 (``models/zamba2.py``) on
one card: ``train.py``'s set-up, window and check with the Zamba2
reference (``bench/reference/zamba2.py``) in the Mamba2 one's place.

Set-up: the program's model holds the benchmark's weights (drawn from the
seed on the card); the program's AdamW with the configuration's
hyper-parameters; a pool of token batches drawn from the seed on the card.
The step's first call, its warm-up and capture, runs on the pool's last
batch; the weights and AdamW's state are then written back in place, and
the first ``checked_steps`` replays are read for the check.  Under
``--trace 1`` the program's tracer is installed before set-up, so the
captured graph holds the step's and the hybrid sites' marks; after the
profiled steps, ``traced`` more steps read the sites' device ms
(``zamba2.site_ms``).

Window and check: as ``train.py``'s.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from bench.drivers import _lm, train
from bench.harness import counts_zamba2 as counts
from bench.harness import device as hd
from bench.harness import profile
from bench.reference import zamba2 as ref

MAMBA = _lm.MAMBA
#: the shared blocks' and the sites' leaves (``bench/reference/zamba2.py``)
SHARED = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_gate_up", "w_down")}
SITE = ("adapter_a", "adapter_b", "linear")
#: the most weights a token a CPU run takes: tests' small sizes, never the
#: configuration's own 2.7 B
CPU_PARAMS = 1e8


def model_config(cfg):
    """The program's ``Zamba2Config`` of the configuration file."""
    from repro_torch.models import zamba2
    return zamba2.config(cfg, name=cfg["name"])


def port_model(cfg, w: Dict[str, torch.Tensor]):
    """The program's model holding copies of the stacked weights ``w``; its
    parameter names are the reference's own leaf names (checked)."""
    from repro_torch.models.api import Block
    from repro_torch.models.zamba2 import Zamba2Model
    k = ref.dims(cfg)

    def one(name, i):
        return w[name][i].clone()
    blocks = [Block({"ln": one("blocks.ln", i),
                     "mamba": {m: one(f"blocks.mamba.{m}", i)
                               for m in MAMBA}})
              for i in range(k["L"])]
    shared = [Block({"ln1": one("shared.ln1", s), "ln2": one("shared.ln2", s),
                     **{g: {n: one(f"shared.{g}.{n}", s) for n in names}
                        for g, names in SHARED.items()}})
              for s in range(k["blocks"])]
    sites = [Block({n: one(f"sites.{n}", j) for n in SITE})
             for j in range(k["sites"])]
    model = Zamba2Model(w["embed"].clone(), w["final_norm"].clone(),
                        w["lm_head"].clone(), blocks, shared, sites)
    want = {one_name for one_name, _, _ in ref.leaf_names(cfg)}
    got = {n for n, _ in model.named_parameters()}
    if got != want:
        raise ValueError(f"the program's leaves differ from the reference's:"
                         f" {sorted(got ^ want)[:8]}")
    return model


def program_step(cfg, weights, dev, tr):
    """The program's model, optimizer, state and captured step."""
    from repro_torch.launch.steps import CompiledTraining
    from repro_torch.models.api import build_model, train_params
    from repro_torch.optim.optimizers import make_optimizer
    api = build_model(model_config(cfg), device=dev,
                      dtype=_lm.DTYPES[cfg["dtype"]], trainable=True)
    params = train_params(port_model(cfg, weights))
    _lm.check_shapes(cfg, api, params)
    hp = {k: v for k, v in cfg["optimizer"].items() if k != "name"}
    opt = make_optimizer(cfg["optimizer"]["name"], **hp)
    state = opt.init(dict(params.named_parameters()))
    if any(bool(t.any()) for t in train._leaves(state)):
        raise ValueError("the optimizer's initial state is not all zeros: "
                         "the driver's restore would not give it back")
    like = {k: torch.empty((int(tr["batch"]), int(tr["seq"])),
                           dtype=torch.int32, device="meta")
            for k in ("inputs", "targets")}
    step = CompiledTraining(api, params, state, opt, like)
    return api, params, opt, state, step


def restore(cfg, params, state, weights) -> None:
    """``train.restore`` of this model's leaves."""
    named = dict(params.named_parameters())
    with torch.no_grad():
        for one, st, i in ref.leaf_names(cfg):
            named[one].copy_(ref.layer_leaf(weights, st, i))
        for t in train._leaves(state):
            t.zero_()


def run(ctx) -> Dict:
    from repro_torch.kernels import backend
    from repro_torch.models import zamba2 as prog
    from repro_torch.obs import trace
    cfg, tr = ctx.config(), ctx.cell.traffic
    dev = torch.device(ctx.device, 0) if ctx.device == "cuda" \
        else torch.device(ctx.device)
    if dev.type == "cpu" and counts.matmul_params(cfg) > CPU_PARAMS:
        raise ValueError(f"{cfg['name']}: {counts.matmul_params(cfg):.3g} "
                         "weights a token; a CPU run takes a small size "
                         "(the configuration's keys overridden)")
    if ctx.trace:                    # before the capture: it holds the marks
        trace.enable()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend.library(backend.MODEL_SOURCE)    # built once a checkout
    clock = hd.Clock()
    dtype = _lm.DTYPES[cfg["dtype"]]
    ctx.phase("kernels loaded")
    weights = ref.make_weights(cfg, ctx.seed, dev, dtype)
    api, params, opt, state, step = program_step(cfg, weights, dev, tr)
    pool = train.batch_pool(cfg, tr, ctx.seed, dev)
    ctx.phase("weights, model and optimizer state")
    checked = int(tr["checked_steps"])
    capture_at = pool.shape[0] - 1          # no checked step's batch
    if capture_at < checked:
        raise ValueError(f"a pool of {pool.shape[0]} batches leaves none "
                         f"apart from the {checked} checked ones")
    batch = train.batch
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
    B, S = int(tr["batch"]), int(tr["seq"])
    rec = {"setup_s": setup_s, "attempted": n, "failed": 0,
           "e2e": {"train_tokens_per_s": n * B * S / window_s},
           "train": {"steps": n, "window_s": window_s, "chips": 1,
                     "flops_per_step": counts.train_step_flops(cfg, B, S),
                     "peak_flops_s": counts.peaks()["bf16_flops_s"]}}
    if not all(v == v for v in losses):
        rec["failed"] = n
    if ctx.trace and dev.type == "cuda":
        traced_steps = int(tr["traced"])

        def traced():
            for j in range(traced_steps):
                with torch.profiler.record_function("train_step"):
                    step.step(batch(pool[(k + j) % pool.shape[0]]))
        t = profile.traced(traced, (dev.index,))
        rec["trace"] = profile.summary(t)
        rec["trace"]["steps"] = traced_steps
        rec["trace"]["flash_wgmma_s"] = sum(
            s for name, s in t.seconds_by_name().items()
            if "flash_wgmma_kernel" in name)
        rec["bounds"] = {"flash_calls_per_step": len(ref.sites(cfg)),
                         "flash_s": counts.flash_bound_s(cfg, B, S)}
        shared = []
        for j in range(traced_steps):
            step.step(batch(pool[(k + traced_steps + j) % pool.shape[0]]))
            shared.append(prog.site_ms(api.marks.phase_ms()))
        rec["marks"] = {"shared_ms": statistics.median(shared)}
        ctx.say(f"[trace] hybrid sites' device ms a step: {shared}; "
                f"phases {step.phase_ms()}")
    rec["memory_peak_bytes"] = hd.peak_bytes([dev])

    # ---- the check ---------------------------------------------------------
    del step, state, params, opt, api
    hd.free(dev)
    w0 = ref.make_weights(cfg, ctx.seed, dev, dtype)
    want = ref.train_readings(cfg, w0, [batch(pool[k])
                                        for k in range(checked)],
                              dict(cfg["optimizer"]),
                              micro=int(tr["reference_rows"]))
    rec["checks"] = train.compare(ctx, losses, gnorms, first, change, want)
    return rec
