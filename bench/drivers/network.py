"""Driver of a solved network on the fused tier.

Set-up: the configuration's layer graph is built with the program's
layer constructors (``repro_torch.workloads.layers``), solved by the
program's KAPLA solver for the configuration's accelerator template
(``repro_torch.hw.presets``), lowered (``lower_network``) and fused
(``lower/fuse.py`` ``fused_runner``); the weights and a pool of input
batches are drawn from the seed on the card (``bench/reference/resnet.py``);
the first call captures the network's CUDA graph and a few more replay
it.

Window: a closed loop of back-to-back fused replays, each on the next
batch of the pool (the program copies the inputs into its buffers), at
most ``inflight`` replays queued ahead of the card.  Images per second are
every replay's batch over the whole window.

Check: the network's output of replays drawn from the seed, and of the
last one, against the float32 reference on the same weights and batch,
run after the window with the program's memory freed.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from bench.harness import counts
from bench.harness import device as hd
from bench.harness import profile
from bench.reference import resnet as ref


def program_graph(cfg):
    """The configuration's layer graph as the program's ``LayerGraph``."""
    from repro_torch.workloads import layers as pl
    specs = []
    for l in ref.layers(cfg):
        if l["kind"] == "conv":
            specs.append(pl.conv(l["name"], l["N"], l["C"], l["K"], l["X"],
                                 l["Y"], l["R"], l["S"], stride=l["stride"],
                                 src=l["src"]))
        elif l["kind"] == "pool":
            specs.append(pl.pool(l["name"], l["N"], l["C"], l["X"], l["Y"],
                                 l["R"], l["S"], stride=l["stride"],
                                 src=l["src"]))
        elif l["kind"] == "eltwise":
            specs.append(pl.eltwise(l["name"], l["N"], l["C"], l["X"],
                                    l["Y"], src=l["src"]))
        else:
            specs.append(pl.fc(l["name"], l["N"], l["C"], l["K"],
                               src=l["src"]))
    return pl.LayerGraph(cfg["name"], specs)


def run(ctx) -> Dict:
    from repro_torch.core.solver import solve
    from repro_torch.hw import presets
    from repro_torch.kernels import backend
    from repro_torch.lower import clear_cache, fused_runner, lower_network

    cfg, tr = ctx.config(), ctx.cell.traffic
    dev = torch.device(ctx.device, 0) if ctx.device == "cuda" \
        else torch.device(ctx.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend.library(backend.SOURCE)          # built once a checkout
    ctx.phase("kernels loaded")
    graph = program_graph(cfg)
    hw = getattr(presets, cfg["hardware"])(**cfg.get("hardware_args", {}))
    nplan = lower_network(solve(graph, hw), graph, hw)
    if not nplan.executable:
        raise RuntimeError(f"{cfg['name']}: {nplan.invalid_layers()}")
    ctx.phase("solved and lowered")
    layers = ref.layers(cfg)
    first, last = layers[0]["name"], layers[-1]["name"]
    weights = ref.make_weights(cfg, ctx.seed, dev)
    images = ref.make_images(cfg, ctx.seed, dev, int(tr["pool"]))
    feeds = [dict(weights, **{f"{first}.I": images[i]})
             for i in range(images.shape[0])]
    ctx.phase("inputs drawn")
    net = fused_runner(nplan, device=dev)
    for i in range(int(tr["warmup"])):           # the capture, then replays
        net(feeds[i % len(feeds)], keep="boundary")
    hd.sync(dev)
    ctx.phase("captured and warmed")
    t0 = time.perf_counter()
    net(feeds[0], keep="boundary")
    hd.sync(dev)
    replay_s = time.perf_counter() - t0
    expected = max(1, int(ctx.seconds / max(replay_s, 1e-6)))
    samples = set(hd.sample(ctx.seed, expected, int(tr["samples"])))

    # ---- the window --------------------------------------------------------
    setup_s = time.monotonic() - ctx.t_start
    q = hd.Inflight(dev, int(tr["inflight"]))
    q.start()
    kept, n = {}, 0
    t0 = time.perf_counter()
    while True:
        out = net(feeds[n % len(feeds)], keep="boundary")
        if n in samples:
            kept[n] = out[last].clone()
        n += 1
        q.step()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    hd.sync(dev)
    window_s = time.perf_counter() - t0
    ctx.say(f"[window] device ms a replay: {hd.describe(q.step_ms())}")
    kept[n - 1] = out[last].clone()
    rec = {"setup_s": setup_s, "attempted": n, "failed": 0,
           "e2e": {"net_images_per_s": n * cfg["batch"] / window_s},
           "net": {"passes": n, "window_s": window_s,
                   "flops_per_pass": counts.network_flops(cfg)}}

    if ctx.trace and dev.type == "cuda":
        k = max(1, min(int(tr["traced"]), expected))

        def traced():
            for i in range(k):
                with torch.profiler.record_function("fused_replay"):
                    net(feeds[i % len(feeds)], keep="boundary")
        rec["trace"] = profile.summary(profile.traced(traced, (dev.index,)))
        rec["trace"]["passes"] = k
    rec["memory_peak_bytes"] = hd.peak_bytes([dev])

    # ---- the check ---------------------------------------------------------
    del net, out
    clear_cache()
    hd.free(dev)
    worst = 0.0
    for i, got in sorted(kept.items()):
        want = ref.forward(cfg, weights, images[i % len(feeds)],
                           keep=(last,))[last]
        worst = max(worst, ref.rel_error(got, want))
    rec["checks"] = [{"name": "out_rel_err", "value": worst,
                      "limit": ctx.cell.limits["out_rel_err"]}]
    p = counts.peaks()
    rec["bounds"] = {"conv_s": counts.conv_bound_s(
        cfg, p["tf32x3_flops_s"], p["hbm_bytes_s"]),
        "flops_s": p["tf32x3_flops_s"]}
    return rec
