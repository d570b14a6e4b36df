"""Quickstart of the port: the steps of ``examples/quickstart.py`` on the card.

KAPLA schedules AlexNet b64 on the 16x16-node Eyeriss-like accelerator
through the schedule service (``LocalClient`` over a content-addressed
store; a repeated request is a store hit, not a re-solve), prints the
winning directives of ``conv2``, the energy and latency, and a comparison
with random search.  Then the batch-1 schedule's ``conv3`` plan is lowered
and run through the hand-written CUDA kernel, verified against the torch
oracle and measured; and the whole batch-1 schedule is lowered to a
``NetworkPlan``, verified on the per-layer tier and measured on both the
per-layer tier (host round-trips at segment boundaries) and the fused tier
(one CUDA graph, everything on the device).

    python -m repro_torch.quickstart                # on the card
    python -m repro_torch.quickstart --device cpu   # plain versions

Exits non-zero when a numerics check fails.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Dict, List, Optional

from .core.solver import random_search, solve
from .hw.presets import eyeriss_multinode
from .kernels.backend import resolve_device
from .lower import (compare_network, lower_scheme, make_inputs,
                    make_network_inputs, measure_network, measure_plan,
                    network_runner, verify_plan)
from .service import LocalClient, ScheduleStore
from .workloads.nets import get_net


def run(device=None, samples: int = 500) -> Dict:
    """Every step, printed; returns what a caller checks (energy and
    latency of the b64 schedule, the store's answer, the checks' errors
    and the measured seconds)."""
    dev = resolve_device(device)
    hw = eyeriss_multinode()
    net = get_net("alexnet", batch=64)
    print(f"scheduling {net.name}: {len(net)} layers on {hw.name} "
          f"({hw.total_pes} PEs)")

    # solves route through the schedule service: a content-addressed store
    # keeps every winner, so only the first request pays the solver
    with tempfile.TemporaryDirectory(prefix="repro-quickstart-store-") \
            as store_dir:
        client = LocalClient(ScheduleStore(store_dir))
        first = client.solve(net, hw)
        res = first.schedule
        energy_mj = res.total_energy_pj / 1e9
        latency_ms = res.total_latency_cycles / hw.freq_hz * 1e3
        print(f"\nKAPLA: energy {energy_mj:.2f} mJ, latency "
              f"{latency_ms:.2f} ms, solved in {res.solve_seconds:.2f} s")
        print(f"inter-layer chains kept: k_S={len(res.chain.segments)} "
              "segments")
        st = res.prune_stats
        print(f"pruning: {st.total} inter-layer candidates -> "
              f"{st.after_pareto} after validity+Pareto "
              f"({100 * (1 - st.after_pareto / st.total):.1f}% pruned)")

        print("\n--- directives for conv2 (row-stationary, node-parallel) ---")
        for d in res.layer_schemes["conv2"].to_directives(
                ["REGF", "GBUF", "DRAM"]):
            print(d)

        rnd = random_search.solve(net, hw, samples=samples)
        ratio = rnd.total_energy_pj / res.total_energy_pj
        print(f"\nrandom search: {ratio:.2f}x KAPLA energy")

        # the same request again: served from the store, not re-solved
        second = client.solve(get_net("alexnet", batch=64), hw)
        st = client.stats()
        print(f"\nschedule service: first solve source={first.source} "
              f"({first.seconds * 1e3:.0f} ms), second source="
              f"{second.source} ({second.seconds * 1e3:.1f} ms, "
              f"{first.seconds / second.seconds:.0f}x faster) | store "
              f"hits={st['hits']} misses={st['misses']}")
        if second.schedule.total_energy_pj != res.total_energy_pj:
            raise AssertionError("the store served another schedule")

    # lower the winning scheme for one layer and run it on the device
    edge_net = get_net("alexnet", batch=1)
    edge = solve(edge_net, hw)
    plan = lower_scheme(edge.layer_schemes["conv3"], hw)
    print(f"\n--- lowering conv3 (batch 1) to a kernel plan on {dev} ---")
    print(plan.describe())
    ok, err = verify_plan(plan, dev)
    print(f"numerics vs kernels/ref.py oracle: "
          f"{'OK' if ok else 'MISMATCH'} (max rel err {err:.1e})")
    measured = measure_plan(plan, make_inputs(plan, device=dev), dev,
                            iters=2)
    predicted = plan.predicted.latency_cycles / hw.freq_hz
    print(f"predicted latency {predicted * 1e3:.3f} ms "
          f"({plan.predicted.latency_cycles:.0f} cycles @ "
          f"{hw.freq_hz / 1e6:.0f} MHz) | measured on {dev} "
          f"{measured * 1e3:.3f} ms")

    # then lower and execute the whole network (the network tier)
    nplan = edge.lower(edge_net, hw)
    print(f"\n--- network tier: executing all of alexnet (batch 1) ---")
    print(nplan.describe())
    net_inputs = make_network_inputs(nplan, device=dev)
    per_layer = network_runner(nplan, net_inputs, dev)
    ver = compare_network(nplan, per_layer(), net_inputs)
    print(f"whole-graph numerics vs reference pass: "
          f"{'OK' if ver.ok else 'MISMATCH'} (worst layer "
          f"{ver.worst_layer}, max rel err {ver.max_rel_err:.1e}); "
          f"{ver.n_forwarded} tensors forwarded on-chip")
    net_measured = measure_network(nplan, iters=1, warmup=0,
                                   runner=per_layer)
    net_predicted = nplan.predicted_latency_cycles / hw.freq_hz
    print(f"network predicted {net_predicted * 1e3:.2f} ms | measured "
          f"(per-layer tier, host round-trips) {net_measured * 1e3:.2f} ms")
    # the fused tier: the whole plan replayed as one CUDA graph (the
    # default measured path; the per-layer tier above is the oracle)
    fused_measured = measure_network(nplan, net_inputs, dev, iters=1)
    print(f"fused tier: {fused_measured * 1e3:.2f} ms "
          f"({net_measured / fused_measured:.1f}x over per-layer): the "
          "plan replays as one CUDA graph over the same kernels, cached "
          "process-wide by plan signature")
    return {"energy_mj": energy_mj, "latency_ms": latency_ms,
            "random_ratio": ratio, "sources": (first.source, second.source),
            "plan_ok": ok, "plan_rel_err": err,
            "plan_measured_s": measured, "network_ok": ver.ok,
            "network_rel_err": ver.max_rel_err,
            "network_per_layer_s": net_measured,
            "network_fused_s": fused_measured}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu (the plain "
                    "versions)")
    ap.add_argument("--samples", type=int, default=500,
                    help="random-search samples (default %(default)s)")
    args = ap.parse_args(argv)
    out = run(args.device, args.samples)
    return 0 if out["plan_ok"] and out["network_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
