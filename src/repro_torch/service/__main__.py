"""Schedule-service CLI of the port.

    python -m repro_torch.service solve    --net resnet --batch 64 [--deadline S]
    python -m repro_torch.service get      --net resnet --batch 64 [--json]
    python -m repro_torch.service stats    [--json | --prom]
    python -m repro_torch.service warm     --net resnet --batch 32
    python -m repro_torch.service autotune --net mlp --batch 4 -k 3 [--device cpu]
    python -m repro_torch.service repair

The verbs and flags of ``python -m repro.service``.

``solve`` answers through ``LocalClient`` down the degradation ladder
(store hit -> warm near-miss -> cold solve -> greedy first-valid when a
``--deadline`` expires) and reports the source + wall clock, so running
it twice demonstrates the cached path.  ``warm`` forces a warm-start
solve seeded from the nearest family record (same net, different batch).
``autotune`` lowers + executes the top-k candidates on the card (the fused
tier; ``--device cpu`` runs the plain versions) and promotes the measured
winner.  ``stats`` includes the resilience counters (corrupt /
quarantined / io_errors / rebuilds); ``stats --json`` adds the full
``repro_torch.obs`` metrics-registry snapshot and ``--prom`` emits Prometheus
text exposition.  ``repair`` rebuilds the store
index from the records dir, quarantining corrupt records.  The store dir
defaults to ``$REPRO_STORE_DIR`` or ``.repro_store``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from ..core.solver.kapla import solve
from ..hw.presets import eyeriss_multinode
from ..workloads.nets import NETS, get_net
from .autotune import autotune_network
from .client import LocalClient, SolveRequest, warm_context
from .store import DEFAULT_ROOT, ScheduleStore


def _add_common(p: argparse.ArgumentParser, net: bool = True) -> None:
    p.add_argument("--store-dir", default=DEFAULT_ROOT,
                   help="schedule store root (default: %(default)s)")
    if net:
        p.add_argument("--net", required=True, choices=sorted(NETS),
                       help="registered network")
        p.add_argument("--batch", type=int, default=64)
        p.add_argument("--training", action="store_true",
                       help="use the training graph (fwd+bwd layers)")
        p.add_argument("--objective", default="energy",
                       choices=("energy", "edp", "latency"))
        p.add_argument("--k-s", type=int, default=4, dest="k_s")
        p.add_argument("--max-seg-len", type=int, default=4)


def _request(args) -> SolveRequest:
    graph = get_net(args.net, batch=args.batch, training=args.training)
    hw = eyeriss_multinode()
    return SolveRequest.make(graph, hw,
                             deadline_s=getattr(args, "deadline", None),
                             objective=args.objective,
                             k_s=args.k_s, max_seg_len=args.max_seg_len)


def _print_result(res, hw_freq: float) -> None:
    s = res.schedule
    flags = " DEGRADED" if res.degraded else ""
    print(f"{s.graph_name}: source={res.source}{flags} "
          f"sig={res.signature[:12]} in {res.seconds * 1e3:.1f} ms")
    if res.error:
        print(f"  degraded by: {res.error}")
    if s.valid:
        print(f"  energy {s.total_energy_pj / 1e9:.2f} mJ | latency "
              f"{s.total_latency_cycles / hw_freq * 1e3:.2f} ms "
              f"({s.total_latency_cycles:.3e} cycles) | "
              f"{0 if s.chain is None else len(s.chain.segments)} segments")
    else:
        print("  INVALID (no feasible schedule)")


def cmd_solve(args) -> int:
    from .client import ServiceError
    store = ScheduleStore(args.store_dir)
    client = LocalClient(store)
    req = _request(args)
    try:
        res = client.solve_request(req)
    except ServiceError as e:
        print(f"ERROR {e.signature[:12]}: {e}")
        return 2
    _print_result(res, req.hw.freq_hz)
    print("  store:", json.dumps(store.stats()))
    return 0 if res.schedule.valid else 1


def cmd_get(args) -> int:
    store = ScheduleStore(args.store_dir)
    req = _request(args)
    rec = store.get_record(req.signature())
    if rec is None:
        print(f"MISS {req.signature()[:12]} ({args.net}/b{args.batch})")
        return 1
    if args.json:
        json.dump(rec.to_json(), sys.stdout, indent=1)
        print()
        return 0
    print(f"HIT {rec.signature[:12]}: {rec.graph_name}/b{rec.batch} on "
          f"{rec.hw_name}, energy {rec.predicted_energy_pj / 1e9:.2f} mJ, "
          f"{rec.predicted_latency_cycles:.3e} cycles")
    if rec.measured:
        print(f"  measured: {json.dumps(rec.measured)}")
    return 0


def cmd_stats(args) -> int:
    store = ScheduleStore(args.store_dir)
    if getattr(args, "prom", False):
        from ..obs.metrics import REGISTRY
        sys.stdout.write(REGISTRY.exposition())
        return 0
    if getattr(args, "json", False):
        from ..obs.metrics import REGISTRY
        json.dump({"store": store.stats(),
                   "metrics": REGISTRY.snapshot()},
                  sys.stdout, indent=1)
        print()
        return 0
    print(json.dumps(store.stats(), indent=1))
    return 0


def cmd_warm(args) -> int:
    """Warm-start solve: seed from the nearest family record (same net,
    different batch) and write the result for this batch's signature."""
    store = ScheduleStore(args.store_dir)
    req = _request(args)
    sig = req.signature()
    ctx = warm_context(store, req, sig)
    seeds = solver = None
    if ctx is not None:
        seeds, solver, rec = ctx
        print(f"seeding from {rec.graph_name}/b{rec.batch} "
              f"({rec.signature[:12]})")
    t0 = time.perf_counter()
    sched = solve(req.graph, req.hw, seed_chains=seeds,
                  use_dp=not seeds,
                  **(dict(layer_solver=solver) if solver else {}),
                  **req.opts)
    dt = time.perf_counter() - t0
    if not sched.valid:
        print("warm solve produced no valid schedule")
        return 1
    store.put(sched, req.graph, req.hw, req.opts, sig=sig)
    print(f"{'warm' if seeds else 'cold'} solve in {dt:.3f} s -> stored "
          f"{sig[:12]}")
    return 0


def cmd_repair(args) -> int:
    """Rebuild the index from the records dir, quarantining corrupt
    records on the way — the manual entry point to the same self-healing
    the store runs automatically when it detects index damage."""
    store = ScheduleStore(args.store_dir)
    n = store.rebuild_index()
    print(f"rebuilt index: {n} records, "
          f"{store.quarantined} quarantined, "
          f"{sum(1 for v in store._family.values() if v)} families")
    print(json.dumps(store.stats(), indent=1))
    return 0


def cmd_autotune(args) -> int:
    store = ScheduleStore(args.store_dir)
    req = _request(args)
    report = autotune_network(req.graph, req.hw, store=store, k=args.k,
                              iters=args.iters,
                              candidate_timeout_s=args.candidate_timeout,
                              device=args.device, **req.opts)
    print(json.dumps(report, indent=1))
    return 0 if report.get("n_executed") else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.service",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="verb", required=True)

    p = sub.add_parser("solve", help="serve one schedule "
                       "(cache -> warm -> cold -> greedy)")
    _add_common(p)
    p.add_argument("--deadline", type=float, default=None,
                   help="per-request deadline in seconds; past it the "
                   "answer degrades to the greedy floor")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("get", help="look up the stored record")
    _add_common(p)
    p.add_argument("--json", action="store_true",
                   help="dump the full record JSON")
    p.set_defaults(fn=cmd_get)

    p = sub.add_parser("stats", help="store statistics")
    p.add_argument("--json", action="store_true",
                   help="store stats + repro_torch.obs metrics snapshot")
    p.add_argument("--prom", action="store_true",
                   help="Prometheus text exposition of the registry")
    _add_common(p, net=False)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("warm", help="warm-start solve from a family "
                       "near-miss and store it")
    _add_common(p)
    p.set_defaults(fn=cmd_warm)

    p = sub.add_parser("repair", help="rebuild the store index, "
                       "quarantining corrupt records")
    _add_common(p, net=False)
    p.set_defaults(fn=cmd_repair)

    p = sub.add_parser("autotune", help="measure top-k candidates and "
                       "promote the fastest")
    _add_common(p)
    p.add_argument("-k", type=int, default=3,
                   help="candidate schedules to execute")
    p.add_argument("--iters", type=int, default=2,
                   help="timing iterations per candidate")
    p.add_argument("--candidate-timeout", type=float, default=None,
                   help="disqualify a candidate whose lower+verify+"
                   "measure exceeds this many seconds")
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card) or cpu (the plain "
                   "versions)")
    p.set_defaults(fn=cmd_autotune)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
