"""Observability CLI of the port.

    python -m repro_torch.obs summarize TRACE.json [--critical-path] [--json]
    python -m repro_torch.obs metrics [SNAPSHOT.json] [--prom | --json]
    python -m repro_torch.obs explain <sig|net[/bN]> [--batch N]
                                      [--store-dir DIR] [--json]
    python -m repro_torch.obs watch [--calibration REC.json ...]
                                    [--bench CUR.json=BASE.json ...]
                                    [--metrics SNAPSHOT.json] [--state FILE]
                                    [--out REPORT.json] [--gate] [--json]

The verbs of ``repro.obs``'s CLI, over the port's copies of ``trace``,
``metrics``, ``explain`` and ``watch``:

``summarize`` aggregates an exported Chrome trace-event file (per-span
count / total / max duration, instant-event counts, thread rows);
``--critical-path`` adds per-span self time and the dominant span chain.
Given a metrics snapshot instead, it renders the registry families with
interpolated p50/p95/p99 per histogram series.
``metrics`` renders a registry snapshot from a file, else the live
in-process registry; ``--prom`` emits Prometheus text exposition.
``explain`` renders a solver flight-recorder record: from a stored
schedule (by signature or net name, searching ``--store-dir``), else by
solving the named net fresh with ``explain=True`` on the 16x16 Eyeriss
template.
``watch`` runs the drift watchdog over the calibration records and bench
pairs it is given and the live ``latency_drift_ratio`` histogram;
``--gate`` exits non-zero on any error finding.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import List, Optional

from . import metrics, trace, watch
from .explain import render as render_explain
from .metrics import series_quantiles


def _fmt_q(v: float) -> str:
    return "n/a" if not math.isfinite(v) else f"{v:.4g}"


def _looks_like_snapshot(d) -> bool:
    return isinstance(d, dict) and "traceEvents" not in d and any(
        isinstance(v, dict) and "kind" in v and "series" in v
        for v in d.values())


def _render_snapshot(snap: dict) -> None:
    for name in sorted(snap):
        fam = snap[name]
        print(f"{name} ({fam.get('kind', '?')}) — {fam.get('help', '')}")
        for s in fam.get("series", []):
            labels = ",".join(f"{k}={v}" for k, v in s["labels"].items())
            if "count" in s:            # histogram series
                mean = s["sum"] / s["count"] if s["count"] else 0.0
                q = series_quantiles(s)
                print(f"  {{{labels}}} count={s['count']} "
                      f"mean={mean:.6g} sum={s['sum']:.6g} "
                      f"p50={_fmt_q(q['p50'])} p95={_fmt_q(q['p95'])} "
                      f"p99={_fmt_q(q['p99'])}")
            else:
                print(f"  {{{labels}}} {s['value']:g}")
    if not snap:
        print("(registry is empty)")


def _snapshot_from_file(path: str) -> dict:
    with open(path) as f:
        d = json.load(f)
    # a bare registry snapshot, or a record embedding one under "metrics"
    if isinstance(d, dict) and isinstance(d.get("metrics"), dict):
        return d["metrics"]
    return d


def cmd_summarize(args) -> int:
    with open(args.trace) as f:
        d = json.load(f)
    if _looks_like_snapshot(d):
        snap = d["metrics"] if isinstance(d.get("metrics"), dict) else d
        if args.json:
            json.dump({name: {"quantiles": [
                {"labels": s["labels"], **series_quantiles(s)}
                for s in fam.get("series", []) if "count" in s]}
                for name, fam in snap.items()}, sys.stdout, indent=1)
            print()
        else:
            _render_snapshot(snap)
        return 0
    events = d["traceEvents"] if isinstance(d, dict) else d
    s = trace.summarize_events(events)
    if args.critical_path:
        s["self_times"] = trace.self_times(events)
        s["critical_path"] = trace.critical_path(events)
    if args.json:
        json.dump(s, sys.stdout, indent=1)
        print()
        return 0
    print(f"{args.trace}: {s['n_events']} events, "
          f"{len(s['threads'])} threads")
    if s["spans"]:
        print("spans (count / total ms / max ms):")
        width = max(len(n) for n in s["spans"])
        for name in sorted(s["spans"],
                           key=lambda n: -s["spans"][n]["total_us"]):
            sp = s["spans"][name]
            print(f"  {name:<{width}}  {sp['count']:>6}  "
                  f"{sp['total_us'] / 1e3:>10.2f}  "
                  f"{sp['max_us'] / 1e3:>10.2f}")
    if s["instants"]:
        print("instant events:")
        for name in sorted(s["instants"]):
            print(f"  {name}: {s['instants'][name]}")
    if args.critical_path:
        st = s["self_times"]
        if st:
            print("self time (count / total ms / self ms):")
            width = max(len(n) for n in st)
            for name in sorted(st, key=lambda n: -st[n]["self_us"]):
                r = st[name]
                print(f"  {name:<{width}}  {r['count']:>6}  "
                      f"{r['total_us'] / 1e3:>10.2f}  "
                      f"{r['self_us'] / 1e3:>10.2f}")
        if s["critical_path"]:
            print("critical path (longest nested span chain):")
            for step in s["critical_path"]:
                print(f"  {step['name']}  "
                      f"{step['dur_us'] / 1e3:.2f} ms total, "
                      f"{step['self_us'] / 1e3:.2f} ms self "
                      f"({step['frac_of_root'] * 100:.0f}% of root)")
    print("open in Perfetto: https://ui.perfetto.dev (drag the file in)")
    return 0


def cmd_metrics(args) -> int:
    snap = _snapshot_from_file(args.snapshot) if args.snapshot \
        else metrics.REGISTRY.snapshot()
    if args.prom:
        if not args.snapshot:
            print(metrics.REGISTRY.exposition(), end="")
            return 0
        # rebuild counters and gauges from the snapshot for the exposition
        # (histogram buckets do not reload one to one)
        reg = metrics.Registry()
        for name, fam in snap.items():
            make = {"counter": reg.counter,
                    "gauge": reg.gauge}.get(fam.get("kind"))
            if make is None:
                continue
            m = make(name, fam.get("help", ""),
                     tuple(fam.get("labelnames", ())))
            for s in fam.get("series", []):
                m.inc(s["value"], **s["labels"])
        print(reg.exposition(), end="")
        return 0
    if args.json:
        json.dump(snap, sys.stdout, indent=1)
        print()
        return 0
    _render_snapshot(snap)
    return 0


def _explain_from_store(target: str, store_dir: Optional[str]):
    """Find a stored schedule by exact signature or by graph name;
    returns (record, its explain block), or (None, None) on no match."""
    from ..service.store import DEFAULT_ROOT, ScheduleStore
    root = store_dir or DEFAULT_ROOT
    if not os.path.isdir(root):
        return None, None
    store = ScheduleStore(root)
    sigs = store.signatures()
    if target in sigs:
        rec = store.get_record(target)
        return rec, (rec.schedule or {}).get("explain") if rec else None
    for sig in sigs:
        rec = store.get_record(sig)
        if rec is not None and rec.graph_name == target:
            return rec, (rec.schedule or {}).get("explain")
    return None, None


def cmd_explain(args) -> int:
    rec, record = _explain_from_store(args.target, args.store_dir)
    if rec is not None and record is None:
        print(f"stored schedule {rec.signature} for {rec.graph_name} has "
              "no explain block (solved without explain=True); solving "
              "fresh", file=sys.stderr)
    if record is None:
        # not stored (or stored without a record): solve the net fresh
        from ..core.solver import solve
        from ..hw.presets import eyeriss_multinode
        from ..workloads.nets import get_net
        name, batch = args.target, args.batch
        if "/b" in name:                # accept "resnet/b64" directly
            name, _, b = name.rpartition("/b")
            batch = int(b)
        try:
            net = get_net(name, batch=batch)
        except KeyError:
            print(f"explain: {args.target!r} is neither a stored "
                  "signature/net nor a registered net name",
                  file=sys.stderr)
            return 1
        record = solve(net, eyeriss_multinode(), explain=True).explain
    if record is None:
        print(f"explain: no record produced for {args.target!r}",
              file=sys.stderr)
        return 1
    if args.json:
        json.dump(record, sys.stdout, indent=1)
        print()
    else:
        print(render_explain(record))
    return 0


def cmd_watch(args) -> int:
    calibrations = []
    for path in args.calibration:
        with open(path) as f:
            calibrations.append((os.path.basename(path), json.load(f)))
    benches = []
    for spec in args.bench:
        cur_path, sep, base_path = spec.partition("=")
        if not sep:
            print(f"watch: --bench wants CURRENT.json=BASELINE.json, "
                  f"got {spec!r}", file=sys.stderr)
            return 2
        with open(cur_path) as f:
            cur = json.load(f)
        with open(base_path) as f:
            base = json.load(f)
        benches.append((os.path.basename(cur_path), cur, base))
    snapshot = None
    if args.metrics:
        snapshot = _snapshot_from_file(args.metrics)
    elif metrics.REGISTRY.get("latency_drift_ratio") is not None:
        snapshot = metrics.REGISTRY.snapshot()
    state = watch.load_state(args.state) if args.state else None
    report = watch.run_watch(calibrations=calibrations, benches=benches,
                             snapshot=snapshot, state=state)
    if state is not None:
        watch.save_state(state, args.state)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
    else:
        print(watch.render_report(report))
    return 1 if args.gate and not report["ok"] else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="verb", required=True)

    p = sub.add_parser("summarize", help="aggregate an exported trace "
                       "(or a metrics snapshot, with quantiles)")
    p.add_argument("trace", help="Chrome trace-event JSON file (or a "
                   "metrics snapshot JSON)")
    p.add_argument("--critical-path", action="store_true",
                   help="add the self-time table and the dominant nested "
                        "span chain")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summary")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("metrics", help="dump a metrics snapshot")
    p.add_argument("snapshot", nargs="?", default=None,
                   help="snapshot JSON file (default: live registry)")
    p.add_argument("--prom", action="store_true",
                   help="Prometheus text exposition")
    p.add_argument("--json", action="store_true", help="raw snapshot JSON")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("explain", help="solve a net with the flight "
                       "recorder on and render it (funnel, attribution, "
                       "runners-up)")
    p.add_argument("target", help="registered net name, optionally with "
                   "its batch (e.g. alexnet/b1)")
    p.add_argument("--batch", type=int, default=64,
                   help="batch size when the target names none (default 64)")
    p.add_argument("--store-dir", default=None,
                   help="schedule store to search first (default: "
                        "$REPRO_STORE_DIR or .repro_store)")
    p.add_argument("--json", action="store_true",
                   help="raw explain record JSON")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("watch", help="drift watchdog: calibration fit "
                       "quality, bench regressions, drift baselines")
    p.add_argument("--calibration", action="append", default=[],
                   metavar="REC.json",
                   help="calibration record to health-check (repeatable)")
    p.add_argument("--bench", action="append", default=[],
                   metavar="CUR.json=BASE.json",
                   help="bench record vs its baseline (repeatable)")
    p.add_argument("--metrics", default=None, metavar="SNAPSHOT.json",
                   help="metrics snapshot with latency_drift_ratio "
                        "(default: the live registry when populated)")
    p.add_argument("--state", default=None, metavar="FILE",
                   help="rolling EWMA baseline state file (read and "
                        "updated)")
    p.add_argument("--out", default=None, metavar="REPORT.json",
                   help="write the full report JSON here")
    p.add_argument("--gate", action="store_true",
                   help="exit non-zero on any error finding")
    p.add_argument("--json", action="store_true",
                   help="print the report as JSON")
    p.set_defaults(fn=cmd_watch)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
