"""Thread-aware span tracing with Chrome trace-event export.

The tracing half of the observability layer (``repro.obs``): call sites
mark *spans* (timed regions) and *instant events* (annotated moments —
a degradation decision, an injected fault, a backup dispatch), and an
enabled tracer turns a run into a Perfetto-viewable timeline.

Design constraints, in order:

1. **Disabled is free.**  No tracer is installed by default; ``span()``
   then returns a shared no-op context manager and ``instant()`` returns
   immediately — one global read + ``None`` check on the hot path, no
   allocation beyond the caller's kwargs.  The solver's inner loops stay
   uninstrumented entirely; spans sit at segment/request granularity.
2. **Thread-aware.**  Events record the OS thread ident and name, so the
   solver's segment pool, the server's executor hops and the mesh's
   worker nodes each get their own timeline row in the viewer.
3. **Zero dependencies.**  stdlib only; the export target is the Chrome
   trace-event JSON format (``{"traceEvents": [...]}``), which Perfetto
   (https://ui.perfetto.dev) and ``chrome://tracing`` both load.

Usage::

    from repro.obs import trace

    with trace.tracing("run.trace.json"):
        with trace.span("solve.segment", graph="resnet", seg="0:4") as sp:
            ...
            sp.set(pipelined=True)          # late-bound attributes
        trace.instant("service.degrade", rung="greedy", reason="deadline")

Span/event names are dotted ``subsystem.action`` (``solve.segment``,
``service.request``, ``mesh.task``, ``fault.injected``); attributes are
JSON-safe scalars and land in the event's ``args``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class _NoopSpan:
    """Shared constant no-op: what ``span()`` hands out while tracing is
    disabled.  ``set`` swallows late-bound attributes."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One live timed region; records itself into the tracer on exit."""

    __slots__ = ("_tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **attrs) -> None:
        """Attach attributes decided after the span opened (e.g. the
        resolved request path)."""
        self.args.update(attrs)

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._complete(self.name, self.t0, time.perf_counter(),
                               self.args)
        return False


class Tracer:
    """An event buffer with Chrome trace-event export.

    Thread-safe; events carry (name, phase, t0, dur, thread ident,
    thread name, args) with times relative to the tracer's epoch.
    ``events`` rows are dicts — tests assert on them directly, the
    exporter maps them to trace-event JSON.
    """

    def __init__(self):
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self.events: List[Dict] = []
        self.dropped = 0
        self.max_events = 1_000_000     # runaway-trace backstop

    # -- recording -----------------------------------------------------------
    def _append(self, ev: Dict) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(ev)

    def _complete(self, name: str, t0: float, t1: float,
                  args: Dict) -> None:
        t = threading.current_thread()
        self._append({"name": name, "ph": "X",
                      "ts": t0 - self.epoch, "dur": t1 - t0,
                      "tid": t.ident, "tname": t.name, "args": args})

    def span(self, name: str, **args) -> Span:
        return Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        t = threading.current_thread()
        self._append({"name": name, "ph": "i",
                      "ts": time.perf_counter() - self.epoch,
                      "tid": t.ident, "tname": t.name, "args": args})

    # -- querying (tests, summaries) -----------------------------------------
    def find(self, name: str) -> List[Dict]:
        """Events with this exact name, in record order."""
        with self._lock:
            return [e for e in self.events if e["name"] == name]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for e in self.events:
                out[e["name"]] = out.get(e["name"], 0) + 1
            return out

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> Dict:
        """The buffer as Chrome trace-event JSON (Perfetto-loadable):
        ``X`` complete events with µs timestamps, ``i`` thread-scoped
        instants, plus ``M`` thread-name metadata rows."""
        pid = os.getpid()
        out: List[Dict] = []
        threads: Dict[int, str] = {}
        with self._lock:
            events = list(self.events)
        for e in events:
            threads.setdefault(e["tid"], e["tname"])
            row = {"name": e["name"], "ph": e["ph"], "pid": pid,
                   "tid": e["tid"], "ts": e["ts"] * 1e6,
                   "cat": e["name"].split(".", 1)[0],
                   "args": e["args"]}
            if e["ph"] == "X":
                row["dur"] = e["dur"] * 1e6
            else:
                row["s"] = "t"          # thread-scoped instant
            out.append(row)
        for tid, tname in sorted(threads.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# -- activation ---------------------------------------------------------------
# process-global, like runtime.inject: worker threads spawned inside the
# enabled scope (segment pool, node pool, server executor) must see it.
_tracer: Optional[Tracer] = None


def enabled() -> bool:
    return _tracer is not None


def current() -> Optional[Tracer]:
    return _tracer


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the process-wide tracer."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def disable() -> Optional[Tracer]:
    """Remove the process-wide tracer; returns it for export."""
    global _tracer
    t = _tracer
    _tracer = None
    return t


@contextmanager
def tracing(path: Optional[str] = None, tracer: Optional[Tracer] = None):
    """Enable tracing for a scope; export to ``path`` on exit (even on
    error — a crashed chaos run still yields its timeline)::

        with trace.tracing("chaos.trace.json") as t:
            run()
    """
    t = enable(tracer)
    try:
        yield t
    finally:
        disable()
        if path is not None:
            t.save(path)


# -- the hot-path entry points ------------------------------------------------

def span(name: str, **args):
    """A timed region (context manager).  No-op constant when tracing is
    disabled."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return t.span(name, **args)


def instant(name: str, **args) -> None:
    """An annotated moment (degradation decision, injected fault, backup
    dispatch...).  No-op when tracing is disabled."""
    t = _tracer
    if t is None:
        return
    t.instant(name, **args)


# -- trace-file summaries (the ``python -m repro.obs`` backend) ---------------

def load_events(path: str) -> List[Dict]:
    """Load a Chrome trace-event file back into event rows."""
    with open(path) as f:
        d = json.load(f)
    return d["traceEvents"] if isinstance(d, dict) else d


def summarize_events(events: List[Dict]) -> Dict:
    """Aggregate a trace-event list: per-name span count/total/max µs,
    instant-event counts, thread rows."""
    spans: Dict[str, Dict] = {}
    instants: Dict[str, int] = {}
    threads: Dict[int, str] = {}
    for e in events:
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") == "thread_name":
                threads[e["tid"]] = e.get("args", {}).get("name", "?")
            continue
        name = e.get("name", "?")
        if ph == "X":
            s = spans.setdefault(name, {"count": 0, "total_us": 0.0,
                                        "max_us": 0.0})
            s["count"] += 1
            dur = float(e.get("dur", 0.0))
            s["total_us"] += dur
            s["max_us"] = max(s["max_us"], dur)
        elif ph == "i":
            instants[name] = instants.get(name, 0) + 1
    return {"n_events": len(events), "spans": spans,
            "instants": instants,
            "threads": {str(k): v for k, v in sorted(threads.items())}}


def _nest_spans(events: List[Dict]) -> List[Dict]:
    """Build per-(pid, tid) containment forests over the ``X`` events.

    Chrome complete events carry no explicit parent links; within one
    thread timeline, span A contains span B iff B's [ts, ts+dur) sits
    inside A's.  Returns the root nodes; each node is
    ``{event, children, self_us}`` with self time = own duration minus
    the durations of direct children."""
    by_thread: Dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        key = (e.get("pid", 0), e.get("tid", 0))
        by_thread.setdefault(key, []).append(e)
    roots: List[Dict] = []
    for evs in by_thread.values():
        # sort by start asc, then duration desc: a parent sorts before
        # any span it contains, so a simple open-span stack nests them
        evs.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                -float(e.get("dur", 0.0))))
        stack: List[Dict] = []
        for e in evs:
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
            node = {"event": e, "children": [], "self_us": dur}
            while stack:
                top = stack[-1]
                t0 = float(top["event"].get("ts", 0.0))
                t1 = t0 + float(top["event"].get("dur", 0.0))
                if ts < t1 and ts + dur <= t1 + 1e-9:
                    break
                stack.pop()
            if stack:
                stack[-1]["children"].append(node)
                stack[-1]["self_us"] -= dur
            else:
                roots.append(node)
            stack.append(node)
    return roots


def self_times(events: List[Dict]) -> Dict[str, Dict]:
    """Per-name self time (span duration minus direct children): where
    the wall clock actually went, with double-counting from nesting
    removed.  Returns ``{name: {count, total_us, self_us}}``."""
    out: Dict[str, Dict] = {}

    def walk(node: Dict) -> None:
        name = node["event"].get("name", "?")
        s = out.setdefault(name, {"count": 0, "total_us": 0.0,
                                  "self_us": 0.0})
        s["count"] += 1
        s["total_us"] += float(node["event"].get("dur", 0.0))
        s["self_us"] += max(0.0, node["self_us"])
        for c in node["children"]:
            walk(c)

    for r in _nest_spans(events):
        walk(r)
    return out


def critical_path(events: List[Dict]) -> List[Dict]:
    """The longest root-to-leaf chain of nested spans: start from the
    longest root and descend into the largest child at every level.
    Each step reports name/duration/self time and its share of the root.
    An approximation of "what must get faster for the run to get
    faster" for the dominant serial timeline."""
    roots = _nest_spans(events)
    if not roots:
        return []
    node = max(roots, key=lambda n: float(n["event"].get("dur", 0.0)))
    root_dur = float(node["event"].get("dur", 0.0)) or 1.0
    path: List[Dict] = []
    while node is not None:
        dur = float(node["event"].get("dur", 0.0))
        path.append({"name": node["event"].get("name", "?"),
                     "dur_us": dur,
                     "self_us": max(0.0, node["self_us"]),
                     "frac_of_root": dur / root_dur,
                     "args": node["event"].get("args", {})})
        node = max(node["children"],
                   key=lambda n: float(n["event"].get("dur", 0.0)),
                   default=None)
    return path


__all__ = ["Tracer", "Span", "NOOP_SPAN", "span", "instant", "enabled",
           "enable", "disable", "current", "tracing", "load_events",
           "summarize_events", "self_times", "critical_path"]
