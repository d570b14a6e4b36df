"""Process-wide metrics registry: labeled counters, gauges, histograms.

The always-on half of the observability layer (``repro.obs``): where
tracing (``obs.trace``) answers *when and why did this happen*, metrics
answer *how often and how much, over the process lifetime*.  One global
``REGISTRY`` aggregates every subsystem — store hits, solver memo hits,
request sources, mesh recovery events, injected faults, latency drift —
so a single ``snapshot()`` (JSON) or ``exposition()`` (Prometheus text)
covers the whole stack.

Design constraints:

* **Zero dependencies**, stdlib only.
* **Cheap.**  An update is a flag check, a label-tuple build and a
  locked dict add — nanoseconds against the millisecond-scale operations
  being counted.  ``off()`` (see ``repro.obs``) turns updates into the
  flag check alone, the overhead-bench baseline.
* **Per-instance thin views.**  Components that used to keep ad-hoc
  ``stats()`` dicts (``ScheduleStore``, ``SolveServer``, ...) hold a
  ``CounterGroup``: per-instance integers whose every increment is
  mirrored into a shared labeled counter, so old ``stats()`` shapes
  survive unchanged while the registry sees the union of all instances.

Naming scheme (kept Prometheus-conventional): ``<subsystem>_<what>``
with ``_total`` for counters and ``_seconds``/``_ratio`` units for
histograms — e.g. ``store_events_total{event="hits"}``,
``service_request_seconds{source="cached"}``, ``latency_drift_ratio``
(labeled ``{source, backend}``: predicted-vs-measured drift is a
different series per execution backend, interpreter seconds and fused
compiled-XLA seconds being different units).  The compiled tier adds
``fused_cache_events_total{event}`` / ``fused_cache_size`` /
``fused_compile_seconds`` (``repro.lower.fuse``).
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

#: kill switch (set via repro.obs.off()): updates become a flag check.
#: Exists so the overhead bench has a true no-observability baseline.
_off = False


def set_off(flag: bool) -> None:
    global _off
    _off = bool(flag)


def is_off() -> bool:
    return _off


#: default latency buckets (seconds) — sub-ms solver ops up to minute-
#: scale autotune runs
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: buckets for measured/predicted latency ratios: 1.0 = perfect model,
#: log-ish spread both ways so calibration decay is visible in either
#: direction
DRIFT_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.1, 1.25, 1.5, 2.0,
                 3.0, 5.0, 10.0, 25.0, 100.0)


def escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped inside the quoted value."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n",
                                                               "\\n")


def quantile_from_buckets(bounds: Sequence[float],
                          cumulative: Sequence[float],
                          count: float, q: float) -> float:
    """Estimate the ``q``-quantile from cumulative bucket counts by
    linear interpolation inside the straddling bucket (Prometheus
    ``histogram_quantile`` semantics: the first finite bucket's lower
    edge is 0, observations past the last finite bound clamp to it).

    ``bounds`` are the finite upper edges (ascending) and ``cumulative``
    the matching cumulative counts; ``count`` is the series total
    (the ``+Inf`` bucket)."""
    if count <= 0:
        return float("nan")
    target = q * count
    prev_cum = 0.0
    prev_bound = 0.0
    for b, c in zip(bounds, cumulative):
        if c >= target:
            in_bucket = c - prev_cum
            if in_bucket <= 0:
                return float(b)
            frac = (target - prev_cum) / in_bucket
            return float(prev_bound + (b - prev_bound) * frac)
        prev_cum, prev_bound = c, b
    return float(bounds[-1]) if len(bounds) else float("nan")


def series_quantiles(series: Dict,
                     qs: Sequence[float] = (0.5, 0.95, 0.99)
                     ) -> Dict[str, float]:
    """Quantiles of one snapshot histogram series (the ``series()`` /
    ``snapshot()`` dict shape: cumulative ``buckets`` with a ``+Inf``
    key plus ``count``) — usable on live and JSON-loaded snapshots
    alike, e.g. by the drift watchdog over ``BENCH_*.json`` records."""
    buckets = series.get("buckets", {})
    finite = sorted((float(k), v) for k, v in buckets.items()
                    if k not in ("+Inf", "inf"))
    bounds = [b for b, _ in finite]
    cum = [c for _, c in finite]
    count = series.get("count", 0)
    return {f"p{round(q * 100)}": quantile_from_buckets(bounds, cum,
                                                        count, q)
            for q in qs}


class Metric:
    """Base: a named family of labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple, float] = {}

    def _key(self, labels: Mapping[str, object]) -> Tuple:
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def series(self) -> List[Dict]:
        with self._lock:
            items = sorted(self._series.items())
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in items]

    def snapshot(self) -> Dict:
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "series": self.series()}

    # Prometheus text exposition -------------------------------------------
    def _fmt_labels(self, key: Tuple, extra: str = "") -> str:
        parts = [f'{n}="{escape_label_value(v)}"'
                 for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._series.items())
        for k, v in items:
            lines.append(f"{self.name}{self._fmt_labels(k)} {v}")
        return lines


class Counter(Metric):
    """Monotone event count (negative deltas tolerated for the few
    legacy counters that reconcile, e.g. a solve retracted after a
    fallback)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if _off:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def expose(self) -> List[str]:
        # Prometheus convention: counter sample names carry a _total
        # suffix.  Families already named *_total are left alone.
        name = self.name if self.name.endswith("_total") \
            else self.name + "_total"
        lines = [f"# HELP {name} {self.help}",
                 f"# TYPE {name} {self.kind}"]
        with self._lock:
            items = sorted(self._series.items())
        for k, v in items:
            lines.append(f"{name}{self._fmt_labels(k)} {v}")
        return lines


class Gauge(Metric):
    """A point-in-time value (alive nodes, fleet median, queue depth)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if _off:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if _off:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` buckets
    plus ``+Inf``, with per-series ``sum`` and ``count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        # per label-key: [bucket counts..., +Inf count], sum, count
        self._h: Dict[Tuple, List] = {}

    def observe(self, value: float, **labels) -> None:
        if _off:
            return
        key = self._key(labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            h = self._h.get(key)
            if h is None:
                h = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._h[key] = h
            h[0][i] += 1
            h[1] += value
            h[2] += 1

    def value(self, **labels) -> float:
        """The series count (histograms have no single value)."""
        with self._lock:
            h = self._h.get(self._key(labels))
            return 0 if h is None else h[2]

    def series(self) -> List[Dict]:
        with self._lock:
            items = sorted(self._h.items())
        out = []
        for k, (counts, total, n) in items:
            cum, buckets = 0, {}
            for b, c in zip(self.buckets, counts):
                cum += c
                buckets[str(b)] = cum
            buckets["+Inf"] = n
            out.append({"labels": dict(zip(self.labelnames, k)),
                        "buckets": buckets, "sum": total, "count": n})
        return out

    def quantile(self, q: float, **labels) -> float:
        """Interpolated ``q``-quantile of one live series (see
        ``quantile_from_buckets``; NaN when the series is empty)."""
        with self._lock:
            h = self._h.get(self._key(labels))
            if h is None:
                return float("nan")
            counts, _, n = h
        cum, cumulative = 0, []
        for c in counts[:-1]:
            cum += c
            cumulative.append(cum)
        return quantile_from_buckets(self.buckets, cumulative, n, q)

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for s in self.series():
            key = tuple(s["labels"][n] for n in self.labelnames)
            for le, c in s["buckets"].items():
                extra = 'le="%s"' % le
                lines.append(f"{self.name}_bucket"
                             f"{self._fmt_labels(key, extra)} {c}")
            lines.append(f"{self.name}_sum{self._fmt_labels(key)} "
                         f"{s['sum']}")
            lines.append(f"{self.name}_count{self._fmt_labels(key)} "
                         f"{s['count']}")
        return lines


class Registry:
    """Name -> metric family.  ``counter``/``gauge``/``histogram`` are
    get-or-create and idempotent — every call site can declare the
    metric it uses; redeclaring with a different kind or labelset is a
    bug and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or \
                m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} redeclared as {cls.kind}"
                f"{tuple(labelnames)} but exists as {m.kind}"
                f"{m.labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict:
        """JSON-safe snapshot of every family (the ``stats --json`` /
        ``BENCH_obs.json`` payload)."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}

    def exposition(self) -> str:
        """Prometheus text-format exposition of the whole registry."""
        with self._lock:
            metrics = dict(self._metrics)
        lines: List[str] = []
        for _, m in sorted(metrics.items()):
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every family (tests)."""
        with self._lock:
            self._metrics.clear()


#: the process-wide registry every subsystem publishes into
REGISTRY = Registry()


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


class CounterGroup:
    """Per-instance counter block mirrored into one shared labeled
    counter (``<subsystem>_events_total{event=...}``).

    The re-homing seam for the stack's legacy ``stats()`` dicts: each
    ``ScheduleStore``/``SolveServer``/... instance keeps its own integer
    view (so existing tests and stats shapes are untouched), while the
    process registry accumulates the union across instances."""

    def __init__(self, subsystem: str, names: Sequence[str],
                 registry: Optional[Registry] = None):
        self.subsystem = subsystem
        self._vals = {n: 0 for n in names}
        self._lock = threading.Lock()
        self._metric = (registry if registry is not None
                        else REGISTRY).counter(
            f"{subsystem}_events_total",
            f"{subsystem} counter events (all instances)",
            labelnames=("event",))

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._vals[name] += amount      # KeyError = undeclared event
        self._metric.inc(amount, event=name)

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._vals[name]

    def view(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._vals)


__all__ = ["Metric", "Counter", "Gauge", "Histogram", "Registry",
           "REGISTRY", "counter", "gauge", "histogram", "CounterGroup",
           "LATENCY_BUCKETS", "DRIFT_BUCKETS", "set_off", "is_off",
           "escape_label_value", "quantile_from_buckets",
           "series_quantiles"]
