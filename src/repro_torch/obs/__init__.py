"""Observability: spans (``obs.trace``) and the metrics registry
(``obs.metrics``), the copies the solver needs.  ``explain`` and
``watch`` are not ported yet, so a solve with ``explain=True`` raises
``ImportError`` here."""
from . import metrics, trace
from .metrics import (REGISTRY, Counter, CounterGroup, Gauge, Histogram,
                      Registry, counter, gauge, histogram)
from .trace import Tracer, instant, span, tracing


def off() -> None:
    """Disable all observability: tracing off, metric updates skipped."""
    trace.disable()
    metrics.set_off(True)


def on() -> None:
    """Restore the default: metrics on, tracing off."""
    metrics.set_off(False)


__all__ = ["metrics", "trace", "span", "instant", "tracing", "Tracer",
           "REGISTRY", "Registry", "Counter", "Gauge", "Histogram",
           "CounterGroup", "counter", "gauge", "histogram", "off", "on"]
