"""Observability: spans (``obs.trace``), the metrics registry
(``obs.metrics``), the solver flight recorder (``obs.explain``) and the
drift watchdog (``obs.watch``), all byte-identical copies of ``repro``'s;
and the port's own ``obs.device`` (not a copy, imported where used): host
spans that a ``torch.profiler`` sees too, and device marks that survive
CUDA-graph capture.  ``python -m repro_torch.obs`` is the CLI
(summarize, metrics, explain, watch)."""
from . import explain, metrics, trace, watch
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


__all__ = ["metrics", "trace", "explain", "watch", "span", "instant",
           "tracing", "Tracer", "REGISTRY", "Registry", "Counter",
           "Gauge", "Histogram", "CounterGroup", "counter", "gauge",
           "histogram", "off", "on"]
