"""Host spans on the profiler's clock and device marks that survive
CUDA-graph capture: the port's own module, not a copy of the reference's.

``span(name, **args)`` is one host span seen by both recorders: the
installed tracer's (``obs.trace``, its Chrome export and ``python -m
repro_torch.obs summarize``) and, while a ``torch.profiler`` records, the
profiler's, as a ``record_function`` range among its host events on its
own clock.  A device idle gap in a profile is named after the innermost
host event around it, so a gap inside a program call is named by the
program's span.  With no tracer and no profiler it is
``obs.trace.NOOP_SPAN``.

``Marks`` are named device timestamps.  On the card each mark is a
timing event recorded on the current stream as an external event: inside
``torch.cuda.graph`` it becomes an event-record node, which every replay
records again, so the phases of a captured step are read after each
replay.  On the CPU a mark is ``time.perf_counter()``.  A mark is made
only while a tracer is installed at the moment it is recorded (for a
graph, at capture): a graph captured with tracing off holds no mark node,
and replays exactly as it would without this module.  A mark asked for
with no tracer forgets the marks recorded outside a graph, so that a
later ``phase_ms`` reads no phases of an earlier traced run.

Usage::

    marks = Marks(device)
    marks.mark("forward"); ...; marks.mark("backward"); ...
    marks.mark("end")
    marks.phase_ms()        # {"forward": ms, "backward": ms}
"""
from __future__ import annotations

import time
from typing import Dict, Union

import torch

from . import trace


class _ProfiledSpan:
    """A tracer span (or the no-op) and a profiler range, opened and
    closed together."""

    __slots__ = ("_span", "_range")

    def __init__(self, span, name: str):
        self._span = span
        self._range = torch.profiler.record_function(name)

    def __enter__(self) -> "_ProfiledSpan":
        self._span.__enter__()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        return self._span.__exit__(*exc)

    def set(self, **attrs) -> None:
        self._span.set(**attrs)


def span(name: str, **args):
    """A host span (context manager) for the installed tracer and, while a
    profiler records, for the profiler; the shared no-op with neither."""
    t = trace.current()
    if not torch._C._autograd._profiler_enabled():
        return trace.NOOP_SPAN if t is None else t.span(name, **args)
    return _ProfiledSpan(trace.NOOP_SPAN if t is None
                         else t.span(name, **args), name)


class Marks:
    """Named device timestamps, in the order of their first mark; the
    phases between consecutive ones of the last run that recorded them.
    ``device`` is where the marked work runs (the CPU's clock unless a
    CUDA device)."""

    def __init__(self, device: Union[torch.device, str, None] = None):
        self.device = torch.device(device if device is not None else "cpu")
        #: name -> CUDA event, or perf_counter seconds on the CPU
        self._at: Dict[str, object] = {}
        #: whether a captured graph records the events: each replay then
        #: marks them again, with or without a tracer
        self._in_graph = False

    def mark(self, name: str) -> None:
        """Record ``name`` now on the device's current stream while a
        tracer is installed; otherwise forget the marks, unless a graph
        records them."""
        if not trace.enabled():
            if not self._in_graph:
                self._at.clear()
            return
        if self.device.type != "cuda":
            self._at[name] = time.perf_counter()
            return
        if torch.cuda.is_current_stream_capturing():
            self._in_graph = True
        ev = self._at.get(name)
        if ev is None:
            ev = self._at[name] = torch.cuda.Event(enable_timing=True,
                                                   external=True)
        ev.record(torch.cuda.current_stream(self.device))

    def phase_ms(self) -> Dict[str, float]:
        """``{phase: ms}`` from each mark to the next, each phase named
        after the mark that opens it (the last mark opens none); empty
        before two marks.  On the card it waits for the last mark."""
        names = list(self._at)
        if len(names) < 2:
            return {}
        at = self._at
        if self.device.type != "cuda":
            return {a: 1e3 * (at[b] - at[a])
                    for a, b in zip(names, names[1:])}
        at[names[-1]].synchronize()
        return {a: at[a].elapsed_time(at[b])
                for a, b in zip(names, names[1:])}


__all__ = ["Marks", "span"]
