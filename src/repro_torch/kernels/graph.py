"""One step captured as a CUDA graph and replayed, shared by the fused
tier (``lower/fuse.py``), the serving loop (``launch/serve.py``) and the
train step (``launch/steps.py`` ``CompiledTraining``).

``CapturedStep(step, device)`` runs ``step`` (a function of no arguments
returning a dict of tensors) once outside the capture, so that every first
call happens there: a library's build and load, each kernel's
shared-memory attribute, the tensor-map encoder's lookup, the TF32 switch
of ``ref.full_fp32``, the launch-geometry caches.  It then captures one
call into a ``torch.cuda.CUDAGraph`` with a private memory pool; the
outputs are the captured call's tensors, rewritten by every replay.  A
step must read no device value on the host, allocate nothing outside the
pool and read only tensors whose addresses stay fixed (parameters, static
buffers): a replay runs the captured kernels on those addresses.  A
failed capture raises; nothing falls back to running the step eagerly.
A step with effects (a train step updates its parameters) takes
``keep_warmup=True``: the warm-up call's outputs are kept as
``warmup_outputs``, so that its caller can count that call as a step.

The warm-up and the capture are the host spans ``graph.warmup`` and
``graph.capture`` (``obs/device.py``), each carrying the owner's
arguments (``owner``: ``train``, ``net.boundary``, ``seg``, ...), and
their seconds go to the ``graph_capture_seconds`` histogram by owner and
phase, always: one observation each a capture.

Launch counters stay truthful: the capture records the launches of each
kind (``backend.recording_launches``: the capturing thread's, and any
thread's onto the capture stream, such as a backward's on autograd's
device thread) and every replay adds them to their tables, so the counts
are of kernels that ran.  On the CPU there is no
graph: every call runs ``step``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..obs import device as obs_device
from ..obs import metrics
from .backend import recording_launches

_m_capture = metrics.histogram(
    "graph_capture_seconds",
    "wall clock per CUDA-graph capture: the eager warm-up call and the "
    "capture itself", ("owner", "phase"))


class CapturedStep:
    """One captured step: the graph, its static outputs, the launches of
    each kind a replay makes, the bytes its pool took and the seconds of
    its warm-up call (``warmup_seconds``) and of the capture itself
    (``graph_seconds``); ``capture_seconds`` is their sum.  ``owner`` and
    ``args`` label the spans and the histogram.  On the CPU the step runs
    each time."""

    def __init__(self, step: Callable[[], Dict[str, torch.Tensor]],
                 device: torch.device, keep_warmup: bool = False,
                 owner: str = "step", **args):
        self.step = step
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Dict[str, torch.Tensor] = {}
        #: the warm-up call's outputs under ``keep_warmup`` (else None)
        self.warmup_outputs: Optional[Dict[str, torch.Tensor]] = None
        self.launches: Dict[str, int] = {}
        self._tally = None
        self.pool_bytes = 0             # the card's memory the pool took
        self.warmup_seconds = self.graph_seconds = 0.0
        self.capture_seconds = 0.0
        if device.type != "cuda":
            return
        with torch.cuda.device(device):
            t0 = time.perf_counter()
            with obs_device.span("graph.warmup", owner=owner, **args):
                # first calls stay out of the capture
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    first = step()
                if keep_warmup:
                    self.warmup_outputs = first
                del first
                torch.cuda.current_stream(device).wait_stream(side)
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            with obs_device.span("graph.capture", owner=owner, **args):
                graph = torch.cuda.CUDAGraph()
                # the private pool takes segments of its own: what the
                # card reserves across the capture is the pool.  The
                # capture empties the allocator's cache first; so does
                # this, so that the warm-up's freed blocks do not offset
                # the pool
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved(device)
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    # the capture stream's launches from any thread: a
                    # backward runs on autograd's device thread
                    with recording_launches(
                            torch.cuda.current_stream(device).cuda_stream
                    ) as tally:
                        self.outputs = step()
                self.pool_bytes = max(
                    0, torch.cuda.memory_reserved(device) - before)
                torch.cuda.synchronize(device)
            t2 = time.perf_counter()
        self.warmup_seconds, self.graph_seconds = t1 - t0, t2 - t1
        self.capture_seconds = t2 - t0
        _m_capture.observe(self.warmup_seconds, owner=owner, phase="warmup")
        _m_capture.observe(self.graph_seconds, owner=owner, phase="capture")
        self.graph = graph
        self._tally = tally
        self.launches = {k: n for k, n in tally.items() if n}

    def __call__(self) -> Dict[str, torch.Tensor]:
        if self.graph is None:
            return self.step()
        self.graph.replay()
        self._tally.replay()
        return dict(self.outputs)


__all__ = ["CapturedStep"]
