"""What a traced part of a run did on the device, from ``torch.profiler``.

``traced(fn)`` runs ``fn`` under the profiler (host and CUDA activity),
ends with a synchronise, and keeps, from the profiler's own records, every
device operation (kernels, copies, sets; not the host ranges the
profiler mirrors onto the device timeline) with its name, card, start and
length, and every host event.  From those:

* ``busy_s``: the seconds in which some operation ran, per card (the
  union of its operations' intervals), averaged over the cards;
* ``seconds_by_group``: device seconds by kernel group, each operation in
  one group (``group``: the two model kernels, the network tier's conv,
  matrix products, NCCL, copies, the rest);
* ``top_ops``: the operations that took most time, summed by name;
* ``idle_gaps``: the longest gaps between operations on a card, each
  named by the innermost host event around its middle: what the host was
  doing while the device waited.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: kernel name fragments of each group, tried in order
GROUPS = (
    ("flash_attention", ("flash_kernel", "flash_wgmma_kernel")),
    ("ssd_intra_chunk", ("ssd_intra_kernel",)),
    ("conv", ("conv_kernel",)),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas",
                "wgmma", "matmul")),
    ("memcpy", ("memcpy", "memset")),
    ("nccl", ("nccl",)),
)


def group(name: str) -> str:
    n = name.lower()
    for g, keys in GROUPS:
        if any(k in n for k in keys):
            return g
    return "other"


@dataclasses.dataclass
class Trace:
    window_s: float
    #: (name, card, start ns, length ns) of each device operation
    ops: List[Tuple[str, int, int, int]]
    #: (name, start ns, end ns) of each host event
    host: List[Tuple[str, int, int]]
    cards: Tuple[int, ...]

    def intervals(self, card: int) -> List[Tuple[int, int]]:
        """The card's busy intervals, merged."""
        spans = sorted((s, s + d) for _, c, s, d in self.ops if c == card)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        cards = self.cards or (0,)
        return sum(sum(e - s for s, e in self.intervals(c))
                   for c in cards) / len(cards) / 1e9

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for name, _, _, d in self.ops:
            out[name] += d / 1e9
        return dict(out)

    def seconds_by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for name, sec in self.seconds_by_name().items():
            out[group(name)] += sec
        return dict(out)

    def top_ops(self, n: int = 10) -> List[List]:
        by = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        return [[name[:120], sec] for name, sec in by[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between operations on any card, each
        named by the innermost host event around its middle."""
        gaps = []
        for c in self.cards or (0,):
            iv = self.intervals(c)
            gaps += [(b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:])]
        gaps.sort(reverse=True)
        starts = [h[1] for h in self.host]
        out = []
        for length, s, e in gaps[:n]:
            mid = (s + e) // 2
            best: Optional[Tuple[str, int, int]] = None
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                h = self.host[i]
                if h[2] >= mid and (best is None
                                    or h[2] - h[1] < best[2] - best[1]):
                    best = h
                if mid - h[1] > 60e9:      # no host event lasts a minute
                    break
            out.append([best[0][:120] if best else "(no host event)",
                        length / 1e9])
        return out


def traced(fn: Callable[[], None], cards=(0,)) -> Trace:
    """``fn()`` under the profiler, ending in a synchronise of ``cards``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for c in cards:
        torch.cuda.synchronize(c)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for c in cards:
            torch.cuda.synchronize(c)
        window = time.perf_counter() - t0
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            ops.append((e.name(), e.device_index(), e.start_ns(),
                        e.duration_ns()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_ns(), e.end_ns()))
    host.sort(key=lambda h: h[1])
    return Trace(window, ops, host, tuple(cards))


def summary(trace: Trace) -> Dict:
    """The numbers of a trace that a run's records keep."""
    return {"window_s": trace.window_s, "busy_s": trace.busy_s(),
            "by_group": trace.seconds_by_group(),
            "device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps(),
            "ops": len(trace.ops)}
