"""What the program records about itself, read in the run's own process.

A metric's reader gets the driver's records alone; the numbers below are
kept by the program (``src/repro_torch/obs/``) in the process that ran
the cell, and are read from there once the driver has returned.  A
program that does not keep a number, or a run that never loaded the
program, reads None.
"""
from __future__ import annotations

import sys
from typing import Optional


def _registry():
    mod = sys.modules.get("repro_torch.obs.metrics")
    return None if mod is None else mod.REGISTRY


def capture_seconds(owner: str, registry=None) -> Optional[float]:
    """Seconds a CUDA-graph capture of ``owner`` took, its eager warm-up
    call and the capture itself (as ``kernels/graph.py`` ``CapturedStep``
    counts them in the program's ``graph_capture_seconds`` histogram by
    owner and phase), over the captures of that owner: None without
    one."""
    registry = _registry() if registry is None else registry
    h = None if registry is None else registry.get("graph_capture_seconds")
    if h is None:
        return None
    mine = [s for s in h.series() if s["labels"].get("owner") == owner]
    captures = sum(s["count"] for s in mine
                   if s["labels"].get("phase") == "capture")
    if not captures:
        return None
    return sum(s["sum"] for s in mine) / captures
