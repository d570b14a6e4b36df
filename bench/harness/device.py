"""Small helpers the drivers share: synchronising, bounding the work
queued ahead of the card, peak memory, freeing the card, seeded draws."""
from __future__ import annotations

import gc
import random
import time
from typing import List, Sequence

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inflight:
    """Keeps at most ``depth`` steps queued ahead of the card: after each
    step an event is recorded, and the host waits for the one ``depth``
    steps back.  The host still issues ahead of the device, and the
    window's end waits for everything queued."""

    def __init__(self, device: torch.device, depth: int):
        self.device, self.depth = device, depth
        self.events: List[torch.cuda.Event] = []
        self.marks: List[torch.cuda.Event] = []

    def start(self) -> None:
        """Mark the window's start on the device."""
        self.step(wait=False)

    def step(self, wait: bool = True) -> None:
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        self.events.append(ev)
        self.marks.append(ev)
        if wait and len(self.events) > self.depth:
            self.events.pop(0).synchronize()

    def step_ms(self) -> List[float]:
        """Each step's device milliseconds, mark to mark (after a
        synchronise)."""
        return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                   self.marks[1:])]


def describe(ms: List[float]) -> str:
    if not ms:
        return "none"
    s = sorted(ms)
    return (f"{len(ms)}: first {ms[0]:.2f}, min {s[0]:.2f}, median "
            f"{s[len(s) // 2]:.2f}, max {s[-1]:.2f}, last {ms[-1]:.2f}")


def peak_bytes(devices: Sequence[torch.device]) -> int:
    """The most memory any of ``devices`` held at once in this process."""
    return max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sample(seed: int, population: int, k: int, salt: int = 0) -> List[int]:
    """``k`` distinct indices of ``range(population)`` drawn from
    ``seed``, sorted."""
    rng = random.Random(seed * 1_000_003 + salt)
    return sorted(rng.sample(range(population), min(k, population)))


class Clock:
    """Seconds the drivers spend on the check during set-up, which
    ``setup_s`` leaves out."""

    def __init__(self):
        self.excluded = 0.0
        self._t = None

    def __enter__(self):
        self._t = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.excluded += time.monotonic() - self._t
        return False

