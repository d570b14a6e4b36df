"""Straggler mitigation.

SPMD steps are gang-scheduled: one slow host stalls the whole pod.  Two
mitigations, both host-side (no device code changes):

* ``StragglerDetector`` — EWMA of step latencies with an outlier threshold;
  flags hosts whose recent steps exceed ``factor`` x the fleet median so the
  controller can drain/replace them before they become failures.
* ``BackupDispatcher`` — duplicate-dispatch of *input pipeline* work (the
  common non-SPMD straggler source): issue each host's batch generation to
  a backup worker after a deadline, take whichever finishes first
  (deterministic: both produce identical bytes by construction).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional

from ..obs import metrics

_m_task_seconds = metrics.histogram(
    "straggler_task_seconds",
    "per-host task latencies fed to the straggler detector", ("host",))


@dataclasses.dataclass
class StragglerDetector:
    factor: float = 1.8
    alpha: float = 0.2                  # EWMA smoothing
    warmup: int = 5

    def __post_init__(self):
        self._ewma: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    def record(self, host: str, seconds: float) -> None:
        _m_task_seconds.observe(seconds, host=host)
        prev = self._ewma.get(host)
        self._ewma[host] = seconds if prev is None else \
            (1 - self.alpha) * prev + self.alpha * seconds
        self._count[host] = self._count.get(host, 0) + 1

    def fleet_median(self) -> Optional[float]:
        vals = [v for h, v in self._ewma.items()
                if self._count.get(h, 0) >= self.warmup]
        return statistics.median(vals) if vals else None

    def stragglers(self) -> List[str]:
        med = self.fleet_median()
        if med is None or med <= 0:
            return []
        return [h for h, v in self._ewma.items()
                if self._count.get(h, 0) >= self.warmup
                and v > self.factor * med]

    def forget(self, host: str) -> None:
        """Drop a drained/replaced host's history so its (typically
        inflated) EWMA stops poisoning the fleet median."""
        self._ewma.pop(host, None)
        self._count.pop(host, None)

    def stats(self) -> Dict:
        return {"hosts": dict(self._ewma),
                "counts": dict(self._count),
                "fleet_median": self.fleet_median(),
                "stragglers": self.stragglers()}


class BackupDispatcher:
    """Speculative duplicate execution with a deadline.

    A context manager (the pool is real OS threads; relying on GC to
    reap it leaks workers): ``with BackupDispatcher(0.5) as bd: ...``.
    ``run`` races primary against a deadline-launched backup, returns the
    first *successful* result, and cancels the loser (a not-yet-started
    loser is dropped; a running one finishes but its result is ignored).
    A worker that raises is not a winner — the race falls through to the
    other worker, and only when both raise does ``run`` re-raise the
    primary's error.
    """

    def __init__(self, deadline_seconds: float, workers: int = 2):
        self.deadline = deadline_seconds
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.cancelled_losers = 0
        self.failovers = 0

    def __enter__(self) -> "BackupDispatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _finish(self, winner, loser) -> object:
        if loser is not None and loser.cancel():
            self.cancelled_losers += 1
        return winner.result()

    def run(self, primary: Callable[[], object],
            backup: Callable[[], object]) -> object:
        f1 = self.pool.submit(primary)
        done, _ = wait([f1], timeout=self.deadline,
                       return_when=FIRST_COMPLETED)
        if done and f1.exception() is None:
            return f1.result()
        if done:                        # primary raised before the deadline
            self.failovers += 1
            f2 = self.pool.submit(backup)
            return self._finish(f2, None)
        f2 = self.pool.submit(backup)
        pending = {f1, f2}
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            winners = [f for f in done if f.exception() is None]
            if winners:
                if not pending and len(winners) == len(done) == 2:
                    # both finished between waits: keep the primary
                    return self._finish(f1, f2)
                loser = pending.pop() if pending else None
                if winners[0] is f2:
                    self.failovers += 1
                return self._finish(winners[0], loser)
            # everything done so far raised; fall through to the rest
        # both raised: surface the primary's error
        return f1.result()

    def close(self):
        self.pool.shutdown(wait=False, cancel_futures=True)
