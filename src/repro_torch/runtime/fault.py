"""Fault tolerance for pod-scale runs.

At thousands of nodes, failures are routine.  The framework's contract:

1. every step is restartable from the last atomic checkpoint
   (checkpoint/ckpt.py);
2. a failure raises through ``run_with_recovery`` which restores and
   retries with bounded backoff;
3. on *permanent* capacity loss, ``ElasticPlanner`` re-solves the mesh for
   the surviving device count and the autoshard planner produces fresh
   shardings — checkpoints are mesh-agnostic (host npz + respec on load).

This container has one real device, so the multi-host behaviours are
exercised with simulated failure injectors in tests/test_runtime.py.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple


class NodeFailure(RuntimeError):
    """Raised by the step runner when a device/host is lost."""

    def __init__(self, msg: str, lost_devices: int = 1,
                 permanent: bool = False):
        super().__init__(msg)
        self.lost_devices = lost_devices
        self.permanent = permanent


@dataclasses.dataclass
class RecoveryPolicy:
    max_retries: int = 5
    backoff_seconds: float = 1.0
    backoff_factor: float = 2.0
    max_backoff: float = 60.0


@dataclasses.dataclass
class RecoveryStats:
    restarts: int = 0
    last_error: Optional[str] = None
    reshards: int = 0


def run_with_recovery(step_fn: Callable[[int], None], start_step: int,
                      num_steps: int,
                      restore_fn: Callable[[], int],
                      policy: Optional[RecoveryPolicy] = None,
                      on_permanent_loss: Optional[Callable[[int], None]]
                      = None,
                      sleep=time.sleep) -> RecoveryStats:
    """Drive ``step_fn(step)`` for ``num_steps``, restoring via
    ``restore_fn() -> resume_step`` after transient failures."""
    # default constructed per call: a shared module-level instance would
    # leak one caller's tweaks into every later call
    policy = policy if policy is not None else RecoveryPolicy()
    stats = RecoveryStats()
    step = start_step
    retries = 0
    backoff = policy.backoff_seconds
    while step < start_step + num_steps:
        try:
            step_fn(step)
            step += 1
            retries = 0
            backoff = policy.backoff_seconds
        except NodeFailure as e:
            stats.last_error = str(e)
            if e.permanent and on_permanent_loss is not None:
                on_permanent_loss(e.lost_devices)
                stats.reshards += 1
            retries += 1
            if retries > policy.max_retries:
                raise
            sleep(min(backoff, policy.max_backoff))
            backoff *= policy.backoff_factor
            step = restore_fn()
            stats.restarts += 1
    return stats


@dataclasses.dataclass
class ElasticPlanner:
    """Choose a new (pods, data, model) mesh after capacity change.

    Keeps the model axis intact (tensor-parallel groups must be complete;
    losing one chip of a TP group kills the group) and shrinks the data
    axis — the same conservative validity logic the KAPLA inter-layer
    pruner uses: never produce a mesh the model cannot run on.
    """

    model_axis: int = 16
    min_data: int = 1

    def plan(self, surviving_chips: int) -> Tuple[int, int]:
        """-> (data_axis, model_axis); raises if nothing valid remains."""
        groups = surviving_chips // self.model_axis
        if groups < self.min_data:
            raise NodeFailure(
                f"only {surviving_chips} chips left; cannot form a "
                f"model-parallel group of {self.model_axis}",
                permanent=True)
        # largest power-of-two data axis <= surviving groups keeps global
        # batch divisibility and collective trees balanced
        data = 2 ** int(math.log2(groups))
        return data, self.model_axis

    def plan_nodes(self, surviving_nodes: int) -> int:
        """Node-mesh variant of ``plan``: segment-chain parts tolerate
        any node count (no collective trees to balance), so every
        survivor stays in service — but below ``min_data`` nodes the
        mesh cannot serve at all and the caller must fall back."""
        if surviving_nodes < self.min_data:
            raise NodeFailure(
                f"only {surviving_nodes} node(s) left; mesh needs at "
                f"least {self.min_data}", permanent=True)
        return surviving_nodes

    def batch_for(self, global_batch: int, data_axis: int,
                  old_data_axis: int) -> int:
        """Rescale the global batch proportionally (keeps per-replica
        microbatch — and therefore convergence behaviour — unchanged)."""
        per_replica = global_batch // old_data_axis
        return per_replica * data_axis


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open -> half-open).

    ``threshold`` consecutive failures open the circuit; while open,
    ``allow()`` is False so callers skip the protected dependency (the
    schedule service degrades to solve-without-caching when the store
    trips it).  After ``cooldown_s`` one probe call is allowed
    (half-open); its success closes the circuit, its failure re-opens.
    Thread-safe — the server touches it from executor threads.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._lock = threading.Lock()
        self.opens = 0

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self.clock() - self._opened_at >= self.cooldown_s:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if self.clock() - self._opened_at < self.cooldown_s:
                return False
            if self._probing:                   # one probe at a time
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self.threshold:
                if self._opened_at is None:
                    self.opens += 1
                self._opened_at = self.clock()

    def stats(self) -> dict:
        return {"state": self.state, "opens": self.opens,
                "consecutive_failures": self._failures}


class StepHeartbeat:
    """Deadline monitor: a step that exceeds ``deadline_seconds`` is
    declared failed (hung collective / dead host) so recovery kicks in."""

    def __init__(self, deadline_seconds: float, clock=time.monotonic):
        self.deadline = deadline_seconds
        self.clock = clock
        self._armed_at: Optional[float] = None

    def arm(self):
        self._armed_at = self.clock()

    def check(self):
        if self._armed_at is None:
            return
        dt = self.clock() - self._armed_at
        if dt > self.deadline:
            raise NodeFailure(
                f"step heartbeat expired after {dt:.1f}s "
                f"(deadline {self.deadline}s)", permanent=False)

    def disarm(self):
        self._armed_at = None
