"""Deterministic, seeded fault injection across the schedule service.

The chaos harness for the solve -> store -> autotune path: a
``FaultPlan`` names per-site fault specs (rate, kind, delay) and a seed;
a ``FaultInjector`` turns the plan into a *replayable* fault schedule.
Decisions are keyed, not sequenced: whether occurrence ``n`` of
``(site, key)`` faults depends only on ``(seed, site, key, n)``, so the
same plan produces the same schedule regardless of thread interleaving
(the solver's segment pool and the server's executor hops reorder calls
freely between runs).

Sites instrumented in the production code:

    store.read        ScheduleStore record reads  (kinds: error, corrupt)
    store.write       ScheduleStore.put           (kinds: error, corrupt)
    store.index       index.jsonl appends         (kinds: error, corrupt)
    solve.segment     kapla.solve_segment         (kinds: error, slow)
    autotune.measure  autotune candidate runs     (kinds: error, slow, nan)
    node.crash        meshexec worker nodes       (kinds: error -> the node
                      dies permanently, NodeFailure)
    node.hang         meshexec worker nodes       (kinds: slow -> the task
                      blocks ``delay_s``, tripping the hang deadline)
    node.slow         meshexec worker nodes       (kinds: slow -> the task
                      stretches to ``factor`` x its real runtime)

Node-site keys are ``"node<id>"``, so ``FaultSpec.match`` pins a fault
to one node and ``FaultSpec.after`` fires it only from occurrence
``after`` on — together they script "kill node 1 on its 3rd task"
deterministically.

``corrupt`` on reads truncates the on-disk record *before* the read, so
the store's real checksum/quarantine machinery is exercised, not mocked;
``corrupt`` on writes leaves a torn record/index tail, simulating a
writer killed mid-``put``.  ``error`` raises ``InjectedFault`` (transient
by construction: a retry draws fresh randomness).  ``slow`` sleeps
``delay_s`` at the site.  ``nan`` asks the call site to poison its
measurement.

Activation is a process-global context manager (``inject``), so worker
threads spawned inside the scope see the injector; call sites pay one
global read + ``None`` check when no injector is active.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Mapping, Optional, Tuple

from ..obs import metrics, trace

_m_faults = metrics.counter("faults_injected_total",
                            "chaos faults fired, by site", ("site",))

#: sites the production code instruments (``FaultPlan`` rejects others)
SITES = ("store.read", "store.write", "store.index",
         "solve.segment", "autotune.measure",
         "node.crash", "node.hang", "node.slow")

KINDS = ("error", "corrupt", "slow", "nan")


class InjectedFault(RuntimeError):
    """A fault produced by the injection harness.  Transient by
    construction — retrying the operation draws fresh randomness."""

    def __init__(self, site: str, key: str = "", occurrence: int = 0):
        super().__init__(f"injected fault at {site} "
                         f"(key={key!r}, occurrence={occurrence})")
        self.site = site
        self.key = key
        self.occurrence = occurrence


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One site's fault behaviour: ``rate`` is the per-occurrence fault
    probability; ``delay_s`` is the sleep for ``slow`` faults.

    Scripting filters (both deterministic, for chaos scenarios that
    target a specific victim at a specific point):

    * ``match``  — fault only keys starting with this prefix (e.g.
      ``"node1"``); non-matching keys still advance their occurrence
      counters, so the schedule for other keys is unchanged;
    * ``after``  — fault only from occurrence ``after`` on (0-based:
      ``after=2`` spares the first two occurrences);
    * ``factor`` — multiplicative slowdown for sites that implement
      proportional ``slow`` faults (``node.slow`` stretches a task to
      ``factor`` x its measured runtime; 0 means site default).
    """

    rate: float
    kind: str = "error"
    delay_s: float = 0.0
    after: int = 0
    match: str = ""
    factor: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")
        if self.after < 0:
            raise ValueError(f"after {self.after} must be >= 0")
        if self.factor < 0:
            raise ValueError(f"factor {self.factor} must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of per-site faults (``{site: FaultSpec}``)."""

    seed: int = 0
    specs: Tuple[Tuple[str, FaultSpec], ...] = ()

    @staticmethod
    def make(seed: int = 0,
             specs: Optional[Mapping[str, FaultSpec]] = None) -> "FaultPlan":
        specs = dict(specs or {})
        for site in specs:
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"one of {SITES}")
        return FaultPlan(seed, tuple(sorted(specs.items())))

    def spec(self, site: str) -> Optional[FaultSpec]:
        for s, spec in self.specs:
            if s == site:
                return spec
        return None


class FaultInjector:
    """Executes a ``FaultPlan``: deterministic per-(site, key, occurrence)
    decisions, a fired-fault log for replay assertions, and per-site
    counters.  Thread-safe; decisions do not depend on call order."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._counts: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()
        #: (site, key, occurrence, kind) for every fault that fired
        self.log: List[Tuple[str, str, int, str]] = []
        self.fired: Dict[str, int] = {}
        self.checked: Dict[str, int] = {}

    def decide(self, site: str, key: str = "") -> Optional[FaultSpec]:
        """The spec if occurrence ``n`` of ``(site, key)`` faults, else
        None.  Advances the per-key occurrence counter either way."""
        spec = self.plan.spec(site)
        with self._lock:
            self.checked[site] = self.checked.get(site, 0) + 1
            n = self._counts.get((site, key), 0)
            self._counts[(site, key)] = n + 1
        if spec is None or spec.rate <= 0.0:
            return None
        if spec.match and not key.startswith(spec.match):
            return None
        if n < spec.after:
            return None
        rng = random.Random(f"{self.plan.seed}:{site}:{key}:{n}")
        if rng.random() >= spec.rate:
            return None
        with self._lock:
            self.fired[site] = self.fired.get(site, 0) + 1
            self.log.append((site, key, n, spec.kind))
        _m_faults.inc(site=site)
        trace.instant("fault.injected", site=site, key=key,
                      occurrence=n, kind=spec.kind)
        return spec

    def fault(self, site: str, key: str = "") -> Optional[FaultSpec]:
        """Decide and act: raise ``InjectedFault`` for ``error``, sleep
        for ``slow``.  ``corrupt``/``nan`` specs are returned for the
        call site to implement (they need site-specific state)."""
        spec = self.decide(site, key)
        if spec is None:
            return None
        if spec.kind == "slow":
            time.sleep(spec.delay_s)
            return spec
        if spec.kind == "error":
            n = self._counts.get((site, key), 1) - 1
            raise InjectedFault(site, key, n)
        return spec

    def summary(self) -> Dict:
        return {"seed": self.plan.seed,
                "checked": dict(self.checked),
                "fired": dict(self.fired),
                "n_faults": len(self.log)}


# -- activation --------------------------------------------------------------
# process-global (not a contextvar): the solver's ThreadPoolExecutor
# workers must see the injector installed by the test/bench main thread.
_active: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _active


@contextmanager
def inject(plan: FaultPlan):
    """Install an injector for ``plan``; yields it for log inspection."""
    global _active
    inj = FaultInjector(plan)
    prev = _active
    _active = inj
    try:
        yield inj
    finally:
        _active = prev


def maybe_fault(site: str, key: str = "") -> Optional[FaultSpec]:
    """No-op unless an injector is active (the production-code hook)."""
    inj = _active
    if inj is None:
        return None
    return inj.fault(site, key)


def truncate_file(path: str, keep_frac: float = 0.5) -> None:
    """Corrupt an on-disk file the way a torn write does: keep a prefix.
    Used by the ``corrupt`` fault kinds; silent on missing files."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, int(size * keep_frac)))
    except OSError:
        pass


__all__ = ["SITES", "KINDS", "InjectedFault", "FaultSpec", "FaultPlan",
           "FaultInjector", "inject", "active", "maybe_fault",
           "truncate_file"]
