"""Client-side types + the synchronous in-process client.

``SolveRequest`` names one solve: a graph, a hardware template, the
normalized solver options and an optional per-request deadline.
``LocalClient`` serves requests directly — store lookup, warm-start
near-miss, cold solve — without an event loop, sharing the exact answer
path of the async ``SolveServer``: both walk the same **degradation
ladder** through ``resolve_request``:

    cached  ->  warm  ->  cold  ->  greedy (first-valid, ``degraded``)

with bounded-backoff retries on transient solve errors
(``runtime.fault.RecoveryPolicy``) and circuit-broken store access
(``StoreGuard``): a broken store degrades the service to
solve-without-caching instead of failing requests.  A request that
exhausts the whole ladder raises the typed ``ServiceError`` — the
service's liveness contract is *result or typed error*, never a hang or
an anonymous crash.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.solver.kapla import (NetworkSchedule, seed_chains_from, solve,
                                 solve_greedy, solve_many,
                                 warm_layer_solver)
from ..hw.template import HWTemplate
from ..obs import metrics, trace
from ..runtime.fault import CircuitBreaker, NodeFailure, RecoveryPolicy
from ..runtime.inject import InjectedFault
from ..workloads.layers import LayerGraph
from .signature import family_signature, schedule_signature, solver_options
from .store import ScheduleStore, StoreError, StoreRecord

#: solve errors worth retrying (fresh attempt may succeed); anything else
#: is treated as a poisoned request and drops straight to the greedy floor
TRANSIENT_ERRORS = (InjectedFault, NodeFailure, OSError, TimeoutError)

#: default retry policy for service solves: cheap, bounded, fast backoff —
#: KAPLA solves are ~sub-second, so retrying beats queueing behind a hang
DEFAULT_RETRY_POLICY = RecoveryPolicy(max_retries=2, backoff_seconds=0.02,
                                      backoff_factor=2.0, max_backoff=0.5)


# -- telemetry (repro.obs): every answer path reports through these ----------
_m_requests = metrics.counter(
    "service_requests_total",
    "requests answered, by resolved ladder rung", ("source",))
_m_request_seconds = metrics.histogram(
    "service_request_seconds",
    "service-side wall clock per answer, by resolved rung", ("source",))
_m_degrade = metrics.counter(
    "service_degrade_total",
    "degradation-ladder drops, by rung transition", ("rung",))
_m_slack = metrics.histogram(
    "service_deadline_slack_seconds",
    "deadline minus service time for deadline-carrying requests")

#: generic per-rung reasons for ``service.resolved`` events when no
#: specific fault forced the rung
_RUNG_REASONS = {"cached": "store hit", "warm": "family near-miss seed",
                 "cold": "full solve", "greedy": "ladder floor",
                 "error": "ladder exhausted"}


def record_resolution(sig: str, source: str, seconds: float,
                      degraded: bool = False,
                      reason: Optional[str] = None,
                      deadline_s: Optional[float] = None) -> None:
    """Publish one answered request: rung counter, latency histogram,
    deadline slack, and a ``service.resolved`` instant in the trace.
    The single funnel for every answer path — the ladder, the server's
    cached/batched paths and ``LocalClient.solve_batch``."""
    _m_requests.inc(source=source)
    _m_request_seconds.observe(seconds, source=source)
    if deadline_s is not None:
        _m_slack.observe(deadline_s - seconds)
    trace.instant("service.resolved", sig=sig[:12], source=source,
                  degraded=bool(degraded),
                  reason=reason or _RUNG_REASONS.get(source, ""))


def record_degrade(sig: str, rung: str, reason: str) -> None:
    """Publish one ladder drop (warm seed failed, transient retry,
    greedy floor, mesh fallback) with its reason."""
    _m_degrade.inc(rung=rung)
    trace.instant("service.degrade", sig=sig[:12], rung=rung,
                  reason=reason)


class ServiceError(RuntimeError):
    """Typed terminal failure for one request: the ladder was exhausted
    (or the request was poisoned beyond even the greedy floor)."""

    def __init__(self, msg: str, signature: str = "", reason: str = "",
                 attempts: int = 0):
        super().__init__(msg)
        self.signature = signature
        self.reason = reason
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One schedule request; ``options`` are ``signature.solver_options``
    overrides (k_s, max_seg_len, objective).  ``deadline_s`` (never part
    of the signature) bounds the service time budget: a request past its
    deadline degrades to the greedy floor instead of queueing a full
    solve.  ``nodes`` (also outside the signature — the single-node
    schedule is the shared, cacheable artifact) asks for a multi-node
    placement of the answer: the result carries a ``MultiNodePlan`` or,
    if partitioning fails, falls back one ladder rung to single-node,
    flagged degraded."""

    graph: LayerGraph
    hw: HWTemplate
    options: Tuple[Tuple[str, object], ...] = ()
    deadline_s: Optional[float] = None
    nodes: int = 1

    @staticmethod
    def make(graph: LayerGraph, hw: HWTemplate,
             deadline_s: Optional[float] = None, nodes: int = 1,
             **options) -> "SolveRequest":
        opts = solver_options(**options)
        return SolveRequest(graph, hw, tuple(sorted(opts.items())),
                            deadline_s, nodes)

    @property
    def opts(self) -> Dict:
        return dict(self.options)

    def signature(self) -> str:
        return schedule_signature(self.graph, self.hw, self.opts)

    def family(self) -> str:
        return family_signature(self.graph, self.hw, self.opts)


@dataclasses.dataclass
class ServiceResult:
    """A served schedule plus provenance: ``source`` is ``"cached"``
    (store hit), ``"warm"`` (near-miss-seeded solve), ``"cold"`` (full
    solve) or ``"greedy"`` (first-valid floor); ``degraded`` marks
    answers below the request's normal quality (greedy floor);
    ``error`` carries the fault that forced the degradation, if any;
    ``seconds`` is the service-side wall clock for this answer."""

    schedule: NetworkSchedule
    signature: str
    source: str
    seconds: float
    record: Optional[StoreRecord] = None
    degraded: bool = False
    error: Optional[str] = None
    #: multi-node placement (``multinode.MultiNodePlan``) when the
    #: request asked for ``nodes > 1`` and partitioning succeeded
    mesh_plan: Optional[object] = None
    nodes: int = 1


def attach_mesh_plan(res: ServiceResult,
                     req: SolveRequest) -> ServiceResult:
    """The service's multi-node rung: a request with ``nodes > 1`` gets
    a ``MultiNodePlan`` attached to its result (the cached/solved
    single-node schedule is reused — only the placement is computed).
    A failed partition falls back one rung to single-node, flagged
    ``degraded`` with the fault recorded — never a failed request.

    Never mutates ``res``: decoration happens on a copy.  Coalesced
    requests *share* one undecorated result (``nodes`` is outside the
    signature), so each awaiter decorates its own view — a ``nodes=1``
    request coalesced onto a ``nodes=4`` solve must not see the other
    request's placement, and vice versa."""
    if res.schedule is None or not res.schedule.valid:
        return res
    if req.nodes <= 1:
        if res.mesh_plan is None and res.nodes == 1:
            return res
        return dataclasses.replace(res, mesh_plan=None, nodes=1)
    from ..core.solver import multinode
    try:
        plan = multinode.plan_multinode(
            res.schedule, req.graph, req.hw,
            multinode.NodeMesh(nodes=req.nodes))
        return dataclasses.replace(res, mesh_plan=plan, nodes=req.nodes)
    except Exception as e:
        err = res.error if res.error is not None else \
            f"multi-node partition failed ({e!r}); single-node fallback"
        record_degrade(res.signature, "mesh->single", repr(e))
        return dataclasses.replace(res, mesh_plan=None, nodes=1,
                                   degraded=True, error=err)


class StoreGuard:
    """Circuit-broken store access.  ``StoreError``s trip the breaker;
    while it is open the store is skipped entirely (reads miss, writes
    drop) so a broken store degrades the service to solve-without-caching
    instead of failing every request."""

    def __init__(self, store: ScheduleStore,
                 breaker: Optional[CircuitBreaker] = None):
        self.store = store
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._events = metrics.CounterGroup("store_guard",
                                            ("errors", "skipped"))

    @property
    def errors(self) -> int:
        return self._events["errors"]

    @property
    def skipped(self) -> int:
        return self._events["skipped"]

    def _guard(self, fn, *args, default=None, **kwargs):
        if not self.breaker.allow():
            self._events.inc("skipped")
            return default
        try:
            out = fn(*args, **kwargs)
        except StoreError:
            self._events.inc("errors")
            self.breaker.record_failure()
            return default
        self.breaker.record_success()
        return out

    def get(self, sig: str, graph: Optional[LayerGraph] = None
            ) -> Optional[NetworkSchedule]:
        return self._guard(self.store.get, sig, graph)

    def put(self, schedule: NetworkSchedule, graph: LayerGraph,
            hw: HWTemplate, options=None, sig: Optional[str] = None
            ) -> Optional[StoreRecord]:
        return self._guard(self.store.put, schedule, graph, hw, options,
                           sig=sig)

    def warm_context(self, req: "SolveRequest", sig: str):
        return self._guard(warm_context, self.store, req, sig)

    def stats(self) -> Dict:
        return {**self.store.stats(), "store_errors": self.errors,
                "store_skipped": self.skipped,
                "breaker": self.breaker.stats()}


def warm_context(store: ScheduleStore, req: SolveRequest, sig: str):
    """(seed chains, transferring layer solver, source record) from the
    nearest family record in ``store``, or None.  The solver re-batches
    the record's stored intra-layer schemes to this graph's batch
    (positional name map — signatures never see names) so warm solves
    *evaluate* instead of re-solving each layer.  The single warm-start
    derivation shared by ``LocalClient``, ``SolveServer`` and the CLI."""
    for rec in store.warm_records(req.family(), exclude=(sig,)):
        sched = NetworkSchedule.from_json(rec.schedule)
        seeds = seed_chains_from(sched, req.graph)
        if not seeds:
            continue
        order = rec.layer_order or list(sched.layer_schemes)
        stored = {l.name: sched.layer_schemes[old]
                  for old, l in zip(order, req.graph.layers)
                  if old in sched.layer_schemes}
        return seeds, warm_layer_solver(stored), rec
    return None


def resolve_request(guard: StoreGuard, req: SolveRequest,
                    sig: Optional[str] = None,
                    policy: Optional[RecoveryPolicy] = None,
                    max_workers: Optional[int] = None,
                    warm_start: bool = True,
                    t0: Optional[float] = None,
                    sleep=time.sleep,
                    attach_mesh: bool = True) -> ServiceResult:
    """Answer one request down the degradation ladder.

    cached -> warm -> cold (with bounded-backoff retries on transient
    errors) -> greedy first-valid (flagged ``degraded``).  ``t0`` is the
    request's submit time (``time.perf_counter`` clock) — deadlines are
    measured from submission, so queue time counts against the budget.
    Raises ``ServiceError`` when even the greedy floor fails.

    ``attach_mesh=False`` skips the multi-node rung — callers whose
    result may be *shared* across coalesced requests (the async server)
    keep it undecorated and attach per awaiter instead.
    """
    t0 = time.perf_counter() if t0 is None else t0
    sig = sig if sig is not None else req.signature()
    with trace.span("service.request", sig=sig[:12],
                    graph=req.graph.name) as sp:
        try:
            res = _resolve_ladder(guard, req, sig, policy, max_workers,
                                  warm_start, t0, sleep, attach_mesh)
        except ServiceError as e:
            sp.set(source="error")
            record_resolution(sig, "error", time.perf_counter() - t0,
                              degraded=True, reason=e.reason,
                              deadline_s=req.deadline_s)
            raise
        sp.set(source=res.source, degraded=res.degraded)
        record_resolution(sig, res.source, res.seconds,
                          degraded=res.degraded, reason=res.error,
                          deadline_s=req.deadline_s)
        return res


def _resolve_ladder(guard: StoreGuard, req: SolveRequest, sig: str,
                    policy: Optional[RecoveryPolicy],
                    max_workers: Optional[int], warm_start: bool,
                    t0: float, sleep, attach_mesh: bool) -> ServiceResult:
    policy = policy if policy is not None else DEFAULT_RETRY_POLICY
    deadline_at = None if req.deadline_s is None else t0 + req.deadline_s
    decorate = attach_mesh_plan if attach_mesh else (lambda r, _: r)

    def expired() -> bool:
        return deadline_at is not None and time.perf_counter() > deadline_at

    cached = guard.get(sig, req.graph)
    if cached is not None:
        return decorate(
            ServiceResult(cached, sig, "cached",
                          time.perf_counter() - t0), req)

    attempts = 0
    backoff = policy.backoff_seconds
    last_err: Optional[BaseException] = None
    while not expired() and attempts <= policy.max_retries:
        attempts += 1
        try:
            ctx = guard.warm_context(req, sig) if warm_start else None
            src = "cold"
            sched = None
            if ctx is not None:
                seeds, solver, _ = ctx
                sched = solve(req.graph, req.hw, max_workers=max_workers,
                              seed_chains=seeds, use_dp=False,
                              layer_solver=solver, **req.opts)
                src = "warm"
                if not sched.valid:
                    sched = None        # seed did not transfer: cold
                    record_degrade(sig, "warm->cold",
                                   "warm seed did not transfer")
            if sched is None:
                src = "cold"
                sched = solve(req.graph, req.hw, max_workers=max_workers,
                              **req.opts)
            rec = guard.put(sched, req.graph, req.hw, req.opts, sig=sig) \
                if sched.valid else None
            return decorate(
                ServiceResult(sched, sig, src,
                              time.perf_counter() - t0, rec), req)
        except TRANSIENT_ERRORS as e:
            last_err = e
            if attempts > policy.max_retries or expired():
                break
            record_degrade(sig, "retry", repr(e))
            sleep(min(backoff, policy.max_backoff))
            backoff *= policy.backoff_factor
        except Exception as e:          # poisoned request: no retry value
            last_err = e
            break

    # ladder floor: first-valid greedy, flagged degraded
    record_degrade(sig, "greedy",
                   repr(last_err) if last_err is not None
                   else "deadline expired")
    try:
        sched = solve_greedy(req.graph, req.hw, max_workers=max_workers,
                             **req.opts)
        if sched.valid:
            return decorate(ServiceResult(
                sched, sig, "greedy", time.perf_counter() - t0,
                degraded=True,
                error=None if last_err is None else repr(last_err)), req)
        if last_err is None:
            # nothing faulted — the request has no feasible schedule at
            # all; answer with the invalid schedule like a plain solve
            return ServiceResult(sched, sig, "cold",
                                 time.perf_counter() - t0)
    except Exception as e:
        last_err = last_err if last_err is not None else e
    raise ServiceError(
        f"request {sig[:12]} failed after {attempts} attempt(s): "
        f"{last_err!r}", signature=sig, reason=repr(last_err),
        attempts=attempts)


class LocalClient:
    """Synchronous in-process schedule client over one ``ScheduleStore``.

    ``solve`` answers one request down the full degradation ladder;
    ``solve_batch`` coalesces a list — identical signatures are deduped
    and the distinct misses' segments are pooled into one
    ThreadPoolExecutor pass (``kapla.solve_many``); a fault inside the
    pooled solve isolates to per-request resolution so one poisoned
    request cannot fail its batch."""

    def __init__(self, store: Optional[ScheduleStore] = None,
                 max_workers: Optional[int] = None,
                 warm_start: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_policy: Optional[RecoveryPolicy] = None):
        self.store = store if store is not None else ScheduleStore()
        self.guard = StoreGuard(self.store, breaker)
        self.max_workers = max_workers
        self.warm_start = warm_start
        self.retry_policy = retry_policy
        self._events = metrics.CounterGroup("client",
                                            ("degraded", "errors"))

    @property
    def degraded(self) -> int:
        return self._events["degraded"]

    @property
    def errors(self) -> int:
        return self._events["errors"]

    # -- single request ------------------------------------------------------
    def solve(self, graph: LayerGraph, hw: HWTemplate,
              deadline_s: Optional[float] = None, nodes: int = 1,
              **options) -> ServiceResult:
        req = SolveRequest.make(graph, hw, deadline_s=deadline_s,
                                nodes=nodes, **options)
        return self.solve_request(req)

    def solve_request(self, req: SolveRequest) -> ServiceResult:
        try:
            res = resolve_request(self.guard, req,
                                  policy=self.retry_policy,
                                  max_workers=self.max_workers,
                                  warm_start=self.warm_start)
        except ServiceError:
            self._events.inc("errors")
            raise
        if res.degraded:
            self._events.inc("degraded")
        return res

    # -- batched requests ----------------------------------------------------
    def solve_batch(self, reqs: Sequence[SolveRequest]
                    ) -> List[ServiceResult]:
        """Answer a batch: dedupe identical signatures, answer fresh ones
        from the store, and solve the distinct misses *together* so their
        segments share one thread pool (the server's coalescing path,
        minus the event loop).  A fault inside the pooled solve falls
        back to per-request isolated resolution; a request that fails
        even isolated resolution gets a ``ServiceResult`` carrying the
        typed error string rather than poisoning its neighbours."""
        t0 = time.perf_counter()
        sigs = [r.signature() for r in reqs]
        results: Dict[str, ServiceResult] = {}
        miss_sigs: List[str] = []
        miss_reqs: List[SolveRequest] = []
        miss_set: set = set()
        for sig, req in zip(sigs, reqs):
            if sig in results or sig in miss_set:
                continue
            cached = self.guard.get(sig, req.graph)
            if cached is not None:
                results[sig] = ServiceResult(
                    cached, sig, "cached", time.perf_counter() - t0)
            else:
                miss_set.add(sig)
                miss_sigs.append(sig)
                miss_reqs.append(req)
        if miss_reqs:
            by_opts: Dict[Tuple, List[int]] = {}
            for i, req in enumerate(miss_reqs):
                by_opts.setdefault(req.options, []).append(i)
            for opt_key, idxs in by_opts.items():
                group = [miss_reqs[i] for i in idxs]
                ctxs = [self._warm_context(r, s)
                        for r, s in zip(group,
                                        (miss_sigs[i] for i in idxs))]
                seeds = [c[0] if c else None for c in ctxs]
                solvers = [c[1] if c else None for c in ctxs]
                try:
                    res = solve_many([(r.graph, r.hw) for r in group],
                                     max_workers=self.max_workers,
                                     seed_chains=seeds,
                                     layer_solvers=solvers,
                                     **dict(opt_key))
                except Exception:
                    # pooled solve faulted: isolate per request so one
                    # poisoned request fails alone
                    for i in idxs:
                        results[miss_sigs[i]] = self._isolated(
                            miss_reqs[i], miss_sigs[i], t0)
                    continue
                for i, sched, seed in zip(idxs, res, seeds):
                    req, sig = miss_reqs[i], miss_sigs[i]
                    src = "warm" if seed else "cold"
                    if seed and not sched.valid:
                        # a warm seed that does not transfer falls back
                        # to a full cold solve
                        try:
                            sched = solve(req.graph, req.hw,
                                          max_workers=self.max_workers,
                                          **req.opts)
                        except Exception:
                            results[sig] = self._isolated(req, sig, t0)
                            continue
                        src = "cold"
                    rec = self.guard.put(sched, req.graph, req.hw,
                                         req.opts, sig=sig) \
                        if sched.valid else None
                    results[sig] = ServiceResult(
                        sched, sig, src, time.perf_counter() - t0, rec)
        # deduped signatures share one undecorated result; the mesh rung
        # is per *request* (nodes is outside the signature), so each
        # request decorates its own view here
        return [attach_mesh_plan(results[sig], req)
                for sig, req in zip(sigs, reqs)]

    # -- helpers -------------------------------------------------------------
    def _isolated(self, req: SolveRequest, sig: str,
                  t0: float) -> ServiceResult:
        try:
            # shared by signature in the batch results: keep undecorated
            # (the mesh rung runs per request at the end of solve_batch)
            res = resolve_request(self.guard, req, sig=sig,
                                  policy=self.retry_policy,
                                  max_workers=self.max_workers,
                                  warm_start=self.warm_start, t0=t0,
                                  attach_mesh=False)
        except ServiceError as e:
            self._events.inc("errors")
            from ..core.solver.kapla import _invalid_schedule
            return ServiceResult(
                _invalid_schedule(req.graph, None), sig, "error",
                time.perf_counter() - t0, degraded=True, error=str(e))
        if res.degraded:
            self._events.inc("degraded")
        return res

    def _warm_context(self, req: SolveRequest, sig: str):
        if not self.warm_start:
            return None
        return self.guard.warm_context(req, sig)

    def stats(self) -> Dict:
        return {**self.guard.stats(), "degraded": self.degraded,
                "errors": self.errors}


__all__ = ["SolveRequest", "ServiceResult", "ServiceError", "StoreGuard",
           "LocalClient", "warm_context", "resolve_request",
           "attach_mesh_plan", "TRANSIENT_ERRORS", "DEFAULT_RETRY_POLICY"]
