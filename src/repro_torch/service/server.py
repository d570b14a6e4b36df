"""Async batched solve server — hardened.

Clients ``submit`` ``SolveRequest``s; a single coalescing loop
(``serve_forever``) drains the queue in windows and answers each batch:

  1. identical in-flight signatures are **deduped** — the second submit of
     a signature awaits the first's future, never enqueues a second solve;
  2. fresh signatures are answered **from the store** (through the
     ``StoreGuard`` circuit breaker: a broken store degrades the server to
     solve-without-caching instead of failing requests);
  3. the remaining misses are solved **together**: each request's DP runs
     (vectorized, cheap), then the distinct detail-solve segments of all
     requests in the batch are pooled into one ThreadPoolExecutor pass
     (``kapla.solve_many``), run off the event loop in an executor so the
     loop keeps accepting submissions;
  4. winners are written back to the store; family near-misses seed
     warm-start chains exactly like ``LocalClient``.

Resilience contract (the chaos suite's invariants):

* **liveness** — every submitted request resolves to a ``ServiceResult``
  or raises the typed ``ServiceError``; a fault never strands a future;
* **failure isolation** — an exception inside a coalesced batch solve
  re-resolves each member independently (``resolve_request``), so a
  poisoned request fails alone;
* **deadlines** — a request past its ``deadline_s`` (measured from
  submission, queue time included) degrades down the ladder
  cached -> warm -> cold -> greedy first-valid, flagged ``degraded``;
* **bounded retries** — transient solve errors retry with bounded
  backoff (``runtime.fault.RecoveryPolicy``).

The server is in-process (asyncio futures, no sockets): the unit the CLI
and tests drive, and the piece a transport layer would wrap.
"""
from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Tuple

from ..core.solver.kapla import solve_many
from ..obs import metrics, trace
from ..runtime.fault import CircuitBreaker, RecoveryPolicy
from .client import (ServiceError, ServiceResult, SolveRequest, StoreGuard,
                     attach_mesh_plan, record_degrade, record_resolution,
                     resolve_request)
from .store import ScheduleStore

_STOP = object()

_m_batch_width = metrics.histogram(
    "server_batch_width", "requests coalesced into one batch window",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
_m_queue_wait = metrics.histogram(
    "server_queue_wait_seconds",
    "submit-to-batch-processing wait per request")


class SolveServer:
    """Coalescing schedule server over one ``ScheduleStore``."""

    def __init__(self, store: Optional[ScheduleStore] = None,
                 max_workers: Optional[int] = None,
                 batch_window_s: float = 0.005,
                 warm_start: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_policy: Optional[RecoveryPolicy] = None):
        self.store = store if store is not None else ScheduleStore()
        self.guard = StoreGuard(self.store, breaker)
        self.max_workers = max_workers
        self.batch_window_s = batch_window_s
        self.warm_start = warm_start
        self.retry_policy = retry_policy
        self._queue: Optional[asyncio.Queue] = None
        self._queue_loop = None
        self._stopped_loop = None
        self._inflight: Dict[str, asyncio.Future] = {}
        # mirrored into server_events_total{event=...} (repro.obs)
        self._events = metrics.CounterGroup("server", (
            "requests", "coalesced", "batches", "solved", "degraded",
            "errors", "batch_faults", "isolated"))

    @property
    def requests(self) -> int:
        return self._events["requests"]

    @property
    def coalesced(self) -> int:
        return self._events["coalesced"]

    @property
    def batches(self) -> int:
        return self._events["batches"]

    @property
    def solved(self) -> int:
        return self._events["solved"]

    @property
    def degraded(self) -> int:
        return self._events["degraded"]

    @property
    def errors(self) -> int:
        return self._events["errors"]

    @property
    def batch_faults(self) -> int:
        return self._events["batch_faults"]

    @property
    def isolated(self) -> int:
        return self._events["isolated"]

    def _q(self) -> asyncio.Queue:
        # asyncio.Queue binds to the loop it is first awaited on; a server
        # reused across asyncio.run() calls (tests, CLI) needs a fresh
        # queue — and fresh in-flight futures — per event loop
        loop = asyncio.get_running_loop()
        if self._queue is None or self._queue_loop is not loop:
            self._queue = asyncio.Queue()
            self._queue_loop = loop
            self._inflight = {}
        return self._queue

    # -- client side ---------------------------------------------------------
    async def submit(self, req: SolveRequest) -> ServiceResult:
        """Enqueue one request and await its result.  Duplicate in-flight
        signatures share one future (and one solve).  Raises the typed
        ``ServiceError`` if the request fails terminally, or
        ``RuntimeError`` if the server's loop on this event loop has
        already stopped — the request would otherwise never be drained."""
        self._events.inc("requests")
        q = self._q()              # also rebinds in-flight map on new loops
        if self._stopped_loop is asyncio.get_running_loop():
            raise RuntimeError("SolveServer is stopped on this event loop")
        sig = req.signature()
        fut = self._inflight.get(sig)
        if fut is not None:
            self._events.inc("coalesced")
            return await self._decorated(fut, req)
        fut = asyncio.get_running_loop().create_future()
        self._inflight[sig] = fut
        await q.put((sig, req, fut, time.perf_counter()))
        try:
            return await self._decorated(fut, req)
        finally:
            if self._inflight.get(sig) is fut and fut.done():
                self._inflight.pop(sig, None)

    async def _decorated(self, fut: asyncio.Future,
                         req: SolveRequest) -> ServiceResult:
        """Await the (possibly shared) in-flight future and apply the
        per-request multi-node rung.  Coalesced requests share one
        *undecorated* result — ``nodes`` is outside the signature — so
        each awaiter attaches (or strips) its own placement on a copy;
        the plan solve is CPU work and stays off the event loop."""
        res = await asyncio.shield(fut)
        if req.nodes > 1:
            res = await asyncio.get_running_loop().run_in_executor(
                None, attach_mesh_plan, res, req)
        return res

    async def stop(self) -> None:
        await self._q().put(_STOP)

    # -- server side ---------------------------------------------------------
    async def serve_forever(self) -> None:
        """Drain-and-batch loop; returns after ``stop()``."""
        q = self._q()
        self._stopped_loop = None
        running = True
        while running:
            item = await q.get()
            if item is _STOP:
                break
            batch = [item]
            if self.batch_window_s > 0:
                await asyncio.sleep(self.batch_window_s)  # coalesce window
            while not q.empty():
                nxt = q.get_nowait()
                if nxt is _STOP:
                    running = False
                    break
                batch.append(nxt)
            await self._process(batch)
        # fail anything still queued after stop; later submits on this
        # loop raise instead of enqueueing into a drained queue
        self._stopped_loop = asyncio.get_running_loop()
        while not q.empty():
            item = q.get_nowait()
            if item is not _STOP:
                fut = item[2]
                if not fut.done():
                    fut.set_exception(RuntimeError("server stopped"))

    def _expired(self, req: SolveRequest, ts: float) -> bool:
        return req.deadline_s is not None and \
            time.perf_counter() - ts > req.deadline_s

    async def _isolate(self, sig: str, req: SolveRequest,
                       fut: asyncio.Future, ts: float) -> None:
        """Resolve one request independently (the failure-isolation /
        deadline path): full ladder, typed terminal error."""
        self._events.inc("isolated")
        loop = asyncio.get_running_loop()
        try:
            res = await loop.run_in_executor(
                None, lambda: resolve_request(
                    self.guard, req, sig=sig, policy=self.retry_policy,
                    max_workers=self.max_workers,
                    warm_start=self.warm_start, t0=ts,
                    attach_mesh=False))   # shared future: per-awaiter
        except ServiceError as e:
            self._events.inc("errors")
            if not fut.done():
                fut.set_exception(e)
        except Exception as e:          # defensive: always a typed error
            self._events.inc("errors")
            if not fut.done():
                fut.set_exception(ServiceError(
                    f"request {sig[:12]} failed: {e!r}", signature=sig,
                    reason=repr(e)))
        else:
            self._events.inc("solved")
            if res.degraded:
                self._events.inc("degraded")
            if not fut.done():
                fut.set_result(res)
        finally:
            self._inflight.pop(sig, None)

    async def _process(self, batch: List[Tuple]) -> None:
        self._events.inc("batches")
        t0 = time.perf_counter()
        _m_batch_width.observe(len(batch))
        with trace.span("service.batch", width=len(batch)):
            await self._process_batch(batch, t0)

    async def _process_batch(self, batch: List[Tuple], t0: float) -> None:
        loop = asyncio.get_running_loop()
        misses: List[Tuple[str, SolveRequest, asyncio.Future, float]] = []
        for sig, req, fut, ts in batch:
            _m_queue_wait.observe(t0 - ts)
            if fut.done():
                continue
            # store reads parse whole schedule records: keep the disk +
            # JSON work off the event loop, like the solves below.  The
            # guard swallows store faults (breaker) — a read error is a
            # miss, not a failed request.
            cached = await loop.run_in_executor(None, self.guard.get,
                                                sig, req.graph)
            if cached is not None:
                # undecorated: the future may be shared by coalesced
                # requests with different node counts — each awaiter
                # attaches its own placement (``submit``)
                seconds = time.perf_counter() - ts
                record_resolution(sig, "cached", seconds,
                                  deadline_s=req.deadline_s)
                fut.set_result(ServiceResult(
                    cached, sig, "cached", seconds))
            else:
                misses.append((sig, req, fut, ts))
        if not misses:
            return
        by_opts: Dict[Tuple, List[Tuple[str, SolveRequest,
                                        asyncio.Future, float]]] = {}
        for m in misses:
            by_opts.setdefault(m[1].options, []).append(m)
        for opt_key, group in by_opts.items():
            # requests already past their deadline skip the pooled solve
            # and go straight down the ladder (-> greedy floor)
            pooled = [m for m in group if not self._expired(m[1], m[3])]
            expired = [m for m in group if self._expired(m[1], m[3])]
            for sig, req, fut, ts in expired:
                await self._isolate(sig, req, fut, ts)
            if not pooled:
                continue
            ctxs = [await loop.run_in_executor(
                None, self.guard.warm_context, req, sig)
                if self.warm_start else None for sig, req, _, _ in pooled]
            seeds = [c[0] if c else None for c in ctxs]
            solvers = [c[1] if c else None for c in ctxs]
            sources = ["warm" if s else "cold" for s in seeds]
            items = [(req.graph, req.hw) for _, req, _, _ in pooled]
            try:
                schedules = await loop.run_in_executor(
                    None, lambda: solve_many(
                        items, max_workers=self.max_workers,
                        seed_chains=seeds, layer_solvers=solvers,
                        **dict(opt_key)))
            except Exception:
                # per-request failure isolation: one poisoned or faulted
                # request must not fail the whole coalesced batch — each
                # member re-resolves independently and only the failing
                # request's future carries its (typed) error
                self._events.inc("batch_faults")
                trace.instant("service.batch_fault", width=len(pooled))
                await asyncio.gather(*(
                    self._isolate(sig, req, fut, ts)
                    for sig, req, fut, ts in pooled))
                continue
            for (sig, req, fut, ts), sched, src in zip(pooled, schedules,
                                                       sources):
                self._events.inc("solved")
                if src == "warm" and not sched.valid:
                    # seed did not transfer: fall back to a cold solve
                    record_degrade(sig, "warm->cold",
                                   "warm seed did not transfer")
                    try:
                        sched = await loop.run_in_executor(
                            None, lambda: solve_many(
                                [(req.graph, req.hw)],
                                max_workers=self.max_workers,
                                **dict(opt_key))[0])
                    except Exception:
                        self._events.inc("solved", -1)
                        await self._isolate(sig, req, fut, ts)
                        continue
                    src = "cold"
                rec = None
                if sched.valid:
                    # record serialization + the eviction scan stay off
                    # the loop too; the guard drops the write if the
                    # store is broken (solve-without-caching)
                    rec = await loop.run_in_executor(
                        None, lambda s=sched, r=req, g=sig:
                        self.guard.put(s, r.graph, r.hw, r.opts, sig=g))
                if not fut.done():
                    seconds = time.perf_counter() - ts
                    record_resolution(sig, src, seconds,
                                      deadline_s=req.deadline_s)
                    fut.set_result(ServiceResult(
                        sched, sig, src, seconds, rec))
                self._inflight.pop(sig, None)

    def stats(self) -> Dict:
        return {**self.guard.stats(), "requests": self.requests,
                "coalesced": self.coalesced, "batches": self.batches,
                "solved": self.solved, "degraded": self.degraded,
                "errors": self.errors, "batch_faults": self.batch_faults,
                "isolated": self.isolated,
                "inflight": len(self._inflight)}


async def serve_batch(server: SolveServer,
                      reqs: List[SolveRequest]) -> List[ServiceResult]:
    """Convenience: run the server loop just long enough to answer one
    burst of concurrent requests (tests, CLI).  Raises the first
    ``ServiceError`` if any request failed terminally — use
    ``serve_batch_settled`` to collect per-request outcomes instead."""
    loop_task = asyncio.ensure_future(server.serve_forever())
    try:
        results = await asyncio.gather(*(server.submit(r) for r in reqs))
    finally:
        await server.stop()
        await loop_task
    return list(results)


async def serve_batch_settled(server: SolveServer,
                              reqs: List[SolveRequest]) -> List[object]:
    """Like ``serve_batch`` but never raises for individual requests:
    each slot is a ``ServiceResult`` or the exception that answered it
    (liveness: every request gets exactly one of the two)."""
    loop_task = asyncio.ensure_future(server.serve_forever())
    try:
        results = await asyncio.gather(
            *(server.submit(r) for r in reqs), return_exceptions=True)
    finally:
        await server.stop()
        await loop_task
    return list(results)


__all__ = ["SolveServer", "serve_batch", "serve_batch_settled"]
