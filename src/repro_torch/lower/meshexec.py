"""Execute a ``MultiNodePlan`` over a pool of worker nodes — resiliently.

The port of ``repro/lower/meshexec.py``.  The network tier (``netexec``)
chains every kernel on one device; this module spreads that chain over a
mesh of worker "nodes".  Here each node is a single-worker thread over the
one card — but the interfaces (``NodePool.submit/kill/alive``,
``SegmentTask``) are the mesh-ready seams a real multi-node transport
would implement.

Execution walks the plan's chain segments in order; each segment runs
on one node of its assigned part (replicated parts round-robin
requests across their node group — every replica runs the identical
full-batch kernels, so results are bit-identical wherever a request
lands).  Segment-*boundary* tensors are host numpy (``netplan``'s DRAM
analogue), which makes each boundary a natural **checkpoint**: the
request's ``state`` dict after segment *i* is exactly what segment
*i+1* needs, so a failed dispatch replays from the last completed
boundary instead of restarting the request.  On the card every boundary
is therefore one device-to-host copy (``.cpu().numpy()``) and, where a
later segment reads it, one copy back.

A task runs at one of two tiers (``build_segment_tasks``):

  * **per-layer**: the segment's kernels launched from Python
    (``netexec._layer_fn``), each call on fresh device tensors;
  * **fused** (``backend="compiled"``): the segment's CUDA graph
    (``FusedNetwork.run_segment``); every segment is captured once, on
    the thread that builds the tasks, so node threads only copy in,
    replay and copy out, under the network's lock.

The node-failure ladder (each rung a cheaper recovery than the next):

  1. **speculate**   — ``StragglerDetector`` flags nodes whose EWMA
     task latency exceeds ``factor`` x the fleet median;
  2. **re-dispatch** — a flagged node's work is raced through
     ``BackupDispatcher`` against a healthy peer; first success wins;
  3. **re-partition** — a ``NodeFailure`` (crash, or a hang past the
     task deadline, which drains the node) triggers
     ``ElasticPlanner.plan_nodes`` + ``multinode.repartition``:
     surviving parts keep their assignments, only the dead node's
     segments are re-placed (the dirty set), and the straggler history
     of the drained node is ``forget``-ten;
  4. **single-node fallback** — below ``min_nodes`` survivors the
     executor runs segments inline on the driver, flagged degraded.

Faults are injected at the ``node.crash`` / ``node.hang`` /
``node.slow`` sites (``runtime.inject``), so chaos runs are seeded and
replayable.  A node drained for hanging may wake later and run the task
it held: its result goes to a future nobody reads, its per-layer tensors
are its own and a fused replay holds the network's lock, so it cannot
change another request's outputs.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.solver.multinode import MultiNodePlan, repartition
from ..kernels.backend import resolve_device
from ..obs import metrics, trace
from ..runtime import inject
from ..runtime.fault import ElasticPlanner, NodeFailure
from ..runtime.straggler import BackupDispatcher, StragglerDetector
from .exec import as_tensor
from .netexec import _check_executable, _layer_fn
from .netplan import NetworkPlan

#: the reference's backend names; ``"compiled"`` selects the fused tier
BACKENDS = ("interpret", "pallas", "compiled")

# -- telemetry (repro_torch.obs) ---------------------------------------------
_m_alive = metrics.gauge("mesh_alive_nodes",
                         "live worker nodes in the pool")
_m_recovery = metrics.histogram(
    "mesh_recovery_seconds",
    "wall clock per node-failure recovery (repartition or fallback)")


# ---------------------------------------------------------------------------
# segment tasks: one callable per chain segment, checkpoint in/out
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentTask:
    """One chain segment as a self-contained unit of node work:
    ``run(state) -> outputs`` reads the boundary tensors it ``consumes``
    from the checkpoint state and returns the boundary tensors it
    ``produces`` as host numpy (the next checkpoint increment).
    Segment-internal forwarded tensors never leave the call."""

    index: int
    consumes: Tuple[str, ...]
    produces: Tuple[str, ...]
    run: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]


def _host(t: torch.Tensor) -> np.ndarray:
    """A boundary tensor's host copy, in the reference's layout."""
    return np.ascontiguousarray(t.cpu().numpy())


def _on(a, dev: torch.device) -> torch.Tensor:
    """A boundary array on the device, float32 and contiguous."""
    if isinstance(a, np.ndarray) and a.dtype == np.float32 \
            and a.flags.c_contiguous:
        return torch.from_numpy(a).to(dev)
    return as_tensor(a, dev)


def build_segment_tasks(nplan: NetworkPlan, weights: Dict,
                        interpret: bool = True,
                        jit: bool = True,
                        backend: Optional[str] = None,
                        device=None) -> List[SegmentTask]:
    """Build the plan's layers into per-segment tasks on ``device`` (the
    card unless the caller passes ``"cpu"``).

    ``weights`` holds the ``"<layer>.W"`` arrays (moved to the device once:
    resident weights, like a serving node).  External activations are
    *not* captured: each request supplies its ``"<layer>.I"`` tensors
    through the state dict, so one task list serves every request.

    Under ``backend="compiled"`` each task runs one segment of the fused
    tier (``fuse.fused_runner``'s network from the process-wide cache);
    every segment's graph is captured here, on the calling thread, so a
    replay after a node failure, a re-partition or another request
    captures nothing.  A fused task only emits tensors some later segment
    or the network output needs; tensors the per-layer tier round-trips
    but that stay inside one segment never leave the graph.  Any other
    backend (the reference's ``interpret`` or ``pallas``, or None) runs
    the per-layer tier.  ``interpret`` and ``jit`` are accepted for the
    reference's signature and change nothing here: a per-layer task
    launches the kernels from Python, and the fused tier is the compiled
    one."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    dev = resolve_device(device)
    weights = {k: as_tensor(v, dev) for k, v in weights.items()}
    if backend == "compiled":
        from .fuse import fused_runner          # lazy, as in netexec
        fused = fused_runner(nplan, device=dev)
        fused.capture_segments()
        tasks = []
        for seg in nplan.segments:
            consumes, produces = fused.segment_io[seg.index]
            acts = tuple(s for s in consumes if not s.endswith(".W"))
            wkeys = tuple(s for s in consumes if s.endswith(".W"))

            def run(state: Dict[str, np.ndarray], index=seg.index,
                    acts=acts, wkeys=wkeys) -> Dict[str, np.ndarray]:
                feed = {s: state[s] for s in acts}
                feed.update({w: weights[w] for w in wkeys})
                out = fused.run_segment(index, feed)
                return {k: _host(v) for k, v in out.items()}

            tasks.append(SegmentTask(seg.index, acts, produces, run))
        return tasks
    _check_executable(nplan)
    steps: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {
        name: _layer_fn(nplan, name, weights) for name in nplan.order}
    # a forwarded tensor with a consumer outside its own segment must
    # still cross the boundary: emit it like a round-tripped tensor
    emit: Dict[str, bool] = {}
    for seg in nplan.segments:
        inseg = set(seg.layer_names)
        for n in seg.layer_names:
            outside = any(n in steps[c][1] for c in nplan.order
                          if c not in inseg)
            emit[n] = outside or not nplan.placements[n].forwarded
    tasks: List[SegmentTask] = []
    for seg in nplan.segments:
        names = tuple(seg.layer_names)
        inseg = set(names)
        consumes: List[str] = []
        for n in names:
            srcs = steps[n][1]
            if srcs:
                consumes += [s for s in srcs if s not in inseg]
            else:
                consumes.append(f"{n}.I")
        produces = tuple(n for n in names if emit[n])

        def run(state: Dict[str, np.ndarray],
                names=names) -> Dict[str, np.ndarray]:
            onchip: Dict[str, torch.Tensor] = {}
            out: Dict[str, np.ndarray] = {}
            for n in names:
                fn, srcs = steps[n]
                if srcs:
                    # a round-tripped tensor of this segment comes back
                    # from its host copy, as in netexec's per-layer run
                    args = [onchip[s] if s in onchip
                            else _on(out[s] if s in out else state[s], dev)
                            for s in srcs]
                else:
                    # the request's own input: the step's closure holds
                    # no ``.I``, so it never sees another request's
                    args = [_on(state[f"{n}.I"], dev)]
                y = fn(*args)
                if nplan.placements[n].forwarded:
                    onchip[n] = y
                if emit[n]:
                    out[n] = _host(y)
            return out

        tasks.append(SegmentTask(seg.index,
                                 tuple(dict.fromkeys(consumes)),
                                 produces, run))
    return tasks


# ---------------------------------------------------------------------------
# the node pool: serial workers with mesh-ready control surface
# ---------------------------------------------------------------------------

class NodePool:
    """``n`` worker nodes, each a single-thread executor over the one card
    (a node runs one segment at a time — serial, like a real accelerator
    queue).  ``kill`` / ``set_slow`` are the chaos control surface;
    ``submit`` on a dead node raises ``NodeFailure`` immediately."""

    def __init__(self, n: int, name_prefix: str = "node"):
        if n < 1:
            raise ValueError(f"pool needs >= 1 node, got {n}")
        self.n = n
        self._workers = {
            i: ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix=f"{name_prefix}{i}")
            for i in range(n)}
        self._dead: Dict[int, str] = {}
        self._slow: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._events = metrics.CounterGroup("mesh_pool",
                                            ("submits", "kills"))
        _m_alive.set(n)

    def alive(self) -> List[int]:
        with self._lock:
            return [i for i in range(self.n) if i not in self._dead]

    def is_dead(self, nid: int) -> bool:
        with self._lock:
            return nid in self._dead

    def kill(self, nid: int, reason: str = "killed") -> None:
        with self._lock:
            if nid in self._dead:
                return
            self._dead[nid] = reason
            alive = self.n - len(self._dead)
        self._events.inc("kills")
        _m_alive.set(alive)
        trace.instant("mesh.node_killed", node=nid, reason=reason)
        self._workers[nid].shutdown(wait=False, cancel_futures=True)

    def set_slow(self, nid: int, factor: float) -> None:
        with self._lock:
            self._slow[nid] = max(1.0, factor)

    def slow_factor(self, nid: int) -> float:
        with self._lock:
            return self._slow.get(nid, 1.0)

    def submit(self, nid: int, fn: Callable, *args) -> Future:
        with self._lock:
            reason = self._dead.get(nid)
            worker = self._workers[nid]
        if reason is not None:
            raise NodeFailure(f"node {nid} is dead ({reason})",
                              permanent=True)
        try:
            self._events.inc("submits")
            return worker.submit(fn, *args)
        except RuntimeError as e:       # shutdown raced the check
            raise NodeFailure(f"node {nid} is dead (shut down)",
                              permanent=True) from e

    def stats(self) -> Dict:
        """Pool control-surface snapshot (mirrored into the registry as
        mesh_pool_events_total / mesh_alive_nodes)."""
        with self._lock:
            return {"nodes": self.n,
                    "alive": [i for i in range(self.n)
                              if i not in self._dead],
                    "dead": dict(self._dead),
                    "slow": dict(self._slow),
                    "submits": self._events["submits"],
                    "kills": self._events["kills"]}

    def close(self) -> None:
        for w in self._workers.values():
            w.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "NodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _node_body(pool: NodePool, nid: int, task: SegmentTask,
               state: Dict) -> Dict:
    """Run one segment task on one node, with the node-level fault
    sites applied around the real work."""
    key = f"node{nid}"
    if pool.is_dead(nid):
        raise NodeFailure(f"node {nid} is dead", permanent=True)
    inj = inject.active()
    if inj is not None:
        spec = inj.decide("node.crash", key)
        if spec is not None:
            pool.kill(nid, "injected crash")
            raise NodeFailure(f"node {nid} crashed (injected)",
                              permanent=True)
        inj.fault("node.hang", key)     # 'slow' spec blocks delay_s here
    t0 = time.perf_counter()
    out = task.run(state)
    elapsed = time.perf_counter() - t0
    factor = pool.slow_factor(nid)
    if inj is not None:
        spec = inj.decide("node.slow", key)
        if spec is not None:
            factor = max(factor, spec.factor if spec.factor > 1.0
                         else 5.0)
    if factor > 1.0:
        time.sleep(elapsed * (factor - 1.0))
    return out


# ---------------------------------------------------------------------------
# the resilient executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshExecution:
    """One request's outcome: boundary outputs plus recovery telemetry."""

    outputs: Dict[str, np.ndarray]
    degraded: bool
    replays: int                       # boundary replays after failures
    backups: int                       # speculative re-dispatches used
    seconds: float


class MeshExecutor:
    """Drive requests through a ``MultiNodePlan`` on a ``NodePool``,
    surviving node crash / hang / slowdown (see module docstring for
    the recovery ladder).  ``schedule``/``graph``/``hw`` give the
    re-partition context; without them a node loss goes straight to the
    single-node fallback rung.  Thread-safe: concurrent ``run`` calls
    share the pool, the detector and the (lock-guarded) plan."""

    def __init__(self, plan: MultiNodePlan, tasks: Sequence[SegmentTask],
                 schedule=None, graph=None, hw=None,
                 pool: Optional[NodePool] = None,
                 detector: Optional[StragglerDetector] = None,
                 planner: Optional[ElasticPlanner] = None,
                 min_nodes: int = 1,
                 task_timeout_s: float = 30.0,
                 min_backup_deadline_s: float = 0.02):
        self.plan = plan
        self.tasks = sorted(tasks, key=lambda t: t.index)
        if [t.index for t in self.tasks] != list(range(len(self.tasks))):
            raise ValueError("tasks must cover segments 0..S-1 exactly")
        self.schedule, self.graph, self.hw = schedule, graph, hw
        self._own_pool = pool is None
        self.pool = pool if pool is not None else NodePool(plan.mesh.nodes)
        self.detector = detector if detector is not None else \
            StragglerDetector(factor=2.0, warmup=2)
        self.planner = planner if planner is not None else \
            ElasticPlanner(model_axis=1, min_data=min_nodes)
        self.task_timeout_s = task_timeout_s
        self.min_backup_deadline_s = min_backup_deadline_s
        self._lock = threading.RLock()
        self._rr = itertools.count()
        self.fallback = False
        # mirrored into mesh_events_total{event=...} (repro_torch.obs)
        self._events = metrics.CounterGroup("mesh", (
            "requests", "degraded_requests", "failures", "repartitions",
            "resolved_segments", "backups", "replays"))
        self.recovery_seconds = 0.0

    @property
    def requests(self) -> int:
        return self._events["requests"]

    @property
    def degraded_requests(self) -> int:
        return self._events["degraded_requests"]

    @property
    def failures(self) -> int:
        return self._events["failures"]

    @property
    def repartitions(self) -> int:
        return self._events["repartitions"]

    @property
    def resolved_segments(self) -> int:
        return self._events["resolved_segments"]

    @property
    def backups(self) -> int:
        return self._events["backups"]

    @property
    def replays(self) -> int:
        return self._events["replays"]

    # -- node choice ---------------------------------------------------------
    def _pick_node(self, seg_index: int, salt: int) -> Optional[int]:
        with self._lock:
            part = self.plan.part_of_segment(seg_index)
            alive = [n for n in part.node_ids
                     if not self.pool.is_dead(n)]
            if not alive:
                return None
            # replicate directive: requests round-robin the node group
            return alive[salt % len(alive)]

    def _backup_node(self, avoid: int) -> Optional[int]:
        flagged = {h for h in self.detector.stragglers()}
        with self._lock:
            alive = [n for n in self.pool.alive() if n != avoid]
        healthy = [n for n in alive if f"node{n}" not in flagged]
        pick = healthy or alive
        return pick[0] if pick else None

    # -- dispatch with the speculate / re-dispatch rungs ---------------------
    def _dispatch(self, nid: int, task: SegmentTask, state: Dict) -> Dict:
        host = f"node{nid}"
        straggling = host in set(self.detector.stragglers())
        backup_nid = self._backup_node(nid) if straggling else None
        with trace.span("mesh.task", node=nid,
                        segment=task.index) as sp:
            return self._dispatch_inner(nid, host, task, state,
                                        straggling, backup_nid, sp)

    def _dispatch_inner(self, nid: int, host: str, task: SegmentTask,
                        state: Dict, straggling: bool,
                        backup_nid: Optional[int], sp) -> Dict:
        t0 = time.perf_counter()
        if straggling:
            trace.instant(
                "mesh.straggler", node=nid,
                reason=f"EWMA latency > {self.detector.factor:g}x "
                       f"fleet median")
        if backup_nid is not None:
            med = self.detector.fleet_median() or 0.0
            deadline = max(self.min_backup_deadline_s,
                           self.detector.factor * med)
            primary = self.pool.submit(nid, _node_body, self.pool, nid,
                                       task, state)
            with BackupDispatcher(deadline_seconds=deadline) as bd:
                out = bd.run(
                    primary.result,
                    lambda: self.pool.submit(
                        backup_nid, _node_body, self.pool, backup_nid,
                        task, state).result())
                won_backup = bd.failovers > 0
            dt = time.perf_counter() - t0
            trace.instant(
                "mesh.backup_dispatch", primary=nid, backup=backup_nid,
                winner=backup_nid if won_backup else nid,
                reason="straggler flagged; raced a healthy peer")
            sp.set(backup=backup_nid, won_backup=won_backup)
            if won_backup:
                self._events.inc("backups")
            self.detector.record(f"node{backup_nid}" if won_backup
                                 else host, dt)
            return out
        fut = self.pool.submit(nid, _node_body, self.pool, nid, task,
                               state)
        try:
            out = fut.result(timeout=self.task_timeout_s)
        except FutureTimeout:
            # hung node: drain it so the repartition rung takes over
            self.pool.kill(nid, "hung")
            raise NodeFailure(
                f"node {nid} hung past {self.task_timeout_s}s deadline")
        self.detector.record(host, time.perf_counter() - t0)
        return out

    # -- the re-partition / fallback rungs -----------------------------------
    def _on_node_failure(self, nid: Optional[int],
                         err: NodeFailure) -> None:
        t0 = time.perf_counter()
        with self._lock:
            if nid is not None:
                self.pool.kill(nid, str(err))
                # a drained node must stop poisoning the fleet median
                self.detector.forget(f"node{nid}")
            self._events.inc("failures")
            survivors = self.pool.alive()
            try:
                self.planner.plan_nodes(len(survivors))
                if self.schedule is None or self.graph is None \
                        or self.hw is None:
                    raise NodeFailure("no re-partition context",
                                      permanent=True)
                new_plan, dirty = repartition(
                    self.plan, self.schedule, self.graph, self.hw,
                    survivors)
            except NodeFailure as fe:
                self.fallback = True
                trace.instant("mesh.fallback",
                              reason=f"{err} -> {fe}")
            else:
                if dirty:           # idempotent under concurrent failures
                    self.plan = new_plan
                    self._events.inc("repartitions")
                    self._events.inc("resolved_segments", len(dirty))
                    trace.instant(
                        "mesh.repartition", dead=nid,
                        dirty_segments=len(dirty),
                        survivors=len(survivors), reason=str(err))
            dt = time.perf_counter() - t0
            self.recovery_seconds += dt
        _m_recovery.observe(dt)

    # -- request execution ---------------------------------------------------
    def run(self, state_inputs: Dict,
            request_key: str = "req") -> MeshExecution:
        """Execute one request.  ``state_inputs`` carries the external
        ``"<layer>.I"`` activations; the returned outputs are every
        boundary tensor the request produced.  The state dict *is* the
        checkpoint: a failed segment replays from the last completed
        boundary, never from the start of the request."""
        t0 = time.perf_counter()
        salt = next(self._rr)
        self._events.inc("requests")
        state: Dict[str, np.ndarray] = dict(state_inputs)
        i = 0
        replays = 0
        backups0 = self.backups
        degraded = False
        with trace.span("mesh.request",
                        key=request_key) as req_span:
            while i < len(self.tasks):
                task = self.tasks[i]
                if self.fallback:
                    with trace.span("mesh.task", node="driver",
                                    segment=task.index):
                        out = task.run(state)   # last rung: inline, degraded
                    degraded = True
                else:
                    nid = self._pick_node(task.index, salt)
                    if nid is None:
                        self._on_node_failure(None, NodeFailure(
                            f"segment {task.index} lost every node"))
                        replays += 1
                        continue
                    try:
                        out = self._dispatch(nid, task, state)
                    except NodeFailure as e:
                        self._on_node_failure(nid, e)
                        replays += 1
                        continue            # replay from the last boundary
                state.update(out)           # checkpoint the boundary
                i += 1
            outputs = {k: v for k, v in state.items()
                       if k not in state_inputs}
            self._events.inc("replays", replays)
            backups = self.backups - backups0
            if degraded:
                self._events.inc("degraded_requests")
            req_span.set(replays=replays, backups=backups,
                         degraded=degraded)
        return MeshExecution(outputs=outputs, degraded=degraded,
                             replays=replays, backups=backups,
                             seconds=time.perf_counter() - t0)

    def stats(self) -> Dict:
        with self._lock:
            return {"requests": self.requests,
                    "degraded_requests": self.degraded_requests,
                    "failures": self.failures,
                    "repartitions": self.repartitions,
                    "resolved_segments": self.resolved_segments,
                    "backups": self.backups,
                    "replays": self.replays,
                    "recovery_seconds": self.recovery_seconds,
                    "fallback": self.fallback,
                    "alive_nodes": self.pool.alive(),
                    "straggler": self.detector.stats()}

    def close(self) -> None:
        if self._own_pool:
            self.pool.close()

    def __enter__(self) -> "MeshExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["BACKENDS", "SegmentTask", "build_segment_tasks", "NodePool",
           "MeshExecution", "MeshExecutor"]
