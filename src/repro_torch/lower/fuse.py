"""The fused tier: whole segments and whole networks as CUDA graphs.

The port of ``repro/lower/fuse.py``.  The per-layer tier (``netexec`` with
``fused=False``) launches every kernel from Python and sends each boundary
tensor through host numpy and back.  This tier removes both:

  * **one ``torch.cuda.CUDAGraph`` per variant**: the whole network
    (``("net", keep)``) or one chain segment (``("seg", i)``), captured
    over the same per-layer steps the per-layer tier runs
    (``netexec._layer_fn``: the canonical shape adapter, then ``run_fc``,
    ``run_conv``, ``run_pool`` or ``run_eltwise``).  Every tensor, forwarded
    or boundary, stays on the device; nothing goes through host numpy;
  * **static buffers owned by the network**: one for every external
    ``.I`` and ``.W`` input (and, for a segment, every boundary tensor it
    reads, held channels-last as the kernels write it, so the copy-in is
    the only conversion a caller's row-major tensor takes).  Every call copies all of the caller's inputs in, weights
    included: a weight written in place in any way (``.data``, a numpy
    view, a kernel through its pointer) is always seen, for one device
    copy of the weights a call.  A graph reads nothing but
    these buffers, so a cached network serves every caller of an equal
    plan, whatever tensors each one holds;
  * **a process-wide cache** keyed by the plan *signature* (shapes, kinds,
    blocking, buffer schedule: everything that shapes the graph) and the
    device, so re-lowering the same schedule (autotune's top-k, a store
    hit) captures nothing again.  It is bounded by count (32, the
    reference's) and by the device memory its networks hold (their
    buffers and graph pools, against half the card's memory): a network
    holds gigabytes where the reference's entry holds an executable.

The graphs hold the port's own hand-written kernels, not torch twins of
them.  The reference's compiled tier traces pure-jnp twins of its Pallas
kernels; in the port those twins would be ``torch.matmul`` and
``F.conv2d`` (cuBLAS and cuDNN), library calls and not the kernels under
test.  A graph replays the same kernels with the same parameters on the
same data as the per-layer tier, and the kernels use no atomics, so on the
card its outputs equal the per-layer tier's bit for bit.

On the CPU (``device="cpu"``) there is no graph: the same steps run through
the plain versions, so the tier's structure (buffers, variants, keep rules,
cache) is testable there.  Launch counters stay truthful under replay: a
capture records the launches of each kind (``backend.recording_launches``)
and every replay adds them to ``exec.LAUNCHES`` (``kernels/graph.py``
``CapturedStep``, which the serving loop shares).
"""
from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from ..kernels.backend import resolve_device
from ..kernels.graph import CapturedStep
from ..obs import device as obs_device
from ..obs import metrics
from .exec import (channels_last_zeros, conv_pitch, input_shapes,
                   run_attention, run_conv, run_eltwise, run_fc, run_pool)
from .netexec import _check_executable, _layer_fn, network_input_shapes
from .netplan import NetworkPlan
from .plan import KernelPlan

# -- telemetry (obs) ---------------------------------------------------------
_m_cache = metrics.counter(
    "fused_cache_events_total",
    "fused-executable cache events (hit / miss / eviction)", ("event",))
_m_size = metrics.gauge("fused_cache_size",
                        "fused executables resident in the process cache")
_m_compile = metrics.histogram(
    "fused_compile_seconds",
    "wall clock per fused-executable trace+compile")


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


class _Buffers:
    """Static input buffers, and the copy of a caller's tensors into them
    (every name, on every call)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs: Dict[str, torch.Tensor] = {}
        self.nbytes = 0

    def add(self, name: str, shape: Sequence[int],
            channels_last: bool = False,
            pitch: Optional[int] = None) -> torch.Tensor:
        """The buffer ``name``, made at its first add: row-major, or held
        channels-last (at channel pitch ``pitch``), where a caller's tensor
        is copied into the kernels' layout."""
        if name not in self.bufs:
            buf = channels_last_zeros(shape, pitch, self.device) \
                if channels_last else torch.zeros(
                    tuple(shape), dtype=torch.float32, device=self.device)
            self.bufs[name] = buf
            self.nbytes += buf.untyped_storage().nbytes()
        return self.bufs[name]

    def bind(self, values: Mapping, names: Sequence[str]) -> None:
        for name in names:
            if name not in values:
                raise ValueError(f"missing input {name!r}")
            v, buf = values[name], self.bufs[name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.asarray(v))
            if v.dtype != torch.float32:
                raise TypeError(f"{name}: dtype {v.dtype}, expected float32")
            if tuple(v.shape) != tuple(buf.shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)}, expected "
                                 f"{tuple(buf.shape)}")
            buf.copy_(v)


# ---------------------------------------------------------------------------
# the layer tier's step (plan_runner(fused=True), the calibration sweep)
# ---------------------------------------------------------------------------

def compiled_plan_fn(plan: KernelPlan) -> Tuple[Callable, Tuple[str, ...]]:
    """(fn, input names): the one-plan step over the port's kernel, which
    ``plan_graph_runner`` captures.  Errors name the layer of an invalid
    plan."""
    if not plan.valid:
        raise ValueError(
            f"cannot execute invalid plan for layer {plan.layer.name!r}: "
            f"{plan.invalid_reason}")
    if plan.kind == "fc":
        return (lambda i, w: run_fc(plan, i, w)), ("I", "W")
    if plan.kind == "conv":
        return (lambda i, w: run_conv(plan, i, w)), ("I", "W")
    if plan.kind == "pool":
        return (lambda i: run_pool(plan, i)), ("I",)
    if plan.kind == "eltwise":
        return (lambda a, b: run_eltwise(plan, [a, b])), ("A", "B")
    if plan.kind == "attention":
        return (lambda q, k, v: run_attention(plan, q, k, v)), \
            ("Q", "K", "V")
    raise ValueError(f"unsupported kind {plan.kind!r}")


def plan_graph_runner(plan: KernelPlan, device=None
                      ) -> Callable[[Mapping], torch.Tensor]:
    """``inputs -> output`` replaying ``compiled_plan_fn(plan)`` as a
    one-kernel graph on the card (captured at the first call, over static
    input buffers the inputs are copied into; the output is the graph's
    own tensor, valid until the next call); on the CPU the step runs
    through the plain version."""
    fn, names = compiled_plan_fn(plan)
    dev = resolve_device(device)
    bufs = _Buffers(dev)
    shapes = input_shapes(plan)
    # a conv's or a pool's input is copied in channels-last, so the graph
    # holds the kernel alone
    cl = plan.kind in ("conv", "pool")
    pitch = conv_pitch(plan.layer.dim("C")) if plan.kind == "conv" else None
    args = [bufs.add(n, shapes[n], cl and n == "I", pitch) for n in names]
    lock = threading.Lock()
    graph: List[CapturedStep] = []

    def run(inputs: Mapping) -> torch.Tensor:
        with lock:
            bufs.bind(inputs, names)
            if not graph:
                graph.append(CapturedStep(lambda: {"O": fn(*args)}, dev))
            return graph[0]()["O"]
    return run


# ---------------------------------------------------------------------------
# the plan signature: cache key over everything that shapes the graph
# ---------------------------------------------------------------------------

def plan_signature(nplan: NetworkPlan) -> str:
    """Content hash of the captured computation: layer shapes/kinds/meta,
    graph wiring, segment slicing and the buffer schedule; the reference's
    digest for the same plan.  Two plans with equal signatures capture
    identical graphs, so re-lowering the same schedule hits the process
    cache instead of capturing again."""
    doc: Dict = {"graph": nplan.graph_name, "layers": [], "segments": []}
    for name in nplan.order:
        plan = nplan.plans[name]
        layer = plan.layer
        doc["layers"].append({
            "name": name,
            "kind": plan.kind,
            "dims": sorted((d, int(v)) for d, v in layer.dims.items()),
            "meta": sorted((k, repr(v)) for k, v in layer.meta.items()),
            "src": [s for s in layer.src if s in nplan.plans],
            "block": sorted((d, int(v)) for d, v in plan.block.items()),
            "grid": [(ax.dim, ax.steps) for ax in plan.grid],
            "forwarded": nplan.placements[name].forwarded,
        })
    for seg in nplan.segments:
        doc["segments"].append([seg.start, seg.stop,
                                round(seg.granule_frac, 12)])
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def input_specs(nplan: NetworkPlan) -> Dict[str, TensorSpec]:
    """Shapes and types of the plan's external feed (mirrors
    ``make_network_inputs``): what the network's buffers hold."""
    return {k: TensorSpec(tuple(s), torch.float32)
            for k, s in network_input_shapes(nplan).items()}


# ---------------------------------------------------------------------------
# segments and the network
# ---------------------------------------------------------------------------

def _segment_io(nplan: NetworkPlan, seg) -> Tuple[Tuple[str, ...],
                                                  Tuple[str, ...]]:
    """(consumes, produces) boundary names of one segment: tensors read
    from outside the segment (boundary tensors, external ``.I`` feeds and
    ``.W`` weights) and tensors any later consumer, or the network
    output, needs."""
    inseg = set(seg.layer_names)
    consumes: List[str] = []
    for n in seg.layer_names:
        layer = nplan.plans[n].layer
        srcs = [s for s in layer.src if s in nplan.plans]
        if srcs:
            consumes += [s for s in srcs if s not in inseg]
        else:
            consumes.append(f"{n}.I")
        if layer.kind in ("fc", "conv"):
            consumes.append(f"{n}.W")
    produces = []
    for n in seg.layer_names:
        cons = nplan.placements[n].consumers
        if not cons or any(c not in inseg for c in cons):
            produces.append(n)
    return tuple(dict.fromkeys(consumes)), tuple(produces)


def output_shape(plan: KernelPlan) -> Tuple[int, ...]:
    """Shape of a layer's output as its kernel writes it."""
    L = plan.layer
    if plan.kind == "fc":
        return (L.dim("N"), L.dim("K"))
    C = L.dim("K") if plan.kind == "conv" else L.dim("C")
    return (L.dim("N"), C, L.dim("X"), L.dim("Y"))


class FusedNetwork:
    """The fused tier of one ``NetworkPlan`` on one device: graphs of two
    granularities (whole net, single segment), each captured at its first
    call and kept on this object, which the process-wide cache keys by
    plan signature.

    ``traces`` counts variant builds: on the card, each is one capture; a
    call of a built variant, or a cache hit, captures nothing.  One lock
    serializes each capture and each copy-in plus replay.  ``nbytes`` is
    the device memory the network holds: its buffers and its graphs'
    pools.  A call is the host spans ``fused.bind`` and ``fused.replay``
    (``obs/device.py``), carrying ``call=<n>``, and marks ``copy_in``,
    ``replay`` and ``end`` on the device's stream, outside the graph, which
    ``phase_ms`` reads."""

    def __init__(self, nplan: NetworkPlan, device=None):
        _check_executable(nplan)             # errors name the layer
        self.nplan = nplan
        self.device = resolve_device(device)
        self.signature = plan_signature(nplan)
        self.traces = 0
        self.capture_seconds: Dict[Tuple, float] = {}
        self.segment_io = [_segment_io(nplan, seg)
                           for seg in nplan.segments]
        self._graphs: Dict[Tuple, CapturedStep] = {}
        self._pool_bytes = 0
        self._lock = threading.Lock()
        self._bufs = _Buffers(self.device)
        self._calls = 0
        self._marks = obs_device.Marks(self.device)
        self._feed = network_input_shapes(nplan)
        for name, shape in self._feed.items():
            self._bufs.add(name, shape)

    @property
    def nbytes(self) -> int:
        return self._bufs.nbytes + self._pool_bytes

    def phase_ms(self) -> Dict[str, float]:
        """``{copy_in, replay}``: device ms of the last call's copy of the
        inputs into the buffers and of its replay (empty unless a tracer
        was installed across that call)."""
        return self._marks.phase_ms()

    # -- variants -----------------------------------------------------------

    def _chain(self, names: Sequence[str], kept: Sequence[str]
               ) -> Callable[[], Dict[str, torch.Tensor]]:
        """The step running ``names`` in order over this network's buffers
        (each layer's sources from earlier outputs, else the buffers); a
        value not kept is dropped after its last consumer."""
        bufs = self._bufs.bufs
        steps = [(n, *_layer_fn(self.nplan, n, bufs)) for n in names]
        last = {}
        for i, (_, _, srcs) in enumerate(steps):
            for s in srcs:
                last[s] = i
        keep = set(kept)

        def step() -> Dict[str, torch.Tensor]:
            vals: Dict[str, torch.Tensor] = {}
            for i, (n, fn, srcs) in enumerate(steps):
                vals[n] = fn(*(vals[s] if s in vals else bufs[s]
                               for s in srcs))
                for s in srcs:
                    if last[s] == i and s in vals and s not in keep:
                        del vals[s]
            return {n: vals[n] for n in kept}
        return step

    def _build(self, key: Tuple) -> CapturedStep:
        if key[0] == "seg":
            seg = self.nplan.segments[key[1]]
            step = self._chain(seg.layer_names, self.segment_io[key[1]][1])
        elif key[1] == "all":
            step = self._chain(self.nplan.order, self.nplan.order)
        else:                                # "boundary": serving outputs
            step = self._chain(self.nplan.order,
                               [n for s in self.segment_io for n in s[1]])
        graph = CapturedStep(
            step, self.device,
            owner="seg" if key[0] == "seg" else f"net.{key[1]}",
            net=self.nplan.graph_name, signature=self.signature[:12],
            variant=str(key))
        self.traces += 1
        self._pool_bytes += graph.pool_bytes
        self.capture_seconds[key] = graph.capture_seconds
        _m_compile.observe(graph.capture_seconds)
        return graph

    def _boundary_buffers(self, names: Sequence[str]) -> None:
        for name in names:
            if name not in self._feed:           # a boundary tensor
                shape = output_shape(self.nplan.plans[name])
                self._bufs.add(name, shape, len(shape) == 4)

    def _graph(self, key: Tuple) -> Tuple[CapturedStep, bool]:
        """The variant's graph, and whether this call built it."""
        graph = self._graphs.get(key)
        if graph is not None:
            return graph, False
        graph = self._graphs[key] = self._build(key)
        return graph, True

    def _run(self, key: Tuple, values: Mapping, names: Sequence[str],
             copy: bool = False) -> Dict[str, torch.Tensor]:
        with self._lock:
            self._calls += 1
            self._boundary_buffers(names)
            self._marks.mark("copy_in")
            with obs_device.span("fused.bind", call=self._calls):
                self._bufs.bind(values, names)   # checked before a capture
            graph, built = self._graph(key)
            self._marks.mark("replay")
            with obs_device.span("fused.replay", call=self._calls):
                out = graph()
            self._marks.mark("end")
            if copy:                             # in the reference layout
                out = {k: v.clone(memory_format=torch.contiguous_format)
                       for k, v in out.items()}
        if built:                                # it holds more memory now
            _trim(keep=self)
        return out

    # -- execution ----------------------------------------------------------

    def __call__(self, inputs: Mapping, keep: str = "all",
                 donate: bool = False, copy: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """Run the whole plan.  ``keep="all"`` returns every layer output
        (verification); ``keep="boundary"`` only segment-boundary and
        network outputs (the serving path).  On the card the outputs are
        the graph's own tensors: they belong to this network, which the
        cache shares among every caller of an equal plan, and the next
        call of the same variant, from any caller or thread, overwrites
        them.  ``copy=True`` returns copies made before the lock is let
        go: this call's results alone.  ``donate`` is accepted for the
        reference's signature: inputs are copied into this network's
        buffers either way, and weights are never touched."""
        if keep not in ("all", "boundary"):
            raise ValueError(f"keep must be 'all'|'boundary', got {keep!r}")
        return self._run(("net", keep), inputs, tuple(self._feed), copy)

    def run_segment(self, index: int, state: Mapping
                    ) -> Dict[str, torch.Tensor]:
        """Run one segment over a boundary-state dict (it must hold the
        segment's ``consumes`` names); returns copies of its ``produces``
        outputs, since they feed another segment."""
        return self._run(("seg", index), state, self.segment_io[index][0],
                         copy=True)

    def capture_segments(self) -> None:
        """Build every segment's variant now, on the calling thread, over
        the buffers as they stand (zeros until a call fills them): a later
        ``run_segment`` then only copies in and replays, from any thread.
        The mesh executor's tasks (``meshexec.build_segment_tasks``) call
        this, so that no capture runs on a node's thread beside another
        node's copies and launches on the same card."""
        built = False
        with self._lock:
            for i, (consumes, _) in enumerate(self.segment_io):
                self._boundary_buffers(consumes)
                built |= self._graph(("seg", i))[1]
        if built:                                # it holds more memory now
            _trim(keep=self)

    def release(self) -> None:
        """Drop every graph and its memory pool (outputs a caller still
        holds stay alive until dropped); a later call captures again."""
        with self._lock:
            self._graphs.clear()
            self._pool_bytes = 0


# ---------------------------------------------------------------------------
# the process-wide cache
# ---------------------------------------------------------------------------

_CACHE: "OrderedDict[Tuple[str, str], FusedNetwork]" = OrderedDict()
_CACHE_CAP = 32
#: device bytes the cached networks of one device may hold; ``None`` is
#: half the card's memory, and no bound on the CPU
_CACHE_BYTES: Optional[int] = None
_CACHE_LOCK = threading.Lock()
_cache_counts = {"hits": 0, "misses": 0, "evictions": 0}


def fused_runner(nplan: NetworkPlan, cache: bool = True,
                 device=None) -> FusedNetwork:
    """The fused tier's entry point: the ``FusedNetwork`` for this plan on
    ``device`` (the card unless ``"cpu"``), served from the process-wide
    cache when an equal-signature plan was fused there before."""
    _check_executable(nplan)
    dev = resolve_device(device)
    if not cache:
        return FusedNetwork(nplan, dev)
    key = (plan_signature(nplan), str(dev))
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _CACHE.move_to_end(key)
            _cache_counts["hits"] += 1
            _m_cache.inc(event="hit")
            return hit
    # build outside the lock; losing a build race just wastes one
    # construction, never corrupts the cache
    fused = FusedNetwork(nplan, dev)
    with _CACHE_LOCK:
        if key in _CACHE:
            _CACHE.move_to_end(key)
            return _CACHE[key]
        _cache_counts["misses"] += 1
        _m_cache.inc(event="miss")
        _CACHE[key] = fused
    _trim(keep=fused)
    return fused


def _budget(dev: torch.device) -> Optional[int]:
    if _CACHE_BYTES is not None:
        return _CACHE_BYTES
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory // 2


def _over(nets: Sequence[FusedNetwork]) -> bool:
    """Whether the cached ``nets`` pass the count or a device's bytes."""
    if len(nets) > _CACHE_CAP:
        return True
    held: Dict[torch.device, int] = {}
    for net in nets:
        held[net.device] = held.get(net.device, 0) + net.nbytes
    for dev, n in held.items():
        budget = _budget(dev)
        if budget is not None and n > budget:
            return True
    return False


def _trim(keep: FusedNetwork) -> None:
    """Evict least recently used networks, never ``keep`` (the one just
    added or grown), until the cache is within its count and bytes."""
    evicted = []
    with _CACHE_LOCK:
        for key in list(_CACHE):
            if not _over(list(_CACHE.values())):
                break
            if _CACHE[key] is keep:
                continue
            evicted.append(_CACHE.pop(key))
            _cache_counts["evictions"] += 1
            _m_cache.inc(event="eviction")
        _m_size.set(len(_CACHE))
    for net in evicted:
        net.release()
    _return_memory(evicted)


def _return_memory(nets: Sequence[FusedNetwork]) -> None:
    """Give the freed graph pools back to the card."""
    if any(n.device.type == "cuda" for n in nets):
        torch.cuda.empty_cache()


def cache_stats() -> Dict[str, int]:
    with _CACHE_LOCK:
        return {"size": len(_CACHE), **_cache_counts}


def clear_cache() -> None:
    """Empty the cache, dropping every cached network's graphs and memory
    pools, and give the memory back to the card."""
    with _CACHE_LOCK:
        nets = list(_CACHE.values())
        _CACHE.clear()
        for k in _cache_counts:
            _cache_counts[k] = 0
        _m_size.set(0)
    for net in nets:
        net.release()
    _return_memory(nets)


__all__ = ["FusedNetwork", "TensorSpec", "fused_runner", "plan_signature",
           "input_specs", "compiled_plan_fn", "plan_graph_runner",
           "cache_stats", "clear_cache", "output_shape"]
