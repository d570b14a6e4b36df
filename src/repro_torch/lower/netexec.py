"""Execute a ``NetworkPlan`` end to end through the CUDA kernels.

The port of ``repro/lower/netexec.py``.  The layer tier (``exec.py``) runs
one kernel; this module chains every kernel of a lowered network in
topological order, realizing the plan's buffer schedule, at one of two
tiers:

  * **per-layer** (``fused=False``): each kernel launched from Python;
    **forwarded** tensors (segment-internal, see ``netplan``) stay device
    tensors handed from the producing kernel to its consumers, and
    **boundary** tensors go to host numpy after the producer
    (``.cpu().numpy()``) and back to the device when consumed: the
    execution analogue of a DRAM store + reload;
  * **fused** (``fused=True``, ``fuse.py``): the same kernels replayed as
    one CUDA graph, every tensor on the device; ``roundtrips`` then lists
    the boundary tensors, which stay on the device.  ``measure_network``
    measures this tier unless told otherwise, as the reference measures
    its compiled tier.

Inside one call the activations are held channels-last (``[N, X, Y,
C]`` memory under the reference's ``[N, C, X, Y]`` shape; ``exec.
to_channels_last``), the layout the conv kernel reads: the external inputs
are converted once where a layer reads them, every conv, pool and eltwise
sum writes channels-last, and the adapter below keeps the layout.  Only a
reshape in the reference's element order (the flatten before an fc with
more than one position, a fold-sum) converts back.  ``exec.LAUNCHES
["layout"]`` counts the conversions: one a call for ResNet-50 (the images).
Tensors handed back to a caller are in the reference's layout.

Producer and consumer shapes line up only approximately (conv halos,
flattening before FC, LSTM gate merges, inception concat).  One canonical
adapter closes the gap, used identically by the executor and the
whole-graph reference pass, so rel-error comparisons are like for like:

  1. equal per-batch size        -> reshape (flatten before FC, 2-D<->4-D);
  2. channel-matched 4-D tensors -> centered zero-pad / crop of the
     spatial dims;
  3. divisible per-batch size    -> fold-sum over the leading groups;

and multi-source eltwise layers whose channel counts partition the output
(inception concat) embed each source at its channel offset, so the n-ary
sum kernel computes the concatenation.  Attention layers stay layer-tier
only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
import zlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import backend, ref
from ..obs import metrics, trace, watch
from ..workloads.layers import LayerSpec
from .exec import (as_tensor, channels_last_zeros, conv_folds, conv_input,
                   conv_pitch, input_extent, input_shapes, rel_error,
                   run_conv, run_eltwise, run_fc, run_pool, to_channels_last,
                   to_reference_layout)
from .netplan import NetworkPlan


# ---------------------------------------------------------------------------
# shapes + the canonical adapter
# ---------------------------------------------------------------------------

def required_input_shape(layer: LayerSpec) -> Tuple[int, ...]:
    """Canonical input-activation shape each kernel consumes."""
    if layer.kind == "fc":
        return (layer.dim("N"), layer.dim("C"))
    if layer.kind in ("conv", "pool"):
        XI, YI = input_extent(layer)
        return (layer.dim("N"), layer.dim("C"), XI, YI)
    if layer.kind == "eltwise":
        return (layer.dim("N"), layer.dim("C"), layer.dim("X"),
                layer.dim("Y"))
    raise ValueError(f"no network-exec input feed for kind {layer.kind!r}")


def _pad_crop(arr: torch.Tensor, shape: Tuple[int, ...],
              channels_last: bool) -> torch.Tensor:
    """Centered zero-pad / crop of the spatial dims of a channel-matched
    4-D tensor (a crop is a view; a pad is held channels-last with
    ``channels_last``)."""
    out = arr
    lo = [0, 0]
    for ax in (2, 3):
        d = shape[ax] - out.shape[ax]
        if d < 0:
            out = out.narrow(ax, (-d) // 2, shape[ax])
        elif d > 0:
            lo[ax - 2] = d // 2
    if tuple(out.shape) == tuple(shape):
        return out
    pad = _zeros(shape, arr, channels_last)
    pad[:, :, lo[0]:lo[0] + out.shape[2], lo[1]:lo[1] + out.shape[3]] = out
    return pad


def _zeros(shape: Tuple[int, ...], like: torch.Tensor,
           channels_last: bool) -> torch.Tensor:
    """Zeros of ``shape`` on ``like``'s device, channels-last or
    row-major."""
    if channels_last:
        return channels_last_zeros(shape, device=like.device)
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def adapt_tensor(arr: torch.Tensor, shape: Tuple[int, ...],
                 channels_last: bool = False,
                 pitch: Optional[int] = None) -> torch.Tensor:
    """Adapt a producer output to a consumer's required input shape (see
    module docstring for the three rules), in the reference's element order
    whatever ``arr``'s memory layout.  The result is contiguous, or, with
    ``channels_last`` and a 4-D ``shape``, held channels-last (at channel
    pitch ``pitch``; ``exec.to_channels_last``): the network executor's
    layout.  A copy between the two layouts counts in
    ``exec.LAUNCHES["layout"]``."""
    shape = tuple(shape)
    if tuple(arr.shape) != shape:
        n = shape[0]
        src_per = int(np.prod(arr.shape[1:]))
        dst_per = int(np.prod(shape[1:]))
        if src_per == dst_per:
            arr = to_reference_layout(arr).reshape(shape)
        elif arr.dim() == 4 and len(shape) == 4 and arr.shape[1] == shape[1]:
            arr = _pad_crop(arr, shape, channels_last)
        elif src_per % dst_per == 0:
            k = src_per // dst_per
            arr = to_reference_layout(arr).reshape(
                (n, k, dst_per)).sum(dim=1).reshape(shape)
        else:
            raise ValueError(f"cannot adapt shape {tuple(arr.shape)} -> "
                             f"{shape}")
    if channels_last and len(shape) == 4:
        return to_channels_last(arr, pitch)
    return to_reference_layout(arr)


def _eltwise_operands(srcs: Sequence[torch.Tensor], layer: LayerSpec,
                      channels_last: bool = False) -> List[torch.Tensor]:
    """Adapt eltwise sources to the output shape.  When the sources'
    channel counts partition the output channels (inception concat), each
    source is embedded at its channel offset so the sum kernel computes
    the concatenation; otherwise every source adapts independently and
    the kernel computes a plain sum (residual add, gate merge).  The
    operands are held channels-last with ``channels_last``."""
    shape = required_input_shape(layer)
    C = shape[1]
    chans = [a.shape[1] if a.dim() == 4 else -1 for a in srcs]
    if len(srcs) > 1 and all(c > 0 for c in chans) and sum(chans) == C \
            and any(c != C for c in chans):
        out, off = [], 0
        for a, c in zip(srcs, chans):
            a4 = adapt_tensor(a, (shape[0], c, shape[2], shape[3]),
                              channels_last)
            emb = _zeros(shape, a4, channels_last)
            emb[:, off:off + c] = a4
            out.append(emb)
            off += c
        return out
    return [adapt_tensor(a, shape, channels_last) for a in srcs]


# ---------------------------------------------------------------------------
# deterministic network inputs (external activations + per-layer weights)
# ---------------------------------------------------------------------------

def network_input_shapes(nplan: NetworkPlan) -> Dict[str, Tuple[int, ...]]:
    """``"<layer>.I"`` for graph sources and ``"<layer>.W"`` for conv/fc
    layers (fc ``W[C,K]``, conv ``W[K,C,R,S]``, activations NCHW)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name in nplan.order:
        layer = nplan.plans[name].layer
        if not any(s in nplan.plans for s in layer.src):
            shapes[f"{name}.I"] = required_input_shape(layer)
        if layer.kind == "fc":
            shapes[f"{name}.W"] = (layer.dim("C"), layer.dim("K"))
        elif layer.kind == "conv":
            shapes[f"{name}.W"] = (layer.dim("K"), layer.dim("C"),
                                   int(layer.meta["R"]), int(layer.meta["S"]))
    return shapes


def make_network_inputs(nplan: NetworkPlan, seed: int = 0,
                        device=None) -> Dict[str, torch.Tensor]:
    """Deterministic inputs for the plan, drawn with numpy (one generator
    per name, seeded by ``(seed, crc32(name))``), weights variance-scaled
    by fan-in^-1/2 so activations stay O(1) through deep graphs."""
    dev = backend.resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in network_input_shapes(nplan).items():
        rng = np.random.default_rng(
            [seed, zlib.crc32(name.encode()) & 0x7FFFFFFF])
        a = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith(".W"):
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            a *= np.float32(fan_in ** -0.5)
        out[name] = torch.from_numpy(a).to(dev)
    return out


def from_reference_inputs(arrays: Mapping[str, np.ndarray], plan,
                          device=None) -> Dict[str, torch.Tensor]:
    """A checked copy of the input dict that ``repro.lower.make_inputs`` /
    ``make_network_inputs`` return (passed through ``np.asarray``): same
    keys, float32, contiguous, in the JAX package's layouts.  ``plan`` is
    the ``KernelPlan`` or ``NetworkPlan`` the inputs are for; a missing or
    extra key, a shape the plan does not expect, or a dtype other than
    float32 raises."""
    dev = backend.resolve_device(device)
    want = network_input_shapes(plan) if isinstance(plan, NetworkPlan) \
        else input_shapes(plan)
    if set(arrays) != set(want):
        raise ValueError(
            f"input keys differ from the plan's: missing "
            f"{sorted(set(want) - set(arrays))}, extra "
            f"{sorted(set(arrays) - set(want))}")
    out: Dict[str, torch.Tensor] = {}
    for k, shape in want.items():
        a = np.asarray(arrays[k])
        if a.shape != shape:
            raise ValueError(f"{k}: shape {a.shape}, plan expects {shape}")
        if a.dtype != np.float32:
            raise TypeError(f"{k}: dtype {a.dtype}, expected float32")
        out[k] = torch.from_numpy(np.array(a, order="C")).to(dev)
    return out


# ---------------------------------------------------------------------------
# per-layer step functions + the execution chain
# ---------------------------------------------------------------------------

def _layer_fn(nplan: NetworkPlan, name: str, inputs: Mapping
              ) -> Tuple[Callable, Tuple[str, ...]]:
    """(fn, src_names): ``fn(*src_tensors) -> output`` for one layer, with
    the shape adapter folded in.  Activations pass between layers
    channels-last: a source held row-major (an external ``.I``, a copy a
    caller handed back) is converted where a layer reads it, and a conv
    reads its input at ``exec.conv_pitch``, or, for the images (at most 4
    channels), folded by ``exec.conv_input`` (conv1's 3 channels padded to
    4 with zeros, which meet zero weights)."""
    plan = nplan.plans[name]
    layer = plan.layer
    srcs = tuple(s for s in layer.src if s in nplan.plans)
    w = inputs.get(f"{name}.W")
    ext = inputs.get(f"{name}.I")
    if plan.kind == "eltwise":
        def fn(*xs):
            return run_eltwise(plan, _eltwise_operands(
                list(xs) if xs else [ext], layer, channels_last=True))
        return fn, srcs
    if plan.kind not in ("fc", "conv", "pool"):
        raise ValueError(f"cannot execute layer {name!r}: kind "
                         f"{plan.kind!r} has no network-exec input feed")
    shape = required_input_shape(layer)
    run = {"fc": run_fc, "conv": run_conv, "pool": run_pool}[plan.kind]
    extra = () if plan.kind == "pool" else (w,)
    pitch = conv_pitch(layer.dim("C")) if plan.kind == "conv" else None
    # an input the conv kernel reads folded is folded from whatever layout
    # it comes in: one conversion
    fold = plan.kind == "conv" and conv_folds(plan)

    def fn(*xs):
        x = adapt_tensor(xs[0] if xs else ext, shape,
                         channels_last=not fold, pitch=pitch)
        return run(plan, conv_input(plan, x) if fold else x, *extra)
    return fn, srcs


@dataclasses.dataclass
class NetworkExecution:
    """Outputs of one end-to-end network run plus the realized buffer
    schedule.  Forwarded outputs are device tensors; round-tripped ones
    are the host copies (CPU tensors over the numpy buffers).  Every output
    is in the reference's layout (4-D ones row-major [N, C, X, Y]), except
    the fused tier's ``keep="boundary"`` outputs, which are the network's
    own tensors as its kernels left them: the same shapes and values, held
    channels-last."""

    outputs: Dict[str, torch.Tensor]
    forwarded: Tuple[str, ...]      # handed on the device, never left it
    roundtrips: Tuple[str, ...]     # materialized to host numpy
    seconds: float
    device: str = "cuda"
    tier: str = "per-layer"         # or "fused" (``fuse.py``)


def _check_executable(nplan: NetworkPlan) -> None:
    bad = nplan.invalid_layers()
    if bad:
        raise ValueError(
            f"network plan {nplan.graph_name!r} is not executable: "
            + "; ".join(f"{n}: {r}" for n, r in bad))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def network_runner(nplan: NetworkPlan, inputs: Mapping, device=None,
                   keep: str = "all", fused: bool = False
                   ) -> Callable[[], NetworkExecution]:
    """Build a reusable ``() -> NetworkExecution`` for the plan on
    ``device`` (the card unless the caller passes ``"cpu"``).

    Inputs (tensors or numpy arrays) are moved to the device once, so
    weights stay resident.  Each call runs every kernel in topological
    order; forwarded tensors pass between kernels on the device, boundary
    tensors round-trip through host numpy.  ``keep="boundary"`` returns
    only the round-tripped outputs (the measurement path), ``keep="all"``
    every layer output (verification).

    ``fused=True`` runs the fused tier instead: ``fuse.fused_runner``'s
    network from the process-wide cache; each call copies the inputs into
    its buffers, replays its graph and synchronises.  With ``keep="all"``
    the outputs are copies, this call's alone.  With ``keep="boundary"``
    (the measurement path) they are the cached network's own tensors,
    shared by every runner of an equal plan: the next fused call of that
    plan, from any runner or thread, overwrites them."""
    if keep not in ("all", "boundary"):
        raise ValueError(f"keep must be 'all' or 'boundary', got {keep!r}")
    _check_executable(nplan)
    dev = backend.resolve_device(device)
    inputs = {k: as_tensor(v, dev) for k, v in inputs.items()}
    if fused:
        from .fuse import fused_runner          # lazy: fuse imports this
        net = fused_runner(nplan, device=dev)
        fwd = nplan.forwarded()
        boundary = tuple(n for n in nplan.order if n not in fwd)

        def run_fused() -> NetworkExecution:
            t0 = time.perf_counter()
            outputs = net(inputs, keep=keep, copy=keep == "all")
            _sync(dev)
            return NetworkExecution(
                outputs=outputs, forwarded=fwd, roundtrips=boundary,
                seconds=time.perf_counter() - t0, device=str(dev),
                tier="fused")
        return run_fused
    steps = []
    for name in nplan.order:
        fn, srcs = _layer_fn(nplan, name, inputs)
        steps.append((name, fn, srcs, nplan.placements[name].forwarded))

    def run() -> NetworkExecution:
        t0 = time.perf_counter()
        onchip: Dict[str, torch.Tensor] = {}
        host: Dict[str, np.ndarray] = {}
        for name, fn, srcs, fwd in steps:
            args = [onchip[s] if s in onchip
                    else torch.from_numpy(host[s]).to(dev) for s in srcs]
            out = fn(*args)
            if fwd:
                onchip[name] = out              # stays a device tensor
            else:
                host[name] = out.cpu().numpy()  # the host round-trip
        _sync(dev)
        seconds = time.perf_counter() - t0
        # handed back in the reference's layout (copies where the kernels
        # left them channels-last)
        outputs = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in host.items()}
        if keep == "all":
            outputs.update((k, v.contiguous()) for k, v in onchip.items())
        return NetworkExecution(outputs=outputs, forwarded=tuple(onchip),
                                roundtrips=tuple(host), seconds=seconds,
                                device=str(dev))
    return run


def execute_network(nplan: NetworkPlan, inputs: Optional[Mapping] = None,
                    device=None, seed: int = 0) -> NetworkExecution:
    """Run every kernel of the plan in topological order (one-shot
    convenience over ``network_runner``)."""
    inputs = inputs if inputs is not None \
        else make_network_inputs(nplan, seed, device)
    return network_runner(nplan, inputs, device)()


# ---------------------------------------------------------------------------
# whole-graph reference forward pass + verification
# ---------------------------------------------------------------------------

def reference_network(nplan: NetworkPlan, inputs: Mapping,
                      device=None) -> Dict[str, torch.Tensor]:
    """Ground truth: the same graph evaluated with the ``kernels/ref.py``
    oracles and the same canonical adapters, in the same order."""
    dev = backend.resolve_device(device)
    vals: Dict[str, torch.Tensor] = {}
    for name in nplan.order:
        layer = nplan.plans[name].layer
        srcs = [vals[s] for s in layer.src if s in vals]
        shape = required_input_shape(layer)
        ext = inputs.get(f"{name}.I")
        ext = None if ext is None else as_tensor(ext, dev)
        x = adapt_tensor(srcs[0], shape) if srcs else ext
        if layer.kind == "fc":
            vals[name] = ref.matmul_ref(x, as_tensor(inputs[f"{name}.W"],
                                                     dev))
        elif layer.kind == "conv":
            vals[name] = ref.conv2d_ref(x, as_tensor(inputs[f"{name}.W"],
                                                     dev),
                                        stride=int(layer.meta["stride"]))
        elif layer.kind == "pool":
            vals[name] = ref.pool2d_ref(x, int(layer.meta["R"]),
                                        int(layer.meta["S"]),
                                        stride=int(layer.meta["stride"]))
        elif layer.kind == "eltwise":
            vals[name] = ref.eltwise_ref(
                *_eltwise_operands(srcs if srcs else [ext], layer))
        else:
            raise ValueError(f"no oracle for kind {layer.kind!r}")
    return vals


@dataclasses.dataclass
class NetworkVerification:
    ok: bool
    max_rel_err: float
    worst_layer: str
    errors: Dict[str, float]
    n_forwarded: int


def compare_network(nplan: NetworkPlan, ex: NetworkExecution,
                    inputs: Mapping, tol: float = 1e-3
                    ) -> NetworkVerification:
    """Compare every layer output of an execution against the whole-graph
    reference pass, run on the execution's device (per-layer max relative
    error)."""
    want = reference_network(nplan, inputs, ex.device)
    errors = {n: rel_error(ex.outputs[n], want[n]) for n in nplan.order}
    worst = max(errors, key=errors.get)
    return NetworkVerification(
        ok=errors[worst] < tol, max_rel_err=errors[worst],
        worst_layer=worst, errors=errors, n_forwarded=len(ex.forwarded))


def verify_network(nplan: NetworkPlan, device=None, seed: int = 0,
                   tol: float = 1e-3) -> NetworkVerification:
    """Execute the plan and compare against the whole-graph reference."""
    inputs = make_network_inputs(nplan, seed, device)
    return compare_network(nplan, execute_network(nplan, inputs, device),
                           inputs, tol)


_m_drift = metrics.histogram(
    "latency_drift_ratio",
    "measured / predicted network latency of lowered plans",
    ("source", "backend"), buckets=metrics.DRIFT_BUCKETS)


def backend_label(device, fused: bool = False) -> str:
    """The ``backend`` label of a run on ``device`` (a ``torch.device`` or
    its name): ``"cuda"`` for the kernels launched one by one on the card,
    ``"cuda-graph"`` for the fused tier's graph replays there, ``"cpu"``
    for the plain versions.  The JAX package's labels (interpret, pallas,
    compiled) are never reused, so a fit or a drift series of one never
    prices the other."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return "cuda-graph" if fused else "cuda"


def record_latency_drift(predicted_seconds: Optional[float],
                         measured_seconds: float,
                         source: str = "netexec",
                         backend: str = "cuda") -> Optional[float]:
    """Record one predicted-vs-measured latency pair into the
    ``latency_drift_ratio{source, backend}`` histogram, the watchdog's
    sample ring (``watch.note_sample``) and a ``netexec.latency_drift``
    trace instant.  Returns the ratio, or None when either side is
    unusable (zero or negative prediction, NaN or non-positive
    measurement)."""
    if not predicted_seconds or predicted_seconds <= 0.0:
        return None
    if not math.isfinite(measured_seconds) or measured_seconds <= 0.0:
        return None
    ratio = measured_seconds / predicted_seconds
    _m_drift.observe(ratio, source=source, backend=backend)
    watch.note_sample(predicted_seconds, measured_seconds,
                      source=source, backend=backend)
    trace.instant("netexec.latency_drift", source=source, backend=backend,
                  ratio=round(ratio, 4))
    return ratio


def measure_network(nplan: NetworkPlan, inputs: Optional[Mapping] = None,
                    device=None, iters: int = 3, warmup: int = 1,
                    runner: Optional[Callable[[], NetworkExecution]] = None,
                    predicted_seconds: Optional[float] = None,
                    drift_source: str = "netexec",
                    fused: bool = True) -> float:
    """Wall-clock seconds of one end-to-end network execution: min over
    ``iters`` after ``warmup`` runs.  Without a ``runner`` it measures the
    fused tier (``fused=True``: graph replays, boundary outputs only, as
    the reference measures its compiled tier); ``fused=False`` measures
    the per-layer tier, host round-trips included.  Pass an existing
    ``network_runner`` (with ``warmup=0`` if it already ran) to reuse it;
    its tier is then the runner's.  With ``predicted_seconds`` the pair is
    recorded as drift (``record_latency_drift``) under ``drift_source``,
    labelled with the device and tier the runs went to
    (``backend_label``)."""
    if runner is None:
        inputs = inputs if inputs is not None \
            else make_network_inputs(nplan, device=device)
        runner = network_runner(nplan, inputs, device, keep="boundary",
                                fused=fused)
        warmup = max(1, warmup)
    for _ in range(warmup):
        runner()
    best, label = math.inf, None
    for _ in range(max(1, iters)):
        ex = runner()
        best = min(best, ex.seconds)
        label = backend_label(ex.device, ex.tier == "fused")
        del ex      # free this run's outputs before the next one starts
    if predicted_seconds is not None:
        record_latency_drift(predicted_seconds, best, source=drift_source,
                             backend=label)
    return best


__all__ = ["NetworkExecution", "NetworkVerification", "adapt_tensor",
           "backend_label", "compare_network", "execute_network",
           "from_reference_inputs", "make_network_inputs", "measure_network",
           "network_input_shapes", "network_runner", "record_latency_drift",
           "reference_network", "required_input_shape", "verify_network"]
