"""Measured-runtime calibration of the analytical cost model, on the card.

The port of ``repro/lower/calibrate.py``.  Sweeps (scheme, layer) pairs
through the full pipeline (solve with the intra-layer solver, lower to a
``KernelPlan``, execute through the CUDA kernels, time it) and compares the
detailed model's predicted latency against the measured wall clock:

  * **rank correlation** (Spearman): does the model order schemes and
    layers the way the card does?
  * **per-term scale coefficients**: a least-squares fit of measured
    seconds against the roofline's cycle terms (compute, DRAM, GBUF) plus a
    per-grid-step overhead, exported as a ``cost_model.Calibration``.

``device=None`` is the card; ``device="cpu"`` runs the plain versions.
``fused=True`` (``--fused``, the counterpart of the reference's
``--compiled``) measures the fused tier: each plan or network replayed as a
CUDA graph (``fuse.py``).  The record's ``backend`` (and the fit's) is
``"cuda"``, ``"cuda-graph"`` or ``"cpu"`` (``netexec.backend_label``), so a
fit of one never prices another, nor the JAX package's
``interpret``/``pallas``/``compiled`` fits.  The record
schema is the JAX package's, so ``obs.watch.check_calibration_record``
reads it.  Every measured pair is also recorded as latency drift
(``netexec.record_latency_drift``, source ``calibration``).

    python -m repro_torch.lower.calibrate [--network] [--full] [--iters N]
                                          [--out F] [--device cpu] [--fused]
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.cost_model import Calibration, cycle_terms
from ..core.directives import LayerScheme, canonical_orders
from ..core.solver.intralayer import Constraints, solve_intra_layer
from ..hw.presets import eyeriss_multinode
from ..hw.template import HWTemplate
from ..kernels import backend as kbackend
from ..workloads.layers import LayerSpec, attention, conv, fc
from .exec import (_sync, kernel_inputs, make_inputs, plan_runner,
                   reference_output, rel_error)
from .netexec import backend_label, record_latency_drift
from .plan import lower_scheme


# ---------------------------------------------------------------------------
# Spearman rank correlation (no scipy dependency)
# ---------------------------------------------------------------------------

def _ranks(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=float)
    order = np.argsort(a, kind="mergesort")
    r = np.empty(len(a))
    r[order] = np.arange(1, len(a) + 1)
    vals, inv, counts = np.unique(a, return_inverse=True, return_counts=True)
    sums = np.zeros(len(vals))
    np.add.at(sums, inv, r)
    return sums[inv] / counts[inv]          # tie-averaged ranks


def spearman(x: Sequence[float], y: Sequence[float]) -> float:
    rx, ry = _ranks(np.asarray(x)), _ranks(np.asarray(y))
    rx -= rx.mean()
    ry -= ry.mean()
    denom = float(np.sqrt((rx ** 2).sum() * (ry ** 2).sum()))
    return float((rx * ry).sum() / denom) if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# Sweep definition (the JAX package's)
# ---------------------------------------------------------------------------

def default_hw() -> HWTemplate:
    """A deliberately small node grid so realistic layers overflow on-chip
    capacity and the DRAM-level loop nest (the kernel's plan grid) is
    non-trivial."""
    return eyeriss_multinode(nodes=4, pe=8)


def default_sweep(quick: bool = True) -> List[LayerSpec]:
    """conv / matmul / attention layers spanning ~3 orders of magnitude of
    work."""
    layers = [
        fc("cal.fc.s", 64, 128, 128),
        fc("cal.fc.m", 64, 512, 512),
        fc("cal.fc.l", 128, 1024, 1024),
        fc("cal.fc.wide", 512, 1024, 512),
        fc("cal.fc.xl", 256, 2048, 1024),
        conv("cal.conv.s", 2, 16, 32, 14, 14, 3, 3),
        conv("cal.conv.m", 2, 64, 64, 28, 28, 3, 3),
        conv("cal.conv.5x5", 4, 32, 96, 14, 14, 5, 5),
        conv("cal.conv.stride2", 2, 32, 64, 28, 28, 3, 3, stride=2),
        conv("cal.conv.deep", 2, 96, 128, 14, 14, 3, 3),
        conv("cal.conv.l", 4, 64, 128, 28, 28, 3, 3),
        attention("cal.attn.s", 2, 2, 128, 64),
        attention("cal.attn.m", 2, 4, 256, 64),
        attention("cal.attn.l", 4, 4, 256, 64),
        attention("cal.attn.long", 2, 4, 512, 64),
    ]
    if not quick:
        layers += [
            fc("cal.fc.xxl", 256, 4096, 2048),
            conv("cal.conv.xl", 4, 128, 256, 28, 28, 3, 3),
            attention("cal.attn.xl", 4, 8, 512, 64),
        ]
    return layers


def _active_nest(scheme: LayerScheme) -> tuple:
    """The DRAM-level loops that actually run (dims with tf > 1, in nest
    order): two orders with the same active nest lower to the same plan."""
    top = scheme.levels[-1]
    sig = [d for d in top.order if top.tf(d) > 1]
    sig += [d for d in scheme.layer.dims if top.tf(d) > 1 and d not in sig]
    return tuple(sig)


def scheme_variants(layer: LayerSpec, hw: HWTemplate,
                    n_variants: int = 2) -> List[LayerScheme]:
    """The solver's best scheme plus up to ``n_variants`` DRAM loop-order
    variants of it (identical factors, different outermost nest).  Orders
    whose *active* nest matches an already-kept scheme are skipped, so
    every returned scheme lowers to a distinct plan."""
    scheme, cost = solve_intra_layer(layer, hw,
                                     Constraints(nodes=hw.node_array))
    if scheme is None or not cost.valid:
        return []
    out = [scheme]
    seen = {_active_nest(scheme)}
    for order in canonical_orders():
        if len(out) >= 1 + n_variants:
            break
        var = LayerScheme(layer, [lv.copy() for lv in scheme.levels])
        var.levels[-1].order = tuple(order)
        sig = _active_nest(var)
        if sig in seen:
            continue
        seen.add(sig)
        out.append(var)
    return out


# ---------------------------------------------------------------------------
# Calibration run
# ---------------------------------------------------------------------------

def fit_calibration(pairs: List[Dict], hw: HWTemplate,
                    backend: str = "cuda") -> Calibration:
    """Least-squares fit: measured_seconds ~ cycle terms + grid steps,
    stamped with the backend it measured."""
    X = np.array([[p["cyc_compute"], p["cyc_dram"], p["cyc_gbuf"],
                   p["grid_steps"], 1.0] for p in pairs])
    y = np.array([p["measured_seconds"] for p in pairs])
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    raw = [p["predicted_cycles"] for p in pairs]
    return Calibration(
        a_compute=float(coef[0]), a_dram=float(coef[1]),
        a_gbuf=float(coef[2]), a_step=float(coef[3]),
        intercept=float(coef[4]),
        spearman=spearman(raw, y), n_pairs=len(pairs), backend=backend)


def run_calibration(hw: Optional[HWTemplate] = None, quick: bool = True,
                    layers: Optional[Sequence[LayerSpec]] = None,
                    n_variants: int = 3, device=None, verify: bool = True,
                    iters: int = 2, seed: int = 0,
                    fused: bool = False) -> Dict:
    """Full calibration sweep on ``device`` (the card unless ``"cpu"``);
    returns a JSON-safe record whose ``calibration`` round-trips through
    ``Calibration.from_json_dict``.  Each pair launches its kernel once for
    the warm-up and the numerics check together, then ``iters`` times for
    the timing (min), fenced by ``torch.cuda.synchronize``; with ``fused``
    each plan replays as a one-kernel CUDA graph (``plan_runner``)."""
    dev = kbackend.resolve_device(device)
    backend = backend_label(dev, fused)
    hw = hw if hw is not None else default_hw()
    layers = list(layers) if layers is not None else default_sweep(quick)
    pairs: List[Dict] = []
    skipped: List[Dict] = []
    for layer in layers:
        for vi, scheme in enumerate(scheme_variants(layer, hw, n_variants)):
            plan = lower_scheme(scheme, hw)
            if not plan.valid:
                skipped.append({"layer": layer.name, "variant": vi,
                                "reason": plan.reason})
                continue
            entry = {
                "layer": layer.name, "kind": plan.kind, "variant": vi,
                "grid": [(ax.dim, ax.steps) for ax in plan.grid],
                "grid_steps": plan.grid_steps,
                "predicted_cycles": plan.predicted.latency_cycles,
                "predicted_energy_pj": plan.predicted.energy_pj,
                "predicted_seconds_raw":
                    plan.predicted.latency_cycles / hw.freq_hz,
            }
            entry.update(cycle_terms(plan.predicted, layer.total_macs(), hw))
            # one runner serves the warm-up, the numerics check and the
            # timing: the warm-up's output is the one checked
            inputs = make_inputs(plan, seed, dev)
            # in the layout the kernel reads, converted once, outside the
            # calls timed
            feed = kernel_inputs(plan, inputs, dev)
            run = plan_runner(plan, dev, fused)
            out = run(feed)
            _sync(dev)
            if verify:
                err = rel_error(out, reference_output(plan, inputs))
                entry["rel_err"] = err
                if err >= 1e-3:
                    skipped.append({"layer": layer.name, "variant": vi,
                                    "reason": f"numerics {err:.2e}"})
                    continue
            best = float("inf")
            for _ in range(max(1, iters)):
                t0 = time.perf_counter()
                run(feed)
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
            entry["measured_seconds"] = best
            record_latency_drift(entry["predicted_seconds_raw"], best,
                                 source="calibration", backend=backend)
            pairs.append(entry)

    record: Dict = {
        "hw": hw.name,
        "backend": backend,
        "n_pairs": len(pairs),
        "pairs": pairs,
        "skipped": skipped,
    }
    if len(pairs) >= 3:
        cal = fit_calibration(pairs, hw, backend=backend)
        measured = [p["measured_seconds"] for p in pairs]
        calibrated = [
            cal.a_compute * p["cyc_compute"] + cal.a_dram * p["cyc_dram"]
            + cal.a_gbuf * p["cyc_gbuf"] + cal.a_step * p["grid_steps"]
            + cal.intercept for p in pairs]
        record["calibration"] = cal.to_json_dict()
        record["spearman_raw"] = cal.spearman
        record["spearman_calibrated"] = spearman(calibrated, measured)
    return record


# ---------------------------------------------------------------------------
# Network-level calibration: solve -> lower_network -> execute -> measure
# ---------------------------------------------------------------------------

def default_network_sweep(quick: bool = True):
    """Registered nets spanning ~2 orders of magnitude of work, every layer
    kind of the network tier (conv/fc/pool/eltwise)."""
    from ..workloads.nets import get_net, transformer
    nets = [get_net("mlp", batch=4), transformer(batch=8, layers=2)]
    if not quick:
        nets += [get_net("lstm", batch=64), get_net("alexnet", batch=1)]
    return nets


def run_network_calibration(hw: Optional[HWTemplate] = None,
                            quick: bool = True, nets=None, device=None,
                            iters: int = 2, seed: int = 0,
                            tol: float = 1e-3, fused: bool = False) -> Dict:
    """End-to-end network calibration on ``device``: each net is solved,
    lowered to a ``NetworkPlan``, verified against the whole-graph
    reference pass, and its measured wall clock compared with the
    schedule's predicted latency (``spearman_network``); ``fused`` runs
    the fused tier (``network_runner``)."""
    from ..core.solver import solve
    from .netexec import (compare_network, make_network_inputs,
                          measure_network, network_runner)
    from .netplan import lower_network

    dev = kbackend.resolve_device(device)
    backend = backend_label(dev, fused)
    hw = hw if hw is not None else default_hw()
    nets = list(nets) if nets is not None else default_network_sweep(quick)
    entries: List[Dict] = []
    skipped: List[Dict] = []
    for net in nets:
        schedule = solve(net, hw)
        if not schedule.valid:
            skipped.append({"net": net.name, "reason": "solve failed"})
            continue
        nplan = lower_network(schedule, net, hw)
        bad = nplan.invalid_layers()
        if bad:
            skipped.append({"net": net.name,
                            "reason": "; ".join(f"{n}: {r}"
                                                for n, r in bad)})
            continue
        # one runner serves verification, warm-up and timing
        inputs = make_network_inputs(nplan, seed, dev)
        run = network_runner(nplan, inputs, dev, fused=fused)
        ver = compare_network(nplan, run(), inputs, tol)
        entry = {
            "net": net.name,
            "n_layers": len(nplan.order),
            "n_segments": len(nplan.segments),
            "n_forwarded": ver.n_forwarded,
            "forwarded": list(nplan.forwarded()),
            "max_rel_err": ver.max_rel_err,
            "worst_layer": ver.worst_layer,
            "predicted_cycles": schedule.total_latency_cycles,
            "predicted_seconds_raw":
                schedule.total_latency_cycles / hw.freq_hz,
            "predicted_energy_pj": schedule.total_energy_pj,
            "solve_seconds": schedule.solve_seconds,
        }
        if not ver.ok:
            skipped.append({"net": net.name, "max_rel_err": ver.max_rel_err,
                            "reason": f"numerics {ver.max_rel_err:.2e} "
                                      f"at {ver.worst_layer}"})
            continue
        entry["measured_seconds"] = measure_network(
            nplan, iters=iters, warmup=0, runner=run,
            predicted_seconds=entry["predicted_seconds_raw"],
            drift_source="calibration")
        entries.append(entry)

    record: Dict = {
        "hw": hw.name,
        "backend": backend,
        "n_nets": len(entries),
        "nets": entries,
        "skipped": skipped,
    }
    if len(entries) >= 2:
        record["spearman_network"] = spearman(
            [e["predicted_cycles"] for e in entries],
            [e["measured_seconds"] for e in entries])
    return record


def save_record(record: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")


def load_record(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    """The command line (see the module docstring); prints the record
    without its pairs."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lower.calibrate",
        description="Calibrate the cost model against the card (or, with "
                    "--device cpu, the plain PyTorch versions).")
    parser.add_argument("--network", action="store_true",
                        help="run the end-to-end network sweep instead of "
                             "the per-kernel sweep")
    parser.add_argument("--full", action="store_true",
                        help="full sweep (default: quick)")
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--out", default=None,
                        help="write the JSON record here")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--fused", action="store_true",
                        help="measure the fused tier (CUDA graph replays) "
                             "instead of kernels launched one by one")
    args = parser.parse_args(argv)
    if args.network:
        record = run_network_calibration(quick=not args.full,
                                         iters=args.iters,
                                         device=args.device,
                                         fused=args.fused)
    else:
        record = run_calibration(quick=not args.full, iters=args.iters,
                                 device=args.device, fused=args.fused)
    if args.out:
        save_record(record, args.out)
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("pairs", "nets")}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["spearman", "default_hw", "default_sweep", "scheme_variants",
           "fit_calibration", "run_calibration", "save_record",
           "load_record", "Calibration", "default_network_sweep",
           "run_network_calibration", "main"]
