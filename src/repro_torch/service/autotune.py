"""Measured top-k autotuning: re-rank the solver's best-k schedules by
real (executed) runtime on the card and promote the measured winner into
the store.

The port of ``repro/service/autotune.py``.  The analytical model picks an
argmin; the autotuner checks it: the k best valid chains from
``kapla.solve_topk`` are each compiled to a ``NetworkPlan``
(``lower_network``), executed end to end through the port's network
executor (``netexec``, the fused tier by default: one CUDA graph over the
hand-written kernels), verified against the whole-graph reference pass,
and timed.  The measured-fastest schedule is written to the store for the
request's signature with its measured latency recorded alongside the
predicted cost.

Rank agreement between predicted and measured latency across the
candidates (Spearman) is the per-request trust signal, the service-tier
counterpart of the calibration sweeps in ``repro_torch.lower.calibrate``.
"""
from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional

from ..core.solver.kapla import solve_topk
from ..hw.template import HWTemplate
from ..obs import trace
from ..runtime import inject
from ..workloads.layers import LayerGraph
from .signature import schedule_signature, solver_options
from .store import ScheduleStore


class _Skip(Exception):
    """Internal: candidate disqualified for a recorded reason."""


def _run_candidate(rank: int, sched, graph: LayerGraph, hw: HWTemplate,
                   seed: int, iters: int, device, fused: bool,
                   tol: float) -> Dict:
    """Lower + verify + measure one candidate (raises ``_Skip`` with the
    disqualification reason).  Runs inside the per-candidate worker so a
    timeout can abandon it."""
    with trace.span("autotune.candidate", rank=rank, graph=graph.name,
                    device=str(device), fused=fused):
        return _run_candidate_impl(rank, sched, graph, hw, seed, iters,
                                   device, fused, tol)


def _run_candidate_impl(rank: int, sched, graph: LayerGraph,
                        hw: HWTemplate, seed: int, iters: int, device,
                        fused: bool, tol: float) -> Dict:
    # execution lives behind torch; keep the service core numpy-only
    from ..lower.netexec import (compare_network, make_network_inputs,
                                 measure_network, network_runner)
    from ..lower.netplan import lower_network

    # chaos hook: slow sleeps here (counts against the candidate
    # timeout), error raises, nan poisons the measurement below
    spec = inject.maybe_fault("autotune.measure", key=str(rank))
    nplan = lower_network(sched, graph, hw)
    bad = nplan.invalid_layers()
    if bad:
        raise _Skip("; ".join(f"{n}: {r}" for n, r in bad))
    inputs = make_network_inputs(nplan, seed, device)
    run = network_runner(nplan, inputs, device, fused=fused)
    ver = compare_network(nplan, run(), inputs, tol)
    if not ver.ok:
        raise _Skip(f"numerics {ver.max_rel_err:.2e} at "
                    f"{ver.worst_layer}")
    measured = measure_network(
        nplan, iters=iters, warmup=0, runner=run,
        predicted_seconds=sched.total_latency_cycles / hw.freq_hz,
        drift_source="autotune")
    if spec is not None and spec.kind == "nan":
        measured = float("nan")
    return {
        "rank": rank,
        "n_segments": 0 if sched.chain is None
        else len(sched.chain.segments),
        "predicted_cycles": sched.total_latency_cycles,
        "predicted_energy_pj": sched.total_energy_pj,
        "max_rel_err": ver.max_rel_err,
        "measured_seconds": measured,
    }


def autotune_network(graph: LayerGraph, hw: HWTemplate,
                     store: Optional[ScheduleStore] = None, k: int = 3,
                     iters: int = 2, device=None, seed: int = 0,
                     max_workers: Optional[int] = None,
                     tol: float = 1e-3,
                     candidate_timeout_s: Optional[float] = None,
                     fused: bool = True,
                     explain: bool = False,
                     **options) -> Dict:
    """Autotune one network on ``device`` (the card unless ``"cpu"``);
    returns a JSON-safe report.  Candidates that fail to lower or verify,
    or that crash, return a non-finite measurement, or exceed
    ``candidate_timeout_s``, are disqualified with a recorded reason
    instead of aborting the run; the report's ``candidates`` are the ones
    that really executed.

    Measured re-ranking runs on the fused tier by default (``fused=True``):
    top-k candidates with equal plan signatures share the process-wide
    graph cache (``lower.fuse``), so re-measuring a candidate captures
    nothing again.  Pass ``fused=False`` to rank on the per-layer tier."""
    from ..kernels.backend import resolve_device
    from ..lower.calibrate import spearman
    from ..lower.netexec import backend_label

    dev = resolve_device(device)
    backend = backend_label(dev, fused)

    opts = solver_options(**options)
    t0 = time.perf_counter()
    cands = solve_topk(graph, hw, k=k, max_workers=max_workers,
                       explain=explain, **opts)
    entries: List[Dict] = []
    skipped: List[Dict] = []
    for rank, sched in enumerate(cands):
        try:
            if candidate_timeout_s is None:
                entry = _run_candidate(rank, sched, graph, hw, seed,
                                       iters, dev, fused, tol)
            else:
                # a fresh single-thread pool per candidate: a hung
                # measurement is abandoned (the thread leaks until it
                # returns, the run does not)
                ex = ThreadPoolExecutor(max_workers=1)
                try:
                    entry = ex.submit(
                        _run_candidate, rank, sched, graph, hw, seed,
                        iters, dev, fused, tol
                    ).result(timeout=candidate_timeout_s)
                finally:
                    ex.shutdown(wait=False)
        except _Skip as e:
            skipped.append({"rank": rank, "reason": str(e)})
            continue
        except FutureTimeout:
            skipped.append({"rank": rank, "reason":
                            f"timeout after {candidate_timeout_s}s"})
            continue
        except Exception as e:          # crash disqualifies, never aborts
            skipped.append({"rank": rank, "reason": f"crashed: {e!r}"})
            continue
        if not math.isfinite(entry["measured_seconds"]):
            skipped.append({"rank": rank, "reason":
                            "non-finite measurement"})
            continue
        entries.append(entry)
    report: Dict = {
        "net": graph.name,
        "hw": hw.name,
        "options": opts,
        "k_requested": k,
        "n_candidates": len(cands),
        "n_executed": len(entries),
        "candidates": entries,
        "skipped": skipped,
        "autotune_seconds": time.perf_counter() - t0,
    }
    if not entries:
        return report
    preds = [e["predicted_cycles"] for e in entries]
    if len(entries) >= 2 and len(set(preds)) > 1:
        report["rank_agreement"] = spearman(
            preds, [e["measured_seconds"] for e in entries])
    elif len(entries) >= 2:
        # all candidates predicted exactly equal: rank agreement is
        # undefined, not zero
        report["rank_agreement"] = None
    best = min(entries, key=lambda e: e["measured_seconds"])
    argmin = next((e for e in entries if e["rank"] == 0), None)
    report["promoted_rank"] = best["rank"]
    report["promoted_measured_seconds"] = best["measured_seconds"]
    if argmin is not None:
        report["argmin_measured_seconds"] = argmin["measured_seconds"]
    sig = schedule_signature(graph, hw, opts)
    report["signature"] = sig
    if store is not None:
        measured_meta = {
            "measured_seconds": best["measured_seconds"],
            "predicted_cycles": best["predicted_cycles"],
            "rank": best["rank"],
            "backend": backend,
            "rank_agreement": report.get("rank_agreement"),
            "n_candidates_executed": len(entries),
        }
        try:
            store.put(cands[best["rank"]], graph, hw, opts, sig=sig,
                      measured=measured_meta)
            report["promoted"] = True
        except Exception as e:      # a broken store loses the promotion,
            report["promoted"] = False      # never the measurements
            report["promote_error"] = repr(e)
    return report


__all__ = ["autotune_network"]
