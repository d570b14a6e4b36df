"""Drift watchdog: predicted-vs-measured latency health over time.

The solver's trustworthiness rests on its calibrated cost model; this
module watches the places where model and hardware meet and flags decay:

* **live drift**: every ``netexec.record_latency_drift`` call (serving,
  calibration sweeps, autotune) lands in the
  ``latency_drift_ratio{source, backend}`` histogram *and* in a small
  sample ring here (``note_sample``), so the watchdog can summarize
  recent measured/predicted ratios per backend with p50/p95/p99;
* **rolling baselines**: per-series EWMA of the drift median persisted
  in a state file — a backend whose current median moves away from its
  own history gets flagged, without hard-coding what "normal" drift is
  for an interpreter vs a compiled tier;
* **calibration fit quality**: a committed ``BENCH_calibration.json`` is
  re-checked from its raw (cycle-terms, measured-seconds) pairs — the
  stored coefficients must still *explain* the stored measurements
  (R² and rank correlation).  A corrupted or stale fit fails loudly
  even though the record "looks" complete;
* **bench regressions**: current ``BENCH_*.json`` records are compared
  against committed baselines — quality metrics (spearman, availability)
  must not drop, timing metrics must not blow up.

``python -m repro.obs watch`` renders the report; ``--gate`` exits
non-zero on any *error* finding, the CI hook.  Zero dependencies, and no
solver imports — the watchdog reads records, it never runs solves.
"""
from __future__ import annotations

import collections
import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import is_off, series_quantiles

# -- thresholds (module constants so tests can reference them) ----------------

#: calibration coefficients must still explain the measured pairs
R2_MIN = 0.5
#: ...and order them the way the hardware did
RANK_CORR_MIN = 0.8
#: quality metrics (spearman, availability, speedup) may drop this much
QUALITY_DROP_TOL = 0.10
#: timing metrics may grow this much before a warning (CI machines vary)
TIME_GROWTH_TOL = 0.50
#: absolute floor below which timing deltas are ignored (seconds)
TIME_ABS_FLOOR = 1e-3
#: a drift median this far from its rolling baseline is flagged
BASELINE_RATIO_TOL = 2.0
#: EWMA smoothing for the rolling baselines
EWMA_ALPHA = 0.3


# -- live sample ring ---------------------------------------------------------

_ring_lock = threading.Lock()
_samples: collections.deque = collections.deque(maxlen=512)


def note_sample(predicted_seconds: Optional[float],
                measured_seconds: float, source: str = "netexec",
                backend: str = "interpret") -> None:
    """Record one predicted/measured pair into the watchdog's ring.

    Called by ``lower.netexec.record_latency_drift`` next to the
    histogram observe; the ring keeps the raw recent pairs (the
    histogram only keeps bucket counts), bounded and cheap."""
    if is_off():
        return
    if not predicted_seconds or predicted_seconds <= 0.0:
        return
    if not math.isfinite(measured_seconds) or measured_seconds <= 0.0:
        return
    with _ring_lock:
        _samples.append({"predicted": predicted_seconds,
                         "measured": measured_seconds,
                         "ratio": measured_seconds / predicted_seconds,
                         "source": source, "backend": backend})


def recent_samples() -> List[Dict]:
    with _ring_lock:
        return list(_samples)


def clear_samples() -> None:
    with _ring_lock:
        _samples.clear()


def samples_report() -> Dict[str, Dict]:
    """Recent ring samples grouped by ``source|backend``: count and
    median ratio (exact — the ring has the raw values, unlike the
    bucketed histogram)."""
    groups: Dict[str, List[float]] = {}
    for s in recent_samples():
        groups.setdefault(f"{s['source']}|{s['backend']}",
                          []).append(s["ratio"])
    out = {}
    for key, ratios in sorted(groups.items()):
        ratios.sort()
        n = len(ratios)
        med = ratios[n // 2] if n % 2 else \
            0.5 * (ratios[n // 2 - 1] + ratios[n // 2])
        out[key] = {"count": n, "median_ratio": med,
                    "min_ratio": ratios[0], "max_ratio": ratios[-1]}
    return out


# -- pure-python fit statistics (obs stays numpy-free) ------------------------

def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs)


def _ranks(xs: Sequence[float]) -> List[float]:
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0          # tie-averaged 1-based rank
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def rank_correlation(x: Sequence[float], y: Sequence[float]) -> float:
    """Spearman rank correlation, stdlib-only (mirrors
    ``lower.calibrate.spearman`` without the numpy dependency)."""
    rx, ry = _ranks(x), _ranks(y)
    mx, my = _mean(rx), _mean(ry)
    num = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    den = math.sqrt(sum((a - mx) ** 2 for a in rx)
                    * sum((b - my) ** 2 for b in ry))
    return num / den if den > 0 else 0.0


def r_squared(y: Sequence[float], yhat: Sequence[float]) -> float:
    my = _mean(y)
    ss_tot = sum((v - my) ** 2 for v in y)
    ss_res = sum((v - p) ** 2 for v, p in zip(y, yhat))
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


# -- calibration record health ------------------------------------------------

def _finding(findings: List[Dict], severity: str, check: str,
             subject: str, message: str) -> None:
    findings.append({"severity": severity, "check": check,
                     "subject": subject, "message": message})


def check_calibration_record(record: Dict, name: str = "calibration",
                             findings: Optional[List[Dict]] = None
                             ) -> Dict:
    """Re-derive the fit quality of a calibration record from its own
    raw pairs.  The stored coefficients are applied to the stored cycle
    terms and compared against the stored measurements — a record whose
    coefficients were corrupted (or refit against different data) no
    longer explains its pairs, however plausible each field looks alone.

    Note the checks are *fit-quality* (R², rank correlation), not ratio
    checks: the affine fit has a negative intercept on the committed
    interpreter record, so small predictions legitimately go non-
    positive and measured/predicted ratios are meaningless there."""
    findings = findings if findings is not None else []
    cal = record.get("calibration")
    pairs = record.get("pairs") or []
    out: Dict = {"name": name, "n_pairs": len(pairs)}
    if not cal:
        _finding(findings, "error", "calibration", name,
                 "record has no fitted calibration block")
        out["ok"] = False
        return out
    if len(pairs) < 3:
        _finding(findings, "error", "calibration", name,
                 f"only {len(pairs)} measured pairs (need >= 3 to "
                 "judge the fit)")
        out["ok"] = False
        return out
    meas = [p["measured_seconds"] for p in pairs]
    pred = [cal["a_compute"] * p["cyc_compute"]
            + cal["a_dram"] * p["cyc_dram"]
            + cal["a_gbuf"] * p["cyc_gbuf"]
            + cal["a_step"] * p["grid_steps"]
            + cal["intercept"] for p in pairs]
    out["r2"] = r_squared(meas, pred)
    out["rank_corr"] = rank_correlation(pred, meas)
    out["backend"] = cal.get("backend", record.get("backend", "?"))
    stored = record.get("spearman_calibrated")
    if stored is not None:
        out["stored_rank_corr"] = stored
        if abs(stored - out["rank_corr"]) > 0.05:
            _finding(findings, "error", "calibration", name,
                     f"stored spearman_calibrated {stored:.3f} does not "
                     f"match recomputed {out['rank_corr']:.3f} — record "
                     "is stale or inconsistent with its own pairs")
    if out["r2"] < R2_MIN:
        _finding(findings, "error", "calibration", name,
                 f"fit no longer explains its measurements: R2 "
                 f"{out['r2']:.3f} < {R2_MIN} — recalibrate")
    if out["rank_corr"] < RANK_CORR_MIN:
        _finding(findings, "error", "calibration", name,
                 f"fit mis-orders its measurements: rank corr "
                 f"{out['rank_corr']:.3f} < {RANK_CORR_MIN} — "
                 "recalibrate")
    out["ok"] = not any(f["severity"] == "error"
                        and f["subject"] == name for f in findings)
    return out


# -- bench-record regression check --------------------------------------------

#: metric-key classification for the generic record walk
_HIGHER_BETTER = ("speedup", "spearman", "availability", "_per_sec")
_LOWER_BETTER = ("seconds", "overhead", "rel_err")


def _classify_key(key: str) -> Optional[str]:
    k = key.lower()
    for pat in _HIGHER_BETTER:
        if pat in k:
            return "higher"
    for pat in _LOWER_BETTER:
        if pat in k:
            return "lower"
    return None


def _walk_numbers(d, path="") -> Dict[str, float]:
    out: Dict[str, float] = {}
    if isinstance(d, dict):
        for k, v in d.items():
            out.update(_walk_numbers(v, f"{path}.{k}" if path else k))
    elif isinstance(d, (int, float)) and not isinstance(d, bool):
        if math.isfinite(d):
            out[path] = float(d)
    return out


def check_bench_regression(name: str, current: Dict, baseline: Dict,
                           findings: Optional[List[Dict]] = None,
                           time_tol: float = TIME_GROWTH_TOL,
                           quality_tol: float = QUALITY_DROP_TOL
                           ) -> Dict:
    """Compare a current bench record against its committed baseline.

    Quality metrics (spearman / availability) dropping by more than
    ``quality_tol`` are **errors**; speedup/throughput drops and timing
    growth beyond ``time_tol`` are **warnings** (CI machines differ, the
    trend matters more than one sample)."""
    findings = findings if findings is not None else []
    cur = _walk_numbers(current)
    base = _walk_numbers(baseline)
    compared, regressions = 0, []
    for path, bval in sorted(base.items()):
        cval = cur.get(path)
        kind = _classify_key(path.rsplit(".", 1)[-1])
        if cval is None or kind is None:
            continue
        compared += 1
        if kind == "higher":
            if bval > 0 and cval < bval * (1.0 - quality_tol):
                key = path.rsplit(".", 1)[-1].lower()
                hard = "spearman" in key or "availability" in key
                sev = "error" if hard else "warn"
                msg = (f"{path}: {cval:.4g} dropped from baseline "
                       f"{bval:.4g} (-{(1 - cval / bval) * 100:.1f}%)")
                _finding(findings, sev, "bench", name, msg)
                regressions.append({"path": path, "current": cval,
                                    "baseline": bval, "severity": sev})
        else:
            if cval > bval * (1.0 + time_tol) \
                    and cval - bval > TIME_ABS_FLOOR:
                msg = (f"{path}: {cval:.4g} grew from baseline "
                       f"{bval:.4g} (+{(cval / bval - 1) * 100:.1f}%)")
                _finding(findings, "warn", "bench", name, msg)
                regressions.append({"path": path, "current": cval,
                                    "baseline": bval,
                                    "severity": "warn"})
    return {"name": name, "compared": compared,
            "regressions": regressions,
            "ok": not any(r["severity"] == "error"
                          for r in regressions)}


# -- drift quantiles + rolling EWMA baselines ---------------------------------

def drift_from_snapshot(snapshot: Dict) -> Dict[str, Dict]:
    """Per-``source|backend`` drift summary from a registry snapshot
    (live ``REGISTRY.snapshot()`` or a JSON file of one): count plus
    interpolated p50/p95/p99 of ``latency_drift_ratio``."""
    fam = snapshot.get("latency_drift_ratio")
    if not fam:
        return {}
    out: Dict[str, Dict] = {}
    for s in fam.get("series", []):
        labels = s.get("labels", {})
        key = f"{labels.get('source', '?')}|{labels.get('backend', '?')}"
        q = series_quantiles(s)
        out[key] = {"count": s.get("count", 0), **q}
    return out


def load_state(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"version": 1, "baselines": {}}


def save_state(state: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(state, f, indent=2)
        f.write("\n")


def update_baselines(state: Dict, drift: Dict[str, Dict],
                     findings: Optional[List[Dict]] = None,
                     alpha: float = EWMA_ALPHA,
                     ratio_tol: float = BASELINE_RATIO_TOL) -> Dict:
    """Fold the current per-series drift medians into the rolling EWMA
    baselines; a median ``ratio_tol``x away from its own history (either
    direction) is flagged.  Returns the mutated state."""
    findings = findings if findings is not None else []
    baselines = state.setdefault("baselines", {})
    for key, summary in sorted(drift.items()):
        p50 = summary.get("p50")
        if p50 is None or not math.isfinite(p50) or p50 <= 0:
            continue
        b = baselines.get(key)
        if b is None:
            baselines[key] = {"ewma_p50": p50, "n": 1}
            summary["baseline_p50"] = p50
            continue
        prior = b["ewma_p50"]
        summary["baseline_p50"] = prior
        rel = p50 / prior if prior > 0 else float("inf")
        summary["vs_baseline"] = rel
        if rel > ratio_tol or rel < 1.0 / ratio_tol:
            _finding(findings, "warn", "drift", key,
                     f"drift median {p50:.3g} is {rel:.2f}x its rolling "
                     f"baseline {prior:.3g}")
        b["ewma_p50"] = (1.0 - alpha) * prior + alpha * p50
        b["n"] = b.get("n", 0) + 1
    return state


# -- the watchdog run ---------------------------------------------------------

def run_watch(calibrations: Sequence[Tuple[str, Dict]] = (),
              benches: Sequence[Tuple[str, Dict, Dict]] = (),
              snapshot: Optional[Dict] = None,
              state: Optional[Dict] = None) -> Dict:
    """One watchdog pass over everything it was given:
    ``calibrations`` are ``(name, record)`` pairs, ``benches`` are
    ``(name, current, baseline)`` triples, ``snapshot`` a metrics
    registry snapshot, ``state`` the rolling-baseline state (mutated in
    place when given).  Returns the JSON-safe report; ``report["ok"]``
    is False iff any error-severity finding fired (the ``--gate``
    bit)."""
    findings: List[Dict] = []
    report: Dict = {"version": 1, "findings": findings}
    report["calibration"] = {
        name: check_calibration_record(rec, name, findings)
        for name, rec in calibrations}
    report["bench"] = {
        name: check_bench_regression(name, cur, base, findings)
        for name, cur, base in benches}
    if snapshot is not None:
        drift = drift_from_snapshot(snapshot)
        if state is not None:
            update_baselines(state, drift, findings)
        report["drift"] = drift
    samples = samples_report()
    if samples:
        report["samples"] = samples
    report["n_errors"] = sum(1 for f in findings
                             if f["severity"] == "error")
    report["n_warnings"] = sum(1 for f in findings
                               if f["severity"] == "warn")
    report["ok"] = report["n_errors"] == 0
    return report


def render_report(report: Dict) -> str:
    """Human rendering of a ``run_watch`` report."""
    lines: List[str] = []
    ok = report.get("ok", False)
    lines.append(f"drift watchdog: {'OK' if ok else 'FAILING'} "
                 f"({report.get('n_errors', 0)} error(s), "
                 f"{report.get('n_warnings', 0)} warning(s))")
    for name, c in sorted(report.get("calibration", {}).items()):
        if "r2" in c:
            lines.append(f"  calibration[{name}] backend="
                         f"{c.get('backend', '?')}: R2 {c['r2']:.3f}, "
                         f"rank corr {c['rank_corr']:.3f} over "
                         f"{c['n_pairs']} pairs -> "
                         f"{'ok' if c.get('ok') else 'FAIL'}")
        else:
            lines.append(f"  calibration[{name}]: "
                         f"{'ok' if c.get('ok') else 'FAIL'}")
    for name, b in sorted(report.get("bench", {}).items()):
        lines.append(f"  bench[{name}]: {b['compared']} metrics vs "
                     f"baseline, {len(b['regressions'])} regressed")
    for key, d in sorted(report.get("drift", {}).items()):
        extra = ""
        if "vs_baseline" in d:
            extra = f", {d['vs_baseline']:.2f}x rolling baseline"
        lines.append(f"  drift[{key}]: n={d.get('count', 0)} "
                     f"p50={d.get('p50', float('nan')):.3g} "
                     f"p95={d.get('p95', float('nan')):.3g} "
                     f"p99={d.get('p99', float('nan')):.3g}{extra}")
    for key, s in sorted(report.get("samples", {}).items()):
        lines.append(f"  samples[{key}]: n={s['count']} median ratio "
                     f"{s['median_ratio']:.3g}")
    for f in report.get("findings", []):
        lines.append(f"  {f['severity'].upper()} {f['check']}"
                     f"[{f['subject']}]: {f['message']}")
    return "\n".join(lines)


__all__ = ["note_sample", "recent_samples", "clear_samples",
           "samples_report", "rank_correlation", "r_squared",
           "check_calibration_record", "check_bench_regression",
           "drift_from_snapshot", "load_state", "save_state",
           "update_baselines", "run_watch", "render_report",
           "R2_MIN", "RANK_CORR_MIN"]
