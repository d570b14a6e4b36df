"""The port's observability pieces: latency drift into the histogram, the
trace and the watchdog's sample ring; the watchdog over the port's
calibration records; the solver flight recorder against the JAX package's;
and ``python -m repro_torch.obs`` (explain, watch)."""
import json

import pytest

pytest.importorskip("torch")

from repro.core.solver import solve
from repro.hw.presets import eyeriss_multinode
from repro.workloads.nets import get_net
from repro_torch.core.solver import solve as t_solve
from repro_torch.hw.presets import eyeriss_multinode as t_eyeriss
from repro_torch.lower import (lower_network, make_network_inputs,
                               measure_network, network_runner,
                               record_latency_drift)
from repro_torch.lower import calibrate as tcal
from repro_torch.obs import REGISTRY, explain, trace, watch
from repro_torch.obs.__main__ import main
from repro_torch.workloads.layers import attention, conv, fc
from repro_torch.workloads.nets import get_net as t_get_net


def test_latency_drift_histogram_and_event():
    h = REGISTRY.get("latency_drift_ratio")
    before = h.value(source="unit", backend="cuda")
    t = trace.enable()
    try:
        ratio = record_latency_drift(0.010, 0.012, source="unit")
    finally:
        trace.disable()
    assert ratio == pytest.approx(1.2)
    assert h.value(source="unit", backend="cuda") == before + 1
    (ev,) = t.find("netexec.latency_drift")
    assert ev["args"]["source"] == "unit"
    assert ev["args"]["backend"] == "cuda"
    assert ev["args"]["ratio"] == pytest.approx(1.2, abs=1e-3)
    b_cpu = h.value(source="unit", backend="cpu")
    record_latency_drift(0.010, 0.011, source="unit", backend="cpu")
    assert h.value(source="unit", backend="cpu") == b_cpu + 1
    assert h.value(source="unit", backend="cuda") == before + 1
    # degenerate inputs are refused, not observed
    assert record_latency_drift(0.0, 1.0, source="unit") is None
    assert record_latency_drift(1.0, float("nan"), source="unit") is None
    assert h.value(source="unit", backend="cuda") == before + 1


def test_drift_feeds_the_watchdog_sample_ring():
    watch.clear_samples()
    record_latency_drift(0.010, 0.012, source="ring", backend="unit")
    record_latency_drift(0.010, 0.014, source="ring", backend="unit")
    samples = watch.recent_samples()
    assert [s["source"] for s in samples] == ["ring", "ring"]
    assert samples[-1]["measured"] == pytest.approx(0.014)
    rep = watch.samples_report()
    assert rep["ring|unit"]["count"] == 2
    assert rep["ring|unit"]["median_ratio"] == pytest.approx(1.3)
    watch.clear_samples()
    assert watch.samples_report() == {}


def test_measure_network_records_drift_on_cpu():
    net = t_get_net("mlp", batch=4)
    hw = t_eyeriss(nodes=4, pe=8)
    nplan = lower_network(t_solve(net, hw), net, hw)
    run = network_runner(nplan, make_network_inputs(nplan, device="cpu"),
                         device="cpu")
    h = REGISTRY.get("latency_drift_ratio")
    before = h.value(source="unit-net", backend="cpu")
    watch.clear_samples()
    # no device given: the label comes from where the runs went
    sec = measure_network(nplan, runner=run, warmup=0, iters=1,
                          predicted_seconds=1e-3, drift_source="unit-net")
    assert sec > 0
    assert h.value(source="unit-net", backend="cpu") == before + 1
    (sample,) = watch.recent_samples()
    assert sample["backend"] == "cpu"
    assert sample["ratio"] == pytest.approx(sec / 1e-3)
    watch.clear_samples()


@pytest.fixture(scope="module")
def cpu_record():
    layers = [fc("o.fc.s", 32, 64, 64), fc("o.fc.m", 64, 512, 512),
              fc("o.fc.l", 128, 1024, 1024),
              conv("o.conv.s", 2, 16, 32, 14, 14, 3, 3),
              conv("o.conv.m", 2, 64, 64, 28, 28, 3, 3),
              attention("o.attn", 2, 4, 256, 64)]
    rec = tcal.run_calibration(tcal.default_hw(), layers=layers,
                               n_variants=2, iters=1, device="cpu")
    assert rec["backend"] == "cpu" and rec["n_pairs"] >= 8, rec["skipped"]
    return rec


def test_watch_reads_a_port_record(cpu_record):
    findings = []
    out = watch.check_calibration_record(cpu_record, "cpu", findings)
    assert out["backend"] == "cpu"
    assert out["n_pairs"] == cpu_record["n_pairs"]
    # the stored rank correlation is the one its own pairs give: not stale
    assert out["stored_rank_corr"] == pytest.approx(out["rank_corr"],
                                                    abs=1e-12)
    assert not any("stale" in f["message"] for f in findings)


def _explained(record):
    """The record's own pairs (real cycle terms and grid steps) with
    measurements an affine function of them, 1% off, and the coefficients
    that made them: a fit the watchdog must pass."""
    rec = json.loads(json.dumps(record))
    terms = ("cyc_compute", "cyc_dram", "cyc_gbuf", "grid_steps")
    coef = {}
    for name, t in zip(("a_compute", "a_dram", "a_gbuf", "a_step"), terms):
        mean = sum(p[t] for p in rec["pairs"]) / len(rec["pairs"])
        coef[name] = 1e-3 / mean if mean > 0 else 0.0
    coef["intercept"] = 1e-4
    for i, p in enumerate(rec["pairs"]):
        p["measured_seconds"] = (
            sum(coef[n] * p[t] for n, t in zip(coef, terms))
            + coef["intercept"]) * (1.0 + 0.01 * ((i % 3) - 1))
    rec["calibration"].update(coef)
    pred = [sum(coef[n] * p[t] for n, t in zip(coef, terms))
            + coef["intercept"] for p in rec["pairs"]]
    rec["spearman_calibrated"] = tcal.spearman(
        pred, [p["measured_seconds"] for p in rec["pairs"]])
    return rec


def test_watch_passes_and_flags_port_records(cpu_record, tmp_path, capsys):
    good = _explained(cpu_record)
    findings = []
    out = watch.check_calibration_record(good, "good", findings)
    assert out["ok"] and not findings, findings
    assert out["r2"] > 0.9 and out["rank_corr"] > 0.9
    bad = json.loads(json.dumps(good))
    bad["calibration"]["a_dram"] *= 100.0       # a corrupted coefficient
    findings = []
    assert not watch.check_calibration_record(bad, "bad", findings)["ok"]
    assert any(f["severity"] == "error" for f in findings)
    stale = json.loads(json.dumps(good))
    stale["spearman_calibrated"] = 0.2
    findings = []
    watch.check_calibration_record(stale, "stale", findings)
    assert any("stale" in f["message"] for f in findings)
    # ...and through the CLI: --gate exits 1 on the corrupted record
    paths = {}
    for name, rec in (("good", good), ("bad", bad)):
        paths[name] = str(tmp_path / f"{name}.json")
        tcal.save_record(rec, paths[name])
    assert main(["watch", "--calibration", paths["good"], "--gate"]) == 0
    assert "backend=cpu" in capsys.readouterr().out
    report_path = str(tmp_path / "report.json")
    assert main(["watch", "--calibration", paths["bad"], "--gate",
                 "--out", report_path]) == 1
    assert "FAILING" in capsys.readouterr().out
    with open(report_path) as f:
        report = json.load(f)
    assert not report["ok"] and report["n_errors"] >= 1


def _untimed(d):
    if isinstance(d, dict):
        return {k: _untimed(v) for k, v in d.items()
                if not k.endswith("seconds")}
    if isinstance(d, list):
        return [_untimed(v) for v in d]
    return d


def test_explain_record_matches_reference():
    ref = solve(get_net("alexnet", batch=1), eyeriss_multinode(),
                explain=True).explain
    port = t_solve(t_get_net("alexnet", batch=1), t_eyeriss(),
                   explain=True).explain
    assert port is not None and port["funnel"]
    assert _untimed(json.loads(json.dumps(port))) == \
        _untimed(json.loads(json.dumps(ref)))
    text = explain.render(port)
    assert "alexnet" in text


def test_obs_cli_explain(capsys, tmp_path):
    assert main(["explain", "alexnet/b1"]) == 0
    out = capsys.readouterr().out
    assert out.strip() and "alexnet" in out
    assert main(["explain", "alexnet", "--batch", "1", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["graph"] and rec["funnel"]
    assert main(["explain", "no-such-net"]) == 1
    # a store dir that does not exist holds nothing: the net is solved
    # fresh, as the reference's CLI does
    assert main(["explain", "alexnet/b1", "--store-dir",
                 str(tmp_path / "no-store")]) == 0
    assert "alexnet" in capsys.readouterr().out
