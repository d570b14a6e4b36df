"""The port's calibration sweep vs the JAX package's: the same layers
through both ``run_calibration``s (the port on the CPU, through its plain
versions; the reference in Pallas interpret mode) give the same pairs on
every deterministic field, both within 1e-3 of their oracles; the fit, the
rank correlation and the network sweep agree."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.lower import calibrate as jcal
from repro.workloads.layers import attention, conv, fc
from repro_torch.lower import calibrate as tcal
from repro_torch.workloads.layers import attention as t_attention
from repro_torch.workloads.layers import conv as t_conv
from repro_torch.workloads.layers import fc as t_fc

#: fc (C as a reduction grid axis in two orders), conv, attention (one
#: plan over N, one with C outermost)
LAYERS = [
    (fc, ("t.cal.fc.s", 32, 64, 64)),
    (fc, ("t.cal.fc.m", 64, 512, 512)),
    (conv, ("t.cal.conv.s", 2, 16, 32, 14, 14, 3, 3)),
    (attention, ("t.cal.attn", 2, 4, 256, 64)),
    (attention, ("t.cal.attn.c", 1, 2, 2048, 64)),
]
PORT = {fc: t_fc, conv: t_conv, attention: t_attention}
DETERMINISTIC = ["layer", "kind", "variant", "grid", "grid_steps",
                 "predicted_cycles", "predicted_energy_pj",
                 "predicted_seconds_raw", "cyc_compute", "cyc_dram",
                 "cyc_gbuf"]


@pytest.fixture(scope="module")
def records():
    ref = jcal.run_calibration(jcal.default_hw(),
                               layers=[f(*a) for f, a in LAYERS],
                               n_variants=1, iters=1)
    port = tcal.run_calibration(tcal.default_hw(),
                                layers=[PORT[f](*a) for f, a in LAYERS],
                                n_variants=1, iters=1, device="cpu")
    return ref, port


def _norm(v):
    return [tuple(g) for g in v] if isinstance(v, list) else v


@pytest.mark.parametrize("field", DETERMINISTIC)
def test_pairs_match_on_deterministic_fields(records, field):
    ref, port = records
    assert port["n_pairs"] == ref["n_pairs"] >= 6, (ref["skipped"],
                                                    port["skipped"])
    assert [_norm(p[field]) for p in port["pairs"]] == \
        [_norm(p[field]) for p in ref["pairs"]]


def test_sweep_covers_c_outermost_attention(records):
    _, port = records
    grids = {tuple(d for d, _ in p["grid"]) for p in port["pairs"]
             if p["layer"] == "t.cal.attn.c"}
    assert grids == {("C", "N", "X")}, grids


def test_both_sides_within_oracle_tolerance(records):
    ref, port = records
    assert not ref["skipped"] and not port["skipped"]
    for rec in records:
        for p in rec["pairs"]:
            assert p["rel_err"] < 1e-3, (p["layer"], p["rel_err"])
            assert p["measured_seconds"] > 0


def test_record_schema_and_backend(records):
    ref, port = records
    assert set(port) == set(ref)
    assert set(port["pairs"][0]) == set(ref["pairs"][0])
    assert port["backend"] == port["calibration"]["backend"] == "cpu"
    assert port["hw"] == ref["hw"]
    assert set(port["calibration"]) == set(ref["calibration"])


def test_fit_matches_on_reference_pairs(records):
    ref, _ = records
    hw = tcal.default_hw()
    want = jcal.fit_calibration(ref["pairs"], jcal.default_hw())
    got = tcal.fit_calibration(ref["pairs"], hw, backend="cpu")
    for name in ("a_compute", "a_dram", "a_gbuf", "a_step", "intercept",
                 "spearman"):
        a, b = getattr(got, name), getattr(want, name)
        assert a == pytest.approx(b, rel=1e-9, abs=1e-300), name
    assert got.n_pairs == want.n_pairs and got.backend == "cpu"


@pytest.mark.parametrize("seed,n,ties", [(0, 5, False), (1, 40, False),
                                         (2, 40, True), (3, 3, True)])
def test_spearman_matches(seed, n, ties):
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    if ties:
        x, y = np.round(x), np.round(y * 2)
    assert tcal.spearman(x, y) == jcal.spearman(x, y)
    assert tcal.spearman(list(x), list(x)) == pytest.approx(1.0)


def test_network_calibration_matches():
    ref = jcal.run_network_calibration(quick=True, iters=1)
    port = tcal.run_network_calibration(quick=True, iters=1, device="cpu")
    assert port["backend"] == "cpu" and set(port) == set(ref)
    assert not port["skipped"] and port["n_nets"] == ref["n_nets"] == 2
    for a, b in zip(port["nets"], ref["nets"]):
        for key in ("net", "n_layers", "n_segments", "n_forwarded",
                    "forwarded", "predicted_cycles", "predicted_energy_pj"):
            assert a[key] == b[key], key
        assert a["max_rel_err"] < 1e-3 and a["measured_seconds"] > 0
    assert "spearman_network" in port


def test_calibrate_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "cal.json"
    assert tcal.main(["--device", "cpu", "--iters", "1",
                      "--out", str(out)]) == 0
    rec = tcal.load_record(str(out))
    assert rec["backend"] == "cpu" and not rec["skipped"]
    assert rec["n_pairs"] >= 20
    kinds = {p["kind"] for p in rec["pairs"]}
    assert kinds == {"fc", "conv", "attention"}
    assert '"backend": "cpu"' in capsys.readouterr().out
