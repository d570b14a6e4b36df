"""The benchmark's files: ``BENCHMARK.json`` within the format's limits,
every part of every cell found by its name, and a cell, a mix and a
metric added as files alone."""
import json
import re
import shutil
from pathlib import Path

import pytest

from bench.harness import cells

ROOT = cells.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits into the driver's 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert all(c in (1, 4) for c in chips)
    assert sum(c == 4 for c in chips) <= max(1, len(chips) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = cells.load_cell(name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert hasattr(cells.metric_reader(m["name"]), "read")
    assert hasattr(cells.driver(cell.driver), "run")
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_a_cell_added_from_files(tmp_path):
    """A new mix, cell, limits and per-layer metric are files and entries
    alone: the harness finds and reads them without an edit."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "bench" / "traffic" / "train_4x256.json").write_text(
        json.dumps({"driver": "train", "batch": 4, "seq": 256}))
    (tmp_path / "bench" / "workloads" / "mamba2-1.3b.train.4x256.json"
     ).write_text(json.dumps({"limits": {"loss_gap": 1e-3}}))
    (tmp_path / "bench" / "metrics" / "steps.train.py").write_text(
        "def read(rec):\n    t = rec.get('train')\n"
        "    return None if not t else t['steps']\n")
    bench["workloads"].append({"name": "mamba2-1.3b.train.4x256",
                               "config": "mamba2-1.3b",
                               "traffic": "train_4x256", "chips": 1,
                               "why": "a smaller batch"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer",
                               "moves": "train_tokens_per_s",
                               "workloads": ["mamba2-1.3b.train.4x256"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("mamba2-1.3b.train.4x256")
    cell = cells.load_cell("mamba2-1.3b.train.4x256", tmp_path, bench)
    assert cell.traffic["batch"] == 4 and cell.driver == "train"
    assert [m["name"] for m in cell.per_layer] == ["steps.train"]
    got = cells.read_metrics(cell, {"train": {"steps": 7}}, tmp_path)
    assert got == {"steps.train": {"value": 7.0, "unit": "steps"}}
    # a reader that finds nothing leaves its metric out
    assert cells.read_metrics(cell, {}, tmp_path) == {}


def test_network_config_is_the_programs_resnet50():
    from repro_torch.workloads.nets import resnet50
    from bench.reference import resnet
    cfg = json.loads((ROOT / "bench/configs/resnet50-b64-16x16.json")
                     .read_text())
    mine = resnet.layers(cfg)
    theirs = resnet50(cfg["batch"]).layers
    assert [l["name"] for l in mine] == [l.name for l in theirs]
    for a, b in zip(mine, theirs):
        assert a["kind"] == b.kind and tuple(a["src"]) == tuple(b.src)
        for d, v in b.dims.items():
            assert a[d] == v, (a["name"], d)
        if a["kind"] in ("conv", "pool"):
            assert (a["R"], a["S"], a["stride"]) == (
                b.meta["R"], b.meta["S"], b.meta["stride"])


def test_lm_config_is_the_published_mamba2():
    """Every width and the depth as the source publishes them, and the
    program's model of that family."""
    from bench.drivers import _lm
    cfg = json.loads((ROOT / "bench/configs/mamba2-1.3b.json").read_text())
    pub = cfg["published"]
    block = pub["Mamba2 block defaults"]
    assert (cfg["d_model"], cfg["num_layers"], cfg["vocab_size"]) == (
        pub["d_model"], pub["n_layer"], pub["vocab_size"])
    assert (cfg["ssm_state"], cfg["ssm_head_dim"], cfg["ssm_expand"],
            cfg["conv_width"]) == (block["d_state"], block["headdim"],
                                   block["expand"], block["d_conv"])
    assert pub["d_intermediate"] == 0 and not pub["attn_layer_idx"]
    assert block["ngroups"] == 1
    # each key changed from the source is in ``reduced``, and none is a
    # width
    assert set(cfg["reduced"]) == set(cfg["changed"]) <= set(pub)
    for k in cfg["reduced"]:
        assert not k.endswith(("_dim", "_rank", "_size", "_state"))
    prog = _lm.model_config(cfg)
    assert prog.family == "ssm" and prog.d_ff == 0 and prog.attn_every == 0
