"""Where a cell's parts live, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Its parts are files of their own, so that a cell, a configuration,
a mix or a per-layer metric is added by adding files:

* the configuration: the ``file`` its ``configs`` entry gives;
* the traffic mix: ``bench/traffic/<traffic>.json``, whose ``driver``
  names the driver that runs it, ``bench/drivers/<driver>.py``;
* the cell's correctness limits: ``bench/workloads/<cell>.json``;
* each per-layer metric: ``bench/metrics/<metric>.py``, whose ``read``
  takes the run's records and returns a number or None.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Mapping, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    why: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reported(metric: Mapping, cell: str, entries: Mapping) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list,
    or, without one, every cell that reports the end-to-end metric it
    moves (an end-to-end metric without a list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return _reported(entries[moves], cell, entries)


def load_cell(name: str, root: Path = ROOT,
              benchmark: Optional[Mapping] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, limits and
    metrics; a missing entry or file raises."""
    bench = benchmark if benchmark is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "bench" / "workloads" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return Cell(
        name=name, chips=int(w["chips"]), why=w["why"], config=config,
        traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"]
                    if _reported(m, name, e2e)],
        per_layer=[m for m in bench["per_layer"]
                   if _reported(m, name, e2e)])


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} (for {name!r}) is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT) -> ModuleType:
    """``bench/drivers/<name>.py``."""
    return _module(root / "bench" / "drivers" / f"{name}.py", name)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``bench/metrics/<name>.py`` (a metric's dots kept in the file
    name)."""
    return _module(root / "bench" / "metrics" / f"{name}.py", name)


def read_metrics(cell: Cell, records: Mapping,
                 root: Path = ROOT) -> Dict[str, Dict]:
    """Every per-layer metric of ``cell`` that finds something to read in
    ``records``, by name, with its unit."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root).read(records)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
