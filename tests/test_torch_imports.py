"""The PyTorch/CUDA port (src/repro_torch), chip_smoke.py and the port's
tools import neither jax nor anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top.startswith("jax") or top == "repro"


def test_port_sources_import_no_jax_and_no_repro():
    assert len(PORT_FILES) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in PORT_FILES
           for m in _absolute_imports(f) if _forbidden(m)]
    assert not bad, bad


SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
import repro_torch.lower.calibrate
import repro_torch.lower.fuse
import repro_torch.obs.__main__
import repro_torch.quickstart
import repro_torch.service.__main__
import repro_torch.checkpoint.ckpt
import repro_torch.data.pipeline
import repro_torch.launch.serve
import repro_torch.launch.train
import repro_torch.optim.compression
import repro_torch.optim.optimizers
import repro_torch.hw.gpu
import repro_torch.core.autoshard
import repro_torch.launch.mesh
import repro_torch.launch.op_cost
import repro_torch.launch.dryrun
import repro_torch.launch.roofline
from repro_torch.core.solver import solve
from repro_torch.hw.presets import eyeriss_multinode
from repro_torch.lower import lower_network
from repro_torch.obs import explain
from repro_torch.workloads.nets import get_net
net = get_net("alexnet", batch=1)
hw = eyeriss_multinode()
sched = solve(net, hw, explain=True)
nplan = lower_network(sched, net, hw)
assert sched.valid and nplan.executable, nplan.invalid_layers()
assert sched.explain["funnel"] and explain.render(sched.explain)
print(sorted(m for m, v in sys.modules.items() if v is not None
             and (m.split(".")[0] == "repro" or m.startswith("jax"))))
"""


def test_port_solves_and_lowers_with_jax_and_repro_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
