"""``python -m repro_torch.autoshard_plan`` against
``examples/autoshard_plan.py``, each in a process of its own, for
Kimi-K2 ``train_4k`` on both production meshes: the same candidate log
and chosen plan, line for line (both plan for the example's v5e pod
spec); the example leaf specs under the port's per-layer names."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(cmd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable] + cmd, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    lines = out.splitlines()
    cut = lines.index("  example param specs:")
    return lines[:cut], lines[cut + 1:]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_candidate_log_and_choice_match_the_example(multi_pod):
    args = ["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k"] + \
        (["--multi-pod"] if multi_pod else [])
    ref_head, _ = _run(["examples/autoshard_plan.py"] + args)
    port_head, port_specs = _run(["-m", "repro_torch.autoshard_plan"]
                                 + args)
    assert port_head == ref_head
    assert any(line.startswith("  chosen: ") for line in port_head)
    assert len(port_head) > 4               # the candidates are listed
    # the port's per-layer names; the experts sharded over model
    assert any(line.strip().startswith("blocks.1.moe.wi: P('model'")
               for line in port_specs)
