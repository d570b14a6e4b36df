"""Expert-parallel ``moe_ffn`` (``models/moe.py`` with ``model_axis``)
against the reference's ``moe_ffn`` under ``shard_map``, f32, within 1e-5:
tiny Qwen2-MoE (8 experts, top-2) on the meshes (1, 4) and (2, 2), 6
experts padded to 8 on a model axis of 4, and capacity drops on (2, 2).
The reference runs on 4 host devices in a process of its own
(``tests/_partition_ref.py moe``; this process's JAX keeps one device),
the port on 4 ranks of one gloo group spawned once for the file
(``tests/_partition_ranks.py`` ``moe_cases``): each rank holds its window
of experts and its data shard of tokens, routes with the local capacity
and sums its partial output over ``model`` with one all-reduce."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.partition import run_ranks

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from _partition_ref import MOE  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    subprocess.run([sys.executable, str(HERE / "_partition_ref.py"), "moe",
                    str(out), "--devices", "4"], check=True, env=env,
                   timeout=600)
    ref = np.load(out)
    cases = []
    for name, arch, over, mesh, _, _ in MOE:
        p = {k.split("/")[-1]: ref[k] for k in ref.files
             if k.startswith(f"{name}/p/")}
        cases.append({"name": name, "arch": arch, "over": over,
                      "mesh": mesh, "p": p, "x": ref[f"{name}/x"]})
    got = run_ranks(f"{HERE / '_partition_ranks.py'}:moe_cases", 4, "gloo",
                    {"cases": cases}, timeout=600)[0]
    return {name: ref[f"{name}/y"] for name, *_ in MOE}, got


@pytest.mark.parametrize("name", [c[0] for c in MOE])
def test_expert_parallel_moe_matches_shard_map(results, name):
    want, got = results
    y = got[name]["y"]
    assert y.shape == want[name].shape
    assert float(np.abs(y - want[name]).max()) <= \
        TOL * float(np.abs(want[name]).max())


def test_padded_experts_split_evenly_and_are_never_routed(results):
    """6 experts on a model axis of 4: padded to 8, two a rank; the
    padding experts' -1e30 logits keep every pair off them, so the
    output equals the reference's, which pads the same way."""
    _, got = results
    assert got["padded-6-experts"]["experts"] == 2
    assert got["qwen2-moe-1x4"]["experts"] == 2
    assert got["qwen2-moe-2x2"]["experts"] == 4


def test_capacity_drops_happen_in_the_drop_case(results):
    """At capacity factor 0.5 each rank's capacity, from its data shard's
    64 tokens as in the reference's ``shard_map`` body, drops pairs: the
    match above covers the dropped pairs' zero contributions."""
    _, got = results
    assert got["drops-2x2"]["dropped"] > 0
    assert got["qwen2-moe-2x2"]["dropped"] == 0
