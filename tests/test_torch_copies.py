"""The port's numpy modules are byte-identical copies of the JAX package's,
and the port's solver and planners pick exactly the reference's schedules
and plans."""
import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import get_config, list_archs
from repro.core.solver import solve
from repro.hw.presets import eyeriss_multinode
from repro.workloads.nets import get_net, transformer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.core.solver import solve as t_solve
from repro_torch.hw.presets import eyeriss_multinode as t_eyeriss
from repro_torch.lower import lower_network as t_lower_network
from repro_torch.workloads.nets import get_net as t_get_net
from repro_torch.workloads.nets import transformer as t_transformer

SRC = Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "workloads/layers.py", "workloads/nets.py",
    "hw/template.py", "hw/presets.py",
    "core/directives.py", "core/cost_model.py", "core/cost_batch.py",
    "core/estimate.py", "core/estimate_batch.py",
    "obs/metrics.py", "obs/trace.py", "obs/watch.py", "obs/explain.py",
    "runtime/inject.py", "runtime/fault.py", "runtime/straggler.py",
    "core/solver/__init__.py",
    "core/solver/memo.py", "core/solver/intralayer.py",
    "core/solver/interlayer.py", "core/solver/kapla.py",
    "core/solver/random_search.py", "core/solver/exhaustive.py",
    "core/solver/annealing.py", "core/solver/multinode.py",
    "service/signature.py", "service/store.py", "service/client.py",
    "service/server.py",
    "lower/plan.py", "lower/netplan.py",
    "configs/__init__.py", "configs/base.py", "configs/registry.py",
    "configs/gemma2_2b.py", "configs/internlm2_20b.py",
    "configs/internvl2_26b.py", "configs/kimi_k2.py",
    "configs/mamba2_1_3b.py", "configs/musicgen_large.py",
    "configs/qwen2_5_3b.py", "configs/qwen2_moe_a2_7b.py",
    "configs/yi_6b.py", "configs/zamba2_1_2b.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    assert (SRC / "repro_torch" / rel).read_bytes() == \
        (SRC / "repro" / rel).read_bytes()


def test_data_pipeline_is_the_reference_without_its_jax_import():
    """``data/pipeline.py`` is a copy with one line dropped: the
    reference's ``import jax`` (unused there), which the port may not
    import."""
    ref = (SRC / "repro" / "data" / "pipeline.py").read_text()
    assert "import jax\n" in ref.splitlines(keepends=True)
    want = "".join(line for line in ref.splitlines(keepends=True)
                   if line != "import jax\n")
    assert (SRC / "repro_torch" / "data" / "pipeline.py").read_text() == want


def test_every_config_file_is_copied():
    ref = {p.name for p in (SRC / "repro" / "configs").glob("*.py")}
    assert {f"configs/{n}" for n in ref} <= set(COPIES)


@pytest.mark.parametrize("arch", list_archs())
def test_configs_are_equal(arch):
    assert t_list_archs() == list_archs()
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(get_config(arch))
    assert t_get_config(arch).padded_vocab == get_config(arch).padded_vocab


NETS = {
    "alexnet_b64": (lambda: get_net("alexnet", batch=64),
                    lambda: t_get_net("alexnet", batch=64)),
    "resnet_b64": (lambda: get_net("resnet", batch=64),
                   lambda: t_get_net("resnet", batch=64)),
    "mlp_b4": (lambda: get_net("mlp", batch=4),
               lambda: t_get_net("mlp", batch=4)),
    "transformer2_b8": (lambda: transformer(batch=8, layers=2),
                        lambda: t_transformer(batch=8, layers=2)),
    "lstm_b8": (lambda: get_net("lstm", batch=8),
                lambda: t_get_net("lstm", batch=8)),
}
HWS = {"16x16": {}, "4x4": {"nodes": 4, "pe": 8}}


def _untimed(sched_json):
    return {k: v for k, v in sched_json.items() if k != "solve_seconds"}


def _plan_shape(nplan):
    return {n: (tuple((a.dim, a.steps) for a in p.grid), dict(p.block),
                p.valid) for n, p in nplan.plans.items()}


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("net", sorted(NETS))
def test_solve_and_lower_parity(net, hw):
    make_ref, make_port = NETS[net]
    ref_net, port_net = make_ref(), make_port()
    ref_hw, port_hw = eyeriss_multinode(**HWS[hw]), t_eyeriss(**HWS[hw])
    ref_sched, port_sched = solve(ref_net, ref_hw), t_solve(port_net, port_hw)
    assert ref_sched.valid
    assert _untimed(port_sched.to_json()) == _untimed(ref_sched.to_json())
    ref_plan = ref_sched.lower(ref_net, ref_hw)
    port_plan = t_lower_network(port_sched, port_net, port_hw)
    assert _plan_shape(port_plan) == _plan_shape(ref_plan)
    assert port_plan.forwarded() == ref_plan.forwarded()
