"""The dry-run's partitioned trace (``launch/dryrun.py``
``trace_partitioned``: one rank's prefill or decode step on meta shards
under ``launch/mesh.py`` ``fake_group``) against the reference's
partitioned compile, and the production cells it now records.

(c) Tiny Qwen2-MoE's prefill on a (2, 4) mesh: the reference compiled over
8 host devices in a process of its own (``tests/_partition_ref.py
dryrun``), the port traced under a fake group of 8.  The per-device FLOPs
agree within 5% once the masked (query, key) pairs the reference's jnp
attention computes are added back (as ``test_torch_op_cost.py``'s
unpartitioned case does), and the MoE's all-reduce, an f32 [T_local, d]
on both sides, moves the same bytes.  (d) Qwen2-MoE-A2.7B ``prefill_32k``
and Kimi-K2 ``decode_32k`` on both production meshes: partitioned
records, the arguments the plan's bytes, the FLOPs over the chips at
least the one-device trace's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.hw.template import TPUPodSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, fake_group, make_production_mesh
from repro_torch.launch.op_cost import attention_pairs
from repro_torch.launch.train import tiny_config

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from _partition_ref import DRYRUN  # noqa: E402


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The reference's partitioned compile and the port's trace of the
    tiny cell, each with the reference's TPU spec, so both planners pick
    the same plan."""
    arch, mesh, B, S = DRYRUN
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    subprocess.run([sys.executable, str(HERE / "_partition_ref.py"),
                    "dryrun", str(out), "--devices", "8"], check=True,
                   env=env, timeout=600)
    ref = json.loads(out.read_text())
    cfg = tiny_config(get_config(arch))
    tr = dryrun.trace_partitioned(
        cfg, ShapeConfig("tiny_prefill", S, B, "prefill"),
        Mesh(mesh, ("data", "model")), pod=TPUPodSpec(), dtype=torch.float32)
    return cfg, ref, tr


def test_tiny_prefill_flops_per_device_match_reference(tiny):
    cfg, ref, tr = tiny
    _, (dp, tp), B, S = DRYRUN
    assert [tr.plan.zero_opt, tr.plan.attn_sharded] == ref["plan"]
    masked = 4 * (B // dp) * (cfg.num_heads // tp) * cfg.head_dim \
        * cfg.num_layers * (S * S - attention_pairs(S, S, True, 0))
    port = tr.cost.flops
    assert port < ref["flops"]
    assert abs(port + masked - ref["flops"]) / ref["flops"] < 0.05


def test_tiny_prefill_moe_all_reduce_bytes_match_reference(tiny, capsys):
    cfg, ref, tr = tiny
    _, (dp, tp), B, S = DRYRUN
    tokens = (B // dp) * S
    # the only 2-d all-reduce on either side: the MoE's f32 [T_local, d]
    ref_moe = [dims for t, dims in ref["all_reduce_shapes"]
               if len(dims) == 2]
    port_moe = [c for c in tr.cost.colls
                if c[0] == "all-reduce" and len(c[1]) == 2]
    assert ref_moe == [[tokens, cfg.d_model]]   # in the scanned layer body
    assert len(port_moe) == cfg.num_layers      # one a layer, unrolled
    assert {(c[1], c[2]) for c in port_moe} == {
        ((tokens, cfg.d_model), "float32")}
    ref_bytes = 4 * ref_moe[0][0] * ref_moe[0][1]
    assert {4 * c[1][0] * c[1][1] for c in port_moe} == {ref_bytes}
    with capsys.disabled():
        print(f"\n  tiny qwen2-moe prefill (2, 4), per device: port "
              f"{tr.cost.coll_by_kind}, reference {ref['coll_by_kind']} "
              f"(its HLO's all-reduce shapes {ref['all_reduce_shapes']})")


@pytest.fixture(scope="module")
def cells():
    traces, out = {}, {}
    for arch, shape in (("qwen2-moe-a2.7b", "prefill_32k"),
                        ("kimi-k2-1t-a32b", "decode_32k")):
        for multi_pod in (False, True):
            rec = dryrun.lower_cell(arch, shape, multi_pod=multi_pod,
                                    verbose=False, traces=traces)
            out[(arch, shape, multi_pod)] = (rec, traces[
                (arch, shape, False, rec["mesh"])])
        global_trace = dryrun.trace_step(get_config(arch), SHAPES[shape],
                                         make_production_mesh())
        out[(arch, shape)] = global_trace.cost.flops
    return out


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", [("qwen2-moe-a2.7b", "prefill_32k"),
                                        ("kimi-k2-1t-a32b", "decode_32k")])
def test_production_cell_is_partitioned(cells, arch, shape, multi_pod):
    rec, tr = cells[(arch, shape, multi_pod)]
    chips = 512 if multi_pod else 256
    assert rec["status"] == "ok" and rec["per_device"] == "partitioned"
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(tr.plan)
    assert rec["roofline"]["flops_per_device"] * chips >= \
        cells[(arch, shape)]
    coll = rec["roofline"]["coll_by_kind"]
    assert coll == tr.cost.coll_by_kind and coll["all-reduce"] > 0
    if arch == "kimi-k2-1t-a32b":          # FSDP: weights gathered on use
        assert rec["plan"]["fsdp"] and coll["all-gather"] > 0


def test_fake_group_is_destroyed_on_failure():
    import sys

    import torch.distributed as dist
    hook = sys.excepthook
    with pytest.raises(RuntimeError, match="inside"):
        with fake_group(8):
            assert dist.get_world_size() == 8
            raise RuntimeError("inside")
    assert not dist.is_initialized()
    # the group's "[rank0]: " traceback prefixer goes with it
    assert sys.excepthook is hook
