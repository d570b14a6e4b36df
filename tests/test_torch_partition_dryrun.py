"""The dry-run's partitioned trace (``launch/dryrun.py``
``trace_partitioned``: one rank's train, prefill or decode step on meta
shards under ``launch/mesh.py`` ``fake_group``) against the reference's
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
least the one-device trace's.

(e) Tiny Qwen2.5-3B's train step (``remat="block"``) on a (2, 4) mesh:
the reference's partitioned compile (``tests/_partition_ref.py
dryrun-train``, 8 host devices) against the port's trace of one rank's
forward, backward and update under a fake group of 8: the same plan
choices, and the per-device FLOPs within 5% once the masked pairs the
reference's jnp attention computes are added back (in the forward and
in the remat's recompute; both backwards compute every pair).  (f) ``main
--both-meshes``, run once in a process of its own:
64 partitioned records, 16 skipped, none failed, none divided by the
chips; its Zamba2-1.2B and Kimi-K2 ``train_4k`` records on both meshes
partitioned, their arguments the plan's per-chip parameters and
optimizer state."""
import collections
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
from _partition_ref import DRYRUN, DRYRUN_TRAIN  # noqa: E402


@pytest.fixture(scope="module")
def both_meshes(tmp_path_factory):
    """``main --both-meshes`` in a process of its own, started once for
    the tests that read it; ``wait()`` gives its records and output."""
    out = tmp_path_factory.mktemp("main") / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--both-meshes",
         "--out", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def wait():
        text, _ = proc.communicate(timeout=1200)
        assert proc.returncode == 0, text[-4000:]
        return json.loads(out.read_text()), text
    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


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


# ---------------------------------------------------------------------------
# (e) a tiny train cell against the reference's partitioned compile
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_train(tmp_path_factory):
    import dataclasses
    arch, mesh, B, S = DRYRUN_TRAIN
    out = tmp_path_factory.mktemp("dryrun_train") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    subprocess.run([sys.executable, str(HERE / "_partition_ref.py"),
                    "dryrun-train", str(out), "--devices", "8"],
                   check=True, env=env, timeout=600)
    ref = json.loads(out.read_text())
    cfg = dataclasses.replace(tiny_config(get_config(arch)), remat="block")
    tr = dryrun.trace_partitioned(
        cfg, ShapeConfig("tiny_train", S, B, "train"),
        Mesh(mesh, ("data", "model")), pod=TPUPodSpec(), dtype=torch.float32)
    return cfg, ref, tr


def test_tiny_train_flops_per_device_match_reference(tiny_train):
    cfg, ref, tr = tiny_train
    _, (dp, tp), B, S = DRYRUN_TRAIN
    assert [tr.plan.zero_opt, tr.plan.attn_sharded, tr.plan.fsdp] == \
        ref["plan"]
    # each masked (query, key) pair of a local head: the forward's two
    # products, and again in the remat's recompute (both backwards
    # compute every pair)
    masked = 4 * (B // dp) * (cfg.num_heads // tp) * cfg.head_dim \
        * cfg.num_layers * (S * S - attention_pairs(S, S, True, 0)) * 2
    port = tr.cost.flops
    assert port < ref["flops"]
    assert abs(port + masked - ref["flops"]) / ref["flops"] < 0.05


def test_tiny_train_collectives_by_kind(tiny_train, capsys):
    """The rank's step issues the forward's all-reduces and their
    transposes; ZeRO's gradient reduce-scatter and parameter all-gather
    where the plan shards the moments over ``data``."""
    cfg, ref, tr = tiny_train
    coll = tr.cost.coll_by_kind
    assert coll["all-reduce"] > 0
    assert ("reduce-scatter" in coll) == ("all-gather" in coll) == \
        tr.plan.zero_opt
    with capsys.disabled():
        print(f"\n  tiny qwen2.5 train (2, 4), per device: port {coll}, "
              f"reference {ref['coll_by_kind']}")


# ---------------------------------------------------------------------------
# (f) main --both-meshes: every cell partitioned
# ---------------------------------------------------------------------------

def test_main_both_meshes_records_every_cell_partitioned(both_meshes):
    recs, text = both_meshes()
    kinds = collections.Counter(r.get("per_device", r["status"])
                                for r in recs)
    assert kinds == {"partitioned": 64, "skipped": 16}
    assert "80 cells, 0 failures" in text and "global/chips" not in text
    assert {r["mode"] for r in recs if r["status"] == "ok"} == {
        "train", "prefill", "decode"}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "kimi-k2-1t-a32b"])
def test_production_train_cell_is_partitioned(both_meshes, arch, multi_pod):
    import dataclasses
    from repro_torch.launch import partition
    recs, _ = both_meshes()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = next(r for r in recs if r["arch"] == arch and
               r["shape"] == "train_4k" and
               r["mesh"] == ("2x16x16" if multi_pod else "16x16"))
    assert rec["status"] == "ok" and rec["per_device"] == "partitioned"
    cfg = dataclasses.replace(get_config(arch), remat="block")
    plan = partition.plan_for(cfg, SHAPES["train_4k"], mesh)
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(plan)
    assert plan.bytes_per_chip["opt"] > 0
    assert rec["plan"]["fsdp"] == plan.fsdp
    assert rec["trace"]["new_output_bytes"] == 8    # loss, grad_norm
