"""The port's dry-run (``repro_torch.launch.dryrun``) on ``meta`` tensors:
full-width cells, the reference's skip and record keys, ``main`` and the
roofline table reading its output; and (marked ``gpu``) the counter's
counts of a step run on the card, its kernels launched, against the meta
trace's.  The file imports no JAX, so the card's machine runs it too."""
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCounter, storage_bytes
from repro_torch.launch.steps import (build_prefill_step, build_train_step,
                                      input_structs)
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import make_optimizer

ROOT = Path(__file__).resolve().parents[1]

#: the keys of the reference's records (``repro/launch/dryrun.py:72-161``),
#: less ``xla_cost_analysis``, which has no counterpart
REF_KEYS = {"arch", "shape", "mesh", "mode", "status", "compile_seconds",
            "plan", "memory", "roofline"}
REF_PLAN = {"zero", "attn_sharded", "hbm_gb", "notes"}
#: the port's own: the per-chip bytes at the trace's peak, and whether
#: they fit as the planner's ``valid`` asks
TRACE_PLAN = {"trace_hbm_gb", "trace_valid"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes"}
REF_ROOFLINE = {"flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "coll_by_kind", "t_compute",
                "t_memory", "t_collective", "bottleneck", "model_flops",
                "useful_ratio", "roofline_fraction"}
DENSE = [a for a in list_archs() if get_config(a).family == "dense"]


@pytest.fixture(scope="module")
def traces():
    """Traces kept across this file's cells, as ``main`` keeps them."""
    return {}


def _check_record(rec, mesh):
    """Every cell's counts are one rank's partitioned trace's (train
    cells' backward and optimizer update included)."""
    assert rec["status"] == "ok" and rec["mesh"] == mesh
    assert REF_KEYS <= set(rec) and rec["per_device"] == "partitioned"
    assert REF_PLAN | TRACE_PLAN <= set(rec["plan"])
    assert rec["plan"]["trace_hbm_gb"] >= \
        rec["memory"]["argument_bytes"] / 2**30 - 0.01
    assert set(rec["memory"]) == REF_MEMORY
    assert set(rec["roofline"]) == REF_ROOFLINE
    r, t = rec["roofline"], rec["trace"]
    assert r["flops_per_device"] == t["flops"] > 0
    assert r["bytes_per_device"] == t["bytes"] > 0
    # as XLA's temp_size_in_bytes: beyond the arguments and new results
    assert rec["memory"]["temp_bytes"] == (
        t["peak_bytes"] - t["held_bytes"] - t["new_output_bytes"]) > 0
    # the rank's peak, its collectives as traced
    assert rec["plan"]["trace_hbm_gb"] == round(t["peak_bytes"] / 2**30, 2)
    assert r["collective_bytes_per_device"] == sum(
        r["coll_by_kind"].values()) > 0
    assert r["t_compute"] == r["flops_per_device"] / 989e12   # H100Spec
    assert r["bottleneck"] in ("compute", "memory", "collective")


def test_qwen_train_cell_full_width(traces):
    rec = dryrun.lower_cell("qwen2.5-3b", "train_4k", verbose=False,
                            traces=traces)
    _check_record(rec, "16x16")
    assert rec["mode"] == "train" and rec["plan"]["valid"]
    cfg = get_config("qwen2.5-3b")
    # remat="block": each layer's flash forward runs again in the backward;
    # the optimizer: one update of the rank's windows, and two norms (the
    # clip's and the metric's), each a sum of squares a group of leaves
    # sharded over the same mesh axes (four groups on this plan)
    assert rec["trace"]["kernel_units"] == {
        "flash_attention": 2 * cfg.num_layers, "multi_tensor_adamw": 1,
        "multi_tensor_sumsq": 2 * 4}
    # the parameters and the optimizer state are updated in place, as the
    # reference donates them; the new results are the two f32 metrics
    tr = traces[("qwen2.5-3b", "train_4k", False, "16x16")]
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(
        tr.plan) > tr.plan.bytes_per_chip["params"]
    assert rec["trace"]["new_output_bytes"] == 8
    coll = rec["roofline"]["coll_by_kind"]
    assert coll["all-reduce"] > 0 and ("reduce-scatter" in coll) == \
        rec["plan"]["zero"]


def test_zamba2_prefill_cell_full_width(traces):
    rec = dryrun.lower_cell("zamba2-1.2b", "prefill_32k", verbose=False,
                            traces=traces)
    _check_record(rec, "16x16")
    cfg = get_config("zamba2-1.2b")
    assert rec["trace"]["kernel_units"] == {
        "ssd_intra_chunk": cfg.num_layers,
        "flash_attention": cfg.num_layers // cfg.attn_every}


def test_kimi_decode_cell_on_pod_mesh(traces):
    rec = dryrun.lower_cell("kimi-k2-1t-a32b", "decode_32k", multi_pod=True,
                            verbose=False, traces=traces)
    _check_record(rec, "2x16x16")
    assert rec["trace"]["kernel_units"] == {}     # decode runs no kernel
    assert rec["memory"]["argument_bytes"] > 0


def test_long_context_skipped_with_the_reference_reason():
    rec = dryrun.lower_cell("gemma2-2b", "long_500k", verbose=False)
    assert rec == {"arch": "gemma2-2b", "shape": "long_500k",
                   "status": "skipped",
                   "reason": "long_500k skipped: pure full-attention "
                             "architecture"}


def test_main_writes_records_the_roofline_table_reads(tmp_path, capsys):
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "prefill_32k",
                      "--both-meshes", "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    # a trace per mesh: a rank of the 512-chip mesh holds half the batch
    assert [r["per_device"] for r in recs] == ["partitioned"] * 2
    assert recs[1]["trace"]["flops"] < recs[0]["trace"]["flops"]
    assert "2 cells, 0 failures" in capsys.readouterr().out
    sys.path.insert(0, str(ROOT))
    table = importlib.import_module("benchmarks.roofline_table")
    rows = table.run(str(out))
    assert [r[0] for r in rows] == ["roofline.qwen2.5-3b.prefill_32k"] * 2


@pytest.mark.parametrize("arch", DENSE)
def test_useful_ratio_of_dense_train_cells(traces, arch):
    """The counter's useful ratio of the whole step (one device's trace)
    is within (0.3, 1]; the cell's, a rank's partitioned trace over the
    chips, is at most that: the rank also counts the work the plan
    repeats on every model rank (Gemma2's 8 heads on a model axis of 16
    are not sharded, so every rank runs all of them)."""
    rec = dryrun.lower_cell(arch, "train_4k", verbose=False, traces=traces)
    cfg = dataclasses.replace(get_config(arch), remat="block")
    whole = dryrun.trace_step(cfg, SHAPES["train_4k"],
                              make_production_mesh())
    model = rec["roofline"]["model_flops"]
    assert 0.3 < model / whole.cost.flops <= 1.0
    assert 0 < rec["roofline"]["useful_ratio"] <= model / whole.cost.flops
    assert rec["roofline"]["flops_per_device"] * 256 >= whole.cost.flops


@pytest.mark.parametrize("arch,mode", [
    ("qwen2.5-3b", "train"), ("zamba2-1.2b", "train"),
    ("qwen2.5-3b", "prefill"), ("qwen2-moe-a2.7b", "decode")])
def test_trace_hbm_on_one_chip_is_the_meta_peak(arch, mode):
    """On the one-card mesh the plan's arguments are the trace's held
    parameters, optimizer state and cache, so the trace's per-chip bytes
    are its peak, less the held batch the plan does not count."""
    from repro_torch.core.autoshard import plan_sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import tiny_config
    from repro_torch.launch.op_cost import storage_bytes
    cfg = tiny_config(get_config(arch))
    shape = ShapeConfig(mode, 64, 2, mode)
    tr = dryrun.trace_step(cfg, shape)
    plan = plan_sharding(cfg, shape, make_local_mesh(device="cpu"),
                         tr.params, tr.opt_state, cache_shapes=tr.cache)
    batch = storage_bytes(input_structs(cfg, shape))
    got = dryrun.trace_hbm_bytes(tr, plan)
    assert tr.cost.peak_bytes - batch <= got <= tr.cost.peak_bytes


# ---------------------------------------------------------------------------
# on the card: the counts of a step with the kernels launched
# ---------------------------------------------------------------------------

def _cut(arch, layers, remat="none"):
    import dataclasses
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               remat=remat)


def _step(cfg, shape, dev):
    """One step of ``shape.mode`` at full width on ``dev`` and its
    arguments."""
    train = shape.mode == "train"
    api = build_model(cfg, device=dev, trainable=train)
    params = api.init(0)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in input_structs(cfg, shape).items()}
    if train:
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(dict(params.named_parameters()))
        step, args = build_train_step(api, opt), (params, state, batch)
    else:
        step = build_prefill_step(api, shape.seq_len)
        args = (params, batch["inputs"])
    return step, args


def _count(step, args, dev):
    with OpCounter(dev) as c:
        c.hold(args)
        step(*args)
    return c.cost()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers,mode,remat", [
    ("zamba2-1.2b", 6, "train", "none"), ("zamba2-1.2b", 6, "train", "block"),
    ("qwen2.5-3b", 4, "train", "block"), ("qwen2.5-3b", 4, "prefill", "none")])
def test_card_counts_equal_meta_counts(arch, layers, mode, remat):
    """``remat="block"`` is how the dry-run traces every train cell: the
    backward recomputes each block, its kernels included, under the
    counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _cut(arch, layers, remat)
    shape = ShapeConfig(mode, 512, 2, mode)
    meta = _count(*_step(cfg, shape, "meta"), "meta")
    dev = torch.device("cuda", 0)
    step, args = _step(cfg, shape, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    card = _count(step, args, dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert launches["flash_attention"] == \
        card.kernel_units.get("flash_attention", 0) > 0
    assert launches["ssd_intra_chunk"] == \
        card.kernel_units.get("ssd_intra_chunk", 0)
    assert (card.flops, card.bytes, card.kernel_units) == \
        (meta.flops, meta.bytes, meta.kernel_units)
    assert abs(meta.peak_bytes - peak) <= 0.25 * peak, (meta.peak_bytes,
                                                       peak)



# ---------------------------------------------------------------------------
# the meta device
# ---------------------------------------------------------------------------

def test_kernel_wrappers_on_meta_launch_nothing():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    ops.reset_launch_counts()
    q = torch.empty((2, 8, 64, 128), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k = torch.empty((2, 2, 64, 128), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    out, lse = fa.flash_attention(q, k, k, return_lse=True)
    assert (out.shape, out.dtype, out.is_meta) == (q.shape, q.dtype, True)
    assert (lse.shape, lse.dtype) == ((2, 8, 64), torch.float32)
    dq, dk = torch.autograd.grad(ops.flash_attention_vjp(q, k, k).sum(),
                                 (q, k))
    assert (dq.shape, dk.shape) == (q.shape, k.shape) and dq.is_meta
    with pytest.raises(ValueError, match="head dim 48"):   # as the card
        fa.flash_attention(*(torch.empty((1, 2, 8, 48), device="meta"),) * 3)
    x = torch.empty((2, 4, 3, 128, 64), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    dt = torch.empty((2, 4, 3, 128), device="meta")
    b = torch.empty((2, 3, 128, 16), device="meta", requires_grad=True)
    y = ssd_scan.ssd_intra_chunk(x, dt, dt, b, b)
    assert (y.shape, y.dtype, y.is_meta) == (x.shape, x.dtype, True)
    dx, db = torch.autograd.grad(
        ssd_scan.ssd_intra_chunk_vjp(x, dt, dt, b, b).sum(), (x, b))
    assert (dx.shape, db.shape) == (x.shape, b.shape)
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_wgmma": 0,
                                   "ssd_intra_chunk": 0,
                                   "multi_tensor_sumsq": 0,
                                   "multi_tensor_adamw": 0}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b",
                                  "kimi-k2-1t-a32b"])
def test_init_cache_and_optimizer_on_meta(arch):
    """``init`` on meta draws nothing and gives the CPU's shapes and types;
    ``init_cache`` and the optimizer's ``init`` work there too."""
    from repro_torch.launch.train import tiny_config
    cfg = tiny_config(get_config(arch))
    rng = torch.get_rng_state()
    meta = build_model(cfg, device="meta").init(0)
    assert torch.equal(rng, torch.get_rng_state())
    cpu = build_model(cfg, device="cpu").init(0)
    assert [(n, p.shape, p.dtype) for n, p in meta.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in cpu.named_parameters()]
    assert all(p.is_meta for p in meta.parameters())
    cache = build_model(cfg, device="meta").init_cache(2, 16)
    assert all(t.is_meta for t in cache.values())
    state = make_optimizer(cfg.optimizer).init(dict(meta.named_parameters()))
    assert state["step"].is_meta


def test_decode_and_moe_drops_on_meta():
    """A decode step traces at ``cache_len = seq_len - 1`` (the full
    static cache); the MoE drop counter counts the routed pairs and
    keeps no meta tensor to read back."""
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.launch.train import tiny_config
    from repro_torch.models.moe import counting_drops
    cfg = tiny_config(get_config("qwen2-moe-a2.7b"))
    api = build_model(cfg, device="meta")
    params = api.init(0)
    cache = api.init_cache(2, 16)
    tok = torch.empty((2, 1), dtype=torch.int32, device="meta")
    with counting_drops() as count:
        nxt, cache = build_serve_step(api)(params, cache, tok, 15)
        api.forward(params, torch.empty((2, 8), dtype=torch.int32,
                                        device="meta"))
    assert nxt.shape == (2, 1) and nxt.is_meta
    assert count.pairs == (cfg.num_layers - cfg.first_dense_layers) \
        * (2 + 16) * cfg.top_k
    assert count.dropped == 0
