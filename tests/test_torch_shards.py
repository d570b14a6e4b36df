"""One rank's view of a partitioned model (``models/shards.py``) and the
counting of one rank's program (``launch/op_cost.py``), on the CPU, under
``launch/mesh.py`` ``fake_group``: the local window of a multi-axis
shard, the KV heads a rank's query heads read, the collectives counted by
kind with their result bytes, and a DTensor op counted at its local
shapes, not at the global ones its sharding propagation infers.

Each collective's backward is its transpose: on 4 gloo ranks in f64
(``tests/_partition_ranks.py`` ``transpose_cases``, one group for the
file's cases), ⟨op(x), y⟩ = ⟨x, op's backward of y⟩ for ``finish``'s
all-reduce, ``enter``, ``all_gather``, ``reduce_scatter`` and
``local``'s gather over ``data``, each summed over the ranks, a tensor
alike on every rank of the group counted once.  On a 1 x 1 mesh a train
step issues no collective."""
from pathlib import Path

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import Mesh, device_mesh, fake_group
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models.shards import Shards, heads_for


def _shards(shape, axes, rank):
    return Shards(device_mesh(Mesh(shape, axes), "cpu"))


@pytest.mark.parametrize("rank", [0, 5, 11, 15])
def test_window_of_a_dim_sharded_over_two_axes(rank):
    """P(("pod", "data"), "model") on a 2 x 4 x 2 mesh: dim 0 splits over
    pod then data (pod outermost), dim 1 over model."""
    with fake_group(16, rank):
        sh = _shards((2, 4, 2), ("pod", "data", "model"), rank)
        lay = sh.window((64, 8), [Shard(0), Shard(0), Shard(1)])
        pod, data, model = (sh.coord[a] for a in ("pod", "data", "model"))
        assert lay.sizes == (8, 4)
        assert lay.offsets == ((pod * 4 + data) * 8, model * 4)
        assert lay.axes == (("pod", "data"), ("model",))


def test_shard_keeps_a_copy_of_the_window_and_full_undoes_it():
    with fake_group(4, 2):
        sh = _shards((2, 2), ("data", "model"), 2)
        full = torch.arange(32.0).reshape(4, 8)
        dt = sh.shard(full, [Shard(0), Shard(1)])
        assert dt.shape == (4, 8)
        assert torch.equal(dt.to_local(), full[2:4, 0:4])
        assert dt.to_local().data_ptr() != full.data_ptr()


@pytest.mark.parametrize("H,KV,h0,n,kv_heads", [
    (4, 2, 1, 1, 1), (4, 2, 2, 1, 1), (4, 2, 2, 2, 1), (32, 4, 16, 8, 1),
    (48, 8, 18, 6, 1), (64, 8, 16, 16, 2), (12, 4, 4, 4, 4), (4, 4, 0, 4, 4)])
def test_each_query_head_reads_its_own_kv_head(H, KV, h0, n, kv_heads):
    """Global query head h reads KV head h // (H // KV): a rank's local
    heads are heads h0.. of the model, not 0..  The operand is a slice
    where the local heads fall on whole groups (or within one), else one
    KV head per query head (12 heads over 4 KV heads, heads 4..7)."""
    k = torch.arange(KV, dtype=torch.float32).reshape(1, KV, 1, 1)
    got = heads_for(k, H, KV, h0, n)
    assert got.shape[1] == kv_heads
    per_head = got.repeat_interleave(n // kv_heads, dim=1).flatten().tolist()
    assert per_head == [(h0 + j) // (H // KV) for j in range(n)]


def test_collectives_counted_by_kind_with_their_result_bytes():
    with fake_group(8):
        sh = _shards((2, 4), ("data", "model"), 0)
        x = torch.empty(16, 32, device="meta")
        with OpCounter("meta") as counter:
            sh.all_reduce(x)
            sh.all_gather(x, 1)
            from repro_torch.models.shards import reduce_scatter
            reduce_scatter(x, 0, sh.model)
            sh.all_reduce(x, ("data",), "max")
        c = counter.cost()
    assert c.coll_by_kind == {"all-reduce": 2 * 16 * 32 * 4,
                              "all-gather": 16 * 128 * 4,
                              "reduce-scatter": 4 * 32 * 4}
    assert c.coll_bytes == sum(c.coll_by_kind.values())
    assert [k for k, _, _ in c.colls] == ["all-reduce", "all-gather",
                                          "reduce-scatter", "all-reduce"]
    assert c.flops == 0 and c.bytes >= c.coll_bytes


def test_a_dtensor_op_counts_its_local_shapes():
    """The counter leaves a DTensor's op to the DTensor and counts the
    local op it runs; the global-shape op of the sharding propagation's
    fake tensors is not counted."""
    with fake_group(4):
        dm = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        a = DTensor.from_local(torch.empty(8, 16, device="meta"), dm,
                               [Shard(0)], run_check=False)
        b = DTensor.from_local(torch.empty(16, 4, device="meta"), dm,
                               [Replicate()], run_check=False)
        with OpCounter("meta") as counter:
            y = a @ b
        assert y.shape == (32, 4)
    assert counter.cost().by_op["mm"][0] == 2 * 8 * 16 * 4


# ---------------------------------------------------------------------------
# each collective's backward is its transpose
# ---------------------------------------------------------------------------

TRANSPOSE_MESHES = [(1, 4), (2, 2)]


@pytest.fixture(scope="module")
def transposes():
    from repro_torch.launch.partition import run_ranks
    here = Path(__file__).resolve().parent
    return run_ranks(f"{here / '_partition_ranks.py'}:transpose_cases", 4,
                     "gloo", {"meshes": TRANSPOSE_MESHES}, timeout=300)[0]


@pytest.mark.parametrize("mesh", TRANSPOSE_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("op", ["finish", "enter", "all_gather",
                                "reduce_scatter", "local"])
def test_backward_is_the_transpose(transposes, op, mesh):
    lhs, rhs, alike = transposes[(mesh, op)]
    assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12)
    assert lhs != 0.0
    assert alike              # an input alike on the ranks gets one gradient


def test_one_by_one_mesh_issues_no_collective():
    """Over axes of size 1 the partitioned train step is the one-card
    program: no collective, forward or backward."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import partition as pt
    from repro_torch.launch.train import tiny_config
    from repro_torch.models.api import build_model
    cfg = tiny_config(get_config("kimi-k2-1t-a32b"))
    mesh = Mesh((1, 1), ("data", "model"))
    with fake_group(1):
        api = build_model(cfg, device="cpu", dtype=torch.float32,
                          mesh=device_mesh(mesh, "cpu"), trainable=True)
        plan = pt.plan_for(cfg, ShapeConfig("t", 16, 2, "train"), mesh,
                           torch.float32)
        params = pt.init_params(api, plan)
        opt = pt.default_optimizer(cfg, params)
        state = pt.init_opt_state(api, opt, plan)
        g = torch.Generator().manual_seed(0)
        batch = pt.distribute_batch({
            k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
            for k in ("inputs", "targets")}, plan, api)
        with OpCounter() as counter:
            _, _, m = pt.partitioned_train_step(api, opt, plan)(
                params, state, batch)
    assert counter.cost().colls == []
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
