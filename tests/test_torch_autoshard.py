"""The port's sharding planner (``repro_torch.core.autoshard``) on the
reference's cases, and in parity with the reference's planner.

Parity rule: the reference stacks every block leaf on a leading layer dim,
the port keeps one leaf per layer.  For every (arch, shape, mesh) both
planners, given the same ``TPUPodSpec()``, pick the same candidate (ZeRO,
sharded attention, FSDP or not), report the per-chip HBM and the step
estimate within 1e-4 relative, and give every leaf the reference's spec
with the layer entry dropped, wherever the reference's data axes are not
on that layer entry (there ZeRO shards a later dim of the port's per-layer
leaf, or nothing where none divides).  Adafactor's state is kept over the
reference's stacks (``models.api.layer_stacks``), so its leaves have the
reference's paths and shapes, layer dim included, and are held against
the reference's specs whole.
"""
import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES, get_config, list_archs
from repro.core.autoshard import plan_sharding as ref_plan_sharding
from repro.hw.template import TPUPodSpec
from repro.models.api import build_model as ref_build_model
from repro.optim.optimizers import make_optimizer as ref_make_optimizer
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autoshard import (P, named_leaves, placements,
                                        plan_sharding)
from repro_torch.hw.gpu import H100Spec
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models.api import build_model, layer_stacks
from repro_torch.optim.optimizers import make_optimizer

MESH = Mesh((16, 16), ("data", "model"))
MESH3 = Mesh((2, 16, 16), ("pod", "data", "model"))
TPU = TPUPodSpec()
DP_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# shapes of both packages, built once per arch
# ---------------------------------------------------------------------------

class _Shapes:
    """Meta parameters, optimizer state and caches of the port, and the
    reference's ``jax.eval_shape`` trees, built lazily and kept."""

    def __init__(self):
        self._port, self._ref, self._cache = {}, {}, {}

    def port(self, arch):
        if arch not in self._port:
            cfg = t_get_config(arch)
            api = build_model(cfg, device="meta")
            params = api.init(0)
            opt = make_optimizer(
                cfg.optimizer, stacks=layer_stacks(cfg, params)).init(
                dict(params.named_parameters()))
            self._port[arch] = (cfg, api, params, opt)
        return self._port[arch]

    def ref(self, arch):
        if arch not in self._ref:
            cfg = get_config(arch)
            api = ref_build_model(cfg)
            params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
            opt = jax.eval_shape(ref_make_optimizer(cfg.optimizer).init,
                                 params)
            self._ref[arch] = (cfg, api, params, opt)
        return self._ref[arch]

    def caches(self, arch, shape):
        key = (arch, shape.name)
        if key not in self._cache:
            _, api, _, _ = self.port(arch)
            _, rapi, _, _ = self.ref(arch)
            self._cache[key] = (
                api.init_cache(shape.global_batch, shape.seq_len),
                jax.eval_shape(lambda: rapi.init_cache(shape.global_batch,
                                                       shape.seq_len)))
        return self._cache[key]


@pytest.fixture(scope="module")
def shapes():
    return _Shapes()


def _port_plan(shapes, arch, shape_name, mesh=MESH, pod=TPU, cache=None):
    cfg, _, params, opt = shapes.port(arch)
    shape = T_SHAPES[shape_name]
    opt_sds = opt if shape.mode == "train" else {}
    if cache is None and shape.mode == "decode":
        cache = shapes.caches(arch, shape)[0]
    return cfg, plan_sharding(cfg, shape, mesh, params, opt_sds,
                              cache_shapes=cache, pod=pod), params


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_autoshard.py) on the port's planner
# ---------------------------------------------------------------------------

def _check_divisible(spec_tree, shape_tree, mesh):
    leaves = named_leaves(shape_tree)
    flat = _flat_specs(spec_tree)
    assert [p for p, _ in flat] == [p for p, _ in leaves]
    for (path, spec), (_, leaf) in zip(flat, leaves):
        for dim, entry in zip(leaf.shape, tuple(spec)):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            size = math.prod(mesh.shape[a] for a in axes)
            assert dim % size == 0, (path, spec, leaf.shape)


def _flat_specs(tree, prefix=()):
    if isinstance(tree, P):
        return [(prefix, tree)]
    return [leaf for k, v in tree.items()
            for leaf in _flat_specs(v, prefix + tuple(k.split(".")))]


@pytest.mark.parametrize("arch", ["internlm2-20b", "gemma2-2b",
                                  "qwen2.5-3b", "qwen2-moe-a2.7b",
                                  "kimi-k2-1t-a32b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_param_specs_divisible(shapes, arch):
    cfg, plan, params = _port_plan(shapes, arch, "train_4k")
    _check_divisible(plan.param_specs, params, MESH)


def test_gemma2_heads_force_replicated_attention(shapes):
    cfg, plan, _ = _port_plan(shapes, "gemma2-2b", "train_4k")
    assert not plan.attn_sharded          # 8 heads % 16 != 0


def test_internlm_heads_shardable(shapes):
    cfg, plan, _ = _port_plan(shapes, "internlm2-20b", "train_4k")
    assert plan.attn_sharded


def test_kimi_fits_hbm_only_with_adafactor(shapes):
    """The reference's case, on the v5e's 16 GB (``pod=TPUPodSpec()``)."""
    cfg, plan, _ = _port_plan(shapes, "kimi-k2-1t-a32b", "train_4k", MESH3)
    assert cfg.optimizer == "adafactor"
    assert plan.hbm_gb_per_chip < 16.0    # the validity check passes
    assert plan.zero_opt and plan.valid   # ZeRO is required to fit


def test_zero_shards_optimizer_state_over_data(shapes):
    cfg, plan, _ = _port_plan(shapes, "yi-6b", "train_4k")
    assert plan.zero_opt
    assert any("data" in (e if isinstance(e, tuple) else (e,))
               for _, spec in _flat_specs(plan.opt_specs) for e in spec)


def test_decode_cache_never_replicated_large(shapes):
    cfg, plan, _ = _port_plan(shapes, "gemma2-2b", "decode_32k")
    assert "model" in tuple(plan.cache_specs["k"])


def test_plan_notes_record_candidates(shapes):
    _, plan, _ = _port_plan(shapes, "yi-6b", "train_4k")
    assert len(plan.notes) >= 2           # >1 candidate was considered
    assert any("zero=True" in n for n in plan.notes)
    assert any("zero=False" in n for n in plan.notes)


def test_cache_spec_uses_real_mesh_shape(shapes):
    # the reference's regression: the decode cache's batch sharding
    # follows the caller's mesh, not a hardcoded data axis
    cfg, api, params, _ = shapes.port("gemma2-2b")
    shape = ShapeConfig("decode_small", 1024, 8, "decode")
    mesh = Mesh((4, 16), ("data", "model"))
    plan = plan_sharding(cfg, shape, mesh, params, {},
                         cache_shapes=api.init_cache(8, 1024), pod=TPU)
    k_spec = tuple(plan.cache_specs["k"])
    assert k_spec[1] == "data", k_spec     # batch 8 >= dp_size 4
    assert "data" not in k_spec[2:], k_spec


# ---------------------------------------------------------------------------
# parity with the reference's planner
# ---------------------------------------------------------------------------

def _ref_path(path, cfg):
    """The reference leaf of a port leaf path, and the port leaf's layer
    within it (None: not stacked, or a state leaf kept over the whole
    stack)."""
    if "blocks" not in path:
        return path, None
    i = path.index("blocks")
    if not path[i + 1].isdigit():
        return path, None
    layer = int(path[i + 1])
    rest = path[:i] + path[i + 2:]
    fd = cfg.first_dense_layers if cfg.family == "moe" else 0
    if layer < fd:
        return rest[:i] + ("dense_blocks",) + rest[i:], layer
    return rest[:i] + ("blocks",) + rest[i:], layer - fd


def _ref_specs(tree):
    """Reference spec tree -> {path: PartitionSpec}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(getattr(k, "key", k)) for k in p): s for p, s in flat}


def _data_on(entry) -> bool:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return any(a in DP_AXES for a in axes)


def _compare_specs(port_tree, ref_tree, cfg):
    ref = _ref_specs(ref_tree)
    flat = _flat_specs(port_tree)
    assert flat, "no leaves"
    n_layer_dim = 0
    for path, spec in flat:
        rpath, layer = _ref_path(path, cfg)
        rspec = tuple(ref[rpath])
        if layer is not None:
            if rspec and _data_on(rspec[0]):
                n_layer_dim += 1          # ZeRO took the layer dim there
                continue
            rspec = rspec[1:]
        assert tuple(spec) == rspec, (path, spec, rspec)
    return n_layer_dim


def _close(a, b, rel=1e-4):
    if a == b:                            # the over-budget fallback's inf
        return True
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", list_archs())
def test_plan_matches_reference(shapes, arch, shape_name, multi_pod):
    mesh = MESH3 if multi_pod else MESH
    ref_mesh_shape = dict(mesh.shape)

    class RefMesh:                       # the reference test's FakeMesh
        shape = ref_mesh_shape
        axis_names = tuple(ref_mesh_shape)

    rcfg, _, rparams, ropt = shapes.ref(arch)
    shape = SHAPES[shape_name]
    train = shape.mode == "train"
    port_cache = ref_cache = None
    if not train:
        port_cache, ref_cache = shapes.caches(arch, shape)
    ref = ref_plan_sharding(rcfg, shape, RefMesh(), rparams,
                            ropt if train else {}, cache_shapes=ref_cache)
    cfg, port, _ = _port_plan(shapes, arch, shape_name, mesh,
                              cache=port_cache)
    ref_fsdp = any(_data_on(e) for s in _ref_specs(ref.param_specs).values()
                   for e in s)
    assert (port.zero_opt, port.attn_sharded, port.fsdp) == \
        (ref.zero_opt, ref.attn_sharded, ref_fsdp)
    assert _close(port.hbm_gb_per_chip, ref.hbm_gb_per_chip)
    assert _close(port.est_step_seconds, ref.est_step_seconds)
    assert len(port.notes) == len(ref.notes)
    _compare_specs(port.param_specs, ref.param_specs, cfg)
    if train:
        _compare_specs(port.opt_specs, ref.opt_specs, cfg)
    else:
        assert port.cache_specs == {k: P(*v) for k, v in
                                    ref.cache_specs.items()}
    assert {k: tuple(v) for k, v in port.batch_specs.items()} == \
        {k: tuple(v) for k, v in ref.batch_specs.items()}


def test_layer_dim_rule_is_exercised(shapes):
    """mamba2-1.3b's 48 layers divide the 16-way data axis: the reference's
    ZeRO shards the layer dim of every optimizer-state leaf whose first
    dim is the layer, and the port a later dim of the per-layer leaf."""
    rcfg, _, rparams, ropt = shapes.ref("mamba2-1.3b")

    class RefMesh:
        shape = dict(MESH.shape)
        axis_names = tuple(MESH.shape)

    ref = ref_plan_sharding(rcfg, SHAPES["train_4k"], RefMesh(), rparams,
                            ropt)
    cfg, port, _ = _port_plan(shapes, "mamba2-1.3b", "train_4k")
    assert ref.zero_opt and port.zero_opt
    assert _compare_specs(port.opt_specs, ref.opt_specs, cfg) > 0
    a_log = port.opt_specs["m"]["blocks.0.mamba.a_log"]
    assert a_log == P("model")            # 64 heads: model, then no dim


# ---------------------------------------------------------------------------
# the H100
# ---------------------------------------------------------------------------

def test_kimi_on_h100_pod_mesh(shapes):
    """Kimi-K2 training on 2 x 16 x 16 H100s (80 GB each): it fits with
    ZeRO, and the estimate reads the H100's rates."""
    cfg, plan, _ = _port_plan(shapes, "kimi-k2-1t-a32b", "train_4k", MESH3,
                              pod=H100Spec())
    assert plan.valid and plan.zero_opt
    assert plan.hbm_gb_per_chip < 80e9 * 0.92 / 2 ** 30
    shape = T_SHAPES["train_4k"]
    t_compute = 6.0 * cfg.active_param_count() * shape.global_batch \
        * shape.seq_len / (512 * 989e12)
    assert plan.est_step_seconds >= t_compute
    assert sum(plan.coll_by_kind.values()) / (25e9 * 18) <= \
        plan.est_step_seconds
    assert set(plan.coll_by_kind) >= {"all-reduce", "reduce-scatter",
                                      "all-gather"}


def test_placements_of_leaves(shapes):
    from torch.distributed.tensor import Replicate, Shard
    cfg, plan, _ = _port_plan(shapes, "qwen2.5-3b", "train_4k",
                              pod=H100Spec())
    assert plan.attn_sharded
    ps = plan.param_shardings(MESH)
    assert ps["embed"] == (Replicate(), Shard(0))          # vocab-parallel
    assert ps["blocks.0.attn.wq"] == (Replicate(), Shard(1))
    assert ps["blocks.0.mlp.wo"] == (Replicate(), Shard(0))
    assert ps["blocks.0.ln1"] == (Replicate(), Replicate())
    os_ = plan.opt_shardings(MESH)
    spec = plan.opt_specs["m"]["blocks.0.mlp.wo"]
    assert spec == P("model", "data") and os_["m"]["blocks.0.mlp.wo"] == \
        (Shard(1), Shard(0))
    assert placements(P(None, ("pod", "data"), "model"), MESH3) == \
        (Shard(1), Shard(1), Shard(2))


def test_local_mesh_plans_one_chip(shapes):
    """On the one-card mesh every axis has size 1, so a leaf's bytes per
    chip are all its bytes."""
    mesh = make_local_mesh(device="meta")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices.shape == (1, 1)
    assert mesh.devices[0, 0] == torch.device("meta")
    cfg, _, params, opt = shapes.port("zamba2-1.2b")
    plan = plan_sharding(cfg, ShapeConfig("train", 512, 8, "train"), mesh,
                         params, opt, pod=H100Spec())
    assert plan.valid and "all-reduce" not in plan.coll_by_kind
    pb = sum(p.numel() * p.element_size() for p in params.parameters())
    assert plan.bytes_per_chip["params"] == pb
