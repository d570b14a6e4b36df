"""The port's model zoo in training against the JAX package, in f32 on
the CPU at ``tiny_config``, with the JAX weights carried across by
``params_from_reference``: ``loss_fn`` and every gradient leaf of seven
archs (the JAX stacked leaves cut per layer), ``remat="block"``, three
whole train steps against the reference's jitted ``train_step``, eager and
through the compiled step (``CompiledTraining``, which on the CPU runs its
body each step and equals the eager step bit for bit), and
``input_structs``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, synth_batch
from repro.launch.steps import build_train_step as j_build_train_step
from repro.launch.steps import input_structs as j_input_structs
from repro.launch.train import tiny_config
from repro.models.api import build_model as j_build_model
from repro.optim.optimizers import make_optimizer as j_make_optimizer
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.steps import (CompiledTraining, build_train_step,
                                      input_structs)
from repro_torch.models import api as tapi
from repro_torch.optim.optimizers import make_optimizer


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    workers on the same cores, and each worker's default thread pool (one
    thread a core) then oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _err(got, want):
    """Max abs error of ``got`` over the max |want|."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.abs(want).max() + 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# models: loss_fn and every gradient leaf
# ---------------------------------------------------------------------------

GRAD_ARCHS = ["qwen2.5-3b", "gemma2-2b", "mamba2-1.3b", "zamba2-1.2b",
              "qwen2-moe-a2.7b", "musicgen-large", "kimi-k2-1t-a32b"]
B, S = 2, 16


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embed":
        inputs = (rng.standard_normal((B, S, cfg.d_model)) * 0.5
                  ).astype(np.float32)
    else:
        inputs = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"inputs": inputs,
            "targets": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}


def _reference_leaf(cfg, tree, name: str):
    """The JAX leaf (a layer of a stacked leaf) the port's parameter
    ``name`` came from (``params_from_reference``'s layout)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i, rest = int(parts[1]), parts[2:]
        fd = cfg.first_dense_layers if cfg.family == "moe" else 0
        node, i = (tree["dense_blocks"], i) if i < fd \
            else (tree["blocks"], i - fd)
        for p in rest:
            node = node[p]
        return np.asarray(node)[i]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)


def _both(cfg, seed=0):
    japi = j_build_model(cfg, dtype=jnp.float32)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    api = tapi.build_model(cfg, device="cpu", dtype=torch.float32)
    params = api.train_params(tapi.params_from_reference(
        cfg, tree, device="cpu", dtype=torch.float32))
    return japi, jparams, api, params


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    cfg = tiny_config(get_config(arch))
    japi, jparams, api, params = _both(cfg)
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    loss = api.loss_fn(params, {k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert _err(loss, jloss) <= 1e-5
    named = dict(params.named_parameters())
    assert sum(p.numel() for p in named.values()) == sum(
        x.size for x in jax.tree_util.tree_leaves(jgrads))
    for name, p in named.items():
        want = _reference_leaf(cfg, jgrads, name)
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        assert tuple(got.shape) == want.shape, name
        err = float(np.abs(_np(got) - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, err)


def test_remat_block_gives_the_same_gradients():
    """kimi-k2's ``remat="block"`` recomputes each block in the backward;
    the gradients are those of the plain forward."""
    cfg = tiny_config(get_config("kimi-k2-1t-a32b"))
    assert cfg.remat == "block"
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat="none")):
        _, _, api, params = _both(c)
        api.loss_fn(params, {k: _t(v) for k, v in
                             _batch(c).items()}).backward()
        grads.append({n: p.grad for n, p in params.named_parameters()})
    for n, g in grads[0].items():
        assert torch.allclose(g, grads[1][n], rtol=0, atol=1e-6), n


# ---------------------------------------------------------------------------
# the whole slice: train steps against the reference's jitted train_step
# ---------------------------------------------------------------------------

def _train_steps_against_jax(arch, compiled):
    """Three train steps of tiny ``arch`` against the reference's jitted
    ``train_step``, eager or through ``CompiledTraining``."""
    cfg = tiny_config(get_config(arch))
    japi, jparams, api, params = _both(cfg, seed=1)
    jopt = j_make_optimizer(cfg.optimizer, lr=1e-3)
    jstep = jax.jit(j_build_train_step(japi, jopt))
    jstate = jopt.init(jparams)
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    step = build_train_step(api, opt)
    state = opt.init(dict(params.named_parameters()))
    shape = ShapeConfig("t", S, B, "train")
    ctrain = CompiledTraining(api, params, state, opt,
                              input_structs(cfg, shape)) if compiled else None
    for i in range(3):
        batch = synth_batch(cfg, shape, i, DataConfig(seed=0))
        jparams, jstate, jm = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        if compiled:
            m = ctrain.step(batch)
        else:
            params, state, m = step(params, state,
                                    {k: _t(v) for k, v in batch.items()})
        assert _err(m["loss"], jm["loss"]) <= 1e-4, i
        assert _err(m["grad_norm"], jm["grad_norm"]) <= 1e-4, i
    assert int(state["step"]) == 3


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "kimi-k2-1t-a32b"])
def test_train_steps_match_jax(arch):
    _train_steps_against_jax(arch, compiled=False)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "kimi-k2-1t-a32b"])
def test_compiled_train_steps_match_jax(arch):
    """The compiled step against the reference's jitted one, which donates
    nothing here: the values are what must match."""
    _train_steps_against_jax(arch, compiled=True)


COMPILED_ARCHS = ["qwen2.5-3b", "zamba2-1.2b", "qwen2-moe-a2.7b",
                  "musicgen-large", "kimi-k2-1t-a32b"]


def _snapshot(params, state):
    leaves = {f"param/{n}": p.detach().clone()
              for n, p in params.named_parameters()}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        else:
            leaves[f"state{path}"] = tree.clone()
    walk(state, "")
    return leaves


@pytest.mark.parametrize("arch", COMPILED_ARCHS)
def test_compiled_training_equals_the_eager_step(arch):
    """``CompiledTraining`` over 3 steps gives the eager
    ``build_train_step``'s losses, gradient norms, parameters and
    optimizer state (Adafactor over the layer stacks for kimi-k2) bit for
    bit, in place in the tensors it was given; its batch buffers are
    allocated once."""
    cfg = tiny_config(get_config(arch))
    shape = ShapeConfig("t", S, B, "train")
    runs = []
    for compiled in (False, True):
        api = tapi.build_model(cfg, device="cpu", dtype=torch.float32,
                               trainable=True)
        params = api.init(3)
        opt = make_optimizer(cfg.optimizer, lr=1e-3,
                             stacks=tapi.layer_stacks(cfg, params))
        state = opt.init(dict(params.named_parameters()))
        ptrs = {n: p.data_ptr() for n, p in params.named_parameters()}
        step = build_train_step(api, opt)
        if compiled:
            ctrain = CompiledTraining(api, params, state, opt,
                                      input_structs(cfg, shape))
            bufs = {k: t.data_ptr() for k, t in ctrain.batch.items()}
        metrics = []
        for i in range(3):
            batch = synth_batch(cfg, shape, i, DataConfig(seed=0))
            if compiled:
                m = ctrain.step(batch)
            else:
                m = step(params, state,
                         {k: _t(v) for k, v in batch.items()})[2]
            metrics.append({k: v.clone() for k, v in m.items()})
        assert {n: p.data_ptr() for n, p in params.named_parameters()} \
            == ptrs
        if compiled:
            assert {k: t.data_ptr() for k, t in ctrain.batch.items()} \
                == bufs
            assert ctrain.capture_seconds == 0.0 and ctrain.pool_bytes == 0
        assert int(state["step"]) == 3
        runs.append((metrics, _snapshot(params, state)))
    (want_m, want), (got_m, got) = runs
    for w, g in zip(want_m, got_m):
        assert torch.equal(w["loss"], g["loss"])
        assert torch.equal(w["grad_norm"], g["grad_norm"])
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_compiled_training_refuses_another_batch_shape():
    cfg = tiny_config(get_config("qwen2.5-3b"))
    api = tapi.build_model(cfg, device="cpu", dtype=torch.float32,
                           trainable=True)
    params = api.init(0)
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    state = opt.init(dict(params.named_parameters()))
    shape = ShapeConfig("t", S, B, "train")
    ctrain = CompiledTraining(api, params, state, opt,
                              input_structs(cfg, shape))
    batch = synth_batch(cfg, ShapeConfig("t", 2 * S, B, "train"), 0)
    with pytest.raises(ValueError, match="graph holds"):
        ctrain.step(batch)
    assert int(state["step"]) == 0


@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", "train"),
                                       ("musicgen-large", "train"),
                                       ("mamba2-1.3b", "prefill"),
                                       ("zamba2-1.2b", "decode")])
def test_input_structs_match_jax(arch, mode):
    shape = ShapeConfig("c", 64, 4, mode)
    want = j_input_structs(get_config(arch), shape)
    got = input_structs(t_get_config(arch), shape)
    assert set(got) == set(want)
    for k, s in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == s.shape
        assert str(got[k].dtype).split(".")[-1] == str(s.dtype)
