"""The port's optimizers over the reference's layer stacks, and in place.

The reference stacks every block leaf on a layer axis; the port keeps one
leaf per layer.  Adafactor, given ``models.api.layer_stacks``, must compute
what the reference computes over each stacked leaf: ``vr`` and ``vc`` of a
stack of vectors, one clip RMS per stack.  The same numpy parameters and
gradients (scaled 1, 10 and 0.1 by layer, so that the layers' statistics
differ) go to the reference's ``adafactor`` on its stacked tree and to the
port's on its per-layer leaves; after each of three updates every
parameter and every state leaf agrees within 1e-6 of its max, f32 on both
sides.  Then: ``update`` and ``train_step`` write parameters and state
into the given tensors (the counterpart of the reference's donation),
bit for bit what the functional update computes, and the meta trace of a
train step no longer holds a second optimizer state.

Run as a script, the file prints how far the Adafactor of the
``repro_torch`` on the path lands from the reference's on the stack test's
inputs, so that another tree (one without ``layer_stacks``, whose
Adafactor keeps one leaf per layer) can be measured on them:

    PYTHONPATH=OTHER_CHECKOUT/src python3 tests/test_torch_optim_stacks.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.launch.train import tiny_config
from repro.models.api import build_model as j_build_model
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.op_cost import OpCounter, storage_bytes
from repro_torch.launch.steps import build_train_step, input_structs
from repro_torch.launch.train import tiny_config as t_tiny_config
from repro_torch.models import api as tapi
from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, tree_leaves,
                                          tree_map)

#: gradient scale of layer i: SCALES[i % 3]
SCALES = (1.0, 10.0, 0.1)
STACK_TOL = 1e-6


def _configs():
    kimi = dataclasses.replace(tiny_config(get_config("kimi-k2-1t-a32b")),
                               num_layers=5, first_dense_layers=2)
    zamba = dataclasses.replace(tiny_config(get_config("zamba2-1.2b")),
                                num_layers=3)
    return {"kimi-k2": kimi, "zamba2": zamba}


CONFIGS = _configs()


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny shapes, as the suite runs several
    workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(tree, key):
    for part in key.split("."):
        tree = tree[part]
    return tree


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.abs(want).max() + 1e-30))


def _reference_setup(cfg, seed=0):
    """The reference's f32 parameters (numpy), the port's copy of them as a
    flat dict of tensors, and the port's stacks."""
    jparams = j_build_model(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    model = tapi.params_from_reference(cfg, tree, device="cpu",
                                       dtype=torch.float32)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return tree, params, tapi.layer_stacks(cfg, model)


def _gradients(tree, stacks, rng):
    """Random gradients of the reference's tree, each stacked leaf's layer
    i scaled by ``SCALES[i % 3]``, and the same as the port's flat dict."""
    jg = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
    for key, names in stacks.items():
        leaf = _path(jg, key)
        for i in range(len(names)):
            leaf[i] *= SCALES[i % 3]
    flat = {}
    for key, names in stacks.items():
        for i, n in enumerate(names):
            flat[n] = torch.from_numpy(np.array(_path(jg, key)[i]))
    return jg, flat


def _flat_gradients(jg, params, stacks):
    """The port's gradients of the leaves in no stack."""
    member = {n for names in stacks.values() for n in names}
    return {n: torch.from_numpy(np.array(_path(jg, n)))
            for n in params if n not in member}


def _check(cfg, tree, jstate, params, state, stacks):
    member = {n for names in stacks.values() for n in names}
    for key, names in stacks.items():
        got = np.stack([params[n].numpy() for n in names])
        assert _err(got, _path(tree, key)) <= STACK_TOL, key
    for n in params:
        if n not in member:
            assert _err(params[n].numpy(), _path(tree, n)) <= STACK_TOL, n
    for key, s in state["f"].items():
        want = _path(jstate["f"], key)
        assert set(s) == set(want), key
        for k, t in s.items():
            assert tuple(t.shape) == want[k].shape, (key, k)
            assert _err(t.numpy(), want[k]) <= STACK_TOL, (key, k)
    assert int(state["step"]) == int(jstate["step"])


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_adafactor_over_stacks_matches_reference(arch):
    cfg = CONFIGS[arch]
    tree, params, stacks = _reference_setup(cfg)
    assert all(len(v) >= 2 for v in stacks.values())
    if arch == "kimi-k2":
        assert {k.split(".")[0] for k in stacks} == {"dense_blocks",
                                                     "blocks"}
    else:                # the hybrid's shared block is in no stack
        assert "shared.attn.wq" in params and all(
            not n.startswith("shared") for v in stacks.values() for n in v)
    # no global-norm clipping: over ~1e6 gradients the reference's f32 sum
    # of squares lands 1.2e-5 off the float64 one, which would swamp the
    # statistics compared here (``test_optim``'s parity covers clipping).
    # A small step: a parameter's error is lr times its direction's, so an
    # f32 sqrt that is not correctly rounded moves it little
    jo = jopt.make_optimizer("adafactor", lr=1e-4, clip_norm=0.0)
    to = make_optimizer("adafactor", lr=1e-4, clip_norm=0.0, stacks=stacks)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jo.init(jp)
    state = to.init(params)
    # the state tree has the reference's paths and shapes
    ref_keys = {".".join(str(getattr(k, "key", k)) for k in p[:-1])
                for p, _ in jax.tree_util.tree_flatten_with_path(
                    jstate["f"])[0]}
    assert set(state["f"]) == ref_keys
    rng = np.random.default_rng(0)
    for _ in range(3):
        jg, flat = _gradients(tree, stacks, rng)
        flat.update(_flat_gradients(jg, params, stacks))
        jp, jstate = jo.update(jax.tree_util.tree_map(jnp.asarray, jg),
                               jstate, jp)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        out, state = to.update(flat, state, params)
        assert out is params
        _check(cfg, tree, jax.tree_util.tree_map(np.asarray, jstate),
               params, state, stacks)


def test_layer_stacks_follow_the_reference_cut():
    cfg = CONFIGS["kimi-k2"]
    model = tapi.build_model(cfg, device="meta").init(0)
    stacks = tapi.layer_stacks(cfg, model)
    assert stacks["dense_blocks.mlp.wi"] == ["blocks.0.mlp.wi",
                                             "blocks.1.mlp.wi"]
    assert stacks["blocks.moe.router"] == [f"blocks.{i}.moe.router"
                                           for i in (2, 3, 4)]
    gemma = t_tiny_config(t_get_config("gemma2-2b"))
    gstacks = tapi.layer_stacks(
        gemma, tapi.build_model(gemma, device="meta").init(0))
    assert gstacks["blocks.attn.wq"] == [f"blocks.{i}.attn.wq"
                                         for i in range(gemma.num_layers)]


def test_adafactor_without_stacks_keeps_per_leaf_state():
    opt = make_optimizer("adafactor")
    params = {"blocks.0.ln": torch.zeros(4), "blocks.1.ln": torch.zeros(4)}
    state = opt.init(params)
    assert set(state["f"]) == set(params)
    assert state["f"]["blocks.0.ln"]["v"].shape == (4,)


# ---------------------------------------------------------------------------
# in place
# ---------------------------------------------------------------------------

def _functional_adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.1, clip_norm=1.0):
    """AdamW as the port computed it before it wrote in place: the same
    f32 formulas, new tensors returned, the arguments left alone."""
    base = adamw(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 clip_norm=clip_norm)

    def update(grads, state, params):
        if clip_norm > 0:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        t = step.float()
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            new = p.float() - lr * (
                mh / (torch.sqrt(vh) + eps) + weight_decay * p.float())
            new_p[k], new_m[k], new_v[k] = new.to(p.dtype), m, v
        return new_p, {"m": new_m, "v": new_v, "step": step}
    return Optimizer("adamw", base.init, update)


def _on_copies(opt):
    """``opt``'s update on copies of the parameters and state."""
    def update(grads, state, params):
        return opt.update(grads, tree_map(lambda t: t.clone(), state),
                          tree_map(lambda t: t.clone(), params))
    return Optimizer(opt.name, opt.init, update)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_updates_in_place(name):
    cfg = t_tiny_config(t_get_config("zamba2-1.2b"))
    api = tapi.build_model(cfg, device="cpu", dtype=torch.float32,
                           trainable=True)
    params = api.init(0)
    ref_params = api.init(0)
    stacks = tapi.layer_stacks(cfg, params)
    opt = make_optimizer(name, lr=1e-2, stacks=stacks)
    functional = _functional_adamw(lr=1e-2) if name == "adamw" \
        else _on_copies(opt)
    state = opt.init(dict(params.named_parameters()))
    ptrs = {n: p.data_ptr() for n, p in params.named_parameters()}
    sptrs = [t.data_ptr() for t in tree_leaves(state)]
    step = build_train_step(api, opt)
    rng = np.random.default_rng(0)
    for i in range(2):
        batch = {"inputs": torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (2, 16)).astype(np.int32)),
            "targets": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 16)).astype(np.int32))}
        # the functional update of the same gradients, from copies
        named = dict(ref_params.named_parameters())
        for p in named.values():
            p.grad = None
        api.loss_fn(ref_params, batch).backward()
        grads = {n: p.grad for n, p in named.items()}
        with torch.no_grad():
            want_p, want_s = functional.update(
                grads, state, {n: p.detach() for n, p in named.items()})
            for n, p in named.items():
                p.copy_(want_p[n])
        out, state2, m = step(params, state, batch)
        assert out is params and state2 is state
        assert float(m["grad_norm"]) == float(global_norm(grads))
        for n, p in params.named_parameters():
            assert p.data_ptr() == ptrs[n], n
            assert torch.equal(p, want_p[n]), (i, n)
        assert [t.data_ptr() for t in tree_leaves(state)] == sptrs
        for got, want in zip(tree_leaves(state), tree_leaves(want_s)):
            assert torch.equal(got, want), i
    assert int(state["step"]) == 2


def test_adamw_in_place_equals_the_functional_update_bit_for_bit():
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.standard_normal((6, 5))
                                    .astype(np.float32)).to(torch.bfloat16),
              "b": torch.from_numpy(rng.standard_normal(5)
                                    .astype(np.float32))}
    opt, fopt = adamw(lr=1e-2), _functional_adamw(lr=1e-2)
    state = opt.init(params)
    fparams, fstate = tree_map(lambda t: t.clone(), params), \
        opt.init(params)
    for _ in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)).to(v.dtype) for k, v in params.items()}
        fparams, fstate = fopt.update(grads, fstate, fparams)
        out, state = opt.update(grads, state, params)
        assert out is params
        for k in params:
            assert torch.equal(params[k], fparams[k]), k
            assert torch.equal(state["m"][k], fstate["m"][k]), k
            assert torch.equal(state["v"][k], fstate["v"][k]), k


def test_meta_train_step_holds_one_optimizer_state():
    """The tiny Zamba2 AdamW step traced on meta: the functional update
    holds its new state beside the old until the step ends; in place, the
    trace's peak is lower by at least that state's bytes, and the step
    returns no new buffer but its two metrics.  One 16-token sequence, so
    that the update and not the backward holds the peak."""
    cfg = t_tiny_config(t_get_config("zamba2-1.2b"))
    shape = ShapeConfig("t", 16, 1, "train")

    def trace(opt):
        api = tapi.build_model(cfg, device="meta", trainable=True)
        params = api.init(0)
        state = opt.init(dict(params.named_parameters()))
        args = (params, state, input_structs(cfg, shape))
        step = build_train_step(api, opt)
        with OpCounter("meta") as counter:
            counter.hold(args)
            out = step(*args)
        return counter.cost(), out, state

    fcost, _, _ = trace(_functional_adamw())
    cost, out, state = trace(adamw())
    state_bytes = storage_bytes({"m": state["m"], "v": state["v"]})
    assert fcost.peak_bytes - cost.peak_bytes >= state_bytes
    assert storage_bytes(out[2]) == 8     # loss and grad norm, f32
    assert out[1] is state


# ---------------------------------------------------------------------------
# as a script: the stack test's difference for any tree
# ---------------------------------------------------------------------------

def _reference_cut(cfg, params):
    """The reference's cut of the per-layer names into stacks, for a tree
    without ``layer_stacks``: ``blocks.<i>.<rest>`` is layer i of
    ``dense_blocks.<rest>`` below an MoE model's ``first_dense_layers``,
    else of ``blocks.<rest>``."""
    fd = cfg.first_dense_layers if cfg.family == "moe" else 0
    stacks = {}
    for n in params:
        parts = n.split(".")
        if parts[0] == "blocks":
            stack = "dense_blocks" if int(parts[1]) < fd else "blocks"
            stacks.setdefault(f"{stack}.{'.'.join(parts[2:])}", []).append(n)
    return stacks


def _stack_diff():
    """Per model, the largest |port - reference| of any parameter over its
    reference leaf's max |value| after the stack test's three updates."""
    torch.set_num_threads(1)
    for name, cfg in CONFIGS.items():
        jparams = j_build_model(cfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        model = tapi.params_from_reference(cfg, tree, device="cpu",
                                           dtype=torch.float32)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        kw = {}
        if hasattr(tapi, "layer_stacks"):
            kw["stacks"] = stacks = tapi.layer_stacks(cfg, model)
        else:
            stacks = _reference_cut(cfg, params)
        jo = jopt.make_optimizer("adafactor", lr=1e-4, clip_norm=0.0)
        to = make_optimizer("adafactor", lr=1e-4, clip_norm=0.0, **kw)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jstate, state = jo.init(jp), to.init(params)
        member = {n for names in stacks.values() for n in names}
        rng = np.random.default_rng(0)
        worst = 0.0
        for _ in range(3):
            jg, flat = _gradients(tree, stacks, rng)
            flat.update(_flat_gradients(jg, params, stacks))
            jp, jstate = jo.update(jax.tree_util.tree_map(jnp.asarray, jg),
                                   jstate, jp)
            tree = jax.tree_util.tree_map(np.asarray, jp)
            params, state = to.update(flat, state, params)
            errs = [_err(np.stack([params[n].numpy() for n in names]),
                         _path(tree, key)) for key, names in stacks.items()]
            errs += [_err(p.numpy(), _path(tree, n))
                     for n, p in params.items() if n not in member]
            worst = max(worst, *errs)
        print(f"{name}: max |param - reference| / max |reference leaf| "
              f"after 3 updates: {worst:.3e}")


if __name__ == "__main__":
    _stack_diff()
