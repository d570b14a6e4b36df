"""The port's optimizers and gradient compression: ``adamw`` and
``adafactor`` updates against the JAX package's on identical numpy params,
grads and state (1e-6), and the reference's own cases
(``tests/test_optim.py``) on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:     # degrade: property tests skip, rest run
    from _hypothesis_stub import given, settings, strategies as st

from repro.optim import optimizers as jopt
from repro_torch.optim.compression import (compress, compress_tree,
                                           decompress, ef_round, init_error,
                                           wire_bytes_saved)
from repro_torch.optim.optimizers import (adafactor, adamw,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, tree_leaves)

SHAPES = {"w": (8, 6), "stack": (3, 4, 5), "b": (6,), "s": ()}


def _np_tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _sorted_leaves(tree):
    """Leaves in sorted key order, as ``jax.tree_util`` walks a dict."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _max_err(t_tree, j_tree):
    t = [x.float().numpy() for x in _sorted_leaves(t_tree)]
    j = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(j_tree)]
    assert [x.shape for x in t] == [x.shape for x in j]
    return max(float(np.max(np.abs(a - b)) / (np.abs(b).max() + 1e-30))
               for a, b in zip(t, j))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_update_matches_jax(name, grad_scale):
    """Three updates from the same params, grads and (random, non-zero)
    state, with clipping on (``grad_scale`` 10 clips, 1e-3 does not)."""
    rng = np.random.default_rng(int(grad_scale * 1000))
    params = _np_tree(rng)
    jo = jopt.make_optimizer(name, lr=0.01)
    to = make_optimizer(name, lr=0.01)
    jstate = jo.init(jax.tree_util.tree_map(jnp.asarray, params))
    # a random state of the right structure, positive second moments
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.standard_normal(x.shape))
                              .astype(np.float32) * 1e-3)
        if x.dtype == jnp.float32 else jnp.asarray(4, jnp.int32), jstate)
    tstate = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)), jstate)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch_tree(params)
    for _ in range(3):
        grads = _np_tree(rng, grad_scale)
        jp, jstate = jo.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               jstate, jp)
        tp, tstate = to.update(_torch_tree(grads), tstate, tp)
        assert _max_err(tp, jp) <= 1e-6
        assert _max_err({k: v for k, v in tstate.items() if k != "step"},
                        {k: v for k, v in jstate.items() if k != "step"}) \
            <= 1e-6
        assert int(tstate["step"]) == int(jstate["step"])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_keeps_bf16_params_and_f32_state(name):
    opt = make_optimizer(name)
    params = {"w": torch.ones((4, 3), dtype=torch.bfloat16),
              "b": torch.ones((3,), dtype=torch.bfloat16)}
    state = opt.init(params)
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    new, state = opt.update(grads, state, params)
    assert all(v.dtype == torch.bfloat16 for v in new.values())
    state_leaves = tree_leaves({k: v for k, v in state.items()
                                if k != "step"})
    assert all(v.dtype == torch.float32 for v in state_leaves)
    # written in place, as the reference's donated train step
    assert new is params and new["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# tests/test_optim.py on the port
# ---------------------------------------------------------------------------

def quad_loss(params):
    return sum(torch.sum(torch.square(p - 3.0)) for p in params.values())


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_reduces_loss(opt_name):
    opt = make_optimizer(opt_name, lr=0.1, weight_decay=0.0)
    params = {"w": torch.zeros((8, 8)), "b": torch.zeros((8,))}
    state = opt.init(params)
    losses = []
    for _ in range(60):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        loss = quad_loss(leaves)
        loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        params, state = opt.update(grads, state, params)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.2


def test_adafactor_state_is_factored():
    opt = adafactor()
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros((16,))}
    state = opt.init(params)
    assert state["f"]["w"]["vr"].shape == (64,)
    assert state["f"]["w"]["vc"].shape == (32,)
    assert state["f"]["b"]["v"].shape == (16,)
    # factored state is much smaller than the params
    n_state = sum(x.numel() for x in tree_leaves(state["f"]))
    n_param = sum(x.numel() for x in tree_leaves(params))
    assert n_state < n_param * 0.2


def test_adamw_state_is_f32_on_the_params_device():
    state = adamw().init({"w": torch.zeros((2, 3), dtype=torch.bfloat16)})
    assert state["m"]["w"].dtype == state["v"]["w"].dtype == torch.float32
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped = clip_by_global_norm(g, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    small = {"a": torch.full((4,), 0.01)}
    out = clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(out["a"].numpy(), small["a"].numpy(),
                               rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(-100, 100), min_size=1, max_size=32))
def test_compression_bounded_error(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, s = compress(x)
    back = decompress(q, s)
    assert float((back - x).abs().max()) <= float(s) * 0.5 + 1e-6


def test_compression_matches_jax():
    from repro.optim import compression as jcomp
    x = np.random.default_rng(0).standard_normal(100).astype(np.float32) * 3
    q, s = compress(torch.from_numpy(x))
    jq, js = jcomp.compress(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    tree = compress_tree({"a": torch.from_numpy(x)})
    assert torch.equal(tree["a"][0], q)


def test_error_feedback_converges():
    """EF accumulates what quantization drops: the *sum* of dequantized
    grads over steps tracks the sum of true grads."""
    g = {"w": torch.full((16,), 0.003)}
    err = init_error(g)
    total = np.zeros((16,), np.float32)
    for _ in range(100):
        deq, err = ef_round(g, err)
        total += deq["w"].float().numpy()
    np.testing.assert_allclose(total, 0.3 * np.ones(16), rtol=0.05)


def test_wire_bytes_saved():
    g = {"w": torch.zeros((1000,))}
    bf16, int8 = wire_bytes_saved(g)
    assert bf16 == 2000 and int8 < bf16
