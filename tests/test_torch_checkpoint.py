"""The port's checkpoints: the reference's cases (``tests/test_checkpoint.py``)
on trees of tensors, plus a model's parameters by name (bf16 through f32,
written back in place), the optimizer state on the model's device, and the
reference's on-disk layout."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:     # degrade: property tests skip, rest run
    from _hypothesis_stub import given, settings, strategies as st

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.launch.train import tiny_config
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import make_optimizer


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn((8, 4), generator=g),
                      "b": torch.randn((4,), generator=g)},
            "head": torch.randn((4, 16), generator=g).to(torch.bfloat16)}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_roundtrip(tmp_path):
    params = _tree(0)
    opt = {"m": _zeros_like(params), "step": torch.tensor(7)}
    path = ckpt.save(str(tmp_path), 7, params, opt, extra={"loss": 1.5})
    assert os.path.exists(os.path.join(path, "manifest.json"))
    p2, o2, man = ckpt.restore(str(tmp_path), _zeros_like(params), opt)
    assert man["step"] == 7 and man["extra"]["loss"] == 1.5
    for a, b in zip(_leaves(params), _leaves(p2)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert int(o2["step"]) == 7 and o2["step"].dtype == torch.int64


def test_retention_gc(tmp_path):
    params = _tree(1)
    for s in range(5):
        ckpt.save(str(tmp_path), s, params, {"step": torch.tensor(s)},
                  keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_no_tmp_left_behind_on_failure(tmp_path):
    params = _tree(2)

    class Boom:
        def __iter__(self):
            raise RuntimeError("disk full")
    with pytest.raises(Exception):
        ckpt.save(str(tmp_path), 0, params, Boom())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_shape_mismatch_rejected(tmp_path):
    params = _tree(3)
    ckpt.save(str(tmp_path), 1, params, {"step": torch.tensor(1)})
    bad_template = {"layer": {"w": torch.zeros((9, 4)),
                              "b": torch.zeros((4,))},
                    "head": torch.zeros((4, 16), dtype=torch.bfloat16)}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), bad_template, {"step": torch.tensor(0)})


def test_missing_checkpoint_raises(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {}, {})


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4), st.integers(1, 6))
def test_property_roundtrip_random_trees(depth, width):
    import tempfile
    tmp = tempfile.mkdtemp(prefix="ckpt_prop_")
    rng = np.random.default_rng(depth * 10 + width)
    tree = {f"k{i}": np.asarray(rng.standard_normal((width, depth)),
                                np.float32)
            for i in range(depth)}
    ckpt.save(str(tmp), 0, tree, {"s": np.asarray(0)})
    t2, _, _ = ckpt.restore(str(tmp), tree, {"s": np.asarray(0)})
    for k in tree:
        np.testing.assert_array_equal(tree[k], t2[k])


def test_model_and_optimizer_roundtrip_by_name(tmp_path):
    """A bf16 model's parameters go out by ``named_parameters()`` name, as
    f32, and come back bit for bit into the same module, in place, after
    the layout the reference writes; the optimizer state comes back with
    its types."""
    cfg = tiny_config(get_config("zamba2-1.2b"))
    api = build_model(cfg, device="cpu", trainable=True)
    params = api.init(0)
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(dict(params.named_parameters()))
    state["m"]["embed"].fill_(0.25)
    state["step"] += 3
    path = ckpt.save(str(tmp_path), 3, params, state)
    assert sorted(os.listdir(path)) == ["manifest.json", "opt_h0.npz",
                                        "params_h0.npz"]
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["step"] == 3
    with np.load(os.path.join(path, "params_h0.npz")) as z:
        assert sorted(z.files) == sorted(n for n, _ in
                                         params.named_parameters())
        assert z["blocks.0.mamba.w_z"].dtype == np.float32
    with np.load(os.path.join(path, "opt_h0.npz")) as z:
        assert "m/shared.attn.wq" in z.files and "step" in z.files
    want = {n: p.detach().clone() for n, p in params.named_parameters()}
    fresh = api.init(1)
    template = opt.init(dict(fresh.named_parameters()))
    p2, s2, man = ckpt.restore(str(tmp_path), fresh, template)
    assert p2 is fresh and man["step"] == 3
    for n, p in fresh.named_parameters():
        assert p.dtype == want[n].dtype and p.requires_grad, n
        assert torch.equal(p, want[n]), n
    assert torch.equal(s2["m"]["embed"], state["m"]["embed"])
    assert s2["step"].dtype == torch.int32 and int(s2["step"]) == 3


def test_model_shape_mismatch_leaves_the_model_untouched(tmp_path):
    cfg = tiny_config(get_config("qwen2.5-3b"))
    api = build_model(cfg, device="cpu", trainable=True)
    ckpt.save(str(tmp_path), 1, api.init(0), {})
    wider = build_model(dataclasses.replace(cfg, d_ff=512),
                        device="cpu").init(2)
    before = {n: p.clone() for n, p in wider.named_parameters()}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), wider, {})
    for n, p in wider.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_restore_writes_the_optimizer_state_in_place(tmp_path, optimizer):
    """Every tensor leaf of the templates comes back as the template's own
    tensor holding the saved values (``m``, ``v``, Adafactor's ``vr`` and
    ``vc``, ``step``), as the compiled train step's graph needs; a numpy
    leaf comes back as a new array of its type."""
    cfg = tiny_config(get_config("kimi-k2-1t-a32b"))
    api = build_model(cfg, device="cpu", trainable=True)
    params = api.init(0)
    opt = make_optimizer(optimizer)
    state = opt.init(dict(params.named_parameters()))
    g = torch.Generator().manual_seed(5)
    for leaf in _leaves(state):
        if leaf.is_floating_point():
            leaf.copy_(torch.rand(leaf.shape, generator=g))
    state["step"] += 4
    saved = [t.clone() for t in _leaves(state)]
    ckpt.save(str(tmp_path), 4, params, {**state, "host": np.int64(7)})
    template = opt.init(dict(params.named_parameters()))
    objects = _leaves(template)
    got = ckpt.restore(str(tmp_path), params,
                       {**template, "host": np.int64(0)})[1]
    host = got.pop("host")
    assert isinstance(host, np.ndarray) and host.dtype == np.int64 \
        and int(host) == 7
    assert len(_leaves(got)) == len(objects)
    for obj, back, want in zip(objects, _leaves(got), saved):
        assert back is obj
        assert back.dtype == want.dtype and torch.equal(back, want)
    assert int(template["step"]) == 4


def test_restore_in_place_checks_every_leaf_before_writing(tmp_path):
    """A missing leaf or a shape mismatch anywhere raises before any
    tensor of the templates is written."""
    params = _tree(4)
    opt = {"m": _zeros_like(params), "step": torch.tensor(3)}
    ckpt.save(str(tmp_path), 3, params, opt)
    fresh = _zeros_like(params)
    missing = {"m": _zeros_like(params), "v": torch.zeros(2),
               "step": torch.tensor(0)}
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        ckpt.restore(str(tmp_path), fresh, missing)
    wrong = {"m": {**_zeros_like(params), "head": torch.zeros((5, 16))},
             "step": torch.tensor(0)}
    with pytest.raises(ValueError, match="head"):
        ckpt.restore(str(tmp_path), fresh, wrong)
    for leaf in _leaves(fresh) + _leaves(missing) + _leaves(wrong):
        assert not leaf.any()
