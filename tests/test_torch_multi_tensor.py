"""The multi-tensor AdamW (``kernels/multi_tensor.py``): the sum of
squares' and the clipped update's kernels over every leaf of a tree at
once, and their plain versions, the per-leaf code.

On the CPU: the launch packing covers every element of every leaf once, in
leaf order, within its kernel-argument limit, whose constants are the CUDA
source's; the device alone routes (the plain versions on the CPU, nothing
run on meta, no launch on either), a rank's windows (``shards``) go
through the same wrappers as a whole tree and a mesh of one rank gives
its bits, and the cost counter counts each call as one unit, alike on
the CPU and on meta.  On the card (``-m gpu``): over a tree that mixes
bf16 and f32 leaves of 1, 63, 64, 4,097 and 2^20 + 3 elements, a leaf at
an address that is not 16-byte aligned and enough small leaves for
several launches, the update equals the per-leaf path bit for bit given
the same clip scale (clip active, inactive, none), eagerly, through the
optimizer and replayed in a CUDA graph; the norm is within 1e-6 of the
per-leaf norm and the same bits every run; the launches are counted;
tensors the kernels do not take raise; the cost counter on the card
counts what it counts on meta.  The file imports no JAX, so the card's
machine runs it too."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import multi_tensor as mt
from repro_torch.kernels import ops
from repro_torch.launch.op_cost import KERNEL_UNITS, OpCounter
from repro_torch.optim.optimizers import adamw, clip_scale, global_norm

SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc" / "model_kernels.cu"
#: the sizes the card tests take in both types, and the small leaves that
#: push the tree past one launch of either kernel
SIZES = (1, 63, 64, 4097, (1 << 20) + 3)
SMALL = 170
STEPS = 3
HP = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _plain_norm(ts):
    return torch.sqrt(mt.plain_sumsq(ts))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the packing (CPU)
# ---------------------------------------------------------------------------

def _cuda_constants():
    text = SOURCE.read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (MT_[A-Z_]+) = (\d+);", text)}


def _args_bytes(leaves: int, pointers: int, tail: int) -> int:
    """sizeof of an ``Mt*Args`` struct: int64 sizes and ``pointers``
    addresses a leaf, int first blocks (one more), bf16 and vec bytes, the
    int count, then ``tail`` bytes of 8-byte-aligned members."""
    size = 8 * leaves * (1 + pointers) + 4 * (leaves + 1) + 2 * leaves + 4
    return -(-size // 8) * 8 + tail


def test_packing_constants_are_the_cuda_sources():
    c = _cuda_constants()
    assert (c["MT_CHUNK"], c["MT_SUMSQ_LEAVES"], c["MT_ADAMW_LEAVES"]) == \
        (mt.CHUNK, mt.SUMSQ_LEAVES, mt.ADAMW_LEAVES)
    # the structs fit the kernel-argument limit the kernels are built for
    assert _args_bytes(mt.SUMSQ_LEAVES, 1, 8) <= c["MT_ARG_BYTES"]
    assert _args_bytes(mt.ADAMW_LEAVES, 4, 3 * 8 + 7 * 4) <= \
        c["MT_ARG_BYTES"]
    assert mt.CHUNK % (8 * c["MT_THREADS"]) == 0


@pytest.mark.parametrize("numels,per_launch", [
    ([1, 63, 64, 4097, (1 << 20) + 3], 80),
    ([5] * 200 + [3 * mt.CHUNK + 1], 160),
    ([0, 7, 0, 0, mt.CHUNK, mt.CHUNK + 1, 0], 2),
    ([mt.CHUNK * 3] * 5, 1),
    ([], 80),
    ([0, 0], 80),
])
def test_plan_covers_every_element_once_in_leaf_order(numels, per_launch):
    packs = mt.plan(numels, per_launch)
    seen = []
    first = 0
    for pack in packs:
        assert 0 < len(pack.leaves) <= per_launch
        assert pack.first == first
        first += pack.blocks
        assert pack.starts[0] == 0 and len(pack.starts) == \
            len(pack.leaves) + 1
        seen += pack.chunks(numels)
    assert [leaf for leaf, _, _ in seen] == sorted(
        leaf for leaf, _, _ in seen)
    for i, n in enumerate(numels):
        spans = [(lo, hi) for leaf, lo, hi in seen if leaf == i]
        # each block a whole chunk but the leaf's last, no block empty
        assert spans == [(lo, min(n, lo + mt.CHUNK))
                         for lo in range(0, n, mt.CHUNK)]


# ---------------------------------------------------------------------------
# the routing (CPU)
# ---------------------------------------------------------------------------

def _tree(device, dtype=torch.float32, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"w": (8, 6), "b": (6,), "s": (), "big": (3, 700)}
    return {k: (torch.randn(s, generator=g) * scale).to(dtype).to(device)
            for k, s in shapes.items()}


def _state(opt, params, seed=1):
    state = opt.init(params)
    g = torch.Generator().manual_seed(seed)
    for k in params:
        state["m"][k].copy_(torch.randn(params[k].shape, generator=g) * .01)
        state["v"][k].copy_(torch.rand(params[k].shape, generator=g) * .01)
    return state


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_cpu_update_is_the_per_leaf_path(grad_scale):
    """On the CPU the update is ``clip_by_global_norm`` and the plain
    per-leaf update, bit for bit, and launches nothing."""
    opt = adamw(**HP)
    params = _tree("cpu", torch.bfloat16)
    state = _state(opt, params)
    want_p = {k: v.clone() for k, v in params.items()}
    want_s = {k: {n: t.clone() for n, t in state[k].items()}
              for k in ("m", "v")}
    ops.reset_launch_counts()
    for i in range(STEPS):
        grads = _tree("cpu", torch.bfloat16, seed=10 + i, scale=grad_scale)
        opt.update(grads, state, params)
        scale = clip_scale(_plain_norm(list(grads.values())), 1.0)
        t = torch.tensor(float(i + 1))
        mt.plain_adamw(list(want_p.values()), list(grads.values()),
                       list(want_s["m"].values()),
                       list(want_s["v"].values()),
                       1.0 - torch.pow(HP["b1"], t),
                       1.0 - torch.pow(HP["b2"], t), scale, **HP)
        for k in params:
            assert torch.equal(params[k], want_p[k]), k
            assert torch.equal(state["m"][k], want_s["m"][k]), k
            assert torch.equal(state["v"][k], want_s["v"][k]), k
    assert int(state["step"]) == STEPS
    assert all(v == 0 for k, v in ops.launch_counts().items()
               if k.startswith("multi_tensor"))


def test_meta_update_takes_the_per_leaf_path():
    """On meta the update and the norm run nothing and launch nothing: the
    parameters stay meta tensors, the norm a 0-d float32 one."""
    opt = adamw(**HP)
    params = _tree("meta", torch.bfloat16)
    state = opt.init(params)
    grads = _tree("meta", torch.bfloat16)
    ops.reset_launch_counts()
    out, state = opt.update(grads, state, params)
    assert out is params and all(p.is_meta for p in out.values())
    norm = global_norm(grads)
    assert norm.is_meta and norm.shape == () and norm.dtype == torch.float32
    assert ops.launch_counts()["multi_tensor_adamw"] == 0
    assert ops.launch_counts()["multi_tensor_sumsq"] == 0


class _OneRank:
    """A rank's ``TreeShards`` stand-in for a mesh of one rank: every
    window the whole leaf, every collective the identity."""

    def __init__(self, names):
        self.params = self.grads = {n: None for n in names}
        self.sh = self

    def axes(self, lay, dims=None):
        return ()

    def narrower(self, lay, state_lay):
        return []

    def all_reduce(self, t, axes):
        return t


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' calls recorded, each then run as it is."""
    calls = []
    sumsq, update = mt.sumsq, mt.adamw
    monkeypatch.setattr(mt, "sumsq", lambda ts: calls.append("sumsq")
                        or sumsq(ts))
    monkeypatch.setattr(mt, "adamw", lambda *a, **k: calls.append("adamw")
                        or update(*a, **k))
    return calls


def test_the_routing_sends_whole_trees_to_the_kernels(card_route):
    """A whole tree and a rank's windows both take the wrappers: one sum
    of squares, then the update with the clip inside it (no clipped tree);
    a mesh of one rank gives the whole tree's bits."""
    opt = adamw(**HP)
    params = _tree("cpu", torch.bfloat16)
    state = _state(opt, params)
    ref_p = {k: v.clone() for k, v in params.items()}
    ref_s = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in state.items()}
    grads = _tree("cpu", torch.bfloat16, seed=5, scale=10.0)
    assert float(_plain_norm(list(grads.values()))) > 1.0   # clips
    opt.update(grads, state, params)
    assert card_route == ["sumsq", "adamw"]
    card_route.clear()
    opt.update(grads, ref_s, ref_p, _OneRank(list(params)))
    assert card_route == ["sumsq", "adamw"]     # a rank's windows alike
    for k in params:
        assert torch.equal(params[k], ref_p[k]), k
        assert torch.equal(state["m"][k], ref_s["m"][k]), k
        assert torch.equal(state["v"][k], ref_s["v"][k]), k
    assert int(state["step"]) == int(ref_s["step"]) == 1
    assert torch.equal(global_norm(grads),
                       global_norm(grads, _OneRank(list(params))))


def _counted_update(device, clip_norm):
    """The cost counter's counts of one update and one norm on
    ``device``."""
    opt = adamw(**HP, clip_norm=clip_norm)
    params = _tree(device, torch.bfloat16)
    grads = _tree(device, torch.bfloat16, seed=3, scale=10.0)
    state = opt.init(params)
    ops.reset_launch_counts()
    with OpCounter(torch.device(device)) as counter:
        opt.update(grads, state, params)
        global_norm(grads)
    cost = counter.cost()
    return params, (cost.flops, cost.bytes, cost.kernel_units)


@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_cost_counter_counts_each_call_as_one_unit(clip_norm):
    """The update and each sum of squares count as a kernel's unit, alike
    on the CPU (the plain versions run) and on meta (nothing runs): 22 B
    and 16 flops a bf16 element for the update (17 with the clip), the
    gradients' bytes for a sum of squares."""
    params, cpu = _counted_update("cpu", clip_norm)
    _, meta = _counted_update("meta", clip_norm)
    assert cpu == meta
    n = sum(p.numel() for p in params.values())
    sums = 2 if clip_norm > 0 else 1
    assert cpu[2] == {"multi_tensor_sumsq": sums, "multi_tensor_adamw": 1}
    assert KERNEL_UNITS["multi_tensor_adamw"](
        list(params.values()), list(params.values()),
        clip=clip_norm > 0) == ((17 if clip_norm > 0 else 16) * n, 22 * n)
    assert KERNEL_UNITS["multi_tensor_sumsq"](
        list(params.values())) == (2 * n, 2 * n + 4)
    assert all(v == 0 for k, v in ops.launch_counts().items()
               if k.startswith("multi_tensor"))


def test_the_kernels_refuse_what_they_do_not_take():
    """``_check``: a tensor of another type, on another device, or not
    contiguous raises, as the card's wrappers do before a launch."""
    dev = torch.device("cpu")
    ok = [torch.zeros(4), torch.zeros(3, dtype=torch.bfloat16)]
    mt._check("t", dev, ok)
    with pytest.raises(TypeError):
        mt._check("t", dev, ok + [torch.zeros(2, dtype=torch.float64)])
    with pytest.raises(ValueError):
        mt._check("t", dev, ok + [torch.zeros(4, 4).t()])
    with pytest.raises(ValueError):
        mt._check("t", torch.device("meta"), ok)
    with pytest.raises(ValueError):
        mt.adamw(ok, ok[:1], ok, ok, ok[0], ok[0], lr=1e-3, b1=.9, b2=.95,
                 eps=1e-8, weight_decay=0.)
    with pytest.raises(ValueError):
        mt.sumsq([])


# ---------------------------------------------------------------------------
# the kernels (card)
# ---------------------------------------------------------------------------

def _card_tree(dev, seed: int, grad_scale: float):
    """(params, grads, m, v) lists: each of ``SIZES`` in bf16 and f32, one
    bf16 leaf at an address 2 bytes past 16-byte alignment, and ``SMALL``
    leaves of 1 to 37 elements in both types."""
    g = torch.Generator(device=dev).manual_seed(seed)
    specs = [(n, dt) for n in SIZES for dt in (torch.bfloat16,
                                               torch.float32)]
    specs += [(1 + i % 37, (torch.bfloat16, torch.float32)[i % 2])
              for i in range(SMALL)]
    ps, gs, ms, vs = [], [], [], []
    for n, dt in specs:
        ps.append(torch.randn(n, generator=g, device=dev).to(dt))
        gs.append((torch.randn(n, generator=g, device=dev)
                   * grad_scale).to(dt))
        ms.append(torch.randn(n, generator=g, device=dev) * 1e-2)
        vs.append(torch.rand(n, generator=g, device=dev) * 1e-3)
    # unaligned: a view one bf16 element into its buffer, so every 16-byte
    # load of the leaf falls back to the scalar path
    n = 4097
    buf = torch.randn(n + 1, generator=g, device=dev).to(torch.bfloat16)
    ps.append(buf[1:])
    gs.append((torch.randn(n, generator=g, device=dev)
               * grad_scale).to(torch.bfloat16))
    ms.append(torch.randn(n, generator=g, device=dev) * 1e-2)
    vs.append(torch.rand(n, generator=g, device=dev) * 1e-3)
    assert ps[-1].data_ptr() % 16 == 2 and ps[-1].is_contiguous()
    return ps, gs, ms, vs


def _clone(ts):
    return [t.clone() for t in ts]


def _assert_equal(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, i, a.numel())


def _corrections(step):
    t = step.add_(1).float()
    return 1.0 - torch.pow(HP["b1"], t), 1.0 - torch.pow(HP["b2"], t)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["active", "inactive", "none"])
def test_update_kernel_equals_the_per_leaf_path_bitwise(clip):
    dev = _card()
    ps, gs, ms, vs = _card_tree(dev, 0, 10.0 if clip == "active" else 1e-4)
    qs, ns, ws = _clone(ps), _clone(ms), _clone(vs)
    steps = [torch.zeros((), dtype=torch.int32, device=dev)
             for _ in range(2)]
    n_adamw = len(mt.plan([p.numel() for p in ps], mt.ADAMW_LEAVES))
    assert n_adamw >= 2
    for k in range(STEPS):
        grads = [(g.float() * (1 + k)).to(g.dtype) for g in gs]
        scale = None if clip == "none" else \
            clip_scale(_plain_norm(grads), 1.0)
        if clip == "active":
            assert float(scale) < 1.0
        elif clip == "inactive":
            assert float(scale) == 1.0
        ops.reset_launch_counts()
        mt.adamw(ps, grads, ms, vs, *_corrections(steps[0]), scale, **HP)
        assert ops.launch_counts()["multi_tensor_adamw"] == n_adamw
        mt.plain_adamw(qs, grads, ns, ws, *_corrections(steps[1]), scale,
                       **HP)
        torch.cuda.synchronize()
        assert ops.launch_counts()["multi_tensor_adamw"] == n_adamw
        _assert_equal(ps, qs, f"params, step {k + 1}")
        _assert_equal(ms, ns, f"m, step {k + 1}")
        _assert_equal(vs, ws, f"v, step {k + 1}")
    assert int(steps[0]) == int(steps[1]) == STEPS


@pytest.mark.gpu
def test_fused_optimizer_step_equals_the_per_leaf_optimizer_step():
    """``adamw().update`` on the card (the kernels: the norm, then the
    clipped update) against the plain per-leaf update of copies given the
    kernels' scale: parameters, moments and the step bit for bit over 3
    steps, with the launches of one norm and one update a step."""
    dev = _card()
    ps, gs, _, _ = _card_tree(dev, 1, 10.0)
    opt = adamw(**HP)
    params = {f"l{i}": p.clone() for i, p in enumerate(ps)}
    state = opt.init(params)
    qs = _clone(ps)
    ns = [torch.zeros_like(m) for m in state["m"].values()]
    ws = [torch.zeros_like(v) for v in state["v"].values()]
    step = torch.zeros((), dtype=torch.int32, device=dev)
    numels = [g.numel() for g in gs]
    want = {"multi_tensor_sumsq": len(mt.plan(numels, mt.SUMSQ_LEAVES)) + 1,
            "multi_tensor_adamw": len(mt.plan(numels, mt.ADAMW_LEAVES))}
    for k in range(STEPS):
        grads = [(g.float() * (1 + k)).to(g.dtype) for g in gs]
        ops.reset_launch_counts()
        opt.update({f"l{i}": g for i, g in enumerate(grads)}, state,
                   params)
        got = ops.launch_counts()
        assert {n: got[n] for n in want} == want
        scale = clip_scale(mt.norm(grads), 1.0)
        assert float(scale) < 1.0
        mt.plain_adamw(qs, grads, ns, ws, *_corrections(step), scale, **HP)
        torch.cuda.synchronize()
        _assert_equal(list(params.values()), qs, f"params, step {k + 1}")
        _assert_equal(list(state["m"].values()), ns, f"m, step {k + 1}")
        _assert_equal(list(state["v"].values()), ws, f"v, step {k + 1}")
    assert int(state["step"]) == int(step) == STEPS


@pytest.mark.gpu
def test_update_replayed_in_a_cuda_graph_equals_the_per_leaf_path():
    """The optimizer's update (norm, clip and update kernels) captured once
    and replayed 3 times on new gradients copied into its buffers: each
    replay reads that step's bias corrections and scale, and equals the
    per-leaf path given the same scale (the kernels' norm) bit for bit."""
    from repro_torch.kernels import backend
    dev = _card()
    ps, gs, ms, vs = _card_tree(dev, 2, 10.0)
    backend.library(backend.MODEL_SOURCE)
    opt = adamw(**HP)
    params = {f"l{i}": p.clone() for i, p in enumerate(ps)}
    state = opt.init(params)
    for i in range(len(ps)):
        state["m"][f"l{i}"].copy_(ms[i])
        state["v"][f"l{i}"].copy_(vs[i])
    static = {f"l{i}": torch.zeros_like(g) for i, g in enumerate(gs)}
    qs, ns, ws = _clone(ps), _clone(ms), _clone(vs)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.update(static, state, params)
    assert int(state["step"]) == 0              # the capture ran nothing
    for k in range(STEPS):
        grads = [(g.float() * (1 + k)).to(g.dtype) for g in gs]
        for i, g in enumerate(grads):
            static[f"l{i}"].copy_(g)
        graph.replay()
        scale = clip_scale(mt.norm(grads), 1.0)
        assert float(scale) < 1.0
        mt.plain_adamw(qs, grads, ns, ws, *_corrections(step), scale, **HP)
        torch.cuda.synchronize()
        assert int(state["step"]) == k + 1
        _assert_equal(list(params.values()), qs, f"params, replay {k + 1}")
        _assert_equal(list(state["m"].values()), ns, f"m, replay {k + 1}")
        _assert_equal(list(state["v"].values()), ws, f"v, replay {k + 1}")


@pytest.mark.gpu
def test_norm_kernel_is_within_1e6_and_the_same_bits_every_run():
    dev = _card()
    _, gs, _, _ = _card_tree(dev, 3, 1.0)
    packs = mt.plan([g.numel() for g in gs], mt.SUMSQ_LEAVES)
    assert len(packs) >= 2
    ops.reset_launch_counts()
    a, b = mt.norm(gs), mt.norm(gs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["multi_tensor_sumsq"] == 2 * (len(packs) + 1)
    assert a.dtype == torch.float32 and a.shape == ()
    assert torch.equal(a, b)
    want = _plain_norm(gs).double()
    assert abs(float(a) - float(want)) <= 1e-6 * float(want)
    # and each leaf alone, the unaligned one and the one-element ones too
    for g in gs[-1:] + gs[:4]:
        want = _plain_norm([g]).double()
        assert abs(float(mt.norm([g])) - float(want)) <= 1e-6 * float(want)


@pytest.mark.gpu
def test_cost_counter_on_the_card_counts_what_it_counts_on_meta():
    """The dry-run's counter (``launch/op_cost.py``) on the card: the
    kernels launch, and the flops, bytes and units are meta's."""
    dev = _card()
    _, card = _counted_update(dev.type, 1.0)
    launches = ops.launch_counts()
    assert launches["multi_tensor_adamw"] == 1
    assert launches["multi_tensor_sumsq"] == 2 * 2    # a pack and the sum
    _, meta = _counted_update("meta", 1.0)
    assert card == meta and card[0] > 0


@pytest.mark.gpu
def test_the_card_wrappers_raise_for_what_the_kernels_do_not_take():
    dev = _card()
    g = torch.zeros(8, 8, device=dev)
    ops.reset_launch_counts()
    with pytest.raises(ValueError):
        mt.sumsq([g.t()])
    with pytest.raises(TypeError):
        mt.sumsq([g.double()])
    with pytest.raises(ValueError):
        mt.sumsq([g, torch.zeros(3)])
    one = torch.ones((), device=dev)
    with pytest.raises(ValueError):            # moments not float32
        mt.adamw([g], [g], [g.bfloat16()], [g], one, one, lr=1e-3, b1=.9,
                 b2=.95, eps=1e-8, weight_decay=0.)
    assert all(v == 0 for k, v in ops.launch_counts().items()
               if k.startswith("multi_tensor"))
