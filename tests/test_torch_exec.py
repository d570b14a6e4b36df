"""Layer tier of the port vs the JAX package's interpret-mode Pallas
kernels: the same numpy inputs through ``repro.lower.execute_plan(...,
interpret=True)`` and ``repro_torch.lower.execute_plan(..., device="cpu")``
(the plain PyTorch versions, which walk the plan's grid in order).  Both
sides are float32 and differ only in summation order, hence max rel error
<= 1e-5.  Schemes cross from the reference through ``LayerScheme`` JSON."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.solver.intralayer import Constraints, solve_intra_layer
from repro.lower import execute_plan, lower_scheme, make_inputs
from repro.lower.calibrate import default_hw, scheme_variants
from repro.workloads.layers import attention, conv, eltwise, fc, pool
from repro_torch.core.directives import LayerScheme as TLayerScheme
from repro_torch.core.solver.intralayer import Constraints as TConstraints
from repro_torch.core.solver.intralayer import \
    solve_intra_layer as t_solve_intra_layer
from repro_torch.hw.presets import eyeriss_multinode as t_eyeriss
from repro_torch.lower import exec as tex
from repro_torch.lower import from_reference_inputs
from repro_torch.lower import lower_scheme as t_lower_scheme
from repro_torch.workloads.layers import attention as t_attention

HW = default_hw()
T_HW = t_eyeriss(nodes=4, pe=8)
TOL = 1e-5

# tests/test_lowering.py SWEEP, the kinds of the network tier (attention
# below)
SWEEP = [
    fc("t.fc.s", 32, 64, 64),
    fc("t.fc.m", 64, 512, 512),
    conv("t.conv.s", 2, 16, 32, 14, 14, 3, 3),
    conv("t.conv.m", 2, 64, 64, 28, 28, 3, 3),
    conv("t.conv.str2", 2, 32, 64, 28, 28, 3, 3, stride=2),
    pool("t.pool.s", 2, 16, 13, 13, 3, 3),
    pool("t.pool.str", 1, 96, 27, 27, 3, 3, stride=2),
    eltwise("t.elt.s", 2, 64, 14, 14),
    eltwise("t.elt.flat", 8, 512, 1, 1),
]


def _best_scheme(layer):
    scheme, cost = solve_intra_layer(layer, HW,
                                     Constraints(nodes=HW.node_array))
    assert scheme is not None and cost.valid
    return scheme


def _check_parity(scheme):
    """Lower ``scheme`` in both packages, run both on the reference's
    inputs, return (port plan, rel error)."""
    plan = lower_scheme(scheme, HW)
    tplan = t_lower_scheme(TLayerScheme.from_json(scheme.to_json()), T_HW)
    assert plan.valid and tplan.valid, (plan.reason, tplan.reason)
    assert tplan.grid_shape == plan.grid_shape
    assert [a.dim for a in tplan.grid] == [a.dim for a in plan.grid]
    assert tplan.block == plan.block
    inputs = {k: np.asarray(v) for k, v in make_inputs(plan).items()}
    want = np.asarray(execute_plan(plan, inputs, interpret=True))
    out = tex.execute_plan(tplan, from_reference_inputs(inputs, tplan,
                                                        device="cpu"),
                           device="cpu")
    assert out.device.type == "cpu" and tuple(out.shape) == want.shape
    return tplan, tex.rel_error(out, want)


@pytest.mark.parametrize("layer", SWEEP, ids=lambda l: l.name)
def test_plan_matches_interpret_mode(layer):
    tplan, err = _check_parity(_best_scheme(layer))
    assert err <= TOL, f"{tplan.describe()}: rel err {err:.2e}"
    ok, oracle_err = tex.verify_plan(tplan, device="cpu")
    assert ok, f"{tplan.describe()}: vs oracle {oracle_err:.2e}"


def test_loop_order_variants_match_interpret_mode():
    layer = fc("t.fc.orders", 128, 1024, 1024)   # DRAM-splits both C and K
    grids = set()
    for scheme in scheme_variants(layer, HW, n_variants=3):
        tplan, err = _check_parity(scheme)
        grids.add(tuple(a.dim for a in tplan.grid))
        assert err <= TOL, f"{tplan.describe()}: rel err {err:.2e}"
    assert len(grids) >= 2, "variants should produce distinct grid orders"


@pytest.mark.parametrize("layer", [
    fc("t.fc.cout", 128, 1024, 1024),
    conv("t.conv.cout", 2, 64, 64, 28, 28, 3, 3),
], ids=lambda l: l.name)
def test_reduction_axis_outermost(layer):
    # the order compiled Pallas refuses; the port loops C inside the block
    scheme = _best_scheme(layer)
    top = scheme.levels[-1]
    if top.tf("C") == 1:                 # move a factor of C to DRAM
        inner = next(lv for lv in scheme.levels[-2::-1] if lv.tf("C") % 2 == 0)
        inner.t["C"] = inner.tf("C") // 2
        top.t["C"] = 2
        assert scheme.validate_factors()
    top.order = ("C", "K", "N", "X", "Y")
    tplan, err = _check_parity(scheme)
    assert tplan.grid[0].dim == "C" and len(tplan.grid) > 1, \
        tplan.describe()
    assert err <= TOL, f"{tplan.describe()}: rel err {err:.2e}"


def test_reference_inputs_are_checked():
    plan = lower_scheme(_best_scheme(SWEEP[0]), HW)
    tplan = t_lower_scheme(TLayerScheme.from_json(
        _best_scheme(SWEEP[0]).to_json()), T_HW)
    inputs = {k: np.asarray(v) for k, v in make_inputs(plan).items()}
    with pytest.raises(ValueError, match="shape"):
        from_reference_inputs({**inputs, "I": inputs["I"][:1]}, tplan,
                              device="cpu")
    with pytest.raises(ValueError, match="missing"):
        from_reference_inputs({"I": inputs["I"]}, tplan, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        from_reference_inputs({**inputs, "W": inputs["W"].astype(np.float64)},
                              tplan, device="cpu")


# attention cases: tests/test_lowering.py's SWEEP layers, a plan with C
# outermost (grid C:2 x N:2 x X:8 on the 4x4 template), and the same scheme
# with C forced between N and X
ATTENTION = [
    ("t.attn.s", attention("t.attn.s", 2, 2, 128, 64), None),
    ("t.attn.m", attention("t.attn.m", 2, 4, 256, 64), None),
    ("t.c1", attention("t.c1", 1, 2, 2048, 64), None),
    ("t.c1.cmid", attention("t.c1", 1, 2, 2048, 64),
     ("N", "C", "X", "K", "Y")),
]


@pytest.mark.parametrize("name,layer,order", ATTENTION,
                         ids=[a[0] for a in ATTENTION])
def test_attention_matches_interpret_mode(name, layer, order):
    scheme = _best_scheme(layer)
    if order:
        scheme.levels[-1].order = order
    tplan, err = _check_parity(scheme)
    assert err <= TOL, f"{tplan.describe()}: rel err {err:.2e}"
    dims = [a.dim for a in tplan.grid]
    if name == "t.c1":
        assert dims == ["C", "N", "X"], tplan.describe()
    if order:
        assert dims == ["N", "C", "X"], tplan.describe()
    ok, oracle_err = tex.verify_plan(tplan, device="cpu")
    assert ok, f"{tplan.describe()}: vs oracle {oracle_err:.2e}"


def _port_plan(layer, **hw_args):
    hw = t_eyeriss(**hw_args)
    scheme, cost = t_solve_intra_layer(layer, hw,
                                       TConstraints(nodes=hw.node_array))
    plan = t_lower_scheme(scheme, hw)
    assert plan.valid, plan.reason
    return plan


@pytest.mark.parametrize("layer,hw_args,grid", [
    (t_attention("zamba2.attn", 8, 32, 512, 64), {}, (8, 256)),
    (t_attention("zamba2.attn", 8, 32, 512, 64), {"nodes": 4, "pe": 8},
     (8, 256)),
    (t_attention("long4k", 1, 8, 4096, 64), {"nodes": 4, "pe": 8}, (64, 8)),
], ids=["zamba2-16x16", "zamba2-4x4", "long4k-4x4"])
def test_attention_launch_geometry(layer, hw_args, grid):
    plan = _port_plan(layer, **hw_args)
    N, X, C, D, bx, bc, sub_x, gx, gy, smem, mma = tex.attention_launch(plan)
    assert (N, X, C, D) == (layer.dim("N"), layer.dim("X"), layer.dim("C"),
                            layer.dim("K"))
    assert (bx, bc) == (plan.block["X"], plan.block["C"])
    assert (gx, gy) == grid
    assert sub_x * tex.ATTN_TILE >= bx > (sub_x - 1) * tex.ATTN_TILE
    assert gx == (X // bx) * sub_x          # every query row in one block
    # D = 64 takes the tensor-core path: Q and two stages of K and V tiles
    assert mma == 1 and tex.ATTN_PATHS[D] == "mma-3xtf32"
    assert smem == 4 * 5 * tex.ATTN_TILE * (D + 4) <= 227 * 1024


def _hand_attention_plan(D, X=100, C=200):
    """An attention plan at head dim D: C outermost, ragged tiles."""
    from repro_torch.lower.plan import GridAxis, KernelPlan
    return KernelPlan(layer=t_attention("t.attn.hand", 1, 3, X, D, seq_kv=C),
                      scheme=None, kind="attention",
                      grid=(GridAxis("C", 2), GridAxis("N", 3),
                            GridAxis("X", 2)),
                      block={"N": 1, "X": X // 2, "C": C // 2, "K": D},
                      valid=True)


def test_attention_launch_refuses_other_head_dims():
    """Head dims above the largest instantiated one (256) are refused;
    every other runs (``test_attention_launch_pads_head_dims``)."""
    with pytest.raises(ValueError, match="head dim 320"):
        tex.attention_launch(_hand_attention_plan(320))
    with pytest.raises(ValueError, match="head dim 320"):
        tex.attention_head_dim(320)
    assert tex.attention_launch(_port_plan(
        t_attention("t.d32", 1, 2, 128, 32), nodes=4, pe=8))[3] == 32


@pytest.mark.parametrize("D,Dk", [(48, 64), (200, 256), (80, 128),
                                  (1, 16), (256, 256)])
def test_attention_launch_pads_head_dims(D, Dk):
    """A head dim outside ``ATTN_HEAD_DIMS`` runs at the next instantiated
    one: its path, shared memory and grid, the plan's own blocks."""
    plan = _hand_attention_plan(D)
    if D == 48:                 # the solver's plan too
        plan = _port_plan(t_attention("t.d48", 1, 2, 128, 48), nodes=4,
                          pe=8)
    N, X, C, Dl, bx, bc, sub_x, gx, gy, smem, mma = \
        tex.attention_launch(plan)
    L, b = plan.layer, plan.block
    assert tex.attention_head_dim(D) == Dl == Dk
    assert (N, X, C) == (L.dim("N"), L.dim("X"), L.dim("C"))
    assert (bx, bc) == (b["X"], b["C"]) and b["K"] == D
    assert (gx, gy) == ((X // bx) * sub_x, N)
    assert mma == int(tex.ATTN_PATHS[Dk] == "mma-3xtf32")
    rows = 5 * tex.ATTN_TILE if mma else 3 * tex.ATTN_TILE
    assert smem == 4 * rows * (Dk + 4) <= tex.CONV_SMEM_MAX


@pytest.mark.parametrize("D", [48, 200])
def test_attention_zero_padding_keeps_the_function(D):
    """What the wrapper hands the kernel at a padded head dim: Q, K and V
    zero-padded to ``attention_head_dim(D)``, the scale of D, the output
    sliced back; against plain_attention at D (float32, 1e-6)."""
    plan = _hand_attention_plan(D)
    inputs = tex.make_inputs(plan, seed=3, device="cpu")
    Dk = tex.attention_head_dim(D)
    q, k, v = (torch.nn.functional.pad(inputs[n], (0, Dk - D))
               for n in ("Q", "K", "V"))
    s = torch.einsum("nqd,nkd->nqk", q, k) * D ** -0.5
    got = (torch.softmax(s, dim=-1) @ v)[..., :D]
    want = tex.plain_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    assert tex.rel_error(got, want) <= 1e-6
    assert tex.rel_error(tex.run_attention(plan, inputs["Q"], inputs["K"],
                                           inputs["V"]), want) <= 1e-6


def test_attention_wrapper_checks_its_inputs():
    plan = _port_plan(t_attention("t.attn.s", 2, 2, 128, 64), nodes=4, pe=8)
    assert tex.input_shapes(plan) == {"Q": (4, 128, 64), "K": (4, 128, 64),
                                      "V": (4, 128, 64)}
    inputs = tex.make_inputs(plan, device="cpu")
    q, k, v = inputs["Q"], inputs["K"], inputs["V"]
    assert all(t.dtype == torch.float32 for t in (q, k, v))
    with pytest.raises(ValueError, match="shape"):
        tex.run_attention(plan, q[:, :64], k, v)
    with pytest.raises(ValueError, match="shape"):
        tex.run_attention(plan, q, k, v[:, :, :32])
    with pytest.raises(TypeError, match="float32"):
        tex.run_attention(plan, q, k.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        tex.run_attention(plan, q, k.transpose(1, 2).contiguous()
                          .transpose(1, 2), v)
    out = tex.run_attention(plan, q, k, v)
    assert out.shape == (4, 128, 64) and out.dtype == torch.float32
    want = tex.reference_output(plan, inputs)
    assert tex.rel_error(out, want) <= TOL


# ---------------------------------------------------------------------------
# fc launch geometry (the CUDA kernel's C split, computed in Python)
# ---------------------------------------------------------------------------

#: the workspace cap the C split must respect: 64 MiB
FC_CAP = 64 << 20


def _hand_fc_plan(N, C, K, block, grid):
    """An fc plan with the given block and grid order (outer -> inner)."""
    from repro_torch.lower.plan import GridAxis, KernelPlan
    from repro_torch.workloads.layers import fc as t_fc
    return KernelPlan(layer=t_fc("t.fc.hand", N, C, K), scheme=None,
                      kind="fc", grid=tuple(GridAxis(d, s) for d, s in grid),
                      block=block, valid=True)


def _fc_plans(source):
    """Every fc plan of ``source``, lowered by the port."""
    from repro_torch.core.solver import solve
    from repro_torch.lower import calibrate as tcal
    from repro_torch.lower import lower_network
    from repro_torch.workloads.layers import fc as t_fc
    from repro_torch.workloads.nets import get_net
    if source in ("resnet-16x16", "alexnet-16x16", "alexnet-4x4"):
        net_name, tmpl = source.split("-")
        hw = t_eyeriss() if tmpl == "16x16" else t_eyeriss(nodes=4, pe=8)
        net = get_net(net_name, batch=64)
        nplan = lower_network(solve(net, hw), net, hw)
        return [nplan.plans[n] for n in nplan.order
                if nplan.plans[n].kind == "fc"]
    if source == "calibration":
        hw = tcal.default_hw()
        plans = [t_lower_scheme(s, hw) for layer in tcal.default_sweep(False)
                 if layer.kind == "fc"
                 for s in tcal.scheme_variants(layer, hw, 3)]
        for net in tcal.default_network_sweep(False):
            nplan = lower_network(solve(net, hw), net, hw)
            plans += [nplan.plans[n] for n in nplan.order
                      if nplan.plans[n].kind == "fc"]
        return plans
    if source == "file":
        layers = [t_fc(l.name, l.dim("N"), l.dim("C"), l.dim("K"))
                  for l in SWEEP if l.kind == "fc"]
        plans = [_port_plan(l, nodes=4, pe=8) for l in layers]
        for order in (("C", "K", "N", "X", "Y"), ("K", "C", "N", "X", "Y")):
            scheme, _ = t_solve_intra_layer(
                t_fc("t.fc.cout", 128, 1024, 1024), T_HW,
                TConstraints(nodes=T_HW.node_array))
            scheme.levels[-1].order = order
            plans.append(t_lower_scheme(scheme, T_HW))
        return plans
    assert source == "hand"
    return [_hand_fc_plan(64, 2048, 1000, {"N": 64, "C": 2048, "K": 200},
                          [("K", 5)]),
            _hand_fc_plan(64, 300, 400, {"N": 64, "C": 100, "K": 200},
                          [("C", 3), ("K", 2)]),
            _hand_fc_plan(128, 216, 256, {"N": 64, "C": 72, "K": 128},
                          [("N", 2), ("C", 3), ("K", 2)]),
            _hand_fc_plan(4, 500, 10, {"N": 4, "C": 100, "K": 10},
                          [("C", 5)]),
            _hand_fc_plan(200, 90, 60, {"N": 200, "C": 30, "K": 12},
                          [("C", 3), ("K", 5)])]


FC_SOURCES = ["resnet-16x16", "alexnet-16x16", "alexnet-4x4", "calibration",
              "file", "hand"]


def _covers_once(pieces, lo, hi):
    """``pieces`` of (start, end) tile [lo, hi) exactly, in any order."""
    pieces = sorted(pieces)
    return (pieces[0][0] == lo and pieces[-1][1] == hi
            and all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
            and all(s < e for s, e in pieces))


def _check_fc_launch(plan, launch, cap):
    L, b = plan.layer, plan.block
    N, C, K = L.dim("N"), L.dim("C"), L.dim("K")
    # output sub-tiles: widths multiples of 8, each plan tile covered once
    for axis, dim, tile, sub, grid_axis in (
            ("N", N, launch.tn, launch.sub_n, 1),
            ("K", K, launch.tk, launch.sub_k, 0)):
        block = b[axis]
        assert tile % 8 == 0 and 8 <= tile <= tex.FC_TILE
        if any(block % w == 0 for w in range(8, tex.FC_TILE + 1, 8)):
            assert block % tile == 0, (axis, block, tile)   # even division
        assert launch.grid[grid_axis] == (dim // block) * sub
        for t in range(dim // block):
            pieces = [launch.sub_tile(axis, g)
                      for g in range(t * sub, (t + 1) * sub)]
            assert _covers_once([(s, s + e) for s, e in pieces],
                                t * block, (t + 1) * block), (axis, pieces)
    # C: parts partition every C tile in whole slabs, never straddling one
    by_tile = {}
    for part in range(launch.n_parts):
        for t, c0, c1 in launch.part_range(part):
            assert t * b["C"] <= c0 < c1 <= (t + 1) * b["C"]
            assert (c0 - t * b["C"]) % tex.FC_SLAB == 0
            by_tile.setdefault(t, []).append((c0, c1))
    assert sorted(by_tile) == list(range(C // b["C"]))
    for t, pieces in by_tile.items():
        assert _covers_once(pieces, t * b["C"], (t + 1) * b["C"])
    # grid size and workspace
    assert launch.grid[2] == launch.n_parts
    out_blocks = launch.grid[0] * launch.grid[1]
    if launch.slices > 1:       # split only as far as the target
        assert out_blocks * launch.n_parts <= tex.FC_TARGET_BLOCKS
    if launch.group == 1 and launch.slices < launch.slabs \
            and launch.c_tiles * (launch.slices + 1) * 4 * N * K <= cap:
        # one more slice a tile would pass the target
        assert out_blocks * launch.c_tiles * (launch.slices + 1) > \
            tex.FC_TARGET_BLOCKS
    assert launch.n_parts <= launch.c_tiles * launch.slabs
    assert launch.workspace_bytes == (4 * launch.n_parts * N * K
                                      if launch.n_parts > 1 else 0)
    assert launch.workspace_bytes <= cap
    assert len(launch.params(launch.vec)) == 19


@pytest.mark.parametrize("source", FC_SOURCES)
def test_fc_launch_geometry(source):
    plans = _fc_plans(source)
    assert plans and all(p.valid and p.kind == "fc" for p in plans)
    if source == "file":        # C outermost and in the middle
        assert any(p.grid and p.grid[0].dim == "C" for p in plans)
    for plan in plans:
        _check_fc_launch(plan, tex.fc_launch(plan), FC_CAP)
    assert tex.FC_WORKSPACE_CAP == FC_CAP


def test_fc_launch_geometry_of_the_resnet_plan():
    (plan,) = _fc_plans("resnet-16x16")
    launch = tex.fc_launch(plan)
    assert (plan.block["N"], plan.block["C"], plan.block["K"]) == \
        (64, 2048, 200)
    assert (launch.tk, launch.sub_k) == (40, 5)     # no 8-wide remainder
    assert launch.grid == (25, 1, 10) and launch.n_parts == 10
    assert launch.workspace_bytes == 4 * 10 * 64 * 1000


def _emulate_fc(plan, launch, x, w):
    """The kernel's partition and order in torch, per plan output tile:
    each part's partial product (a slice of a C tile, or its tiles in
    order), then per C tile the sum of its slices, the C tiles added in
    plan order."""
    b = plan.block
    out = torch.empty((x.shape[0], w.shape[1]))
    for n0 in range(0, x.shape[0], b["N"]):
        for k0 in range(0, w.shape[1], b["K"]):
            xs, ws = x[n0:n0 + b["N"]], w[:, k0:k0 + b["K"]]
            parts = []
            for part in range(launch.n_parts):
                acc = torch.zeros((xs.shape[0], ws.shape[1]))
                for _, c0, c1 in launch.part_range(part):
                    acc = acc + xs[:, c0:c1] @ ws[c0:c1]
                parts.append(acc)
            if launch.group > 1:        # one part wrote the output
                (tile_out,) = parts
            else:
                tile_out = torch.zeros_like(parts[0])
                for t in range(launch.c_tiles):
                    tile = torch.zeros_like(tile_out)
                    for j in range(launch.slices):
                        tile = tile + parts[t * launch.slices + j]
                    tile_out = tile_out + tile
            out[n0:n0 + b["N"], k0:k0 + b["K"]] = tile_out
    return out


@pytest.mark.parametrize("source,cap", [(s, FC_CAP) for s in FC_SOURCES]
                         + [("hand", 100_000), ("alexnet-4x4", 8 << 20)])
def test_fc_split_emulation_matches_plain(source, cap, monkeypatch):
    """Summing the slices of each C tile and adding the C tiles in plan
    order computes plain_fc's function (float32, 1e-6); a small cap forces
    one part that walks every C tile."""
    monkeypatch.setattr(tex, "FC_WORKSPACE_CAP", cap)
    grouped = False
    for plan in _fc_plans(source):
        launch = tex.fc_launch(plan)
        _check_fc_launch(plan, launch, cap)
        grouped |= launch.group > 1
        if launch.group > 1:
            assert (launch.group, launch.n_parts, launch.workspace_bytes) \
                == (launch.c_tiles, 1, 0)
        inputs = tex.make_inputs(plan, seed=1, device="cpu")
        x, w = inputs["I"], inputs["W"]
        got = _emulate_fc(plan, launch, x, w)
        want = tex.plain_fc(plan, x, w)
        assert tex.rel_error(got, want) <= 1e-6, plan.describe()
    assert grouped == (cap != FC_CAP)


# ---------------------------------------------------------------------------
# conv launch geometry (the implicit GEMM's sub-tiles, wgmma orientation,
# TMA boxes and ring, computed in Python) and an emulation of its
# channels-last addressing
# ---------------------------------------------------------------------------

def _hand_conv_plan(N, C, K, X, Y, R, stride, block, grid):
    """A conv plan with the given block and grid order (outer -> inner)."""
    from repro_torch.lower.plan import GridAxis, KernelPlan
    from repro_torch.workloads.layers import conv as t_conv
    return KernelPlan(layer=t_conv("t.conv.hand", N, C, K, X, Y, R, R,
                                   stride=stride),
                      scheme=None, kind="conv",
                      grid=tuple(GridAxis(d, s) for d, s in grid),
                      block=block, valid=True)


#: hand-made conv plans: a 16-position tile (N=16, X=Y=1) at stride 2, a K=8
#: tile, conv1's C=3 at 7x7 stride 2 and 11x11 stride 4, a ragged X=7 tile
#: with C outermost and a ragged chunk (C tile 10), C outermost over K
CONV_HAND = {
    "m16-1x1-s2": (32, 64, 128, 2, 2, 1, 2,
                   {"N": 16, "C": 64, "K": 128, "X": 1, "Y": 1},
                   [("N", 2), ("X", 2), ("Y", 2)]),
    "k8-3x3": (8, 24, 16, 3, 3, 3, 1,
               {"N": 8, "C": 24, "K": 8, "X": 1, "Y": 1},
               [("X", 3), ("Y", 3), ("K", 2)]),
    "c3-7x7-s2": (2, 3, 16, 6, 4, 7, 2,
                  {"N": 2, "C": 3, "K": 16, "X": 3, "Y": 4}, [("X", 2)]),
    "c3-11x11-s4": (2, 3, 8, 5, 3, 11, 4,
                    {"N": 2, "C": 3, "K": 8, "X": 5, "Y": 1}, [("Y", 3)]),
    "ragged-x7-cout": (4, 20, 12, 7, 7, 3, 1,
                       {"N": 4, "C": 10, "K": 12, "X": 7, "Y": 1},
                       [("C", 2), ("Y", 7)]),
    "cout-over-k": (2, 48, 16, 4, 4, 3, 1,
                    {"N": 2, "C": 16, "K": 8, "X": 2, "Y": 4},
                    [("C", 3), ("K", 2), ("X", 2)]),
    # positions on the M side at the emulation's size: two warpgroups
    # over a ragged 3-image box, and one over a 64-position tile with a
    # 40-channel C tile (a piece of 8)
    "pos-m-ragged": (6, 16, 24, 9, 8, 3, 1,
                     {"N": 3, "C": 16, "K": 24, "X": 9, "Y": 8},
                     [("N", 2)]),
    "pos-m-c40": (1, 80, 8, 8, 8, 1, 1,
                  {"N": 1, "C": 40, "K": 8, "X": 8, "Y": 8}, [("C", 2)]),
}


def _conv_plans(source):
    """Every conv plan of ``source``, lowered by the port (or made by
    hand)."""
    from repro_torch.core.solver import solve
    from repro_torch.lower import lower_network
    from repro_torch.workloads.layers import conv as t_conv
    from repro_torch.workloads.nets import get_net
    if source in ("resnet-16x16", "alexnet-16x16", "alexnet-4x4"):
        net_name, tmpl = source.split("-")
        hw = t_eyeriss() if tmpl == "16x16" else t_eyeriss(nodes=4, pe=8)
        net = get_net(net_name, batch=64)
        nplan = lower_network(solve(net, hw), net, hw)
        return [nplan.plans[n] for n in nplan.order
                if nplan.plans[n].kind == "conv"]
    if source == "file":        # the SWEEP's convs, and C outermost
        plans = [_port_plan(t_conv(l.name, *(l.dim(d) for d in "NCKXY"),
                                   int(l.meta["R"]), int(l.meta["S"]),
                                   stride=int(l.meta["stride"])),
                            nodes=4, pe=8)
                 for l in SWEEP if l.kind == "conv"]
        scheme, _ = t_solve_intra_layer(
            t_conv("t.conv.cout", 2, 64, 64, 28, 28, 3, 3), T_HW,
            TConstraints(nodes=T_HW.node_array))
        top = scheme.levels[-1]
        if top.tf("C") == 1:
            inner = next(lv for lv in scheme.levels[-2::-1]
                         if lv.tf("C") % 2 == 0)
            inner.t["C"] = inner.tf("C") // 2
            top.t["C"] = 2
        top.order = ("C", "K", "N", "X", "Y")
        plans.append(t_lower_scheme(scheme, T_HW))
        return plans
    return [_hand_conv_plan(*CONV_HAND[source])]


CONV_SOURCES = ["resnet-16x16", "alexnet-16x16", "alexnet-4x4", "file",
                *CONV_HAND]


def _check_conv_launch(plan, launch):
    L, b = plan.layer, plan.block
    N, C, K, XO, YO = (L.dim(d) for d in "NCKXY")
    RS, st = int(L.meta["R"]) * int(L.meta["S"]), int(L.meta["stride"])
    rows = tex.CONV_ROWS * launch.cw
    # orientation: the positions on wgmma's M side from 64 a plan tile
    P = b["N"] * b["X"] * b["Y"]
    assert launch.pos_m == (P >= tex.CONV_ROWS)
    assert launch.nw in tex.CONV_WIDTHS and launch.cw in (1, 2)
    if launch.pos_m:
        assert launch.box <= rows and launch.tk <= launch.nw
        assert (launch.xrows, launch.wrows) == (rows, launch.nw)
        assert launch.cw == (2 if P >= 2 * tex.CONV_ROWS else 1)
    else:
        assert launch.box <= launch.nw < launch.box + 8 or \
            launch.nw == tex.conv_width(launch.box)
        assert launch.tk <= rows and (launch.xrows, launch.wrows) == \
            (launch.nw, rows)
    # sub-tiles cover each plan tile exactly once along every axis, and
    # none reaches into the next plan tile
    sub = launch.sub
    for axis, dim in (("N", N), ("K", K), ("X", XO), ("Y", YO)):
        for t in range(dim // b[axis]):
            pieces = [launch.sub_tile(axis, g)
                      for g in range(t * sub[axis], (t + 1) * sub[axis])]
            assert _covers_once([(s, s + e) for s, e in pieces],
                                t * b[axis], (t + 1) * b[axis]), \
                (axis, pieces)
    # a block walks sub-tiles of one plan tile; the blocks of a plan tile
    # walk each of its sub-tiles once, in groups of at most ``group``
    assert launch.grid == ((XO // b["X"]) * (YO // b["Y"]), K // b["K"],
                           (N // b["N"]) * launch.groups)
    assert launch.subs == sub["N"] * sub["K"] * sub["X"] * sub["Y"]
    assert 1 <= launch.group <= launch.subs
    assert launch.groups == tex._ceil(launch.subs, launch.group)
    if launch.grid[0] * launch.grid[1] * launch.grid[2] <= 4096:
        seen = {}
        for x, y, z in itertools.product(*(range(g) for g in launch.grid)):
            tiles = launch.block_subtiles(x, y, z)
            assert 1 <= len(tiles) <= launch.group
            plan_of = {(d, s // b[d]) for tile in tiles
                       for d, (s, _) in zip("NKXY", tile)}
            assert len(plan_of) == 4, "a block spans two plan tiles"
            for tile in tiles:
                seen[tile] = seen.get(tile, 0) + 1
        assert set(seen.values()) == {1}
        assert len(seen) == launch.subs * (N // b["N"]) * (K // b["K"]) \
            * (XO // b["X"]) * (YO // b["Y"])
    # the dims the kernel runs: the layer's, or folded for an input of at
    # most 4 channels in one C tile: 4 S channels, one tap along y
    if launch.fold:
        assert C <= 4 and b["C"] == C and launch.fold == int(L.meta["S"])
        assert (launch.C, launch.S, launch.sy, launch.YI) == \
            (4 * launch.fold, 1, 1, YO)
        C, RS = launch.C, launch.R
    else:
        assert (launch.C, launch.S, launch.sy) == (C, int(L.meta["S"]), st)
    assert launch.fold == tex.conv_folds(plan) * int(L.meta["S"])
    # steps: the C tiles in plan order; each tap's pieces start on a
    # 16-byte unit at most 3 channels before the tile and their k8 steps
    # hold every channel of the tile once, and at most 7 past it
    steps = launch.steps()
    bc = launch.bc
    assert [t for t, *_ in steps] == sorted(t for t, *_ in steps)
    for t in range(C // bc):
        for rs in range(RS):
            mine = [(c, c + 8 * ks) for tt, _, r, c, ks in steps
                    if tt == t and r == rs and ks]
            assert all(c % 4 == 0 for c, _ in mine)
            assert t * bc - 3 <= mine[0][0] <= t * bc < mine[0][1]
            assert (t + 1) * bc <= mine[-1][1] <= (t + 1) * bc + 7
            assert all(a[1] == b2[0] for a, b2 in zip(mine, mine[1:]))
    assert all(0 <= ks <= tex.CONV_PIECE // 8 for *_, ks in steps)
    assert len(steps) == (C // bc) * tex._ceil(launch.bcp, tex.CONV_PIECE) \
        * RS
    # TMA: 16-byte units, rows within the 128-byte swizzle, 256-element
    # boxes, strides it can traverse, 16-byte global strides
    (xb, xe), wb = launch.x_box, launch.w_box
    assert xb[0] * 4 % 16 == 0 and xb[0] * 4 <= 128
    assert wb[0] * 4 % 16 == 0 and wb[0] * 4 <= 128
    assert max(*xb, *wb) <= tex.CONV_BOX_MAX and max(xe) <= 8
    assert [xb[i] // xe[i] for i in (1, 2, 3)] == \
        [launch.ty, launch.tx, launch.tn]
    assert xe[1:3] == (launch.sy, st) and wb[3] == launch.wrows
    assert launch.cp % 4 == 0 and launch.bcp % 4 == 0
    assert launch.cp >= launch.C and launch.bcp >= launch.bc + (
        3 if launch.bc % 4 else 0)
    # the ring and the shared-memory limit
    assert 2 <= launch.stages <= tex.CONV_STAGES
    assert launch.stage_bytes % 1024 == 0
    assert launch.smem <= tex.CONV_SMEM_MAX <= 227 * 1024
    assert launch.grid[0] < 2 ** 31 and max(launch.grid[1:]) <= 65535
    assert launch.vec == (K % 2 == 0 and b["K"] % 2 == 0
                          and launch.tk % 2 == 0)
    assert len(launch.params()) == 40


@pytest.mark.parametrize("source", CONV_SOURCES)
def test_conv_launch_geometry(source):
    plans = _conv_plans(source)
    assert plans and all(p.valid and p.kind == "conv" for p in plans)
    for plan in plans:
        XI, YI = tex.input_extent(plan.layer)
        launch = tex.conv_launch(plan, XI, YI)
        _check_conv_launch(plan, launch)
        if source in ("resnet-16x16", "alexnet-16x16", "alexnet-4x4"):
            # the solver's tiles fill at least 3/4 of the M side's rows
            m_rows = launch.box if launch.pos_m else launch.tk
            assert m_rows * 4 >= 3 * tex.CONV_ROWS * launch.cw \
                or launch.box == plan.block["N"] * plan.block["X"] \
                * plan.block["Y"], plan.describe()


def test_conv_orientation_of_the_resnet_plans():
    """ResNet-50's four plans with tiles under 64 positions put their
    output channels on wgmma's M side; every other plan its positions."""
    by_name = {p.layer.name: p for p in _conv_plans("resnet-16x16")}
    assert len(by_name) == 53
    chans_m = {n for n, p in by_name.items()
               if not tex.conv_launch(p, *tex.input_extent(p.layer)).pos_m}
    assert chans_m == {"r4a.a", "r4a.p", "r5a.a", "r5a.p"}
    for name in sorted(chans_m):
        plan = by_name[name]
        launch = tex.conv_launch(plan, *tex.input_extent(plan.layer))
        P = plan.block["N"] * plan.block["X"] * plan.block["Y"]
        assert launch.box == P and launch.nw == P
        assert launch.tk == min(plan.block["K"], 2 * tex.CONV_ROWS)


def test_conv_launch_fits_the_narrow_plan_tiles():
    """ResNet-50's 16-position tile runs its 128 channels over two
    warpgroups and its positions 16 wide; AlexNet's K = 8 tile on the 4x4
    template one warpgroup of 64 positions by an 8-wide wgmma; C outermost
    keeps the plan's C tiles as steps."""
    by_name = {p.layer.name: p for p in _conv_plans("resnet-16x16")}
    plan = by_name["r5a.p"]
    launch = tex.conv_launch(plan, *tex.input_extent(plan.layer))
    assert (plan.block["N"], plan.block["X"], plan.block["Y"]) == (16, 1, 1)
    assert (launch.pos_m, launch.cw, launch.nw, launch.tk) == \
        (False, 2, 16, 128)
    by_name = {p.layer.name: p for p in _conv_plans("alexnet-4x4")}
    plan = by_name["conv5"]
    launch = tex.conv_launch(plan, *tex.input_extent(plan.layer))
    assert plan.block["K"] == 8
    assert (launch.pos_m, launch.cw, launch.nw, launch.tk, launch.box) == \
        (True, 1, 8, 8, 64)
    plan = by_name["conv2"]
    assert plan.grid[0].dim == "C"
    launch = tex.conv_launch(plan, *tex.input_extent(plan.layer))
    assert len(launch.steps()) == (plan.layer.dim("C") // plan.block["C"]) \
        * tex._ceil(plan.block["C"], tex.CONV_PIECE) * 25
    # conv1: the images folded, 7 taps of 28 channels (3 of every 4 real)
    plan = _conv_plans("resnet-16x16")[0]
    launch = tex.conv_launch(plan, *tex.input_extent(plan.layer))
    assert plan.layer.name == "conv1" and launch.fold == 7
    assert [ks for *_, ks in launch.steps()] == [4] * 7


def _tma_box(t, start, box, estr):
    """TMA's tiled load of ``t`` (dims outermost first): the box at
    ``start`` (innermost first), ``box[i] // estr[i]`` elements along dim
    i, zeros outside the tensor."""
    idx = []
    for d, (s0, b, e) in enumerate(zip(start, box, estr)):
        size = t.shape[t.dim() - 1 - d]
        i = torch.arange(s0, s0 + b, e)
        idx.append((i, (i >= 0) & (i < size)))
    out = torch.zeros([len(i) for i, _ in reversed(idx)])
    ok = [v for _, v in reversed(idx)]
    src = t
    for d, (i, v) in enumerate(reversed(idx)):
        src = src.index_select(d, i.clamp(0, t.shape[d] - 1))
    mask = ok[0].view(-1, 1, 1, 1) & ok[1].view(1, -1, 1, 1) \
        & ok[2].view(1, 1, -1, 1) & ok[3].view(1, 1, 1, -1)
    out[mask] = src[mask]
    return out


def _split(t):
    hi = (t.view(torch.int32) & tex.TF32_MASK).view(torch.float32)
    return hi, t - hi


def _emulate_conv(launch, x, w, plan):
    """The kernel's addressing in torch: the input channels-last at pitch
    ``cp`` ([N, XI, YI, cp]) and the weights as ``conv_weight_layout``
    lays them out, each step's tiles cut by TMA boxes (zeros outside), the
    activations split into hi and lo, the three products of each k8 step
    that holds channels, each step's sum added to the output accumulator
    in order, positions and channels past the sub-tile dropped.  Every
    output element is written exactly once."""
    L = launch
    xcl = torch.zeros((L.N, L.XI, L.YI, L.cp))
    xcl[..., :L.C] = tex.conv_input(plan, x).permute(0, 2, 3, 1)
    whi, wlo = tex.conv_weight_layout(plan, w)
    (xbox, xest), wbox = L.x_box, L.w_box
    out = torch.zeros((L.N, L.XO, L.YO, L.K))
    writes = torch.zeros(out.shape, dtype=torch.int32)
    tiles = [t for b in itertools.product(*(range(g) for g in L.grid))
             for t in L.block_subtiles(*b)]
    for (n0, an), (k0, ak), (x0, ax), (y0, ay) in tiles:
        acc = torch.zeros((L.box, L.wrows))
        for t, j, rs, c0, ks in launch.steps():
            if not ks:
                continue
            r, s = divmod(rs, L.S)
            a = _tma_box(xcl, (c0, y0 * L.sy + s, x0 * L.stride + r, n0),
                         xbox, xest).reshape(L.box, -1)
            bh = _tma_box(whi, (32 * j, rs, t, k0), wbox, (1,) * 4)
            bl = _tma_box(wlo, (32 * j, rs, t, k0), wbox, (1,) * 4)
            bh, bl = bh.reshape(L.wrows, -1), bl.reshape(L.wrows, -1)
            ah, al = _split(a)
            d = torch.zeros_like(acc)
            for kk in range(0, 8 * ks, 8):
                ks = slice(kk, kk + 8)
                d += al[:, ks] @ bh[:, ks].T + ah[:, ks] @ bl[:, ks].T \
                    + ah[:, ks] @ bh[:, ks].T
            acc += d
        p = torch.arange(L.box)
        pn, px, py = p // (L.tx * L.ty), (p // L.ty) % L.tx, p % L.ty
        keep = (pn < an) & (px < ax) & (py < ay)
        pn, px, py = pn[keep], px[keep], py[keep]
        rows = acc[keep][:, :ak]
        out[n0 + pn, x0 + px, y0 + py, k0:k0 + ak] = rows
        writes[n0 + pn, x0 + px, y0 + py, k0:k0 + ak] += 1
    assert bool((writes == 1).all()), "an output element written " \
        f"{int(writes.min())}..{int(writes.max())} times"
    return out.permute(0, 3, 1, 2)


@pytest.mark.parametrize("source", ["file", *CONV_HAND])
def test_conv_kernel_emulation_matches_plain(source):
    """The kernel's sub-tiles, channels-last TMA boxes, laid-out weights,
    3xTF32 split and plan-order steps compute plain_conv's function
    (float32, 1e-5)."""
    for plan in _conv_plans(source):
        XI, YI = tex.input_extent(plan.layer)
        launch = tex.conv_launch(plan, XI, YI)
        _check_conv_launch(plan, launch)
        inputs = tex.make_inputs(plan, seed=2, device="cpu")
        got = _emulate_conv(launch, inputs["I"], inputs["W"], plan)
        want = tex.plain_conv(plan, inputs["I"], inputs["W"])
        assert tex.rel_error(got, want) <= TOL, plan.describe()


def test_conv_weight_layout():
    """``conv_weight_layout`` (the plain version of ``conv_kernel_weights``):
    C tile t's channels of every tap at [sh, sh + bc) of its row (sh = t*bc
    mod 4, where its pieces start), zeros around them, hi the leading 19
    bits, hi + lo = W exactly."""
    plan = _hand_conv_plan(*CONV_HAND["ragged-x7-cout"])
    w = tex.make_inputs(plan, seed=3, device="cpu")["W"]
    hi, lo = tex.conv_weight_layout(plan, w)
    K, C, R, S = w.shape
    bc = plan.block["C"]
    assert bc % 4 and tex.conv_bcp(bc) == 16
    assert hi.shape == (K, C // bc, R * S, 16) == lo.shape
    want = torch.zeros(hi.shape)
    for t in range(C // bc):
        sh = t * bc % 4
        want[:, t, :, sh:sh + bc] = w[:, t * bc:(t + 1) * bc].reshape(
            K, bc, R * S).transpose(1, 2)
    assert torch.equal(hi + lo, want)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= hi.abs() * 2.0 ** -10).all()


# ---------------------------------------------------------------------------
# eltwise beyond one launch's operands, and the conv batch split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_ops", [9, 12])
def test_eltwise_many_operands_bitwise_vs_interpret(n_ops):
    """More operands than one launch takes (``ELTWISE_MAX_OPS``): the port
    (the plain version here; chained launches on the card, in operand
    order) equals the reference's ``_run_eltwise`` in interpret mode bit
    for bit, and so does the chain's order replayed on the CPU."""
    from repro.lower.exec import _run_eltwise
    layer = eltwise("t.elt.many", 2, 16, 7, 7)
    scheme = _best_scheme(layer)
    plan = lower_scheme(scheme, HW)
    tplan = t_lower_scheme(TLayerScheme.from_json(scheme.to_json()), T_HW)
    rng = np.random.default_rng(n_ops)
    xs = [rng.standard_normal((2, 16, 7, 7), dtype=np.float32)
          for _ in range(n_ops)]
    want = np.asarray(_run_eltwise(plan, xs, interpret=True))
    tex.reset_launch_counts()
    got = tex.run_eltwise(tplan, [torch.from_numpy(a) for a in xs])
    assert tex.LAUNCHES["eltwise"] == 0          # CPU: the plain version
    assert np.array_equal(got.numpy(), want)
    chain = tex.eltwise_chain(n_ops)
    assert len(chain) == 2
    acc = None
    for ops in chain:
        part = [acc] if acc is not None else []
        acc = tex.plain_eltwise(tplan, part + [torch.from_numpy(xs[i])
                                               for i in ops])
    assert np.array_equal(acc.numpy(), want)


@pytest.mark.parametrize("n_ops,launches", [(1, [1]), (8, [8]), (9, [8, 1]),
                                            (12, [8, 4]), (15, [8, 7]),
                                            (16, [8, 7, 1])])
def test_eltwise_chain(n_ops, launches):
    """Each launch after the first adds up to ELTWISE_MAX_OPS - 1 operands
    to the running sum; every operand once, in order."""
    chain = tex.eltwise_chain(n_ops)
    assert [len(r) for r in chain] == launches
    assert [i for r in chain for i in r] == list(range(n_ops))
    assert all(len(r) + (k > 0) <= tex.ELTWISE_MAX_OPS
               for k, r in enumerate(chain))
    with pytest.raises(ValueError, match="operand"):
        tex.eltwise_chain(0)


#: conv plans whose input passes 2^31 elements (never allocated here):
#: (N, C, K, X, Y, R, stride), block, grid
CONV_BIG = {
    "just-over": ((130, 64, 8, 512, 512, 1, 1),
                  {"N": 2, "C": 64, "K": 8, "X": 16, "Y": 512},
                  [("N", 65), ("X", 32)]),
    "resnet-like-4096": ((4096, 256, 64, 56, 56, 3, 1),
                         {"N": 8, "C": 64, "K": 64, "X": 14, "Y": 14},
                         [("N", 512), ("C", 4), ("X", 4), ("Y", 4)]),
}


@pytest.mark.parametrize("case", sorted(CONV_BIG))
def test_conv_batch_split_past_2_31(case):
    """The batch is cut at multiples of the plan's N block so that each
    launch's input and output stay within the kernel's 32-bit offsets, as
    few launches as that allows; each part's geometry is valid."""
    (N, C, K, X, Y, R, st), block, grid = CONV_BIG[case]
    plan = _hand_conv_plan(N, C, K, X, Y, R, st, block, grid)
    XI, YI = tex.input_extent(plan.layer)
    assert N * C * XI * YI >= 2 ** 31
    parts = tex.conv_batch_parts(plan, XI, YI)
    assert len(parts) > 1
    assert _covers_once(parts, 0, N)
    per_image = max(C * XI * YI, K * X * Y)
    for n0, n1 in parts:
        assert n0 % block["N"] == 0 and (n1 - n0) % block["N"] == 0
        assert (n1 - n0) * per_image <= tex.CONV_MAX_ELEMS
        launch = tex.conv_launch(plan, XI, YI, n1 - n0)
        assert launch.N == n1 - n0
        assert launch.grid[2] == (n1 - n0) // block["N"] * launch.groups
    # one block more a part would pass the limit
    size = parts[0][1] - parts[0][0]
    assert (size + block["N"]) * per_image > tex.CONV_MAX_ELEMS
    assert len(parts) == -(-N // size)
    with pytest.raises(ValueError, match="32-bit|at most"):
        tex.conv_launch(plan, XI, YI)
    small = _hand_conv_plan(*CONV_HAND["k8-3x3"])
    assert tex.conv_batch_parts(small, *tex.input_extent(small.layer)) == \
        [(0, small.layer.dim("N"))]


def test_conv_batch_split_refuses_a_block_past_2_31():
    plan = _hand_conv_plan(64, 64, 8, 1024, 1024, 1, 1,
                           {"N": 64, "C": 64, "K": 8, "X": 16, "Y": 1024},
                           [("X", 64)])
    with pytest.raises(ValueError, match="32-bit"):
        tex.conv_batch_parts(plan, *tex.input_extent(plan.layer))
