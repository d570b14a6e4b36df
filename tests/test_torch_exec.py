"""Layer tier of the port vs the JAX package's interpret-mode Pallas
kernels: the same numpy inputs through ``repro.lower.execute_plan(...,
interpret=True)`` and ``repro_torch.lower.execute_plan(..., device="cpu")``
(the plain PyTorch versions, which walk the plan's grid in order).  Both
sides are float32 and differ only in summation order, hence max rel error
<= 1e-5.  Schemes cross from the reference through ``LayerScheme`` JSON."""
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
    N, X, C, D, bx, bc, sub_x, gx, gy, smem = tex.attention_launch(plan)
    assert (N, X, C, D) == (layer.dim("N"), layer.dim("X"), layer.dim("C"),
                            layer.dim("K"))
    assert (bx, bc) == (plan.block["X"], plan.block["C"])
    assert (gx, gy) == grid
    assert sub_x * tex.ATTN_TILE >= bx > (sub_x - 1) * tex.ATTN_TILE
    assert gx == (X // bx) * sub_x          # every query row in one block
    assert smem == 4 * 3 * tex.ATTN_TILE * (D + 4)


def test_attention_launch_refuses_other_head_dims():
    plan = _port_plan(t_attention("t.d48", 1, 2, 128, 48), nodes=4, pe=8)
    with pytest.raises(ValueError, match="head dim 48"):
        tex.attention_launch(plan)
    assert tex.attention_launch(_port_plan(
        t_attention("t.d32", 1, 2, 128, 32), nodes=4, pe=8))[3] == 32


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
