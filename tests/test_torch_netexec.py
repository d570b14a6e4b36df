"""Network tier of the port vs the JAX package's interpret-mode execution:
every layer output of ``repro_torch`` on the CPU (plain PyTorch versions)
matches ``repro.lower.execute_network(..., backend="interpret")`` on the same
numpy inputs within 1e-5 max rel error (float32 both sides, only the
summation order differs); the port's own ``verify_network`` passes at 1e-3.
Schedules cross from the reference through ``NetworkSchedule`` JSON."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.solver import solve
from repro.lower import execute_network, make_network_inputs
from repro.hw.presets import eyeriss_multinode
from repro.lower.calibrate import default_hw
from repro.lower.netexec import _eltwise_operands, adapt_tensor
from repro.workloads.layers import eltwise
from repro.workloads.nets import get_net, transformer
from repro_torch.core.solver.kapla import NetworkSchedule as TSchedule
from repro_torch.hw.presets import eyeriss_multinode as t_eyeriss
from repro_torch.lower import (from_reference_inputs, lower_network,
                               network_runner, verify_network)
from repro_torch.lower import execute_network as t_execute_network
from repro_torch.lower import netexec as tnx
from repro_torch.workloads.layers import eltwise as t_eltwise

HW = default_hw()
T_HW = t_eyeriss(nodes=4, pe=8)
TOL = 1e-5


def _plans(net, hw=HW, t_hw=T_HW):
    sched = solve(net, hw)
    assert sched.valid
    nplan = sched.lower(net, hw)
    tsched = TSchedule.from_json(json.loads(json.dumps(sched.to_json())))
    tplan = lower_network(tsched, tsched.to_graph(), t_hw)
    assert tplan.executable, tplan.invalid_layers()
    assert tplan.order == nplan.order
    assert tplan.forwarded() == nplan.forwarded()
    return nplan, tplan


def _check_network(net, hw=HW, t_hw=T_HW):
    nplan, tplan = _plans(net, hw, t_hw)
    inputs = {k: np.asarray(v) for k, v in make_network_inputs(nplan).items()}
    want = execute_network(nplan, inputs, backend="interpret")
    got = t_execute_network(tplan, from_reference_inputs(inputs, tplan,
                                                         device="cpu"),
                            device="cpu")
    assert set(got.forwarded) == set(want.forwarded)
    assert set(got.roundtrips) == set(want.roundtrips)
    errors = {n: tnx.rel_error(got.outputs[n], np.asarray(want.outputs[n]))
              for n in nplan.order}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= TOL, f"{net.name}: {worst} {errors[worst]:.2e}"
    ver = verify_network(tplan, device="cpu")
    assert ver.ok, f"{net.name}: {ver.worst_layer} {ver.max_rel_err:.2e}"
    assert set(ver.errors) == set(tplan.order)
    return tplan, got


@pytest.mark.parametrize("make", [
    lambda: get_net("mlp", batch=4),
    lambda: transformer(batch=8, layers=2),
    lambda: get_net("lstm", batch=8),
], ids=["mlp", "transformer2", "lstm"])
def test_network_matches_interpret_mode(make):
    tplan, got = _check_network(make())
    assert len(got.forwarded) >= 1


def test_alexnet_matches_interpret_mode():
    # the quickstart's net and template (conv + pool + fc, 11x11/s4 conv1)
    tplan, got = _check_network(get_net("alexnet", batch=1),
                                eyeriss_multinode(), t_eyeriss())
    assert any(s.length > 1 for s in tplan.segments)
    # forwarded tensors stayed tensors on the run's device
    for n in got.forwarded:
        assert isinstance(got.outputs[n], torch.Tensor)


def test_keep_boundary_drops_forwarded_outputs():
    _, tplan = _plans(get_net("mlp", batch=4))
    inputs = tnx.make_network_inputs(tplan, device="cpu")
    ex = network_runner(tplan, inputs, device="cpu", keep="boundary")()
    assert set(ex.outputs) == set(ex.roundtrips)
    assert tnx.measure_network(tplan, inputs, device="cpu", iters=1) > 0


def test_adapt_tensor_rules_match_reference():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    y = np.ones((2, 8), np.float32)
    cases = [(x, (2, 12)),                 # rule 1: reshape
             (x, (2, 3, 4, 4)),            # rule 2: centered zero pad
             (np.pad(x, ((0, 0), (0, 0), (1, 2), (1, 2))), (2, 3, 2, 2)),
             (y, (2, 2, 1, 1))]            # rule 3: fold-sum
    for arr, shape in cases:
        got = tnx.adapt_tensor(torch.from_numpy(arr), shape)
        assert got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(adapt_tensor(jnp.asarray(arr), shape)))
    with pytest.raises(ValueError, match="cannot adapt"):
        tnx.adapt_tensor(torch.ones((2, 5)), (2, 3))


def test_eltwise_concat_embedding_matches_reference():
    a = np.ones((2, 2, 4, 4), np.float32)
    b = 2 * np.ones((2, 4, 4, 4), np.float32)
    want = _eltwise_operands([jnp.asarray(a), jnp.asarray(b)],
                             eltwise("cat", 2, 6, 4, 4, src=["a", "b"]))
    got = tnx._eltwise_operands([torch.from_numpy(a), torch.from_numpy(b)],
                                t_eltwise("cat", 2, 6, 4, 4, src=["a", "b"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    total = sum(g.numpy() for g in got)
    np.testing.assert_allclose(total[:, :2], 1.0)
    np.testing.assert_allclose(total[:, 2:], 2.0)


# ---------------------------------------------------------------------------
# the executor's activation layout: channels-last inside a call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,conversions", [("resnet", 1), ("alexnet", 2)])
def test_channels_last_executor_tiers_agree(name, conversions):
    """ResNet-50 and AlexNet through the per-layer tier and the fused tier's
    CPU path (batch 2: at batch 64 each tier's outputs would hold some 4 GB
    of host memory): every output in the reference layout (row-major [N, C,
    X, Y]), the two tiers equal bit for bit, within 1e-4 of the torch
    oracles, and the layout conversions a call are the images' (folded for
    conv1), and, in AlexNet, pool5's 6 x 6 positions flattened before fc6."""
    from repro_torch.core.solver import solve as t_solve
    from repro_torch.lower import exec as lx
    from repro_torch.workloads.nets import get_net as t_get_net
    hw = t_eyeriss()
    tnet = t_get_net(name, batch=2)
    tplan = lower_network(t_solve(tnet, hw), tnet, hw)
    inputs = tnx.make_network_inputs(tplan, seed=3, device="cpu")
    outs = []
    for fused in (False, True):
        run = network_runner(tplan, inputs, device="cpu", fused=fused)
        for _ in range(2):
            lx.reset_launch_counts()
            ex = run()
            assert lx.LAUNCHES["layout"] == conversions
            assert not any(v for k, v in lx.LAUNCHES.items()
                           if k != "layout")
        assert set(ex.outputs) == set(tplan.order)
        assert all(v.is_contiguous() for v in ex.outputs.values())
        outs.append(ex.outputs)
    for n in tplan.order:
        assert torch.equal(outs[0][n], outs[1][n]), n
    ver = tnx.compare_network(tplan, ex, inputs, tol=1e-4)
    assert ver.ok, (ver.worst_layer, ver.max_rel_err)


def test_eltwise_concat_embedding_channels_last():
    """The inception channel embedding on a hand-built two-source eltwise,
    channels-last: each source embedded at its channel offset in a tensor
    held channels-last, equal to the row-major path's operands; their sum
    is the concatenation; sources already channels-last take no
    conversion, row-major ones one each."""
    from repro_torch.lower import exec as lx
    layer = t_eltwise("cat", 2, 24, 5, 5, src=["a", "b"])
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((2, 10, 5, 5), np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 14, 5, 5), np.float32))
    want = tnx._eltwise_operands([a, b], layer)
    for srcs, conversions in (([lx.to_channels_last(a),
                                lx.to_channels_last(b)], 0), ([a, b], 2)):
        lx.reset_launch_counts()
        got = tnx._eltwise_operands(srcs, layer, channels_last=True)
        assert lx.LAUNCHES["layout"] == conversions
        assert [lx.channel_pitch(g) for g in got] == [24, 24]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(got[0] + got[1], torch.cat([a, b], dim=1))


def test_adapt_tensor_channels_last_keeps_the_reference_order():
    """The adapter's rules on a channels-last source: the flatten before an
    fc and the fold-sum read the reference's [N, C, X, Y] order (one
    conversion each), a pad or crop keeps the layout (none), and every
    result equals the row-major path's."""
    from repro_torch.lower import exec as lx
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 4), np.float32))
    xcl = lx.to_channels_last(x)
    for shape, conversions in (((2, 48), 1), ((2, 3, 6, 6), 0),
                               ((2, 3, 2, 2), 0), ((2, 12, 1, 1), 1)):
        lx.reset_launch_counts()
        got = tnx.adapt_tensor(xcl, shape, channels_last=True)
        assert lx.LAUNCHES["layout"] == conversions, shape
        assert torch.equal(got, tnx.adapt_tensor(x, shape)), shape
        if len(shape) == 4:
            assert lx.channel_pitch(got) == shape[1]
