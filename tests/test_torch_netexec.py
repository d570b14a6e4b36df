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
