"""The port's fused tier (``repro_torch.lower.fuse``) vs the JAX package's
(``repro.lower.fuse``), on the CPU, where the same per-layer steps run
through the plain versions with no graph: every segment matches the
reference's fused segment and its interpret oracle within 1e-5, the whole
net keeps the reference's keys, ``plan_signature`` gives the reference's
digest, the cache serves equal plans with zero recaptures while each
caller's own inputs and weights are used, donation never touches weights,
and invalid plans fail naming the layer.  Schedules cross from the
reference through ``NetworkSchedule`` JSON."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.solver import solve
from repro.core.solver.intralayer import Constraints, solve_intra_layer
from repro.hw.presets import eyeriss_multinode
from repro.lower import fuse as jfuse
from repro.lower import (lower_network, lower_scheme, make_inputs,
                         make_network_inputs, network_runner)
from repro.lower.exec import plan_runner
from repro.lower.calibrate import default_hw
from repro.obs.metrics import REGISTRY as J_REGISTRY
from repro.workloads.layers import attention, conv, eltwise, fc, pool
from repro.workloads.nets import get_net, transformer
from repro_torch.core.directives import LayerScheme as TLayerScheme
from repro_torch.core.solver import solve as t_solve
from repro_torch.core.solver.kapla import NetworkSchedule as TSchedule
from repro_torch.hw.presets import eyeriss_multinode as t_eyeriss
from repro_torch.kernels import backend
from repro_torch.lower import (LAUNCHES, FusedNetwork, cache_stats,
                               clear_cache, compiled_plan_fn,
                               from_reference_inputs, fused_runner,
                               measure_network, plan_signature,
                               reset_launch_counts)
from repro_torch.lower import calibrate as tcal
from repro_torch.lower import exec as tex
from repro_torch.lower import fuse as tfuse
from repro_torch.lower import lower_network as t_lower_network
from repro_torch.lower import lower_scheme as t_lower_scheme
from repro_torch.lower import netexec as tnx
from repro_torch.lower import network_runner as t_network_runner
from repro_torch.obs.metrics import REGISTRY
from repro_torch.workloads.nets import get_net as t_get_net

HW = default_hw()
T_HW = t_eyeriss(nodes=4, pe=8)
TOL = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions issue many small ops; one intra-op thread each
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(net, hw=HW, t_hw=T_HW):
    """(reference plan, port plan) of one schedule solved by the
    reference and crossed through JSON."""
    sched = solve(net, hw)
    assert sched.valid
    nplan = lower_network(sched, net, hw)
    tsched = TSchedule.from_json(json.loads(json.dumps(sched.to_json())))
    tplan = t_lower_network(tsched, tsched.to_graph(), t_hw)
    assert tplan.executable, tplan.invalid_layers()
    assert tplan.order == nplan.order
    return nplan, tplan


def _inputs(nplan, seed=0):
    return {k: np.asarray(v)
            for k, v in make_network_inputs(nplan, seed=seed).items()}


def _oracle(nplan, inputs):
    """Layer-by-layer interpret-mode outputs of the reference."""
    ex = network_runner(nplan, inputs, jit=True, backend="interpret")()
    return {k: np.asarray(v) for k, v in ex.outputs.items()}


def _err(got, want) -> float:
    return tnx.rel_error(got, np.asarray(want))


# ---------------------------------------------------------------------------
# per-segment numerics vs the reference's fused tier and interpret oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: get_net("mlp", batch=4),
    lambda: transformer(batch=8, layers=2),
    lambda: get_net("alexnet", batch=1),
], ids=["mlp", "transformer2", "alexnet"])
def test_fused_segments_match_reference_and_oracle(make):
    net = make()
    nplan, tplan = _plans(net)
    inputs = _inputs(nplan)
    oracle = _oracle(nplan, inputs)
    jf = jfuse.fused_runner(nplan, cache=False)
    tf = fused_runner(tplan, cache=False, device=CPU)
    assert tf.segment_io == jf.segment_io
    feed_t = from_reference_inputs(inputs, tplan, device=CPU)
    for index, (consumes, produces) in enumerate(tf.segment_io):
        assert produces, f"segment {index} produces nothing"
        # feed each segment from oracle boundary values, so errors do not
        # accumulate across segments
        feed = {s: inputs[s] if s in inputs else oracle[s]
                for s in consumes}
        want = jf.run_segment(index, feed)
        got = tf.run_segment(index, {
            s: feed_t[s] if s in feed_t
            else torch.from_numpy(np.array(oracle[s]))
            for s in consumes})
        assert set(got) == set(want) == set(produces)
        for name in produces:
            assert _err(got[name], oracle[name]) <= TOL, \
                f"{net.name} segment {index} {name} vs oracle"
            assert _err(got[name], want[name]) <= TOL, \
                f"{net.name} segment {index} {name} vs reference fused"


def test_whole_network_keeps_the_reference_keys():
    nplan, tplan = _plans(get_net("mlp", batch=4))
    inputs = _inputs(nplan)
    oracle = _oracle(nplan, inputs)
    jf = jfuse.fused_runner(nplan, cache=False)
    tf = fused_runner(tplan, cache=False, device=CPU)
    feed = from_reference_inputs(inputs, tplan, device=CPU)
    for keep in ("all", "boundary"):
        want = jf(inputs, keep=keep)
        got = tf(feed, keep=keep)
        assert set(got) == set(want), keep
        for name in got:
            assert _err(got[name], oracle[name]) <= TOL, (keep, name)
    assert set(tf(feed, keep="boundary")) < set(tplan.order)
    with pytest.raises(ValueError, match="keep"):
        tf(feed, keep="some")


def test_network_runner_fused_tier():
    nplan, tplan = _plans(get_net("mlp", batch=4))
    inputs = _inputs(nplan)
    oracle = _oracle(nplan, inputs)
    feed = from_reference_inputs(inputs, tplan, device=CPU)
    ex = t_network_runner(tplan, feed, device=CPU, fused=True)()
    assert ex.tier == "fused"
    assert set(ex.forwarded) == set(tplan.forwarded())
    assert set(ex.roundtrips) == set(tplan.order) - set(tplan.forwarded())
    assert set(ex.outputs) == set(tplan.order)
    for name, val in ex.outputs.items():
        assert _err(val, oracle[name]) <= TOL, name
    per_layer = t_network_runner(tplan, feed, device=CPU)()
    assert per_layer.tier == "per-layer"
    for name in tplan.order:
        assert torch.equal(ex.outputs[name], per_layer.outputs[name]), name


def test_measure_network_measures_the_fused_tier_by_default():
    _, tplan = _plans(get_net("mlp", batch=4))
    feed = tnx.make_network_inputs(tplan, device=CPU)
    clear_cache()
    assert measure_network(tplan, feed, device=CPU, iters=1) > 0
    assert cache_stats()["misses"] == 1
    net = fused_runner(tplan, device=CPU)
    assert cache_stats()["hits"] == 1 and net.traces == 1
    assert measure_network(tplan, feed, device=CPU, iters=1,
                           fused=False) > 0
    assert cache_stats()["hits"] == 1          # the per-layer tier: no cache
    assert tnx.backend_label("cuda", fused=True) == "cuda-graph"
    assert tnx.backend_label("cuda") == "cuda"
    assert tnx.backend_label(CPU, fused=True) == "cpu"
    clear_cache()


# ---------------------------------------------------------------------------
# the plan signature and the cache
# ---------------------------------------------------------------------------

NETS = {
    "alexnet_b64": lambda: get_net("alexnet", batch=64),
    "resnet_b64": lambda: get_net("resnet", batch=64),
    "mlp_b4": lambda: get_net("mlp", batch=4),
    "transformer2_b8": lambda: transformer(batch=8, layers=2),
    "lstm_b8": lambda: get_net("lstm", batch=8),
}
HWS = {"16x16": ({}, {}), "4x4": ({"nodes": 4, "pe": 8},
                                  {"nodes": 4, "pe": 8})}


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("net", sorted(NETS))
def test_plan_signature_matches_reference(net, hw):
    ref_hw, port_hw = HWS[hw]
    nplan, tplan = _plans(NETS[net](), eyeriss_multinode(**ref_hw),
                          t_eyeriss(**port_hw))
    assert plan_signature(tplan) == jfuse.plan_signature(nplan)
    specs = tfuse.input_specs(tplan)
    assert {k: s.shape for k, s in specs.items()} == \
        {k: tuple(s.shape) for k, s in jfuse.input_specs(nplan).items()}
    assert all(s.dtype == torch.float32 for s in specs.values())


def test_cache_hits_with_zero_recapture():
    clear_cache()
    net = get_net("mlp", batch=4)
    _, tplan = _plans(net)
    hits = REGISTRY.get("fused_cache_events_total")
    h0, m0 = hits.value(event="hit"), hits.value(event="miss")

    fused = fused_runner(tplan, device=CPU)
    assert cache_stats()["misses"] == 1
    assert hits.value(event="miss") == m0 + 1
    fused(tnx.make_network_inputs(tplan, device=CPU), keep="boundary")
    traces = fused.traces
    assert traces == 1

    # a fresh lowering of the same schedule has the same signature: the
    # second execution reuses the built variant
    _, tplan2 = _plans(net)
    assert plan_signature(tplan2) == plan_signature(tplan)
    fused2 = fused_runner(tplan2, device=CPU)
    assert fused2 is fused
    assert hits.value(event="hit") == h0 + 1
    fused2(tnx.make_network_inputs(tplan2, seed=1, device=CPU),
           keep="boundary")
    assert fused2.traces == traces

    # a different plan (another batch, other shapes) is a miss
    _, other = _plans(get_net("mlp", batch=8))
    assert plan_signature(other) != plan_signature(tplan)
    assert fused_runner(other, device=CPU) is not fused
    assert cache_stats()["misses"] == 2
    clear_cache()
    assert cache_stats() == {"size": 0, "hits": 0, "misses": 0,
                             "evictions": 0}


def test_metrics_match_the_reference():
    for name in ("fused_cache_events_total", "fused_cache_size",
                 "fused_compile_seconds"):
        mine, ref = REGISTRY.get(name), J_REGISTRY.get(name)
        assert mine is not None and ref is not None, name
        assert (mine.kind, mine.help, mine.labelnames) == \
            (ref.kind, ref.help, ref.labelnames), name


def test_equal_signature_runners_each_match_their_own_oracle():
    """Two runners of one cached network with other inputs and weights
    (seeds 0 and 1), called in turn: each result is its own seed's."""
    nplan, tplan = _plans(get_net("mlp", batch=4))
    _, tplan2 = _plans(get_net("mlp", batch=4))
    clear_cache()
    runs = []
    for seed, tp in ((0, tplan), (1, tplan2)):
        inputs = _inputs(nplan, seed)
        runs.append((t_network_runner(
            tp, from_reference_inputs(inputs, tp, device=CPU), device=CPU,
            fused=True), _oracle(nplan, inputs)))
    assert cache_stats()["misses"] == 1 and cache_stats()["hits"] == 1
    last = tplan.order[-1]
    assert _err(runs[0][1][last], runs[1][1][last]) > 1e-2
    for run, oracle in runs + runs:
        ex = run()
        for name in tplan.order:
            assert _err(ex.outputs[name], oracle[name]) <= TOL, name
    assert fused_runner(tplan, device=CPU).traces == 1
    clear_cache()


def test_lru_eviction(monkeypatch):
    monkeypatch.setattr(tfuse, "_CACHE_CAP", 1)
    clear_cache()
    ev = REGISTRY.get("fused_cache_events_total")
    e0 = ev.value(event="eviction")
    _, a = _plans(get_net("mlp", batch=4))
    _, b = _plans(get_net("mlp", batch=8))
    first = fused_runner(a, device=CPU)
    feed = tnx.make_network_inputs(a, device=CPU)
    first(feed)
    fused_runner(b, device=CPU)
    assert cache_stats() == {"size": 1, "hits": 0, "misses": 2,
                             "evictions": 1}
    assert ev.value(event="eviction") == e0 + 1
    assert REGISTRY.get("fused_cache_size").value() == 1
    # an evicted network dropped its variants; a holder may still call it
    first(feed)
    assert first.traces == 2
    clear_cache()


# ---------------------------------------------------------------------------
# buffers: donation, weights, input checks, launches
# ---------------------------------------------------------------------------

def test_donated_buffers_are_safe():
    _, tplan = _plans(get_net("mlp", batch=4))
    inputs = tnx.make_network_inputs(tplan, device=CPU)
    weights = {k: v.clone() for k, v in inputs.items() if k.endswith(".W")}
    fused = fused_runner(tplan, cache=False, device=CPU)
    expect = {k: v.clone() for k, v in fused(inputs, keep="boundary").items()}
    donated = fused({k: v.clone() for k, v in inputs.items()},
                    keep="boundary", donate=True)
    for name, val in expect.items():
        assert torch.equal(donated[name], val), name
    # weights are never donated: the same resident weights serve the next
    # request, and the caller's tensors are unchanged
    again = fused({k: (v if k.endswith(".W") else v.clone())
                   for k, v in inputs.items()}, keep="boundary", donate=True)
    for name, val in expect.items():
        assert torch.equal(again[name], val), name
    for k, w in weights.items():
        assert torch.equal(inputs[k], w), k


def _write_in_place(how, t):
    """Double ``t`` in place the way ``how`` names."""
    if how == "mul_":
        t.mul_(2.0)
    elif how == "data":                 # bumps no version counter
        t.data.copy_(t.data * 2.0)
    else:                               # through a numpy view
        view = t.numpy()
        view *= 2.0


@pytest.mark.parametrize("how", ["mul_", "data", "numpy"])
def test_weights_written_in_place_are_seen(how):
    """Every call copies the weights in: a weight written in place, even
    in a way that leaves no trace on the tensor, gives its new result."""
    _, tplan = _plans(get_net("mlp", batch=4))
    inputs = tnx.make_network_inputs(tplan, device=CPU)
    fused = fused_runner(tplan, cache=False, device=CPU)
    base = {k: v.clone() for k, v in fused(inputs).items()}
    w = next(k for k in inputs if k.endswith(".W"))
    _write_in_place(how, inputs[w])
    doubled = fused(inputs)
    assert not torch.equal(doubled[tplan.order[-1]], base[tplan.order[-1]])
    want = t_network_runner(tplan, inputs, device=CPU)().outputs
    for name in tplan.order:
        assert torch.equal(doubled[name], want[name]), name


def test_cache_bounded_by_bytes(monkeypatch):
    """A network is evicted when the cached networks of its device hold
    more bytes than the bound, never the one just added; on the CPU they
    hold their buffers."""
    _, a = _plans(get_net("mlp", batch=4))
    _, b = _plans(get_net("mlp", batch=8))
    clear_cache()
    first = fused_runner(a, device=CPU)
    held = first.nbytes
    assert held == 4 * sum(int(np.prod(s)) for s in
                           tnx.network_input_shapes(a).values())
    assert tfuse._budget(torch.device(CPU)) is None
    fused_runner(b, device=CPU)
    assert cache_stats()["size"] == 2
    clear_cache()
    monkeypatch.setattr(tfuse, "_CACHE_BYTES", held)
    first = fused_runner(a, device=CPU)
    second = fused_runner(b, device=CPU)
    assert cache_stats() == {"size": 1, "hits": 0, "misses": 2,
                             "evictions": 1}
    assert fused_runner(b, device=CPU) is second
    assert fused_runner(a, device=CPU) is not first
    clear_cache()


def test_fused_network_runner_all_returns_copies():
    """``network_runner(fused=True)`` with ``keep="all"`` hands out copies
    (its outputs are its call's alone), ``keep="boundary"`` the network's
    own tensors."""
    _, tplan = _plans(get_net("mlp", batch=4))
    inputs = tnx.make_network_inputs(tplan, device=CPU)
    clear_cache()
    calls = []
    net = fused_runner(tplan, device=CPU)
    real = net._run

    def spy(key, values, names, copy=False):
        calls.append((key, copy))
        return real(key, values, names, copy)
    net._run = spy
    t_network_runner(tplan, inputs, device=CPU, fused=True)()
    t_network_runner(tplan, inputs, device=CPU, keep="boundary",
                     fused=True)()
    assert calls == [(("net", "all"), True), (("net", "boundary"), False)]
    clear_cache()


def test_inputs_are_checked():
    _, tplan = _plans(get_net("mlp", batch=4))
    inputs = tnx.make_network_inputs(tplan, device=CPU)
    fused = fused_runner(tplan, cache=False, device=CPU)
    name = next(iter(inputs))
    with pytest.raises(ValueError, match="missing input"):
        fused({k: v for k, v in inputs.items() if k != name})
    with pytest.raises(ValueError, match="shape"):
        fused({**inputs, name: inputs[name][:1]})
    with pytest.raises(TypeError, match="float32"):
        fused({**inputs, name: inputs[name].double()})
    got = fused({k: v.numpy() for k, v in inputs.items()})
    want = fused(inputs)
    assert set(got) == set(want)


def test_cpu_fused_tier_launches_no_kernel():
    _, tplan = _plans(get_net("mlp", batch=4))
    inputs = tnx.make_network_inputs(tplan, device=CPU)
    reset_launch_counts()
    fused_runner(tplan, cache=False, device=CPU)(inputs)
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


def test_recording_launches_diverts_the_count():
    reset_launch_counts()
    with backend.recording_launches() as tally:
        backend.count_launch(LAUNCHES, "conv")
        backend.count_launch(LAUNCHES, "attention_mma", 2)
    backend.count_launch(LAUNCHES, "fc")
    assert tally["conv"] == 1 and tally["attention_mma"] == 2
    assert LAUNCHES["conv"] == 0 and LAUNCHES["fc"] == 1
    reset_launch_counts()


# ---------------------------------------------------------------------------
# invalid plans, no card
# ---------------------------------------------------------------------------

def test_invalid_plan_errors_name_layer():
    net = t_get_net("mobilenet", batch=1)     # dwconv has no kernel
    hw = t_eyeriss(nodes=4, pe=8)
    nplan = t_lower_network(t_solve(net, hw), net, hw)
    assert not nplan.executable
    with pytest.raises(ValueError, match="mobilenet.*dw"):
        fused_runner(nplan, cache=False, device=CPU)
    with pytest.raises(ValueError, match="mobilenet.*dw"):
        fused_runner(nplan)
    with pytest.raises(ValueError, match="mobilenet.*dw"):
        FusedNetwork(nplan)
    with pytest.raises(ValueError, match="mobilenet.*dw"):
        t_network_runner(nplan, {}, device=CPU, fused=True)
    bad = next(p for _, p in sorted(nplan.plans.items()) if not p.valid)
    with pytest.raises(ValueError, match=bad.layer.name):
        compiled_plan_fn(bad)


def test_fused_tier_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    _, tplan = _plans(get_net("mlp", batch=4))
    feed = tnx.make_network_inputs(tplan, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_runner(tplan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedNetwork(tplan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_network_runner(tplan, feed, fused=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_network(tplan, feed)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.plan_runner(tplan.plans[tplan.order[0]], fused=True)


# ---------------------------------------------------------------------------
# the layer tier's fused step and the calibration sweep
# ---------------------------------------------------------------------------

LAYERS = [fc("t.f.fc", 32, 64, 64), conv("t.f.conv", 2, 16, 32, 14, 14, 3, 3),
          pool("t.f.pool", 2, 16, 13, 13, 3, 3, stride=2),
          eltwise("t.f.elt", 2, 64, 14, 14),
          attention("t.f.attn", 2, 4, 256, 64)]


@pytest.mark.parametrize("layer", LAYERS, ids=lambda l: l.kind)
def test_fused_plan_runner_matches_reference_compiled(layer):
    scheme, cost = solve_intra_layer(layer, HW,
                                     Constraints(nodes=HW.node_array))
    assert scheme is not None and cost.valid
    plan = lower_scheme(scheme, HW)
    tplan = t_lower_scheme(TLayerScheme.from_json(scheme.to_json()), T_HW)
    inputs = {k: np.asarray(v) for k, v in make_inputs(plan).items()}
    want = plan_runner(plan, backend="compiled")(inputs)
    feed = from_reference_inputs(inputs, tplan, device=CPU)
    got = tex.plan_runner(tplan, CPU, fused=True)(feed)
    assert _err(got, want) <= TOL
    fn, names = compiled_plan_fn(tplan)
    assert names == jfuse.compiled_plan_fn(plan)[1]
    assert torch.equal(fn(*(feed[n] for n in names)), got)


def test_fused_calibration_on_cpu(capsys, tmp_path):
    rec = tcal.run_calibration(tcal.default_hw(), layers=LAYERS[:2],
                               n_variants=1, iters=1, device=CPU,
                               fused=True)
    assert rec["backend"] == "cpu" and rec["n_pairs"] == 2
    assert all(p["rel_err"] < 1e-3 for p in rec["pairs"])
    net = tcal.run_network_calibration(nets=[t_get_net("mlp", batch=4)],
                                       device=CPU, iters=1, fused=True)
    assert net["n_nets"] == 1 and not net["skipped"]
    out = str(tmp_path / "cal.json")
    assert tcal.main(["--device", CPU, "--fused", "--network", "--out",
                      out]) == 0
    assert tcal.load_record(out)["n_nets"] == 2
    clear_cache()
