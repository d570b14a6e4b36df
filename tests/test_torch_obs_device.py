"""The port's host spans and device marks (``obs/device.py``) and where the
program opens them: ``span`` is the shared no-op with neither a tracer nor
a profiler, lands in the tracer's events and among a ``torch.profiler``
run's host events; a tiny ``CompiledTraining`` and a tiny
``FusedNetwork`` read their phases (``phase_ms``) when a tracer is
installed, and none without one, nor after the tracer is removed; the
train step's, the fused call's and the capture's spans carry their
arguments.  The ``gpu`` cases, on the card: a captured replay's phases
add up to the replay's time taken by events outside the graph, and are
read after the tracer is removed (the graph records its marks), a graph
captured with tracing off holds no mark, and the copy-in and replay of a
fused call add up to the call.
The file imports no JAX, so the card's machine runs it too."""
import dataclasses
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.solver import solve
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.hw.presets import eyeriss_multinode
from repro_torch.kernels.graph import CapturedStep
from repro_torch.launch.steps import (OPTIMIZER_SPAN, CompiledTraining,
                                      build_train_step, input_structs)
from repro_torch.launch.train import tiny_config
from repro_torch.lower import (fused_runner, lower_network,
                               make_network_inputs)
from repro_torch.models.api import build_model
from repro_torch.obs import device, trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.workloads.nets import get_net

ROOT = Path(__file__).resolve().parents[1]
TRAIN_PHASES = ["forward", "backward", "optimizer"]
NET_PHASES = ["copy_in", "replay"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny shapes (the suite runs several
    workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracer():
    t = trace.enable()
    yield t
    trace.disable()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and their event nodes "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _training(dev, dtype=torch.float32, B=2, S=32):
    """(step object, its batches, (api, params, optimizer, state)): tiny
    Qwen2.5-3B on ``dev``."""
    cfg = dataclasses.replace(tiny_config(get_config("qwen2.5-3b")),
                              head_dim=64)
    api = build_model(cfg, device=dev, dtype=dtype, trainable=True)
    params = api.init(0)
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    state = opt.init(dict(params.named_parameters()))
    shape = ShapeConfig("t", S, B, "train")
    step = CompiledTraining(api, params, state, opt,
                            input_structs(cfg, shape))
    batches = [synth_batch(cfg, shape, i, DataConfig(seed=0))
               for i in range(4)]
    return step, batches, (api, params, opt, state)


def _network(dev, name="mlp", batch=4, hw=None):
    """(fused network, its inputs): a net solved and lowered by the port
    (a small MLP unless named)."""
    net = get_net(name, batch=batch)
    hw = hw or eyeriss_multinode(nodes=4, pe=8)
    nplan = lower_network(solve(net, hw), net, hw)
    assert nplan.executable
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    return fused_runner(nplan, cache=False, device=dev), inputs


# -- span ---------------------------------------------------------------------

def test_span_is_the_shared_noop_without_a_tracer_or_a_profiler():
    assert not trace.enabled()
    assert device.span("x.y", a=1) is trace.NOOP_SPAN
    with device.span("x.y") as sp:
        sp.set(b=2)


def test_span_lands_in_the_tracers_events(tracer):
    with device.span("x.outer", a=1) as sp:
        with device.span("x.inner"):
            time.sleep(0.001)
        sp.set(b=2)
    (outer,) = tracer.find("x.outer")
    (inner,) = tracer.find("x.inner")
    assert outer["args"] == {"a": 1, "b": 2} and outer["ph"] == "X"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["dur"] >= 0.001


@pytest.mark.parametrize("traced", [False, True], ids=["alone", "traced"])
def test_span_is_a_host_event_of_a_profile(traced):
    """Under a CPU ``torch.profiler`` run the span is one of its host
    events, with or without a tracer; with one it lands there too."""
    from torch.profiler import ProfilerActivity, profile
    t = trace.enable() if traced else None
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with device.span("x.profiled", a=1):
                torch.ones(8).add_(1)
    finally:
        if traced:
            trace.disable()
    names = [e.name for e in prof.events()]
    assert names.count("x.profiled") == 1
    assert "aten::add_" in names
    if traced:
        assert len(t.find("x.profiled")) == 1


def test_span_records_an_error_and_lets_it_through(tracer):
    with pytest.raises(KeyError):
        with device.span("x.failing"):
            raise KeyError("k")
    (ev,) = tracer.find("x.failing")
    assert ev["args"]["error"] == "KeyError"


# -- marks --------------------------------------------------------------------

def test_marks_need_a_tracer():
    marks = device.Marks()
    marks.mark("a")
    marks.mark("b")
    assert marks.phase_ms() == {}


def test_marks_name_each_phase_after_its_opening_mark(tracer):
    marks = device.Marks("cpu")
    assert marks.phase_ms() == {}
    marks.mark("a")
    time.sleep(0.002)
    marks.mark("b")
    marks.mark("c")
    got = marks.phase_ms()
    assert list(got) == ["a", "b"]
    assert got["a"] >= 2.0 and got["b"] >= 0.0
    # a second run rewrites the marks in their first order
    marks.mark("a")
    marks.mark("b")
    time.sleep(0.003)
    marks.mark("c")
    got = marks.phase_ms()
    assert list(got) == ["a", "b"] and got["b"] >= 3.0


# -- the program's phases and spans on the CPU --------------------------------

def test_compiled_training_phases_on_the_cpu(tracer):
    step, batches, _ = _training("cpu")
    for b in batches[:2]:
        t0 = time.perf_counter()
        step.step(b)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        got = step.phase_ms()
        assert list(got) == TRAIN_PHASES
        assert all(v > 0 for v in got.values()), got
        assert sum(got.values()) <= wall_ms
    copies = tracer.find("train.copy_in")
    assert [e["args"]["step"] for e in copies] == [1, 2]
    # on the CPU the first step runs the body too, not a warm-up
    assert [e["args"]["step"] for e in tracer.find("train.replay")] == [1, 2]
    assert len(tracer.find(OPTIMIZER_SPAN)) == 2
    assert step.steps == 2


def test_compiled_training_has_no_phases_without_a_tracer():
    step, batches, _ = _training("cpu")
    step.step(batches[0])
    step.step(batches[1])
    assert step.phase_ms() == {}
    assert step.capture_seconds == 0.0


def test_fused_network_phases_on_the_cpu(tracer):
    net, inputs = _network("cpu")
    for n in (1, 2):
        t0 = time.perf_counter()
        net(inputs, keep="boundary")
        wall_ms = 1e3 * (time.perf_counter() - t0)
        got = net.phase_ms()
        assert list(got) == NET_PHASES
        assert all(v > 0 for v in got.values()), got
        assert sum(got.values()) <= wall_ms
    assert [e["args"]["call"] for e in tracer.find("fused.bind")] == [1, 2]
    assert [e["args"]["call"] for e in tracer.find("fused.replay")] == [1, 2]
    # no capture on the CPU: no capture span, no seconds
    assert not tracer.find("graph.capture")
    assert net.capture_seconds == {("net", "boundary"): 0.0}


def test_fused_network_has_no_phases_without_a_tracer():
    net, inputs = _network("cpu")
    net(inputs, keep="boundary")
    assert net.phase_ms() == {}


def test_marks_without_a_tracer_forget_a_traced_run():
    marks = device.Marks("cpu")
    trace.enable()
    try:
        marks.mark("a")
        marks.mark("b")
    finally:
        trace.disable()
    assert list(marks.phase_ms()) == ["a"]
    marks.mark("a")
    assert marks.phase_ms() == {}


def test_an_untraced_call_after_a_traced_one_has_no_phases():
    """The fused call's marks sit outside the graph: a call made after
    the tracer is removed reads no phases of the traced call before it."""
    net, inputs = _network("cpu")
    trace.enable()
    try:
        net(inputs, keep="boundary")
    finally:
        trace.disable()
    assert list(net.phase_ms()) == NET_PHASES
    net(inputs, keep="boundary")
    assert net.phase_ms() == {}


def test_an_untraced_cpu_step_after_a_traced_one_has_no_phases():
    step, batches, _ = _training("cpu")
    trace.enable()
    try:
        step.step(batches[0])
    finally:
        trace.disable()
    assert list(step.phase_ms()) == TRAIN_PHASES
    step.step(batches[1])
    assert step.phase_ms() == {}


def test_a_segment_run_is_a_fused_call_too(tracer):
    net, inputs = _network("cpu")
    state = dict(inputs)
    for i in range(len(net.segment_io)):
        state.update(net.run_segment(i, state))
    calls = [e["args"]["call"] for e in tracer.find("fused.replay")]
    assert calls == list(range(1, len(net.segment_io) + 1))
    assert list(net.phase_ms()) == NET_PHASES


def test_the_capture_histogram_is_labelled_by_owner_and_phase():
    h = REGISTRY.get("graph_capture_seconds")
    assert h is not None and h.kind == "histogram"
    assert h.labelnames == ("owner", "phase")


def test_a_cpu_step_captures_nothing(tracer):
    calls = []
    cs = CapturedStep(lambda: calls.append(1) or {}, torch.device("cpu"),
                      owner="unit")
    assert (cs.warmup_seconds, cs.graph_seconds, cs.capture_seconds) == (
        0.0, 0.0, 0.0)
    cs()
    assert calls == [1] and not tracer.find("graph.warmup")


# -- on the card ----------------------------------------------------------------

def _outer_ms(fn):
    """``fn()`` between two events outside it: their device ms.  The card
    spins ~10 ms first (``torch.cuda._sleep``), so that the events, the
    marks and ``fn``'s work are all queued before the card reaches them:
    neither the events nor the marks then hold a wait for the host's issue
    (tens of microseconds for a graph of many nodes)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


#: the events' own resolution, ms
RESOLUTION_MS = 0.002


@pytest.mark.gpu
def test_captured_train_phases_add_up_to_the_replay(tracer):
    """The marks captured as event-record nodes time every replay: the
    three phases add up to within 2% of the replay's time taken by events
    outside the graph, and the capture's spans carry their owner."""
    dev = _card()
    step, batches, _ = _training(dev, torch.bfloat16, B=8, S=256)
    step.step(batches[0])                  # warm-up and capture
    assert step.captured.graph is not None
    for b in batches[1:]:
        for k, buf in step.batch.items():
            buf.copy_(torch.as_tensor(b[k]))
        outer = _outer_ms(step.captured)
        got = step.phase_ms()
        assert list(got) == TRAIN_PHASES
        assert all(v > 0 for v in got.values()), got
        assert abs(sum(got.values()) - outer) <= \
            0.02 * outer + RESOLUTION_MS, (got, outer)
    (cap,) = tracer.find("graph.capture")
    (warm,) = tracer.find("graph.warmup")
    assert cap["args"] == {"owner": "train"} == warm["args"]
    assert step.captured.capture_seconds == pytest.approx(
        step.captured.warmup_seconds + step.captured.graph_seconds)
    assert step.captured.graph_seconds > 0


@pytest.mark.gpu
def test_a_graph_captured_with_its_marks_keeps_them_untraced():
    dev = _card()
    step, batches, _ = _training(dev, torch.bfloat16)
    trace.enable()
    try:
        step.step(batches[0])              # warm-up and capture
    finally:
        trace.disable()
    step.step(batches[1])
    got = step.phase_ms()
    assert list(got) == TRAIN_PHASES
    assert all(v > 0 for v in got.values()), got


@pytest.mark.gpu
def test_a_graph_captured_with_tracing_off_holds_no_mark():
    dev = _card()
    step, batches, _ = _training(dev, torch.bfloat16)
    step.step(batches[0])
    t = trace.enable()                     # installed after the capture
    try:
        step.step(batches[1])
        assert step.phase_ms() == {}
        assert not step.marks._at
        assert len(t.find("train.replay")) == 1
    finally:
        trace.disable()


@pytest.mark.gpu
def test_fused_copy_in_and_replay_add_up_to_the_call(tracer):
    """AlexNet b64: a call of milliseconds, against which the events' own
    microseconds at each boundary are small."""
    dev = _card()
    net, inputs = _network(dev, "alexnet", 64, eyeriss_multinode())
    net(inputs, keep="boundary")          # the capture
    for _ in range(3):
        outer = _outer_ms(lambda: net(inputs, keep="boundary"))
        got = net.phase_ms()
        assert list(got) == NET_PHASES
        assert all(v > 0 for v in got.values()), got
        assert abs(sum(got.values()) - outer) <= \
            0.02 * outer + RESOLUTION_MS, (got, outer)
    (cap,) = tracer.find("graph.capture")
    assert cap["args"]["owner"] == "net.boundary"
    assert cap["args"]["variant"] == str(("net", "boundary"))
    assert net.capture_seconds[("net", "boundary")] > 0


@pytest.mark.gpu
def test_an_eager_steps_update_is_found_under_its_span():
    """With no tracer, the update's span is still a profiler range:
    ``chip_smoke.py``'s ``_train_groups`` finds the update's kernels under
    it."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    _, batches, (api, params, opt, state) = _training(dev, torch.bfloat16)
    train_step = build_train_step(api, opt)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    train_step(params, state, batch)            # first calls unprofiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke._train_groups(prof, wall_ms)
    assert got["device_ms"]["optimizer"] > 0
    assert got["optimizer_span_ms"] > 0
