"""The port's mesh executor (``repro_torch.lower.meshexec``) against the JAX
package's: the synthetic executor and pool cases of
``tests/test_multinode.py`` on the port's classes, then segment tasks of
both tiers on the CPU, fed the reference's own arrays through
``from_reference_inputs``: bit for bit equal to the port's network run and
within 1e-5 of the reference's interpret-mode run, through node crashes,
hangs and re-partitions.  The card-only case is
``tests/test_torch_device.py``'s, which imports no JAX."""
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.solver import solve
from repro.lower.calibrate import default_hw
from repro.lower.netexec import execute_network, make_network_inputs
from repro.workloads.nets import get_net
from repro_torch.core.solver import solve as t_solve
from repro_torch.core.solver.multinode import (MultiNodePlan, NodeAssignment,
                                               NodeMesh, plan_multinode)
from repro_torch.hw.presets import eyeriss_multinode as t_eyeriss
from repro_torch.lower import from_reference_inputs, fused_runner
from repro_torch.lower import lower_network as t_lower_network
from repro_torch.lower import netexec as tnx
from repro_torch.lower.meshexec import (MeshExecutor, NodePool, SegmentTask,
                                        build_segment_tasks)
from repro_torch.obs.metrics import REGISTRY
from repro_torch.runtime.fault import ElasticPlanner, NodeFailure
from repro_torch.runtime.inject import FaultPlan, FaultSpec, inject
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.workloads.nets import get_net as t_get_net

HW = default_hw()
T_HW = t_eyeriss(nodes=4, pe=8)
CPU = "cpu"
TOL = 1e-5
TIERS = [None, "compiled"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions issue many small ops; one intra-op thread each
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    net = t_get_net("mlp", batch=4)
    sched = t_solve(net, T_HW, max_seg_len=2)
    assert sched.valid
    return net, sched


# ---------------------------------------------------------------------------
# the resilient executor (synthetic tasks: fast, no kernels)
# ---------------------------------------------------------------------------

def synth_plan(parts_spec, nodes=4):
    parts = []
    seg = 0
    for pi, (nseg, node_ids) in enumerate(parts_spec):
        parts.append(NodeAssignment(
            part=pi, seg_start=seg, seg_stop=seg + nseg,
            node_ids=tuple(node_ids), compute_cycles=100.0, energy_pj=1.0,
            inbound_bytes=0.0, inbound_hops=0, link_cycles=0.0,
            onchip_staged=True))
        seg += nseg
    return MultiNodePlan(
        graph_name="synth", mesh=NodeMesh(nodes=nodes),
        parts=tuple(parts), bottleneck_cycles=100.0, latency_cycles=100.0,
        total_energy_pj=1.0, link_bytes=0.0, est_cost=100.0)


def synth_tasks(n, log=None, seconds=0.0):
    tasks = []
    for i in range(n):
        def run(state, i=i):
            if log is not None:
                log.append((i, threading.current_thread().name))
            if seconds:
                time.sleep(seconds)
            return {f"t{i}": np.asarray(state.get(f"t{i-1}", 0) + i + 1)}
        tasks.append(SegmentTask(i, (f"t{i-1}",) if i else (),
                                 (f"t{i}",), run))
    return tasks


def test_executor_fault_free_runs_on_assigned_nodes():
    log = []
    plan = synth_plan([(1, (0,)), (1, (1,)), (1, (2,))])
    with MeshExecutor(plan, synth_tasks(3, log)) as ex:
        r = ex.run({}, "r0")
    assert int(r.outputs["t2"]) == 1 + 2 + 3
    assert not r.degraded and r.replays == 0 and r.backups == 0
    threads = {i: t for i, t in log}
    assert threads[0].startswith("node0")
    assert threads[1].startswith("node1")
    assert threads[2].startswith("node2")


def test_executor_replicated_part_round_robins_requests():
    log = []
    plan = synth_plan([(2, (0, 1, 2, 3))])
    with MeshExecutor(plan, synth_tasks(2, log)) as ex:
        for i in range(4):
            ex.run({}, f"r{i}")
    # each request sticks to one replica; requests spread across the group
    assert len({t.split("_")[0] for _, t in log}) > 1


def test_executor_dead_assignment_falls_back_without_context():
    # no schedule/graph/hw: the repartition rung is unavailable, so a
    # lost node drops straight to the single-node fallback — degraded,
    # but the request still completes with correct outputs
    plan = synth_plan([(1, (0,)), (1, (1,))])
    with MeshExecutor(plan, synth_tasks(2)) as ex:
        ex.pool.kill(1, "test")
        r = ex.run({}, "r0")
    assert int(r.outputs["t1"]) == 3
    assert r.degraded and ex.fallback
    assert ex.stats()["degraded_requests"] == 1


@pytest.mark.chaos
def test_executor_repartitions_on_injected_crash(solved):
    net, sched = solved
    plan = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    victim = plan.parts[0].node_ids[0]
    S = plan.n_segments
    faults = FaultPlan.make(1, {"node.crash": FaultSpec(
        rate=1.0, match=f"node{victim}")})
    with MeshExecutor(plan, synth_tasks(S), schedule=sched, graph=net,
                      hw=T_HW) as ex:
        with inject(faults) as inj:
            r = ex.run({}, "r0")
        assert int(r.outputs[f"t{S-1}"]) == sum(range(1, S + 1))
        assert not r.degraded              # survivors absorbed the loss
        assert r.replays >= 1              # replayed from the boundary
        st = ex.stats()
        assert st["failures"] >= 1
        assert st["repartitions"] >= 1
        assert st["resolved_segments"] >= 1
        assert victim not in st["alive_nodes"]
        # the drained node's straggler history was forgotten
        assert f"node{victim}" not in st["straggler"]["hosts"]
        assert inj.fired.get("node.crash", 0) >= 1
        # repartitioned plan no longer references the dead node
        assert all(victim not in p.node_ids for p in ex.plan.parts)


@pytest.mark.chaos
def test_executor_hang_drains_node(solved):
    net, sched = solved
    plan = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    victim = plan.parts[0].node_ids[0]
    S = plan.n_segments
    faults = FaultPlan.make(1, {"node.hang": FaultSpec(
        rate=1.0, kind="slow", delay_s=5.0, match=f"node{victim}")})
    with MeshExecutor(plan, synth_tasks(S), schedule=sched, graph=net,
                      hw=T_HW, task_timeout_s=0.3) as ex:
        with inject(faults):
            r = ex.run({}, "r0")
    assert int(r.outputs[f"t{S-1}"]) == sum(range(1, S + 1))
    assert not r.degraded
    assert ex.pool.is_dead(victim)         # hung -> drained
    assert ex.stats()["repartitions"] >= 1


def test_executor_straggler_feeds_backup_dispatch():
    """The reference's case, with its slow primary held for seconds past
    the backup deadline (1.5 x the fleet median 0.254 s = 0.381 s), not
    19 ms: the healthy peer wins however loaded the machine is."""
    plan = synth_plan([(1, (0,)), (1, (1,))])
    release = threading.Event()

    def run(state):
        if threading.current_thread().name.startswith("node1"):
            release.wait(timeout=10.0)     # 9.6 s past the deadline
        return {"t1": np.asarray(7)}

    tasks = [synth_tasks(1)[0],
             SegmentTask(1, ("t0",), ("t1",), run)]
    det = StragglerDetector(factor=1.5, warmup=1)
    for _ in range(3):
        det.record("node1", 0.5)           # node1 is already notorious
        det.record("node0", 0.01)
    try:
        with MeshExecutor(plan, tasks, detector=det,
                          min_backup_deadline_s=0.05) as ex:
            r = ex.run({}, "r0")
            assert not ex.pool.is_dead(1)  # slow, not dead: never killed
    finally:
        release.set()
    assert int(r.outputs["t1"]) == 7
    assert r.backups >= 1                  # the healthy peer won the race
    assert not r.degraded
    assert r.seconds < 5.0


@pytest.mark.chaos
def test_executor_all_nodes_lost_single_node_fallback(solved):
    net, sched = solved
    plan = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    S = plan.n_segments
    faults = FaultPlan.make(1, {"node.crash": FaultSpec(rate=1.0)})
    planner = ElasticPlanner(model_axis=1, min_data=2)
    with MeshExecutor(plan, synth_tasks(S), schedule=sched, graph=net,
                      hw=T_HW, planner=planner) as ex:
        with inject(faults):               # every dispatch crashes a node
            r = ex.run({}, "r0")
    assert int(r.outputs[f"t{S-1}"]) == sum(range(1, S + 1))
    assert r.degraded and ex.fallback      # below min_nodes: last rung
    assert ex.stats()["recovery_seconds"] >= 0.0


def test_node_pool_contract():
    with NodePool(2) as pool:
        assert pool.alive() == [0, 1]
        fut = pool.submit(0, lambda: 42)
        assert fut.result() == 42
        pool.kill(0, "test")
        pool.kill(0, "again")              # idempotent
        assert pool.alive() == [1]
        with pytest.raises(NodeFailure) as ei:
            pool.submit(0, lambda: 0)
        assert ei.value.permanent
        pool.set_slow(1, 3.0)
        assert pool.slow_factor(1) == 3.0
    with pytest.raises(ValueError):
        NodePool(0)


def test_metric_names_match_the_reference():
    import repro.lower.meshexec as jmesh
    from repro.obs.metrics import REGISTRY as J_REGISTRY
    plan = synth_plan([(1, (0,))], nodes=1)
    for executor in (MeshExecutor, jmesh.MeshExecutor):
        with executor(plan, synth_tasks(1)) as ex:
            ex.run({}, "r0")

    def mesh(registry):
        return {n for n in registry.snapshot() if n.startswith("mesh")}
    assert mesh(REGISTRY) == mesh(J_REGISTRY)
    assert {"mesh_alive_nodes", "mesh_recovery_seconds",
            "mesh_pool_events_total", "mesh_events_total"} <= mesh(REGISTRY)


# ---------------------------------------------------------------------------
# segment tasks on the CPU: the port's kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lowered(solved):
    """The reference's plan and inputs (numpy), the port's plan of the
    same schedule, and the port's tensors of those arrays."""
    net, sched = solved
    ref_net = get_net("mlp", batch=4)
    ref_sched = solve(ref_net, HW, max_seg_len=2)
    ref_plan = ref_sched.lower(ref_net, HW)
    arrays = {k: np.asarray(v)
              for k, v in make_network_inputs(ref_plan, seed=0).items()}
    nplan = t_lower_network(sched, net, T_HW)
    assert nplan.order == ref_plan.order
    inputs = from_reference_inputs(arrays, nplan, device=CPU)
    return ref_plan, arrays, nplan, inputs


def _split(inputs):
    weights = {k: v for k, v in inputs.items() if k.endswith(".W")}
    ext = {k: v.numpy() for k, v in inputs.items() if k.endswith(".I")}
    return weights, ext


def _network(nplan, inputs):
    """The port's network run, in a thread of its own: a node's thread
    runs the plain versions with the intra-op threads a new thread gets,
    not those this test's thread was set to, and the CPU's matmul sums in
    another order with another count."""
    with ThreadPoolExecutor(1) as pool:
        ex = pool.submit(lambda: tnx.network_runner(
            nplan, inputs, device=CPU)()).result()
    return {k: v.numpy() for k, v in ex.outputs.items()}


@pytest.mark.parametrize("backend", TIERS, ids=["per-layer", "fused"])
def test_segment_tasks_match_network_execution(lowered, solved, backend):
    net, sched = solved
    ref_plan, arrays, nplan, inputs = lowered
    weights, ext = _split(inputs)
    tasks = build_segment_tasks(nplan, weights, backend=backend, device=CPU)
    plan = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    with MeshExecutor(plan, tasks, schedule=sched, graph=net,
                      hw=T_HW) as ex:
        r = ex.run(ext, "r0")
    want = _network(nplan, inputs)
    ref = execute_network(ref_plan, arrays)
    assert r.outputs
    for k, v in r.outputs.items():
        assert isinstance(v, np.ndarray) and v.dtype == np.float32, k
        assert np.array_equal(v, want[k]), k
        assert tnx.rel_error(v, np.asarray(ref.outputs[k])) < TOL, k
    assert nplan.order[-1] in r.outputs     # the network's output


def test_fused_tasks_equal_per_layer_tasks(lowered, solved):
    """The fused tier's tasks emit a subset of the per-layer tier's
    boundary tensors (what a later segment or the output needs), each bit
    for bit equal on the CPU."""
    net, sched = solved
    _, _, nplan, inputs = lowered
    weights, ext = _split(inputs)
    plan = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    outs = []
    for backend in TIERS:
        tasks = build_segment_tasks(nplan, weights, backend=backend,
                                    device=CPU)
        with MeshExecutor(plan, tasks) as ex:
            outs.append(ex.run(ext, "r0").outputs)
    per_layer, fused = outs
    assert fused and set(fused) <= set(per_layer)
    for k, v in fused.items():
        assert np.array_equal(v, per_layer[k]), k


@pytest.mark.parametrize("backend", TIERS, ids=["per-layer", "fused"])
def test_each_request_computes_on_its_own_inputs(lowered, solved, backend):
    """Two requests with different ``.I`` through one task list each equal
    their own network run (a step that read its closure's input would
    give the first request's to both)."""
    net, sched = solved
    _, _, nplan, inputs = lowered
    weights, ext = _split(inputs)
    other = dict(inputs)
    for k in ext:
        other[k] = torch.from_numpy(
            np.random.default_rng(7).standard_normal(
                ext[k].shape).astype(np.float32))
    _, ext2 = _split(other)
    tasks = build_segment_tasks(nplan, weights, backend=backend, device=CPU)
    plan = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    with MeshExecutor(plan, tasks) as ex:
        got = [ex.run(e, f"r{i}").outputs
               for i, e in enumerate((ext, ext2, ext))]
    wants = [_network(nplan, inputs), _network(nplan, other)]
    last = nplan.order[-1]
    assert not np.array_equal(wants[0][last], wants[1][last])
    for out, want in zip(got, wants + wants[:1]):
        for k, v in out.items():
            assert np.array_equal(v, want[k]), k


@pytest.mark.chaos
@pytest.mark.parametrize("backend", TIERS, ids=["per-layer", "fused"])
def test_mesh_chaos_kill_keeps_results_bit_identical(lowered, solved,
                                                     backend):
    net, sched = solved
    _, _, nplan, inputs = lowered
    weights, ext = _split(inputs)
    tasks = build_segment_tasks(nplan, weights, backend=backend, device=CPU)
    fused = fused_runner(nplan, device=CPU)
    traces = fused.traces
    plan0 = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    with MeshExecutor(plan0, tasks, schedule=sched, graph=net,
                      hw=T_HW) as ex:
        baseline = ex.run(ext, "r0").outputs
    victim = plan0.parts[0].node_ids[0]
    faults = FaultPlan.make(5, {"node.crash": FaultSpec(
        rate=1.0, match=f"node{victim}", after=1)})
    plan1 = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    with MeshExecutor(plan1, tasks, schedule=sched, graph=net,
                      hw=T_HW) as ex:
        with inject(faults):
            runs = [ex.run(ext, f"r{i}") for i in range(4)]
        st = ex.stats()
    assert all(not r.degraded for r in runs)
    for r in runs:                         # availability + bit-identity
        for k, v in r.outputs.items():
            assert np.array_equal(v, baseline[k]), k
    assert st["failures"] >= 1
    assert st["repartitions"] >= 1
    # incremental: the re-partition re-placed at most the whole chain
    assert 1 <= st["resolved_segments"] <= st["repartitions"] * len(tasks)
    # every segment was built with the tasks: failures, replays and the
    # re-partition built nothing again
    assert fused.traces == traces


@pytest.mark.chaos
@pytest.mark.parametrize("backend", TIERS, ids=["per-layer", "fused"])
def test_woken_drained_node_cannot_change_later_outputs(lowered, solved,
                                                        backend):
    """A node hangs past the task deadline holding request 0 (inputs A),
    is drained, and wakes while later requests (inputs B) run: it really
    runs its task then, and every later request still equals B's own
    network run."""
    net, sched = solved
    _, _, nplan, inputs = lowered
    weights, ext_a = _split(inputs)
    other = dict(inputs)
    for k in ext_a:
        other[k] = torch.from_numpy(-ext_a[k])
    _, ext_b = _split(other)
    want_b = _network(nplan, other)
    runs_log = []

    def logged(task):
        def run(state):
            runs_log.append((threading.current_thread().name,
                             time.perf_counter()))
            return task.run(state)
        return SegmentTask(task.index, task.consumes, task.produces, run)

    tasks = [logged(t) for t in build_segment_tasks(
        nplan, weights, backend=backend, device=CPU)]
    plan = plan_multinode(sched, net, T_HW, NodeMesh(nodes=4))
    victim = plan.parts[0].node_ids[0]
    faults = FaultPlan.make(3, {"node.hang": FaultSpec(
        rate=1.0, kind="slow", delay_s=0.6, match=f"node{victim}")})
    with MeshExecutor(plan, tasks, schedule=sched, graph=net, hw=T_HW,
                      task_timeout_s=0.2) as ex:
        with inject(faults):
            first = ex.run(ext_a, "hung")
            drained = time.perf_counter()
            assert ex.pool.is_dead(victim)
            later = []
            while time.perf_counter() < drained + 1.5:
                later.append(ex.run(ext_b, f"r{len(later)}"))
    woke = [t for name, t in runs_log
            if name.startswith(f"node{victim}_") and t > drained]
    assert woke, "the drained node never ran its task"
    assert not first.degraded
    assert len(later) >= 2
    for r in later:
        assert not r.degraded
        for k, v in r.outputs.items():
            assert np.array_equal(v, want_b[k]), k


def test_build_segment_tasks_checks_its_backend(lowered):
    _, _, nplan, inputs = lowered
    weights, _ = _split(inputs)
    with pytest.raises(ValueError, match="unknown backend"):
        build_segment_tasks(nplan, weights, backend="tpu", device=CPU)


def test_build_segment_tasks_needs_the_card_unless_asked_for_the_cpu(
        lowered):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    _, _, nplan, inputs = lowered
    weights, _ = _split(inputs)
    for backend in TIERS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_segment_tasks(nplan, weights, backend=backend)
