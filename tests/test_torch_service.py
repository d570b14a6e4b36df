"""The port's schedule service and baseline solvers vs the JAX package's:
the same seed gives the same random-search, annealing and exhaustive
schedules; signatures and store records are equal and read across
packages; the service's execution-free behaviour (store, client, server,
CLI) mirrors ``tests/test_service.py``; autotune verifies every candidate
on the CPU through the fused tier's shared cache; ``obs explain
--store-dir`` finds a stored schedule; the quickstart prints the
reference's headline."""
import asyncio
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core.solver import annealing as j_annealing
from repro.core.solver import exhaustive as j_exhaustive
from repro.core.solver import random_search as j_random_search
from repro.core.solver import solve as j_solve
from repro.hw.presets import eyeriss_multinode as j_eyeriss
from repro.service import ScheduleStore as JStore
from repro.service import family_signature as j_family_signature
from repro.service import schedule_signature as j_schedule_signature
from repro.workloads.nets import get_net as j_get_net
from repro_torch.core.solver import (NetworkSchedule, annealing, exhaustive,
                                     random_search, seed_chains_from, solve,
                                     solve_many, solve_topk)
from repro_torch.hw.presets import eyeriss_multinode
from repro_torch.lower import (cache_stats, clear_cache, lower_cached,
                               lower_network, plan_signature)
from repro_torch.lower.calibrate import default_hw
from repro_torch.service import (LocalClient, ScheduleStore, SolveRequest,
                                 SolveServer, autotune_network,
                                 family_signature, schedule_signature,
                                 serve_batch, solver_options)
from repro_torch.workloads.layers import LayerGraph, fc
from repro_torch.workloads.nets import get_net

HW = eyeriss_multinode()


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions issue many small ops; one intra-op thread each
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _branchy(name="twin", batch=8, flip=False):
    a = fc("a", batch, 256, 128)
    b = fc("b", batch, 512, 128)
    first, second = (b, a) if flip else (a, b)
    join = fc("join", batch, 128, 64, src=[first.name])
    return LayerGraph(name, [first, second, join])


def _same(port, ref):
    assert port.valid == ref.valid
    assert port.total_energy_pj == ref.total_energy_pj
    assert port.total_latency_cycles == ref.total_latency_cycles


# ---------------------------------------------------------------------------
# the package surfaces
# ---------------------------------------------------------------------------

def test_packages_export_the_reference_names():
    import repro.core.solver
    import repro.lower
    import repro.service
    import repro_torch.core.solver
    import repro_torch.lower
    import repro_torch.service
    for ref, port in ((repro.core.solver, repro_torch.core.solver),
                      (repro.lower, repro_torch.lower),
                      (repro.service, repro_torch.service)):
        assert set(ref.__all__) <= set(port.__all__), \
            sorted(set(ref.__all__) - set(port.__all__))


# ---------------------------------------------------------------------------
# baseline solvers: same seed, same schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["mlp", "alexnet"])
def test_random_search_matches_reference(net):
    for seed in (0, 3):
        _same(random_search.solve(get_net(net, batch=8), HW, samples=100,
                                  seed=seed),
              j_random_search.solve(j_get_net(net, batch=8), j_eyeriss(),
                                    samples=100, seed=seed))


@pytest.mark.parametrize("net", ["mlp", "alexnet"])
def test_annealing_matches_reference(net):
    _same(annealing.solve(get_net(net, batch=8), HW, iters=4, batch=8,
                          seed=1),
          j_annealing.solve(j_get_net(net, batch=8), j_eyeriss(), iters=4,
                            batch=8, seed=1))


def test_exhaustive_matches_reference():
    port = exhaustive.solve(get_net("mlp", batch=8), HW,
                            budget_per_layer=200)
    _same(port, j_exhaustive.solve(j_get_net("mlp", batch=8), j_eyeriss(),
                                   budget_per_layer=200))
    # the paper's claim on the port's copies: KAPLA near the optimum,
    # never worse than the random and annealing baselines by more than
    # rounding
    k = solve(get_net("mlp", batch=8), HW)
    assert k.total_energy_pj / port.total_energy_pj - 1.0 < 0.10
    r = random_search.solve(get_net("mlp", batch=8), HW, samples=100)
    assert k.total_energy_pj <= r.total_energy_pj * 1.001


# ---------------------------------------------------------------------------
# signatures and the store, across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,batch", [("mlp", 8), ("lstm", 8),
                                       ("alexnet", 4), ("resnet", 2)])
def test_signatures_equal_across_packages(net, batch):
    assert schedule_signature(get_net(net, batch=batch), HW) == \
        j_schedule_signature(j_get_net(net, batch=batch), j_eyeriss())
    assert family_signature(get_net(net, batch=batch), HW) == \
        j_family_signature(j_get_net(net, batch=batch), j_eyeriss())
    opts = {"objective": "latency"}
    assert schedule_signature(get_net(net, batch=batch), HW, opts) == \
        j_schedule_signature(j_get_net(net, batch=batch), j_eyeriss(), opts)


def test_signature_rules():
    g1 = get_net("mlp", batch=8)
    renamed = [dataclasses.replace(
        l, name=f"L{i}", src=tuple(f"L{j}" for j in range(i)
                                   if g1.layers[j].name in l.src))
        for i, l in enumerate(g1.layers)]
    assert schedule_signature(g1, HW) == \
        schedule_signature(LayerGraph("mlp", renamed), HW)
    assert schedule_signature(_branchy(), HW) != \
        schedule_signature(_branchy(flip=True), HW)
    g16 = get_net("mlp", batch=16)
    assert schedule_signature(g1, HW) != schedule_signature(g16, HW)
    assert family_signature(g1, HW) == family_signature(g16, HW)
    assert schedule_signature(g1, HW) != \
        schedule_signature(g1, HW.with_(mac_energy_pj=HW.mac_energy_pj * 2))
    with pytest.raises(ValueError):
        solver_options(bogus=1)


def test_store_records_read_across_packages(tmp_path):
    port_root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    port_store, ref_store = ScheduleStore(port_root), JStore(ref_root)
    for name, batch in (("mlp", 8), ("alexnet", 4)):
        sched = solve(get_net(name, batch=batch), HW)
        ref = j_solve(j_get_net(name, batch=batch), j_eyeriss())
        _same(sched, ref)
        sig = port_store.put(sched, get_net(name, batch=batch), HW).signature
        assert ref_store.put(ref, j_get_net(name, batch=batch),
                             j_eyeriss()).signature == sig
        # each package reads the other's record and rescores it exactly
        back = JStore(port_root).get(sig, j_get_net(name, batch=batch))
        e, lat, _ = back.rescore(j_get_net(name, batch=batch), j_eyeriss())
        assert (e, lat) == (sched.total_energy_pj,
                            sched.total_latency_cycles)
        back = ScheduleStore(ref_root).get(sig, get_net(name, batch=batch))
        e, lat, _ = back.rescore(get_net(name, batch=batch), HW)
        assert (e, lat) == (ref.total_energy_pj, ref.total_latency_cycles)


def test_store_put_get_eviction_and_atomic_files(tmp_path):
    store = ScheduleStore(str(tmp_path), max_entries=2)
    net = get_net("mlp", batch=8)
    sched = solve(net, HW)
    rec = store.put(sched, net, HW)
    assert store.has(rec.signature) and len(store) == 1
    back = store.get(rec.signature, get_net("mlp", batch=8))
    assert back.total_energy_pj == sched.total_energy_pj
    assert store.get("0" * 64) is None
    assert store.stats()["hits"] == 1 and store.stats()["misses"] == 1
    for batch in (2, 4):
        g = get_net("mlp", batch=batch)
        store.put(solve(g, HW), g, HW)
    assert len(store) == 2 and store.stats()["evictions"] == 1
    assert not [n for n in os.listdir(store.records_dir)
                if n.endswith(".tmp")]
    assert ScheduleStore(str(tmp_path)).warm_records(
        family_signature(net, HW))


def test_from_json_roundtrip_and_positional_rebind(tmp_path):
    net = get_net("mlp", batch=8)
    sched = solve(net, HW)
    blob = json.dumps(sched.to_json())
    back = NetworkSchedule.from_json(json.loads(blob))
    e, lat, _ = back.rescore(hw=HW)
    assert (e, lat) == (sched.total_energy_pj, sched.total_latency_cycles)
    assert json.dumps(back.to_json()) == blob
    store = ScheduleStore(str(tmp_path))
    sig = store.put(sched, net, HW).signature
    renamed = LayerGraph("mlp-renamed", [dataclasses.replace(
        l, name=f"L{i}", src=(f"L{i - 1}",) if i else ())
        for i, l in enumerate(net.layers)])
    assert schedule_signature(renamed, HW) == sig
    assert set(store.get(sig, renamed).layer_schemes) == \
        {l.name for l in renamed.layers}


def test_seed_chains_from_rebatches_granules():
    sched = solve(get_net("lstm", batch=8), HW)
    net32 = get_net("lstm", batch=32)
    seeds = seed_chains_from(sched, net32)
    assert [(s.start, s.stop) for s in seeds[0].segments] == \
        [(s.start, s.stop) for s in sched.chain.segments]
    assert solve(net32, HW, seed_chains=seeds, use_dp=False).valid


# ---------------------------------------------------------------------------
# client, server, top-k
# ---------------------------------------------------------------------------

def test_client_cold_cached_warm_and_batch(tmp_path):
    client = LocalClient(ScheduleStore(str(tmp_path)))
    r1 = client.solve(get_net("mlp", batch=8), HW)
    assert r1.source == "cold" and r1.schedule.valid
    assert client.solve(get_net("mlp", batch=8), HW).source == "cached"
    r3 = client.solve(get_net("mlp", batch=16), HW)
    assert r3.source == "warm" and r3.schedule.valid
    reqs = [SolveRequest.make(get_net("mlp", batch=8), HW),
            SolveRequest.make(get_net("lstm", batch=8), HW),
            SolveRequest.make(get_net("lstm", batch=8), HW)]
    res = client.solve_batch(reqs)
    assert [r.source for r in res] == ["cached", "cold", "cold"]
    assert res[1].schedule.total_energy_pj == \
        j_solve(j_get_net("lstm", batch=8), j_eyeriss()).total_energy_pj


def test_solve_many_matches_individual_solves():
    items = [(get_net("mlp", batch=8), HW), (get_net("lstm", batch=8), HW)]
    for (g, hw), sched in zip(items, solve_many(items)):
        _same(sched, solve(g, hw))


def test_server_coalesces_and_caches(tmp_path):
    server = SolveServer(ScheduleStore(str(tmp_path)))
    reqs = [SolveRequest.make(get_net("mlp", batch=8), HW),
            SolveRequest.make(get_net("mlp", batch=8), HW),
            SolveRequest.make(get_net("mlp", batch=16), HW)]
    res = asyncio.run(serve_batch(server, reqs))
    assert all(r.schedule.valid for r in res)
    st = server.stats()
    assert st["requests"] == 3 and st["coalesced"] >= 1
    assert st["solved"] <= 2
    res2 = asyncio.run(serve_batch(server, reqs))
    assert [r.source for r in res2] == ["cached"] * 3


def test_solve_topk_matches_reference():
    from repro.core.solver import solve_topk as j_solve_topk
    cands = solve_topk(get_net("lstm", batch=8), HW, k=3)
    ref = j_solve_topk(j_get_net("lstm", batch=8), j_eyeriss(), k=3)
    assert len(cands) == len(ref) >= 1
    for c, r in zip(cands, ref):
        _same(c, r)


# ---------------------------------------------------------------------------
# autotune, the CLIs, the quickstart
# ---------------------------------------------------------------------------

def test_autotune_verifies_candidates_and_shares_the_cache(tmp_path):
    hw = default_hw()
    net = get_net("mlp", batch=4)
    store = ScheduleStore(str(tmp_path))
    clear_cache()
    report = autotune_network(net, hw, store=store, k=2, iters=1,
                              device="cpu")
    assert not report["skipped"]
    assert report["n_executed"] == report["n_candidates"] >= 1
    assert all(e["max_rel_err"] < 1e-3 for e in report["candidates"])
    best = min(e["measured_seconds"] for e in report["candidates"])
    assert report["promoted_measured_seconds"] == best
    rec = store.get_record(report["signature"])
    assert rec.measured["measured_seconds"] == best
    assert rec.measured["backend"] == "cpu"
    assert lower_cached(store.get(report["signature"]), hw).executable
    # every candidate went through the fused tier's cache once: equal
    # plan signatures hit, distinct ones miss
    sigs = {plan_signature(lower_network(c, net, hw))
            for c in solve_topk(net, hw, k=2)}
    st = cache_stats()
    assert st["misses"] == len(sigs)
    assert st["hits"] + st["misses"] == report["n_executed"]
    clear_cache()


def test_autotune_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune_network(get_net("mlp", batch=4), default_hw(), k=1)


def test_service_cli(tmp_path, capsys):
    from repro_torch.service.__main__ import main
    root = str(tmp_path / "store")
    assert main(["solve", "--net", "mlp", "--batch", "8",
                 "--store-dir", root]) == 0
    assert "source=cold" in capsys.readouterr().out
    assert main(["solve", "--net", "mlp", "--batch", "8",
                 "--store-dir", root]) == 0
    assert "source=cached" in capsys.readouterr().out
    assert main(["warm", "--net", "mlp", "--batch", "16",
                 "--store-dir", root]) == 0
    assert "seeding from mlp/b8" in capsys.readouterr().out
    assert main(["get", "--net", "mlp", "--batch", "8",
                 "--store-dir", root]) == 0
    assert "HIT" in capsys.readouterr().out
    assert main(["stats", "--store-dir", root]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 2
    assert main(["get", "--net", "mlp", "--batch", "4",
                 "--store-dir", root]) == 1
    capsys.readouterr()
    assert main(["repair", "--store-dir", root]) == 0
    assert "rebuilt index: 2 records" in capsys.readouterr().out
    assert main(["autotune", "--net", "mlp", "--batch", "4", "-k", "1",
                 "--iters", "1", "--device", "cpu",
                 "--store-dir", root]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["n_executed"] == 1 and report["promoted"]
    clear_cache()


def test_obs_explain_finds_a_stored_schedule(tmp_path, capsys):
    from repro_torch.obs.__main__ import main
    root = str(tmp_path / "store")
    net = get_net("alexnet", batch=1)
    sched = solve(net, HW, explain=True)
    assert sched.explain
    sig = ScheduleStore(root).put(sched, net, HW).signature
    want = json.loads(json.dumps(sched.to_json()["explain"]))
    for target in (sig, "alexnet"):
        assert main(["explain", target, "--store-dir", root,
                     "--json"]) == 0
        assert json.loads(capsys.readouterr().out) == want
    # stored without a record: solved fresh, with a note
    plain = get_net("mlp", batch=4)
    ScheduleStore(root).put(solve(plain, HW), plain, HW)
    assert main(["explain", "mlp/b4", "--store-dir", root]) == 0
    out = capsys.readouterr()
    assert "mlp" in out.out


def test_quickstart_headline_on_cpu(capsys):
    from repro_torch.quickstart import run
    out = run("cpu", samples=50)
    ref = j_solve(j_get_net("alexnet", batch=64), j_eyeriss())
    assert f"{out['energy_mj']:.2f}" == \
        f"{ref.total_energy_pj / 1e9:.2f}" == "162.82"
    assert f"{out['latency_ms']:.2f}" == "66.56"
    assert out["sources"] == ("cold", "cached")
    assert out["plan_ok"] and out["network_ok"]
    assert out["network_fused_s"] > 0 and out["random_ratio"] > 0
    text = capsys.readouterr().out
    assert "KAPLA: energy 162.82 mJ, latency 66.56 ms" in text
    clear_cache()
