"""The NCCL launcher of the partitioned programs (``launch/partition.py``
``run_ranks``, ``rank_device``, ``rank_env``, ``load_result``) and the
count of collectives staged through the host (``models/shards.py``
``HOST_STAGED``), without spawning a process: an NCCL group of more
ranks than cards is refused before anything starts, rank r is bound to
card r, the ranks' environment puts gloo's and NCCL's bootstrap on the
loopback device, and a rank's result saved on a card loads onto the CPU.
``chip_smoke.py``'s readers of an NCCL run (its log, the bus bandwidth)
and its profile groups are held against hand-made inputs.  The ``gpu``
cases open one-rank groups in this process on the card: gloo stages a
CUDA tensor's collective through the host, counts it and makes
device-to-host copies a profile sees; NCCL stages nothing and copies
nothing to the host."""
import importlib.util
import os
from pathlib import Path

import pytest
import torch

from repro_torch.launch import partition as pt
from repro_torch.launch.mesh import Mesh, fake_group
from repro_torch.launch.steps import OPTIMIZER_SPAN
from repro_torch.models import shards
from repro_torch.models.shards import Shards

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_spawn(monkeypatch):
    """``run_ranks`` may start no process."""
    def popen(*a, **k):
        raise AssertionError("a rank's process was started")
    monkeypatch.setattr(pt.subprocess, "Popen", popen)


@pytest.mark.parametrize("cards", [None, 0, 2, 3])
def test_nccl_group_larger_than_the_cards_raises_before_spawning(
        monkeypatch, no_spawn, cards):
    """``None``: this host as it is (no card here)."""
    if cards is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    elif torch.cuda.device_count() >= 4:
        pytest.skip("this host has 4 cards")
    with pytest.raises(RuntimeError, match="an NCCL group of 4 ranks needs "
                       "4 cards"):
        pt.run_ranks("nowhere:nothing", 4, "nccl", timeout=5)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_rank_r_is_bound_to_card_r(monkeypatch, world):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [pt.rank_device(r, world) for r in range(world)] == [
        torch.device("cuda", r) for r in range(world)]
    with pytest.raises(ValueError):
        pt.rank_device(world, world)


def test_rank_device_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pt.rank_device(0, 1) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        pt.rank_device(0, 2)


def test_rank_env_puts_the_bootstrap_on_loopback(monkeypatch):
    for k in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PYTHONPATH", "elsewhere")
    env = pt.rank_env({"NCCL_DEBUG": "INFO"})
    assert env["NCCL_SOCKET_IFNAME"] == "lo"
    assert env["GLOO_SOCKET_IFNAME"] == "lo"
    assert env["NCCL_DEBUG"] == "INFO"
    assert env["PYTHONPATH"].split(os.pathsep) == [
        str(ROOT / "src"), "elsewhere"]


def test_rank_env_keeps_an_interface_the_caller_set(monkeypatch):
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "eth7")
    env = pt.rank_env({"GLOO_SOCKET_IFNAME": "eth8"})
    assert (env["NCCL_SOCKET_IFNAME"], env["GLOO_SOCKET_IFNAME"]) == (
        "eth7", "eth8")


def test_a_result_saved_on_card_3_loads_onto_the_cpu(monkeypatch, tmp_path):
    """The file is written as a rank on card 3 writes it (its storages
    tagged ``cuda:3``); ``load_result`` restores them on the CPU."""
    import torch.serialization as ser
    monkeypatch.setattr(ser, "_package_registry", list(ser._package_registry))
    ser.register_package(0, lambda obj: "cuda:3", lambda obj, loc: None)
    want = {"logits": torch.arange(6.0).reshape(2, 3), "n": 4}
    torch.save(want, tmp_path / "out0.pt")
    monkeypatch.setattr(ser, "_package_registry",
                        [p for p in ser._package_registry if p[0] != 0])
    assert b"cuda:3" in (tmp_path / "out0.pt").read_bytes()
    got = pt.load_result(tmp_path / "out0.pt")
    assert got["logits"].device == torch.device("cpu")
    assert torch.equal(got["logits"], want["logits"]) and got["n"] == 4


def test_host_staged_count_stays_zero_under_the_fake_group():
    shards.HOST_STAGED = 0
    with fake_group(4, 1):
        from repro_torch.launch.mesh import device_mesh
        sh = Shards(device_mesh(Mesh((2, 2), ("data", "model")), "cpu"))
        x = torch.ones(4, 6)
        sh.all_reduce(x)
        sh.all_gather(x, 0, ("data", "model"))
        sh.reduce_scatter(x, 0, ("model",))
        sh.all_reduce(x, ("data",), "max")
    assert shards.HOST_STAGED == 0


@pytest.mark.parametrize("kind,nbytes,n,ms,want", [
    ("all-reduce", 1e9, 2, 10.0, 100.0),       # 2 (n-1)/n x 1 GB / 10 ms
    ("all-reduce", 1e9, 4, 10.0, 150.0),
    ("all-gather", 1e9, 2, 10.0, 50.0),        # (n-1)/n x the result
    ("reduce-scatter", 0.5e9, 2, 10.0, 50.0),  # (n-1)/n x n x the result
    ("reduce-scatter", 0.25e9, 4, 10.0, 75.0),
    ("all-to-all", 1e9, 2, 10.0, None),
    ("all-reduce", 1e9, 2, 0.0, None)])
def test_bus_bandwidth_follows_nccl_tests(kind, nbytes, n, ms, want):
    got = _chip_smoke().bus_gb_s(kind, nbytes, n, ms)
    assert got == pytest.approx(want) if want is not None else got is None


NCCL_LOG = """\
h:10:10 [2] NCCL INFO Bootstrap : Using lo:127.0.0.1<0>
h:10:10 [2] NCCL INFO NCCL version 2.21.5+cuda12.4
h:10:31 [2] NCCL INFO Channel 00/0 : 2[2] -> 3[3] via P2P/CUMEM/read
h:10:31 [2] NCCL INFO Channel 01/0 : 2[2] -> 3[3] via P2P/CUMEM/read
h:10:31 [2] NCCL INFO Channel 00/0 : 2[2] -> 0[0] via SHM/direct/direct
h:10:31 [2] NCCL INFO comm 0x55 rank 2 nranks 4 cudaDev 2 nvmlDev 2 \
busId 1a000 commId 0x9 - Init COMPLETE
h:10:10 [2] NCCL WARN NVLS multicast support is not available
a torch warning of its own
"""


def test_nccl_log_reader(tmp_path):
    (tmp_path / "r.log").write_text(NCCL_LOG)
    got = _chip_smoke().nccl_log(tmp_path / "r.log")
    assert got["version"] == "2.21.5+cuda12.4"
    assert got["transports"] == {"P2P/CUMEM/read": 2,
                                 "SHM/direct/direct": 1}
    assert got["cuda_devs"] == [2]
    assert got["lines"] == 7 and got["nvls_lines"] == 1
    assert len(got["warnings"]) == 1
    assert _chip_smoke().nccl_log(tmp_path / "none.log")["version"] is None


@pytest.mark.parametrize("name,kind", [
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage)",
     "all-reduce"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", "all-gather"),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", "reduce-scatter"),
    ("ncclDevKernel_SendRecv", "other"),
    ("flash_wgmma_kernel<128>", None)])
def test_nccl_kernel_kind(name, kind):
    assert _chip_smoke().nccl_kind(name) == kind


@pytest.mark.parametrize("name,group", [
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage)",
     "nccl"),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", "nccl"),
    ("Memcpy DtoH (Device -> Pageable)", "memcpy"),
    ("nvjet_tst_128x192_64x5_2x1_v_bz_coopB_NNN", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "other")])
def test_kernel_group_keeps_nccl_apart(name, group):
    assert _chip_smoke().kernel_group(name) == group


class _Avg:
    """One row of a profile's ``key_averages()``."""

    def __init__(self, key, us, count=1, device="DeviceType.CUDA"):
        self.key, self.self_device_time_total = key, us
        self.count, self.device_type = count, device


class _Event:
    """A host event of a profile's ``events()`` and the kernels launched
    under it."""

    def __init__(self, name, kernels=(), children=()):
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import Kernel
        self.name, self.device_type = name, DeviceType.CPU
        self.kernels = [Kernel(n, 0, us) for n, us in kernels]
        self.cpu_children = list(children)


class _Profile:
    def __init__(self, averages, events):
        self._averages, self._events = averages, events

    def key_averages(self):
        return self._averages

    def events(self):
        return self._events


AR = "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
RS = "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL"
EW = "void at::native::vectorized_elementwise_kernel<4>"
GEMM = "nvjet_tst_128x192_64x5_2x1_v_bz_coopB_NNN"


def test_train_groups_count_each_kernel_once():
    """The optimizer's range launches an elementwise kernel, a matmul and
    two NCCL kernels (its ZeRO reduce-scatter, a data-axis all-reduce);
    the backward launches more of each outside it.  NCCL's kernels stay
    in ``nccl`` wherever they ran, the optimizer's others move to
    ``optimizer``, and the groups add up to the busy time."""
    optimizer = _Event(OPTIMIZER_SPAN, [(EW, 3000.0)], [
        _Event("aten::mm", [(GEMM, 1000.0)]),
        _Event("_c10d_functional::all_reduce", [(AR, 4000.0)]),
        _Event("_c10d_functional::reduce_scatter_tensor", [(RS, 2000.0)])])
    prof = _Profile([
        _Avg(EW, 10000.0, 5), _Avg(GEMM, 8000.0, 2), _Avg(AR, 9000.0, 3),
        _Avg(RS, 2000.0), _Avg(OPTIMIZER_SPAN, 7777.0),
        _Avg("aten::mm", 50.0, device="DeviceType.CPU")],
        [_Event("forward"), optimizer])
    got = _chip_smoke()._train_groups(prof, 100.0)
    assert got["device_ms"] == pytest.approx({
        "other": 7.0, "matmul": 7.0, "nccl": 11.0, "optimizer": 4.0})
    assert sum(got["device_ms"].values()) == pytest.approx(29.0)
    assert got["device_busy_ms"] == pytest.approx(29.0)
    assert got["device_kernels"] == 11
    assert got["idle_share"] == pytest.approx(0.71)


def test_dtoh_copies_counts_device_to_host_copies_alone():
    prof = _Profile([
        _Avg("Memcpy DtoH (Device -> Pageable)", 40.0, 6),
        _Avg("Memcpy HtoD (Pageable -> Device)", 40.0, 5),
        _Avg("Memcpy DtoD (Device -> Device)", 40.0, 4),
        _Avg("Memcpy DtoH (Device -> Pageable)", 0.0, 3,
             device="DeviceType.CPU"), _Avg(AR, 9.0)], [])
    assert _chip_smoke().dtoh_copies(prof) == 6


@pytest.mark.parametrize("mesh,n", [((1, 4), 4), ((2, 2), 2), ((4, 1), 4),
                                    ((1, 1), 1)])
def test_every_collective_runs_over_groups_of_one_size(mesh, n):
    assert _chip_smoke().issuing_size(mesh) == n


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a group on the card)")
    return torch.device("cuda", 0)


def _one_rank_group(backend, tmp_path, **kw):
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1, **kw)
    return dist.group.WORLD


def _profiled_dtoh(fn):
    """``fn()`` under ``torch.profiler`` and the device-to-host copies it
    made, as ``chip_smoke.py`` reads them off rank 0's profiles."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, _chip_smoke().dtoh_copies(prof)


@pytest.mark.gpu
def test_gloo_stages_a_cuda_tensor_through_the_host_and_counts_it(
        tmp_path, monkeypatch):
    import torch.distributed as dist
    dev = _card()
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    group = _one_rank_group("gloo", tmp_path)
    try:
        shards.HOST_STAGED = 0
        x = torch.arange(8.0, device=dev)
        y, copies = _profiled_dtoh(
            lambda: shards._all_reduce(x, group))  # a group of 1 issues it
        assert y.device == dev and torch.equal(y, x)
        assert shards.HOST_STAGED == 1 and copies >= 1
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_stages_nothing(tmp_path, monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh
    dev = _card()
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(dev)
    group = _one_rank_group("nccl", tmp_path, device_id=dev)
    try:
        shards.HOST_STAGED = 0
        x = torch.arange(8.0, device=dev)
        y, copies = _profiled_dtoh(lambda: shards._all_gather(
            shards._all_reduce(x, group), 0, group))
        assert torch.equal(y, x) and shards.HOST_STAGED == 0
        assert copies == 0
        sh = Shards(device_mesh(Mesh((1, 1), ("data", "model"))))
        assert sh.size == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()
