"""The window's arithmetic on synthetic records: a rate is all the work
over all the window's time, a stall included; the device's busy time is
the union of its operations."""
import pytest

from bench.harness import cells, profile


def read(metric, rec):
    return cells.metric_reader(metric).read(rec)


def test_rates_take_all_work_over_all_time():
    # 9 steps of 0.5 s and one stalled step of 5.5 s: the window is 10 s
    rec = {"train": {"steps": 10, "window_s": 10.0, "chips": 1,
                     "flops_per_step": 1e13, "peak_flops_s": 1e15}}
    assert read("mfu.train", rec) == pytest.approx(100 * 10 * 1e13 / 10 / 1e15)
    rec["train"]["chips"] = 4
    assert read("mfu.train", rec) == pytest.approx(100 * 1e13 / 1e15 / 4)
    net = {"net": {"passes": 100, "window_s": 4.0, "flops_per_pass": 5e11},
           "bounds": {"flops_s": 1.65e14, "conv_s": 3e-3}}
    assert read("mfu.net", net) == pytest.approx(100 * 100 * 5e11 / 4 / 1.65e14)


def test_readers_find_nothing_to_read():
    for m in ("mfu.net", "conv_roofline", "idle_share.net", "mfu.train",
              "elementwise_ms.train", "idle_share.train"):
        assert read(m, {}) is None, m
    # a kernel that never ran gives no roofline, never 0
    rec = {"trace": {"by_group": {"matmul": 1.0}, "passes": 2},
           "bounds": {"conv_s": 1e-3}}
    assert read("conv_roofline", rec) is None


def _trace():
    ms = 1_000_000
    ops = [("conv_kernel<1,2>", 0, 0 * ms, 10 * ms),
           ("gemm_a", 0, 5 * ms, 10 * ms),            # overlaps the first
           ("eltwise", 0, 20 * ms, 5 * ms),           # 5 ms gap before
           ("nccl:all_reduce", 0, 60 * ms, 10 * ms),  # 35 ms stall before
           ("memcpy DtoD", 1, 0, 30 * ms)]
    host = [("step", 0, 80 * ms), ("cudaStreamSynchronize", 26 * ms, 59 * ms),
            ("aten::mm", 4 * ms, 6 * ms)]
    return profile.Trace(0.1, ops, host, (0, 1))


def test_busy_is_the_union_per_card():
    t = _trace()
    assert t.intervals(0) == [(0, 15_000_000), (20_000_000, 25_000_000),
                              (60_000_000, 70_000_000)]
    assert t.busy_s() == pytest.approx((0.030 + 0.030) / 2)
    g = t.seconds_by_group()
    assert g["conv"] == pytest.approx(0.010)
    assert g["matmul"] == pytest.approx(0.010)
    assert g["nccl"] == pytest.approx(0.010)
    assert g["memcpy"] == pytest.approx(0.030)


def test_idle_gaps_named_by_the_host():
    gaps = _trace().idle_gaps()
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[0][1] == pytest.approx(0.035)
    assert gaps[1][0] == "step" and gaps[1][1] == pytest.approx(0.005)
    s = profile.summary(_trace())
    rec = {"trace": dict(s, steps=1)}
    assert read("idle_share.train", rec) == pytest.approx(
        100 * (1 - s["busy_s"] / 0.1))
    # conv 10, eltwise 5 and the copies 30: all but matmul and NCCL
    assert read("elementwise_ms.train", rec) == pytest.approx(45.0)


def test_groups():
    assert profile.group("void flash_wgmma_kernel<64>") == "flash_attention"
    assert profile.group("ssd_intra_kernel<float>") == "ssd_intra_chunk"
    assert profile.group("void (anonymous namespace)::conv_kernel<2, 2>"
                         ) == "conv"
    assert profile.group("nvjet_tst_64x32") == "matmul"
    assert profile.group("ncclDevKernel_AllReduce_Sum_bf16") == "nccl"
    assert profile.group("Memcpy DtoD (Device -> Device)") == "memcpy"
    assert profile.group("vectorized_elementwise_kernel<4>") == "other"
