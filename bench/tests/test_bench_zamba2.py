"""The published Zamba2's configuration, mixes and cells: the file as the
source publishes it but for ``reduced``, the program's configuration of
it at every published width, the counts of ``counts_zamba2.py`` against
hand counts, and a run of the cell on the CPU at a small size."""
import json

import pytest

from bench.harness import cells, counts, counts_zamba2
from bench.reference import zamba2

CFG = json.loads((cells.ROOT / "bench/configs/zamba2-7b-stage0.json")
                 .read_text())
#: every mechanism at a small size (``tests/test_torch_zamba2.py``'s)
TINY = {"hidden_size": 32, "attention_hidden_size": 64,
        "attention_head_dim": 16, "num_attention_heads": 4,
        "num_key_value_heads": 4, "intermediate_size": 48,
        "adapter_rank": 4, "mamba_d_state": 8, "mamba_headdim": 8,
        "num_hidden_layers": 7, "hybrid_layer_ids": [1, 3, 6],
        "vocab_size": 256}


def test_file_is_the_published_config_but_for_reduced():
    pub = CFG["published"]
    for k, v in pub.items():
        if k not in CFG["reduced"]:
            assert CFG[k] == v, k
    assert set(CFG["reduced"]) == set(CFG["changed"])
    assert CFG["num_hidden_layers"] == 20 and pub["num_hidden_layers"] == 81
    assert CFG["hybrid_layer_ids"] == [i for i in pub["hybrid_layer_ids"]
                                       if i < 20] == [6, 11, 17]
    assert CFG["layers_block_type"] == pub["layers_block_type"][:20]
    assert CFG["tie_word_embeddings"] is False
    for k in CFG["reduced"]:
        assert not k.endswith(("_dim", "_rank", "_size", "_state",
                               "_channels"))
    entry = next(c for c in cells.load_benchmark()["configs"]
                 if c["name"] == CFG["name"])
    assert entry["reduced"] == CFG["reduced"]
    assert entry["source"] == CFG["source"]


def test_program_config_has_every_published_width():
    from bench.drivers import train_zamba2
    cfg = train_zamba2.model_config(CFG)
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.attn_hidden) == (
        3584, 32, 224, 7168)
    assert (cfg.d_ff, cfg.adapter_rank, cfg.mlp_act) == (14336, 128, "gelu")
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups,
            cfg.conv_width) == (112, 64, 64, 2, 4)
    assert cfg.hybrid_layers == (6, 11, 17) and cfg.num_layers == 20
    assert cfg.num_mem_blocks == 2 and cfg.vocab_size == 32000
    # 2.52 B parameters on the chip
    assert 2.50e9 < cfg.param_count() < 2.53e9


@pytest.mark.parametrize("cell,driver,batch,seq", [
    ("zamba2-7b.train.1x4096", "train_zamba2", 1, 4096),
    ("mamba2-1.3b.train.2x2048", "train", 2, 2048)])
def test_mixes(cell, driver, batch, seq):
    c = cells.load_cell(cell)
    assert c.driver == driver
    assert (c.traffic["batch"], c.traffic["seq"]) == (batch, seq)
    assert c.traffic["reference_rows"] == 1
    assert c.traffic["vocab_limit"] <= c.config["vocab_size"]
    names = {m["name"] for m in c.per_layer}
    assert {"mfu.train", "elementwise_ms.train", "idle_share.train",
            "capture_s.train"} <= names
    assert ("flash_roofline.train" in names) == (driver == "train_zamba2")


def test_matmul_params_against_the_program():
    from bench.drivers import train_zamba2
    prog = train_zamba2.model_config(CFG)
    # a token's products: every weight matrix but the embedding's gather,
    # and each shared block once a site: blocks 0 (sites 6, 17), 1 (11)
    block = 3 * 7168 ** 2 + 7168 * 3584 + 3 * 3584 * 14336
    extra_use = block          # block 0 is used twice
    assert counts_zamba2.matmul_params(CFG) == pytest.approx(
        prog.param_count() - 32000 * 3584 + extra_use)
    # 38.5% of the products lie in the sites (1.053 of 2.735 B weights)
    sites = counts_zamba2.matmul_params(CFG) - 20 * (
        3584 * (2 * 7168 + 2 * 128 + 112) + 7168 * 3584) - 3584 * 32000
    assert sites / counts_zamba2.matmul_params(CFG) == pytest.approx(
        0.385, abs=0.002)


def test_forward_flops_hand_worked():
    cfg = dict(CFG, **TINY)
    k = zamba2.dims(cfg)
    d, di, H, GN = 32, 64, 8, 2 * 8
    mamba = d * (2 * di + 2 * GN + H) + di * d
    site = 3 * 64 * 64 + 64 * 32 + 32 * 96 + 48 * 32 + 32 * 4 + 4 * 96 \
        + 32 * 32
    assert counts_zamba2.matmul_params(cfg) == 7 * mamba + 3 * site \
        + 32 * 256
    # one chunk of 4 positions: per group C B^T, per head its product
    # with x, each head's state and its product with C
    tri = 4 * 5 / 2
    assert counts_zamba2.ssd_chunk_flops(cfg, 1, 4) == (
        2 * 2 * tri * 8 + 8 * 2 * tri * 8 + 2 * 4 * 8 * 8 * 8 * 2)
    # causal attention of 4 heads of 16 over 4 positions: q k^T and p v
    assert counts_zamba2.attention_flops(cfg, 1, 4) == 4 * 2 * 2 * 10 * 16
    f = counts_zamba2.forward_flops(cfg, 2, 256)
    assert f == (2 * counts_zamba2.matmul_params(cfg) * 512
                 + 7 * counts_zamba2.ssd_chunk_flops(cfg, 2, 256)
                 + 3 * counts_zamba2.attention_flops(cfg, 2, 256))
    assert counts_zamba2.train_step_flops(cfg, 2, 256) == 3 * f
    assert k["sites"] == 3


def test_step_flops_and_flash_bound_at_size():
    f = counts_zamba2.forward_flops(CFG, 1, 4096)
    assert 23.0e12 < f < 23.8e12           # ~23.4 TFLOP a forward
    ops, nbytes = counts_zamba2.flash_counts(CFG, 1, 4096)
    assert ops == 32 * 4 * 4096 * 4097 / 2 * 224
    assert nbytes == 4 * 32 * 4096 * 224 * 2 + 4 * 32 * 4096
    p = counts.peaks()
    assert counts_zamba2.flash_bound_s(CFG, 1, 4096) == max(
        ops / p["bf16_flops_s"], nbytes / p["hbm_bytes_s"])


def test_readers_of_the_new_metrics():
    rec = {"trace": {"steps": 2, "flash_wgmma_s": 6e-3},
           "bounds": {"flash_calls_per_step": 3, "flash_s": 0.5e-3},
           "marks": {"shared_ms": 123.0}}
    read = {m: cells.metric_reader(m).read
            for m in ("flash_roofline.train", "shared_ms.train")}
    assert read["flash_roofline.train"](rec) == pytest.approx(50.0)
    assert read["shared_ms.train"](rec) == 123.0
    for r in read.values():
        assert r({}) is None
    assert read["flash_roofline.train"]({"trace": {"steps": 2},
                                         "bounds": {}}) is None


def test_cell_runs_on_the_cpu(capsys):
    """The cell's driver end to end at the small size, float32 (the limits
    are the bf16 model's): correct, and a result line."""
    from bench.harness import runner
    real = cells.load_cell

    def load_cell(cell, root=cells.ROOT, benchmark=None):
        c = real(cell, root, benchmark)
        c.traffic = dict(c.traffic, batch=2, seq=256, vocab_limit=256)
        return c
    cells.load_cell = load_cell
    try:
        rc = runner.main(["--workload", "zamba2-7b.train.1x4096", "--seed",
                          str(2 ** 31 + 9), "--seconds", "0.3", "--trace",
                          "0"], require_device=False, device="cpu",
                         overrides=dict(TINY, dtype="float32"))
    finally:
        cells.load_cell = real
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["train_tokens_per_s"]


def test_control_separates_on_the_cpu():
    """The fp8 control and each fault break one of the cell's limits at
    the small size on the CPU."""
    from bench import control_zamba2
    real = cells.load_cell

    def load_cell(cell, root=cells.ROOT, benchmark=None):
        c = real(cell, root, benchmark)
        c.traffic = dict(c.traffic, batch=2, seq=256, vocab_limit=256)
        return c
    cells.load_cell = load_cell
    try:
        got = control_zamba2.main(["--workload", "zamba2-7b.train.1x4096",
                                   "--seeds", "7"], require_device=False,
                                  device="cpu", overrides=TINY)[0]
    finally:
        cells.load_cell = real
    limits = cells.load_cell("zamba2-7b.train.1x4096").limits
    assert any(got["control"][k] > limits[k] for k in limits), got
    for fault, numbers in got["faults"].items():
        assert any(numbers[k] > limits[k] for k in limits), fault
