"""Operations and bytes counted from shapes, against hand-worked
numbers and against the program's own parameter count."""
import json

import pytest

from bench.harness import cells, counts
from bench.reference import resnet

CFG_NET = json.loads((cells.ROOT / "bench/configs/resnet50-b64-16x16.json")
                     .read_text())
CFG_LM = json.loads((cells.ROOT / "bench/configs/mamba2-1.3b.json")
                    .read_text())


def test_conv_counts_hand_worked():
    # 3x3 conv, stride 1, 2 images, 4 -> 8 channels, 5x5 output: the
    # input read at 7x7
    layer = {"kind": "conv", "N": 2, "C": 4, "K": 8, "X": 5, "Y": 5,
             "R": 3, "S": 3, "stride": 1}
    ops, nbytes = counts.conv_counts(layer)
    assert ops == 2 * 2 * 8 * 4 * 5 * 5 * 9
    assert nbytes == 4 * (2 * 4 * 7 * 7 + 8 * 4 * 9 + 2 * 8 * 5 * 5)
    # bound: the larger of the two
    assert counts.bound_s(ops, nbytes, 1e9, 1e6) == pytest.approx(
        max(ops / 1e9, nbytes / 1e6))


def test_resnet50_forward_operations():
    # conv1 alone: 64 images, 3 -> 64 channels, 112 x 112, 7 x 7
    conv1 = resnet.layers(CFG_NET)[0]
    assert counts.conv_counts(conv1)[0] == 2 * 64 * 64 * 3 * 112 * 112 * 49
    # He et al. give ~3.8 GFLOPs (multiply-adds) an image for ResNet-50
    per_image = counts.network_flops(CFG_NET) / 2 / 64
    assert 3.8e9 < per_image < 4.3e9
    bound = counts.conv_bound_s(CFG_NET, 165e12, 3.35e12)
    assert 3.0e-3 < bound < 3.5e-3


def test_mamba2_parameters_against_the_program():
    from repro_torch.configs import get_config
    from bench.drivers import _lm
    prog = _lm.model_config(CFG_LM)
    d, V = CFG_LM["d_model"], 50432
    # the program counts the embedding and the head; a token's products
    # skip the embedding's gather
    assert counts.matmul_params(CFG_LM) == pytest.approx(
        prog.param_count() - V * d, rel=1e-3)
    assert get_config(CFG_LM["arch"]).family == "ssm"


def test_scan_hand_worked():
    cfg = dict(CFG_LM, d_model=8, ssm_head_dim=4, ssm_state=2)
    # one chunk of 4 positions, 4 heads of 4, N 2: the causal C B^T, its
    # product with the inputs, the chunk's state and its product with C
    tri = 4 * 5 / 2
    assert counts.ssd_chunk_flops(cfg, 1, 4) == (
        2 * tri * 2 + 4 * 2 * tri * 4 + 2 * 4 * 4 * 4 * 2 * 2)
    # 2 sequences of 256 positions: 2 chunks of 128 each
    tri = 128 * 129 / 2
    assert counts.ssd_chunk_flops(cfg, 2, 256) == 2 * 2 * (
        2 * tri * 2 + 4 * 2 * tri * 4 + 2 * 128 * 4 * 4 * 2 * 2)


def test_train_totals():
    f = counts.forward_flops(CFG_LM, 8, 512)
    assert counts.train_step_flops(CFG_LM, 8, 512) == 3 * f
    # products by the weights dominate at 512 tokens
    assert 2 * counts.matmul_params(CFG_LM) * 4096 / f > 0.9
    # ~1.4e9 weights in products
    assert 1.3e9 < counts.matmul_params(CFG_LM) < 1.5e9
