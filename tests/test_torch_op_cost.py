"""The op-level counter (``repro_torch.launch.op_cost``): the reference's
``tests/test_hlo_cost.py`` cases in the port's terms, the hand kernels'
formulas against brute-force enumeration, meta against CPU counts of whole
steps, the peak of a known allocation sequence, and a tiny dense prefill
against the reference's ``analyze_hlo``."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.steps import build_prefill_step as ref_prefill_step
from repro.launch.train import tiny_config as ref_tiny_config
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan
from repro_torch.launch.op_cost import (OpCounter, analyze_step,
                                        attention_pairs, flash_bytes,
                                        flash_ops, ssd_bytes, ssd_ops)
from repro_torch.launch.steps import (build_prefill_step, build_train_step,
                                      input_structs)
from repro_torch.launch.train import tiny_config
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import make_optimizer


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# tests/test_hlo_cost.py in the port's terms
# ---------------------------------------------------------------------------

def test_dot_flops_exact_single():
    a, b = _meta(64, 128), _meta(128, 32)
    assert analyze_step(lambda a, b: a @ b, a, b).flops == 2 * 64 * 128 * 32


def _layers(h, ws, n):
    for i in range(n):
        h = torch.tanh(h @ ws[i])
    return h


def test_loop_of_8_counts_8_times():
    """The counterpart of the reference's scan: an eager loop dispatches
    every iteration, so no trip count is needed."""
    x, ws = _meta(128, 256), _meta(8, 256, 256)
    one = analyze_step(_layers, x, ws, 1).flops
    eight = analyze_step(_layers, x, ws, 8).flops
    assert eight == 8 * one == 8 * (2 * 128 * 256 * 256 + 128 * 256)
    expected = 2 * 128 * 256 * 256 * 8     # the reference's dot-only count
    assert abs(eight - expected) / expected < 0.02


def test_nested_loops_multiply():
    def nested(x):
        h = x
        for _ in range(3):
            for _ in range(4):
                h = torch.tanh(h @ h)
        return h
    flops = analyze_step(nested, _meta(32, 32)).flops
    expected = 2 * 32 * 32 * 32 * 12      # 3 x 4 dots
    assert flops == expected + 32 * 32 * 12
    assert abs(flops - expected) / expected < 0.05


def test_bytes_reasonable_for_elementwise():
    b = analyze_step(lambda x: x + 1.0, _meta(1024, 1024)).bytes
    assert b == 2 * 1024 * 1024 * 4       # read + write
    assert 4e6 < b < 4e7


def test_eager_loop_and_unrolled_agree():
    x, ws = _meta(128, 256), _meta(4, 256, 256)

    def unrolled(h, ws):
        h = torch.tanh(h @ ws[0])
        h = torch.tanh(h @ ws[1])
        h = torch.tanh(h @ ws[2])
        return torch.tanh(h @ ws[3])
    loop = analyze_step(_layers, x, ws, 4)
    unr = analyze_step(unrolled, x, ws)
    assert (loop.flops, loop.bytes, loop.ops) == \
        (unr.flops, unr.bytes, unr.ops)


def test_views_are_free_and_copies_move_bytes():
    x = _meta(64, 32)
    view = analyze_step(lambda x: x.t().reshape(32, 64)[1:], x)
    assert (view.flops, view.bytes) == (0, 0)
    copy = analyze_step(lambda x: x.t().contiguous(), x)
    assert (copy.flops, copy.bytes) == (0, 2 * 64 * 32 * 4)
    rows = torch.empty(10, dtype=torch.long, device="meta")
    gather = analyze_step(lambda x, i: x[i], x, rows)
    assert (gather.flops, gather.bytes) == (0, 2 * 10 * 32 * 4)


def test_convolution_counts_its_window():
    x = _meta(2, 6, 10, 10)
    w = _meta(8, 3, 3, 3)                 # groups 2: 3 input channels each
    c = analyze_step(lambda x, w: torch.nn.functional.conv2d(
        x, w, groups=2), x, w)
    assert c.flops == 2 * (2 * 8 * 8 * 8) * (3 * 3 * 3)
    assert c.bytes == 4 * (x.numel() + w.numel() + 2 * 8 * 8 * 8)


# ---------------------------------------------------------------------------
# the hand kernels' formulas
# ---------------------------------------------------------------------------

def _pairs_brute(Sq, Sk, causal, window):
    n = 0
    for r in range(Sq):
        for c in range(Sk):
            qpos = r + Sk - Sq
            if causal and c > qpos:
                continue
            if window > 0 and c <= qpos - window:
                continue
            n += 1
    return n


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, 0), (37, 100, True, 0), (100, 100, False, 0),
    (90, 90, True, 16), (20, 75, True, 8), (50, 50, False, 7)])
def test_flash_formula_against_enumeration(Sq, Sk, causal, window):
    pairs = _pairs_brute(Sq, Sk, causal, window)
    assert attention_pairs(Sq, Sk, causal, window) == pairs
    # the plain version's own tile masks agree
    tiles = sum(int(fa._mask(q0, min(fa.BLOCK_Q, Sq - q0), k0,
                             min(fa.BLOCK_K, Sk - k0), Sk - Sq, causal,
                             window, "cpu").sum())
                for q0 in range(0, Sq, fa.BLOCK_Q)
                for k0 in range(0, Sk, fa.BLOCK_K))
    assert tiles == pairs
    B, H, KV, D = 2, 4, 2, 16
    assert flash_ops(B, H, Sq, Sk, D, causal, window) == \
        B * H * pairs * 2 * (2 * D)       # QKᵀ and PV: D MACs each
    q = torch.zeros((B, H, Sq, D), dtype=torch.bfloat16)
    k = torch.zeros((B, KV, Sk, D), dtype=torch.bfloat16)
    out, lse = fa.flash_attention(q, k, k.clone(), causal, window,
                                  return_lse=True)
    assert flash_bytes(B, H, KV, Sq, Sk, D, 2) == \
        2 * q.nbytes + 2 * k.nbytes == q.nbytes + out.nbytes + 2 * k.nbytes
    assert flash_bytes(B, H, KV, Sq, Sk, D, 2, lse=True) == \
        flash_bytes(B, H, KV, Sq, Sk, D, 2) + lse.nbytes


@pytest.mark.parametrize("B,H,NC,Lc,P,N", [(1, 2, 3, 5, 4, 3),
                                           (2, 3, 2, 8, 6, 4)])
def test_ssd_formula_against_enumeration(B, H, NC, Lc, P, N):
    macs = 0
    for _ in range(B):
        for _ in range(NC):
            for l in range(Lc):
                for m in range(l + 1):
                    macs += N                 # (C Bᵀ)[l, m], once a chunk
                    macs += H * P             # its decayed product with x
    assert ssd_ops(B, H, NC, Lc, P, N) == 2 * macs
    x = torch.zeros((B, H, NC, Lc, P), dtype=torch.bfloat16)
    dt = torch.zeros((B, H, NC, Lc))
    b = torch.zeros((B, NC, Lc, N))
    y = ssd_scan.ssd_intra_chunk(x, dt, dt.clone(), b, b.clone())
    assert ssd_bytes(B, H, NC, Lc, P, N, 2) == \
        x.nbytes + y.nbytes + 2 * dt.nbytes + 2 * b.nbytes


def test_kernel_call_is_one_unit_on_cpu_and_meta():
    """A wrapper's call counts its formula, not the plain version's
    ops, on the CPU as on meta."""
    counts = {}
    for dev in ("cpu", "meta"):
        q = torch.zeros((1, 4, 96, 32), device=dev)
        k = torch.zeros((1, 2, 96, 32), device=dev)
        c = analyze_step(lambda q, k: fa.flash_attention(q, k, k, True, 0),
                         q, k)
        counts[dev] = (c.flops, c.bytes, c.ops, c.kernel_units)
    assert counts["cpu"] == counts["meta"] == (
        flash_ops(1, 4, 96, 96, 32, True, 0),
        flash_bytes(1, 4, 2, 96, 96, 32, 4), 0, {"flash_attention": 1})


# ---------------------------------------------------------------------------
# whole steps: meta against CPU
# ---------------------------------------------------------------------------

def _step_count(arch, mode, dev, remat="none"):
    cfg = dataclasses.replace(tiny_config(get_config(arch)), remat=remat)
    train = mode == "train"
    api = build_model(cfg, device=dev, dtype=torch.float32, trainable=train)
    params = api.init(0)
    shape = ShapeConfig(mode, 64, 2, mode)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in input_structs(cfg, shape).items()}
    if train:
        opt = make_optimizer(cfg.optimizer)
        return analyze_step(build_train_step(api, opt), params,
                            opt.init(dict(params.named_parameters())), batch)
    return analyze_step(build_prefill_step(api, 64), params, batch["inputs"])


@pytest.mark.parametrize("mode", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b",
                                  "qwen2-moe-a2.7b"])
def test_meta_counts_equal_cpu_counts(arch, mode):
    cpu = _step_count(arch, mode, "cpu")
    meta = _step_count(arch, mode, "meta")
    assert cpu.flops > 0 and cpu.kernel_units
    assert (meta.flops, meta.bytes, meta.peak_bytes, meta.ops,
            meta.kernel_units) == (cpu.flops, cpu.bytes, cpu.peak_bytes,
                                   cpu.ops, cpu.kernel_units)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b",
                                  "qwen2-moe-a2.7b"])
def test_meta_counts_equal_cpu_counts_with_remat(arch):
    """``remat="block"``, as the dry-run traces train cells: the backward
    recomputes each block, its kernel calls counted again."""
    cpu = _step_count(arch, "train", "cpu", "block")
    meta = _step_count(arch, "train", "meta", "block")
    plain = _step_count(arch, "train", "meta")
    assert sum(meta.kernel_units.values()) > sum(plain.kernel_units.values())
    assert meta.flops > plain.flops
    assert (meta.flops, meta.bytes, meta.peak_bytes, meta.ops,
            meta.kernel_units) == (cpu.flops, cpu.bytes, cpu.peak_bytes,
                                   cpu.ops, cpu.kernel_units)


def test_peak_of_known_allocations():
    x = torch.zeros(1000)                     # 4000 B, held from the start

    def steps(x):
        y = x * 2                             # +4000: 8000
        z = y + 1                             # +4000: 12000 (the peak)
        del y                                 # -4000
        w = z * 3                             # +4000: 12000
        v = w.view(10, 100)                   # a view: nothing new
        z.add_(1)                             # in place: nothing new
        return v                              # z freed: 8000
    with OpCounter("cpu") as c:
        c.hold(x)
        out = steps(x)
        assert c.live_bytes == 8000
    assert c.cost().peak_bytes == 12000
    assert c.cost().held_bytes == 4000        # the argument's part
    del out
    assert c.live_bytes == 4000               # only x is left


def test_by_op_splits_the_totals():
    a, b = _meta(64, 128), _meta(128, 32)
    q = _meta(1, 4, 96, 32)
    c = analyze_step(lambda a, b, q: (torch.tanh(a @ b) + 1,
                                      fa.flash_attention(q, q, q)), a, b, q)
    assert set(c.by_op) == {"mm", "tanh", "add", "flash_attention"}
    assert c.by_op["mm"] == [2 * 64 * 128 * 32, 4 * (64 * 128 + 128 * 32
                                                     + 64 * 32)]
    assert c.by_op["flash_attention"] == [
        flash_ops(1, 4, 96, 96, 32, True, 0),
        flash_bytes(1, 4, 4, 96, 96, 32, 4)]
    assert sum(f for f, _ in c.by_op.values()) == c.flops
    assert sum(b for _, b in c.by_op.values()) == c.bytes


def test_copying_reshape_is_free_and_kept_apart():
    """``reshape`` of a non-contiguous tensor dispatches ``clone`` then
    ``_unsafe_view``: the pair counts as one free view (``t``, the view and
    ``mul`` make three ops), its bytes go to
    ``free_copy_bytes`` and nowhere else."""
    x = _meta(64, 32)
    c = analyze_step(lambda x: x.t().reshape(-1) * 2, x)
    assert (c.ops, c.flops, c.bytes) == (3, 64 * 32, 2 * 4 * 64 * 32)
    assert c.free_copy_bytes == 2 * 4 * 64 * 32
    assert c.by_op == {"clone": [0, 0], "mul": [64 * 32, 2 * 4 * 64 * 32]}


def test_tiny_dense_prefill_against_reference_hlo_count():
    """The reference's jnp attention computes (and its HLO counts) every
    query-key pair, masked or not: 4 B H D S² per layer; the port counts
    the kernel's unmasked pairs.  With that difference added back, the
    two counts agree within 5% (the rest: elementwise ops that XLA fuses
    or rewrites)."""
    B, S = 2, 128
    rcfg = ref_tiny_config(ref_get_config("qwen2.5-3b"))
    rapi = ref_build_model(rcfg, dtype=jnp.float32)
    rparams = jax.eval_shape(rapi.init, jax.random.PRNGKey(0))
    hlo = jax.jit(ref_prefill_step(rapi, S)).lower(
        rparams, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().as_text()
    ref = analyze_hlo(hlo).flops
    cfg = tiny_config(get_config("qwen2.5-3b"))
    api = build_model(cfg, device="meta", dtype=torch.float32)
    port = analyze_step(build_prefill_step(api, S), api.init(0),
                        torch.empty((B, S), dtype=torch.int32,
                                    device="meta")).flops
    masked = 4 * B * cfg.num_heads * cfg.head_dim * cfg.num_layers \
        * (S * S - attention_pairs(S, S, True, 0))
    assert port < ref
    assert abs(port + masked - ref) / ref < 0.05
