"""Where the port runs: the card unless the caller passes ``device="cpu"``,
never a quiet fallback; the CUDA build raises a clear error without nvcc;
the CPU path launches no kernel.  The card-only test is marked ``gpu``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.solver import solve
from repro_torch.core.solver.intralayer import Constraints, solve_intra_layer
from repro_torch.hw.presets import eyeriss_multinode
from repro_torch.kernels import backend
from repro_torch.lower import (LAUNCHES, lower_network, lower_scheme,
                               make_network_inputs, network_runner,
                               plan_runner, reset_launch_counts,
                               verify_network)
from repro_torch.lower import exec as tex
from repro_torch.workloads.layers import attention, conv, eltwise, fc, pool
from repro_torch.workloads.nets import get_net

HW = eyeriss_multinode(nodes=4, pe=8)


def _plan(layer, order=None):
    scheme, cost = solve_intra_layer(layer, HW,
                                     Constraints(nodes=HW.node_array))
    assert scheme is not None and cost.valid
    if order:
        scheme.levels[-1].order = order
    plan = lower_scheme(scheme, HW)
    assert plan.valid, plan.reason
    return plan


def _mlp_plan():
    net = get_net("mlp", batch=4)
    return lower_network(solve(net, HW), net, HW)


def test_entry_points_raise_without_card_and_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    plan = _plan(fc("d.fc", 8, 64, 64))
    nplan = _mlp_plan()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_runner(plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network_runner(nplan, make_network_inputs(nplan, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_network_inputs(nplan)
    assert backend.resolve_device("cpu").type == "cpu"
    assert backend.resolve_device("meta").type == "meta"   # shapes only
    with pytest.raises(ValueError, match="unsupported device"):
        backend.resolve_device("xpu")


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(backend, "CUDA_HOMES", ())
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        backend.build()
    monkeypatch.setattr(backend, "_libs", {})
    for source in (backend.SOURCE, backend.MODEL_SOURCE):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            backend.build(source)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            backend.library(source)
    assert not (tmp_path / "build").exists() or \
        not any((tmp_path / "build").rglob("*.so"))


def test_build_key_covers_the_shared_header(monkeypatch, tmp_path):
    """Both sources include csrc/online_softmax.cuh, so an edit there must
    rebuild both libraries, and an edit to one source only that one."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(backend.SOURCE.parent, csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    lower, model = csrc / backend.SOURCE.name, csrc / backend.MODEL_SOURCE.name
    before = (backend.library_path(lower), backend.library_path(model))
    header = csrc / "online_softmax.cuh"
    header.write_text(header.read_text() + "\n")
    after = (backend.library_path(lower), backend.library_path(model))
    assert after[0] != before[0] and after[1] != before[1]
    lower.write_text(lower.read_text() + "\n")
    assert backend.library_path(lower) != after[0]
    assert backend.library_path(model) == after[1]


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    ver = verify_network(_mlp_plan(), device="cpu")
    assert ver.ok
    assert set(LAUNCHES) == {"fc", "conv", "conv_weights", "pool",
                             "eltwise", "attention", "attention_mma",
                             "layout"}
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


def test_wrappers_check_their_inputs():
    plan = _plan(fc("d.fc", 8, 64, 64))
    x = torch.zeros((8, 64))
    with pytest.raises(ValueError, match="shape"):
        tex.run_fc(plan, x, torch.zeros((64, 32)))
    with pytest.raises(TypeError, match="float32"):
        tex.run_fc(plan, x.double(), torch.zeros((64, 64)))
    with pytest.raises(ValueError, match="contiguous"):
        tex.run_fc(plan, torch.zeros((64, 8)).t(), torch.zeros((64, 64)))
    with pytest.raises(ValueError, match="shape"):
        tex.rel_error(torch.zeros((2, 3)), torch.zeros((3, 2)))
    elt = _plan(eltwise("d.elt", 2, 4, 3, 3))
    with pytest.raises(ValueError, match="operand"):
        tex.run_eltwise(elt, [])
    with pytest.raises(ValueError, match="shape"):
        tex.run_eltwise(elt, [torch.zeros((2, 4, 3, 3))] * 8
                        + [torch.zeros((2, 4, 3, 2))])


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = eyeriss_multinode(nodes=2, pe=4, gbuf_bytes=2048)
    cases = [(fc("g.fc", 64, 512, 200), None),
             (fc("g.fc.cout", 64, 512, 200), ("C", "K", "N", "X", "Y")),
             (conv("g.conv", 2, 32, 48, 10, 10, 3, 3), None),
             (conv("g.conv.s4", 2, 3, 16, 10, 10, 11, 11, stride=4), None),
             (conv("g.conv.cout", 4, 64, 32, 4, 4, 1, 1),
              ("C", "N", "K", "X", "Y")),
             (pool("g.pool", 2, 16, 13, 13, 3, 3, stride=2), None),
             (eltwise("g.elt", 2, 64, 14, 14), None)]
    reset_launch_counts()
    for layer, order in cases:
        scheme, _ = solve_intra_layer(layer, tiny,
                                      Constraints(nodes=tiny.node_array))
        if order:
            scheme.levels[-1].order = order
        plan = lower_scheme(scheme, tiny)
        inputs = tex.make_inputs(plan, device="cuda")
        out = tex.execute_plan(plan, inputs, device="cuda")
        plain = {"fc": lambda: tex.plain_fc(plan, inputs["I"], inputs["W"]),
                 "conv": lambda: tex.plain_conv(plan, inputs["I"],
                                                inputs["W"]),
                 "pool": lambda: tex.plain_pool(plan, inputs["I"]),
                 "eltwise": lambda: tex.plain_eltwise(
                     plan, [inputs["A"], inputs["B"]])}[plan.kind]()
        torch.cuda.synchronize()
        assert tex.rel_error(out, plain) <= 1e-5, plan.describe()
    # a conv's weight layout beside each conv; the row-major inputs of the
    # three convs and the pool converted for their kernels
    assert LAUNCHES == {"fc": 2, "conv": 3, "conv_weights": 3, "pool": 1,
                        "eltwise": 1, "attention": 0, "attention_mma": 0,
                        "layout": 4}


#: attention plans the solver gives (layer, template): the Zamba2-1.2B shared
#: block on both templates, and a long sequence whose plan puts C outermost
ATTENTION_CASES = {
    "zamba2-16x16": (attention("zamba2.attn", 8, 32, 512, 64), {}),
    "zamba2-4x4": (attention("zamba2.attn", 8, 32, 512, 64),
                   {"nodes": 4, "pe": 8}),
    "long4k-4x4": (attention("long4k", 1, 8, 4096, 64), {"nodes": 4, "pe": 8}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_kernel_matches_plain_on_card(case):
    dev = _card()
    layer, hw_args = ATTENTION_CASES[case]
    hw = eyeriss_multinode(**hw_args)
    scheme, _ = solve_intra_layer(layer, hw, Constraints(nodes=hw.node_array))
    plan = lower_scheme(scheme, hw)
    assert plan.valid, plan.reason
    inputs = tex.make_inputs(plan, device=dev)
    reset_launch_counts()
    out = tex.run_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    want = tex.plain_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    torch.cuda.synchronize()
    assert LAUNCHES["attention"] == 1
    assert _max_rel(out, want) <= 1e-5, plan.describe()


def test_model_zoo_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("zamba2-1.2b"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_rel(out, want):
    return float((out.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,KV,Sq,Sk,D,causal,window,cap", [
    (4, 2, 128, 128, 64, True, 0, 0.0),
    (8, 4, 96, 200, 256, True, 64, 50.0),
    (2, 1, 64, 256, 128, False, 0, 0.0),
    (4, 4, 130, 130, 32, True, 0, 30.0),
])
def test_flash_kernel_matches_plain_on_card(dtype, H, KV, Sq, Sk, D, causal,
                                            window, cap):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _card()
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, H, Sq, D), generator=g, device=dev).to(dt)
    k = torch.randn((2, KV, Sk, D), generator=g, device=dev).to(dt)
    v = torch.randn((2, KV, Sk, D), generator=g, device=dev).to(dt)
    ops.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal, window, cap)
    want = fa.plain_flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    wgmma = int(fa.flash_path(dt, D) == "wgmma")
    assert fa.LAUNCHES == {"flash_attention": 1,
                           "flash_attention_wgmma": wgmma}
    assert out.dtype == dt
    assert _max_rel(out, want) <= (1e-5 if dtype == "f32" else 8e-3)


#: the tensor-core path: GQA 8:1 and 1:1, causal, window + soft-cap,
#: right-aligned queries (Sq < Sk), and Sq, Sk off the 128-query and
#: 64/128-key tiles
WGMMA_FLASH_CASES = [
    # H, KV, Sq, Sk, causal, window, cap
    (8, 1, 256, 256, True, 0, 0.0),
    (4, 4, 200, 333, True, 0, 0.0),
    (8, 1, 200, 333, False, 0, 0.0),
    (4, 4, 333, 333, True, 96, 50.0),
    (8, 1, 64, 333, True, 0, 0.0),
    (4, 4, 130, 200, False, 100, 30.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("H,KV,Sq,Sk,causal,window,cap", WGMMA_FLASH_CASES)
def test_flash_tensor_core_path_matches_plain_on_card(D, H, KV, Sq, Sk,
                                                      causal, window, cap):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(D + Sq)
    q = torch.randn((2, H, Sq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((2, KV, Sk, D), generator=g, device=dev).bfloat16()
    v = torch.randn((2, KV, Sk, D), generator=g, device=dev).bfloat16()
    ops.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal, window, cap)
    want = fa.plain_flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 1}
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert _max_rel(out, want) <= 8e-3


#: the log-sum-exp output on both paths: (dtype, D, H, KV, Sq, Sk, causal,
#: window, cap); bf16 at D 64/128/256 runs the tensor-core kernel, f32 and
#: bf16 at D 32 the FMA tile
LSE_CASES = [("bf16", 64, 8, 1, 256, 256, True, 0, 0.0),
             ("bf16", 128, 4, 4, 200, 333, True, 0, 0.0),
             ("bf16", 256, 4, 4, 333, 333, True, 96, 50.0),
             ("bf16", 64, 8, 1, 64, 333, False, 0, 0.0),
             ("f32", 64, 4, 2, 130, 200, True, 0, 30.0),
             ("f32", 128, 2, 1, 64, 256, False, 0, 0.0),
             ("bf16", 32, 4, 4, 130, 130, True, 40, 0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,H,KV,Sq,Sk,causal,window,cap", LSE_CASES)
def test_flash_lse_matches_plain_on_card(dtype, D, H, KV, Sq, Sk, causal,
                                         window, cap):
    """Both kernels write each row's m + log(max(l, 1e-30)) within 1e-4 of
    the plain walk's (both f32 from the same operands), and the output is
    what it is without the lse."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dev = _card()
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(D + Sk)
    q = torch.randn((2, H, Sq, D), generator=g, device=dev).to(dt)
    k = torch.randn((2, KV, Sk, D), generator=g, device=dev).to(dt)
    v = torch.randn((2, KV, Sk, D), generator=g, device=dev).to(dt)
    ops.reset_launch_counts()
    out, lse = fa.flash_attention(q, k, v, causal, window, cap,
                                  return_lse=True)
    want, want_lse = fa.plain_flash_attention(q, k, v, causal, window, cap,
                                              return_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    assert float((lse - want_lse).abs().max()) <= 1e-4
    assert torch.equal(out, fa.flash_attention(q, k, v, causal, window, cap))
    assert _max_rel(out, want) <= (1e-5 if dtype == "f32" else 8e-3)


@pytest.mark.gpu
def test_zamba2_train_step_at_reduced_depth_on_card():
    """One bf16 train step of Zamba2-1.2B at full width, 6 layers (one
    shared-attention call): the forward launches flash once (tensor-core
    path) and SSD 6 times, the backward launches no kernel, the update
    takes its 114 leaves in 2 launches and each of the two gradient norms
    (the clip's, the metric's) in one and its final sum, and the loss,
    the gradient norm and every updated parameter are finite."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import make_optimizer
    dev = _card()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), num_layers=6)
    api = build_model(cfg, device=dev, trainable=True)
    params = api.init(0)
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    state = opt.init(dict(params.named_parameters()))
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.randint(1, cfg.vocab_size, (2, 256), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("inputs", "targets")}
    before = params.embed.detach().clone()
    ops.reset_launch_counts()
    params, state, m = build_train_step(api, opt)(params, state, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "flash_attention_wgmma": 1,
                                   "ssd_intra_chunk": 6,
                                   "multi_tensor_sumsq": 2 * 2,
                                   "multi_tensor_adamw": 2}
    assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(bool(torch.isfinite(p).all()) for p in params.parameters())
    assert not torch.equal(params.embed, before)


def _fc_plan(N, C, K, block, grid):
    """An fc plan with the given block and grid order (outer -> inner)."""
    from repro_torch.lower.plan import GridAxis, KernelPlan
    layer = fc("g.fc.hand", N, C, K)
    return KernelPlan(layer=layer, scheme=None, kind="fc",
                      grid=tuple(GridAxis(d, s) for d, s in grid),
                      block=block, valid=True)


#: fc plans: a 200-wide K tile (5 sub-tiles of 40), C tiles that are not a
#: whole number of 32-deep slabs (100, 72), C outermost, C in the middle,
#: and K and C not multiples of 4 (4-byte copies)
FC_CASES = {
    "k200": (64, 2048, 1000, {"N": 64, "C": 2048, "K": 200}, [("K", 5)]),
    "c100-outer": (64, 300, 400, {"N": 64, "C": 100, "K": 200},
                   [("C", 3), ("K", 2)]),
    "c72-middle": (128, 216, 256, {"N": 64, "C": 72, "K": 128},
                   [("N", 2), ("C", 3), ("K", 2)]),
    "ragged-k10": (4, 500, 10, {"N": 4, "C": 100, "K": 10}, [("C", 5)]),
    "ragged-c30": (8, 90, 60, {"N": 8, "C": 30, "K": 12},
                   [("C", 3), ("K", 5)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FC_CASES))
def test_fc_kernel_on_ragged_plans_on_card(case):
    dev = _card()
    N, C, K, block, grid = FC_CASES[case]
    plan = _fc_plan(N, C, K, block, grid)
    inputs = tex.make_inputs(plan, device=dev)
    reset_launch_counts()
    out = tex.run_fc(plan, inputs["I"], inputs["W"])
    again = tex.run_fc(plan, inputs["I"], inputs["W"])
    want = tex.plain_fc(plan, inputs["I"], inputs["W"])
    torch.cuda.synchronize()
    assert LAUNCHES["fc"] == 2
    assert tex.rel_error(out, want) <= 1e-5, plan.describe()
    assert torch.equal(out, again), "two launches differ"


@pytest.mark.gpu
def test_fc_kernel_walks_every_c_tile_past_the_workspace_cap_on_card(
        monkeypatch):
    """Where even one part per C tile would pass the workspace cap, one
    part walks every C tile in order and writes the output."""
    dev = _card()
    monkeypatch.setattr(tex, "FC_WORKSPACE_CAP", 3 * 4 * 64 * 400)
    plan = _fc_plan(64, 900, 400, {"N": 64, "C": 100, "K": 200},
                    [("C", 9), ("K", 2)])
    launch = tex.fc_launch(plan)
    assert (launch.group, launch.n_parts) == (9, 1)
    inputs = tex.make_inputs(plan, device=dev)
    out = tex.run_fc(plan, inputs["I"], inputs["W"])
    want = tex.plain_fc(plan, inputs["I"], inputs["W"])
    torch.cuda.synchronize()
    assert tex.rel_error(out, want) <= 1e-5, plan.describe()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,NC,Lc,P,N", [
    (4, 2, 128, 64, 128),
    (3, 3, 64, 32, 16),
    (2, 2, 256, 128, 64),       # two row tiles (workspace), two P tiles
    (3, 2, 200, 100, 20),       # ragged Lc and P; bf16 rows unaligned
    (5, 1, 72, 36, 130),        # N chunks 64 + 64 + 2, 4-byte B/C copies
    (12, 66, 64, 32, 16),       # groups of 8 heads, the last one partial
])
def test_ssd_kernel_matches_plain_on_card(dtype, H, NC, Lc, P, N):
    from repro_torch.kernels import ops, ssd_scan
    dev = _card()
    dt_ = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, H, NC, Lc, P), generator=g, device=dev).to(dt_)
    dt = torch.rand((2, H, NC, Lc), generator=g, device=dev) * 0.2
    acum = torch.cumsum(-dt * 0.5, dim=-1)
    b = torch.randn((2, NC, Lc, N), generator=g, device=dev) * 0.3
    c = torch.randn((2, NC, Lc, N), generator=g, device=dev) * 0.3
    ops.reset_launch_counts()
    out = ssd_scan.ssd_intra_chunk(x, dt, acum, b, c)
    want = ssd_scan.plain_ssd_intra_chunk(x, dt, acum, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES == {"ssd_intra_chunk": 1}
    assert out.dtype == dt_
    assert _max_rel(out, want) <= (1e-5 if dtype == "f32" else 8e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("decay", ["spread", "steep"])
def test_ssd_kernel_strong_decay_on_card(dtype, decay):
    """Decays past float's range: ``spread``, acum falls ~400 over 256 keys
    (steps up to 3); ``steep``, ~15 at every key (|A| 16, dt ~0.95), so
    that each 8-key block spans ~105, past float's exp range.  The
    kernel's factored decay underflows where the plain version's exp does,
    and never makes an inf or a NaN."""
    from repro_torch.kernels import ssd_scan
    dev = _card()
    dt_ = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, 3, 2, 256, 64), generator=g, device=dev).to(dt_)
    if decay == "spread":
        dt = torch.rand((2, 3, 2, 256), generator=g, device=dev) * 3.0
        acum = torch.cumsum(-dt, dim=-1)
    else:
        dt = 0.9 + 0.1 * torch.rand((2, 3, 2, 256), generator=g, device=dev)
        acum = torch.cumsum(-16.0 * dt, dim=-1)
    b = torch.randn((2, 2, 256, 32), generator=g, device=dev) * 0.3
    c = torch.randn((2, 2, 256, 32), generator=g, device=dev) * 0.3
    out = ssd_scan.ssd_intra_chunk(x, dt, acum, b, c)
    want = ssd_scan.plain_ssd_intra_chunk(x, dt, acum, b, c)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _max_rel(out, want) <= (1e-5 if dtype == "f32" else 8e-3)


def _hand_plan(layer, block, grid):
    """A plan of ``layer`` with the given block and grid order (outer ->
    inner)."""
    from repro_torch.lower.plan import GridAxis, KernelPlan
    return KernelPlan(layer=layer, scheme=None, kind=layer.kind,
                      grid=tuple(GridAxis(d, s) for d, s in grid),
                      block=block, valid=True)


#: conv plans on the tensor-core kernel: (N, C, K, X, Y, R, stride), block,
#: grid.  C outermost over K and X; a 16-position tile (N=16, X=Y=1) at
#: stride 2; a K = 8 tile; conv1's C = 3 at 7x7 stride 2 and 11x11 stride
#: 4; a ragged X = 7 tile with C outermost and a ragged channel chunk
CONV_CASES = {
    "c-outermost": ((2, 48, 16, 4, 4, 3, 1),
                    {"N": 2, "C": 16, "K": 8, "X": 2, "Y": 4},
                    [("C", 3), ("K", 2), ("X", 2)]),
    "m16-1x1-s2": ((32, 64, 128, 2, 2, 1, 2),
                   {"N": 16, "C": 64, "K": 128, "X": 1, "Y": 1},
                   [("N", 2), ("X", 2), ("Y", 2)]),
    "k8": ((8, 24, 16, 3, 3, 3, 1),
           {"N": 8, "C": 24, "K": 8, "X": 1, "Y": 1},
           [("X", 3), ("Y", 3), ("K", 2)]),
    "c3-7x7-s2": ((8, 3, 64, 16, 16, 7, 2),
                  {"N": 8, "C": 3, "K": 64, "X": 8, "Y": 4},
                  [("X", 2), ("Y", 4)]),
    "c3-11x11-s4": ((4, 3, 96, 11, 11, 11, 4),
                    {"N": 4, "C": 3, "K": 96, "X": 11, "Y": 1},
                    [("Y", 11)]),
    "ragged-x7": ((8, 40, 24, 7, 7, 3, 1),
                  {"N": 8, "C": 20, "K": 24, "X": 7, "Y": 1},
                  [("C", 2), ("Y", 7)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_kernel_on_plans_on_card(case):
    """The implicit-GEMM conv in 3xTF32 within 1e-5 of plain_conv, and two
    launches bit for bit equal."""
    dev = _card()
    (N, C, K, X, Y, R, st), block, grid = CONV_CASES[case]
    plan = _hand_plan(conv("g.conv.hand", N, C, K, X, Y, R, R, stride=st),
                      block, grid)
    inputs = tex.make_inputs(plan, device=dev)
    reset_launch_counts()
    out = tex.run_conv(plan, inputs["I"], inputs["W"])
    again = tex.run_conv(plan, inputs["I"], inputs["W"])
    want = tex.plain_conv(plan, inputs["I"], inputs["W"])
    torch.cuda.synchronize()
    assert LAUNCHES["conv"] == 2
    assert tex.rel_error(out, want) <= 1e-5, plan.describe()
    assert torch.equal(out, again), "two launches differ"


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_attention_kernel_paths_on_card(D):
    """Every head dim on its path (``ATTN_PATHS``: the tensor cores up to
    128, the FMA tile at 256), with C outermost, ragged C tiles (100 keys:
    64 + 36) and ragged X tiles (50 queries of a 64-row block)."""
    dev = _card()
    plan = _hand_plan(attention("g.attn", 1, 3, 100, D, seq_kv=200),
                      {"N": 1, "X": 50, "C": 100, "K": D},
                      [("C", 2), ("N", 3), ("X", 2)])
    inputs = tex.make_inputs(plan, device=dev)
    reset_launch_counts()
    out = tex.run_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    again = tex.run_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    want = tex.plain_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    torch.cuda.synchronize()
    mma = int(tex.ATTN_PATHS[D] == "mma-3xtf32")
    assert LAUNCHES["attention"] == 2 and LAUNCHES["attention_mma"] == 2 * mma
    assert mma == (D != 256)
    assert _max_rel(out, want) <= 1e-5, plan.describe()
    assert torch.equal(out, again), "two launches differ"


@pytest.mark.gpu
@pytest.mark.parametrize("n_ops,numel_off,offset", [
    (2, 0, 0), (9, 0, 0), (12, 3, 0), (5, 1, 1), (1, 2, 0)])
def test_eltwise_kernel_bitwise_on_card(n_ops, numel_off, offset):
    """The vectorised eltwise, chained past 8 operands, a scalar tail
    (numel % 4) and operands not 16-byte aligned (``offset`` floats into
    their storage): equal to plain_eltwise bit for bit, with one launch per
    ``eltwise_chain`` step."""
    from repro_torch.lower.plan import GridAxis, KernelPlan
    dev = _card()
    N, C, X, Y = 2, 64, 14, 14 + numel_off
    layer = eltwise("g.elt.n", N, C, X, Y)
    plan = KernelPlan(layer=layer, scheme=None, kind="eltwise",
                      grid=(GridAxis("N", 2),),
                      block={"N": 1, "C": C, "X": X, "Y": Y}, valid=True)
    g = torch.Generator(device=dev).manual_seed(n_ops)
    xs = [torch.randn(N * C * X * Y + offset, generator=g, device=dev)
          [offset:].view(N, C, X, Y) for _ in range(n_ops)]
    reset_launch_counts()
    out = tex.run_eltwise(plan, xs)
    want = tex.plain_eltwise(plan, xs)
    torch.cuda.synchronize()
    assert LAUNCHES["eltwise"] == len(tex.eltwise_chain(n_ops))
    assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [48, 80, 200])
def test_attention_kernel_padded_head_dims_on_card(D):
    """Head dims outside the instantiated set run zero-padded to the next
    one (48 -> 64 and 80 -> 128 on the tensor cores, 200 -> 256 on the FMA
    tile), within 1e-5 of plain_attention."""
    dev = _card()
    plan = _hand_plan(attention("g.attn.pad", 1, 3, 100, D, seq_kv=200),
                      {"N": 1, "X": 50, "C": 100, "K": D},
                      [("C", 2), ("N", 3), ("X", 2)])
    inputs = tex.make_inputs(plan, device=dev)
    reset_launch_counts()
    out = tex.run_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    want = tex.plain_attention(plan, inputs["Q"], inputs["K"], inputs["V"])
    torch.cuda.synchronize()
    Dk = tex.attention_head_dim(D)
    assert LAUNCHES["attention"] == 1
    assert LAUNCHES["attention_mma"] == int(tex.ATTN_PATHS[Dk]
                                            == "mma-3xtf32")
    assert out.shape == want.shape == (3, 100, D)
    assert _max_rel(out, want) <= 1e-5, plan.describe()


@pytest.mark.gpu
def test_conv_kernel_on_every_resnet_plan_on_card():
    """Every distinct conv plan of ResNet-50 b64 on the 16x16 template
    (conv1 on its folded images, the four plans with channels on wgmma's M
    side): within 1e-5 of plain_conv, two launches bit for bit equal."""
    dev = _card()
    net = get_net("resnet", batch=64)
    hw = eyeriss_multinode()
    nplan = lower_network(solve(net, hw), net, hw)
    seen = set()
    for n in nplan.order:
        plan = nplan.plans[n]
        key = (plan.describe(), tuple(sorted(plan.layer.dims.items())),
               tuple(sorted(plan.layer.meta.items())))
        if plan.kind != "conv" or key in seen:
            continue
        seen.add(key)
        inputs = tex.make_inputs(plan, device=dev)
        out = tex.run_conv(plan, inputs["I"], inputs["W"])
        again = tex.run_conv(plan, inputs["I"], inputs["W"])
        want = tex.plain_conv(plan, inputs["I"], inputs["W"])
        torch.cuda.synchronize()
        assert tex.rel_error(out, want) <= 1e-5, n
        assert torch.equal(out, again), n
    assert len(seen) >= 20


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_resnet50_b64_call_counts_on_card(fused):
    """One call of ResNet-50 b64 on either tier: its 53 convolutions through
    ``conv_kernel_wgmma`` (and one weight layout each), and one layout
    conversion, the images'."""
    import collections
    from repro_torch.lower import clear_cache
    dev = _card()
    net = get_net("resnet", batch=64)
    hw = eyeriss_multinode()
    nplan = lower_network(solve(net, hw), net, hw)
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    run = network_runner(nplan, inputs, device=dev, keep="boundary",
                         fused=fused)
    run()                                   # the capture, on the fused tier
    reset_launch_counts()
    run()
    kinds = collections.Counter(nplan.plans[n].kind for n in nplan.order)
    assert kinds["conv"] == 53
    assert LAUNCHES["conv"] == LAUNCHES["conv_weights"] == 53
    assert LAUNCHES["layout"] == 1
    clear_cache()


@pytest.mark.gpu
def test_conv_kernel_past_2_31_elements_on_card():
    """An input of just over 2^31 elements (130 x 64 x 512 x 512 float32,
    8.7 GB): the batch split into launches of fewer than 2^31 elements
    each (the kernel's 32-bit launch arguments), against the oracle of
    kernels/ref.py (F.conv2d, TF32 off)."""
    from repro_torch.kernels import ref
    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    plan = _hand_plan(conv("g.conv.big", 130, 64, 8, 512, 512, 1, 1),
                      {"N": 2, "C": 64, "K": 8, "X": 16, "Y": 512},
                      [("N", 65), ("X", 32)])
    XI, YI = tex.input_extent(plan.layer)
    assert 130 * 64 * XI * YI >= 2 ** 31
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((130, 64, XI, YI), generator=g, device=dev)
    w = torch.randn((8, 64, 1, 1), generator=g, device=dev) * 64 ** -0.5
    reset_launch_counts()
    out = tex.run_conv(plan, x, w)
    assert LAUNCHES["conv"] == len(tex.conv_batch_parts(plan, XI, YI)) > 1
    want = ref.conv2d_ref(x, w)
    torch.cuda.synchronize()
    assert _max_rel(out, want) <= 1e-5


# ---------------------------------------------------------------------------
# the fused tier: CUDA graphs over the same kernels
# ---------------------------------------------------------------------------

#: (net, batch, template arguments) of the fused-tier cases
FUSED_CASES = {"mlp": ("mlp", 4, {"nodes": 4, "pe": 8}),
               "alexnet": ("alexnet", 2, {}),
               "resnet": ("resnet", 2, {})}


def _fused_case(case):
    name, batch, hw_args = FUSED_CASES[case]
    hw = eyeriss_multinode(**hw_args)
    net = get_net(name, batch=batch)
    return lower_network(solve(net, hw), net, hw)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_replay_bitwise_equals_per_layer_on_card(case):
    """Every layer output of a replay equals the per-layer tier's bit for
    bit, each replay adds the plan's launches of each kind, the boundary
    variant (the one measured) equals it on what it returns, each
    segment's graph equals the per-layer outputs it produces, and a plan's
    one-kernel graph equals its launch."""
    import collections
    from repro_torch.lower import clear_cache, fused_runner
    dev = _card()
    nplan = _fused_case(case)
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    want = {n: v.to(dev) for n, v in
            network_runner(nplan, inputs, device=dev)().outputs.items()}
    clear_cache()
    run = network_runner(nplan, inputs, device=dev, fused=True)
    run()                                   # warm-up and capture
    expect = collections.Counter(nplan.plans[n].kind for n in nplan.order)
    expect["conv_weights"] = expect["conv"]
    expect["layout"] = {"mlp": 0, "alexnet": 2, "resnet": 1}[case]
    expect = +expect                        # the kinds that launched
    for _ in range(2):
        reset_launch_counts()
        ex = run()
        assert {k: v for k, v in LAUNCHES.items() if v} == dict(expect)
        for n in nplan.order:
            assert torch.equal(ex.outputs[n], want[n]), n
    bound = network_runner(nplan, inputs, device=dev, keep="boundary",
                           fused=True)().outputs
    assert bound and set(bound) < set(nplan.order)
    for n, v in bound.items():
        assert torch.equal(v, want[n]), n
    net = fused_runner(nplan, device=dev)
    assert net.traces == 2
    for i, (consumes, produces) in enumerate(net.segment_io):
        out = net.run_segment(i, {s: inputs[s] if s in inputs else want[s]
                                  for s in consumes})
        for n in produces:
            assert torch.equal(out[n], want[n]), (i, n)
    for n in nplan.order:
        plan = nplan.plans[n]
        feed = tex.make_inputs(plan, seed=1, device=dev)
        assert torch.equal(plan_runner(plan, dev, fused=True)(feed),
                           plan_runner(plan, dev)(feed)), n
    clear_cache()


@pytest.mark.gpu
def test_fused_equal_signature_callers_keep_their_weights_on_card():
    """Two runners of one cached network (seeds 0 and 1), called in turn:
    each replay gives its own caller's per-layer result (a graph that read
    the first caller's tensors would give seed 0's to both), and a result
    held across the other runner's call keeps its values."""
    from repro_torch.lower import cache_stats, clear_cache
    dev = _card()
    clear_cache()
    plans = [_fused_case("alexnet"), _fused_case("alexnet")]
    runs = []
    for seed, nplan in enumerate(plans):
        inputs = make_network_inputs(nplan, seed=seed, device=dev)
        want = {n: v.to(dev) for n, v in
                network_runner(nplan, inputs, device=dev)().outputs.items()}
        runs.append((network_runner(nplan, inputs, device=dev, fused=True),
                     want))
    assert cache_stats()["hits"] == 1
    last = plans[0].order[-1]
    assert not torch.equal(runs[0][1][last], runs[1][1][last])
    held = None
    for run, want in runs + runs:
        ex = run()
        for n in plans[0].order:
            assert torch.equal(ex.outputs[n], want[n]), n
        if held is not None:
            for n in plans[0].order:
                assert torch.equal(held[0].outputs[n], held[1][n]), n
        held = (ex, want)
    clear_cache()


@pytest.mark.gpu
def test_fused_sees_weights_written_in_place_on_card():
    """A weight written through ``.data`` (no version bump) between two
    replays gives the new weight's per-layer result."""
    from repro_torch.lower import clear_cache
    dev = _card()
    nplan = _fused_case("alexnet")
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    clear_cache()
    run = network_runner(nplan, inputs, device=dev, fused=True)
    run()
    w = next(k for k in inputs if k.endswith(".W"))
    inputs[w].data.copy_(inputs[w].data * 2.0)
    got = run().outputs
    want = network_runner(nplan, inputs, device=dev)().outputs
    for n in nplan.order:
        assert torch.equal(got[n], want[n].to(dev)), n
    clear_cache()


@pytest.mark.gpu
def test_fused_capture_in_a_worker_thread_on_card():
    import threading
    from repro_torch.lower import clear_cache
    dev = _card()
    nplan = _fused_case("alexnet")
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    want = network_runner(nplan, inputs, device=dev)().outputs
    clear_cache()
    got, errors = {}, []

    def work():
        try:
            got.update(network_runner(nplan, inputs, device=dev,
                                      fused=True)().outputs)
        except Exception as e:          # surfaced below
            errors.append(e)
    th = threading.Thread(target=work)
    th.start()
    th.join()
    assert not errors, errors
    for n in nplan.order:
        assert torch.equal(got[n], want[n].to(dev)), n
    clear_cache()


@pytest.mark.gpu
def test_fused_clear_cache_gives_the_memory_back_on_card():
    from repro_torch.lower import cache_stats, clear_cache
    dev = _card()
    nplan = _fused_case("resnet")
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    clear_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    run = network_runner(nplan, inputs, device=dev, fused=True)
    run()
    held = torch.cuda.memory_allocated(dev)
    assert held > base
    del run
    assert cache_stats()["size"] == 1
    clear_cache()
    assert torch.cuda.memory_allocated(dev) <= base
    assert cache_stats()["size"] == 0


@pytest.mark.gpu
def test_fused_cache_bounded_by_bytes_on_card(monkeypatch):
    """The cache fills to its bound in bytes and no further: with a bound
    below one network, each new network evicts the last one and its
    memory goes back; by default the bound is half the card."""
    from repro_torch.lower import cache_stats, clear_cache
    from repro_torch.lower import fuse
    dev = _card()
    assert fuse._budget(dev) == \
        torch.cuda.get_device_properties(dev).total_memory // 2
    clear_cache()
    cases = [(c, _fused_case(c)) for c in ("mlp", "alexnet", "resnet")]
    feeds = {c: make_network_inputs(p, seed=0, device=dev)
             for c, p in cases}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    monkeypatch.setattr(fuse, "_CACHE_BYTES", 1)
    for i, (case, nplan) in enumerate(cases):
        network_runner(nplan, feeds[case], device=dev, fused=True)()
        net = fuse.fused_runner(nplan, device=dev)
        assert net.nbytes > 0
        assert cache_stats()["size"] == 1
        assert cache_stats()["evictions"] == i
        # the network held now, and nothing of those evicted before it
        assert torch.cuda.memory_allocated(dev) <= base + net.nbytes, case
        del net
    clear_cache()
    assert torch.cuda.memory_allocated(dev) <= base


# ---------------------------------------------------------------------------
# the mesh executor: segment tasks of both tiers over four nodes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("backend", [None, "compiled"],
                         ids=["per-layer", "fused"])
def test_mesh_tasks_bitwise_equal_fused_replay_on_card(backend):
    """AlexNet b64 on the 16x16 template over 4 nodes: the tier's tasks
    give the fused replay's outputs bit for bit, through a node crash and
    the re-partition after it, and fused tasks capture nothing after they
    are built."""
    import numpy as np
    from repro_torch.core.solver.multinode import NodeMesh, plan_multinode
    from repro_torch.lower import clear_cache, fused_runner
    from repro_torch.lower.meshexec import MeshExecutor, build_segment_tasks
    from repro_torch.runtime.inject import FaultPlan, FaultSpec, inject
    dev = _card()
    hw = eyeriss_multinode()
    net = get_net("alexnet", batch=64)
    sched = solve(net, hw)
    nplan = lower_network(sched, net, hw)
    inputs = make_network_inputs(nplan, seed=0, device=dev)
    clear_cache()
    want = {k: v.cpu().numpy() for k, v in network_runner(
        nplan, inputs, device=dev, fused=True)().outputs.items()}
    weights = {k: v for k, v in inputs.items() if k.endswith(".W")}
    ext = {k: v.cpu().numpy() for k, v in inputs.items()
           if k.endswith(".I")}
    tasks = build_segment_tasks(nplan, weights, backend=backend, device=dev)
    fused = fused_runner(nplan, device=dev)
    traces = fused.traces
    plan = plan_multinode(sched, net, hw, NodeMesh(nodes=4))
    victim = plan.part_of_segment(0).node_ids[0]
    faults = FaultPlan.make(2, {"node.crash": FaultSpec(
        rate=1.0, match=f"node{victim}", after=1)})
    with MeshExecutor(plan, tasks, schedule=sched, graph=net, hw=hw) as ex:
        with inject(faults):
            runs = [ex.run(ext, f"r{i}") for i in range(3)]
        st = ex.stats()
    assert st["failures"] >= 1 and st["repartitions"] >= 1
    for r in runs:
        assert not r.degraded and r.outputs
        for k, v in r.outputs.items():
            assert np.array_equal(v, want[k]), k
    assert fused.traces == traces
    clear_cache()
