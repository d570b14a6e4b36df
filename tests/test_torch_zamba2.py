"""The port's published-Zamba2 path (``models/zamba2.py``) against the
benchmark's plain float32 reference (``bench/reference/zamba2.py``) on
the CPU, at a small size with every mechanism of the published model:
two groups of B and C, two shared blocks over three sites (block 0 used
twice), heads wider than d_model / heads, per-site adapters and linears,
the shared block's output entering only the Mamba input.  Both sides run
float32 (the port its plain kernel versions) from the same seeded
weights.  Also the sites' spans and marks, traced and untraced."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.drivers import train_zamba2  # noqa: E402
from bench.reference import mamba2 as ref_m  # noqa: E402
from bench.reference import zamba2 as ref  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import zamba2  # noqa: E402
from repro_torch.models.api import build_model, train_params  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402

#: the published keys at a small size: 32 wide, attention 64 (= 2 x 32) in
#: 4 heads of 16 (d_model / heads is 8), 7 layers with sites at 1, 3, 6
TINY = {"name": "zamba2-tiny", "dtype": "float32", "hidden_size": 32,
        "attention_hidden_size": 64, "attention_head_dim": 16,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 48, "adapter_rank": 4, "mamba_d_state": 8,
        "mamba_headdim": 8, "mamba_expand": 2, "mamba_d_conv": 4,
        "mamba_ngroups": 2, "num_hidden_layers": 7,
        "hybrid_layer_ids": [1, 3, 6], "num_mem_blocks": 2,
        "vocab_size": 256, "rope_theta": 10000, "hidden_act": "gelu",
        "optimizer": {"name": "adamw", "lr": 1e-3, "b1": 0.9, "b2": 0.95,
                      "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}}
SEQ = 256


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


@pytest.fixture(scope="module")
def sides():
    w = ref.make_weights(TINY, 21, "cpu", torch.float32)
    api = build_model(train_zamba2.model_config(TINY), device="cpu",
                      dtype=torch.float32, trainable=True)
    model = train_params(train_zamba2.port_model(TINY, w))
    toks = torch.randint(1, 256, (2, SEQ + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    return w, api, model, batch


def test_config_holds_every_mechanism():
    cfg = train_zamba2.model_config(TINY)
    assert isinstance(cfg, zamba2.Zamba2Config) and cfg.family == "hybrid"
    assert cfg.head_dim * cfg.num_heads == cfg.attn_hidden == 2 * cfg.d_model
    assert cfg.head_dim > cfg.d_model // cfg.num_heads
    assert cfg.ssm_groups == 2 and cfg.num_mem_blocks == 2
    assert cfg.hybrid_layers == (1, 3, 6)
    api = build_model(cfg, device="meta", dtype=torch.float32)
    # the count is of the matrices, the convolutions' taps left out
    n = sum(p.numel() for name, p in api.init(0).named_parameters()
            if p.dim() == 2 and "conv_" not in name)
    assert n == cfg.param_count()


def test_shapes_are_the_programs_own(sides):
    w, api, model, _ = sides
    from bench.drivers import _lm
    _lm.check_shapes(TINY, api, model)
    assert model.blocks[0].mamba["w_b"].shape == (32, 2 * 8)


def test_logits_and_loss_match_the_reference(sides):
    """float32 on both sides; 1e-5 of the logits' largest (products of a
    few hundred terms summed in other orders: the flash walk against a
    softmax, the chunked scan's einsums) and of the loss."""
    w, api, model, batch = sides
    with torch.no_grad():
        got = api.forward(model, batch["inputs"])
        want = ref.logits(w, batch["inputs"], TINY)
        assert _rel(got, want) < 1e-5
        loss = float(api.loss_fn(model, batch))
        want_loss = float(ref.loss(w, batch["inputs"], batch["targets"],
                                   TINY, remat=False))
    assert loss == pytest.approx(want_loss, rel=1e-5)


def test_every_gradient_matches_the_reference(sides):
    """Every leaf's gradient, both shared blocks' summed over their sites
    and each site's adapter and linear: within 1e-4 of the leaf's largest
    entry (float32 gradients through 7 layers and the chunked CE, summed
    in other orders than the reference's autograd)."""
    w, api, model, batch = sides
    for p in model.parameters():
        p.grad = None
    api.loss_fn(model, batch).backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    wr = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    ref.loss(wr, batch["inputs"], batch["targets"], TINY,
             remat=False).backward()
    names = list(ref.leaf_names(TINY))
    assert {one for one, _, _ in names} == set(got)
    for one, st, i in names:
        want = ref.layer_leaf({k: t.grad for k, t in wr.items()}, st, i)
        assert _rel(got[one], want) < 1e-4, one
    # block 0 serves sites 0 and 2: its gradient is both sites'
    assert float(got["shared.0.attn.wq"].norm()) > 0
    assert float(got["sites.2.adapter_b"].norm()) > 0


def test_one_adamw_step_matches_the_reference(sides):
    """One train step, the program's (``build_train_step``: loss, backward,
    clipped AdamW) against the reference's from the same weights: each
    leaf's change within 1e-3 of the reference change's norm, over the
    leaves whose gradient is not ~0 (AdamW's first step moves every
    element by ~lr whatever its gradient's size, so a gradient at the
    rounding's level moves its element either way)."""
    w, api, _, batch = sides
    hp = dict(TINY["optimizer"])
    model = train_params(train_zamba2.port_model(TINY, w))
    opt = make_optimizer("adamw", **{k: v for k, v in hp.items()
                                     if k != "name"})
    state = opt.init(dict(model.named_parameters()))
    step = build_train_step(api, opt)
    _, _, metrics = step(model, state, batch)
    want = ref.train_readings(TINY, w, [batch], hp)
    assert float(metrics["loss"]) == pytest.approx(want["losses"][0],
                                                   rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        want["grad_norms"][0], rel=1e-4)
    named = dict(model.named_parameters())
    got = {one: float((named[one].detach() - ref.layer_leaf(w, st, i)).norm())
           for one, st, i in ref.leaf_names(TINY)}
    gaps = ref_m.norm_gaps(got, want["change"],
                           ref_m.still_leaves(want["first_grad"]))
    assert max(gaps.values()) < 1e-3, ref_m.worst(gaps)


def test_serving_is_not_implemented(sides):
    _, api, model, batch = sides
    with pytest.raises(NotImplementedError):
        api.prefill(model, batch["inputs"], 300)
    with pytest.raises(NotImplementedError):
        api.init_cache(1, 16)


def test_sites_marks_and_spans_traced_and_untraced(sides):
    """With a tracer installed, a step records each site's forward and
    backward marks in order and one ``hybrid.site`` span a site; without
    one it records none, and the gradient is the same."""
    w, api, model, batch = sides
    phases, grads = {}, {}
    for traced in (False, True):
        for p in model.parameters():
            p.grad = None
        tracer = trace.enable() if traced else None
        try:
            api.loss_fn(model, batch).backward()
        finally:
            if traced:
                trace.disable()
        phases[traced] = api.marks.phase_ms()
        grads[traced] = [p.grad.clone() for p in model.parameters()]
        if traced:
            spans = tracer.find("hybrid.site")
            assert [(s["args"]["site"], s["args"]["block"]) for s in spans] \
                == [(0, 0), (1, 1), (2, 0)]
    api.marks.mark("forget")        # no tracer: the marks are forgotten
    assert api.marks.phase_ms() == {}
    names = list(phases[True]) + ["hybrid.0.backward_end"]
    want = [f"hybrid.{k}.{m}" for k in range(3)
            for m in ("forward", "forward_end")]
    want += [f"hybrid.{k}.{m}" for k in (2, 1, 0)
             for m in ("backward", "backward_end")]
    assert names == want
    assert zamba2.site_ms(phases[True]) > 0
    assert phases[False] == {}
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
def test_captured_step_marks_on_card(traced):
    """The published path through ``CompiledTraining`` on the card (bf16,
    the kernels at D 16 and two B/C groups): the warm-up step's loss equals
    the eager step's (1e-3, bf16), a replay runs, and the sites' marks are
    in the graph exactly when a tracer was installed across the capture."""
    from repro_torch.launch.steps import CompiledTraining
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = dict(TINY, attention_head_dim=16)
    w = ref.make_weights(cfg, 5, dev, torch.bfloat16)
    api = build_model(train_zamba2.model_config(cfg), device=dev,
                      dtype=torch.bfloat16, trainable=True)
    hp = {k: v for k, v in TINY["optimizer"].items() if k != "name"}
    toks = torch.randint(1, 256, (2, SEQ + 1), dtype=torch.int32,
                         device=dev, generator=torch.Generator(
                             device=dev).manual_seed(1))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    eager = train_params(train_zamba2.port_model(cfg, w))
    opt = make_optimizer("adamw", **hp)
    want = build_train_step(api, opt)(
        eager, opt.init(dict(eager.named_parameters())), batch)[2]
    model = train_params(train_zamba2.port_model(cfg, w))
    state = opt.init(dict(model.named_parameters()))
    if traced:
        trace.enable()
    try:
        step = CompiledTraining(api, model, state, opt, batch)
        got = step.step(batch)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                   rel=1e-3)
        step.step(batch)
        torch.cuda.synchronize()
    finally:
        if traced:
            trace.disable()
    phases = api.marks.phase_ms()
    assert bool(phases) == traced
    if traced:
        assert len(phases) == 11 and zamba2.site_ms(phases) > 0
