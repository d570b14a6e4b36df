"""The kernels' new shapes for the published Zamba2: flash attention at
head dim 224 and the SSD with B and C in groups.  On the CPU: the plain
versions, the geometry and the one-group program bit for bit as it was;
on the card (``gpu``): each kernel against its plain version."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ssd_scan
from repro_torch.launch import op_cost
from repro_torch.models import common, ssm


def _rel(out, want):
    return float((out.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _naive_attention(q, k, v, scale):
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    S = q.shape[2]
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    return torch.softmax(s.masked_fill(~causal, float("-inf")), -1) \
        @ v.double()


def test_flash_paths_at_224():
    """bf16 at 224 runs the tensor-core kernel; float32 has no kernel
    there and says which head dims it takes."""
    assert fa.flash_path(torch.bfloat16, 224) == "wgmma"
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_path(torch.float32, 224)
    q = torch.empty((1, 2, 128, 224), dtype=torch.bfloat16, device="meta")
    assert fa.flash_attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("S", [64, 200])
def test_plain_flash_at_224_is_attention(S):
    """The plain walk at D 224 with the published scale (224 / 2)^-1/2
    against softmax attention in float64 (1e-5: float32 sums of 224
    products and of a row's probabilities)."""
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn((2, 3, S, 224), generator=g) for _ in range(3))
    scale = 112 ** -0.5
    out, lse = fa.plain_flash_attention(q, k, v, True, scale=scale,
                                        return_lse=True)
    assert _rel(out, _naive_attention(q, k, v, scale)) < 1e-5
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e300)
    assert float((lse.double() - torch.logsumexp(s, -1)).abs().max()) < 1e-4


def test_flash_vjp_at_224_matches_autograd():
    """The recomputing backward at D 224 against autograd of plain softmax
    attention (float32 both; 1e-4 of each gradient's largest entry)."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, 128, 224), generator=g).requires_grad_()
               for _ in range(3))
    do = torch.randn((1, 2, 128, 224), generator=g)
    scale = 112 ** -0.5
    (ops.flash_attention_vjp(q, k, v, scale=scale) * do).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(),
                      float("-inf"))
    ((torch.softmax(s, -1) @ v) * do).sum().backward()
    for a, t in zip(got, (q, k, v)):
        assert _rel(a, t.grad) < 1e-4


@pytest.mark.parametrize("H,G", [(112, 2), (24, 2), (12, 3), (8, 1)])
def test_ssd_geometry_by_group(H, G):
    """Each B/C group of H / G heads gets blocks of its own, at most 8
    heads a block; one group is the geometry it always was."""
    L = ssd_scan.ssd_launch(1, H, 32, 128, 64, 64, 2, G)
    hpg = H // G
    assert L.hg == min(hpg, ssd_scan.SSD_HG)
    assert L.blocks_a_group == -(-hpg // L.hg)
    assert L.grid == (32, G * L.blocks_a_group)
    assert L.params(1, True, True)[-1] == G
    assert len(L.params(1, True, True)) == 14
    if G == 1:
        assert L.grid[1] == -(-H // min(H, ssd_scan.SSD_HG))
    with pytest.raises(ValueError):
        ssd_scan.ssd_launch(1, H, 32, 128, 64, 64, 2, 5)


def test_ssd_intra_chunk_groups_are_each_groups_own():
    """With B and C in G groups, heads of group g get what a one-group call
    with that group's B and C gives them, forward and backward, exactly."""
    g = torch.Generator().manual_seed(5)
    B, H, NC, Lc, P, N, G = 2, 6, 2, 32, 8, 4, 3
    x = torch.randn((B, H, NC, Lc, P), generator=g)
    dt = torch.rand((B, H, NC, Lc), generator=g) * 0.2
    acum = torch.cumsum(-dt * 0.5, -1)
    b = torch.randn((B, NC, G, Lc, N), generator=g)
    c = torch.randn((B, NC, G, Lc, N), generator=g)
    dy = torch.randn((B, H, NC, Lc, P), generator=g)
    y = ssd_scan.plain_ssd_intra_chunk(x, dt, acum, b, c)
    grads = ssd_scan.ssd_intra_chunk_bwd(dy, x, dt, acum, b, c)
    hpg = H // G
    for j in range(G):
        hs = slice(j * hpg, (j + 1) * hpg)
        one = (x[:, hs], dt[:, hs], acum[:, hs], b[:, :, j], c[:, :, j])
        assert torch.equal(y[:, hs], ssd_scan.plain_ssd_intra_chunk(*one))
        want = ssd_scan.ssd_intra_chunk_bwd(dy[:, hs], *one)
        for got, w in zip(grads[:3], want[:3]):
            assert torch.allclose(got[:, hs], w, atol=1e-6, rtol=1e-5)
        for got, w in zip(grads[3:], want[3:]):
            assert torch.allclose(got[:, :, j], w, atol=1e-5, rtol=1e-5)


def _ssd_as_it_was(x, dt, a_log, b, c, chunk=128):
    """``ops.ssd`` before B and C had groups, verbatim: the oracle of the
    one-group program."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    NC = S // chunk
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    ad = dtf * a[None, None, :]
    x_c = x.reshape(B, NC, chunk, H, P)
    dt_c = dtf.reshape(B, NC, chunk, H)
    ad_c = ad.reshape(B, NC, chunk, H)
    b_c = b.reshape(B, NC, chunk, N).float()
    c_c = c.reshape(B, NC, chunk, N).float()
    acum = torch.cumsum(ad_c, dim=2)
    a_end = acum[:, :, -1]
    w = torch.exp(a_end[:, :, None] - acum) * dt_c
    states = torch.einsum("bclh,bclhp,bcln->bchpn", w, x_c.float(), b_c)
    decay_chunk = torch.exp(a_end)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h0 = []
    for i in range(NC):
        s_prev = states[:, i - 1] if i else torch.zeros_like(h)
        h = h * decay_chunk[:, i, :, None, None] + s_prev
        h0.append(h)
    h0 = torch.stack(h0, dim=1)
    final_state = h0[:, -1] * decay_chunk[:, -1][..., None, None] \
        + states[:, -1]
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", c_c, h0,
                           torch.exp(acum))
    y_intra = ssd_scan.ssd_intra_chunk_vjp(
        x_c.permute(0, 3, 1, 2, 4).contiguous(),
        dt_c.permute(0, 3, 1, 2).contiguous(),
        acum.permute(0, 3, 1, 2).contiguous(), b_c.contiguous(),
        c_c.contiguous()).permute(0, 2, 3, 1, 4)
    return (y_inter + y_intra).reshape(B, S, H, P).to(x.dtype), final_state


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_group_ssd_is_bit_for_bit_as_it_was(dtype, device):
    """``ops.ssd`` with one group, [B, S, N] taken as [B, S, 1, N], against
    its body before groups: outputs and every input's gradient equal."""
    dev = _card() if device == "cuda" else torch.device("cpu")
    g = torch.Generator().manual_seed(7)
    B, S, H, P, N = 2, 256, 4, 16, 8
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.rand((B, S, H), generator=g) * 0.2
    a_log = torch.randn((H,), generator=g) * 0.3
    b, c = (torch.randn((B, S, N), generator=g) for _ in range(2))
    dy, dfs = torch.randn((B, S, H, P), generator=g), torch.randn(
        (B, H, P, N), generator=g)

    def run(ssd):
        ts = [t.to(dev).requires_grad_() for t in (x, dt, a_log, b, c)]
        y, fs = ssd(ts[0].to(dtype), *ts[1:])
        ((y.float() * dy.to(dev)).sum() + (fs * dfs.to(dev)).sum()
         ).backward()
        return [y, fs] + [t.grad for t in ts]
    for got, want in zip(run(ops.ssd), run(_ssd_as_it_was)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_group_mamba_forward_is_bit_for_bit_as_it_was(dtype):
    """``mamba_forward`` with one group of B and C against its body before
    groups, verbatim, on ``_ssd_as_it_was``."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), d_model=32,
                              ssm_state=8, ssm_head_dim=8)
    g = torch.Generator().manual_seed(9)
    p = ssm.init_mamba(g, cfg, dtype)
    p["norm"] = (torch.randn((64,), generator=g) * 0.1).to(dtype)
    x = torch.randn((2, 256, 32), generator=g).to(dtype)
    z = x @ p["w_z"]
    xs = ssm._causal_conv(x @ p["w_x"], p["conv_x_w"], p["conv_x_b"])
    b = ssm._causal_conv(x @ p["w_b"], p["conv_b_w"], p["conv_b_b"])
    c = ssm._causal_conv(x @ p["w_c"], p["conv_c_w"], p["conv_c_b"])
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    xh = xs.reshape(2, 256, 8, 8)
    y, _ = _ssd_as_it_was(xh, dt, p["a_log"], b, c)
    y = (y + xh * p["d_skip"][None, None, :, None].to(xh.dtype)).reshape(
        2, 256, 64)
    want = common.rms_norm(y * F.silu(z), p["norm"]) @ p["w_out"]
    assert torch.equal(ssm.mamba_forward(p, x, cfg), want)


def test_grouped_ssd_is_each_groups_one_group_ssd():
    """``ops.ssd`` with [B, S, G, N] gives each group's heads what the
    one-group call with that group's B and C gives them, and so do the
    gradients (both float32)."""
    g = torch.Generator().manual_seed(8)
    B, S, H, P, N, G = 1, 256, 8, 16, 8, 2
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.rand((B, S, H), generator=g) * 0.2
    a_log = torch.randn((H,), generator=g) * 0.3
    b, c = (torch.randn((B, S, G, N), generator=g) for _ in range(2))
    dy = torch.randn((B, S, H, P), generator=g)

    def grads(split):
        ts = [t.clone().requires_grad_() for t in (x, dt, b, c)]
        if split:
            hs = [slice(j * H // G, (j + 1) * H // G) for j in range(G)]
            y = torch.cat([ops.ssd(ts[0][:, :, s], ts[1][:, :, s],
                                   a_log[s], ts[2][:, :, j],
                                   ts[3][:, :, j])[0]
                           for j, s in enumerate(hs)], 2)
        else:
            y = ops.ssd(*ts[:2], a_log, *ts[2:])[0]
        (y * dy).sum().backward()
        return [y.detach()] + [t.grad for t in ts]
    for got, want in zip(grads(False), grads(True)):
        assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)


def test_cost_counter_counts_each_group():
    x = torch.empty((1, 8, 4, 128, 64), device="meta")
    one = op_cost._ssd_unit(x, torch.empty((1, 4, 1, 128, 64),
                                           device="meta"))
    two = op_cost._ssd_unit(x, torch.empty((1, 4, 2, 128, 64),
                                           device="meta"))
    tri = 128 * 129 // 2
    assert two[0] - one[0] == 2 * 4 * tri * 64
    assert two[1] - one[1] == 4 * 2 * 4 * 128 * 64


def test_chip_smoke_holds_the_cells_kernel_shapes():
    """chip_smoke.py's phase 7 holds both kernels at the Zamba2-7B cell's
    shapes: flash on the tensor-core path at D 224 and the published
    scale, with its lse; the SSD with B and C in the cell's 2 groups (32 x
    14 blocks)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    (case, B, H, KV, Sq, Sk, D, causal, window, cap, dtype,
     _), = cs.TRAIN_FLASH_CASES
    assert (B, H, KV, Sq, Sk, D, causal, window, cap, dtype) == \
        (1, 32, 32, 4096, 4096, 224, True, 0, 0.0, "bf16")
    assert fa.flash_path(torch.bfloat16, D) == "wgmma"
    assert cs.FLASH_SCALES[case] == (224 / 2) ** -0.5
    assert case in cs.LSE_CASES
    (case, B, S, H, P, N, Lc, dtype, G), = cs.GROUPED_SSD_CASES
    assert ssd_scan.ssd_launch(B, H, S // Lc, Lc, P, N, 2, G).grid == \
        (32, 14)
    assert set(cs.TRAIN_STEP_LAUNCHES) == {"flash zamba2-7b",
                                           "ssd zamba2-7b"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Sq,Sk,causal,window,cap", [
    (32, 4096, 4096, True, 0, 0.0),        # Zamba2-7B's site, one sequence
    (4, 200, 333, True, 0, 0.0),
    (4, 333, 333, False, 0, 0.0),
    (4, 130, 200, True, 100, 30.0),
])
def test_flash_224_matches_plain_on_card(H, Sq, Sk, causal, window, cap):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(Sq)
    q = torch.randn((1, H, Sq, 224), generator=g, device=dev).bfloat16()
    k = torch.randn((1, H, Sk, 224), generator=g, device=dev).bfloat16()
    v = torch.randn((1, H, Sk, 224), generator=g, device=dev).bfloat16()
    scale = 112 ** -0.5
    ops.reset_launch_counts()
    out, lse = fa.flash_attention(q, k, v, causal, window, cap, scale,
                                  return_lse=True)
    want, want_lse = fa.plain_flash_attention(q, k, v, causal, window, cap,
                                              scale, return_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 1}
    assert _rel(out, want) <= 8e-3
    assert float((lse - want_lse).abs().max()) <= 1e-4 * max(
        1.0, float(want_lse.abs().max()))
    # nothing past D leaks in: the same result twice, bit for bit
    assert torch.equal(fa.flash_attention(q, k, v, causal, window, cap,
                                          scale), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,G,NC,Lc,P,N", [
    (112, 2, 4, 128, 64, 64),     # Zamba2-7B's layer, 4 chunks
    (24, 2, 2, 128, 64, 32),      # 12 heads a group: blocks of 8 and 4
    (12, 3, 2, 200, 100, 20),     # ragged chunk and P, two row tiles
    (8, 4, 3, 64, 32, 130),       # 2 heads a group, N past two chunks
])
def test_ssd_kernel_groups_match_plain_on_card(dtype, H, G, NC, Lc, P, N):
    dev = _card()
    dt_ = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(H + G)
    x = torch.randn((2, H, NC, Lc, P), generator=g, device=dev).to(dt_)
    dt = torch.rand((2, H, NC, Lc), generator=g, device=dev) * 0.2
    acum = torch.cumsum(-dt * 0.5, dim=-1)
    b = torch.randn((2, NC, G, Lc, N), generator=g, device=dev) * 0.3
    c = torch.randn((2, NC, G, Lc, N), generator=g, device=dev) * 0.3
    ops.reset_launch_counts()
    out = ssd_scan.ssd_intra_chunk(x, dt, acum, b, c)
    want = ssd_scan.plain_ssd_intra_chunk(x, dt, acum, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES == {"ssd_intra_chunk": 1}
    assert _rel(out, want) <= (1e-5 if dtype == "f32" else 8e-3)


@pytest.mark.gpu
def test_ssd_kernel_one_group_either_layout_on_card():
    """B and C as [B, NC, Lc, N] and as one group [B, NC, 1, Lc, N] run the
    same blocks on the same numbers: equal bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((2, 12, 3, 128, 64), generator=g, device=dev).bfloat16()
    dt = torch.rand((2, 12, 3, 128), generator=g, device=dev) * 0.2
    acum = torch.cumsum(-dt * 0.5, dim=-1)
    b = torch.randn((2, 3, 128, 64), generator=g, device=dev) * 0.3
    c = torch.randn((2, 3, 128, 64), generator=g, device=dev) * 0.3
    one = ssd_scan.ssd_intra_chunk(x, dt, acum, b, c)
    grouped = ssd_scan.ssd_intra_chunk(x, dt, acum, b[:, :, None].contiguous(),
                                       c[:, :, None].contiguous())
    assert torch.equal(one, grouped)
