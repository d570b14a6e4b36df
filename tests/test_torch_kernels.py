"""The port's model-zoo kernels on the CPU (their plain versions) and
``kernels/ops.py`` against the JAX package: flash attention vs Pallas
interpret mode, the SSD intra-chunk term vs Pallas interpret mode, and the
ops wrappers vs ``repro.kernels.ops``.  Inputs are drawn with numpy from a
seed and handed to both."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ssd_scan import ssd_intra_chunk as j_ssd_intra
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.abs(b).max() + 1e-9))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _pair(a, dtype):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``
    (``"f32"`` or ``"bf16"``)."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


# the sweep of tests/test_kernels.py
ATTN_SWEEP = [
    # B, H, KV, S, D, causal, window, softcap, dtype
    (1, 2, 1, 128, 32, True, 0, 0.0, "f32"),
    (2, 4, 2, 256, 64, True, 0, 0.0, "f32"),
    (1, 8, 4, 128, 64, True, 0, 50.0, "f32"),
    (1, 4, 4, 256, 32, True, 64, 0.0, "f32"),
    (2, 2, 1, 256, 128, False, 0, 0.0, "f32"),
    (1, 4, 2, 128, 64, True, 32, 30.0, "f32"),
    (1, 2, 2, 128, 32, True, 0, 0.0, "bf16"),
]


def _qkv(B, H, KV, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D), dtype=np.float32),
            rng.standard_normal((B, KV, Sk, D), dtype=np.float32),
            rng.standard_normal((B, KV, Sk, D), dtype=np.float32))


@pytest.mark.parametrize("B,H,KV,S,D,causal,win,cap,dtype", ATTN_SWEEP)
def test_plain_flash_matches_pallas_interpret(B, H, KV, S, D, causal, win,
                                              cap, dtype):
    q, k, v = _qkv(B, H, KV, S, S, D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = j_flash(jq, jk, jv, causal=causal, window=win, logit_softcap=cap,
                   block_q=64, block_k=64, interpret=True)
    tops.reset_launch_counts()
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=win,
                              logit_softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert tfa.LAUNCHES == {"flash_attention": 0,       # CPU: plain version
                            "flash_attention_wgmma": 0}
    tol = 2e-2 if dtype == "bf16" else 2e-5
    assert _rel_err(_np(got), _np(want)) < tol


def test_plain_flash_right_aligned_and_ragged():
    """Queries right-aligned into a longer KV (q_offset = Sk - Sq), and
    sequence lengths that are not multiples of the 64-row tiles."""
    for Sq, Sk, win in ((64, 256, 0), (40, 100, 0), (50, 130, 48)):
        q, k, v = _qkv(2, 4, 2, Sq, Sk, 32, seed=Sq)
        got = tfa.plain_flash_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), window=win)
        want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=win)
        assert _rel_err(_np(got), _np(want)) < 2e-5
        oracle = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), window=win)
        assert _rel_err(_np(oracle), _np(want)) < 2e-5


@pytest.mark.parametrize("B,H,KV,S,D,causal,win,cap,dtype", ATTN_SWEEP[:6])
def test_ops_attention_matches_jax_ops(B, H, KV, S, D, causal, win, cap,
                                       dtype):
    q, k, v = _qkv(B, H, KV, S, S, D, seed=1)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=win, logit_softcap=cap,
                          impl="jnp")
    # non-contiguous inputs, as the models hand them over
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in (q, k, v))
    got = tops.attention(tq, tk, tv, causal=causal, window=win,
                         logit_softcap=cap)
    assert _rel_err(_np(got), _np(want)) < 1e-5


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 30.0)])
def test_decode_attention_matches_jax(quant, window, cap):
    rng = np.random.default_rng(2)
    B, H, KV, Smax, D, n = 2, 8, 2, 32, 16, 21
    q = rng.standard_normal((B, H, 1, D), dtype=np.float32)
    kc = rng.standard_normal((B, KV, Smax, D), dtype=np.float32)
    vc = rng.standard_normal((B, KV, Smax, D), dtype=np.float32)
    if quant:
        jk, jks = jops.quantize_kv(jnp.asarray(kc))
        jv, jvs = jops.quantize_kv(jnp.asarray(vc))
        tk, tks = tops.quantize_kv(torch.from_numpy(kc))
        tv, tvs = tops.quantize_kv(torch.from_numpy(vc))
        assert np.array_equal(np.asarray(jk), tk.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_allclose(np.asarray(jks), tks.numpy(), rtol=1e-6)
    else:
        jk, jv, jks, jvs = jnp.asarray(kc), jnp.asarray(vc), None, None
        tk, tv, tks, tvs = (torch.from_numpy(kc), torch.from_numpy(vc),
                            None, None)
    want = jops.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(n),
                                 window=window, logit_softcap=cap,
                                 k_scale=jks, v_scale=jvs)
    got = tops.decode_attention(torch.from_numpy(q), tk, tv, n,
                                window=window, logit_softcap=cap,
                                k_scale=tks, v_scale=tvs)
    assert got.shape == (B, H, 1, D)
    assert _rel_err(_np(got), _np(want)) < 1e-5


def test_quantize_kv_matches_jax_bf16():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 9, 32), dtype=np.float32) * 3
    jx, tx = _pair(x, "bf16")
    jq, js = jops.quantize_kv(jx)
    tq, ts = tops.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (2, 4, 9, 1)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-6)


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H),
                                             dtype=np.float32) - 1))
    a_log = (rng.standard_normal(H, dtype=np.float32) * 0.5).astype(
        np.float32)
    b = rng.standard_normal((B, S, N), dtype=np.float32) * 0.5
    c = rng.standard_normal((B, S, N), dtype=np.float32) * 0.5
    return x, dt.astype(np.float32), a_log, b, c


INTRA_SWEEP = [
    # B, H, NC, Lc, P, N, dtype
    (1, 2, 2, 32, 16, 8, "f32"),
    (2, 3, 1, 64, 32, 16, "f32"),
    (1, 2, 2, 128, 64, 64, "f32"),
    (2, 2, 2, 32, 16, 8, "bf16"),
    (1, 2, 2, 256, 128, 32, "f32"),
]


@pytest.mark.parametrize("B,H,NC,Lc,P,N,dtype", INTRA_SWEEP)
def test_plain_ssd_intra_matches_pallas_interpret(B, H, NC, Lc, P, N,
                                                  dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, H, NC, Lc, P), dtype=np.float32)
    dt = np.abs(rng.standard_normal((B, H, NC, Lc), dtype=np.float32)) * .1
    acum = np.cumsum(-dt * 0.7, axis=-1).astype(np.float32)
    b = rng.standard_normal((B, NC, Lc, N), dtype=np.float32) * 0.5
    c = rng.standard_normal((B, NC, Lc, N), dtype=np.float32) * 0.5
    jx, tx = _pair(x, dtype)
    want = j_ssd_intra(jx, jnp.asarray(dt), jnp.asarray(acum),
                       jnp.asarray(b), jnp.asarray(c), interpret=True)
    tops.reset_launch_counts()
    got = tssd.ssd_intra_chunk(tx, *(torch.from_numpy(a)
                                     for a in (dt, acum, b, c)))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert tssd.LAUNCHES == {"ssd_intra_chunk": 0}
    tol = 2e-2 if dtype == "bf16" else 1e-5
    assert _rel_err(_np(got), _np(want)) < tol


def test_plain_ssd_intra_makes_no_nan_above_the_diagonal():
    """Large decays overflow exp(acum_l - acum_m) above the diagonal; the
    plain version never forms it there."""
    Lc = 32
    x = torch.ones((1, 1, 1, Lc, 4))
    dt = torch.ones((1, 1, 1, Lc))
    acum = torch.cumsum(-torch.full((1, 1, 1, Lc), 10.0), -1)
    b = torch.zeros((1, 1, Lc, 2))
    c = torch.zeros((1, 1, Lc, 2))
    y = tssd.ssd_intra_chunk(x, dt, acum, b, c)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) == 0.0


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (2, 64, 3, 16, 8, 16, "f32"),
    (1, 256, 2, 32, 16, 128, "f32"),
    (2, 32, 2, 16, 8, 32, "f32"),
    (2, 64, 2, 16, 8, 16, "bf16"),
])
def test_ops_ssd_matches_jax_pallas_interpret(B, S, H, P, N, chunk, dtype):
    x, dt, a_log, b, c = _ssd_inputs(B, S, H, P, N, seed=5)
    jx, tx = _pair(x, dtype)
    jy, jstate = jops.ssd(jx, jnp.asarray(dt), jnp.asarray(a_log),
                          jnp.asarray(b), jnp.asarray(c), chunk=chunk,
                          impl="pallas_interpret")
    ty, tstate = tops.ssd(tx, *(torch.from_numpy(a)
                                for a in (dt, a_log, b, c)), chunk=chunk)
    assert ty.dtype == tx.dtype and ty.shape == (B, S, H, P)
    tol = 2e-2 if dtype == "bf16" else 1e-5
    assert _rel_err(_np(ty), _np(jy)) < tol
    assert _rel_err(_np(tstate), _np(jstate)) < tol


# ---------------------------------------------------------------------------
# the SSD kernel's launch geometry and an emulation of its tile walk and
# fragment layouts
# ---------------------------------------------------------------------------

def _ssd_shape(arch, batch=8, seq=512):
    """(B, H, NC, Lc, P, N) of a config's prefill at chunk 128."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (batch, cfg.ssm_heads, seq // 128, 128, cfg.ssm_head_dim,
            cfg.ssm_state)


#: name -> (B, H, NC, Lc, P, N, element bytes)
SSD_LAUNCH_CASES = {
    "mamba2-1.3b": (*_ssd_shape("mamba2-1.3b"), 2),
    "zamba2-1.2b": (*_ssd_shape("zamba2-1.2b"), 2),
    "zamba2-1.2b-f32": (*_ssd_shape("zamba2-1.2b"), 4),
    "lc256-p128": (2, 4, 2, 256, 128, 64, 4),
    "ragged-lc-p": (1, 3, 2, 200, 100, 20, 4),
    "ragged-bf16": (2, 5, 1, 72, 36, 130, 2),
    "head-groups": (2, 12, 66, 64, 32, 16, 2),
}


@pytest.mark.parametrize("case", sorted(SSD_LAUNCH_CASES))
def test_ssd_launch_geometry(case):
    B, H, NC, Lc, P, N, elem = SSD_LAUNCH_CASES[case]
    L = tssd.ssd_launch(B, H, NC, Lc, P, N, elem)
    # grid: every (b, chunk) once, every head in exactly one group
    assert L.grid == (B * NC, -(-H // L.hg))
    heads = [h for y in range(L.grid[1])
             for h in range(y * L.hg, min(H, (y + 1) * L.hg))]
    assert heads == list(range(H))
    # the head group: the kernel's, or every head if fewer
    assert L.hg == min(H, tssd.SSD_HG)
    # every (row tile, key tile <= row tile, P tile) once
    tiles = L.tiles()
    assert len(tiles) == len(set(tiles)) == \
        L.row_tiles * (L.row_tiles + 1) // 2 * L.p_tiles
    assert all(j <= i for i, j, _ in tiles)
    for size, width, n in ((Lc, tssd.SSD_TILE, L.row_tiles),
                           (P, tssd.SSD_PTILE, L.p_tiles),
                           (N, tssd.SSD_NCHUNK, L.n_chunks)):
        parts = [L.extent(t, size, width) for t in range(n)]
        assert all(e > 0 for _, e in parts)
        assert sum(e for _, e in parts) == size
        assert [s for s, _ in parts] == [t * width for t in range(n)]
    # the strips: a permutation; sub-partitions (warp % 4) get strips s and
    # 7 - s, equal work on a full diagonal tile
    strips = [L.strip(w) for w in range(tssd.SSD_WARPS)]
    assert sorted(strips) == list(range(tssd.SSD_WARPS))
    for sp in range(4):
        assert strips[sp] + strips[sp + 4] == 7
    # k-steps: every key a strip's valid rows need, none past the diagonal
    for i, j, _ in tiles:
        nr = L.extent(i, Lc, tssd.SSD_TILE)[1]
        nk = L.extent(j, Lc, tssd.SSD_TILE)[1]
        for w in range(tssd.SSD_WARPS):
            r0, kt = 16 * L.strip(w), L.ksteps(w, i, j)
            assert 0 <= kt <= 16
            if r0 >= nr:
                assert kt == 0
                continue
            last = min(r0 + 15, nr - 1) if i == j else nk - 1
            assert 8 * kt > min(last, nk - 1) and 8 * (kt - 1) < nk
            if i == j:
                assert 8 * (kt - 1) <= r0 + 15
    # shared memory, the workspace
    assert L.smem <= tssd.SMEM_MAX
    assert L.smem == 2 * 128 * 68 * 4 + 3 * 128 * L.x_pitch * elem \
        + 8 * (3 * 128 + 16 + 128 * 8) * 4
    assert tssd.SSD_HG == 8                                # the kernel's
    assert L.x_pitch == (68 if elem == 4 else 72)
    assert L.workspace == (Lc > tssd.SSD_TILE)
    assert len(L.params(0, True, True)) == 13
    if case in ("mamba2-1.3b", "zamba2-1.2b"):
        assert (B, H, NC, Lc, P) == (8, 64, 4, 128, 64)
        assert (L.hg, L.grid) == (8, (32, 8))


def test_ssd_launch_refuses_empty_dims():
    with pytest.raises(ValueError, match="dims"):
        tssd.ssd_launch(1, 0, 1, 128, 64, 64)


#: lane (g, t) of a warp, and the accumulator element e it holds: row
#: g + 8 (e >> 1), column 2 t + (e & 1) of the m16n8 tile
_LANE = torch.arange(32)
_G, _T = _LANE // 4, _LANE % 4


def _a_fragment(s8):
    """The tf32 A fragment (16 x 8) the kernel builds from one k-step of S
    in the accumulator's layout: a0 = v[0] at (g, t), a1 = v[2] at (g + 8,
    t), a2 = v[1] at (g, t + 4), a3 = v[3] at (g + 8, t + 4)."""
    v = [s8[_G + 8 * (e >> 1), 2 * _T + (e & 1)] for e in range(4)]
    a = torch.full((16, 8), float("nan"))
    a[_G, _T], a[_G + 8, _T] = v[0], v[2]
    a[_G, _T + 4], a[_G + 8, _T + 4] = v[1], v[3]
    return a


def _b_fragment(x8):
    """The B fragments (8 x 8 n-tiles side by side) the kernel reads from
    the staged x rows of one k-step: b0 (row t, column g) from key 2t, b1
    (row t + 4) from key 2t + 1."""
    b = torch.full(x8.shape, float("nan"))
    for n0 in range(0, x8.shape[1], 8):
        b[_T, n0 + _G] = x8[2 * _T, n0 + _G]
        b[_T + 4, n0 + _G] = x8[2 * _T + 1, n0 + _G]
    return b


def _emulate_ssd(L, x, dt, acum, bm, cm):
    """ssd_intra_kernel's walk in torch, float32: per block (b * NC +
    chunk, head group), per tile pair (i, j <= i), each warp's strip of G
    in N chunks of 64 (each from zero), the decay factored at each 8-key
    block's last valid key (per key u = exp(e_b - acum_m) dt_m, per block
    c_b = exp(e_{b+1} - e_b), a row's factor formed at the first block
    wholly below its own and stepped down the blocks by c_b; the row's own
    block on the diagonal exp(acum_l - acum_m) dt_m directly), then per
    (head, P tile) S on and below the
    diagonal through the k-steps the strip needs, 32-key steps from zero,
    last first, with the A/B fragments in the kernel's lane layout, and the
    key tiles' partial sums through a float32 workspace in order.  Counts
    the writes of every output element."""
    B, H, NC, Lc, P, N = L.B, L.H, L.NC, L.Lc, L.P, L.N
    T, PT, NB = tssd.SSD_TILE, tssd.SSD_PTILE, tssd.SSD_NCHUNK
    y = torch.full(x.shape, float("nan"))
    ws = torch.full(x.shape, float("nan"))
    writes = torch.zeros(x.shape, dtype=torch.int32)
    xf = x.float()
    for bc, grp in itertools.product(range(L.grid[0]), range(L.grid[1])):
        b, ch = divmod(bc, NC)
        heads = range(grp * L.hg, min(H, (grp + 1) * L.hg))
        for i in range(L.row_tiles):
            i0, nr = L.extent(i, Lc, T)
            for j in range(i + 1):
                j0, nk = L.extent(j, Lc, T)
                diag = i == j
                # staged C and B: zero past the tile's rows and past N
                cpad = torch.zeros((T, L.n_chunks * NB))
                bpad = torch.zeros((T, L.n_chunks * NB))
                cpad[:nr, :N] = cm[b, ch, i0:i0 + nr]
                bpad[:nk, :N] = bm[b, ch, j0:j0 + nk]
                # the factored decay of each head: zero past the keys
                ka, kdt, ku = {}, {}, {}
                last = (torch.arange(T) | 7).clamp(max=nk - 1)  # e_b's key
                for h in heads:
                    ka[h] = torch.zeros(T)
                    ka[h][:nk] = acum[b, h, ch, j0:j0 + nk]
                    kdt[h] = torch.zeros(T)
                    kdt[h][:nk] = dt[b, h, ch, j0:j0 + nk]
                    ku[h] = torch.where(
                        torch.arange(T) < nk,
                        torch.exp(ka[h][last] - ka[h]) * kdt[h], 0.0)
                for w in range(tssd.SSD_WARPS):
                    r0, kt = 16 * L.strip(w), L.ksteps(w, i, j)
                    if kt == 0:
                        continue
                    # the strip of G in registers: whole halves of 8
                    # n-tiles, each N chunk of 64 from zero
                    G = torch.zeros((16, T))
                    for half in range(2):
                        if 64 * half >= 8 * kt:
                            continue
                        keys = slice(64 * half, 64 * half + 64)
                        for n0 in range(0, N, NB):
                            G[:, keys] += cpad[r0:r0 + 16, n0:n0 + NB] \
                                @ bpad[keys, n0:n0 + NB].T
                    rows = torch.arange(16) + r0
                    for h, p in itertools.product(heads, range(L.p_tiles)):
                        p0, pw = L.extent(p, P, PT)
                        nn = -(-pw // 8)
                        xs = torch.zeros((T, 8 * nn))
                        xs[:nk, :pw] = xf[b, h, ch, j0:j0 + nk, p0:p0 + pw]
                        valid = rows < nr
                        own = rows.clamp(max=nr - 1)
                        al = torch.where(
                            valid, ka[h][own] if diag
                            else acum[b, h, ch, i0 + own], torch.zeros(()))
                        kd = rows // 8 - 1 if diag \
                            else torch.full((16,), kt - 1)
                        fac = torch.zeros(16)
                        acc = torch.zeros((16, 8 * nn))
                        for s4 in reversed(range(0, kt, 4)):
                            pp = torch.zeros_like(acc)
                            for kk in reversed(range(s4, s4 + 4)):
                                c_kk = torch.exp(ka[h][last[8 * kk + 8]]
                                                 - ka[h][last[8 * kk]]) \
                                    if kk < T // 8 - 1 else torch.ones(())
                                fac = torch.where(
                                    kd == kk,
                                    torch.exp(al - ka[h][last[8 * kk]]),
                                    torch.where(kk < kd, fac * c_kk, 0.0))
                                if kk >= kt:
                                    continue
                                keys = torch.arange(8 * kk, 8 * kk + 8)
                                ok = (keys[None] < nk) & valid[:, None]
                                s8 = G[:, keys] * fac[:, None] \
                                    * ku[h][keys][None]
                                if diag:        # the rows' own block
                                    own_b = (rows // 8 == kk)[:, None]
                                    ok &= keys[None] <= rows[:, None]
                                    direct = G[:, keys] * (torch.exp(
                                        torch.where(ok, al[:, None]
                                                    - ka[h][keys][None], 0.0)
                                    ) * kdt[h][keys][None])
                                    s8 = torch.where(own_b, direct, s8)
                                s8 = torch.where(ok, s8, 0.0)
                                pp += _a_fragment(s8) @ _b_fragment(
                                    xs[8 * kk:8 * kk + 8])
                            acc += pp
                        for r in range(16):
                            row = r0 + r
                            if row >= nr:
                                continue
                            v = acc[r, :pw]
                            dst = (b, h, ch, i0 + row, slice(p0, p0 + pw))
                            if L.row_tiles > 1:
                                if j > 0:
                                    v = ws[dst] + v
                                if not diag:
                                    ws[dst] = v
                                    continue
                            y[dst] = v
                            writes[dst] += 1
    assert bool((writes == 1).all()), "an output element written " \
        f"{int(writes.min())}..{int(writes.max())} times"
    return y.to(x.dtype)


@pytest.mark.parametrize("B,H,NC,Lc,P,N,dtype,step,spread", [
    (1, 3, 1, 128, 64, 64, "f32", 0.1, True),
    (1, 2, 1, 256, 128, 32, "f32", 0.1, True),
    (1, 2, 1, 200, 100, 20, "f32", 0.1, True),
    (1, 3, 2, 72, 36, 130, "bf16", 0.1, True),
    (1, 9, 140, 16, 8, 8, "f32", 0.1, True),
    (1, 2, 1, 256, 64, 16, "f32", 3.0, True),   # decays past float's range
    (1, 2, 1, 256, 64, 16, "f32", 21.5, False),  # ~15 a key, every key
])
def test_ssd_kernel_emulation_matches_plain(B, H, NC, Lc, P, N, dtype,
                                            step, spread):
    """The kernel's head groups, tile walk, causal k-step limits, N chunks,
    factored decay, key permutation in the A/B fragments and workspace
    order compute plain_ssd_intra_chunk's function (float32: 1e-5; bf16
    output: one ulp of it); every output element written once.  dt is
    |normal| x ``step``, or ``step`` at every key (``spread`` False)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((B, H, NC, Lc, P),
                                             dtype=np.float32))
    x = x.to(torch.bfloat16) if dtype == "bf16" else x
    dt = torch.from_numpy(np.abs(rng.standard_normal(
        (B, H, NC, Lc), dtype=np.float32)) * step) if spread \
        else torch.full((B, H, NC, Lc), step)
    acum = torch.cumsum(-dt * 0.7, dim=-1)
    bm, cm = (torch.from_numpy(rng.standard_normal((B, NC, Lc, N),
                                                    dtype=np.float32) * 0.5)
              for _ in range(2))
    L = tssd.ssd_launch(B, H, NC, Lc, P, N, x.element_size())
    if NC == 140:               # groups of 8 heads, the last one partial
        assert (L.hg, L.grid) == (8, (140, 2))
    got = _emulate_ssd(L, x, dt, acum, bm, cm)
    want = tssd.plain_ssd_intra_chunk(x, dt, acum, bm, cm)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1e-5 if dtype == "f32" else 8e-3
    assert _rel_err(_np(got), _np(want)) <= tol


def test_ops_ssd_chunk256_p128_matches_jax_and_the_f64_oracle():
    """chunk 256 and head dim 128 (two row tiles, two P tiles on the card).
    Against the JAX package in interpret mode at 1e-5 with dt in Mamba2's
    range ([1e-3, 0.1], as the models' softplus(dt + dt_bias) gives); with
    ``_ssd_inputs``' larger steps (dt up to ~5) the decays span e^-700 over
    a chunk, and there the JAX side is itself 1.3e-5 from a float64 run,
    so that case is held against the sequential float64 oracle
    (``ref.ssd_ref``) at 1e-5 instead."""
    B, S, H, P, N, chunk = 1, 512, 2, 128, 16, 256
    x, dt, a_log, b, c = _ssd_inputs(B, S, H, P, N, seed=5)
    ty, _ = tops.ssd(*(torch.from_numpy(a) for a in (x, dt, a_log, b, c)),
                     chunk=chunk)
    want = tref.ssd_ref(*(torch.from_numpy(a).double()
                          for a in (x, dt, a_log, b, c)))
    assert _rel_err(_np(ty), want.numpy()) < 1e-5
    dt = (np.random.default_rng(9).random((B, S, H), dtype=np.float32)
          * 0.1 + 1e-3).astype(np.float32)
    jy, jstate = jops.ssd(*(jnp.asarray(a) for a in (x, dt, a_log, b, c)),
                          chunk=chunk, impl="pallas_interpret")
    ty, tstate = tops.ssd(*(torch.from_numpy(a) for a in (x, dt, a_log, b, c)),
                          chunk=chunk)
    assert _rel_err(_np(ty), _np(jy)) < 1e-5
    assert _rel_err(_np(tstate), _np(jstate)) < 1e-5


def test_ssd_decode_matches_jax():
    rng = np.random.default_rng(6)
    B, H, P, N = 2, 3, 8, 4
    h = rng.standard_normal((B, H, P, N), dtype=np.float32)
    x = rng.standard_normal((B, H, P), dtype=np.float32)
    dt = np.abs(rng.standard_normal((B, H), dtype=np.float32))
    a_log = rng.standard_normal(H, dtype=np.float32)
    b = rng.standard_normal((B, N), dtype=np.float32)
    c = rng.standard_normal((B, N), dtype=np.float32)
    jh, jy = jops.ssd_decode(*(jnp.asarray(a) for a in (h, x, dt, a_log, b,
                                                        c)))
    th, ty = tops.ssd_decode(*(torch.from_numpy(a) for a in (h, x, dt,
                                                             a_log, b, c)))
    assert _rel_err(_np(th), _np(jh)) < 1e-5
    assert _rel_err(_np(ty), _np(jy)) < 1e-5


def test_ssd_ref_matches_jax_ref():
    x, dt, a_log, b, c = _ssd_inputs(2, 24, 2, 8, 4, seed=7)
    want = jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, a_log, b, c)))
    got = tref.ssd_ref(*(torch.from_numpy(a) for a in (x, dt, a_log, b, c)))
    assert _rel_err(_np(got), _np(want)) < 1e-5


def test_wrappers_check_their_inputs():
    q = torch.zeros((1, 4, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, torch.zeros((1, 3, 8, 16)),
                            torch.zeros((1, 3, 8, 16)))
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2), kv, kv)
    x = torch.zeros((1, 2, 1, 8, 4))
    f = torch.zeros((1, 2, 1, 8))
    bc = torch.zeros((1, 1, 8, 3))
    with pytest.raises(ValueError, match="shape"):
        tssd.ssd_intra_chunk(x, f, f, bc, torch.zeros((1, 1, 8, 2)))
    with pytest.raises(TypeError, match="float32"):
        tssd.ssd_intra_chunk(x, f.double(), f, bc, bc)
    with pytest.raises(ValueError, match="multiple"):
        tops.ssd(torch.zeros((1, 12, 2, 4)), torch.zeros((1, 12, 2)),
                 torch.zeros(2), torch.zeros((1, 12, 3)),
                 torch.zeros((1, 12, 3)), chunk=8)


# ---------------------------------------------------------------------------
# flash attention's two kernels: the path table and the tensor-core
# kernel's numerics (bf16 P in P V), emulated on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py (standard library at import) for its FLASH_CASES and
    BF16_TOL."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flash_path_table():
    for d in tfa.HEAD_DIMS:
        assert tfa.flash_path(torch.float32, d) == "fma"
    assert [tfa.flash_path(torch.bfloat16, d) for d in tfa.HEAD_DIMS] == \
        ["fma", "fma", "wgmma", "wgmma", "wgmma"]
    assert set(tfa.PATHS.values()) == {"fma", "wgmma"}
    for dtype, d in ((torch.float16, 64), (torch.bfloat16, 96),
                     (torch.float32, 512), (torch.bfloat16, 8)):
        with pytest.raises(ValueError, match="no kernel"):
            tfa.flash_path(dtype, d)
    # every bf16 case chip_smoke.py times runs on the tensor cores, the f32
    # case on the FMA tile
    for case in _chip_smoke().FLASH_CASES:
        dtype, D = case[10], case[6]
        want = "wgmma" if dtype == "bf16" else "fma"
        assert tfa.flash_path({"bf16": torch.bfloat16,
                               "f32": torch.float32}[dtype], D) == want


def _wgmma_flash_emulation(q, k, v, causal, window, cap):
    """flash_wgmma_kernel's arithmetic in torch: 64-row query tiles, key
    tiles of 128 at D 64 and 64 otherwise, f32 scores in log2 units
    (soft-capped, then masked to -inf), exp2 online softmax subtracting 0
    while a row's max is -inf, P rounded to bf16 before P V (l from the
    unrounded P), O / max(l, 1e-30) in bf16."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    bk = 128 if D == 64 else 64
    scale, log2e = D ** -0.5, 1.4426950408889634
    qg = q.float().reshape(B, KV, H // KV, Sq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    out = torch.empty((B, KV, H // KV, Sq, D), dtype=q.dtype)
    for q0 in range(0, Sq, 64):
        qb = qg[:, :, :, q0:q0 + 64]
        bq = qb.shape[3]
        o = torch.zeros(qb.shape)
        m = torch.full(qb.shape[:-1], -float("inf"))
        l = torch.zeros(qb.shape[:-1])
        for k0 in range(0, Sk, bk):
            kb, vb = kf[:, :, :, k0:k0 + bk], vf[:, :, :, k0:k0 + bk]
            s = qb @ kb.transpose(-1, -2)
            s = torch.tanh(s * scale / cap) * cap * log2e if cap > 0 \
                else s * (scale * log2e)
            mask = tfa._mask(q0, bq, k0, kb.shape[3], Sk - Sq, causal,
                             window, "cpu")
            s = torch.where(mask, s, -float("inf"))
            mn = torch.maximum(m, s.amax(-1))
            base = torch.where(mn == -float("inf"), 0.0, mn)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l, m = l * alpha + p.sum(-1), mn
            o = o * alpha[..., None] \
                + p.to(torch.bfloat16).float() @ vb
        out[:, :, :, q0:q0 + bq] = (
            o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, H, Sq, D)


def _narrowed_bf16_flash_cases():
    """Each bf16 row of chip_smoke.py's FLASH_CASES at batch 1, at most two
    KV heads (the GQA ratio kept), a quarter of the sequence plus 5 (ragged
    tiles) and half the window."""
    cases = []
    for (name, B, H, KV, Sq, Sk, D, causal, window, cap, dtype,
         _) in _chip_smoke().FLASH_CASES:
        if dtype == "bf16":
            kv = min(KV, 2)
            cases.append((name, kv * (H // KV), kv, Sq // 4 + 5, Sk // 4 + 5,
                          D, causal, window // 2, cap))
    return cases


@pytest.mark.parametrize("case", range(7))
def test_bf16_p_in_pv_stays_within_bf16_tol(case):
    cases = _narrowed_bf16_flash_cases()
    assert len(cases) == 7
    name, H, KV, Sq, Sk, D, causal, window, cap = cases[case]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, H, KV, Sq, Sk, D, seed=case))
    want = tfa.plain_flash_attention(q, k, v, causal, window, cap)
    got = _wgmma_flash_emulation(q, k, v, causal, window, cap)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = _rel_err(_np(got), _np(want))
    assert err <= _chip_smoke().BF16_TOL, (name, err)
