"""The port's training path against the JAX package, in f32 on the CPU,
with the same numpy inputs handed to both: the flash VJP (out, lse and
dq/dk/dv) against ``jax.vjp`` of ``repro.kernels.ops.flash_attention_vjp``;
the SSD gradients against ``jax.vjp`` of ``ssd(impl="jnp")`` and the
closed-form intra-chunk backward against autograd of its plain version;
RMSNorm's VJP and the losses; and the reference's end-to-end training
cases (``tests/test_e2e.py``) on the port with ``device="cpu"``.  The
models' gradients and whole train steps are in
``test_torch_train_models.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    workers on the same cores, and each worker's default thread pool (one
    thread a core) then oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _err(got, want):
    """Max abs error of ``got`` over the max |want|."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.abs(want).max() + 1e-30))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

#: B, H, KV, Sq, Sk, D, causal, window, softcap, block_k
VJP_CASES = {
    "causal": (2, 4, 4, 32, 32, 16, True, 0, 0.0, 16),
    "window": (1, 4, 2, 48, 48, 16, True, 16, 0.0, 16),
    "softcap": (1, 2, 2, 32, 32, 32, True, 0, 30.0, 16),
    "gqa": (2, 8, 2, 32, 32, 16, True, 0, 0.0, 32),
    "sq-lt-sk": (1, 4, 2, 16, 64, 16, True, 0, 0.0, 16),
    "non-causal": (1, 4, 2, 24, 32, 16, False, 0, 0.0, 8),
}


@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_flash_attention_vjp_matches_jax(case):
    B, H, KV, Sq, Sk, D, causal, window, cap, bk = VJP_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, KV, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, KV, Sk, D), dtype=np.float32)
    do = rng.standard_normal((B, H, Sq, D), dtype=np.float32)

    def jfn(q_, k_, v_):
        return jops.flash_attention_vjp(q_, k_, v_, causal=causal,
                                        window=window, logit_softcap=cap,
                                        block_k=bk)
    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    _, jlse = jops._chunked_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window, cap,
        None, bk, return_lse=True)

    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tops.flash_attention_vjp(tq, tk, tv, causal=causal, window=window,
                                   logit_softcap=cap, block_k=bk)
    out.backward(torch.from_numpy(do))
    _, lse = tfa.flash_attention(_t(q), _t(k), _t(v), causal, window, cap,
                                 return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, Sq)
    for got, want in ((out, jout), (lse, jlse), (tq.grad, jdq),
                      (tk.grad, jdk), (tv.grad, jdv)):
        assert _err(got, want) <= 1e-5


def test_flash_lse_of_the_plain_walk():
    """The plain version's lse is the log-sum-exp of the masked scores."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 2, 70, 16), dtype=np.float32))
    k = _t(rng.standard_normal((1, 2, 90, 16), dtype=np.float32))
    out, lse = tfa.plain_flash_attention(q, k, k, True, 30, 20.0,
                                         return_lse=True)
    s = torch.tanh(q @ k.transpose(-1, -2) * 0.25 / 20.0) * 20.0
    qpos = torch.arange(70)[:, None] + 20
    kpos = torch.arange(90)[None, :]
    s = s.masked_fill(~((kpos <= qpos) & (kpos > qpos - 30)), -torch.inf)
    assert _err(lse, torch.logsumexp(s, -1)) <= 1e-6
    assert torch.equal(out, tfa.plain_flash_attention(q, k, k, True, 30,
                                                      20.0))


def test_flash_attention_vjp_raises_on_ragged_key_chunks():
    q = torch.zeros((1, 2, 16, 16), requires_grad=True)
    kv = torch.zeros((1, 2, 48, 16), requires_grad=True)
    out = tops.flash_attention_vjp(q, kv, kv, block_k=32)
    with pytest.raises(ValueError, match="multiple of the key chunk 32"):
        out.sum().backward()


def test_attention_takes_the_vjp_only_for_gradients():
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((1, 2, 16, 16), dtype=np.float32), True)
    with torch.no_grad():
        assert tops.attention(q, q, q).grad_fn is None
    out = tops.attention(q, q, q)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert tops.attention(q.detach(), q.detach(), q.detach()).grad_fn \
        is None


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(B=2, S=32, H=3, P=8, N=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P), dtype=np.float32),
            rng.uniform(0.01, 0.3, (B, S, H)).astype(np.float32),
            (rng.standard_normal(H) * 0.5).astype(np.float32),
            rng.standard_normal((B, S, N), dtype=np.float32),
            rng.standard_normal((B, S, N), dtype=np.float32))


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_grads_match_jax(chunk):
    ins = _ssd_inputs()
    rng = np.random.default_rng(1)
    B, S, H, P = ins[0].shape
    dy = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dst = rng.standard_normal((B, H, P, ins[3].shape[-1]), dtype=np.float32)
    (jy, jst), vjp = jax.vjp(
        lambda *a: jops.ssd(*a, chunk=chunk, impl="jnp"),
        *map(jnp.asarray, ins))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    targs = [_t(a, True) for a in ins]
    y, st = tops.ssd(*targs, chunk=chunk)
    ((y * _t(dy)).sum() + (st * _t(dst)).sum()).backward()
    assert _err(y, jy) <= 1e-4 and _err(st, jst) <= 1e-4
    for t, g in zip(targs, jgrads):
        assert _err(t.grad, g) <= 1e-4


def test_ssd_intra_backward_matches_autograd_of_plain():
    rng = np.random.default_rng(2)
    B, H, NC, Lc, P, N = 2, 3, 2, 16, 8, 5
    x = rng.standard_normal((B, H, NC, Lc, P), dtype=np.float32)
    dt = rng.uniform(0.01, 0.3, (B, H, NC, Lc)).astype(np.float32)
    a = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    acum = np.cumsum(dt * a[None, :, None, None], -1).astype(np.float32)
    b = rng.standard_normal((B, NC, Lc, N), dtype=np.float32)
    c = rng.standard_normal((B, NC, Lc, N), dtype=np.float32)
    dy = rng.standard_normal(x.shape, dtype=np.float32)
    args = [_t(v, True) for v in (x, dt, acum, b, c)]
    tssd.plain_ssd_intra_chunk(*args).backward(_t(dy))
    closed = tssd.ssd_intra_chunk_bwd(_t(dy), *map(_t, (x, dt, acum, b, c)))
    for t, g in zip(args, closed):
        assert _err(g, t.grad) <= 1e-5
    vargs = [_t(v, True) for v in (x, dt, acum, b, c)]
    y = tssd.ssd_intra_chunk_vjp(*vargs)
    assert torch.equal(y, tssd.plain_ssd_intra_chunk(*map(_t, (x, dt, acum,
                                                               b, c))))
    y.backward(_t(dy))
    for t, g in zip(vargs, closed):
        assert torch.equal(t.grad, g)


# ---------------------------------------------------------------------------
# RMSNorm and the losses
# ---------------------------------------------------------------------------

def _ulp_bf16(w):
    w = np.abs(np.asarray(w, np.float64))
    return np.where(w > 0, 2.0 ** (np.floor(np.log2(np.maximum(w, 1e-38)))
                                   - 7), 2.0 ** -133)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_vjp_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 32), dtype=np.float32)
    scale = (rng.standard_normal(32) * 0.3).astype(np.float32)
    dy = rng.standard_normal((3, 5, 32), dtype=np.float32)
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jy, vjp = jax.vjp(jcommon.rms_norm, jnp.asarray(x, jt),
                      jnp.asarray(scale, jt))
    jdx, jds = vjp(jnp.asarray(dy, jt))
    tx = _t(x).to(tt).requires_grad_(True)
    ts = _t(scale).to(tt).requires_grad_(True)
    y = tcommon.rms_norm(tx, ts)
    y.backward(_t(dy).to(tt))
    assert y.dtype == tx.grad.dtype == ts.grad.dtype == tt
    for got, want in ((y, jy), (tx.grad, jdx), (ts.grad, jds)):
        if dtype == "f32":
            assert _err(got, want) <= 1e-6
        else:
            diff = np.abs(_np(got).astype(np.float64) - _np(want))
            assert np.all(diff <= _ulp_bf16(_np(want)) + 1e-30)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_loss_matches_jax(z_loss):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 12, 40), dtype=np.float32) * 3
    tg = rng.integers(0, 40, (2, 12)).astype(np.int32)
    jl, jg = jax.value_and_grad(jcommon.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(tg), 40, z_loss)
    tl = _t(logits, True)
    loss = tcommon.cross_entropy_loss(tl, _t(tg), 40, z_loss)
    loss.backward()
    assert _err(loss, jl) <= 1e-6 and _err(tl.grad, jg) <= 1e-6


@pytest.mark.parametrize("S,softcap", [(16, 0.0), (16, 30.0), (12, 0.0),
                                       (12, 30.0)])
def test_chunked_cross_entropy_matches_jax(S, softcap):
    """S 16 takes the chunked branch (two chunks of 8), S 12 the
    whole-sequence one (12 % 8)."""
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, 8), dtype=np.float32)
    w = rng.standard_normal((8, 40), dtype=np.float32)
    tg = rng.integers(0, 40, (2, S)).astype(np.int32)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h_, w_: jcommon.chunked_cross_entropy(
            h_, w_, jnp.asarray(tg), softcap=softcap, chunk=8),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h, True), _t(w, True)
    loss = tcommon.chunked_cross_entropy(th, tw, _t(tg), softcap=softcap,
                                         chunk=8)
    loss.backward()
    assert _err(loss, jl) <= 1e-6
    assert _err(th.grad, jgh) <= 1e-6 and _err(tw.grad, jgw) <= 1e-6


# ---------------------------------------------------------------------------
# tests/test_e2e.py's training cases, on the port with device="cpu"
# ---------------------------------------------------------------------------

def test_tiny_training_loss_decreases(tmp_path):
    losses, stats = ttrain.train("qwen2.5-3b", steps=40, batch=4, seq=32,
                                 tiny=True, ckpt_dir=str(tmp_path),
                                 ckpt_every=16, device="cpu")
    assert len(losses) == 40
    # synthetic uniform tokens: loss should head toward ln(vocab)
    assert np.mean(losses[-5:]) < np.mean(losses[:3])
    assert stats.restarts == 0
    assert len(stats.step_seconds) == 40


def test_training_recovers_from_injected_failure(tmp_path):
    losses, stats = ttrain.train("qwen2.5-3b", steps=16, batch=4, seq=32,
                                 tiny=True, ckpt_dir=str(tmp_path),
                                 ckpt_every=4, fail_at=9, device="cpu")
    assert stats.restarts == 1
    assert np.isfinite(losses).all()
    assert len(losses) == 16 + 1        # step 8 runs again after restore


def test_resume_from_checkpoint(tmp_path):
    full, _ = ttrain.train("mamba2-1.3b", steps=14, batch=2, seq=32,
                           tiny=True, device="cpu")
    ttrain.train("mamba2-1.3b", steps=10, batch=2, seq=32, tiny=True,
                 ckpt_dir=str(tmp_path), ckpt_every=5, device="cpu")
    losses, _ = ttrain.train("mamba2-1.3b", steps=14, batch=2, seq=32,
                             tiny=True, ckpt_dir=str(tmp_path), resume=True,
                             device="cpu")
    assert len(losses) == 4               # only steps 10..13 run
    np.testing.assert_allclose(losses, full[10:], rtol=1e-5)


def _eager_losses(arch, steps, batch, seq):
    """The parent port's loop: ``build_train_step`` eagerly, each step on
    its ``synth_batch``, the pieces ``train`` builds."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model, layer_stacks
    from repro_torch.optim.optimizers import make_optimizer
    cfg = ttrain.tiny_config(get_config(arch))
    api = build_model(cfg, device="cpu", trainable=True)
    params = api.init(0)
    opt = make_optimizer(cfg.optimizer, lr=1e-3,
                         stacks=layer_stacks(cfg, params))
    state = opt.init(dict(params.named_parameters()))
    step = build_train_step(api, opt)
    shape = ShapeConfig(f"train_{seq}", seq, batch, "train")
    losses = []
    for i in range(steps):
        b = synth_batch(cfg, shape, i, DataConfig(seed=0))
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in
                                 b.items()})
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "kimi-k2-1t-a32b"])
def test_train_through_the_compiled_step_equals_the_eager_loop(arch):
    """``train`` steps through ``CompiledTraining``: the eager loop's
    losses, one optimizer update a step."""
    losses, stats = ttrain.train(arch, steps=3, batch=2, seq=16,
                                 tiny=True, device="cpu")
    assert losses == _eager_losses(arch, 3, 2, 16)
    assert stats.updates == 3 and stats.restarts == 0
    assert stats.capture_seconds == 0.0 and stats.pool_bytes == 0


def test_recovery_restores_the_state_in_place(tmp_path):
    """A failure after a checkpoint: the restore writes the compiled
    step's own state, so the re-run steps give the uninterrupted run's
    losses and the optimizer ends at one update a step."""
    whole, _ = ttrain.train("qwen2.5-3b", steps=8, batch=2, seq=16,
                            tiny=True, device="cpu")
    losses, stats = ttrain.train("qwen2.5-3b", steps=8, batch=2, seq=16,
                                 tiny=True, ckpt_dir=str(tmp_path),
                                 ckpt_every=4, fail_at=6, device="cpu")
    assert stats.restarts == 1 and stats.updates == 8
    assert losses == whole[:6] + whole[4:]      # steps 4-5 run again


def test_train_tiny_lm_on_the_cpu(capsys):
    from repro_torch import train_tiny_lm
    losses, stats = train_tiny_lm.main(["--steps", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(restarts=1)" in out
    assert "recovered from 1 injected failure(s)" in out
    assert stats.restarts == 1 and np.isfinite(losses).all()
    assert len(losses) == 20 + 10      # no checkpoint yet: steps 0-9 again


def test_train_cli_on_the_cpu(capsys):
    ttrain.main(["--arch", "zamba2-1.2b", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--device", "cpu"])
    assert "done: first loss" in capsys.readouterr().out


def test_train_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train("qwen2.5-3b", steps=1)
