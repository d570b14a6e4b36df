"""The port's decode step with the cache length as a 0-d device tensor,
against the JAX package's: ``decode_step`` with a tensor ``cache_len`` at
several positions (Qwen2.5-3B; Gemma2 with its local window and both
soft-caps, the window passed within the run; Zamba2's hybrid cache; an
int8 KV cache), ``ops.decode_attention`` on int8 caches against the
reference's, and ``decode_step`` and ``prefill`` traced on ``meta`` with a
``meta`` length and cache, which proves that neither reads a device value
on the host (a captured step could not).  f32 on both sides, 1e-4 of the
logits' max (the reference's own model tests' limit)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.models.api import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import build_serve_step
from repro_torch.launch.train import tiny_config
from repro_torch.models import api as tapi

TOL = 1e-4
B, PROMPT, STEPS = 2, 6, 6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.abs(want).max() + 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(arch, **over):
    cfg = tiny_config(t_get_config(arch))
    if cfg.local_window:
        over.setdefault("local_window", 4)      # passed within the run
    return dataclasses.replace(cfg, **over)


CASES = {"qwen2.5-3b": {}, "gemma2-2b": {}, "zamba2-1.2b": {},
         "qwen2.5-3b-int8": {"kv_cache_dtype": "int8"}}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_with_tensor_length_matches_jax(case):
    arch = case.replace("-int8", "")
    cfg = _cfg(arch, **CASES[case])
    assert cfg.name == get_config(arch).name
    japi = j_build_model(cfg, dtype=jnp.float32)
    jparams = japi.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    api = tapi.build_model(cfg, device="cpu", dtype=torch.float32)
    params = tapi.params_from_reference(cfg, tree, device="cpu",
                                        dtype=torch.float32)
    max_len = PROMPT + STEPS
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    jstep = jax.jit(japi.decode_step)
    with torch.inference_mode():
        if cfg.family in ("dense", "moe"):
            _, jcache = japi.prefill(jparams, jnp.asarray(prompt), max_len)
            _, cache = api.prefill(params, torch.from_numpy(prompt), max_len,
                                   cache=api.init_cache(B, max_len))
            start = PROMPT
        else:                  # the hybrid's state: replayed from zero
            jcache = japi.init_cache(B, max_len)
            cache = api.init_cache(B, max_len)
            start = 0
        for i in range(STEPS):
            n = start + i
            jlogits, jcache = jstep(jparams, jcache,
                                    jnp.asarray(tokens[:, i:i + 1]),
                                    jnp.asarray(n, jnp.int32))
            logits, cache = api.decode_step(
                params, cache, torch.from_numpy(tokens[:, i:i + 1]),
                torch.tensor(n, dtype=torch.int32))
            assert _rel(logits.numpy(), jlogits) <= TOL, (case, n)
        for k, t in cache.items():
            if t.is_floating_point():
                assert _rel(t.numpy(), jcache[k]) <= TOL, k
            else:
                assert np.array_equal(t.numpy(), np.asarray(jcache[k])), k


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 50.0)])
def test_decode_attention_int8_matches_reference(window, softcap):
    rng = np.random.default_rng(2)
    Bq, H, KV, Smax, D = 2, 8, 2, 16, 32
    q = rng.standard_normal((Bq, H, 1, D)).astype(np.float32)
    kf = rng.standard_normal((Bq, KV, Smax, D)).astype(np.float32)
    vf = rng.standard_normal((Bq, KV, Smax, D)).astype(np.float32)
    kq, ks = jops.quantize_kv(jnp.asarray(kf))
    vq, vs = jops.quantize_kv(jnp.asarray(vf))
    tkq, tks = tops.quantize_kv(torch.from_numpy(kf))
    assert np.array_equal(tkq.numpy(), np.asarray(kq))
    assert _rel(tks.numpy(), ks) <= 1e-6
    for n in (1, 7, Smax):
        want = jops.decode_attention(jnp.asarray(q), kq, vq,
                                     jnp.asarray(n), window=window,
                                     logit_softcap=softcap, k_scale=ks,
                                     v_scale=vs)
        got = tops.decode_attention(
            _t(q), _t(kq), _t(vq), torch.tensor(n), window=window,
            logit_softcap=softcap, k_scale=_t(ks), v_scale=_t(vs))
        assert _rel(got.numpy(), want) <= 1e-5, n


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-2b", "zamba2-1.2b",
                                  "qwen2-moe-a2.7b"])
def test_decode_and_prefill_trace_on_meta_with_a_meta_length(arch):
    """Every op of the step runs on ``meta`` tensors, which hold no values:
    a step that read one on the host (``int()``, ``.item()``, a boolean
    index) would raise here."""
    cfg = _cfg(arch)
    api = tapi.build_model(cfg, device="meta")
    params = api.init(0)
    cache = api.init_cache(B, 16)
    ptrs = {k: v for k, v in cache.items()}
    n = torch.empty((), dtype=torch.int32, device="meta")
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    nxt, out = build_serve_step(api)(params, cache, tok, n)
    assert nxt.is_meta and nxt.shape == (B, 1) and nxt.dtype == torch.int32
    assert all(out[k] is ptrs[k] for k in cache)
    prompt = torch.empty((B, 8), dtype=torch.int32, device="meta")
    logits, out = api.prefill(params, prompt, 16, cache=cache)
    assert logits.is_meta and logits.shape == (B, 1, cfg.padded_vocab)
    assert all(out[k] is ptrs[k] for k in cache)
