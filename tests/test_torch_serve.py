"""The port's serving loop against the JAX package's: ``serve(tiny=True,
device="cpu")`` on the JAX weights gives the same greedy token matrix in
f32 as the JAX loop rebuilt here from ``api.prefill`` and
``build_serve_step`` (the same steps as ``repro/launch/serve.py``, which
draws its own weights), on the same prompts; and a bf16 prefill stays close
to the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.launch.steps import build_serve_step
from repro.launch.train import tiny_config
from repro.models.api import build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.api import params_from_reference

REQUESTS, PROMPT, GEN, SEED = 3, 16, 6, 0


def _jax_serve(arch, dtype):
    """repro/launch/serve.py's loop on weights drawn from ``SEED``; returns
    (tokens, prefill logits, the weights as numpy)."""
    cfg = tiny_config(get_config(arch))
    api = build_model(cfg, dtype=dtype)
    params = api.init(jax.random.PRNGKey(SEED))
    max_len = PROMPT + GEN
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(1, min(cfg.vocab_size, 1000),
                           size=(REQUESTS, PROMPT)).astype(np.int32)
    logits, cache = jax.jit(lambda p, x: api.prefill(p, x, max_len))(
        params, jnp.asarray(prompts))
    step = jax.jit(build_serve_step(api))
    if cfg.family in ("ssm", "hybrid"):
        for t in range(PROMPT):
            tok, cache = step(params, cache,
                              jnp.asarray(prompts[:, t:t + 1]),
                              jnp.asarray(t))
        next_tok = tok
    else:
        next_tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    outs = [np.asarray(next_tok)]
    for i in range(GEN - 1):
        next_tok, cache = step(params, cache, next_tok,
                               jnp.asarray(PROMPT + i))
        outs.append(np.asarray(next_tok))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), params)
    return np.concatenate(outs, axis=1), np.asarray(logits, np.float32), \
        cfg, tree


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-2b", "mamba2-1.3b",
                                  "zamba2-1.2b", "qwen2-moe-a2.7b",
                                  "kimi-k2-1t-a32b"])
def test_serve_tokens_match_jax_f32(arch):
    want, want_logits, cfg, tree = _jax_serve(arch, jnp.float32)
    params = params_from_reference(cfg, tree, device="cpu",
                                   dtype=torch.float32)
    res = tserve.serve(arch, requests=REQUESTS, prompt_len=PROMPT, gen=GEN,
                       tiny=True, seed=SEED, device="cpu", params=params,
                       dtype=torch.float32)
    assert res.tokens.dtype == np.int32
    assert res.tokens.shape == (REQUESTS, GEN)
    np.testing.assert_array_equal(res.tokens, want)
    got = res.logits.float().numpy()
    assert np.max(np.abs(got - want_logits)) / np.abs(want_logits).max() \
        < 1e-4
    assert res.prefill_seconds > 0 and res.decode_seconds > 0


#: measured 1.65e-2 on zamba2-1.2b (qwen2.5-3b 5.6e-3, gemma2-2b 5.9e-3,
#: mamba2-1.3b 9.6e-3); the stated bound is 5e-2
BF16_TOL = 3e-2


def test_serve_prefill_logits_bf16_close_to_jax():
    """bf16 rounds at other places in the two frameworks (matmul outputs,
    the causal conv's taps): the prefill logits agree to BF16_TOL of their
    largest magnitude, not bit for bit."""
    arch = "zamba2-1.2b"
    _, want_logits, cfg, tree = _jax_serve(arch, jnp.bfloat16)
    params = params_from_reference(cfg, tree, device="cpu",
                                   dtype=torch.bfloat16)
    res = tserve.serve(arch, requests=REQUESTS, prompt_len=PROMPT, gen=2,
                       tiny=True, seed=SEED, device="cpu", params=params)
    got = res.logits.float().numpy()
    err = np.max(np.abs(got - want_logits)) / np.abs(want_logits).max()
    assert err < BF16_TOL


def test_tiny_config_matches_jax():
    from repro.launch.train import tiny_config as j_tiny
    for arch in ("qwen2.5-3b", "gemma2-2b", "zamba2-1.2b", "kimi-k2-1t-a32b"):
        assert tserve.tiny_config(t_get_config(arch)).__dict__ == \
            j_tiny(get_config(arch)).__dict__


def test_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--arch", "mamba2-1.3b", "--requests", "2",
                 "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert "tok/s" in capsys.readouterr().out


def test_serve_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve("zamba2-1.2b", requests=1, prompt_len=4, gen=2)
