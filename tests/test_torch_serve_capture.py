"""The serving loop's compiled steps (``launch/serve.py``
``CompiledServing``): one static cache, allocated once, that the prefill
fills and the decode step reads and writes; the decode step's token and
length buffers advanced by the step itself.  On the CPU the same step
bodies run each time, and they give the eager loop's tokens
(``build_serve_step`` with a host length) bit for bit; on the card
(``gpu``) the two CUDA graphs give the eager step's tokens and prefill
logits, and the launch counters count the kernels that ran, not those
captured.  The file imports no JAX, so the card's machine runs it too."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import CompiledServing, serve
from repro_torch.launch.steps import build_serve_step
from repro_torch.launch.train import tiny_config
from repro_torch.models.api import build_model
from repro_torch.models.moe import counting_drops

ARCHS = ["qwen2.5-3b", "gemma2-2b", "zamba2-1.2b", "qwen2-moe-a2.7b",
         "musicgen-large"]
B, PROMPT, GEN = 2, 16, 5


def _inputs(cfg, dev, seed=0):
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(
        1, min(cfg.vocab_size, 1000), (B, PROMPT)).astype(np.int32)).to(dev)
    if cfg.frontend == "embed":
        emb = torch.from_numpy((rng.standard_normal(
            (B, PROMPT, cfg.d_model)) * 0.02).astype(np.float32)).to(dev)
        return prompt, emb
    return prompt, prompt


def _eager(api, params, prompt, inputs, max_len):
    """The eager loop of the parent port: ``api.prefill`` into a new cache,
    ``build_serve_step`` with a Python length; (logits, tokens)."""
    step = build_serve_step(api)
    logits, cache = api.prefill(params, inputs, max_len)
    if api.cfg.family in ("ssm", "hybrid"):
        for t in range(PROMPT):
            tok, cache = step(params, cache, prompt[:, t:t + 1], t)
    else:
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    outs = [tok]
    for i in range(GEN - 1):
        tok, cache = step(params, cache, tok, PROMPT + i)
        outs.append(tok)
    return logits, torch.cat(outs, dim=1)


def _compiled(steps, prompt, inputs):
    logits = steps.prefill(inputs).clone()
    steps.start(logits, prompt)
    outs = [steps.tokens.clone()]
    for _ in range(GEN - 1):
        outs.append(steps.decode().clone())
    return logits, torch.cat(outs, dim=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_serving_on_the_cpu_equals_the_eager_loop(arch):
    cfg = tiny_config(get_config(arch))
    api = build_model(cfg, device="cpu", dtype=torch.float32)
    max_len = PROMPT + GEN
    with torch.inference_mode():
        params = api.init(0)
        prompt, inputs = _inputs(cfg, torch.device("cpu"))
        want_logits, want = _eager(api, params, prompt, inputs, max_len)
        steps = CompiledServing(api, params, inputs, max_len)
        ptrs = {k: t.data_ptr() for k, t in steps.cache.items()}
        bufs = (steps.tokens.data_ptr(), steps.cache_len.data_ptr())
        for _ in range(2):                 # a second request, same buffers
            logits, got = _compiled(steps, prompt, inputs)
            assert torch.equal(logits, want_logits)
            assert torch.equal(got, want)
            assert int(steps.cache_len) == PROMPT + GEN - 1
            assert {k: t.data_ptr() for k, t in steps.cache.items()} == ptrs
            assert (steps.tokens.data_ptr(),
                    steps.cache_len.data_ptr()) == bufs
    assert steps.capture_seconds == 0.0 and steps.pool_bytes == 0


def test_serve_on_the_cpu_reports_its_parts():
    res = serve("zamba2-1.2b", requests=B, prompt_len=PROMPT, gen=GEN,
                device="cpu", dtype=torch.float32)
    assert res.tokens.shape == (B, GEN)
    assert res.prompt_seconds > 0 and res.capture_seconds == 0.0
    dense = serve("qwen2.5-3b", requests=B, prompt_len=PROMPT, gen=GEN,
                  device="cpu", dtype=torch.float32)
    assert dense.prompt_seconds == 0.0


def test_compiled_serving_refuses_another_prompt_shape():
    """The graphs hold the prompt shape they were built for: a prompt that
    would broadcast into the static buffer, or a longer one, raises."""
    cfg = tiny_config(get_config("qwen2.5-3b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32)
    with torch.inference_mode():
        params = api.init(0)
        prompt, inputs = _inputs(cfg, torch.device("cpu"))
        steps = CompiledServing(api, params, inputs, PROMPT + GEN)
        with pytest.raises(ValueError, match="graphs hold"):
            steps.prefill(inputs[:1])
        logits = steps.prefill(inputs)
        with pytest.raises(ValueError, match="graphs hold"):
            steps.start(logits, torch.cat([prompt, prompt], dim=1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b",
                                  "qwen2-moe-a2.7b", "gemma2-2b"])
def test_captured_serving_equals_the_eager_step(arch):
    dev = _card()
    cfg = dataclasses.replace(tiny_config(get_config(arch)), head_dim=64)
    api = build_model(cfg, device=dev)
    max_len = PROMPT + GEN
    with torch.inference_mode():
        params = api.init(0)
        prompt, inputs = _inputs(cfg, dev)
        ops.reset_launch_counts()
        want_logits, want = _eager(api, params, prompt, inputs, max_len)
        eager = ops.launch_counts()
        steps = CompiledServing(api, params, inputs, max_len)
        assert steps.prefill_graph.graph is not None
        assert steps.decode_graph.graph is not None
        assert steps.decode_graph.launches == {}    # decode runs no kernel
        for _ in range(2):
            ops.reset_launch_counts()
            logits, got = _compiled(steps, prompt, inputs)
            torch.cuda.synchronize()
            assert ops.launch_counts() == eager      # one prefill each
            assert torch.equal(got, want)
            assert torch.equal(logits, want_logits)
    assert eager["flash_attention"] >= 1


@pytest.mark.gpu
def test_counting_drops_refuses_a_capture():
    dev = _card()
    cfg = tiny_config(get_config("qwen2-moe-a2.7b"))
    api = build_model(cfg, device=dev)
    with torch.inference_mode():
        params = api.init(0)
        prompt, inputs = _inputs(cfg, dev)
        with counting_drops():
            with pytest.raises(RuntimeError, match="counting_drops"):
                CompiledServing(api, params, inputs, PROMPT + GEN)
