"""The partitioned serving program (``launch/partition.py``,
``models/shards.py``) against the JAX package's forward: a prefill and one
decode step of seven tiny architectures on 4 ranks of one gloo group, on
the meshes (1, 4) and (2, 2), in f32, within 1e-4 (logits, and the cache
after the step).

The ranks run in processes of their own, spawned once for the file
(``tests/_partition_ranks.py`` ``serve_cases``), while this process runs
the reference.  The reference's partitioned program routes each data
shard's tokens with that shard's capacity (its ``shard_map`` sees the
local batch), so its forward is run on each data shard of the batch and
the shards put back together; on one data shard that is the plain
forward.  Covered: dense GQA with K/V replicated where the KV heads do not
divide the model axis (qwen2.5-3b, yi-6b: each rank's query heads read
their own KV heads, the cache sharded over positions), Gemma2's windows
and soft caps, routed and shared experts (qwen2-moe), Kimi-K2's first
dense layer and sequence-sharded residual, Mamba2 and the Zamba2 hybrid
on local heads."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.launch.train import tiny_config
from repro.models.api import build_model
from repro_torch.launch.partition import run_ranks

TOL = 1e-4
B, S, MAX_LEN = 4, 48, 52
ARCHS = ["qwen2.5-3b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "yi-6b",
         "gemma2-2b", "mamba2-1.3b", "zamba2-1.2b"]
MESHES = [(1, 4), (2, 2)]
WORKER = str(Path(__file__).resolve().parent / "_partition_ranks.py")


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.abs(b).max() + 1e-9))


def _reference(cfg, params, inputs, tokens, data):
    """The reference's prefill, then one decode step, on each of ``data``
    shards of the batch; the shards' logits and caches put together."""
    api = build_model(cfg, dtype=jnp.float32)
    prefill = jax.jit(api.prefill, static_argnums=2)
    decode = jax.jit(api.decode_step)
    parts = []
    n = B // data
    for i in range(data):
        sl = slice(i * n, (i + 1) * n)
        logits, cache = prefill(params, jnp.asarray(inputs[sl]), MAX_LEN)
        step, cache = decode(params, cache, jnp.asarray(tokens[sl]),
                             jnp.int32(S))
        parts.append((np.asarray(logits), np.asarray(step),
                      {k: np.asarray(v) for k, v in cache.items()}))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            {k: np.concatenate([p[2][k] for p in parts], axis=1)
             for k in parts[0][2]})


@pytest.fixture(scope="module")
def results():
    """Every case run once: the ranks in their processes, the reference
    here meanwhile."""
    from concurrent.futures import ThreadPoolExecutor
    cases, refs, inputs = [], {}, {}
    for arch in ARCHS:
        cfg = tiny_config(get_config(arch))
        params = build_model(cfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        rng = np.random.default_rng(1)
        if cfg.frontend == "embed":
            x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        else:
            x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        inputs[arch] = (cfg, params, x, tok)
        for mesh in MESHES:
            cases.append({"arch": arch, "mesh": mesh, "tree": tree,
                          "inputs": x, "tokens": tok, "B": B, "S": S,
                          "max_len": MAX_LEN})
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, f"{WORKER}:serve_cases", 4, "gloo",
                            {"cases": cases}, timeout=900)
        for arch, (cfg, params, x, tok) in inputs.items():
            for mesh in MESHES:
                refs[(arch, mesh)] = _reference(cfg, params, x, tok, mesh[0])
        got = ranks.result()[0]
    return refs, got


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_prefill_and_decode_match_reference(results, arch,
                                                        mesh):
    refs, got = results
    want_prefill, want_decode, want_cache = refs[(arch, mesh)]
    res = got[(arch, mesh)]
    assert res["prefill"].shape == want_prefill.shape
    assert _rel_err(res["prefill"], want_prefill) < TOL
    assert res["decode"].shape == want_decode.shape
    assert _rel_err(res["decode"], want_decode) < TOL
    assert set(res["cache"]) == set(want_cache)
    for k, v in want_cache.items():
        assert res["cache"][k].shape == v.shape, k
        assert _rel_err(res["cache"][k], v) < TOL, k


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2.5-3b"])
def test_gqa_with_replicated_kv_is_the_planned_case(results, arch):
    """Two KV heads for four query heads on a model axis of 4: the plan
    replicates K/V and shards the cache's positions over ``model``, so
    rank r's one query head r must read KV head r // 2, not head 0 (the
    match above holds only if it does)."""
    _, got = results
    plan = got[(arch, (1, 4))]["plan"]
    assert plan["attn_sharded"]
    assert plan["wk"] == (None, None)
    assert plan["cache_k"] == (None, "data", None, "model", None)
