"""The port's model zoo against the JAX package, arch by arch, at the
reduced sizes of tests/test_models.py, in f32, with the JAX weights carried
across by ``params_from_reference``: forward logits, prefill (logits and
cache), three decode steps, and the Mamba2, attention and MoE blocks alone
(the MoE FFN also where capacity drops tokens: the same pairs dropped)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config, list_archs
from repro.models.api import build_model
from repro.models.attention import attn_forward
from repro.models.moe import moe_ffn
from repro.models.ssm import mamba_forward
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import attn_forward as t_attn_forward
from repro_torch.models.ssm import mamba_forward as t_mamba_forward

TOL = 1e-4
B, S, GEN = 2, 12, 3


def reduced(cfg):
    """tests/test_models.py's reduced config."""
    over = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=512,
                head_dim=16)
    if cfg.num_heads:
        over.update(num_heads=4,
                    num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads
                    else 4)
    if cfg.family == "moe":
        over.update(num_experts=8, top_k=2, moe_d_ff=32,
                    num_shared_experts=min(1, cfg.num_shared_experts),
                    first_dense_layers=min(1, cfg.first_dense_layers),
                    capacity_factor=8.0)
    if cfg.family in ("ssm", "hybrid"):
        over.update(ssm_state=16, ssm_head_dim=16)
    if cfg.local_window:
        over.update(local_window=8)
    if cfg.attn_every:
        over.update(attn_every=2, num_layers=5)
    return dataclasses.replace(cfg, **over)


ARCHS = list_archs()
MOE_ARCHS = [a for a in list_archs() if get_config(a).family == "moe"]


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.abs(b).max() + 1e-9))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _models(cfg, seed=0):
    japi = build_model(cfg, dtype=jnp.float32)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tapi_ = tapi.build_model(cfg, device="cpu", dtype=torch.float32)
    tparams = tapi.params_from_reference(cfg, tree, device="cpu",
                                         dtype=torch.float32)
    return japi, jparams, tapi_, tparams


def _inputs(cfg, rng):
    if cfg.frontend == "embed":
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.integers(0, 100, size=(B, S)).astype(np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _check_cache(tcache, jcache):
    assert set(tcache) == set(jcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        if jcache[k].dtype == jnp.int8:
            assert np.array_equal(tcache[k].numpy(), np.asarray(jcache[k]))
        else:
            assert _rel_err(_np(tcache[k]), jcache[k]) < TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    cfg = reduced(get_config(arch))
    if arch == "qwen2.5-3b":              # the int8 KV-cache branch too
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    japi, jparams, tapi_, tparams = _models(cfg)
    rng = np.random.default_rng(0)
    jin, tin = _inputs(cfg, rng)
    max_len = S + GEN

    with torch.inference_mode():
        logits = tapi_.forward(tparams, tin)
        want = jax.jit(japi.forward)(jparams, jin)
        assert tuple(logits.shape) == (B, S, cfg.padded_vocab)
        assert _rel_err(_np(logits), want) < TOL

        tlog, tcache = tapi_.prefill(tparams, tin, max_len)
        jlog, jcache = jax.jit(lambda p, x: japi.prefill(p, x, max_len))(
            jparams, jin)
        assert tuple(tlog.shape) == (B, 1, cfg.padded_vocab)
        assert _rel_err(_np(tlog), jlog) < TOL
        _check_cache(tcache, jcache)

        # dense/moe: continue after the prompt; ssm/hybrid: the fresh cache
        # the serving loop fills by replay, from position 0
        start = S if cfg.family in ("dense", "moe") else 0
        jstep = jax.jit(japi.decode_step)
        toks = rng.integers(0, 100, size=(GEN, B, 1)).astype(np.int32)
        for i in range(GEN):
            tl, tcache = tapi_.decode_step(tparams, tcache,
                                           torch.from_numpy(toks[i]),
                                           start + i)
            jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[i]),
                               jnp.asarray(start + i))
            assert tuple(tl.shape) == (B, 1, cfg.padded_vocab)
            assert _rel_err(_np(tl), jl) < TOL, i
        _check_cache(tcache, jcache)


def _block0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_mamba_forward_matches_jax(arch):
    cfg = reduced(get_config(arch))
    _, jparams, _, tparams = _models(cfg, seed=1)
    x = np.random.default_rng(1).standard_normal(
        (B, 32, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: mamba_forward(p, x, cfg))(
        _block0(jparams["blocks"])["mamba"], jnp.asarray(x))
    with torch.inference_mode():
        got = t_mamba_forward(tparams.blocks[0]["mamba"],
                              torch.from_numpy(x), cfg)
    assert _rel_err(_np(got), want) < TOL


@pytest.mark.parametrize("arch,window", [("qwen2.5-3b", 0),
                                         ("gemma2-2b", 8),
                                         ("zamba2-1.2b", 0)])
def test_attn_forward_matches_jax(arch, window):
    cfg = reduced(get_config(arch))
    _, jparams, _, tparams = _models(cfg, seed=2)
    jp = jparams["shared"]["attn"] if cfg.family == "hybrid" \
        else _block0(jparams["blocks"])["attn"]
    tp = tparams.shared["attn"] if cfg.family == "hybrid" \
        else tparams.blocks[0]["attn"]
    x = np.random.default_rng(2).standard_normal(
        (B, 24, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: attn_forward(p, x, cfg, window=window))(
        jp, jnp.asarray(x))
    with torch.inference_mode():
        got = t_attn_forward(tp, torch.from_numpy(x), cfg, window=window)
    assert _rel_err(_np(got), want) < TOL


def _probe_experts(jp, tp, d):
    """Give expert e's down projection a single 1 in output column e, so
    the MoE output's column e of a token is nonzero exactly when the pair
    (token, e) was kept: the kept pairs read off the output alone."""
    wo = np.zeros(np.asarray(jp["wo"]).shape, np.float32)
    for e in range(wo.shape[0]):
        wo[e, :, e] = 1.0
    jp = dict(jp, wo=jnp.asarray(wo))
    tp = {k: tp[k] for k in ("router", "wi", "wg")}
    tp["wo"] = torch.from_numpy(wo)
    assert wo.shape[0] <= d
    return jp, tp


def _kept(out, E):
    return {(t, e) for t, e in zip(*np.nonzero(np.asarray(out)[:, :E]))}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_moe_ffn_matches_jax_and_drops_the_same_pairs(arch,
                                                      capacity_factor):
    """``moe_ffn`` against the JAX one, without drops (8.0) and where
    capacity drops pairs (1.0, 0.5): the outputs agree, and the (token,
    slot) pairs the port drops are exactly those the reference drops
    (read off both outputs through probe experts)."""
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              capacity_factor=capacity_factor)
    _, jparams, _, tparams = _models(cfg, seed=3)
    fd = cfg.first_dense_layers
    jp = {k: v for k, v in _block0(jparams["blocks"])["moe"].items()
          if k != "shared"}
    tp = tparams.blocks[fd]["moe"]
    x = np.random.default_rng(3).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32)
    T, E = 4 * 32, cfg.num_experts
    want = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(jp, jnp.asarray(x))
    with torch.inference_mode():
        with tmoe.counting_drops() as count:
            got = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert _rel_err(_np(got), want) < TOL
    assert count.pairs == T * cfg.top_k
    if capacity_factor < 8.0:
        assert count.dropped > 0
    else:
        assert count.dropped == 0

    # the pairs: every routed pair (a capacity no pair exceeds), minus the
    # dropped ones, read off each side's probe output
    jprobe, tprobe = _probe_experts(jp, tp, cfg.d_model)
    wide = dataclasses.replace(cfg, capacity_factor=float(E))
    routed = _kept(jax.jit(lambda p, x: moe_ffn(p, x, wide))(
        jprobe, jnp.asarray(x)).reshape(T, -1), E)
    ref_kept = _kept(jax.jit(lambda p, x: moe_ffn(p, x, cfg))(
        jprobe, jnp.asarray(x)).reshape(T, -1), E)
    with torch.inference_mode():
        port_routed = _kept(tmoe.moe_ffn(tprobe, torch.from_numpy(x), wide)
                            .reshape(T, -1).numpy(), E)
        port_kept = _kept(tmoe.moe_ffn(tprobe, torch.from_numpy(x), cfg)
                          .reshape(T, -1).numpy(), E)
    assert len(routed) == T * cfg.top_k
    assert port_routed == routed
    assert port_kept == ref_kept
    assert port_routed - port_kept == routed - ref_kept
    assert len(routed - ref_kept) == count.dropped


def test_moe_params_keep_the_router_in_f32():
    """bf16 parameters from the JAX tree: the router stays float32 (as
    ``init_moe`` draws it), kimi-k2's first dense layer comes first."""
    cfg = reduced(get_config("kimi-k2-1t-a32b"))
    jparams = build_model(cfg, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jparams)
    tparams = tapi.params_from_reference(cfg, tree, device="cpu")
    assert len(tparams.blocks) == cfg.num_layers
    assert "mlp" in tparams.blocks[0] and "moe" in tparams.blocks[1]
    moe_p = tparams.blocks[1]["moe"]
    assert moe_p["router"].dtype == torch.float32
    assert moe_p["wi"].dtype == torch.bfloat16
    assert moe_p["shared"]["wo"].dtype == torch.bfloat16
    own = tapi.build_model(cfg, device="cpu").init(0)
    for name, leaf in jparams["blocks"]["moe"].items():
        if name == "shared":
            continue
        assert tuple(own.blocks[1]["moe"][name].shape) == leaf.shape[1:]
        assert (own.blocks[1]["moe"][name].dtype == torch.float32) == \
            (leaf.dtype == jnp.float32), name


def test_port_init_shapes_match_jax_tree():
    """The port's own init gives the JAX tree's shapes and dtypes, block by
    block, with frozen parameters."""
    cfg = reduced(get_config("zamba2-1.2b"))
    jtree = jax.eval_shape(build_model(cfg, dtype=jnp.float32).init,
                           jax.random.PRNGKey(0))
    tparams = tapi.build_model(cfg, device="cpu",
                               dtype=torch.float32).init(0)
    assert tuple(tparams.embed.shape) == jtree["embed"].shape
    assert tuple(tparams.lm_head.shape) == jtree["lm_head"].shape
    assert len(tparams.blocks) == cfg.num_layers
    for name, leaf in jtree["blocks"]["mamba"].items():
        got = tparams.blocks[0]["mamba"][name]
        assert tuple(got.shape) == leaf.shape[1:], name
        assert (got.dtype == torch.float32) == (leaf.dtype == jnp.float32)
    for name, leaf in jtree["shared"]["attn"].items():
        assert tuple(tparams.shared["attn"][name].shape) == leaf.shape
    assert not any(p.requires_grad for p in tparams.parameters())
