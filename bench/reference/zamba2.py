"""Plain reference of the published Zamba2 language model (Zyphra's
Zamba2; the ``zamba2`` model of Hugging Face ``transformers``): weights,
forward, loss, AdamW steps, and the readings a training check compares.

Plain PyTorch in float32, one product at a time, no kernel, no cache.  The
configuration's keys are the published ``config.json``'s.  With ``x0``
the token embedding (not scaled) and ``h`` the residual stream, layer i
is a Mamba2 layer; a layer in ``hybrid_layer_ids``, the k-th of them, first
runs shared block ``k % num_mem_blocks``:

    a = RMSNorm(concat[h, x0]);  q, k, v = a Wq, a Wk, a Wv
        (``num_attention_heads`` heads of ``attention_head_dim``; RoPE of
        base ``rope_theta`` over the whole head on q and k)
    attn = softmax(causal(q k^T (attention_head_dim / 2)^-1/2)) v Wo
    m = RMSNorm(attn);  [g, u] = m Wgu + (m A_k) B_k  (site k's adapter)
    t = (gelu(g) * u) Wdown L_k                        (site k's linear)
    h <- h + Mamba_i(RMSNorm(h + t))

and every other layer ``h <- h + Mamba_i(RMSNorm(h))``; then a final
RMSNorm and an untied LM head.  The Mamba2 layer is ``mamba2.py``'s with
B and C in ``mamba_ngroups`` groups (head h reads group h // (H / G)) and
the gated norm over each group's channels.  RMSNorm, the z-loss and the
AdamW step are ``mamba2.py``'s.

Stacked leaf names: ``blocks.*`` over the layers, ``shared.*`` over the
shared blocks and ``sites.*`` over the hybrid sites; ``leaf_names`` gives
each layer's, block's or site's own (``shared.1.attn.wq``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import mamba2
from .mamba2 import Z_LOSS, causal_conv, rms_norm
from .precision import full_fp32, matmul

#: stacked leaf prefixes and the key of the configuration counting them
STACKS = ("blocks", "shared", "sites")


def dims(cfg: Mapping) -> Dict[str, int]:
    d = int(cfg["hidden_size"])
    di = int(cfg["mamba_expand"]) * d
    P = int(cfg["mamba_headdim"])
    L = int(cfg["num_hidden_layers"])
    return {"d": d, "di": di, "H": di // P, "P": P,
            "N": int(cfg["mamba_d_state"]), "G": int(cfg["mamba_ngroups"]),
            "cw": int(cfg["mamba_d_conv"]), "L": L,
            "V": -(-int(cfg["vocab_size"]) // 256) * 256,
            "A": int(cfg["attention_hidden_size"]),
            "heads": int(cfg["num_attention_heads"]),
            "hd": int(cfg["attention_head_dim"]),
            "F": int(cfg["intermediate_size"]),
            "r": int(cfg["adapter_rank"]),
            "blocks": int(cfg["num_mem_blocks"]),
            "sites": len(sites(cfg))}


def sites(cfg: Mapping) -> List[int]:
    """The hybrid layers held, in order (site k is the k-th)."""
    L = int(cfg["num_hidden_layers"])
    return [int(i) for i in cfg["hybrid_layer_ids"] if int(i) < L]


def leaf_specs(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every stacked leaf, in the order they
    are drawn; the inits as ``mamba2.leaf_specs``'s."""
    k = dims(cfg)
    d, di, H, cw, L = k["d"], k["di"], k["H"], k["cw"], k["L"]
    GN, A, F_, r = k["G"] * k["N"], k["A"], k["F"], k["r"]
    nb, ns = k["blocks"], k["sites"]
    gain = 0.1
    return [
        ("embed", (k["V"], d), "normal", d ** -0.5),
        ("lm_head", (d, k["V"]), "normal", d ** -0.5),
        ("final_norm", (d,), "normal", gain),
        ("blocks.ln", (L, d), "normal", gain),
        ("blocks.mamba.w_z", (L, d, di), "normal", d ** -0.5),
        ("blocks.mamba.w_x", (L, d, di), "normal", d ** -0.5),
        ("blocks.mamba.w_b", (L, d, GN), "normal", d ** -0.5),
        ("blocks.mamba.w_c", (L, d, GN), "normal", d ** -0.5),
        ("blocks.mamba.w_dt", (L, d, H), "normal", d ** -0.5),
        ("blocks.mamba.conv_x_w", (L, cw, di), "normal", cw ** -0.5),
        ("blocks.mamba.conv_b_w", (L, cw, GN), "normal", cw ** -0.5),
        ("blocks.mamba.conv_c_w", (L, cw, GN), "normal", cw ** -0.5),
        ("blocks.mamba.conv_x_b", (L, di), "normal", gain),
        ("blocks.mamba.conv_b_b", (L, GN), "normal", gain),
        ("blocks.mamba.conv_c_b", (L, GN), "normal", gain),
        ("blocks.mamba.a_log", (L, H), "log_uniform_a", 0.0),
        ("blocks.mamba.dt_bias", (L, H), "dt_bias", 0.0),
        ("blocks.mamba.d_skip", (L, H), "one_plus", gain),
        ("blocks.mamba.norm", (L, di), "normal", gain),
        ("blocks.mamba.w_out", (L, di, d), "normal", di ** -0.5),
        ("shared.ln1", (nb, A), "normal", gain),
        ("shared.attn.wq", (nb, A, A), "normal", A ** -0.5),
        ("shared.attn.wk", (nb, A, A), "normal", A ** -0.5),
        ("shared.attn.wv", (nb, A, A), "normal", A ** -0.5),
        ("shared.attn.wo", (nb, A, d), "normal", A ** -0.5),
        ("shared.ln2", (nb, d), "normal", gain),
        ("shared.mlp.w_gate_up", (nb, d, 2 * F_), "normal", d ** -0.5),
        ("shared.mlp.w_down", (nb, F_, d), "normal", F_ ** -0.5),
        ("sites.adapter_a", (ns, d, r), "normal", d ** -0.5),
        ("sites.adapter_b", (ns, r, 2 * F_), "normal", r ** -0.5),
        ("sites.linear", (ns, d, d), "normal", d ** -0.5),
    ]


def make_weights(cfg: Mapping, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """Every stacked leaf drawn from ``seed`` by one generator on
    ``device``, one call a leaf, in ``dtype`` (``mamba2.F32_LEAVES`` in
    float32): the same numbers every time for one seed and device."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = {}
    for name, shape, init, scale in leaf_specs(cfg):
        want = torch.float32 if name.rsplit(".", 1)[-1] in \
            mamba2.F32_LEAVES else dtype
        if init == "normal":
            t = torch.randn(shape, generator=g, device=device) * scale
        elif init == "one_plus":
            t = 1.0 + torch.randn(shape, generator=g, device=device) * scale
        elif init == "log_uniform_a":
            u = torch.rand(shape, generator=g, device=device)
            t = torch.log(1.0 + 15.0 * u)
        elif init == "dt_bias":
            u = torch.rand(shape, generator=g, device=device)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                                  - math.log(1e-3)))
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = t.to(want)
        del t
    return out


def leaf_names(cfg: Mapping) -> Iterator[Tuple[str, str, Optional[int]]]:
    """(own name, stacked name, index) of every leaf: a stacked leaf
    ``shared.attn.wq`` is ``shared.{j}.attn.wq`` for block j."""
    k = dims(cfg)
    count = {"blocks": k["L"], "shared": k["blocks"], "sites": k["sites"]}
    for name, _, _, _ in leaf_specs(cfg):
        top, _, rest = name.partition(".")
        if top in STACKS:
            for i in range(count[top]):
                yield f"{top}.{i}.{rest}", name, i
        else:
            yield name, name, None


layer_leaf = mamba2.layer_leaf


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def ssd(u, dt, a_log, b, c, G: int, prec: str = "f32") -> torch.Tensor:
    """``mamba2.ssd`` of each group's heads with that group's B and C.
    u: [B, S, H, P]; dt: [B, S, H]; b, c: [B, S, G * N]."""
    H, N = u.shape[2], b.shape[-1] // G
    Hg = H // G
    return torch.cat([mamba2.ssd(u[:, :, g * Hg:(g + 1) * Hg],
                                 dt[:, :, g * Hg:(g + 1) * Hg],
                                 a_log[g * Hg:(g + 1) * Hg],
                                 b[..., g * N:(g + 1) * N],
                                 c[..., g * N:(g + 1) * N], prec)
                      for g in range(G)], dim=2)


def mamba_block(w, i: int, x: torch.Tensor, cfg: Mapping,
                prec: str = "f32") -> torch.Tensor:
    """One Mamba2 layer's output (the residual not added); x normed."""
    k = dims(cfg)
    p = {n: w[f"blocks.mamba.{n}"][i] for n in (
        "w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x_w", "conv_b_w",
        "conv_c_w", "conv_x_b", "conv_b_b", "conv_c_b", "a_log", "dt_bias",
        "d_skip", "norm", "w_out")}
    Bsz, S, _ = x.shape
    z = matmul(x, p["w_z"], prec)
    u = causal_conv(matmul(x, p["w_x"], prec), p["conv_x_w"], p["conv_x_b"])
    b = causal_conv(matmul(x, p["w_b"], prec), p["conv_b_w"], p["conv_b_b"])
    c = causal_conv(matmul(x, p["w_c"], prec), p["conv_c_w"], p["conv_c_b"])
    dt = F.softplus(matmul(x, p["w_dt"], prec) + p["dt_bias"].float())
    uh = u.reshape(Bsz, S, k["H"], k["P"])
    y = ssd(uh, dt, p["a_log"], b, c, k["G"], prec)
    y = y + uh * p["d_skip"].float()[:, None]
    y = (y.reshape(Bsz, S, k["di"]) * F.silu(z)).reshape(
        Bsz, S, k["G"], k["di"] // k["G"])
    y = rms_norm(y, p["norm"].reshape(k["G"], -1)).reshape(Bsz, S, k["di"])
    return matmul(y, p["w_out"], prec)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the whole head, halves rotated.
    x: [B, S, heads, hd]."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def shared_block(w, s: int, k: int, h: torch.Tensor, x0: torch.Tensor,
                 cfg: Mapping, prec: str = "f32") -> torch.Tensor:
    """Site ``k``'s ``t``: shared block ``s`` on [h, x0], then the site's
    linear."""
    d = dims(cfg)
    Bsz, S, _ = h.shape
    heads, hd = d["heads"], d["hd"]
    a = rms_norm(torch.cat([h, x0], -1), w["shared.ln1"][s])
    q = rope(matmul(a, w["shared.attn.wq"][s], prec).reshape(
        Bsz, S, heads, hd), float(cfg["rope_theta"])).transpose(1, 2)
    kk = rope(matmul(a, w["shared.attn.wk"][s], prec).reshape(
        Bsz, S, heads, hd), float(cfg["rope_theta"])).transpose(1, 2)
    v = matmul(a, w["shared.attn.wv"][s], prec).reshape(
        Bsz, S, heads, hd).transpose(1, 2)
    scores = matmul(q, kk.transpose(-1, -2), prec) * (hd / 2) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = matmul(p, v, prec).transpose(1, 2).reshape(Bsz, S, heads * hd)
    m = rms_norm(matmul(o, w["shared.attn.wo"][s], prec), w["shared.ln2"][s])
    gu = matmul(m, w["shared.mlp.w_gate_up"][s], prec) + matmul(
        matmul(m, w["sites.adapter_a"][k], prec), w["sites.adapter_b"][k],
        prec)
    g, u = gu.chunk(2, -1)
    f = matmul(F.gelu(g) * u, w["shared.mlp.w_down"][s], prec)
    return matmul(f, w["sites.linear"][k], prec)


def hidden(w, tokens: torch.Tensor, cfg: Mapping, prec: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden state [B, S, d] of ``tokens`` [B, S];
    ``remat`` recomputes each layer (with its shared block) in the
    backward."""
    site_of = {layer: k for k, layer in enumerate(sites(cfg))}
    nb = dims(cfg)["blocks"]

    def layer(i, h, x0):
        x = h
        if i in site_of:
            k = site_of[i]
            x = h + shared_block(w, k % nb, k, h, x0, cfg, prec)
        return h + mamba_block(w, i, rms_norm(x, w["blocks.ln"][i]), cfg,
                               prec)

    x0 = w["embed"].float()[tokens.long()]
    h = x0
    for i in range(int(cfg["num_hidden_layers"])):
        if remat and torch.is_grad_enabled():
            h = checkpoint(layer, i, h, x0, use_reentrant=False)
        else:
            h = layer(i, h, x0)
    return rms_norm(h, w["final_norm"])


def logits(w, tokens: torch.Tensor, cfg: Mapping,
           prec: str = "f32") -> torch.Tensor:
    """Logits [B, S, V] in float32."""
    return matmul(hidden(w, tokens, cfg, prec), w["lm_head"], prec)


def loss(w, inputs: torch.Tensor, targets: torch.Tensor, cfg: Mapping,
         prec: str = "f32", remat: bool = True) -> torch.Tensor:
    """Mean token cross-entropy plus the z-loss."""
    lg = matmul(hidden(w, inputs, cfg, prec, remat), w["lm_head"], prec)
    lse = torch.logsumexp(lg, -1)
    gold = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    return (lse - gold).mean() + Z_LOSS * lse.square().mean()


# ---------------------------------------------------------------------------
# training: the readings compared with the program's
# ---------------------------------------------------------------------------

def train_readings(cfg: Mapping, w0: Dict[str, torch.Tensor], batches,
                   hp: Mapping, prec: str = "f32",
                   micro: Optional[int] = None) -> Dict:
    """``mamba2.train_readings`` of this model: each step's loss and
    gradient norm before clipping, each leaf's norm of the clipped first
    gradient and each leaf's change after the last step, by own leaf
    name; ``micro`` rows at a time, their gradients summed in float32."""
    full_fp32()
    w = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in w0.items()}
    state = {"step": 0, "m": {n: torch.zeros_like(t) for n, t in w.items()},
             "v": {n: torch.zeros_like(t) for n, t in w.items()}}
    losses, norms, first = [], [], None
    for bi, batch in enumerate(batches):
        inputs, targets = batch["inputs"], batch["targets"]
        rows = inputs.shape[0]
        step = micro or rows
        total = 0.0
        for r in range(0, rows, step):
            n = min(step, rows - r)
            part = loss(w, inputs[r:r + step], targets[r:r + step], cfg, prec)
            (part * (n / rows)).backward()
            total += float(part.detach()) * n / rows
        grads = {n: t.grad for n, t in w.items()}
        gnorm = float(torch.sqrt(sum(g.square().sum()
                                     for g in grads.values())))
        losses.append(total)
        norms.append(gnorm)
        if bi == 0:
            clip = min(1.0, hp["clip_norm"] / max(gnorm, 1e-9))
            first = {one: float(layer_leaf(grads, st, i).norm()) * clip
                     for one, st, i in leaf_names(cfg)}
        with torch.no_grad():
            mamba2.adamw_step(w, grads, state, hp)
        for t in w.values():
            t.grad = None
    with torch.no_grad():
        change = {one: float((layer_leaf(w, st, i)
                              - layer_leaf(w0, st, i).float()).norm())
                  for one, st, i in leaf_names(cfg)}
    return {"losses": losses, "grad_norms": norms, "first_grad": first,
            "change": change}
