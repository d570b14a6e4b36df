"""Plain reference of the Mamba2 language model: weights, forward, loss,
one AdamW step, and the readings a training check compares.

Plain PyTorch in float32, one product at a time, no kernel, no cache, no
batching tricks.  The model is the one the configuration describes:
``num_layers`` Mamba2 blocks with a pre-RMSNorm residual each, a final
RMSNorm and an untied LM head.  The token embedding is scaled by
sqrt(d_model) rounded to bfloat16, as the configuration's type rounds
it.  RMSNorm computes its statistics in float32 and applies the gain
``1 + scale``; the loss is the token cross-entropy plus a z-loss of 1e-4
times the mean squared log-sum-exp.

A Mamba2 block (SSD, one group of B and C shared by the heads):

    z = x Wz;  u = silu(conv(x Wx));  B = silu(conv(x Wb));
    C = silu(conv(x Wc));  dt = softplus(x Wdt + dt_bias);  A = -exp(a_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t^T;  y_t = h_t C_t + D u_t
    out = RMSNorm(y * silu(z)) Wout

with a causal depthwise convolution of width ``conv_width`` (taps plus a
bias).  The scan runs in chunks of 128 positions: within a chunk as the
masked quadratic form, between chunks as the recurrence of the states.

Weights are made here from a seed, on any device, one call of the
generator for each leaf stacked over the layers, in the configuration's
type; ``make_weights`` gives the same numbers every time for one
seed and device.  Leaf names are ``"embed"`` and ``"blocks.mamba.w_z"``
(stacked over the layers); ``leaf_names`` maps them to one leaf a layer.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import full_fp32, matmul, operand

RMS_EPS = 1e-6
Z_LOSS = 1e-4
SSD_CHUNK = 128
#: leaves held in float32 whatever the model's type
F32_LEAVES = ("a_log", "dt_bias", "d_skip")


def padded_vocab(cfg: Mapping) -> int:
    """The vocabulary rounded up to a multiple of 256, the rows the
    embedding and the head hold."""
    return -(-int(cfg["vocab_size"]) // 256) * 256


def dims(cfg: Mapping) -> Dict[str, int]:
    d = int(cfg["d_model"])
    di = int(cfg["ssm_expand"]) * d
    return {"d": d, "di": di, "H": di // int(cfg["ssm_head_dim"]),
            "P": int(cfg["ssm_head_dim"]), "N": int(cfg["ssm_state"]),
            "cw": int(cfg["conv_width"]), "L": int(cfg["num_layers"]),
            "V": padded_vocab(cfg)}


def leaf_specs(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every stacked leaf, in the order they
    are drawn.  Inits: ``normal`` (N(0, scale^2)), ``log_uniform_a``
    (log of A ~ U[1, 16]), ``dt_bias`` (softplus^-1 of dt, log dt ~
    U[log 1e-3, log 1e-1]), ``one_plus`` (1 + N(0, scale^2))."""
    k = dims(cfg)
    d, di, H, N, cw, L = k["d"], k["di"], k["H"], k["N"], k["cw"], k["L"]
    gain = 0.1
    return [
        ("embed", (k["V"], d), "normal", d ** -0.5),
        ("lm_head", (d, k["V"]), "normal", d ** -0.5),
        ("final_norm", (d,), "normal", gain),
        ("blocks.ln", (L, d), "normal", gain),
        ("blocks.mamba.w_z", (L, d, di), "normal", d ** -0.5),
        ("blocks.mamba.w_x", (L, d, di), "normal", d ** -0.5),
        ("blocks.mamba.w_b", (L, d, N), "normal", d ** -0.5),
        ("blocks.mamba.w_c", (L, d, N), "normal", d ** -0.5),
        ("blocks.mamba.w_dt", (L, d, H), "normal", d ** -0.5),
        ("blocks.mamba.conv_x_w", (L, cw, di), "normal", cw ** -0.5),
        ("blocks.mamba.conv_b_w", (L, cw, N), "normal", cw ** -0.5),
        ("blocks.mamba.conv_c_w", (L, cw, N), "normal", cw ** -0.5),
        ("blocks.mamba.conv_x_b", (L, di), "normal", gain),
        ("blocks.mamba.conv_b_b", (L, N), "normal", gain),
        ("blocks.mamba.conv_c_b", (L, N), "normal", gain),
        ("blocks.mamba.a_log", (L, H), "log_uniform_a", 0.0),
        ("blocks.mamba.dt_bias", (L, H), "dt_bias", 0.0),
        ("blocks.mamba.d_skip", (L, H), "one_plus", gain),
        ("blocks.mamba.norm", (L, di), "normal", gain),
        ("blocks.mamba.w_out", (L, di, d), "normal", di ** -0.5),
    ]


def _is_f32_leaf(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in F32_LEAVES


def make_weights(cfg: Mapping, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """Every stacked leaf drawn from ``seed`` by one generator on
    ``device``, one call a leaf, in ``dtype`` (the float32 leaves in
    float32)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = {}
    for name, shape, init, scale in leaf_specs(cfg):
        want = torch.float32 if _is_f32_leaf(name) else dtype
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
    return out


def leaf_names(cfg: Mapping) -> Iterator[Tuple[str, str, Optional[int]]]:
    """(one-layer name, stacked name, layer) of every leaf: a stacked
    leaf ``blocks.mamba.w_z`` is ``blocks.{i}.mamba.w_z`` for layer i."""
    L = int(cfg["num_layers"])
    for name, _, _, _ in leaf_specs(cfg):
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(L):
                yield f"blocks.{i}.{rest}", name, i
        else:
            yield name, name, None


def layer_leaf(w: Mapping[str, torch.Tensor], stacked: str,
               layer: Optional[int]) -> torch.Tensor:
    t = w[stacked]
    return t if layer is None else t[layer]


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def embed_scale(cfg: Mapping) -> float:
    """sqrt(d_model) rounded to bfloat16."""
    return float(torch.tensor(int(cfg["d_model"]) ** 0.5,
                              dtype=torch.bfloat16))


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + RMS_EPS) * (1.0 + scale.float())


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over positions, then SiLU.
    x: [B, S, C]; w: [cw, C]; b: [C]."""
    cw, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = sum(xp[:, i:i + S] * w[i].float() for i in range(cw))
    return F.silu(y + b.float())


def ssd(u: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, prec: str = "f32",
        chunk: int = SSD_CHUNK) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) exp(A (cum_t - cum_s)) dt_s u_s.
    u: [B, S, H, P]; dt: [B, S, H]; a_log: [H]; b, c: [B, S, N]."""
    Bsz, S, H, P = u.shape
    N = b.shape[-1]
    Lc = min(chunk, S)
    if S % Lc:                 # positions after the last change nothing
        pad = Lc - S % Lc
        u, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (u, dt, b, c))
        return ssd(u, dt, a_log, b, c, prec, chunk)[:, :S]
    NC = S // Lc
    a = -torch.exp(a_log.float())
    da = (dt * a).reshape(Bsz, NC, Lc, H)
    cum = torch.cumsum(da, dim=2)                                # [B,NC,Lc,H]
    uc = operand(u, prec).reshape(Bsz, NC, Lc, H, P)
    bc = operand(b, prec).reshape(Bsz, NC, Lc, N)
    cc = operand(c, prec).reshape(Bsz, NC, Lc, N)
    dtc = dt.reshape(Bsz, NC, Lc, H)
    # within a chunk
    seg = cum.permute(0, 1, 3, 2)                                # [B,NC,H,Lc]
    seg = seg[..., :, None] - seg[..., None, :]                  # [.., t, s]
    mask = torch.ones(Lc, Lc, dtype=torch.bool, device=u.device).tril()
    decay = torch.exp(seg.masked_fill(~mask, float("-inf")))
    g = torch.einsum("bctn,bcsn->bcts", cc, bc)                  # [B,NC,t,s]
    m = g[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[..., None, :]
    y = torch.einsum("bchts,bcshp->bcthp", m, uc)
    # the state each chunk leaves, and the recurrence between chunks
    tail = torch.exp(cum[:, :, -1:] - cum) * dtc                 # [B,NC,Lc,H]
    states = torch.einsum("bclh,bclhp,bcln->bchpn", tail, uc, bc)
    h = torch.zeros(Bsz, H, P, N, device=u.device)
    inter = []
    for i in range(NC):
        inter.append(h)
        h = h * torch.exp(cum[:, i, -1])[..., None, None] + states[:, i]
    h0 = torch.stack(inter, 1)                                   # [B,NC,H,P,N]
    y = y + torch.einsum("bctn,bchpn,bcth->bcthp", cc, h0, torch.exp(cum))
    return y.reshape(Bsz, S, H, P)


def mamba_block(w, i: int, x: torch.Tensor, cfg: Mapping,
                prec: str = "f32") -> torch.Tensor:
    """One Mamba2 block's output (the residual not added); x normed."""
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
    y = ssd(uh, dt, p["a_log"], b, c, prec)
    y = y + uh * p["d_skip"].float()[:, None]
    y = rms_norm(y.reshape(Bsz, S, k["di"]) * F.silu(z), p["norm"])
    return matmul(y, p["w_out"], prec)


def hidden(w, tokens: torch.Tensor, cfg: Mapping, prec: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden state [B, S, d] of ``tokens`` [B, S];
    ``remat`` recomputes each block in the backward."""
    def run(fn, *args):
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def mamba(i, h):
        return h + mamba_block(w, i, rms_norm(h, w["blocks.ln"][i]), cfg,
                               prec)

    h = w["embed"].float()[tokens.long()] * embed_scale(cfg)
    for i in range(int(cfg["num_layers"])):
        h = run(mamba, i, h)
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
# training: AdamW steps and the readings compared with the program's
# ---------------------------------------------------------------------------

def adamw_step(w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict, hp: Mapping) -> None:
    """One AdamW update in place: the gradients clipped to global norm
    ``clip_norm``, bias-corrected moments, decoupled weight decay."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(hp["clip_norm"] / torch.clamp(norm, min=1e-9),
                        max=1.0)
    state["step"] += 1
    t = state["step"]
    b1, b2 = hp["b1"], hp["b2"]
    for n, p in w.items():
        g = grads[n] * scale
        m, v = state["m"][n], state["v"][n]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        d = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + hp["eps"])
        p.sub_(hp["lr"] * (d + hp["weight_decay"] * p))


def train_readings(cfg: Mapping, w0: Dict[str, torch.Tensor], batches,
                   hp: Mapping, prec: str = "f32",
                   micro: Optional[int] = None) -> Dict:
    """The reference's readings over ``len(batches)`` steps from ``w0``
    (float32 copies are made): each step's loss and gradient norm before
    clipping, each leaf's norm of the clipped first gradient, and each
    leaf's change after the last step, by one-layer leaf name.  Rows of
    a batch go ``micro`` at a time, their gradients summed in float32."""
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
        for t in w.values():
            t.grad = None
        total = 0.0
        for r in range(0, rows, step):
            part = loss(w, inputs[r:r + step], targets[r:r + step], cfg, prec)
            (part * (min(step, rows - r) / rows)).backward()
            total += float(part.detach()) * min(step, rows - r) / rows
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
            adamw_step(w, grads, state, hp)
        for t in w.values():
            t.grad = None
    with torch.no_grad():
        change = {one: float((layer_leaf(w, st, i)
                              - layer_leaf(w0, st, i).float()).norm())
                  for one, st, i in leaf_names(cfg)}
    return {"losses": losses, "grad_norms": norms, "first_grad": first,
            "change": change}


def norm_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              skip: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and the median
    leaf's."""
    names = [n for n in ref if n not in skip]
    med = sorted(ref[n] for n in names)[len(names) // 2]
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def worst(gaps: Mapping[str, float]) -> Tuple[float, str]:
    """(the largest gap, its leaf)."""
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def median(gaps: Mapping[str, float]) -> float:
    vals = sorted(gaps.values())
    return vals[len(vals) // 2]


def still_leaves(first_grad: Mapping[str, float]) -> Tuple[str, ...]:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: AdamW moves them by rounding alone, so their change is not
    compared."""
    vals = sorted(first_grad.values())
    med = vals[len(vals) // 2]
    return tuple(n for n, v in first_grad.items() if v < 1e-3 * med)


def step_gaps(got: Mapping, want: Mapping) -> Dict[str, List[float]]:
    """Each step's gap of the loss and of the gradient norm before
    clipping, relative to the reference's."""
    return {k: [abs(a - b) / abs(b) for a, b in zip(got[k], want[k])]
            for k in ("losses", "grad_norms")}


def train_numbers(got: Mapping, want: Mapping) -> Dict[str, float]:
    """The numbers a training check compares, of readings ``got`` (the
    program's, or a control's) against the reference's ``want``: the first
    step's loss and gradient norm before clipping (the later steps' start
    from weights the configuration's bfloat16 storage has rounded apart
    from the reference's float32, PERF.md section 2), the median leaf's
    first gradient as AdamW holds it and the median leaf's change after
    the last step (the worst leaf of either is a few small leaves' noise;
    leaves the reference's gradient leaves still are not compared)."""
    skip = still_leaves(want["first_grad"])
    steps = step_gaps(got, want)
    return {
        "loss_gap": steps["losses"][0],
        "grad_norm_gap": steps["grad_norms"][0],
        "first_grad_gap": median(norm_gaps(got["first_grad"],
                                           want["first_grad"])),
        "change_gap": median(norm_gaps(got["change"], want["change"],
                                       skip))}
