"""What the language model's drivers share: the program's configuration
and model built from the benchmark's configuration file and weights."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from bench.reference import mamba2 as ref

SIZES = ("num_layers", "d_model", "vocab_size", "ssm_state", "ssm_head_dim",
         "ssm_expand", "conv_width")
MAMBA = ("w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x_w", "conv_b_w",
         "conv_c_w", "conv_x_b", "conv_b_b", "conv_c_b", "a_log", "dt_bias",
         "d_skip", "norm", "w_out")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: Mapping):
    """The program's ``ModelConfig`` of the configuration file: its
    registered architecture with every size replaced by the file's."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    if base.family != cfg["family"]:
        raise ValueError(f"{cfg['arch']} is {base.family}, the file says "
                         f"{cfg['family']}")
    return dataclasses.replace(base, **{k: cfg[k] for k in SIZES})


def port_model(cfg: Mapping, w: Dict[str, torch.Tensor]):
    """The program's ``Model`` holding copies of the benchmark's stacked
    weights ``w``, one leaf a layer; its parameter names are the
    reference's one-layer names (checked)."""
    from repro_torch.models.api import Block, Model
    blocks = [Block({"ln": w["blocks.ln"][i].clone(),
                     "mamba": {k: w[f"blocks.mamba.{k}"][i].clone()
                               for k in MAMBA}})
              for i in range(int(cfg["num_layers"]))]
    model = Model(w["embed"].clone(), w["final_norm"].clone(),
                  w["lm_head"].clone(), blocks, None)
    want = {one for one, _, _ in ref.leaf_names(cfg)}
    got = {n for n, _ in model.named_parameters()}
    if got != want:
        raise ValueError(f"the program's leaves differ from the reference's:"
                         f" {sorted(got ^ want)[:8]}")
    return model


def check_shapes(cfg: Mapping, api, model) -> None:
    """Every leaf of ``model`` at the shape and type the program's own
    ``init`` gives it (traced on ``meta``)."""
    from repro_torch.models.api import build_model
    meta = build_model(api.cfg, device="meta", dtype=api.dtype).init(0)
    want = {n: (tuple(p.shape), p.dtype) for n, p in meta.named_parameters()}
    for n, p in model.named_parameters():
        if want.get(n) != (tuple(p.shape), p.dtype):
            raise ValueError(f"{n}: {tuple(p.shape)} {p.dtype}, the program "
                             f"builds {want.get(n)}")


def tokens(seed: int, device: torch.device, shape, vocab: int,
           salt: int) -> torch.Tensor:
    """Token ids in [1, vocab) of ``shape``, int32, drawn on ``device``
    by a generator seeded from ``seed`` and ``salt``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 16 + salt)
    return torch.randint(1, vocab, tuple(shape), generator=g, device=device,
                         dtype=torch.int32)
