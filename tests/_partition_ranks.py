"""The ranks' side of the partitioned tests (``test_torch_partition*.py``):
each function runs on every rank of one gloo group of
``launch/partition.py`` ``run_ranks``, as ``fn(rank, world, args)``, on
the CPU, and returns its cases' results whole on rank 0 (None elsewhere).
No JAX here: the reference's numbers come from the test process."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import partition as pt
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.launch.train import tiny_config
from repro_torch.models.api import build_model, params_from_reference
from repro_torch.models.moe import moe_ffn
from repro_torch.models.shards import Shards

AXES = ("data", "model")


def _meshes(shapes):
    torch.set_num_threads(1)
    return {tuple(s): device_mesh(Mesh(tuple(s), AXES), "cpu")
            for s in sorted({tuple(s) for s in shapes})}


def serve_cases(rank, world, args):
    """Per case (arch, mesh, the reference's weights, a prompt and one
    token): the partitioned prefill's logits, one decode step's logits,
    the cache after it, the plan's choices and the decode step's
    collectives, every tensor whole."""
    meshes = _meshes(c["mesh"] for c in args["cases"])
    out = {}
    for case in args["cases"]:
        shape = tuple(case["mesh"])
        dm = meshes[shape]
        cfg = tiny_config(get_config(case["arch"]))
        B, S, max_len = case["B"], case["S"], case["max_len"]
        api = build_model(cfg, device="cpu", dtype=torch.float32, mesh=dm)
        sh = api.shards
        plan = pt.plan_for(cfg, ShapeConfig("case", max_len, B, "prefill"),
                           Mesh(shape, AXES), torch.float32)
        params = pt.distribute_params(params_from_reference(
            cfg, case["tree"], device="cpu", dtype=torch.float32), plan, api)
        inputs = pt.distribute(torch.from_numpy(case["inputs"]),
                               plan.batch_specs["inputs"], api)
        with torch.inference_mode():
            logits, cache = pt.partitioned_prefill_step(api, max_len, plan)(
                params, inputs)
            tokens = pt.distribute(torch.from_numpy(case["tokens"]),
                                   pt.token_spec(plan), api)
            step, cache = api.decode_step(params, cache, tokens, S)
            res = {"prefill": sh.full(logits).numpy(),
                   "decode": sh.full(step).numpy(),
                   "cache": {k: sh.full(v).numpy() for k, v in cache.items()},
                   "plan": {"attn_sharded": plan.attn_sharded,
                            "cache_k": tuple(plan.cache_specs["k"])
                            if "k" in plan.cache_specs else None,
                            "wk": tuple(plan.param_specs.get(
                                "blocks.0.attn.wk", ()))}}
        out[(case["arch"], shape)] = res
    return out if rank == 0 else None


def moe_cases(rank, world, args):
    """Per case (config overrides, mesh, the reference's MoE weights and
    input): ``moe_ffn`` expert-parallel over ``model`` on this rank's
    experts and data shard of tokens, the output gathered over ``data``,
    and the dropped (token, slot) pairs of this rank's routing."""
    import dataclasses
    from repro_torch.models.moe import counting_drops
    meshes = _meshes(c["mesh"] for c in args["cases"])
    out = {}
    for case in args["cases"]:
        shape = tuple(case["mesh"])
        dm = meshes[shape]
        sh = Shards(dm)
        cfg = dataclasses.replace(tiny_config(get_config(case["arch"])),
                                  **case["over"])
        p = {k: torch.from_numpy(np.asarray(v)) for k, v in case["p"].items()}
        E_l = p["wi"].shape[0] // sh.tp
        e0 = sh.model_rank * E_l
        local = {"router": p["router"]}
        for k in ("wi", "wg", "wo"):
            local[k] = p[k][e0:e0 + E_l].contiguous()
        x = torch.from_numpy(case["x"])
        B_l = x.shape[0] // sh.size["data"]
        b0 = sh.coord["data"] * B_l
        with torch.inference_mode(), counting_drops() as count:
            y = moe_ffn(local, x[b0:b0 + B_l], cfg, model_axis=dm["model"])
            y = sh.all_gather(y, 0, ("data",))
        out[case["name"]] = {"y": y.numpy(), "dropped": count.dropped,
                             "experts": E_l}
    return out if rank == 0 else None
