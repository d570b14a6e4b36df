"""The reference's partitioned programs, for ``test_torch_partition_*.py``:
run as a script in a process of its own, whose JAX sees ``--devices`` host
devices (the tests' own process keeps one):

  python tests/_partition_ref.py moe OUT.npz --devices 4
  python tests/_partition_ref.py dryrun OUT.json --devices 8

``moe``: the reference's ``moe_ffn`` under ``shard_map`` over a host mesh,
as ``models/api.py`` ``_routed_moe`` runs it, for each case of ``MOE``;
the weights, the input and the output to an npz.  ``dryrun``: tiny
Qwen2-MoE's prefill compiled partitioned over a (2, 4) host mesh with the
plan's shardings, as ``launch/dryrun.py`` compiles a cell; per-device
FLOPs and collective bytes (``launch/hlo_cost.py``) and the result shapes
of the partitioned HLO's all-reduces, to a JSON file."""
import argparse
import dataclasses
import functools
import json
import os
import re
import sys

#: (name, arch, config overrides, mesh (data, model), batch, sequence)
MOE = (("qwen2-moe-1x4", "qwen2-moe-a2.7b", {}, (1, 4), 4, 32),
       ("qwen2-moe-2x2", "qwen2-moe-a2.7b", {}, (2, 2), 4, 32),
       ("padded-6-experts", "qwen2-moe-a2.7b", {"num_experts": 6}, (1, 4),
        4, 32),
       ("drops-2x2", "qwen2-moe-a2.7b", {"capacity_factor": 0.5}, (2, 2),
        4, 32))
#: the dry-run case: arch, mesh, batch, sequence
DRYRUN = ("qwen2-moe-a2.7b", (2, 4), 4, 32)


def _mesh(jax, shape):
    return jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]])


def moe(out):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.train import tiny_config
    from repro.models.moe import init_moe, moe_ffn

    arrays = {}
    for name, arch, over, shape, B, S in MOE:
        cfg = dataclasses.replace(tiny_config(get_config(arch)), **over)
        mesh = _mesh(jax, shape)
        p = init_moe(jax.random.PRNGKey(0), cfg, shape[1], jnp.float32)
        p = {k: v for k, v in p.items() if k != "shared"}
        x = np.random.default_rng(1).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        pspecs = {"router": P(), "wi": P("model", None, None),
                  "wg": P("model", None, None), "wo": P("model", None, None)}
        fn = shard_map(functools.partial(moe_ffn, cfg=cfg, model_axis="model"),
                       mesh=mesh, in_specs=(pspecs, P("data", None, None)),
                       out_specs=P("data", None, None), check_rep=False)
        y = jax.jit(fn)(p, jnp.asarray(x))
        for k, v in p.items():
            arrays[f"{name}/p/{k}"] = np.asarray(v)
        arrays[f"{name}/x"] = x
        arrays[f"{name}/y"] = np.asarray(y)
    np.savez(out, **arrays)


def dryrun(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.core.autoshard import plan_sharding
    from repro.launch.hlo_cost import analyze_hlo
    from repro.launch.steps import build_prefill_step
    from repro.launch.train import tiny_config
    from repro.models.api import build_model

    arch, shape, B, S = DRYRUN
    cfg = tiny_config(get_config(arch))
    mesh = _mesh(jax, shape)
    api = build_model(cfg, mesh=mesh, dtype=jnp.float32)
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: api.init_cache(B, S))
    cell = ShapeConfig("tiny_prefill", S, B, "prefill")
    plan = plan_sharding(cfg, cell, mesh, params, {}, cache_shapes=cache)

    def shardings(specs):
        return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                      specs, is_leaf=lambda x:
                                      isinstance(x, P))
    with mesh:
        step = jax.jit(build_prefill_step(api, S),
                       in_shardings=(shardings(plan.param_specs),
                                     shardings(plan.batch_specs["inputs"])),
                       out_shardings=(None, shardings(plan.cache_specs)))
        hlo = step.lower(params, jax.ShapeDtypeStruct(
            (B, S), jnp.int32)).compile().as_text()
    cost = analyze_hlo(hlo)
    reduces = []
    for line in hlo.splitlines():
        m = re.search(r"=\s*(.*?)\s+all-reduce(?:-start)?\(", line)
        if m:
            reduces += [(t, [int(d) for d in dims.split(",") if d])
                        for t, dims in re.findall(r"([a-z0-9]+)\[([0-9,]*)\]",
                                                  m.group(1))]
    with open(out, "w") as f:
        json.dump({"flops": cost.flops, "coll_by_kind": cost.coll_by_kind,
                   "all_reduce_shapes": reduces,
                   "plan": [plan.zero_opt, plan.attn_sharded]}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("moe", "dryrun"))
    ap.add_argument("out")
    ap.add_argument("--devices", type=int, required=True)
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={args.devices}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    {"moe": moe, "dryrun": dryrun}[args.what](args.out)


if __name__ == "__main__":
    main()
