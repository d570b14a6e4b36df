"""The reference's partitioned programs, for ``test_torch_partition_*.py``:
run as a script in a process of its own, whose JAX sees ``--devices`` host
devices (the tests' own process keeps one):

  python tests/_partition_ref.py moe OUT.npz --devices 4
  python tests/_partition_ref.py dryrun OUT.json --devices 8
  python tests/_partition_ref.py train OUT.npz --devices 4 --cases C.json
  python tests/_partition_ref.py dryrun-train OUT.json --devices 8

``moe``: the reference's ``moe_ffn`` under ``shard_map`` over a host mesh,
as ``models/api.py`` ``_routed_moe`` runs it, for each case of ``MOE``;
the weights, the input and the output to an npz.  ``dryrun``: tiny
Qwen2-MoE's prefill compiled partitioned over a (2, 4) host mesh with the
plan's shardings, as ``launch/dryrun.py`` compiles a cell; per-device
FLOPs and collective bytes (``launch/hlo_cost.py``) and the result shapes
of the partitioned HLO's all-reduces, to a JSON file.  ``train``: each
case of the JSON file ``--cases`` (arch, mesh, HBM budget) as
``launch/dryrun.py`` compiles a train cell, ``jax.jit(train_step,
in_shardings=..., out_shardings=...)`` with the plan's specs, run for
``TRAIN_STEPS`` steps on ``train_batch``'s batches: the losses, gradient
norms, the first batch's gradients (``jax.grad`` in the same jit) and the
plan's choices, to an npz.  ``dryrun-train``: ``DRYRUN_TRAIN`` compiled
so, per-device FLOPs and the plan's choices, to a JSON file."""
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
#: the dry-run's tiny train cell: arch, mesh, batch, sequence
DRYRUN_TRAIN = ("qwen2.5-3b", (2, 4), 8, 64)
#: the train cases' global batch and steps
TRAIN_B, TRAIN_STEPS = 4, 3


def train_seq(cfg):
    """The train cases' sequence: one CE chunk (512), so the chunked CE
    runs; 64 for the SSM families, whose reference gradients are NaN from
    128 positions on (two or more SSD chunks), so no oracle exists
    there."""
    return 64 if cfg.family in ("ssm", "hybrid") else 512


def train_config(arch, optimizer=None):
    """The tiny config of a train case (``optimizer`` overrides it)."""
    from repro.configs import get_config
    from repro.launch.train import tiny_config
    cfg = tiny_config(get_config(arch))
    return cfg if optimizer is None else dataclasses.replace(
        cfg, optimizer=optimizer)


def train_batch(cfg, step):
    """Step ``step``'s batch of ``cfg``'s train cases, numpy, from its
    seed."""
    import numpy as np
    rng = np.random.default_rng(100 + step)
    shape = (TRAIN_B, train_seq(cfg))
    if cfg.frontend == "embed":
        inputs = (rng.standard_normal(shape + (cfg.d_model,)) * 0.5
                  ).astype(np.float32)
    else:
        inputs = rng.integers(1, cfg.vocab_size, shape).astype(np.int32)
    return {"inputs": inputs,
            "targets": rng.integers(0, cfg.vocab_size, shape
                                    ).astype(np.int32)}


def _mesh(jax, shape, auto=False):
    """A host mesh of ``shape``; ``auto``: with the reference's own axis
    types (``launch/mesh.py``), under which its train step compiles."""
    kw = {"axis_types": (jax.sharding.AxisType.Auto,) * 2} if auto else {}
    return jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]], **kw)


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


def _train_jit(api, cfg, mesh, shape, pod, optimizer):
    """The reference's train cell compiled as ``launch/dryrun.py`` does,
    with the gradients of its batch beside the step (one compile:
    ``(params, state, batch) -> (grads, params, state, metrics)``), the
    parameters and state placed at its plan's shardings, and the batch's
    shardings."""
    import jax
    from repro.core.autoshard import plan_sharding
    from repro.launch.steps import build_train_step

    params = api.init(jax.random.PRNGKey(0))
    state = optimizer.init(params)
    plan = plan_sharding(cfg, shape, mesh, jax.eval_shape(lambda: params),
                         jax.eval_shape(lambda: state), pod=pod)
    ps, os_, bs = (_shardings(jax, mesh, s) for s in (
        plan.param_specs, plan.opt_specs, plan.batch_specs))
    train_step = build_train_step(api, optimizer)

    def step(p, s, b):
        return (jax.grad(api.loss_fn)(p, b),) + train_step(p, s, b)
    return jax.jit(step, in_shardings=(ps, os_, bs),
                   out_shardings=(ps, ps, os_, None)), plan, \
        jax.device_put(params, ps), jax.device_put(state, os_), bs


def _shardings(jax, mesh, specs):
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs,
                                  is_leaf=lambda x: isinstance(x, P))


def _fsdp(jax, plan):
    """The reference's plan keeps no FSDP flag: its parameters sharded
    over ``data`` say it."""
    from jax.sharding import PartitionSpec as P
    return any(e == "data" or (isinstance(e, tuple) and "data" in e)
               for spec in jax.tree_util.tree_leaves(
                   plan.param_specs, is_leaf=lambda x: isinstance(x, P))
               for e in spec)


def _pod(hbm):
    from repro.hw.template import TPUPodSpec
    return TPUPodSpec() if hbm is None else dataclasses.replace(
        TPUPodSpec(), hbm_bytes=hbm)


def train(out, cases):
    import jax
    import numpy as np
    from repro.configs.base import ShapeConfig
    from repro.models.api import build_model
    from repro.optim.optimizers import make_optimizer

    arrays = {}
    for case in json.loads(open(cases).read()):
        cfg = train_config(case["arch"], case.get("optimizer"))
        mesh = _mesh(jax, tuple(case["mesh"]), auto=True)
        shape = ShapeConfig("t", train_seq(cfg), TRAIN_B, "train")
        api = build_model(cfg, mesh=mesh, dtype=np.float32)
        with mesh:
            step, plan, params, state, bs = _train_jit(
                api, cfg, mesh, shape, _pod(case["hbm"]),
                make_optimizer(cfg.optimizer, lr=1e-3))
            name = case["name"]
            for i in range(TRAIN_STEPS):
                batch = jax.device_put(train_batch(cfg, i), bs)
                g, params, state, m = step(params, state, batch)
                if i == 0:
                    for path, leaf in jax.tree_util.tree_flatten_with_path(
                            g)[0]:
                        key = "/".join(k.key for k in path)
                        arrays[f"{name}/grad/{key}"] = np.asarray(leaf)
                arrays[f"{name}/loss/{i}"] = np.asarray(m["loss"])
                arrays[f"{name}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
        arrays[f"{name}/plan"] = np.array(
            [plan.zero_opt, plan.attn_sharded, _fsdp(jax, plan)])
    np.savez(out, **arrays)


def dryrun_train(out):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.core.autoshard import plan_sharding
    from repro.launch.hlo_cost import analyze_hlo
    from repro.launch.steps import build_train_step, input_structs
    from repro.launch.train import tiny_config
    from repro.models.api import build_model
    from repro.optim.optimizers import make_optimizer

    arch, shape, B, S = DRYRUN_TRAIN
    cfg = dataclasses.replace(tiny_config(get_config(arch)), remat="block")
    mesh = _mesh(jax, shape, auto=True)
    cell = ShapeConfig("tiny_train", S, B, "train")
    api = build_model(cfg, mesh=mesh, dtype=jnp.float32)
    optimizer = make_optimizer(cfg.optimizer)
    with mesh:
        param_sds = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        opt_sds = jax.eval_shape(optimizer.init, param_sds)
        plan = plan_sharding(cfg, cell, mesh, param_sds, opt_sds)
        ps, os_, bs = (_shardings(jax, mesh, s) for s in (
            plan.param_specs, plan.opt_specs, plan.batch_specs))
        hlo = jax.jit(build_train_step(api, optimizer),
                      in_shardings=(ps, os_, bs),
                      out_shardings=(ps, os_, None),
                      donate_argnums=(0, 1)).lower(
            param_sds, opt_sds, input_structs(cfg, cell)).compile().as_text()
    cost = analyze_hlo(hlo)
    with open(out, "w") as f:
        json.dump({"flops": cost.flops, "coll_by_kind": cost.coll_by_kind,
                   "plan": [plan.zero_opt, plan.attn_sharded,
                            _fsdp(jax, plan)]}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("moe", "dryrun", "train",
                                     "dryrun-train"))
    ap.add_argument("out")
    ap.add_argument("--devices", type=int, required=True)
    ap.add_argument("--cases", default=None)
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={args.devices}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    if args.what == "train":
        train(args.out, args.cases)
    else:
        {"moe": moe, "dryrun": dryrun,
         "dryrun-train": dryrun_train}[args.what](args.out)


if __name__ == "__main__":
    main()
