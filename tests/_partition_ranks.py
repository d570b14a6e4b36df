"""The ranks' side of the partitioned tests (``test_torch_partition*.py``):
each function runs on every rank of one gloo group of
``launch/partition.py`` ``run_ranks``, as ``fn(rank, world, args)``, on
the CPU, and returns its cases' results whole on rank 0 (None elsewhere).
No JAX here: the reference's numbers come from the test process."""
import numpy as np
import torch
from torch.overrides import TorchFunctionMode

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


class BareCollectives(TorchFunctionMode):
    """Raises on a ``_c10d_functional`` collective called while a gradient
    is recorded through it.  The port's collectives run inside their
    autograd functions, where none is; one outside would backpropagate
    through PyTorch's own formula (once DTensor is imported, the identity
    for all three, silently wrong for a gather or a scatter; before, a
    warning), not through its transpose."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if str(func).startswith("_c10d_functional.") and \
                torch.is_grad_enabled() and any(
                    isinstance(t, torch.Tensor) and t.requires_grad
                    for t in list(args) + list(kwargs.values())):
            raise RuntimeError(f"{func} records a gradient outside the "
                               f"port's collectives")
        return func(*args, **kwargs)


def train_cases(rank, world, args):
    """Per case (arch, optimizer override, mesh, HBM budget, the
    reference's weights, the batches): the partitioned train step on this
    rank, each step's loss and gradient norm, the first batch's gradients
    reduced as the step reduces them and gathered whole, the plan's
    choices, and whether every rank holding the same window of a leaf
    holds the same bytes after each update.  Every case runs under
    ``BareCollectives``: a collective without its explicit backward fails
    it."""
    with BareCollectives():
        return _train_cases(rank, args)


def _train_cases(rank, args):
    import dataclasses

    from repro_torch.hw.gpu import H100Spec
    from repro_torch.hw.template import TPUPodSpec
    from repro_torch.optim.optimizers import TreeShards, tree_map
    meshes = _meshes(c["mesh"] for c in args["cases"])
    out = {}
    for case in args["cases"]:
        shape = tuple(case["mesh"])
        dm = meshes[shape]
        cfg = tiny_config(get_config(case["arch"]))
        if case.get("optimizer"):
            cfg = dataclasses.replace(cfg, optimizer=case["optimizer"])
        pod = H100Spec() if case["hbm"] is None else dataclasses.replace(
            TPUPodSpec(), hbm_bytes=case["hbm"])
        B, S = case["batches"][0]["targets"].shape
        mesh = Mesh(shape, AXES)
        api = build_model(cfg, device="cpu", dtype=torch.float32, mesh=dm)
        sh = api.shards
        plan = pt.plan_for(cfg, ShapeConfig("case", S, B, "train"), mesh,
                           torch.float32, pod=pod)
        params = api.train_params(pt.distribute_params(params_from_reference(
            cfg, case["tree"], device="cpu", dtype=torch.float32), plan, api))
        opt = pt.default_optimizer(cfg, params, lr=1e-3)
        state = pt.init_opt_state(api, opt, plan)
        step = pt.partitioned_train_step(api, opt, plan)
        res = {"loss": [], "grad_norm": [], "equal": [],
               "plan": (plan.zero_opt, plan.attn_sharded, plan.fsdp)}
        for i, b in enumerate(case["batches"]):
            batch = pt.distribute_batch({k: torch.from_numpy(v)
                                         for k, v in b.items()}, plan, api)
            if i == 0:
                api.loss_fn(params, batch).backward()
                named = dict(params.named_parameters())
                view = TreeShards(sh, {n: sh.layout(p)
                                       for n, p in named.items()},
                                  tree_map(sh.layout, state), opt.mirror)
                with torch.no_grad():
                    res["grads"] = {n: _whole(sh, view.reduce(
                        n, p.grad.to_local()), view.grads[n]).numpy()
                        for n, p in named.items()}
                for p in named.values():
                    p.grad = None
            params, state, m = step(params, state, batch)
            res["loss"].append(float(m["loss"]))
            res["grad_norm"].append(float(m["grad_norm"]))
            res["equal"].append(_windows_equal(sh, params))
        out[case["name"]] = res
    return out if rank == 0 else None


def _whole(sh, t, lay):
    """A window gathered whole over every axis that shards it."""
    for d, ax in enumerate(lay.axes):
        if ax:
            t = sh.all_gather(t, d, ax)
    return t


def _windows_equal(sh, params) -> bool:
    """Every rank that holds the same window of a leaf (the axes that do
    not shard it) holds the same bytes, on every rank."""
    bad = 0.0
    with torch.no_grad():
        for p in params.parameters():
            lay = sh.layout(p)
            peers = [a for a in sh.axis_names
                     if not any(a in ax for ax in lay.axes)]
            x = p.to_local().reshape(1, -1)
            bad += float(not bool((sh.all_gather(x, 0, peers) == x).all()))
    return float(sh.all_reduce(torch.tensor(bad), sh.axis_names)) == 0.0


#: the collectives of ``transpose_cases``: (name, what its input and its
#: output are on the ranks: "L", each rank's own, or "R", alike on every
#: rank of the group)
TRANSPOSES = (("finish", "L", "R"), ("enter", "R", "L"),
              ("all_gather", "L", "L"), ("reduce_scatter", "L", "L"),
              ("local", "L", "L"))


def transpose_cases(rank, world, args):
    """Per mesh and collective of ``TRANSPOSES``, in f64: ⟨op(x), y⟩ and
    ⟨x, op's backward of y⟩, each summed over the ranks (a value alike on
    every rank of the op's group counted once), and whether the gradient
    of an "R" input came out alike on the group's ranks."""
    meshes = _meshes(args["meshes"])
    out = {}
    for shape, dm in meshes.items():
        sh = Shards(dm)
        for name, kind_in, kind_out in TRANSPOSES:
            axis = "data" if name == "local" else "model"
            group = sh.groups[axis]
            n = sh.size[axis]
            gen = torch.Generator().manual_seed(7)
            # one seed a group for "R" values, one a rank for "L" ones
            base = [torch.randn(8, 6, generator=gen, dtype=torch.float64)
                    for _ in range(world + 1)]
            x = (base[world] if kind_in == "R" else base[rank]).clone()
            if name == "reduce_scatter":
                x = x.repeat(n, 1)
            x.requires_grad_(True)
            if name == "finish":
                y_ = sh.finish(x, partial=True)
            elif name == "enter":
                y_ = sh.enter(x)
            elif name == "all_gather":
                y_ = sh.all_gather(x, 0)
            elif name == "reduce_scatter":
                y_ = sh.reduce_scatter(x, 0)
            else:               # a leaf's FSDP shard, gathered over data
                y_ = sh.local(sh.wrap(x, (8 * n, 6), [("data",), ()]))
            gen2 = torch.Generator().manual_seed(11 + (
                sh.coord["data"] if kind_out == "R" else 100 + rank))
            y = torch.randn(y_.shape, generator=gen2, dtype=torch.float64)
            y_.backward(y)
            lhs = float((y_.detach() * y).sum()) / (n if kind_out == "R"
                                                    else 1)
            rhs = float((x.detach() * x.grad).sum()) / (n if kind_in == "R"
                                                        else 1)
            alike = True
            if kind_in == "R":
                g = sh.all_gather(x.grad.detach()[None], 0, (axis,))
                alike = bool((g == g[0]).all())
            sums = torch.tensor([lhs, rhs], dtype=torch.float64)
            torch.distributed.all_reduce(sums)
            out[(shape, name)] = (float(sums[0]), float(sums[1]), alike)
    return out if rank == 0 else None
