"""The partitioned programs: one rank's prefill, decode step and train
step on a device mesh, at the sharding plan's placements.

The port's counterpart of the reference's ``jax.jit(step,
in_shardings=..., out_shardings=...)`` in ``launch/dryrun.py:74-117``.
``core/autoshard.py`` ``plan_sharding`` picks the specs;
``ShardingPlan.param_shardings`` (``batch_shardings``,
``cache_shardings``) turns them into ``torch.distributed.tensor``
placements on the ``DeviceMesh`` (``launch/mesh.py`` ``device_mesh``);
``build_model(cfg, mesh=device_mesh)`` is then one rank's program
(``models/shards.py``), which takes DTensors at those placements and
issues the collectives the reference's GSPMD partition inserts.

* ``distribute_params`` turns a model every rank holds whole (the JAX
  package's weights through ``params_from_reference``, in the tests) into
  one of DTensors; ``init_params`` draws the leaves from the one-device
  model's seeded generator, block by block, and keeps only each rank's
  shard of them, so no rank ever holds the whole model.
* ``init_cache`` allocates each rank's window of the cache.
* ``partitioned_prefill_step`` and ``partitioned_serve_step`` take
  their inputs at the plan's batch and cache placements and return the
  cache at ``cache_specs``, as the reference's ``out_shardings`` do (the
  cache is written in place, in each rank's window).
* ``init_opt_state`` allocates each rank's window of the optimizer state
  at ``opt_specs``; ``partitioned_train_step`` is one rank's forward,
  backward and update (ZeRO and FSDP state as placements), parameters
  and state written in place at their placements.
* ``run_ranks`` runs one function on every rank of a new process group,
  each in a process of its own: the CPU tests and ``chip_smoke.py`` spawn
  their ranks through it.  Under ``nccl`` rank r computes on card r of
  its host (``rank_device``), one rank a card, its communicator bound to
  that card, and a group of more ranks than cards is refused before
  anything starts; under ``gloo`` the ranks run where the caller puts
  them (the CPU, or several ranks on one card, whose CUDA tensors
  ``models/shards.py`` stages through the host).  The backend is the
  caller's; nothing switches backends.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.autoshard import P, ShardingPlan, placements, plan_sharding
from ..hw.gpu import H100Spec
from ..models.api import Model, ModelAPI, build_model, layer_stacks
from ..models.shards import Shards
from ..optim.optimizers import Optimizer, make_optimizer, tree_map
from .mesh import Mesh
from .steps import build_train_step


def shards_of(api: ModelAPI) -> Shards:
    """The ``Shards`` a partitioned API runs with."""
    if api.shards is None:
        raise ValueError("the API was not built on a DeviceMesh")
    return api.shards


def meta_params(cfg: ModelConfig, mesh, dtype: torch.dtype) -> Model:
    """The model's parameters on ``meta``, global shapes (the routed
    experts padded for ``mesh``'s model axis)."""
    return build_model(cfg, device="meta", dtype=dtype, mesh=mesh).init(0)


def default_optimizer(cfg: ModelConfig, params: Model, **kw) -> Optimizer:
    """``cfg``'s optimizer, Adafactor over the reference's layer stacks."""
    return make_optimizer(cfg.optimizer, stacks=layer_stacks(cfg, params),
                          **kw)


def plan_for(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
             dtype: torch.dtype = torch.bfloat16, pod=H100Spec()
             ) -> ShardingPlan:
    """The sharding plan of ``cfg`` for ``shape`` on ``mesh`` (a
    shape-only ``Mesh``), from meta parameters and cache, or (training)
    ``default_optimizer``'s state."""
    api = build_model(cfg, device="meta", dtype=dtype, mesh=mesh)
    params = api.init(0)
    if shape.mode == "train":
        state = default_optimizer(cfg, params).init(
            dict(params.named_parameters()))
        return plan_sharding(cfg, shape, mesh, params, state, pod=pod)
    return plan_sharding(cfg, shape, mesh, params, {}, pod=pod,
                         cache_shapes=api.init_cache(shape.global_batch,
                                                     shape.seq_len))


def _placer(api: ModelAPI, plan: ShardingPlan):
    """``place(name, leaf)``: the DTensor of the leaf's plan placement."""
    sh = shards_of(api)
    return lambda name, t: sh.shard(
        t, placements(plan.param_specs[name], sh.mesh))


def distribute_params(params: Model, plan: ShardingPlan, api: ModelAPI
                      ) -> Model:
    """``params`` (every rank holding the same whole model) with each leaf
    replaced, in place, by the DTensor of its plan placement; returns
    ``params``."""
    place = _placer(api, plan)
    for name, leaf in list(params.named_parameters()):
        owner_name, _, leaf_name = name.rpartition(".")
        owner = params.get_submodule(owner_name) if owner_name else params
        setattr(owner, leaf_name, torch.nn.Parameter(
            place(name, leaf.detach()), requires_grad=False))
    return params


def init_params(api: ModelAPI, plan: ShardingPlan, seed: int = 0) -> Model:
    """The model ``build_model(...).init(seed)`` draws on one device, each
    leaf replaced by this rank's shard as soon as its block is drawn: the
    same numbers on every rank, one block's full leaves live at a time."""
    return api.init(seed, place=_placer(api, plan))


def init_cache(api: ModelAPI, plan: ShardingPlan, batch: int,
               max_len: int) -> Dict[str, torch.Tensor]:
    """This rank's window of the zeroed cache, as DTensors at the plan's
    cache placements."""
    sh = shards_of(api)
    out = {}
    for name, (shape, dtype) in api.cache_shapes(batch, max_len).items():
        lay = sh.window(shape, placements(plan.cache_specs[name], sh.mesh))
        local = torch.zeros(lay.sizes, dtype=dtype, device=api.device)
        out[name] = sh.wrap(local, shape, lay.axes)
    return out


def init_opt_state(api: ModelAPI, optimizer: Optimizer,
                   plan: ShardingPlan) -> Any:
    """This rank's window of ``optimizer``'s zeroed state (every state
    starts at zero), as DTensors at the plan's ``opt_specs``: the state
    the optimizer's ``init`` gives the global meta parameters, each leaf
    allocated at its window only."""
    sh = shards_of(api)
    shape = Mesh(tuple(sh.size[a] for a in sh.axis_names), sh.axis_names)
    params = meta_params(api.cfg, shape, api.dtype)
    meta = optimizer.init(dict(params.named_parameters()))

    def place(t, spec):
        lay = sh.window(tuple(t.shape), placements(spec, sh.mesh))
        local = torch.zeros(lay.sizes, dtype=t.dtype, device=api.device)
        return sh.wrap(local, tuple(t.shape), lay.axes)
    return tree_map(place, meta, plan.opt_specs)


def distribute_batch(batch: Dict[str, torch.Tensor], plan: ShardingPlan,
                     api: ModelAPI) -> Dict[str, Any]:
    """A train batch (``inputs``, ``targets``, whole on every rank) as
    DTensors at the plan's ``batch_specs``."""
    return {k: distribute(v, plan.batch_specs[k], api)
            for k, v in batch.items()}


def partitioned_train_step(api: ModelAPI, optimizer: Optimizer,
                           plan: ShardingPlan):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one rank's forward, backward and update
    (``launch/steps.py`` ``build_train_step`` on the partitioned API).
    ``params`` at ``plan.param_specs`` (``init_params``, trainable),
    ``opt_state`` at ``plan.opt_specs`` (``init_opt_state``) and
    ``batch`` at ``plan.batch_specs`` (``distribute_batch``), all
    DTensors; both trees are updated in place and returned at their
    placements, as the reference's ``out_shardings`` give them back.

    The backward issues the collectives GSPMD inserts: the transposes of
    the forward's (``models/shards.py``), the FSDP gathers'
    reduce-scatters over the data axes; after it, each gradient of a leaf
    replicated over the data axes is all-reduced over them, or under
    ZeRO (``plan.zero_opt``: the moments sharded over the data axes, the
    parameters not) reduce-scattered to the moments' window: each rank
    updates its window of the parameter and all-gathers the parameter
    over them, so the data ranks' copies stay equal bit for bit.  Under
    FSDP parameter, gradient and state are all data-sharded and nothing
    is gathered back.  The metrics
    are the reference's, ``loss`` and ``grad_norm`` before clipping, the
    same 0-d tensors on every rank."""
    sh = shards_of(api)
    step = build_train_step(api, optimizer)
    want = {n: placements(spec, sh.mesh)
            for n, spec in plan.param_specs.items()}

    def train_step(params: Model, opt_state, batch):
        for n, p in params.named_parameters():
            if tuple(p.placements) != want[n]:
                raise ValueError(f"{n} at {p.placements}: the plan places "
                                 f"it at {want[n]}")
        return step(params, opt_state, batch)
    return train_step


def distribute(t: torch.Tensor, spec: P, api: ModelAPI):
    """``t`` (whole on every rank) as the DTensor of ``spec``."""
    sh = shards_of(api)
    return sh.shard(t, placements(spec, sh.mesh))


def token_spec(plan: ShardingPlan) -> P:
    """A decode step's tokens [B, 1]: the batch as the plan's inputs."""
    return P(plan.batch_specs["inputs"][0], None)


def partitioned_prefill_step(api: ModelAPI, max_len: int,
                             plan: ShardingPlan):
    """``prefill_step(params, inputs, cache=None) -> (logits, cache)``:
    ``inputs`` at the plan's ``inputs`` placement, the logits sharded as
    the batch and the vocabulary, the cache at ``cache_specs`` (this
    rank's window, allocated here unless given)."""
    def prefill_step(params, inputs, cache=None):
        if cache is None:
            cache = init_cache(api, plan, inputs.shape[0], max_len)
        return api.prefill(params, inputs, max_len, cache=cache)
    return prefill_step


def partitioned_serve_step(api: ModelAPI, plan: ShardingPlan):
    """``serve_step(params, cache, tokens, cache_len) -> (next tokens,
    cache)``: one decode step at the plan's placements and its greedy
    token, the argmax over the vocabulary gathered over ``model``; the
    tokens come back sharded as they went in."""
    def serve_step(params, cache, tokens, cache_len):
        logits, cache = api.decode_step(params, cache, tokens, cache_len)
        return next_tokens(api, logits, tokens.dtype), cache
    return serve_step


def next_tokens(api: ModelAPI, logits, dtype=torch.int64):
    """The greedy tokens [B, 1] of the last position of partitioned
    ``logits`` [B, S, V]: the vocabulary gathered over ``model``, the
    tokens sharded as the logits' batch."""
    sh = shards_of(api)
    last = logits.to_local()[:, -1]
    if last.shape[-1] < api.cfg.padded_vocab:
        last = sh.all_gather(last, -1)
    nxt = last.argmax(-1).to(dtype)[:, None]
    return sh.wrap(nxt, (logits.shape[0], 1), (sh.layout(logits).axes[0],
                                               ()))


# ---------------------------------------------------------------------------
# ranks in processes of their own
# ---------------------------------------------------------------------------

_SRC = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class RankFailure(RuntimeError):
    rank: int
    returncode: Optional[int]
    stderr: str

    def __str__(self) -> str:
        return (f"rank {self.rank} failed (exit {self.returncode}):\n"
                f"{self.stderr[-6000:]}")


def rank_device(rank: int, world: int) -> torch.device:
    """The card rank ``rank`` of an NCCL group of ``world`` computes on:
    card ``rank`` of this host, one rank a card.  Raises when the host
    has fewer than ``world`` cards (NCCL refuses two ranks on one
    device; nothing falls back to gloo or to the CPU)."""
    cards = torch.cuda.device_count()
    if world > cards:
        raise RuntimeError(f"an NCCL group of {world} ranks needs {world} "
                           f"cards, one a rank; this host has {cards}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a group of {world}")
    return torch.device("cuda", rank)


def rank_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of a rank's process: this one's, then ``env``
    over it, with the port's package first on ``PYTHONPATH``; gloo's and
    NCCL's bootstrap sockets on the loopback device unless set (a machine
    without a network has no other), and faulthandler on."""
    child = {**os.environ, **(env or {})}
    child["PYTHONPATH"] = os.pathsep.join(
        [str(_SRC)] + [p for p in child.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    child.setdefault("GLOO_SOCKET_IFNAME", "lo")
    child.setdefault("NCCL_SOCKET_IFNAME", "lo")
    child.setdefault("PYTHONFAULTHANDLER", "1")
    return child


def load_result(path) -> Any:
    """A rank's saved result, every tensor on the CPU (one saved on card
    3 would land on card 3 of the loading process otherwise)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def run_ranks(target: str, world: int, backend: str, args: Any = None,
              timeout: float = 600.0, env: Optional[Dict[str, str]] = None,
              log_path: Optional[str] = None) -> List[Any]:
    """Run ``target`` (``"package.module:function"`` or
    ``"path/to/file.py:function"``) as ``function(rank, world, args)`` on
    ``world`` processes joined in one process group of ``backend``
    (``gloo``, ``nccl``), initialised through a file, so nothing listens
    on a network port; returns each rank's result (anything ``torch.save``
    writes), by rank, on the CPU.  Each process is this Python with the
    port's package on its path, in ``rank_env(env)``; under ``nccl`` rank
    r runs on card r (``rank_device``: a group of more ranks than cards
    raises here, before any process starts).  With ``log_path`` (a path
    holding ``{rank}``) each rank's output is kept there.  A rank that
    fails, or a group that outlives ``timeout`` seconds, ends every
    process and raises."""
    if backend == "nccl":
        rank_device(0, world)
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        tmp = Path(tmp)
        torch.save(args, tmp / "args.pt")
        child_env = rank_env(env)
        log_path = log_path or str(tmp / "rank{rank}.log")
        procs, logs = [], []
        for r in range(world):
            cmd = [sys.executable, "-m", "repro_torch.launch.partition",
                   target, str(r), str(world), backend, str(tmp)]
            path = Path(log_path.format(rank=r))
            path.parent.mkdir(parents=True, exist_ok=True)
            logs.append(open(path, "w+"))
            procs.append(subprocess.Popen(cmd, env=child_env,
                                          stdout=logs[r],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    raise RankFailure(bad[0], procs[bad[0]].returncode,
                                      _tail(logs[bad[0]]))
                if time.monotonic() > deadline:
                    r = next(r for r, p in enumerate(procs)
                             if p.poll() is None)
                    raise RankFailure(r, None, f"timed out after {timeout} "
                                      f"s\n{_tail(logs[r])}")
                time.sleep(0.05)
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    raise RankFailure(r, p.returncode, _tail(logs[r]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        return [load_result(tmp / f"out{r}.pt") for r in range(world)]


def _tail(log) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-20000:]


def _load_target(target: str) -> Callable:
    where, _, fn = target.rpartition(":")
    if where.endswith(".py"):
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            Path(where).stem, where)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        import importlib
        mod = importlib.import_module(where)
    return getattr(mod, fn)


def _rank_main(argv: List[str]) -> int:
    import torch.distributed as dist
    target, rank, world, backend, tmp = argv
    rank, world, tmp = int(rank), int(world), Path(tmp)
    bind = {}
    if backend == "nccl":          # the communicator bound to its card
        dev = rank_device(rank, world)
        torch.cuda.set_device(dev)
        bind = {"device_id": dev}
    dist.init_process_group(backend, init_method=f"file://{tmp / 'init'}",
                            rank=rank, world_size=world, **bind)
    try:
        args = torch.load(tmp / "args.pt", weights_only=False)
        out = _load_target(target)(rank, world, args)
        dist.barrier(device_ids=[rank] if bind else None)
    finally:
        dist.destroy_process_group()
    torch.save(out, tmp / f"out{rank}.pt")
    return 0


__all__ = ["RankFailure", "default_optimizer", "distribute",
           "distribute_batch", "distribute_params", "init_cache",
           "init_opt_state", "init_params", "load_result", "meta_params",
           "next_tokens", "partitioned_prefill_step",
           "partitioned_serve_step", "partitioned_train_step", "plan_for",
           "rank_device", "rank_env", "run_ranks", "shards_of",
           "token_spec"]


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
