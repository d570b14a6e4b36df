"""The partitioned serving program: one rank's prefill and decode step on
a device mesh, at the sharding plan's placements.

The port's counterpart of the reference's ``jax.jit(step,
in_shardings=..., out_shardings=...)`` in ``launch/dryrun.py:81-117``.
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
* ``run_ranks`` runs one function on every rank of a new process group,
  each in a process of its own (``gloo`` on the CPU, or on one card for
  several ranks, where NCCL refuses two ranks on one device): the CPU
  tests and ``chip_smoke.py`` spawn their ranks through it.  The backend
  is the caller's; nothing switches backends.
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
from ..models.api import Model, ModelAPI, build_model
from ..models.shards import Shards
from .mesh import Mesh


def shards_of(api: ModelAPI) -> Shards:
    """The ``Shards`` a partitioned API runs with."""
    if api.shards is None:
        raise ValueError("the API was not built on a DeviceMesh")
    return api.shards


def plan_for(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
             dtype: torch.dtype = torch.bfloat16) -> ShardingPlan:
    """The sharding plan of ``cfg`` for ``shape`` on ``mesh`` (a
    shape-only ``Mesh``), from meta parameters and cache."""
    api = build_model(cfg, device="meta", dtype=dtype, mesh=mesh)
    cache = api.init_cache(shape.global_batch, shape.seq_len) \
        if shape.mode != "train" else None
    return plan_sharding(cfg, shape, mesh, api.init(0), {},
                         cache_shapes=cache)


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


def run_ranks(target: str, world: int, backend: str, args: Any = None,
              timeout: float = 600.0) -> List[Any]:
    """Run ``target`` (``"package.module:function"`` or
    ``"path/to/file.py:function"``) as ``function(rank, world, args)`` on
    ``world`` processes joined in one process group of ``backend``
    (``gloo``, ``nccl``), initialised through a file, so nothing listens
    on a network port; returns each rank's result (anything ``torch.save``
    writes), by rank.  Each process is this Python with the port's
    package on its path.  A rank that fails, or a group that outlives
    ``timeout`` seconds, ends every process and raises."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        tmp = Path(tmp)
        torch.save(args, tmp / "args.pt")
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(_SRC)] + [p for p in child_env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        child_env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        child_env.setdefault("PYTHONFAULTHANDLER", "1")
        procs, logs = [], []
        for r in range(world):
            cmd = [sys.executable, "-m", "repro_torch.launch.partition",
                   target, str(r), str(world), backend, str(tmp)]
            logs.append(open(tmp / f"log{r}.txt", "w+"))
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
        return [torch.load(tmp / f"out{r}.pt", weights_only=False)
                for r in range(world)]


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
    dist.init_process_group(backend, init_method=f"file://{tmp / 'init'}",
                            rank=rank, world_size=world)
    try:
        args = torch.load(tmp / "args.pt", weights_only=False)
        out = _load_target(target)(rank, world, args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, tmp / f"out{rank}.pt")
    return 0


__all__ = ["RankFailure", "distribute", "distribute_params", "init_cache",
           "init_params", "next_tokens", "partitioned_prefill_step",
           "partitioned_serve_step", "plan_for", "run_ranks", "shards_of",
           "token_spec"]


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
