"""The partitioned train step (``launch/partition.py``
``partitioned_train_step``: one rank's forward, backward and update on
local shards, ``models/shards.py``'s collectives with their transposes as
backward) against the JAX package, in f32 on the CPU, tiny configs on 4
ranks of one gloo group: Qwen2.5-3B, Gemma2-2B, Mamba2-1.3B, Zamba2-1.2B,
Qwen2-MoE-A2.7B and Kimi-K2 (sequence-sharded residual, Adafactor over the
layer stacks) on the meshes (1, 4), (2, 2) and (4, 1), and cases whose
HBM budget (a ``TPUPodSpec`` with less HBM, the same on both sides)
forces the planner into ZeRO (moments sharded over ``data``) or FSDP.

Compared over ``TRAIN_STEPS`` steps of ``TRAIN_B`` x 512 (one CE chunk,
so the chunked CE's rematerialised collectives run; 64 for the SSM
families, ``_partition_ref.py`` ``train_seq``): the first
loss within 1e-5 and every step's loss and gradient norm within 1e-4, the
first batch's gradient leaves, reduced as the step reduces them and
gathered whole, within 1e-4 of each leaf's max |g| (the limits
``test_torch_train_models.py`` holds the one-device step to); after each
update, every rank holding the same window of a leaf holds the same
bytes.  The oracles: GSPMD keeps the semantics, so dense, SSM and hybrid
cases are held against the reference's jitted ``train_step`` on one
device; MoE on a data axis of 2 or 4 routes each data shard's tokens with
that shard's capacity, so those cases, and the ZeRO/FSDP ones, are held
against the reference's partitioned jit (``in_shardings`` from its own
plan) run on 4 host devices in a process of its own
(``tests/_partition_ref.py train``), whose plan must make the same
choices.  The ranks run every case under a guard that raises on a
functional collective recording a gradient outside the port's autograd
functions (``tests/_partition_ranks.py`` ``BareCollectives``): once
DTensor is imported PyTorch backpropagates those as the identity, with
no warning, so a collective without its explicit backward fails the
case."""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.api import build_model as j_build_model
from repro.optim.optimizers import make_optimizer as j_make_optimizer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.hw.template import TPUPodSpec
from repro_torch.launch import partition as pt
from repro_torch.launch.mesh import Mesh, fake_group
from repro_torch.launch.train import tiny_config as t_tiny_config

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from _partition_ref import (TRAIN_B, TRAIN_STEPS,  # noqa: E402
                            train_batch, train_config, train_seq)
from test_torch_train_models import _reference_leaf  # noqa: E402

ARCHS = ["qwen2.5-3b", "gemma2-2b", "mamba2-1.3b", "zamba2-1.2b",
         "qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
MESHES = [(1, 4), (2, 2), (4, 1)]
#: (name, arch, optimizer override, mesh, what the HBM budget forces)
FORCED = [("kimi-fsdp", "kimi-k2-1t-a32b", None, (2, 2), "fsdp"),
          ("zamba2-fsdp", "zamba2-1.2b", None, (2, 2), "fsdp"),
          ("qwen2-moe-zero", "qwen2-moe-a2.7b", None, (2, 2), "zero"),
          ("qwen2.5-adafactor-zero", "qwen2.5-3b", "adafactor", (2, 2),
           "zero")]
CASES = [f"{a}-{m[0]}x{m[1]}" for a in ARCHS for m in MESHES] + \
    [f[0] for f in FORCED]
LOSS_TOL, LEAF_TOL, STEPS_TOL = 1e-5, 1e-4, 1e-4
AXES = ("data", "model")


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def budget(cfg, mesh, what):
    """An HBM budget at which the port's planner picks ``what`` (``fsdp``,
    or ``zero`` without FSDP) for the train cases on ``mesh``: between
    the least at which such a candidate fits and the least at which the
    next one up does (geometric mean), where the reference's planner,
    which shards its stacked layer dim as well, picks it too."""
    shape = ShapeConfig("case", train_seq(cfg), TRAIN_B, "train")

    def plan(hbm):
        return pt.plan_for(cfg, shape, Mesh(mesh, AXES), torch.float32,
                           pod=dataclasses.replace(TPUPodSpec(),
                                                   hbm_bytes=hbm))

    def least(fits):
        lo, hi = 1.0, 1e12
        while hi / lo > 1.0001:
            mid = (lo * hi) ** 0.5
            lo, hi = (lo, mid) if fits(plan(mid)) else (mid, hi)
        return hi
    if what == "fsdp":
        low, up = least(lambda p: p.valid), least(lambda p: not p.fsdp)
    else:
        low = least(lambda p: p.valid and not p.fsdp)
        up = least(lambda p: not p.zero_opt)
    hbm = (low * up) ** 0.5
    got = plan(hbm)
    assert got.valid and got.zero_opt and got.fsdp == (what == "fsdp")
    return hbm


def _one_device(cfg, batches):
    """The reference's jitted ``train_step`` on one device: each step's
    loss and gradient norm, and the first batch's gradients."""
    japi = j_build_model(cfg, dtype=jnp.float32)
    params = japi.init(jax.random.PRNGKey(0))
    jopt = j_make_optimizer(cfg.optimizer, lr=1e-3)
    state = jopt.init(params)
    step = jax.jit(j_build_train_step(japi, jopt))
    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        japi.loss_fn))(params, batches[0]))
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "grads": grads}


def _partitioned(out, cases):
    """The reference's partitioned runs of ``cases``, from its npz."""
    ref = np.load(out)
    got = {}
    for case in cases:
        name = case["name"]
        tree = {}
        for k in ref.files:
            if k.startswith(f"{name}/grad/"):
                node = tree
                *path, leaf = k[len(f"{name}/grad/"):].split("/")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = ref[k]
        got[name] = {
            "loss": [float(ref[f"{name}/loss/{i}"])
                     for i in range(TRAIN_STEPS)],
            "grad_norm": [float(ref[f"{name}/grad_norm/{i}"])
                          for i in range(TRAIN_STEPS)],
            "grads": tree, "plan": tuple(bool(x)
                                         for x in ref[f"{name}/plan"])}
    return got


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case run once: the ranks in their processes and the
    reference's partitioned runs in another, the one-device references
    here meanwhile."""
    cases, part, trees, batches = [], [], {}, {}
    for arch in ARCHS + [f[1] for f in FORCED]:
        for opt in {None} | {f[2] for f in FORCED if f[1] == arch}:
            if (arch, opt) in trees:
                continue
            cfg = train_config(arch, opt)
            trees[(arch, opt)] = jax.tree_util.tree_map(
                np.asarray, j_build_model(cfg, dtype=jnp.float32).init(
                    jax.random.PRNGKey(0)))
            batches[(arch, opt)] = [train_batch(cfg, i)
                                    for i in range(TRAIN_STEPS)]
    specs = [(f"{a}-{m[0]}x{m[1]}", a, None, m, None)
             for a in ARCHS for m in MESHES]
    for name, arch, opt, mesh, what in FORCED:
        cfg = t_tiny_config(t_get_config(arch))
        if opt:
            cfg = dataclasses.replace(cfg, optimizer=opt)
        specs.append((name, arch, opt, mesh, budget(cfg, mesh, what)))
    for name, arch, opt, mesh, hbm in specs:
        cases.append({"name": name, "arch": arch, "optimizer": opt,
                      "mesh": mesh, "hbm": hbm,
                      "tree": trees[(arch, opt)],
                      "batches": batches[(arch, opt)]})
        if hbm is not None or (get_family(arch) == "moe" and mesh[0] > 1):
            part.append({"name": name, "arch": arch, "optimizer": opt,
                         "mesh": mesh, "hbm": hbm})
    tmp = tmp_path_factory.mktemp("train")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    halves = (part[0::2], part[1::2])       # two processes of the reference
    with ThreadPoolExecutor(1 + len(halves)) as pool:
        ranks = pool.submit(run_ranks_train, cases)
        refs = []
        for i, half in enumerate(halves):
            (tmp / f"cases{i}.json").write_text(json.dumps(half))
            refs.append(pool.submit(subprocess.run, [
                sys.executable, str(HERE / "_partition_ref.py"), "train",
                str(tmp / f"ref{i}.npz"), "--devices", "4", "--cases",
                str(tmp / f"cases{i}.json")], check=True, env=env,
                timeout=900))
        one = {}
        for arch in ARCHS:
            cfg = train_config(arch)
            one[arch] = _one_device(cfg, [
                {k: jnp.asarray(v) for k, v in b.items()}
                for b in batches[(arch, None)]])
        got = ranks.result()
        for r in refs:
            r.result()
    wants = {}
    for i, half in enumerate(halves):
        wants.update(_partitioned(tmp / f"ref{i}.npz", half))
    for name, arch, opt, mesh, hbm in specs:
        if name not in wants:
            wants[name] = one[arch]
    return {name: (arch, opt, wants[name], got[name])
            for name, arch, opt, mesh, hbm in specs}


def get_family(arch):
    return t_get_config(arch).family


def run_ranks_train(cases):
    return pt.run_ranks(f"{HERE / '_partition_ranks.py'}:train_cases", 4,
                        "gloo", {"cases": cases}, timeout=900)[0]


@pytest.mark.parametrize("case", CASES)
def test_losses_and_grad_norms_match_reference(results, case):
    _, _, want, got = results[case]
    assert _rel(got["loss"][0], want["loss"][0]) <= LOSS_TOL
    for i in range(TRAIN_STEPS):
        assert _rel(got["loss"][i], want["loss"][i]) <= STEPS_TOL, i
        assert _rel(got["grad_norm"][i], want["grad_norm"][i]) <= \
            STEPS_TOL, i


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_matches_reference(results, case):
    arch, opt, want, got = results[case]
    cfg = train_config(arch, opt)
    assert sum(g.size for g in got["grads"].values()) == sum(
        x.size for x in jax.tree_util.tree_leaves(want["grads"]))
    for name, g in got["grads"].items():
        ref = _reference_leaf(cfg, want["grads"], name)
        assert g.shape == ref.shape, name
        err = float(np.abs(g - ref).max())
        assert err <= LEAF_TOL * float(np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("case", CASES)
def test_ranks_holding_a_window_hold_equal_parameters(results, case):
    """After each update the data ranks' copies of a data-replicated leaf
    (and the model ranks' of a model-replicated one) are equal bit for
    bit: ZeRO's all-gathered windows included."""
    assert results[case][3]["equal"] == [True] * TRAIN_STEPS


@pytest.mark.parametrize("case", [f[0] for f in FORCED])
def test_budget_forces_the_same_plan_on_both_sides(results, case):
    _, _, want, got = results[case]
    what = next(f[4] for f in FORCED if f[0] == case)
    assert got["plan"] == want["plan"]
    assert got["plan"][0] and got["plan"][2] == (what == "fsdp")


def test_a_bare_collective_under_autograd_fails():
    """The ranks' guard: a ``_c10d_functional`` collective that records a
    gradient (which, DTensor imported, PyTorch backpropagates as the
    identity) raises; the port's collectives, which record none inside
    their autograd functions, pass, forward and backward."""
    import torch.distributed as dist
    from repro_torch.models.shards import all_gather
    from _partition_ranks import BareCollectives
    with fake_group(2), BareCollectives():
        x = torch.ones(4, requires_grad=True)
        all_gather(x * 1, 0, dist.group.WORLD).sum().backward()
        assert x.grad is not None
        c = torch.ops._c10d_functional
        with pytest.raises(RuntimeError, match="outside the port"):
            c.all_reduce(x * 1, "sum", dist.group.WORLD.group_name)
