"""One rank's view of a partitioned model: its place in the device mesh,
the local shards of its parameters and cache, and the collectives the
partitioned program issues.

The reference partitions its serving programs with GSPMD (``jax.jit``
with the sharding plan's ``in_shardings``) and runs its routed experts
inside ``shard_map``.  PyTorch has no SPMD partitioner for an eager
program, so the port writes the partitioned program out, as the
reference's ``shard_map`` body is written: with a ``Shards`` every model
function runs on one rank's local shards and issues the collectives GSPMD
would insert.  The parameters, the inputs and the cache are
``torch.distributed.tensor`` DTensors at the plan's placements
(``launch/partition.py``); the program reads their local shards and works
out from the shards' shapes what each rank holds:

* a projection whose output dim is sharded over ``model`` (``wq``,
  ``wi``) gives local heads or columns; its row-sharded partner (``wo``)
  gives a partial sum, finished by one all-reduce over ``model`` (or a
  reduce-scatter, where the residual is sequence-sharded);
* a leaf sharded over the data axes as well (FSDP, ZeRO) is gathered over
  them where it is used, so only one block's gathered weights are live;
* a cache leaf's local window (``Layout``) says which batch rows, KV
  heads and positions this rank keeps.

Every collective goes through ``all_reduce``, ``enter``, ``all_gather``
and ``reduce_scatter`` here: the ``_c10d_functional`` ops, waited on at
once, over the process group of one mesh axis; over an axis of size 1
nothing is issued, so a 1 x 1 mesh runs exactly the one-card program.
Each is a ``torch.autograd.Function`` with its transpose as its backward
(the functional ops have no usable autograd formula): the all-reduce
that finishes partial sums passes its gradient unchanged; ``enter``, the
identity, all-reduces its gradient, and stands wherever a tensor every
``model`` rank holds alike feeds that rank's own share of the work (a
block's input to its column-sharded projections, a replicated weight
read by local heads or experts, the gated norm's variance, the final
hidden state before the vocabulary-sharded head); the all-gather and the
reduce-scatter are each other's backward, and ``local``'s gather over the
data axes (FSDP) reduce-scatters a leaf's gradient over them.  A ``gloo``
group moves host memory, so a CUDA tensor is copied to the host for its
collectives and back (gloo's own CUDA all-gather faults in PyTorch 2.11);
NCCL and the dry-run's ``fake`` group take the tensor where it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch


def _c10d():
    return torch.ops._c10d_functional


def _collective(fn, t: torch.Tensor, group) -> torch.Tensor:
    """``fn(t, group name)``, waited on; through the host for a CUDA
    tensor on a ``gloo`` group.  The two host copies are not the step's
    work: they run outside any dispatch mode, so an ``OpCounter`` counts
    the collective alone, as on ``meta`` under the ``fake`` group."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes
    c = _c10d()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        with _disable_current_modes():
            host = t.cpu()
        out = c.wait_tensor(fn(host, group.group_name))
        with _disable_current_modes():
            return out.to(t.device)
    return c.wait_tensor(fn(t, group.group_name))


def _one(group) -> bool:
    return group is None or group.size() == 1


def _all_reduce(t, group, op="sum"):
    return _collective(lambda x, g: _c10d().all_reduce(x, op, g),
                       t.contiguous(), group)


def _all_gather(t, dim, group):
    n = group.size()
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    out = _collective(
        lambda x, g: _c10d().all_gather_into_tensor(x, n, g), src, group)
    return out.movedim(0, dim)


def _reduce_scatter(t, dim, group):
    n = group.size()
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    out = _collective(
        lambda x, g: _c10d().reduce_scatter_tensor(x, "sum", n, g), src,
        group)
    return out.movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    """The sum over the group; its gradient passes unchanged: the sum is
    used alike on every rank, so each rank's gradient of it is whole."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity; its gradient is summed over the group: a tensor every
    rank holds alike feeds this rank's own share of the work, so each
    rank's gradient of it is a part."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The ranks' chunks concatenated; the gradient is reduce-scattered,
    the all-gather's transpose."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the group, each rank keeping its chunk; the gradient
    is all-gathered, the reduce-scatter's transpose."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``sum``, ``max``) over ``group``'s ranks.  The sum's
    gradient passes unchanged (``_AllReduce``); the max has none."""
    if _one(group):
        return t
    if op == "sum":
        return _AllReduce.apply(t, group)
    return _all_reduce(t.detach(), group, op)


def enter(t: torch.Tensor, group) -> torch.Tensor:
    """``t``, a tensor every rank of ``group`` holds alike, as the input
    of this rank's share of the work: the identity, whose gradient is
    summed over the group (``_Enter``)."""
    if _one(group) or not (t.requires_grad and torch.is_grad_enabled()):
        return t
    return _Enter.apply(t, group)


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order; the
    gradient is reduce-scattered."""
    if _one(group):
        return t
    return _AllGather.apply(t, dim, group)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, each keeping its chunk of
    ``dim`` (rank order); the gradient is all-gathered."""
    if _one(group):
        return t
    return _ReduceScatter.apply(t, dim, group)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The local window of one sharded tensor: per dim, the global offset
    of this rank's shard, its local size, and the mesh axes that shard
    the dim (outermost first)."""
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    axes: Tuple[Tuple[str, ...], ...]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class Shards:
    """This rank's place in ``mesh`` (a ``DeviceMesh`` with named axes,
    ``data``, ``model`` and optionally ``pod``) and the collectives over
    its axes."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_names: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.size: Dict[str, int] = {a: mesh.size(i) for i, a
                                     in enumerate(self.axis_names)}
        self.coord: Dict[str, int] = {a: mesh.get_local_rank(a)
                                      for a in self.axis_names}
        self.groups = {a: mesh.get_group(a) for a in self.axis_names}
        self.tp = self.size.get("model", 1)
        self.model_rank = self.coord.get("model", 0)

    @property
    def model(self):
        """The model axis's process group (None without one)."""
        return self.groups.get("model")

    # ---- collectives over named axes --------------------------------------
    def all_reduce(self, t: torch.Tensor, axes: Sequence[str] = ("model",),
                   op: str = "sum") -> torch.Tensor:
        for a in axes:
            t = all_reduce(t, self.groups.get(a), op)
        return t

    def all_gather(self, t: torch.Tensor, dim: int,
                   axes: Sequence[str] = ("model",)) -> torch.Tensor:
        """Gather ``dim`` sharded over ``axes`` (outermost first): the
        innermost axis is gathered first, so the chunks land in the
        order a multi-axis ``Shard`` lays them out."""
        for a in reversed(tuple(axes)):
            t = all_gather(t, dim, self.groups.get(a))
        return t

    def enter(self, t: torch.Tensor, axes: Sequence[str] = ("model",)
              ) -> torch.Tensor:
        """``t``, held alike on every rank of ``axes``, where it feeds
        this rank's own share of the work (``enter``): its gradient is
        summed over ``axes``."""
        for a in axes:
            t = enter(t, self.groups.get(a))
        return t

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The mesh's data axes (``pod``, ``data``), outermost first."""
        return tuple(a for a in self.axis_names if a != "model")

    def reduce_scatter(self, t: torch.Tensor, dim: int,
                       axes: Sequence[str] = ("model",)) -> torch.Tensor:
        """``t`` summed over ``axes``, each rank keeping its chunk of
        ``dim`` as a multi-axis ``Shard`` lays it out (outermost first)."""
        for a in axes:
            t = reduce_scatter(t, dim, self.groups.get(a))
        return t

    def finish(self, out: torch.Tensor, partial: bool,
               seq: bool = False) -> torch.Tensor:
        """A block's output: ``partial`` sums (a row-sharded projection)
        summed over ``model``; with ``seq`` (a sequence-sharded residual,
        Megatron-SP) each rank keeps its chunk of the sequence (dim 1),
        by a reduce-scatter where the sums are partial.  A whole ``out``
        under ``seq`` was computed from the all-gathered input, whose
        gradient is already reduce-scattered, so its chunk is a plain
        slice."""
        if seq:
            if partial:
                return reduce_scatter(out, 1, self.model)
            return self._chunk(out)
        return all_reduce(out, self.model) if partial else out

    def seq_chunk(self, h: torch.Tensor) -> torch.Tensor:
        """This model rank's chunk of the sequence (dim 1) of ``h``, a
        tensor every model rank holds alike: the chunk's gradient, this
        rank's alone, enters ``h``'s summed over ``model``."""
        return self._chunk(self.enter(h))

    def _chunk(self, h: torch.Tensor) -> torch.Tensor:
        n = h.shape[1] // self.tp
        return h[:, self.model_rank * n:(self.model_rank + 1) * n]

    def seq_sharded(self, cfg, seq_len: int) -> bool:
        """The reference's ``_seq_shard`` condition: Kimi-K2 keeps its
        residual sequence-sharded over ``model`` between blocks where the
        sequence divides the axis."""
        return bool(cfg.seq_shard) and self.tp > 1 \
            and seq_len % self.tp == 0

    def wrap(self, local: torch.Tensor, shape: Sequence[int],
             axes: Sequence[Sequence[str]]):
        """The DTensor of global ``shape`` whose dim ``i`` is sharded over
        ``axes[i]`` (outermost first) and whose shard here is ``local``."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        placements = [Replicate() for _ in self.axis_names]
        for dim, ax in enumerate(axes):
            for a in ax:
                placements[self.axis_names.index(a)] = Shard(dim)
        stride, acc = [], 1
        for n in reversed(tuple(shape)):
            stride.append(acc)
            acc *= n
        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(reversed(stride)))

    # ---- local shards ------------------------------------------------------
    def layout(self, t) -> Layout:
        """The local window of DTensor ``t``."""
        return self.window(tuple(t.shape), t.placements)

    def window(self, shape: Sequence[int], placements) -> Layout:
        """This rank's window of a tensor of global ``shape`` at
        ``placements`` (one per mesh axis): a dim sharded over several axes
        is split over them outermost first, as ``Shard`` lays it out.
        Every sharded dim must divide evenly (the plan never pads)."""
        shape = tuple(shape)
        axes = [[] for _ in shape]
        for a, pl in zip(self.axis_names, placements):
            if pl.is_shard():
                axes[pl.dim % len(shape)].append(a)
        offsets, sizes = [], []
        for n, ax in zip(shape, axes):
            parts = math.prod(self.size[a] for a in ax)
            if n % parts:
                raise ValueError(f"dim of {n} does not divide over {ax}")
            size = n // parts
            index = 0
            for a in ax:                     # outermost axis first
                index = index * self.size[a] + self.coord[a]
            offsets.append(index * size)
            sizes.append(size)
        return Layout(tuple(offsets), tuple(sizes),
                      tuple(tuple(a) for a in axes))

    def shard(self, full: torch.Tensor, placements):
        """The DTensor at ``placements`` of ``full``, a tensor every rank
        holds whole: this rank keeps a copy of its window (no collective);
        ``full`` can be freed."""
        lay = self.window(tuple(full.shape), placements)
        idx = tuple(slice(o, o + n) for o, n in zip(lay.offsets, lay.sizes))
        split = any(self.size[a] > 1 for ax in lay.axes for a in ax)
        local = full[idx].clone() if split else full
        return self.wrap(local, tuple(full.shape), lay.axes)

    def full(self, t) -> torch.Tensor:
        """The whole of DTensor ``t`` on every rank, gathered over each
        sharded dim's axes with this module's collectives."""
        x = t.to_local()
        for dim, ax in enumerate(self.layout(t).axes):
            if ax:
                x = self.all_gather(x, dim, ax)
        return x

    def local(self, t) -> torch.Tensor:
        """The local shard of DTensor ``t``, gathered over the data axes
        where it is sharded over them (FSDP, ZeRO): what the program
        computes with keeps only the ``model`` sharding.  A plain tensor
        passes through."""
        if not is_dtensor(t):
            return t
        x = t.to_local()
        lay = self.layout(t)
        for dim, ax in enumerate(lay.axes):
            data = tuple(a for a in ax if a != "model")
            if data:                # the plan never shards a dim over both
                x = self.all_gather(x, dim, data)
        return x

    def local_tree(self, tree) -> Any:
        """``local`` over a block's tree (a ``Block``, a mapping)."""
        if isinstance(tree, Mapping) or hasattr(tree, "_names"):
            names = tree._names if hasattr(tree, "_names") else tuple(tree)
            return {k: self.local_tree(tree[k]) for k in names}
        if isinstance(tree, torch.nn.ParameterDict):
            return {k: self.local(v) for k, v in tree.items()}
        return self.local(tree)

    def model_offset(self, local: int, full: int) -> int:
        """The global offset of this rank's chunk of a dim of ``full``
        entries held as ``local`` ones (0 where it is not sharded)."""
        return 0 if local == full else self.model_rank * local


def local_share(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                sh: Optional["Shards"], sharded: bool, seq: bool,
                whole: Sequence[str] = ()):
    """(p, x) as one rank's share of a block's work (``Shards.enter``).
    A sharded block's input enters it (``seq``: it is all-gathered
    already, and the gather's backward sums its gradient), and so does
    each leaf of ``whole`` (the leaves the plan keeps whole, which the
    local heads or experts read); an unsharded block under ``seq`` reads
    the gathered input too, so every leaf enters it.  Elsewhere every
    rank runs the whole block alike and nothing enters."""
    if sh is None or not (sharded or seq):
        return p, x
    if not seq:
        x = sh.enter(x)
    return {k: sh.enter(v) if k in whole or not sharded else v
            for k, v in p.items()}, x


def heads_for(k: torch.Tensor, H: int, KV: int, h0: int, n: int
              ) -> torch.Tensor:
    """The KV heads (dim 1 of ``k``, all ``KV`` of them) that query heads
    ``h0 .. h0+n-1`` of ``H`` read, as a GQA operand for those ``n`` heads:
    a slice where the local query heads fall on whole KV heads (or within
    one), else one KV head per query head.  The global query head ``h``
    reads KV head ``h // (H // KV)``; a rank's local heads are not heads
    0.. of the model."""
    if n == H:
        return k
    qpk = H // KV
    if n <= qpk and qpk % n == 0 and h0 // qpk == (h0 + n - 1) // qpk:
        j = h0 // qpk
        return k[:, j:j + 1]
    if n % qpk == 0 and h0 % qpk == 0:
        return k[:, h0 // qpk:(h0 + n) // qpk]
    idx = torch.arange(h0, h0 + n, device=k.device) // qpk
    return k.index_select(1, idx)


__all__ = ["Layout", "Shards", "all_gather", "all_reduce", "enter",
           "heads_for", "local_share", "reduce_scatter"]
