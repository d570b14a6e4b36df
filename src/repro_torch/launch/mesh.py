"""Production mesh shapes, and device meshes over a process group.

The port of ``repro/launch/mesh.py``.  A ``Mesh`` here is the shape the
sharding planner and the dry-run read: ``.shape`` (axis -> size, as
``jax.sharding.Mesh.shape`` is), ``.axis_names`` and ``.devices``, a numpy
object array of the mesh's shape holding ``torch.device``s, or ``None``
where the mesh is shape-only.  The production meshes keep the reference's
TPU-pod shapes, 16 x 16 as (data, model) and 2 x 16 x 16 as (pod, data,
model), since the dry-run's cells are defined by them; on DGX H100 nodes
of 8 GPUs a model axis of 16 spans two NVLink domains.

``device_mesh`` gives the ``torch.distributed`` ``DeviceMesh`` of a
``Mesh``'s shape and axis names over the current process group: the mesh
a partitioned program runs on (``launch/partition.py``).  ``fake_group``
opens a process group of any size whose collectives move nothing
(PyTorch's ``fake`` backend): the dry-run traces one rank of a 256- or
512-chip mesh under it on ``meta``.  ``make_local_mesh``, the reference's
1 x 1 mesh, keeps its meaning.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np


class Mesh:
    """A named device mesh: ``shape`` maps each axis to its size, in
    ``axis_names`` order; ``devices`` holds a ``torch.device`` (or
    ``None``) per mesh position."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        n = math.prod(self.shape.values())
        flat = [None] * n if devices is None else list(devices)
        if len(flat) != n:
            raise ValueError(f"{len(flat)} devices for a mesh of {n}")
        self.devices = np.empty(n, dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(tuple(shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16 x 16 (data, model) mesh, or with ``multi_pod``
    the 2 x 16 x 16 (pod, data, model) one, shape-only."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_local_mesh(axes: Sequence[str] = ("data", "model"),
                    device=None) -> Mesh:
    """A 1 x ... x 1 mesh over one device: the card unless ``device``
    says otherwise (``"cpu"``, ``"meta"``)."""
    from ..kernels.backend import resolve_device
    return Mesh((1,) * len(axes), axes, [resolve_device(device)])


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``mesh``'s shape and axis names over the
    current process group, whose size must be the mesh's.  Under NCCL the
    group must be bound to a card (``init_process_group(device_id=...)``,
    as ``launch/partition.py`` ``run_ranks`` binds it) and that card must
    be the current device: this raises rather than let the mesh pick one
    from the rank's number."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{mesh.size} ranks; have "
            f"{dist.get_world_size() if dist.is_initialized() else 'none'}")
    if dist.get_backend() == "nccl":
        import torch
        bound = dist.distributed_c10d._get_default_group().bound_device_id
        current = torch.cuda.current_device()
        if bound is None or bound.index != current:
            raise RuntimeError(
                f"rank {dist.get_rank()}: the NCCL group is bound to "
                f"{bound}, the current device is cuda:{current}; bind the "
                f"group to the rank's card and set it current first")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """A process group of ``world_size`` ranks on PyTorch's ``fake``
    backend, this process rank ``rank``: collectives return at once and
    move nothing, so one rank's program can be traced (on ``meta``) as
    it would run in the group.  The group is destroyed on exit, also on
    failure, so none outlives the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already open")
    hook = sys.excepthook      # init wraps it in a "[rank0]: " prefixer
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


__all__ = ["Mesh", "device_mesh", "fake_group", "make_local_mesh",
           "make_production_mesh"]
