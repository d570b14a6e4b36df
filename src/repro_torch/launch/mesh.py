"""Production mesh shapes, without devices or a process group.

The port of ``repro/launch/mesh.py``.  A ``Mesh`` here is the shape the
sharding planner and the dry-run read: ``.shape`` (axis -> size, as
``jax.sharding.Mesh.shape`` is), ``.axis_names`` and ``.devices``, a numpy
object array of the mesh's shape holding ``torch.device``s, or ``None``
where the mesh is shape-only.  The production meshes keep the reference's
TPU-pod shapes, 16 x 16 as (data, model) and 2 x 16 x 16 as (pod, data,
model), since the dry-run's cells are defined by them; on DGX H100 nodes
of 8 GPUs a model axis of 16 spans two NVLink domains.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

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


__all__ = ["Mesh", "make_local_mesh", "make_production_mesh"]
