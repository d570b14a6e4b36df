"""Roofline constants of one NVIDIA H100 SXM, for the sharding planner and
the dry-run's roofline.

``H100Spec`` carries the field names of the JAX package's ``TPUPodSpec``
(``hw/template.py``) that ``core/autoshard.py`` and ``launch/roofline.py``
read, so either spec can be passed to both; shared memory per SM takes the
place of ``vmem_bytes``.  Every port caller defaults to ``H100Spec()``.
The mesh's ``ici_*`` names keep the reference's spelling: on an H100 they
are NVLink's figures, and ``dci_bw`` is the network between DGX nodes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class H100Spec:
    """One H100 SXM5 80GB at its full 700 W power limit."""

    name: str = "h100_sxm"
    #: bf16 on the tensor cores, dense (no sparsity): 989 TFLOP/s (NVIDIA
    #: H100 Tensor Core GPU data sheet, SXM column)
    peak_flops_bf16: float = 989e12
    #: HBM3: 3.35 TB/s (data sheet, SXM)
    hbm_bw: float = 3.35e12
    #: HBM3: 80 GB (data sheet, SXM)
    hbm_bytes: float = 80e9
    #: NVLink 4: 900 GB/s per GPU over 18 links (data sheet, SXM), counting
    #: both directions; so 25 GB/s per link in each direction.  The
    #: planner and the roofline divide the bytes one chip sends by
    #: ``ici_link_bw * ici_links_per_chip``, one direction's rate (450 GB/s)
    ici_link_bw: float = 25e9
    ici_links_per_chip: int = 18
    #: between DGX H100 nodes: one 400 Gb/s ConnectX-7 port per GPU (NVIDIA
    #: DGX H100 data sheet: 8 single-port ConnectX-7 for the compute
    #: fabric), 50 GB/s per GPU in each direction
    dci_bw: float = 50e9
    #: shared memory per SM: 228 KB, of which a block may take 227 KB
    #: (NVIDIA Hopper tuning guide); the counterpart of ``vmem_bytes``
    smem_bytes_per_sm: float = 228 * 1024
