"""Execute ``KernelPlan``s through hand-written CUDA kernels.

The port of ``repro/lower/exec.py``.  One kernel per layer family (fc,
conv, pool, eltwise, attention), in ``csrc/lower_kernels.cu``, each
parameterized by the plan: the plan's grid axes that index the output become
the CUDA grid (a plan output tile may span several CUDA blocks), and the
grid axes that do not (the reduction, ``C``) become a loop inside the block,
walked in the plan's order, each C tile accumulated into the output (for
attention: into the online softmax's ``(acc, m, l)``, kept in registers).
fc instead splits each C tile across blocks (``fc_launch``) and adds the
parts in the plan's order in a second kernel.  So every loop order the
solver picks runs, including the reduction-outermost orders that compiled
Pallas refuses (``repro/lower/exec.py:45-60``).

Beside each kernel sits its plain PyTorch version, which walks ``plan.grid``
in order and accumulates into output blocks exactly as the Pallas kernel
does: the port's counterpart of interpret mode.  A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises.  ``LAUNCHES`` counts kernel launches per family; a launch
captured into a CUDA graph (``fuse.py``) counts at each replay.

Every tensor keeps the reference's shape ([N, C, X, Y] for activations).
conv and pool read and write channels-last memory (``to_channels_last``),
which the network executor keeps between kernels; their wrappers take
row-major inputs too and convert them, and ``LAUNCHES["layout"]`` counts
the conversions.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import time
from typing import Callable, Dict, Iterator, List, Mapping, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from ..kernels import backend, ref
from .plan import KernelPlan

#: kernel launches per family since the last ``reset_launch_counts()``
#: (``attention`` counts both attention paths, ``attention_mma`` the
#: tensor-core one; ``conv`` counts ``conv_kernel_wgmma``, ``conv_weights``
#: the weight layout before it), and ``layout``: the activations copied
#: between row-major [N, C, X, Y] and channels-last memory
#: (``to_channels_last``, ``to_reference_layout``)
LAUNCHES: Dict[str, int] = {"fc": 0, "conv": 0, "conv_weights": 0,
                            "pool": 0, "eltwise": 0, "attention": 0,
                            "attention_mma": 0, "layout": 0}

#: the TPU kernel each CUDA kernel replaces (file:line of its definition)
REPLACES = {"fc": "src/repro/lower/exec.py:88",
            "conv": "src/repro/lower/exec.py:118",
            "pool": "src/repro/lower/exec.py:179",
            "eltwise": "src/repro/lower/exec.py:230",
            "attention": "src/repro/lower/exec.py:257"}

SOURCE = "src/repro_torch/csrc/lower_kernels.cu"
NEG_INF = -1e30
#: operands one eltwise launch adds; ``eltwise_chain`` chains launches for
#: more
ELTWISE_MAX_OPS = 8
#: the most elements an array of one conv launch may hold (the kernel's
#: launch arguments are 32-bit); ``conv_batch_parts`` splits the batch
#: under it
CONV_MAX_ELEMS = (1 << 31) - 1
#: rows of a conv consumer warpgroup's wgmma tile (its M side)
CONV_ROWS = 64
#: the wgmma widths (N of m64nNk8) ``conv_kernel_wgmma`` is built at
CONV_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128)
#: channels a conv step stages: one 128-byte row of floats
CONV_PIECE = 32
CONV_STAGES = 8                 # the most stages of the conv kernel's ring
#: the most dynamic shared memory a block may opt into (227 KB)
CONV_SMEM_MAX = 232448
#: TMA's limits: elements a box spans along a dimension, and the stride it
#: traverses one at
CONV_BOX_MAX = 256
CONV_STRIDE_MAX = 8
#: the H100's SMs, and the blocks an SM runs in turn that the conv launch
#: leaves at least, where it groups sub-tiles into blocks
SMS = 132
CONV_WAVES = 4
#: the most channels of an input the conv kernel reads folded
#: (``conv_folds``): one 16-byte unit a tap
CONV_FOLD_C = 4
#: the bits of a float32 that TF32 keeps (sign, exponent, 10 of mantissa)
TF32_MASK = -8192               # 0xffffe000 as an int32
FC_TILE = 64                    # widest fc output sub-tile side
FC_SLAB = 32                    # C depth of one staged fc slab
#: blocks ``fc_launch`` aims the C split at: two for each of the H100's
#: 132 SMs
FC_TARGET_BLOCKS = 2 * 132
#: the most the fc C split's float32 workspace may take
FC_WORKSPACE_CAP = 64 << 20
ATTN_TILE = 64                  # query rows per CUDA block, keys per stage
#: the attention kernel's path by head dim: ``mma-3xtf32``
#: (``attention_mma_kernel``, the tensor cores in 3xTF32) where its tiles
#: fit, else ``fma`` (``attention_kernel``, the FMA tile of
#: ``online_softmax.cuh``): at D = 256 its Q and 64-key K/V ring would take
#: 333 KB of shared memory (227 KB a block) and O half a thread's registers
ATTN_PATHS = {16: "mma-3xtf32", 32: "mma-3xtf32", 64: "mma-3xtf32",
              128: "mma-3xtf32", 256: "fma"}
ATTN_HEAD_DIMS = tuple(ATTN_PATHS)

_INPUT_NAMES = {"fc": ("I", "W"), "conv": ("I", "W"), "pool": ("I",),
                "eltwise": ("A", "B"), "attention": ("Q", "K", "V")}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_kind(plan: KernelPlan) -> None:
    if plan.kind not in _INPUT_NAMES:
        raise ValueError(f"unsupported kind {plan.kind!r}")


# ---------------------------------------------------------------------------
# grid walking (the plain versions) and tensor checks (the wrappers)
# ---------------------------------------------------------------------------

def _walk(plan: KernelPlan) -> Iterator[Dict[str, int]]:
    """Grid coordinates per dim, in the plan's (lexicographic) order."""
    dims = [ax.dim for ax in plan.grid]
    for idx in itertools.product(*(range(ax.steps) for ax in plan.grid)):
        yield dict(zip(dims, idx))


def _blk(plan: KernelPlan, g: Mapping[str, int], d: str) -> slice:
    b = plan.block[d]
    i = g.get(d, 0)
    return slice(i * b, (i + 1) * b)


def _check_reduction(plan: KernelPlan) -> None:
    """The kernels loop the reduction inside the block over C tiles only."""
    rel = plan.layer.tensors["O"]
    if {ax.dim for ax in plan.grid if ax.dim not in rel} - {"C"}:
        raise ValueError(f"{plan.describe()}: only C may be a reduction "
                         f"grid axis of a {plan.kind} plan")


def _check(t: torch.Tensor, shape: Tuple[int, ...], what: str,
           device: torch.device, layout: bool = False) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not (t.is_contiguous() or layout and channel_pitch(t) is not None):
        raise ValueError(f"{what}: must be contiguous" + (
            " or channels-last" if layout else ""))


def _cuda_or_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def _params(values: Sequence[int]):
    return (ctypes.c_int64 * len(values))(*[int(v) for v in values])


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# fc
# ---------------------------------------------------------------------------

def plain_fc(plan: KernelPlan, x: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """``O[N,K] = I[N,C] @ W[C,K]`` walked over the plan's grid; C-tile
    revisits accumulate into the output block."""
    ref.full_fp32(x)
    L = plan.layer
    out = torch.zeros((L.dim("N"), L.dim("K")), dtype=torch.float32,
                      device=x.device)
    for g in _walk(plan):
        n, c, k = (_blk(plan, g, d) for d in "NCK")
        out[n, k] += x[n, c] @ w[c, k]
    return out


def _sub_width(block: int) -> int:
    """Width of the output sub-tiles of a plan tile ``block`` wide: the
    widest multiple of 8 up to ``FC_TILE`` that divides it, else the
    multiple of 8 that cuts it into the fewest sub-tiles (the last short)."""
    for w in range(min(FC_TILE, block) // 8 * 8, 0, -8):
        if block % w == 0:
            return w
    return 8 * _ceil(_ceil(block, _ceil(block, FC_TILE)), 8)


@dataclasses.dataclass(frozen=True)
class FcLaunch:
    """Geometry of one ``kapla_fc`` call (``csrc/lower_kernels.cu``
    ``fc_kernel``).  Block ``(x, y, z)`` owns K sub-tile ``x`` and N
    sub-tile ``y`` (``sub_tile``) and part ``z`` of C (``part_range``): a
    slice of whole ``FC_SLAB``-deep slabs of one plan C tile, or, where a
    workspace would pass ``FC_WORKSPACE_CAP``, every C tile in plan order
    (one part).  With more than one part each block writes its partial
    product to a float32 workspace ``[n_parts, N, K]`` and a second kernel
    adds the slices of each C tile, then the C tiles in plan order."""

    N: int
    C: int
    K: int
    bn: int
    bc: int
    bk: int
    tn: int         # sub-tile rows
    tk: int         # sub-tile columns
    sub_n: int      # sub-tiles per plan tile along N
    sub_k: int      # ... along K
    c_tiles: int
    group: int      # C tiles per part: 1, or all of them past the cap
    slices: int     # parts per C tile (1 when group > 1)
    slabs: int      # slabs per C tile
    vec: bool       # 16-byte copies (C, K and the tiles multiples of 4)

    @property
    def n_parts(self) -> int:
        return 1 if self.group > 1 else self.c_tiles * self.slices

    @property
    def grid(self) -> Tuple[int, int, int]:
        return ((self.K // self.bk) * self.sub_k,
                (self.N // self.bn) * self.sub_n, self.n_parts)

    @property
    def workspace_bytes(self) -> int:
        return 4 * self.n_parts * self.N * self.K if self.n_parts > 1 else 0

    def sub_tile(self, axis: str, g: int) -> Tuple[int, int]:
        """(start, extent) of sub-tile ``g`` along ``axis`` ("N" or "K"),
        as the kernel's ``sub_tile`` computes it."""
        block, tile, sub = ((self.bn, self.tn, self.sub_n) if axis == "N"
                            else (self.bk, self.tk, self.sub_k))
        start = (g // sub) * block + (g % sub) * tile
        return start, min(tile, (g // sub + 1) * block - start)

    def part_range(self, part: int) -> List[Tuple[int, int, int]]:
        """(C tile, c0, c1) of each C range part ``part`` walks, in order."""
        if self.group == 1:
            t, j = divmod(part, self.slices)
            lo = j * self.slabs // self.slices
            hi = (j + 1) * self.slabs // self.slices
            return [(t, t * self.bc + lo * FC_SLAB,
                     min(t * self.bc + hi * FC_SLAB, (t + 1) * self.bc))]
        return [(t, t * self.bc, (t + 1) * self.bc)
                for t in range(self.c_tiles)]

    def params(self, vec: bool) -> List[int]:
        """``kapla_fc``'s parameter array; ``vec`` is ``self.vec`` and the
        16-byte alignment of the operands."""
        return [self.N, self.C, self.K, self.bn, self.bc, self.bk, self.tn,
                self.tk, self.sub_n, self.sub_k, self.c_tiles, self.group,
                self.slices, self.slabs, int(vec), self.n_parts, *self.grid]


def fc_launch(plan: KernelPlan) -> FcLaunch:
    """The geometry of ``kapla_fc`` for ``plan``: sub-tiles that cover each
    plan tile once, and each C tile split into as many slices as keep the
    grid within ``FC_TARGET_BLOCKS`` blocks (an SM with a third block takes
    half as long again as one with two) and the workspace within
    ``FC_WORKSPACE_CAP`` bytes.  Where even one part per C tile would pass
    the cap, one part walks every C tile and writes the output itself."""
    _check_reduction(plan)
    L, b = plan.layer, plan.block
    launch = _fc_launch(L.dim("N"), L.dim("C"), L.dim("K"), b["N"], b["C"],
                        b["K"], FC_WORKSPACE_CAP)
    if max(launch.grid[1:]) > 65535:
        raise ValueError(f"{plan.describe()}: fc grid {launch.grid} too "
                         "large")
    return launch


@functools.lru_cache(maxsize=None)
def _fc_launch(N: int, C: int, K: int, bn: int, bc: int, bk: int,
               workspace_cap: int) -> FcLaunch:
    tn, tk = _sub_width(bn), _sub_width(bk)
    sub_n, sub_k = _ceil(bn, tn), _ceil(bk, tk)
    c_tiles, slabs = C // bc, _ceil(bc, FC_SLAB)
    out_blocks = (N // bn) * sub_n * (K // bk) * sub_k
    part_bytes = 4 * N * K
    slices = min(slabs, FC_TARGET_BLOCKS // (out_blocks * c_tiles),
                 workspace_cap // (c_tiles * part_bytes))
    slices = max(1, slices)
    group = 1
    if slices == 1 and c_tiles > 1 and c_tiles * part_bytes > workspace_cap:
        group = c_tiles
    vec = all(v % 4 == 0 for v in (C, K, bc, bk))
    return FcLaunch(N, C, K, bn, bc, bk, tn, tk, sub_n, sub_k, c_tiles,
                    group, slices, slabs, vec)


@functools.lru_cache(maxsize=None)
def _fc_params(launch: FcLaunch, vec: bool):
    """``kapla_fc``'s parameter array (built once per geometry: the C side
    only reads it)."""
    return _params(launch.params(vec))


def run_fc(plan: KernelPlan, x: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """fc wrapper: the CUDA kernel on the card, ``plain_fc`` on the CPU."""
    L = plan.layer
    N, C, K = L.dim("N"), L.dim("C"), L.dim("K")
    _check(x, (N, C), "fc input I[N,C]", x.device)
    _check(w, (C, K), "fc weight W[C,K]", x.device)
    if not _cuda_or_cpu(x, "fc"):
        return plain_fc(plan, x, w)
    launch = fc_launch(plan)
    vec = launch.vec and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    out = torch.empty((N, K), dtype=torch.float32, device=x.device)
    ws = torch.empty((launch.n_parts, N, K), dtype=torch.float32,
                     device=x.device) if launch.n_parts > 1 else None
    with torch.cuda.device(x.device):
        lib = backend.library()
        backend.check_launch("kapla_fc", lib.kapla_fc(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), _fc_params(launch, vec),
            backend.stream_handle(x.device)))
    backend.count_launch(LAUNCHES, "fc")
    return out


# ---------------------------------------------------------------------------
# activation layout: channels-last inside the network tiers
# ---------------------------------------------------------------------------

def _cl_strides(shape: Sequence[int], pitch: int) -> Tuple[int, ...]:
    """Strides of a [N, C, X, Y] tensor held as [N, X, Y, pitch]."""
    _, _, X, Y = shape
    return (X * Y * pitch, 1, Y * pitch, pitch)


def _strides_match(t: torch.Tensor, want: Sequence[int]) -> bool:
    """``t``'s strides are ``want`` on every dim longer than 1."""
    return all(n == 1 or s == w for n, s, w in zip(t.shape, t.stride(), want))


def channel_pitch(t: torch.Tensor) -> Optional[int]:
    """The channel pitch of a 4-D tensor held channels-last (``[N, X, Y,
    pitch]`` with its channels first in each row), or None when it is not
    held so."""
    if t.dim() != 4:
        return None
    N, C, X, Y = t.shape
    pitch = t.stride(3) if Y > 1 else t.stride(2) if X > 1 else C
    if pitch < C or not _strides_match(t, _cl_strides(t.shape, pitch)):
        return None
    return pitch


def _channels_inner(t: torch.Tensor) -> bool:
    """Whether ``t``'s channels are innermost in memory (channels-last, or a
    view of it such as a crop), where that differs from [N, C, X, Y] memory
    (more than one channel and more than one position)."""
    return t.shape[1] > 1 and t.shape[2] * t.shape[3] > 1 \
        and t.stride(1) == 1


def channels_last_zeros(shape: Sequence[int], pitch: Optional[int] = None,
                        device=None) -> torch.Tensor:
    """Float32 zeros of ``shape`` ([N, C, X, Y]) held as [N, X, Y, pitch]
    (default C)."""
    N, C, X, Y = shape
    cp = C if pitch is None else pitch
    return torch.zeros((N, X, Y, cp), dtype=torch.float32,
                       device=device).permute(0, 3, 1, 2)[:, :C]


def to_channels_last(t: torch.Tensor,
                     pitch: Optional[int] = None) -> torch.Tensor:
    """``t`` ([N, C, X, Y]) held channels-last at channel pitch ``pitch``
    (default C; padding channels zero): ``t`` itself when it already is,
    else a copy.  A copy of a tensor that was not channels-last is a layout
    conversion and counts in ``LAUNCHES["layout"]``."""
    cp = t.shape[1] if pitch is None else pitch
    if channel_pitch(t) == cp:
        return t
    out = channels_last_zeros(t.shape, cp, t.device)
    out.copy_(t)
    if not _channels_inner(t) and _channels_inner(out):
        backend.count_launch(LAUNCHES, "layout")
    return out


def to_reference_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` in [N, C, X, Y] (row-major) memory, for a reshape in the
    reference's element order: ``t`` itself when it already is, else a copy,
    which counts in ``LAUNCHES["layout"]`` where the layouts differ."""
    if t.is_contiguous():
        return t
    if t.dim() == 4 and _channels_inner(t):
        backend.count_launch(LAUNCHES, "layout")
    return t.contiguous()


def _cl_copy(t: torch.Tensor) -> torch.Tensor:
    """A plain version's [N, C, X, Y] result in the kernels' channels-last
    memory (the plain versions emulate the kernels' layout: no count)."""
    return t.contiguous(memory_format=torch.channels_last)


def conv_pitch(C: int) -> int:
    """The channel pitch the conv kernel reads its input at: C rounded up to
    a multiple of 4 (TMA takes rows of whole 16-byte units)."""
    return -(-C // 4) * 4


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

def plain_conv(plan: KernelPlan, x: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Direct VALID conv walked over the plan's grid: per step, the halo'd
    window of the (ix, iy) block, one channel contraction per (r, s) into
    the ``[bn, bk, bx, by]`` tile, added to the output block.  Takes ``x``
    in either memory layout; returns [N, K, X, Y] in row-major memory."""
    ref.full_fp32(x)
    x = x.contiguous()
    L, b = plan.layer, plan.block
    R, S, st = (int(L.meta[k]) for k in ("R", "S", "stride"))
    bx, by = b["X"], b["Y"]
    out = torch.zeros((L.dim("N"), L.dim("K"), L.dim("X"), L.dim("Y")),
                      dtype=torch.float32, device=x.device)
    for g in _walk(plan):
        n, c, k, ox, oy = (_blk(plan, g, d) for d in "NCKXY")
        x0, y0 = g.get("X", 0) * bx * st, g.get("Y", 0) * by * st
        xw = x[n, c, x0:x0 + (bx - 1) * st + R, y0:y0 + (by - 1) * st + S]
        acc = torch.zeros((b["N"], b["K"], bx, by), dtype=torch.float32,
                          device=x.device)
        for r in range(R):
            for s in range(S):
                patch = xw[:, :, r:r + (bx - 1) * st + 1:st,
                           s:s + (by - 1) * st + 1:st]
                acc += torch.einsum("ncxy,kc->nkxy", patch, w[k, c, r, s])
        out[n, k, ox, oy] += acc
    return out


def _even(block: int, tile: int) -> int:
    """The sub-tile width that cuts ``block`` into as many pieces as
    ``tile`` does, balanced (the last piece at most one short of the
    others' share)."""
    return _ceil(block, _ceil(block, tile))


def conv_width(n: int) -> int:
    """The wgmma width (``CONV_WIDTHS``) an N side of ``n`` runs at."""
    return next(w for w in CONV_WIDTHS if w >= n)


@dataclasses.dataclass(frozen=True)
class ConvLaunch:
    """Geometry of one ``kapla_conv`` call (``csrc/lower_kernels.cu``
    ``conv_kernel_wgmma<nw>``, an implicit GEMM on wgmma in 3xTF32 over
    channels-last activations).  A plan tile is cut into output sub-tiles
    (``sub_tile``), each a box of ``tn`` images x ``tx`` rows x ``ty`` cols
    of positions by ``tk`` channels.  Block ``(x, y, z)`` owns plan tile
    (X/Y ``x``, K ``y``, N ``z // groups``) and walks ``group`` of its
    sub-tiles in turn (``block_subtiles``), the ring running on from one
    to the next, so a sub-tile's stores overlap the next one's loads.
    ``pos_m``: the positions are wgmma's 64-row M side (``cw``
    consumer warpgroups of 64 rows) and the channels its N side, ``nw``
    wide; else the channels are M and the positions N.  The reduction walks
    ``steps()``: the plan's C tiles in order, each in pieces of
    ``CONV_PIECE`` channels by the R x S taps, one ring stage a step.  The
    dims are those the kernel runs: for a folded input (``conv_folds``) C
    is 4 S, YI is XO's columns, S is 1 and ``sy`` 1, ``fold`` the layer's
    S."""

    N: int
    C: int
    K: int
    XI: int
    YI: int
    XO: int
    YO: int
    R: int
    S: int
    stride: int
    sy: int         # the y stride (1 for a folded input)
    bn: int
    bc: int
    bk: int
    bx: int
    by: int
    tn: int
    tx: int
    ty: int
    tk: int
    pos_m: bool
    cw: int         # consumer warpgroups
    nw: int         # wgmma width (N side)
    stages: int     # ring stages
    fold: int = 0   # the layer's S folded into the channels (0: none)
    group: int = 1  # sub-tiles a block walks

    @property
    def sub(self) -> Dict[str, int]:
        """Sub-tiles per plan tile along each axis."""
        return {d: _ceil(b, t) for d, b, t in
                (("N", self.bn, self.tn), ("K", self.bk, self.tk),
                 ("X", self.bx, self.tx), ("Y", self.by, self.ty))}

    @property
    def subs(self) -> int:
        """Sub-tiles per plan tile."""
        return int(np.prod(list(self.sub.values())))

    @property
    def groups(self) -> int:
        """Blocks per plan tile."""
        return _ceil(self.subs, self.group)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return ((self.XO // self.bx) * (self.YO // self.by),
                self.K // self.bk, (self.N // self.bn) * self.groups)

    def block_subtiles(self, x: int, y: int, z: int
                       ) -> List[Tuple[Tuple[int, int], ...]]:
        """The sub-tiles block (x, y, z) walks, in order, each as (start,
        extent) along N, K, X and Y: the K sub-tiles fastest, then Y, X and
        N (the kernel's ``conv_subtile``)."""
        sub = self.sub
        py = self.YO // self.by
        plan = {"N": z // self.groups, "K": y, "X": x // py, "Y": x % py}
        first = (z % self.groups) * self.group
        out = []
        for u in range(first, min(self.subs, first + self.group)):
            idx = {}
            for d in "KYXN":
                idx[d] = u % sub[d]
                u //= sub[d]
            out.append(tuple(self.sub_tile(d, plan[d] * sub[d] + idx[d])
                             for d in "NKXY"))
        return out

    @property
    def cp(self) -> int:
        """The input's channel pitch."""
        return conv_pitch(self.C)

    @property
    def box(self) -> int:
        """Positions of the block's box (rows of its activation tile)."""
        return self.tn * self.tx * self.ty

    @property
    def xrows(self) -> int:
        """Rows of a stage's activation tile."""
        return CONV_ROWS * self.cw if self.pos_m else self.nw

    @property
    def wrows(self) -> int:
        """Rows (output channels) of a stage's weight tile."""
        return self.nw if self.pos_m else CONV_ROWS * self.cw

    @property
    def bcp(self) -> int:
        """Row of a C tile in the laid-out weights (``conv_bcp``)."""
        return conv_bcp(self.bc)

    @property
    def vec(self) -> bool:
        """8-byte output stores: every pair of channels starts 8-byte
        aligned."""
        return self.K % 2 == 0 and self.bk % 2 == 0 and self.tk % 2 == 0

    @property
    def x_box(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """The activation tile's TMA box over [N, XI, YI, cp] (dims and
        element strides, innermost first)."""
        st, sy = self.stride, self.sy
        return ((CONV_PIECE, self.ty * sy, self.tx * st, self.tn),
                (1, sy, st, 1))

    @property
    def w_box(self) -> Tuple[int, ...]:
        """The weight tiles' TMA box over [K, T, R*S, bcp]."""
        return (CONV_PIECE, 1, 1, self.wrows)

    @property
    def stage_bytes(self) -> int:
        """A stage: the activation tile, split into hi and lo, and the
        weights' hi and lo tiles, 128-byte rows."""
        return 2 * 128 * (self.xrows + self.wrows)

    @property
    def smem(self) -> int:
        """Dynamic shared memory: 1024-byte alignment, the ring and three
        mbarriers a stage."""
        return 1024 + self.stages * (self.stage_bytes + 3 * 8)

    def sub_tile(self, axis: str, g: int) -> Tuple[int, int]:
        """(start, extent) of sub-tile ``g`` along ``axis`` (N, K, X or
        Y), as the kernel's ``sub_tile`` computes it."""
        block, tile = {"N": (self.bn, self.tn), "K": (self.bk, self.tk),
                       "X": (self.bx, self.tx),
                       "Y": (self.by, self.ty)}[axis]
        sub = self.sub[axis]
        start = (g // sub) * block + (g % sub) * tile
        return start, min(tile, (g // sub + 1) * block - start)

    def steps(self) -> List[Tuple[int, int, int, int, int]]:
        """(C tile, piece, tap r*S + s, box channel, k8 steps) of each
        step, in the kernel's order (``conv_step``): a tile's pieces start
        at its first channel rounded down to a multiple of 4, and the k8
        steps are those that hold channels of the tile (0: none)."""
        out = []
        for t in range(self.C // self.bc):
            sh = t * self.bc % 4
            for j in range(_ceil(self.bcp, CONV_PIECE)):
                held = max(0, min(CONV_PIECE,
                                  sh + self.bc - j * CONV_PIECE))
                for rs in range(self.R * self.S):
                    out.append((t, j, rs,
                                t * self.bc - sh + j * CONV_PIECE,
                                _ceil(held, 8)))
        return out

    def params(self) -> List[int]:
        """``kapla_conv``'s parameter array."""
        sub = self.sub
        return [self.N, self.C, self.K, self.XO, self.YO, self.R, self.S,
                self.stride, self.sy, self.bn, self.bc, self.bk, self.bx,
                self.by, self.tn, self.tx, self.ty, self.tk, sub["N"],
                sub["K"], sub["X"], sub["Y"], int(self.pos_m), self.cw,
                self.xrows, self.wrows, self.stages, self.bcp,
                int(self.vec), self.group, self.groups, self.XI, self.YI,
                self.cp, self.C // self.bc, *self.grid, self.smem, self.nw]


def _conv_box(bn: int, bx: int, by: int, bm: int, st: int,
              sy: int) -> Tuple[int, int, int]:
    """The (images, rows, cols) box of at most ``bm`` positions that cuts
    a plan tile into the fewest sub-tiles, whole rows of the tile first,
    within TMA's 256-element box (rows and cols traversed at the
    strides)."""
    ty = _even(by, min(by, bm, CONV_BOX_MAX // sy))
    tx = _even(bx, min(bx, bm // ty, CONV_BOX_MAX // st))
    tn = _even(bn, min(bn, bm // (tx * ty), CONV_BOX_MAX))
    return tn, tx, ty


def conv_batch_parts(plan: KernelPlan, XI: int,
                     YI: int) -> List[Tuple[int, int]]:
    """The images ``[n0, n1)`` of each ``kapla_conv`` launch: the batch cut
    at multiples of the plan's N block so that each launch's input and
    output hold at most ``CONV_MAX_ELEMS`` elements (one part when the
    whole batch does)."""
    L, bn = plan.layer, plan.block["N"]
    N = L.dim("N")
    C, XI, YI = conv_kernel_dims(plan, XI, YI)[:3]
    per_image = max(conv_pitch(C) * XI * YI,
                    L.dim("K") * L.dim("X") * L.dim("Y"))
    step = CONV_MAX_ELEMS // per_image // bn * bn
    if step == 0:
        raise ValueError(f"{plan.describe()}: one N block of {bn} images "
                         f"holds {bn * per_image} elements; the kernel's "
                         "launch arguments are 32-bit")
    return [(n0, min(N, n0 + step)) for n0 in range(0, N, step)]


def conv_launch(plan: KernelPlan, XI: int, YI: int,
                batch: Optional[int] = None) -> ConvLaunch:
    """The geometry of ``kapla_conv`` for ``plan`` (over ``batch`` images
    of it, a multiple of its N block, where ``conv_batch_parts`` splits the
    batch; by default all of them).  A plan tile of 64 positions or more
    puts them on wgmma's M side: boxes of up to 128 positions over two
    consumer warpgroups (64 and one, under 128 positions), the channels in
    sub-tiles of up to 128; a smaller tile puts its output channels on the
    M side (sub-tiles of up to 128, two warpgroups past 64) and its
    positions, whole, on the N side.  Sub-tiles cover each plan tile once;
    as many ring stages as fit, up to ``CONV_STAGES``."""
    _check_reduction(plan)
    L, b = plan.layer, plan.block
    N, K, XO, YO = (L.dim(d) for d in "NKXY")
    N = N if batch is None else batch
    C, XI, YI, R, S, st, sy, bc, fold = conv_kernel_dims(plan, XI, YI)
    if N % b["N"] or max(N * conv_pitch(C) * XI * YI,
                         N * K * XO * YO) > CONV_MAX_ELEMS:
        raise ValueError(f"{plan.describe()}: a launch of {N} images; the "
                         "kernel takes whole N blocks and arrays of at most "
                         f"{CONV_MAX_ELEMS} elements (conv_batch_parts)")
    if not 1 <= st <= CONV_STRIDE_MAX:
        raise ValueError(f"{plan.describe()}: stride {st}; TMA traverses "
                         f"at most {CONV_STRIDE_MAX}")
    launch = _conv_launch(N, C, K, XI, YI, XO, YO, R, S, st, sy, b["N"],
                          bc, b["K"], b["X"], b["Y"], fold)
    if launch.grid[0] >= 1 << 31 or max(launch.grid[1:]) > 65535:
        raise ValueError(f"{plan.describe()}: conv grid {launch.grid} too "
                         "large")
    return launch


@functools.lru_cache(maxsize=None)
def _conv_launch(N, C, K, XI, YI, XO, YO, R, S, st, sy, bn, bc, bk, bx, by,
                 fold):
    P = bn * bx * by
    pos_m = P >= CONV_ROWS
    if pos_m:
        cw = 2 if P >= 2 * CONV_ROWS else 1
        tn, tx, ty = _conv_box(bn, bx, by, CONV_ROWS * cw, st, sy)
        tk = _even(bk, min(bk, CONV_WIDTHS[-1]))
        nw = conv_width(tk)
    else:
        tn, tx, ty = _conv_box(bn, bx, by, P, st, sy)
        tk = _even(bk, min(bk, 2 * CONV_ROWS))
        cw = 2 if tk > CONV_ROWS else 1
        nw = conv_width(tn * tx * ty)
    base = ConvLaunch(N, C, K, XI, YI, XO, YO, R, S, st, sy, bn, bc, bk, bx,
                      by, tn, tx, ty, tk, pos_m, cw, nw, 1, fold)
    stages = min(CONV_STAGES,
                 (CONV_SMEM_MAX - 1024 - 24 * CONV_STAGES)
                 // base.stage_bytes)
    # as many sub-tiles a block as leave CONV_WAVES blocks an SM, in
    # groups of equal size
    tiles = (XO // bx) * (YO // by) * (K // bk) * (N // bn)
    group = max(1, min(base.subs,
                       tiles * base.subs // (CONV_WAVES * SMS)))
    group = _ceil(base.subs, _ceil(base.subs, group))
    return dataclasses.replace(base, stages=stages, group=group)


@functools.lru_cache(maxsize=None)
def _conv_params(launch: ConvLaunch):
    """``kapla_conv``'s parameter array (built once per geometry)."""
    return _params(launch.params())


def conv_bcp(bc: int) -> int:
    """The row of one C tile of ``bc`` channels in the laid-out weights:
    the tile's channels from ``t*bc mod 4`` (where its pieces start) and
    zeros around them, to a multiple of 4."""
    return conv_pitch(bc + (3 if bc % 4 else 0))


def conv_folds(plan: KernelPlan) -> bool:
    """Whether the conv kernel reads ``plan``'s input folded: at most
    ``CONV_FOLD_C`` channels in one C tile (the images), each position's
    row of S taps laid out as its channels (``conv_input``)."""
    C = plan.layer.dim("C")
    return C <= CONV_FOLD_C and plan.block["C"] == C


def conv_kernel_dims(plan: KernelPlan, XI: int, YI: int
                     ) -> Tuple[int, int, int, int, int, int, int, int, int]:
    """(C, XI, YI, R, S, x stride, y stride, C tile, folded S) of the
    layer as the conv kernel runs it: the layer's own, or, folded, 4 S
    channels over XO's columns at the y stride, one tap along y."""
    L = plan.layer
    R, S, st = (int(L.meta[k]) for k in ("R", "S", "stride"))
    if conv_folds(plan):
        C = CONV_FOLD_C * S
        return C, XI, L.dim("Y"), R, 1, st, 1, C, S
    return L.dim("C"), XI, YI, R, S, st, st, plan.block["C"], 0


def conv_input_shape(plan: KernelPlan) -> Tuple[int, int, int, int]:
    """The shape of ``conv_input``'s result: [N, C, XI, YI], or, folded,
    [N, 4 S, XI, YO]."""
    L = plan.layer
    XI, YI = input_extent(L)
    C, XI, YI = conv_kernel_dims(plan, XI, YI)[:3]
    return (L.dim("N"), C, XI, YI)


def _unfold(plan: KernelPlan, xf: torch.Tensor) -> torch.Tensor:
    """A folded input back as [N, C, XI, YI] (the columns no window reads
    zero), for the plain version."""
    L = plan.layer
    C, S, st = L.dim("C"), int(L.meta["S"]), int(L.meta["stride"])
    N, _, XI, YO = xf.shape
    x = torch.zeros((N, C) + input_extent(L), dtype=xf.dtype,
                    device=xf.device)
    taps = xf.reshape(N, S, CONV_FOLD_C, XI, YO)[:, :, :C]
    for s in range(S):
        x[:, :, :, s:s + (YO - 1) * st + 1:st] = taps[:, s]
    return x


def conv_input(plan: KernelPlan, x: torch.Tensor) -> torch.Tensor:
    """``x`` [N, C, XI, YI] as ``conv_kernel_wgmma`` reads it: channels-last
    at ``conv_pitch`` (as it is where it already is), or, where the input
    folds (``conv_folds``), [N, 4 S, XI, YO] held channels-last with
    channel 4 s + c of column y = x[:, c, :, y * stride + s] (zeros for c
    >= C), an im2col along Y.  A copy that changes the layout counts in
    ``LAUNCHES["layout"]``."""
    L = plan.layer
    C = L.dim("C")
    if not conv_folds(plan):
        cp = channel_pitch(x)
        return x if cp is not None and cp % 4 == 0 \
            else to_channels_last(x, conv_pitch(C))
    S, st = int(L.meta["S"]), int(L.meta["stride"])
    N, _, XI, _ = x.shape
    YO = L.dim("Y")
    buf = torch.zeros((N, XI, YO, S, CONV_FOLD_C), dtype=torch.float32,
                      device=x.device)
    buf[..., :C] = x.unfold(3, S, st).permute(0, 2, 3, 4, 1)
    backend.count_launch(LAUNCHES, "layout")
    return buf.reshape(N, XI, YO, CONV_FOLD_C * S).permute(0, 3, 1, 2)


def conv_weight_layout(plan: KernelPlan, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``conv_kernel_weights``' function: W [K, C, R, S] as hi and lo
    [K, T, RS, bcp] for the dims the kernel runs (``conv_kernel_dims``;
    ``bcp = conv_bcp(bc)``): C tile t's channels at [sh, sh + bc) of each
    tap's row with sh = t*bc mod 4, zeros around them; folded, tap r's row
    holds W[k, c, r, s] at 4 s + c.  hi the leading 19 bits, lo = W - hi."""
    K, C, R, S = w.shape
    Cv, _, _, Rv, Sv, _, _, bc, fold = conv_kernel_dims(plan, 1, 1)
    T, bcp = Cv // bc, conv_bcp(bc)
    laid = torch.zeros((K, T, Rv * Sv, bcp), dtype=torch.float32,
                       device=w.device)
    if fold:
        per_tap = torch.zeros((K, R, S, CONV_FOLD_C), device=w.device)
        per_tap[..., :C] = w.permute(0, 2, 3, 1)
        laid[:, 0, :, :CONV_FOLD_C * S] = per_tap.reshape(K, R, -1)
    else:
        tiles = w.reshape(K, T, bc, R * S).transpose(2, 3)
        for t in range(T):
            sh = t * bc % 4
            laid[:, t, :, sh:sh + bc] = tiles[:, t]
    hi = (laid.view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, laid - hi


def run_conv(plan: KernelPlan, x: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """conv wrapper: the CUDA kernel on the card, ``plain_conv`` on the
    CPU.  ``x`` [N, C, XI, YI] holds exactly the halo'd input extent, in
    either memory layout: channels-last (the network executor's, at a
    channel pitch that is a multiple of 4) goes to the kernel as it is,
    row-major is converted first, and an input that folds is folded
    (``conv_input``), unless it comes folded (``conv_input_shape``).  The
    result is [N, K, X, Y] in channels-last memory.
    On the card ``conv_kernel_weights`` lays the weights out for the
    kernel, then ``conv_kernel_wgmma`` runs once a batch part
    (``conv_batch_parts``)."""
    L = plan.layer
    N, C, K = L.dim("N"), L.dim("C"), L.dim("K")
    R, S = int(L.meta["R"]), int(L.meta["S"])
    XI, YI = input_extent(L)
    folded = conv_folds(plan) and tuple(x.shape) == conv_input_shape(plan)
    _check(x, conv_input_shape(plan) if folded else (N, C, XI, YI),
           "conv input I[N,C,XI,YI]", x.device, layout=True)
    _check(w, (K, C, R, S), "conv weight W[K,C,R,S]", x.device)
    if not _cuda_or_cpu(x, "conv"):
        return _cl_copy(plain_conv(plan, _unfold(plan, x) if folded else x,
                                   w))
    if not folded:
        x = conv_input(plan, x)
    Cv, _, _, Rv, Sv, _, _, bc, fold = conv_kernel_dims(plan, XI, YI)
    T, bcp = Cv // bc, conv_bcp(bc)
    out = torch.empty((N, K, L.dim("X"), L.dim("Y")), dtype=torch.float32,
                      device=x.device, memory_format=torch.channels_last)
    hi = torch.empty((K, T, Rv * Sv, bcp), dtype=torch.float32,
                     device=x.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(x.device):
        lib = backend.library()
        stream = backend.stream_handle(x.device)
        backend.check_launch("kapla_conv_weights", lib.kapla_conv_weights(
            w.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            _params([K, C, Rv * Sv, T, bc, bcp, fold]), stream))
        backend.count_launch(LAUNCHES, "conv_weights")
        for n0, n1 in conv_batch_parts(plan, XI, YI):
            launch = conv_launch(plan, XI, YI, n1 - n0)
            backend.check_launch("kapla_conv", lib.kapla_conv(
                x[n0:n1].data_ptr(), hi.data_ptr(), lo.data_ptr(),
                out[n0:n1].data_ptr(), _conv_params(launch), stream))
            backend.count_launch(LAUNCHES, "conv")
    return out


# ---------------------------------------------------------------------------
# pool (max; every grid axis indexes the output: single visit)
# ---------------------------------------------------------------------------

def plain_pool(plan: KernelPlan, x: torch.Tensor) -> torch.Tensor:
    """Max pool walked over the plan's grid, each block from ``NEG_INF``.
    Takes ``x`` in either memory layout; returns row-major memory."""
    x = x.contiguous()
    L, b = plan.layer, plan.block
    R, S, st = (int(L.meta[k]) for k in ("R", "S", "stride"))
    bx, by = b["X"], b["Y"]
    out = torch.empty((L.dim("N"), L.dim("C"), L.dim("X"), L.dim("Y")),
                      dtype=torch.float32, device=x.device)
    for g in _walk(plan):
        n, c, ox, oy = (_blk(plan, g, d) for d in "NCXY")
        x0, y0 = g.get("X", 0) * bx * st, g.get("Y", 0) * by * st
        xw = x[n, c, x0:x0 + (bx - 1) * st + R, y0:y0 + (by - 1) * st + S]
        acc = torch.full((b["N"], b["C"], bx, by), NEG_INF,
                         dtype=torch.float32, device=x.device)
        for r in range(R):
            for s in range(S):
                acc = torch.maximum(acc, xw[:, :, r:r + (bx - 1) * st + 1:st,
                                            s:s + (by - 1) * st + 1:st])
        out[n, c, ox, oy] = acc
    return out


def run_pool(plan: KernelPlan, x: torch.Tensor) -> torch.Tensor:
    """pool wrapper: the CUDA kernel on the card, ``plain_pool`` on the
    CPU.  ``x`` in either memory layout, as ``run_conv`` takes it (a
    row-major one is converted first); the result is channels-last."""
    L = plan.layer
    N, C, XO, YO = (L.dim(d) for d in "NCXY")
    XI, YI = input_extent(L)
    _check(x, (N, C, XI, YI), "pool input I[N,C,XI,YI]", x.device,
           layout=True)
    if not _cuda_or_cpu(x, "pool"):
        return _cl_copy(plain_pool(plan, x))
    cp = channel_pitch(x)
    if cp is None:
        x = to_channels_last(x)
        cp = C
    prm = _params([N, C, XI, YI, XO, YO, int(L.meta["R"]),
                   int(L.meta["S"]), int(L.meta["stride"]), cp])
    out = torch.empty((N, C, XO, YO), dtype=torch.float32, device=x.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        lib = backend.library()
        backend.check_launch("kapla_pool", lib.kapla_pool(
            x.data_ptr(), out.data_ptr(), prm,
            backend.stream_handle(x.device)))
    backend.count_launch(LAUNCHES, "pool")
    return out


# ---------------------------------------------------------------------------
# eltwise (n-ary sum; residual adds, gate merges, channel-embedded concat)
# ---------------------------------------------------------------------------

def plain_eltwise(plan: KernelPlan,
                  xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """n-ary sum walked over the plan's grid, operands added in order."""
    L = plan.layer
    out = torch.empty(tuple(L.dim(d) for d in "NCXY"), dtype=torch.float32,
                      device=xs[0].device)
    for g in _walk(plan):
        blk = tuple(_blk(plan, g, d) for d in "NCXY")
        acc = xs[0][blk].clone()
        for x in xs[1:]:
            acc = acc + x[blk]
        out[blk] = acc
    return out


def eltwise_chain(n_ops: int) -> List[range]:
    """The operands of each ``kapla_eltwise`` launch for ``n_ops``
    operands: the first ``ELTWISE_MAX_OPS``, then up to
    ``ELTWISE_MAX_OPS - 1`` more a launch, each launch after the first
    adding them to the running sum (its operand 0).  Operand order, and so
    every rounding, is that of one n-ary sum."""
    if n_ops < 1:
        raise ValueError(f"eltwise takes at least one operand, got {n_ops}")
    chain = [range(0, min(n_ops, ELTWISE_MAX_OPS))]
    while chain[-1].stop < n_ops:
        lo = chain[-1].stop
        chain.append(range(lo, min(n_ops, lo + ELTWISE_MAX_OPS - 1)))
    return chain


def run_eltwise(plan: KernelPlan,
                xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """eltwise wrapper (any number of operands): the CUDA kernel on the
    card (one launch per ``eltwise_chain`` step, ping-ponging the running
    sum so that no launch reads what it writes), ``plain_eltwise`` on the
    CPU.  Both add in operand order, so they agree bit for bit.  The
    operands share one memory layout, which the result keeps: channels-last
    where any operand is held so (the others converted), else row-major."""
    shape = tuple(plan.layer.dim(d) for d in "NCXY")
    chain = eltwise_chain(len(xs))
    for i, x in enumerate(xs):
        _check(x, shape, f"eltwise operand {i}", xs[0].device, layout=True)
    cl = any(not x.is_contiguous() for x in xs)
    xs = [to_channels_last(x) if cl else x for x in xs]
    if not _cuda_or_cpu(xs[0], "eltwise"):
        out = plain_eltwise(plan, xs)
        return _cl_copy(out) if cl else out
    dev = xs[0].device
    out = torch.empty(shape, dtype=torch.float32, device=dev,
                      memory_format=torch.channels_last if cl
                      else torch.contiguous_format)
    # the last launch writes out; the ones before alternate with tmp
    tmp = torch.empty_like(out) if len(chain) > 1 else None
    dsts = [out if (len(chain) - 1 - k) % 2 == 0 else tmp
            for k in range(len(chain))]
    with torch.cuda.device(dev):
        lib = backend.library()
        for k, ops in enumerate(chain):
            srcs = ([] if k == 0 else [dsts[k - 1]]) + [xs[i] for i in ops]
            vec = all(t.data_ptr() % 16 == 0 for t in (*srcs, dsts[k]))
            ptrs = (ctypes.c_void_p * len(srcs))(*[t.data_ptr()
                                                   for t in srcs])
            backend.check_launch("kapla_eltwise", lib.kapla_eltwise(
                ptrs, dsts[k].data_ptr(),
                _params([len(srcs), out.numel(), int(vec)]),
                backend.stream_handle(dev)))
            backend.count_launch(LAUNCHES, "eltwise")
    return out


# ---------------------------------------------------------------------------
# attention (non-causal, online softmax over the KV positions C)
# ---------------------------------------------------------------------------

def plain_attention(plan: KernelPlan, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``softmax(Q K^T * D^-1/2) V`` per head, walked over the plan's grid
    step for step as the Pallas kernel runs: ``(acc, m, l)`` buffers
    indexed like O, set on the first visit of an output block, updated by
    one online-softmax step per (N, X, C) tile, then ``acc / max(l,
    1e-30)``."""
    ref.full_fp32(q)
    L = plan.layer
    N, X, D = L.dim("N"), L.dim("X"), L.dim("K")
    scale = D ** -0.5
    rel = L.tensors["O"]
    acc = torch.empty((N, X, D), dtype=torch.float32, device=q.device)
    m = torch.empty((N, X), dtype=torch.float32, device=q.device)
    lsum = torch.empty((N, X), dtype=torch.float32, device=q.device)
    for g in _walk(plan):
        n, x, c = (_blk(plan, g, d) for d in "NXC")
        if all(g[d] == 0 for d in g if d not in rel):     # first visit
            acc[n, x] = 0.0
            m[n, x] = NEG_INF
            lsum[n, x] = 0.0
        s = torch.einsum("nqd,nkd->nqk", q[n, x], k[n, c]) * scale
        m_prev = m[n, x]
        m_cur = torch.maximum(m_prev, s.amax(dim=-1))
        alpha = torch.exp(m_prev - m_cur)
        p = torch.exp(s - m_cur[..., None])
        lsum[n, x] = lsum[n, x] * alpha + p.sum(dim=-1)
        m[n, x] = m_cur
        acc[n, x] = acc[n, x] * alpha[..., None] + \
            torch.einsum("nqk,nkd->nqd", p, v[n, c])
    return acc / lsum.clamp_min(1e-30)[..., None]


def attention_head_dim(D: int) -> int:
    """The instantiated head dim (``ATTN_HEAD_DIMS``) the attention kernel
    runs head dim ``D`` at: ``D`` itself or the next above it, to which the
    wrapper zero-pads Q, K and V; above the largest it raises."""
    if D < 1 or D > ATTN_HEAD_DIMS[-1]:
        raise ValueError(f"head dim {D}; the attention kernel takes 1.."
                         f"{ATTN_HEAD_DIMS[-1]}")
    return next(d for d in ATTN_HEAD_DIMS if d >= D)


def attention_launch(plan: KernelPlan) -> List[int]:
    """Parameters of ``kapla_attention``: dims (D the instantiated head dim
    of ``attention_head_dim``), the plan's X and C blocks, 64-row query
    sub-tiles per plan X tile, grid (query sub-tiles, heads), dynamic
    shared memory and the path (1: ``attention_mma_kernel``, Q and two
    stages of 64-key K and V tiles; 0: ``attention_kernel``, Q, K and V
    tiles of 64 rows; rows at a pitch of D + 4 floats)."""
    _check_reduction(plan)
    L, b = plan.layer, plan.block
    N, X, C = L.dim("N"), L.dim("X"), L.dim("C")
    try:
        D = attention_head_dim(L.dim("K"))
    except ValueError as e:
        raise ValueError(f"{plan.describe()}: {e}") from None
    mma = ATTN_PATHS[D] == "mma-3xtf32"
    if b["K"] != L.dim("K"):
        raise ValueError(f"{plan.describe()}: the head dim must be whole "
                         "in a block")
    sub_x = _ceil(b["X"], ATTN_TILE)
    grid = ((X // b["X"]) * sub_x, N)
    if grid[1] > 65535:
        raise ValueError(f"{plan.describe()}: attention grid {grid} too "
                         "large")
    rows = (1 + 2 * 2) * ATTN_TILE if mma else 3 * ATTN_TILE
    return [N, X, C, D, b["X"], b["C"], sub_x, *grid, 4 * rows * (D + 4),
            int(mma)]


def run_attention(plan: KernelPlan, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """attention wrapper: the CUDA kernel on the card, ``plain_attention``
    on the CPU.  Q ``[N,X,D]``, K and V ``[N,C,D]``, float32; a head dim
    outside ``ATTN_HEAD_DIMS`` runs zero-padded to ``attention_head_dim``
    at its own scale, the output sliced back to D."""
    L = plan.layer
    N, X, C, D = L.dim("N"), L.dim("X"), L.dim("C"), L.dim("K")
    _check(q, (N, X, D), "attention query Q[N,X,K]", q.device)
    _check(k, (N, C, D), "attention keys K[N,C,K]", q.device)
    _check(v, (N, C, D), "attention values V[N,C,K]", q.device)
    if not _cuda_or_cpu(q, "attention"):
        return plain_attention(plan, q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: Q, K and V must be 16-byte aligned "
                         "(the kernel loads float4)")
    launch = attention_launch(plan)
    Dk = launch[3]
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    prm = _params(launch)
    out = torch.empty((N, X, Dk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        lib = backend.library()
        backend.check_launch("kapla_attention", lib.kapla_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), prm,
            (ctypes.c_double * 1)(D ** -0.5),
            backend.stream_handle(q.device)))
    backend.count_launch(LAUNCHES, "attention")
    backend.count_launch(LAUNCHES, "attention_mma", launch[-1])
    return out if Dk == D else out[..., :D].contiguous()


# ---------------------------------------------------------------------------
# Public API: inputs, execution, verification, measurement
# ---------------------------------------------------------------------------

def input_extent(layer) -> Tuple[int, int]:
    """Minimal halo'd spatial input extent of a conv/pool layer under VALID
    padding: (X-1)*stride + R."""
    R, S = int(layer.meta["R"]), int(layer.meta["S"])
    stride = int(layer.meta["stride"])
    return ((layer.dim("X") - 1) * stride + R,
            (layer.dim("Y") - 1) * stride + S)


def input_shapes(plan: KernelPlan) -> Dict[str, Tuple[int, ...]]:
    """The plan's canonical input layouts (fc: I[N,C] W[C,K]; conv:
    I[N,C,XI,YI] W[K,C,R,S]; attention: Q[N,X,K] K/V[N,C,K]; pool:
    I[N,C,XI,YI]; eltwise: A/B [N,C,X,Y])."""
    _check_kind(plan)
    L = plan.layer
    if plan.kind == "fc":
        return {"I": (L.dim("N"), L.dim("C")), "W": (L.dim("C"), L.dim("K"))}
    if plan.kind == "attention":
        kv = (L.dim("N"), L.dim("C"), L.dim("K"))
        return {"Q": (L.dim("N"), L.dim("X"), L.dim("K")), "K": kv, "V": kv}
    if plan.kind == "eltwise":
        shape = tuple(L.dim(d) for d in "NCXY")
        return {"A": shape, "B": shape}
    XI, YI = input_extent(L)
    shapes = {"I": (L.dim("N"), L.dim("C"), XI, YI)}
    if plan.kind == "conv":
        shapes["W"] = (L.dim("K"), L.dim("C"), int(L.meta["R"]),
                       int(L.meta["S"]))
    return shapes


def as_tensor(v, device: torch.device) -> torch.Tensor:
    """A float32 contiguous tensor on ``device`` from a tensor or array."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
    return v.to(device=device, dtype=torch.float32).contiguous()


def _as_input(v, device: torch.device) -> torch.Tensor:
    """``as_tensor``, except that a float32 tensor on ``device`` held
    channels-last stays as it is (``kernel_inputs``)."""
    if isinstance(v, torch.Tensor) and v.device == device \
            and v.dtype == torch.float32 and channel_pitch(v) is not None:
        return v
    return as_tensor(v, device)


def kernel_inputs(plan: KernelPlan, inputs: Mapping,
                  device=None) -> Dict[str, torch.Tensor]:
    """The plan's inputs in the memory layout its kernel reads: a conv's or
    a pool's ``I`` channels-last (a conv's at ``conv_pitch``), the rest as
    given.  A caller that times a plan converts once with this, outside
    the calls it times."""
    dev = backend.resolve_device(device)
    out = {k: as_tensor(v, dev) for k, v in inputs.items()}
    if plan.kind == "conv" and not conv_folds(plan):
        out["I"] = conv_input(plan, out["I"])
    elif plan.kind == "pool":
        out["I"] = to_channels_last(out["I"])
    return out


def make_inputs(plan: KernelPlan, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Deterministic float32 inputs in the plan's canonical layouts, drawn
    with numpy's ``default_rng(seed)``; weights scaled by fan-in^-1/2,
    attention's Q, K and V unscaled."""
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(seed)
    L = plan.layer
    out = {}
    for name, shape in input_shapes(plan).items():
        a = rng.standard_normal(shape, dtype=np.float32)
        if name == "W":
            fan_in = int(np.prod(shape[1:])) if plan.kind == "conv" \
                else L.dim("C")
            a *= np.float32(fan_in ** -0.5)
        out[name] = torch.from_numpy(a).to(dev)
    return out


_RUN = {"fc": run_fc, "conv": run_conv, "pool": run_pool,
        "attention": run_attention}


def plan_runner(plan: KernelPlan, device=None,
                fused: bool = False) -> Callable[[Mapping], torch.Tensor]:
    """``inputs -> output`` for the plan on ``device`` (the card unless the
    caller passes ``"cpu"``); inputs may be tensors or numpy arrays.  With
    ``fused=True`` the plan's step (``fuse.compiled_plan_fn``) replays as a
    one-kernel CUDA graph on the card (``fuse.plan_graph_runner``); on the
    CPU it runs the same step through the plain version."""
    if not plan.valid:
        raise ValueError(
            f"cannot execute invalid plan for layer {plan.layer.name!r}: "
            f"{plan.invalid_reason}")
    _check_kind(plan)
    dev = backend.resolve_device(device)
    if fused:
        from .fuse import plan_graph_runner    # lazy: fuse imports netexec
        return plan_graph_runner(plan, dev)
    names = _INPUT_NAMES[plan.kind]
    if plan.kind == "eltwise":
        return lambda inputs: run_eltwise(
            plan, [as_tensor(inputs[n], dev) for n in names])
    fn = _RUN[plan.kind]
    return lambda inputs: fn(plan, *(_as_input(inputs[n], dev)
                                     for n in names))


def execute_plan(plan: KernelPlan, inputs: Optional[Mapping] = None,
                 device=None, seed: int = 0) -> torch.Tensor:
    """Run the plan and return the output."""
    run = plan_runner(plan, device)          # refuses invalid plans first
    inputs = inputs if inputs is not None else make_inputs(plan, seed,
                                                           device)
    return run(inputs)


def reference_output(plan: KernelPlan, inputs: Mapping) -> torch.Tensor:
    """Ground truth from ``kernels/ref.py`` for the plan's layer."""
    _check_kind(plan)
    L = plan.layer
    if plan.kind == "fc":
        return ref.matmul_ref(inputs["I"], inputs["W"])
    if plan.kind == "conv":
        return ref.conv2d_ref(inputs["I"], inputs["W"],
                              stride=int(L.meta["stride"]))
    if plan.kind == "attention":
        out = ref.attention_ref(inputs["Q"][:, None], inputs["K"][:, None],
                                inputs["V"][:, None], causal=False)
        return out[:, 0]
    if plan.kind == "pool":
        return ref.pool2d_ref(inputs["I"], int(L.meta["R"]),
                              int(L.meta["S"]), stride=int(L.meta["stride"]))
    return ref.eltwise_ref(inputs["A"], inputs["B"])


def rel_error(out, want) -> float:
    """max |out - want| / max |want| (float32), on ``want``'s device."""
    b = want if isinstance(want, torch.Tensor) else as_tensor(want, "cpu")
    a = as_tensor(out, b.device)
    if a.shape != b.shape:
        raise ValueError(f"shape {tuple(a.shape)} vs reference "
                         f"{tuple(b.shape)}")
    b = b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def verify_plan(plan: KernelPlan, device=None, seed: int = 0,
                tol: float = 1e-3) -> Tuple[bool, float]:
    """Execute the plan and compare against the oracle: (ok, rel err)."""
    inputs = make_inputs(plan, seed, device)
    out = execute_plan(plan, inputs, device)
    err = rel_error(out, reference_output(plan, inputs))
    return err < tol, err


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_plan(plan: KernelPlan, inputs: Optional[Mapping] = None,
                 device=None, iters: int = 2, warmup: int = 1) -> float:
    """Wall-clock seconds of one plan execution: min over ``iters`` after
    ``warmup`` runs, fenced by ``torch.cuda.synchronize``."""
    dev = backend.resolve_device(device)
    run = plan_runner(plan, dev)
    inputs = {k: as_tensor(v, dev) for k, v in
              (inputs if inputs is not None
               else make_inputs(plan, device=dev)).items()}
    for _ in range(max(1, warmup)):
        run(inputs)
    _sync(dev)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        run(inputs)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best
