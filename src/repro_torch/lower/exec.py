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
#: tensor-core one)
LAUNCHES: Dict[str, int] = {"fc": 0, "conv": 0, "pool": 0, "eltwise": 0,
                            "attention": 0, "attention_mma": 0}

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
#: the most elements an array of one conv launch may hold: its window
#: offsets are 32-bit, so ``conv_batch_parts`` splits the batch under it
CONV_MAX_ELEMS = (1 << 31) - 1
#: the H100's SMs, over which the conv model spreads blocks
SMS = 132
CONV_THREADS = 128
CONV_WARPS = CONV_THREADS // 32
CONV_STAGES = 3                 # the conv kernel's ring of cp.async stages
#: the most dynamic shared memory a block may opt into (227 KB), and the
#: caps conv_launch sizes chunks for (four, two and one block an SM)
CONV_SMEM_MAX = 232448
CONV_SMEM_CAPS = (56 * 1024, 113 * 1024, CONV_SMEM_MAX)
#: the deepest reduction a conv chunk stages, unless one channel's R*S is
#: deeper
CONV_DEPTH = 80
#: the conv warp tiles: (mt, nt, wm, wn), each warp 16 mt positions x 8 nt
#: channels, the four warps wm x wn
CONV_TILES = tuple((mt, nt, wm, CONV_WARPS // wm) for mt in (1, 2)
                   for nt in (1, 2, 3, 4) for wm in (1, 2, 4))
#: registers a thread of each conv warp tile (mt, nt) takes (ptxas for
#: sm_90a, CUDA 12.8), and the cycles a block waits for its first stages:
#: the conv model's occupancy and fill
CONV_REGS = {(1, 1): 89, (1, 2): 108, (1, 3): 127, (1, 4): 147,
             (2, 1): 116, (2, 2): 151, (2, 3): 187, (2, 4): 227}
CONV_FILL = 10000
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
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


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
# conv
# ---------------------------------------------------------------------------

def plain_conv(plan: KernelPlan, x: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Direct VALID conv walked over the plan's grid: per step, the halo'd
    window of the (ix, iy) block, one channel contraction per (r, s) into
    the ``[bn, bk, bx, by]`` tile, added to the output block."""
    ref.full_fp32(x)
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


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def _even(block: int, tile: int) -> int:
    """The sub-tile width that cuts ``block`` into as many pieces as
    ``tile`` does, balanced (the last piece at most one short of the
    others' share)."""
    return _ceil(block, _ceil(block, tile))


@dataclasses.dataclass(frozen=True)
class ConvLaunch:
    """Geometry of one ``kapla_conv`` call (``csrc/lower_kernels.cu``
    ``conv_kernel<mt, nt>``, an implicit GEMM in 3xTF32).  Block ``(x, y,
    z)`` owns one output sub-tile of one plan tile: X/Y sub-tile ``x``
    (``x // ny``, ``x % ny``), K sub-tile ``y`` and N sub-tile ``z``
    (``sub_tile``): ``tn`` images x ``tx`` rows x ``ty`` cols of positions
    by ``tk`` channels.  Its ``wm x wn`` warps each compute ``16 mt``
    positions x ``8 nt`` channels.  The reduction walks the plan's C tiles
    in order, each in chunks of ``cc`` channels (``chunks``) whose depth
    ``nc * R * S`` is padded to a multiple of 8; a stage holds the chunk's
    weights (``bnw`` rows at pitch ``ldw``) and input window (``cc``
    channels at pitch ``cpitch``)."""

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
    bn: int
    bc: int
    bk: int
    bx: int
    by: int
    tn: int
    tx: int
    ty: int
    tk: int
    cc: int
    mt: int         # 16-row mma tiles a warp (positions)
    nt: int         # 8-column mma tiles a warp (channels)
    wm: int         # warps along positions
    wn: int         # warps along channels
    vec: bool       # 16-byte weight copies (rows 16-byte aligned)

    @property
    def sub(self) -> Dict[str, int]:
        """Sub-tiles per plan tile along each axis."""
        return {d: _ceil(b, t) for d, b, t in
                (("N", self.bn, self.tn), ("K", self.bk, self.tk),
                 ("X", self.bx, self.tx), ("Y", self.by, self.ty))}

    @property
    def grid(self) -> Tuple[int, int, int]:
        sub = self.sub
        return ((self.XO // self.bx) * sub["X"] * (self.YO // self.by)
                * sub["Y"], (self.K // self.bk) * sub["K"],
                (self.N // self.bn) * sub["N"])

    @property
    def bm(self) -> int:
        """Positions the block's warps cover."""
        return self.wm * 16 * self.mt

    @property
    def bnw(self) -> int:
        """Channels the block's warps cover (weight rows staged)."""
        return self.wn * 8 * self.nt

    @property
    def jpad(self) -> int:
        """Reduction depth of a full chunk, padded to a multiple of 8."""
        return _round8(self.cc * self.R * self.S)

    @property
    def ldw(self) -> int:
        """Weight row pitch: 4 mod 8 floats, conflict-free B fragments."""
        return self.jpad + 4

    @property
    def spmax(self) -> int:
        """Input window elements of one channel of the largest sub-tile."""
        return self.tn * ((self.tx - 1) * self.stride + self.R) \
            * ((self.ty - 1) * self.stride + self.S)

    @property
    def cpitch(self) -> int:
        """Window channel pitch: 8 mod 32 floats, so the four channels of a
        1x1 layer's A fragment fall in distinct banks."""
        return self.spmax + (8 - self.spmax) % 32

    @property
    def stage(self) -> int:
        """Floats of one stage of the ring."""
        return self.bnw * self.ldw + self.cc * self.cpitch

    @property
    def smem(self) -> int:
        """Dynamic shared memory: the ring, the reduction offset table and
        the window offset table."""
        return 4 * (CONV_STAGES * self.stage + self.jpad + self.spmax)

    def sub_tile(self, axis: str, g: int) -> Tuple[int, int]:
        """(start, extent) of sub-tile ``g`` along ``axis`` (N, K, X or
        Y), as the kernel's ``sub_tile`` computes it."""
        block, tile = {"N": (self.bn, self.tn), "K": (self.bk, self.tk),
                       "X": (self.bx, self.tx),
                       "Y": (self.by, self.ty)}[axis]
        sub = self.sub[axis]
        start = (g // sub) * block + (g % sub) * tile
        return start, min(tile, (g // sub + 1) * block - start)

    def chunks(self) -> List[Tuple[int, int, int]]:
        """(C tile, c0, channels) of each chunk, in the kernel's order."""
        out = []
        for t in range(self.C // self.bc):
            for c0 in range(t * self.bc, (t + 1) * self.bc, self.cc):
                out.append((t, c0, min(self.cc, (t + 1) * self.bc - c0)))
        return out

    def params(self, vec: bool) -> List[int]:
        """``kapla_conv``'s parameter array; ``vec`` is ``self.vec`` and
        the 16-byte alignment of W."""
        return [self.N, self.C, self.K, self.XI, self.YI, self.XO, self.YO,
                self.R, self.S, self.stride, self.bn, self.bc, self.bk,
                self.bx, self.by, self.tn, self.tx, self.ty, self.tk,
                self.cc, *(self.sub[d] for d in "NKXY"), self.wm, self.wn,
                self.jpad, self.ldw, self.cpitch, self.stage, self.spmax,
                int(vec), *self.grid, self.smem, self.mt, self.nt]


def _conv_box(bn: int, bx: int, by: int, bm: int) -> Tuple[int, int, int]:
    """The (images, rows, cols) box of at most ``bm`` positions that cuts
    a plan tile into the fewest sub-tiles, whole rows of the tile first."""
    ty = _even(by, min(by, bm))
    tx = _even(bx, min(bx, bm // ty))
    tn = _even(bn, min(bn, bm // (tx * ty)))
    return tn, tx, ty


def _conv_chunk(bc: int, RS: int,
                fits: Callable[[int], bool]) -> Optional[int]:
    """The channel chunk: the fewest padded reduction steps over a C tile
    (a chunk costs about 16 more for its stage), within ``CONV_DEPTH``
    (or one channel, where R*S is deeper) and ``fits``; None when one
    channel does not fit."""
    cap = max(CONV_DEPTH, _round8(RS))
    best = None
    for cc in range(1, bc + 1):
        if _round8(cc * RS) > cap or not fits(cc):
            break
        n = _ceil(bc, cc)
        cost = (n - 1) * _round8(cc * RS) \
            + _round8((bc - (n - 1) * cc) * RS) + 16 * n
        if best is None or cost < best[0]:
            best = (cost, cc)
    return None if best is None else best[1]


def _conv_time(launch: ConvLaunch) -> float:
    """A model of the kernel's time, in SM cycles: per block, the
    k-steps (8 deep) of every chunk at the larger of the busy warps' mma
    products (3 m16n8k8 a multiply-add tile, at half of one a cycle) and
    their shared-memory fragment reads (one warp's a cycle), plus a
    quarter cycle per 32-byte sector the chunks stage (a window row of w
    floats touches (w + 7) / 8), and a fill of ``CONV_FILL`` cycles shared
    by the blocks an SM holds (registers, ``CONV_REGS``, and shared
    memory); blocks spread over the SMs.  Its weights come from timing
    every candidate on every ResNet-50 and AlexNet b64 plan on the card
    (``tools/conv_tiles.py``): over a ResNet-50 forward its picks came
    within 3% of the fastest candidates'."""
    L = launch
    warps = CONV_WARPS - _conv_idle_warps(L)
    mma = warps * 3 * L.mt * L.nt * 2
    lds = warps * (4 * L.mt + 2 * L.nt + 2)
    chunks = L.chunks()
    ksteps = sum(_round8(nc * L.R * L.S) // 8 for _, _, nc in chunks)
    winx = (L.tx - 1) * L.stride + L.R
    winy = (L.ty - 1) * L.stride + L.S
    sectors = len(chunks) * (L.cc * L.tn * winx * (winy + 7) / 8
                             + L.bnw * L.jpad / 8)
    per_block = max(mma, lds) * ksteps + sectors / 4
    occupancy = max(1, min(65536 // (CONV_REGS[L.mt, L.nt] * CONV_THREADS),
                           CONV_SMEM_MAX // (L.smem + 1024)))
    blocks = L.grid[0] * L.grid[1] * L.grid[2]
    return blocks * (per_block + CONV_FILL / occupancy) / SMS


def _conv_idle_warps(launch: ConvLaunch) -> int:
    """Warps of a full sub-tile's block that have no position or no
    channel to compute."""
    L = launch
    busy = min(L.wm, _ceil(L.tn * L.tx * L.ty, 16 * L.mt)) \
        * min(L.wn, _ceil(L.tk, 8 * L.nt))
    return CONV_WARPS - busy


def conv_batch_parts(plan: KernelPlan, XI: int,
                     YI: int) -> List[Tuple[int, int]]:
    """The images ``[n0, n1)`` of each ``kapla_conv`` launch: the batch cut
    at multiples of the plan's N block so that each launch's input and
    output hold at most ``CONV_MAX_ELEMS`` elements (one part when the
    whole batch does)."""
    L, bn = plan.layer, plan.block["N"]
    N = L.dim("N")
    per_image = max(L.dim("C") * XI * YI,
                    L.dim("K") * L.dim("X") * L.dim("Y"))
    step = CONV_MAX_ELEMS // per_image // bn * bn
    if step == 0:
        raise ValueError(f"{plan.describe()}: one N block of {bn} images "
                         f"holds {bn * per_image} elements; the kernel's "
                         "window offsets are 32-bit")
    return [(n0, min(N, n0 + step)) for n0 in range(0, N, step)]


def conv_launch(plan: KernelPlan, XI: int, YI: int,
                batch: Optional[int] = None) -> ConvLaunch:
    """The geometry of ``kapla_conv`` for ``plan`` (over ``batch`` images
    of it, a multiple of its N block, where ``conv_batch_parts`` splits the
    batch; by default all of them): of the warp tiles in
    ``CONV_TILES``, each with its chunks sized for every cap of
    ``CONV_SMEM_CAPS``, of those with the fewest idle warps the one that
    the model ``_conv_time`` finds quickest (then the largest, then the
    least shared memory).  Sub-tiles cover each plan tile once; chunks
    never straddle a plan C tile."""
    _check_reduction(plan)
    L, b = plan.layer, plan.block
    N, C, K, XO, YO = (L.dim(d) for d in "NCKXY")
    N = N if batch is None else batch
    R, S, st = (int(L.meta[k]) for k in ("R", "S", "stride"))
    if N % b["N"] or max(N * C * XI * YI, N * K * XO * YO) > CONV_MAX_ELEMS:
        raise ValueError(f"{plan.describe()}: a launch of {N} images; the "
                         "kernel takes whole N blocks and arrays of at most "
                         f"{CONV_MAX_ELEMS} elements (conv_batch_parts)")
    launch = _conv_launch(N, C, K, XI, YI, XO, YO, R, S, st, b["N"],
                          b["C"], b["K"], b["X"], b["Y"])
    if launch is None:
        raise ValueError(f"{plan.describe()}: one channel of the conv "
                         "window does not fit in shared memory")
    if launch.grid[0] >= 1 << 31 or max(launch.grid[1:]) > 65535:
        raise ValueError(f"{plan.describe()}: conv grid {launch.grid} too "
                         "large")
    return launch


@functools.lru_cache(maxsize=None)
def _conv_launch(N, C, K, XI, YI, XO, YO, R, S, st, bn, bc, bk, bx, by):
    found = [f for cap in CONV_SMEM_CAPS for f in conv_candidates(
        N, C, K, XI, YI, XO, YO, R, S, st, bn, bc, bk, bx, by, cap)]
    if not found:
        return None
    return min(found, key=lambda f: f[0])[1]


def conv_candidates(N, C, K, XI, YI, XO, YO, R, S, st, bn, bc, bk, bx, by,
                    cap):
    """(key, launch) for every warp tile of ``CONV_TILES`` whose stage fits
    ``cap`` bytes of shared memory: its sub-tile box, width and channel
    chunk, and ``key`` = (idle warps, ``_conv_time``, -tile size, shared
    memory), which ``conv_launch`` minimizes."""
    RS = R * S
    vec = (C * RS) % 4 == 0 and (bc * RS) % 4 == 0
    found = []
    for mt, nt, wm, wn in CONV_TILES:
        tn, tx, ty = _conv_box(bn, bx, by, wm * 16 * mt)
        tk = _even(bk, min(bk, wn * 8 * nt))
        while True:
            base = ConvLaunch(N, C, K, XI, YI, XO, YO, R, S, st, bn, bc, bk,
                              bx, by, tn, tx, ty, tk, 1, mt, nt, wm, wn,
                              False)

            def fits(cc, base=base):
                return dataclasses.replace(base, cc=cc).smem <= cap
            cc = _conv_chunk(bc, RS, fits)
            if cc is not None or (tn, tx, ty) == (1, 1, 1):
                break
            if tn > 1:          # shrink the window until a channel fits
                tn = _ceil(tn, 2)
            elif tx > 1:
                tx = _ceil(tx, 2)
            else:
                ty = _ceil(ty, 2)
        if cc is None:
            continue
        launch = dataclasses.replace(base, cc=cc,
                                     vec=vec and cc * RS % 4 == 0)
        found.append(((_conv_idle_warps(launch), _conv_time(launch),
                       -launch.bm * launch.bnw, launch.smem), launch))
    return found


@functools.lru_cache(maxsize=None)
def _conv_params(launch: ConvLaunch, vec: bool):
    """``kapla_conv``'s parameter array (built once per geometry)."""
    return _params(launch.params(vec))


def run_conv(plan: KernelPlan, x: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """conv wrapper: the CUDA kernel on the card, ``plain_conv`` on the
    CPU.  ``x`` holds exactly the halo'd input extent."""
    L = plan.layer
    N, C, K = L.dim("N"), L.dim("C"), L.dim("K")
    R, S = int(L.meta["R"]), int(L.meta["S"])
    XI, YI = input_extent(L)
    _check(x, (N, C, XI, YI), "conv input I[N,C,XI,YI]", x.device)
    _check(w, (K, C, R, S), "conv weight W[K,C,R,S]", x.device)
    if not _cuda_or_cpu(x, "conv"):
        return plain_conv(plan, x, w)
    out = torch.empty((N, K, L.dim("X"), L.dim("Y")), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        lib = backend.library()
        for n0, n1 in conv_batch_parts(plan, XI, YI):
            launch = conv_launch(plan, XI, YI, n1 - n0)
            prm = _conv_params(launch, launch.vec and w.data_ptr() % 16 == 0)
            backend.check_launch("kapla_conv", lib.kapla_conv(
                x[n0:n1].data_ptr(), w.data_ptr(), out[n0:n1].data_ptr(),
                prm, backend.stream_handle(x.device)))
            backend.count_launch(LAUNCHES, "conv")
    return out


# ---------------------------------------------------------------------------
# pool (max; every grid axis indexes the output: single visit)
# ---------------------------------------------------------------------------

def plain_pool(plan: KernelPlan, x: torch.Tensor) -> torch.Tensor:
    """Max pool walked over the plan's grid, each block from ``NEG_INF``."""
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
    CPU."""
    L = plan.layer
    N, C, XO, YO = (L.dim(d) for d in "NCXY")
    XI, YI = input_extent(L)
    _check(x, (N, C, XI, YI), "pool input I[N,C,XI,YI]", x.device)
    if not _cuda_or_cpu(x, "pool"):
        return plain_pool(plan, x)
    prm = _params([N, C, XI, YI, XO, YO, int(L.meta["R"]),
                   int(L.meta["S"]), int(L.meta["stride"])])
    out = torch.empty((N, C, XO, YO), dtype=torch.float32, device=x.device)
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
    CPU.  Both add in operand order, so they agree bit for bit."""
    shape = tuple(plan.layer.dim(d) for d in "NCXY")
    chain = eltwise_chain(len(xs))
    for i, x in enumerate(xs):
        _check(x, shape, f"eltwise operand {i}", xs[0].device)
    if not _cuda_or_cpu(xs[0], "eltwise"):
        return plain_eltwise(plan, xs)
    dev = xs[0].device
    out = torch.empty(shape, dtype=torch.float32, device=dev)
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
    return lambda inputs: fn(plan, *(as_tensor(inputs[n], dev)
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
