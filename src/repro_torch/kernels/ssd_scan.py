"""Mamba2 SSD intra-chunk term: the wrapper of the hand-written CUDA kernel
(``csrc/model_kernels.cu`` ``ssd_intra_kernel``) and its plain PyTorch
version.

The port of ``repro/kernels/ssd_scan.py``.  Per (batch, head, chunk):

    y = tril((C Bᵀ) ⊙ exp(acum_l − acum_m) ⊙ dt_m) @ x

with B and C shared across heads (G = 1).  The inter-chunk recurrence stays
in ``ops.ssd``.  ``ssd_intra_chunk`` launches the kernel for CUDA tensors (or
raises) and takes ``plain_ssd_intra_chunk`` for CPU tensors.  ``LAUNCHES``
counts kernel launches.  ``ssd_launch`` computes the kernel's geometry (head
group, tiles, shared memory, grid); the kernel takes any chunk length and
head dim.  ``ssd_intra_chunk_vjp`` is the differentiable form the training
path takes: its forward is ``ssd_intra_chunk`` (the kernel on the card), its
backward a closed form in float32 PyTorch (``ssd_intra_chunk_bwd``); the
reference differentiates the same term by autodiff of its jnp path, with no
Pallas backward.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from . import backend, ref

#: kernel launches since the last ``ops.reset_launch_counts()``
LAUNCHES: Dict[str, int] = {"ssd_intra_chunk": 0}

#: the TPU kernel the CUDA kernel replaces (file:line of its definition)
REPLACES = {"ssd_intra_chunk": "src/repro/kernels/ssd_scan.py:40"}

SOURCE = "src/repro_torch/csrc/model_kernels.cu"
#: the kernel's row and key tiles of a chunk, its P tile, the state columns
#: of a staged B/C chunk and its warps (one 16-row strip each)
SSD_TILE, SSD_PTILE, SSD_NCHUNK, SSD_WARPS = 128, 64, 64, 8
#: the heads a block takes; the kernel's shared memory holds their decays
SSD_HG = 8
#: the most dynamic shared memory a block may opt into (227 KB)
SMEM_MAX = 232448


@dataclasses.dataclass(frozen=True)
class SsdLaunch:
    """Geometry of one ``kapla_ssd_intra_chunk`` call
    (``csrc/model_kernels.cu`` ``ssd_intra_kernel``).  Block ``(x, y)`` owns
    (b, chunk) ``x`` (``b * NC + chunk``) and heads ``[y * hg, y * hg +
    hg)``.  It walks the chunk's row tiles of ``SSD_TILE`` rows, for each
    the key tiles at or below it (``tiles``), forming G = C Bᵀ of the tile
    pair once (``n_chunks`` staged B/C chunks of ``SSD_NCHUNK`` state
    columns) and applying it to every (head, P tile) of its group.  Warp
    ``w`` owns the 16-row strip ``strip(w)`` of a row tile.  With more than
    one row tile the key tiles' partial sums go through a float32 workspace
    (``workspace``)."""

    B: int
    H: int
    NC: int
    Lc: int
    P: int
    N: int
    elem: int       # bytes of an element of x (4 float32, 2 bfloat16)
    hg: int         # heads a block

    @property
    def row_tiles(self) -> int:
        return -(-self.Lc // SSD_TILE)

    @property
    def p_tiles(self) -> int:
        return -(-self.P // SSD_PTILE)

    @property
    def n_chunks(self) -> int:
        return -(-self.N // SSD_NCHUNK)

    @property
    def groups(self) -> int:
        return -(-self.H // self.hg)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.B * self.NC, self.groups)

    @property
    def workspace(self) -> bool:
        return self.row_tiles > 1

    @property
    def x_pitch(self) -> int:
        """Staged x row pitch in elements (bank-conflict-free B fragments):
        68 floats or 72 bf16."""
        return SSD_PTILE + (4 if self.elem == 4 else 8)

    @property
    def smem(self) -> int:
        """Dynamic shared memory: the C and B chunks (rows at a pitch of
        ``SSD_NCHUNK + 4`` floats), the two-slot x ring and the staged
        output tile (at x's pitch), and per head of a group of ``SSD_HG`` a
        key tile's acum, factored decay u and dt, its 8-key blocks' steps
        and 8 decays a row (the row's own block on the diagonal)."""
        return (2 * SSD_TILE * (SSD_NCHUNK + 4) * 4
                + 3 * SSD_TILE * self.x_pitch * self.elem
                + SSD_HG * (11 * SSD_TILE + SSD_TILE // 8) * 4)

    def tiles(self) -> List[Tuple[int, int, int]]:
        """(row tile, key tile, P tile) of every product, in the kernel's
        order within a head."""
        return [(i, j, p) for i in range(self.row_tiles)
                for j in range(i + 1) for p in range(self.p_tiles)]

    def extent(self, tile: int, size: int, width: int) -> Tuple[int, int]:
        """(start, valid extent) of tile ``tile`` of ``width`` along an
        axis of ``size``."""
        return tile * width, min(width, size - tile * width)

    @staticmethod
    def strip(warp: int) -> int:
        """The 16-row strip of a row tile warp ``warp`` owns: warps w and w +
        4 share an SM sub-partition's tensor core, and take strips s and 7 -
        s, so each sub-partition gets equal work on the diagonal tile."""
        return warp if warp < 4 else 11 - warp

    def ksteps(self, warp: int, i: int, j: int) -> int:
        """8-key steps the strip of ``warp`` needs in tile pair (i, j): up
        to its last row on the diagonal, every valid key below it, none
        past the chunk's last row."""
        r0 = 16 * self.strip(warp)
        nr = self.extent(i, self.Lc, SSD_TILE)[1]
        nk = self.extent(j, self.Lc, SSD_TILE)[1]
        if r0 >= nr:
            return 0
        return -(-(min(r0 + 16, nk) if i == j else nk) // 8)

    def params(self, dtype_code: int, xvec: bool, bcvec: bool) -> List[int]:
        """``kapla_ssd_intra_chunk``'s parameter array; ``xvec`` and
        ``bcvec``: the rows of x and of B and C are 16-byte aligned."""
        return [self.B, self.H, self.NC, self.Lc, self.P, self.N,
                dtype_code, self.hg, int(xvec), int(bcvec), *self.grid,
                self.smem]


@functools.lru_cache(maxsize=None)
def ssd_launch(B: int, H: int, NC: int, Lc: int, P: int, N: int,
               elem: int = 2) -> SsdLaunch:
    """The geometry of ``kapla_ssd_intra_chunk``: groups of ``SSD_HG``
    heads (all of them, if fewer).  At Zamba2-1.2B's and Mamba2-1.3B's
    prefill (B 8, 4 chunks, 64 heads) that is 256 blocks of eight warps,
    one an SM at a time, in two waves over the H100's 132 SMs; a
    single-request prefill (B 1) gives 32."""
    if min(B, H, NC, Lc, P, N) <= 0 or elem not in (2, 4):
        raise ValueError(f"ssd_launch: dims {(B, H, NC, Lc, P, N)}, element "
                         f"bytes {elem}")
    launch = SsdLaunch(B, H, NC, Lc, P, N, elem, min(H, SSD_HG))
    if launch.grid[0] >= 1 << 31 or launch.grid[1] > 65535:
        raise ValueError(f"ssd_launch: grid {launch.grid} too large")
    return launch


def plain_ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor,
                          acum: torch.Tensor, b: torch.Tensor,
                          c: torch.Tensor) -> torch.Tensor:
    """The body of ``_ssd_intra_kernel`` batched over (b, h, chunk), in
    f32: ``scores = (c bᵀ) * exp(acum_l - acum_m) * dt_m`` on and below the
    diagonal (the exponent is zeroed above it, so no ``inf`` is formed),
    ``y = scores @ x`` in x's dtype."""
    ref.full_fp32(x)
    Lc = x.shape[3]
    scores = torch.matmul(c.float(), b.float().transpose(-1, -2))
    scores = scores[:, None]                           # [B, 1, NC, Lc, Lc]
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    acum = acum.float()
    diff = torch.where(tri, acum[..., :, None] - acum[..., None, :], 0.0)
    scores = scores * torch.exp(diff) * dt.float()[..., None, :]
    scores = torch.where(tri, scores, 0.0)
    return torch.matmul(scores, x.float()).to(x.dtype)


def _check(x, dt, acum, b, c) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (x, dt, acum, b, c)):
        raise TypeError("ssd_intra_chunk: expected torch.Tensors")
    if x.dim() != 5:
        raise ValueError(f"ssd_intra_chunk x: shape {tuple(x.shape)}, "
                         "expected [B, H, NC, Lc, P]")
    B, H, NC, Lc, P = x.shape
    N = b.shape[-1] if b.dim() == 4 else -1
    want = {"dt": (dt, (B, H, NC, Lc)), "acum": (acum, (B, H, NC, Lc)),
            "b": (b, (B, NC, Lc, N)), "c": (c, (B, NC, Lc, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_intra_chunk {name}: shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_chunk {name}: dtype {t.dtype}, "
                            "expected float32")
    if x.dtype not in backend.DTYPE_CODES:
        raise TypeError(f"ssd_intra_chunk x: dtype {x.dtype}, expected "
                        "float32 or bfloat16")
    for name, t in (("x", x), ("dt", dt), ("acum", acum), ("b", b),
                    ("c", c)):
        if t.device != x.device:
            raise ValueError(f"ssd_intra_chunk {name}: on {t.device}, "
                             f"expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_intra_chunk {name}: must be contiguous")


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, acum: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD term.

    x:    [B, H, NC, Lc, P]   (float32 or bfloat16)
    dt:   [B, H, NC, Lc]      (positive step sizes, float32)
    acum: [B, H, NC, Lc]      (within-chunk cumsum of dt * A, float32)
    b, c: [B, NC, Lc, N]      (G=1: shared across heads, float32)
    returns y_intra: [B, H, NC, Lc, P] in x's dtype.  The CUDA kernel on
    the card (geometry from ``ssd_launch``), the plain version on the CPU,
    an output of the right shape and type on ``meta`` (nothing launched).
    A cost counter (``launch/op_cost.py``) counts the call as one unit.
    """
    _check(x, dt, acum, b, c)
    with backend.kernel_call("ssd_intra_chunk", x, b):
        if x.device.type == "cpu":
            return plain_ssd_intra_chunk(x, dt, acum, b, c)
        if x.is_meta:            # what the card would take, nothing run
            ssd_launch(*x.shape, b.shape[-1], x.element_size())
            return torch.empty_like(x)
        return _launch(x, dt, acum, b, c)


def _launch(x, dt, acum, b, c):
    """One launch of ``ssd_intra_kernel`` on the card."""
    if not x.is_cuda:
        raise ValueError(f"ssd_intra_chunk: unsupported device {x.device}")
    B, H, NC, Lc, P = x.shape
    N = b.shape[-1]
    launch = ssd_launch(B, H, NC, Lc, P, N, x.element_size())
    xvec = (P * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    bcvec = N % 4 == 0 and b.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
    vals = launch.params(backend.DTYPE_CODES[x.dtype], xvec, bcvec)
    prm = (ctypes.c_int64 * len(vals))(*vals)
    out = torch.empty_like(x)
    ws = None
    if launch.workspace:        # the key tiles' partial sums, in float32
        ws = out if x.dtype == torch.float32 else torch.empty(
            x.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        fn = backend.library(backend.MODEL_SOURCE).kapla_ssd_intra_chunk
        backend.check_launch("kapla_ssd_intra_chunk", fn(
            x.data_ptr(), dt.data_ptr(), acum.data_ptr(), b.data_ptr(),
            c.data_ptr(), out.data_ptr(), None if ws is None
            else ws.data_ptr(), prm, backend.stream_handle(x.device)))
    LAUNCHES["ssd_intra_chunk"] += 1
    return out


def ssd_intra_chunk_bwd(dy: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                        acum: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The gradients of ``y = G x`` per (b, h, chunk), in float32, with
    ``S = C Bᵀ`` and ``D = exp(acum_l - acum_m)`` on and below the
    diagonal (the exponent zeroed above it, as the forward does),
    ``G = tril(S D dt_m)`` and ``dG = tril(dY Xᵀ)``:

      dX = Gᵀ dY;  d dt_m = Σ_l dG S D;  dS = Σ_h dG D dt_m, so
      dC = dS B and dB = dSᵀ C (B and C have no head axis);
      with E = dG G: d acum = rowsum(E) - colsum(E).

    Returns (dx in x's type, d dt, d acum, db, dc in float32)."""
    Lc = x.shape[3]
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    bf, cf, acum = b.float(), c.float(), acum.float()
    S = torch.matmul(cf, bf.transpose(-1, -2))[:, None]   # [B,1,NC,l,m]
    D = torch.where(tri, torch.exp(torch.where(
        tri, acum[..., :, None] - acum[..., None, :], 0.0)), 0.0)
    SD = S * D                                             # [B,H,NC,l,m]
    G = SD * dt.float()[..., None, :]
    dyf = dy.float()
    dG = torch.where(tri, torch.matmul(dyf, x.float().transpose(-1, -2)),
                     0.0)
    dx = torch.matmul(G.transpose(-1, -2), dyf)
    ddt = (dG * SD).sum(-2)
    dS = (dG * D * dt.float()[..., None, :]).sum(1)        # [B,NC,l,m]
    dc = torch.matmul(dS, bf)
    db = torch.matmul(dS.transpose(-1, -2), cf)
    E = dG * G
    dacum = E.sum(-1) - E.sum(-2)
    return dx.to(x.dtype), ddt, dacum, db, dc


class _SsdIntraChunk(torch.autograd.Function):
    """Forward: ``ssd_intra_chunk`` (the kernel on the card, the plain
    version on the CPU); backward: ``ssd_intra_chunk_bwd``, recomputed from
    the saved inputs, launching no kernel."""

    @staticmethod
    def forward(ctx, x, dt, acum, b, c):
        ctx.save_for_backward(x, dt, acum, b, c)
        return ssd_intra_chunk(x, dt, acum, b, c)

    @staticmethod
    def backward(ctx, dy):
        return ssd_intra_chunk_bwd(dy, *ctx.saved_tensors)


def ssd_intra_chunk_vjp(x: torch.Tensor, dt: torch.Tensor,
                        acum: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """``ssd_intra_chunk`` with a gradient (same arguments and result)."""
    return _SsdIntraChunk.apply(x, dt, acum, b, c)


__all__ = ["LAUNCHES", "REPLACES", "SOURCE", "SsdLaunch",
           "plain_ssd_intra_chunk", "ssd_intra_chunk", "ssd_intra_chunk_bwd",
           "ssd_intra_chunk_vjp", "ssd_launch"]
