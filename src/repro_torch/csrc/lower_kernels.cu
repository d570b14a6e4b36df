// Hand-written Hopper (sm_90a) kernels for the layer and network tiers of the
// lowering: fc, conv, max pool, the n-ary eltwise sum and attention.  They
// replace the five Pallas kernels of src/repro/lower/exec.py (_run_fc,
// _run_conv, _run_pool, _run_eltwise, _run_attention).  Each runs one
// KernelPlan (repro_torch/lower/plan.py): the plan's output-indexing grid
// axes become the CUDA grid.  In conv and attention the reduction axis (C)
// is a loop inside the block, walked tile by tile in the plan's order, each C
// tile's partial sum added to the output accumulator, which is how the Pallas
// kernels accumulate into an output block across revisits (attention: every
// C tile is a step of the online softmax, whose state stays in registers).
// fc splits C across blocks instead, and a second kernel adds the C tiles in
// the plan's order.  conv and pool read and write activations channels-last
// ([N, X, Y, C]), the layout the network executor keeps between its kernels
// (repro_torch/lower/netexec.py).
//
// All five take float32 and accumulate in float32.  fc, conv and attention
// run their products on the tensor cores in 3xTF32 (tf32_mma.cuh; conv on
// wgmma, fc and attention on mma.sync): three
// TF32 products per multiply-add, which keeps the 1e-5 parity with the plain
// versions that a single TF32 product (about three decimal digits) would
// break.  Attention at head dim 256 keeps the FMA tile of online_softmax.cuh
// on the CUDA cores (the tensor-core kernel's tiles would pass the shared
// memory and registers a block has there).  pool and eltwise move bytes and
// run on the CUDA cores.
// Launch geometry (sub-tile sizes, warp layout, wgmma orientation, C split,
// shared memory, grid) is computed by the Python wrappers in
// repro_torch/lower/exec.py and passed in an int64 parameter array; each
// entry point returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/backend.py does this).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "online_softmax.cuh"
#include "tf32_mma.cuh"

namespace {

// Output sub-tile `g` along one axis: the plan tile is `g / sub`, the CUDA
// sub-tile inside it `g % sub`; returns its start and extent (the last
// sub-tile of a plan tile may be short).
__device__ __forceinline__ void sub_tile(int g, int sub, int block, int tile,
                                         int& start, int& extent) {
  const int t = g / sub, s = g % sub;
  start = t * block + s * tile;
  extent = min(tile, (t + 1) * block - start);
}

// ---------------------------------------------------------------------------
// fc: O[N,K] = I[N,C] @ W[C,K]
// Replaces src/repro/lower/exec.py _run_fc.  Bound: bytes of W at batch 64
// (ResNet-50's fc: 8.2 MB of W against 0.26 GFLOP), operations for the large
// AlexNet layers.  Design:
// - Split C.  A block owns one output sub-tile (up to 64 x 64; fc_launch
//   picks sub-tiles that divide the plan tile in widths that are multiples
//   of 8) and one part of C: a slice of whole 32-deep slabs of one plan C
//   tile, or, where a workspace of one part per C tile would pass its cap,
//   every C tile in order (one part).  fc_launch sizes the slices so the grid
//   reaches about two blocks per SM.  With one part the block writes O;
//   otherwise each part goes to an f32 workspace [n_parts, N, K], and
//   fc_reduce_kernel sums the slices of each C tile and adds the C tiles into
//   O in the plan's order, the order of the Pallas kernel's o_ref += dot on
//   each revisit.  No atomics: the result is the same on every run.
// - A 4-stage ring of 16-byte cp.async copies (4-byte where C or K are not
//   multiples of 4) stages the I and W slabs, so loads overlap the math;
//   out-of-range rows and columns are zero-filled by the copy.
// - Products on the tensor cores in 3xTF32: mma.sync m16n8k8 with each
//   operand split as hi = tf32(x), lo = tf32(x - hi); the two small products
//   lo*hi + hi*lo go to an accumulator of their own and hi*hi to another,
//   added at the end of each C tile.  That keeps float32 accuracy (single
//   TF32 keeps ~3 digits and would break the 1e-5 parity with plain_fc).
//   Not wgmma: its tf32 form takes B only K-major, and W [C, K] is
//   MN-major.  Four warps, each 16
//   rows x the sub-tile's columns; the sub-tile's count of 8-column mma
//   tiles (NT = tk / 8) is a template parameter, so the inner loop has no
//   branch and the NT accumulator chains interleave.
// ---------------------------------------------------------------------------

constexpr int FC_SLAB = 32, FC_STAGES = 4, FC_THREADS = 128;
constexpr int FC_TN = 64, FC_TK = 64;
constexpr int FC_IP = FC_SLAB + 4;  // I slab row pitch: conflict-free A reads
constexpr int FC_WP = FC_TK + 8;    // W slab row pitch: conflict-free B reads
constexpr int FC_STAGE = FC_TN * FC_IP + FC_SLAB * FC_WP;  // floats
constexpr size_t FC_SMEM = (size_t)FC_STAGES * FC_STAGE * sizeof(float);
// blocks an SM holds at FC_SMEM each; tells ptxas the registers it may use
constexpr int FC_BLOCKS_PER_SM = 3;

struct FcArgs {
  int N, C, K, bn, bc, bk, tn, tk, sub_n, sub_k;
  int c_tiles, group, slices, slabs, vec, n_parts;
};

// Stage one slab: I rows [n0, n0 + an) x C [c0, c0 + nc) as [row][c] and W
// rows [c0, c0 + nc) x K [k0, k0 + ak) as [c][k]; the rest of the stage's
// tile is zero-filled.
__device__ __forceinline__ void fc_load_slab(float* is, float* wsm,
                                             const float* I, const float* W,
                                             const FcArgs& a, int n0, int an,
                                             int k0, int ak, int c0, int nc,
                                             int tid) {
  for (int idx = tid; idx < FC_TN * FC_SLAB / 4; idx += FC_THREADS) {
    const int r = idx / (FC_SLAB / 4), c = 4 * (idx % (FC_SLAB / 4));
    const int valid = r < an ? max(0, min(4, nc - c)) : 0;
    const float* src = I + (size_t)(n0 + min(r, an - 1)) * a.C + c0 + c;
    if (a.vec) {
      cp_async16(is + r * FC_IP + c, valid ? src : I, 4 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(is + r * FC_IP + c + e, e < valid ? src + e : I,
                  e < valid ? 4 : 0);
    }
  }
  for (int idx = tid; idx < FC_SLAB * FC_TK / 4; idx += FC_THREADS) {
    const int r = idx / (FC_TK / 4), k = 4 * (idx % (FC_TK / 4));
    const int valid = r < nc ? max(0, min(4, ak - k)) : 0;
    const float* src = W + (size_t)(c0 + min(r, nc - 1)) * a.K + k0 + k;
    if (a.vec) {
      cp_async16(wsm + r * FC_WP + k, valid ? src : W, 4 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(wsm + r * FC_WP + k + e, e < valid ? src + e : W,
                  e < valid ? 4 : 0);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(FC_THREADS, FC_BLOCKS_PER_SM)
fc_kernel(const float* __restrict__ I, const float* __restrict__ W,
          float* __restrict__ O, float* __restrict__ ws, FcArgs a) {
  extern __shared__ float4 fc_smem4[];
  float* sm = reinterpret_cast<float*>(fc_smem4);
  int n0, an, k0, ak;
  sub_tile(blockIdx.y, a.sub_n, a.bn, a.tn, n0, an);
  sub_tile(blockIdx.x, a.sub_k, a.bk, a.tk, k0, ak);
  // this block's part of C: tiles [t_lo, t_hi), slabs [s_lo, s_hi) of each
  const int part = blockIdx.z;
  int t_lo, t_hi, s_lo, s_hi;
  if (a.group == 1) {
    const int j = part % a.slices;
    t_lo = part / a.slices;
    t_hi = t_lo + 1;
    s_lo = j * a.slabs / a.slices;
    s_hi = (j + 1) * a.slabs / a.slices;
  } else {  // one part: every C tile
    t_lo = 0;
    t_hi = a.c_tiles;
    s_lo = 0;
    s_hi = a.slabs;
  }
  const int per = s_hi - s_lo, steps = (t_hi - t_lo) * per;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, wrow = warp * 16;
  auto stage_of = [&](int step, int buf) {
    const int t = t_lo + step / per, sl = s_lo + step % per;
    const int c0 = t * a.bc + sl * FC_SLAB;
    const int nc = min(FC_SLAB, (t + 1) * a.bc - c0);
    float* is = sm + buf * FC_STAGE;
    fc_load_slab(is, is + FC_TN * FC_IP, I, W, a, n0, an, k0, ak, c0, nc,
                 tid);
  };

  float acc[NT][4], prt[NT][4], cor[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = prt[j][e] = cor[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < FC_STAGES - 1; ++s) {
    if (s < steps) stage_of(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<FC_STAGES - 2>();
    __syncthreads();  // this step's slab is in; the previous one is consumed
    const int next = step + FC_STAGES - 1;
    if (next < steps) stage_of(next, next % FC_STAGES);
    cp_async_commit();

    const float* is = sm + (step % FC_STAGES) * FC_STAGE;
    const float* wsm = is + FC_TN * FC_IP;
    if (wrow < an) {
#pragma unroll
      for (int kk = 0; kk < FC_SLAB; kk += 8) {
        uint32_t ah[4], al[4];
        const float* ar = is + (wrow + g) * FC_IP + kk + t4;
        split_tf32(ar[0], ah[0], al[0]);
        split_tf32(ar[8 * FC_IP], ah[1], al[1]);
        split_tf32(ar[4], ah[2], al[2]);
        split_tf32(ar[8 * FC_IP + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh[2], bl[2];
          const float* br = wsm + (kk + t4) * FC_WP + 8 * j + g;
          split_tf32(br[0], bh[0], bl[0]);
          split_tf32(br[4 * FC_WP], bh[1], bl[1]);
          mma_3xtf32(prt[j], cor[j], ah, al, bh, bl);
        }
      }
    }
    if (step % per == per - 1) {  // a C tile (or this slice of it) is done
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] += prt[j][e] + cor[j][e];
          prt[j][e] = cor[j][e] = 0.f;
        }
    }
  }

  float* dst = a.n_parts == 1 ? O : ws + (size_t)part * a.N * a.K;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wrow + g + (e >= 2 ? 8 : 0), c = 8 * j + 2 * t4 + (e & 1);
      if (r < an && c < ak) dst[(size_t)(n0 + r) * a.K + k0 + c] = acc[j][e];
    }
}

template <int NT>
cudaError_t launch_fc(dim3 grid, cudaStream_t s, const float* I,
                      const float* W, float* O, float* ws, const FcArgs& a) {
  static bool smem_set = false;
  cudaError_t err = allow_smem(fc_kernel<NT>, FC_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  fc_kernel<NT><<<grid, FC_THREADS, FC_SMEM, s>>>(I, W, O, ws, a);
  return cudaGetLastError();
}

// O = sum over C tiles in plan order of (the sum of the tile's slices)
__global__ void fc_reduce_kernel(const float* __restrict__ ws,
                                 float* __restrict__ O, FcArgs a) {
  const size_t nk = (size_t)a.N * a.K;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nk;
       i += (size_t)gridDim.x * blockDim.x) {
    float out = 0.f;
    for (int t = 0; t < a.c_tiles; ++t) {
      float tile = 0.f;
      for (int j = 0; j < a.slices; ++j)
        tile += ws[(size_t)(t * a.slices + j) * nk + i];
      out += tile;
    }
    O[i] = out;
  }
}

// ---------------------------------------------------------------------------
// conv: O = VALID conv of I with W [K, C, R, S] at a stride, activations
// channels-last: I [N, XI, YI, C] at a channel pitch cp >= C (a multiple of
// 4), O [N, XO, YO, K]
// Replaces src/repro/lower/exec.py _run_conv.  Bound: operations for every
// layer of ResNet-50 and AlexNet, at the 3xTF32 rate (495 TFLOP/s TF32 / 3
// products = 165 TFLOP/s on the H100 SXM).  Why channels-last: on [N, C, X,
// Y] activations the plans' 1-column tiles make every window element a
// 32-byte sector of its own, and TF32 wgmma, the only way to the tensor
// cores' full rate, takes its operands K-major (the reduction axis
// contiguous), which C is not in that layout.
// Design: an implicit GEMM on wgmma m64nNk8 .tf32 in 3xTF32.  A plan tile
// is cut into output sub-tiles (conv_launch covers each plan tile exactly
// once), each a box of tn images x tx rows x ty cols of positions by tk
// output channels; a block walks `group` sub-tiles of one plan tile in
// turn, its ring running on from one to the next, so one sub-tile's stores
// overlap the next one's loads.  The reduction walks the plan's C tiles in
// plan order,
// each as pieces of 32 channels (one 128-byte row) by the R x S taps; a
// step is one (C tile, piece, tap).
// - Channels-last makes a step's operands two K-major tiles that TMA copies
//   whole: the positions' 32 channels at tap (r, s) are the box (32, ty, tx,
//   tn) of the input at (c0, y0*sy + s, x0*stride + r, n0), traversed at
//   the strides along x and y; the weights' are the box (32, 1, 1, rows) of
//   the weights laid out [K, T, R*S, bcp] by conv_kernel_weights (T the C
//   tiles; a tile's pieces start at its first channel rounded down to a
//   multiple of 4, since a box starts on a 16-byte unit, and its row holds
//   zeros around its channels).  Channels of a piece outside its C tile
//   meet those zero weights (or TMA's zero fill past the tensor), so no
//   step straddles a C tile; k8 steps past the tile's channels are
//   skipped.
// - An input of at most 4 channels in one C tile (the images) comes folded
//   by its layout conversion (exec.py conv_input): each position's row of S
//   taps as its channels, [N, XI, YO, 4 S] at the y stride, so the kernel
//   runs it as R taps of 4 S channels (y stride 1, S = 1) instead of R*S
//   steps of one k8 step each, 28 of every 32 channels zero.
// - 3xTF32: lo*hi + hi*lo + hi*hi, three wgmma a k8 step.  conv_kernel_
//   weights stores the weights split (hi = the leading 19 bits, lo = x -
//   hi); the activations are split in shared memory when they arrive.
// - Warp-specialised: a producer warpgroup, one thread of which issues the
//   TMA copies into a ring of stages (full / ready / empty mbarriers), and
//   three warps of which split each arrived activation tile in place (hi)
//   and into a lo tile; one or two consumer warpgroups of 64 rows run the
//   wgmma, each step's products issued while the step before runs.  The
//   launch picks wgmma's 64-row M side: the positions where the plan tile
//   holds 64 or more (two warpgroups share the weight tiles from 128), else
//   the output channels, with the positions as N.
// - Precision: the products of CONV_CHAIN steps (at most 8 k8 steps x 3)
//   accumulate on the tensor cores from zero, then add into the float32
//   output accumulator, in plan order: a long chain of tensor-core
//   accumulations loses low bits on every add.  No atomics: two launches
//   agree bit for bit.
// - The accumulators go straight to O: a warp's store covers whole 32-byte
//   sectors (8 channels of a position, or 8 bytes of each of 8 positions'
//   runs); positions and channels past the sub-tile are dropped.
// ---------------------------------------------------------------------------

constexpr int CONV_THREADS = 384;  // producer warpgroup + two consumers
constexpr int CONV_SPLITTERS = 96; // producer warps 1-3
constexpr int CONV_CHAIN = 2;      // steps a tensor-core sum spans
// the most dynamic shared memory conv_launch asks for (the H100's 227 KB)
constexpr int CONV_SMEM_MAX = 232448;

struct ConvArgs {
  int N, C, K, XO, YO, R, S, stride, sy;  // sy: the y stride (1 folded)
  int bn, bc, bk, bx, by;          // plan block
  int tn, tx, ty, tk;              // block sub-tile: position box, channels
  int sub_n, sub_k, sub_x, sub_y;  // sub-tiles per plan tile
  int pos_m, cw;                   // positions on the M side; consumer
                                   // warpgroups
  int xrows, wrows, stages;        // rows of a stage's activation and
                                   // weight tiles; stages in the ring
  int bcp;                         // row of a C tile's laid-out weights
  int vec;                         // 8-byte output stores
  int group, groups;               // sub-tiles a block walks; blocks a
                                   // plan tile
};

// Step q of a block: C tile t, piece j of 32 channels, tap rs.  A tile's
// pieces start at its first channel rounded down to a multiple of 4
// (TMA's boxes start on 16-byte units): sh channels early.
__device__ __forceinline__ void conv_step(const ConvArgs& a, int q, int& t,
                                          int& j, int& rs, int& sh) {
  const int RS = a.R * a.S, pieces = (a.bcp + 31) / 32;
  t = q / (pieces * RS);
  const int rem = q - t * pieces * RS;
  j = rem / RS;
  rs = rem - j * RS;
  sh = (t * a.bc) & 3;
}

// K-major, 128-byte swizzled tile at `tile`: the descriptor of k8 step kk.
__device__ __forceinline__ uint64_t conv_desc(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 32, 16, 1024);
}

// Sub-tile u of this block's plan tile: its origin and extent along N, K,
// X and Y (K sub-tiles fastest, then Y, X and N: exec.py block_subtiles).
struct ConvTile {
  int n0, an, k0, ak, x0, ax, y0, ay;
};

__device__ __forceinline__ ConvTile conv_subtile(const ConvArgs& a, int u) {
  const int py = a.YO / a.by;
  const int pk = blockIdx.y, pn = blockIdx.z / a.groups;
  const int px = blockIdx.x / py, pyi = blockIdx.x - px * py;
  ConvTile s;
  const int sk = u % a.sub_k;
  u /= a.sub_k;
  const int sy = u % a.sub_y;
  u /= a.sub_y;
  const int sx = u % a.sub_x, sn = u / a.sub_x;
  sub_tile(pn * a.sub_n + sn, a.sub_n, a.bn, a.tn, s.n0, s.an);
  sub_tile(pk * a.sub_k + sk, a.sub_k, a.bk, a.tk, s.k0, s.ak);
  sub_tile(px * a.sub_x + sx, a.sub_x, a.bx, a.tx, s.x0, s.ax);
  sub_tile(pyi * a.sub_y + sy, a.sub_y, a.by, a.ty, s.y0, s.ay);
  return s;
}

template <int NW>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv_kernel_wgmma(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap thi,
                  const __grid_constant__ CUtensorMap tlo,
                  float* __restrict__ O, ConvArgs a) {
  extern __shared__ uint8_t conv_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(conv_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t stage_bytes = 256u * (a.xrows + a.wrows);
  const uint32_t xlo_off = 128u * a.xrows, whi_off = 256u * a.xrows;
  const uint32_t wlo_off = whi_off + 128u * a.wrows;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.stages * stage_bytes);
  uint64_t* ready = full + a.stages;
  uint64_t* empty = ready + a.stages;

  // this block's sub-tiles [u0, u1) of its plan tile, steps each
  const int subs = a.sub_n * a.sub_k * a.sub_x * a.sub_y;
  const int u0 = (blockIdx.z % a.groups) * a.group;
  const int u1 = min(subs, u0 + a.group);
  const int steps = (a.C / a.bc) * ((a.bcp + 31) / 32) * a.R * a.S;
  const int consumers = 128 * a.cw;

  if (threadIdx.x == 0) {
    tma_prefetch(&tx);
    tma_prefetch(&thi);
    tma_prefetch(&tlo);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], CONV_SPLITTERS);
      mbar_init(&empty[s], consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {
    // ---- producer warpgroup ----
    setmaxnreg_dec<40>();
    const int pt = threadIdx.x - consumers;
    if (pt == 0) {
      // the loader: one thread issues every TMA copy
      const uint32_t bytes =
          128u * (a.tn * a.tx * a.ty) + 2u * 128u * a.wrows;
      int stage = 0, phase = 0;
      for (int u = u0; u < u1; ++u) {
        const ConvTile s0 = conv_subtile(a, u);
        for (int q = 0; q < steps; ++q) {
          int t, j, rs, sh;
          conv_step(a, q, t, j, rs, sh);
          const int r = rs / a.S, s = rs - r * a.S;
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* base = ring + stage * stage_bytes;
          mbar_arrive_expect_tx(&full[stage], bytes);
          tma_load_4d(base, &tx, &full[stage], t * a.bc - sh + 32 * j,
                      s0.y0 * a.sy + s, s0.x0 * a.stride + r, s0.n0);
          tma_load_4d(base + whi_off, &thi, &full[stage], 32 * j, rs, t,
                      s0.k0);
          tma_load_4d(base + wlo_off, &tlo, &full[stage], 32 * j, rs, t,
                      s0.k0);
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (pt >= 32) {
      // the splitters: each arrived activation tile -> hi in place, lo
      const int sid = pt - 32, n4 = a.xrows * 8;
      int stage = 0, phase = 0;
      for (int q = 0; q < (u1 - u0) * steps; ++q) {
        mbar_wait(&full[stage], phase);
        float4* xh = reinterpret_cast<float4*>(ring + stage * stage_bytes);
        float4* xl = reinterpret_cast<float4*>(ring + stage * stage_bytes +
                                               xlo_off);
#pragma unroll 4
        for (int i = sid; i < n4; i += CONV_SPLITTERS) {
          float4 hi, lo;
          split_tf32_4(xh[i], hi, lo);
          xh[i] = hi;
          xl[i] = lo;
        }
        fence_proxy_async();  // the wgmma reads them through the async proxy
        mbar_arrive(&ready[stage]);
        if (++stage == a.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, txy = a.tx * a.ty;
  const int box = a.tn * txy;
  const uint32_t ring_u = smem_u32(ring);
  int stage = 0, phase = 0;
  for (int u = u0; u < u1; ++u) {
    const ConvTile s0 = conv_subtile(a, u);
    float acc[NW / 2], d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    bool fresh = true;  // d holds no product of this chain yet
    int held = -1;      // a stage the running wgmma still reads
    for (int q = 0; q < steps; ++q) {
      int t, j, rs, sh;
      conv_step(a, q, t, j, rs, sh);
      // k8 steps that hold channels of the tile (none: it adds nothing)
      const int ks = (max(0, min(32, sh + a.bc - 32 * j)) + 7) / 8;
      const uint32_t base = ring_u + stage * stage_bytes;
      // A: this warpgroup's 64 rows of the M side; B: the N side
      uint32_t ah, al, bh, bl;
      if (a.pos_m) {
        ah = base + wg * 64 * 128;
        al = base + xlo_off + wg * 64 * 128;
        bh = base + whi_off;
        bl = base + wlo_off;
      } else {
        ah = base + whi_off + wg * 64 * 128;
        al = base + wlo_off + wg * 64 * 128;
        bh = base;
        bl = base + xlo_off;
      }
      mbar_wait(&ready[stage], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ks) {
          wgmma_tf32<NW>(d, conv_desc(al, kk), conv_desc(bh, kk), !fresh);
          wgmma_tf32<NW>(d, conv_desc(ah, kk), conv_desc(bl, kk), 1);
          wgmma_tf32<NW>(d, conv_desc(ah, kk), conv_desc(bh, kk), 1);
          fresh = false;
        }
      }
      wgmma_commit();
      if (q + 1 == steps || (q + 1) % CONV_CHAIN == 0) {
        // the chain ends: its sum joins the accumulator in float32
        wgmma_wait<0>();
        fence_regs(d);
        if (held >= 0) mbar_arrive(&empty[held]);
        mbar_arrive(&empty[stage]);
        held = -1;
        if (!fresh) {
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[i] += d[i];
        }
        fresh = true;
      } else {
        // this step's products run on; the step before is done with its
        // stage
        wgmma_wait<1>();
        if (held >= 0) mbar_arrive(&empty[held]);
        held = stage;
      }
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- the result: straight from the accumulators to O, while the
    // loader fills the ring for the next sub-tile ----
    // accumulator i of a thread: M row 16 warp + lane / 4 + 8 ((i >> 1) &
    // 1), N column 8 (i >> 2) + 2 (lane & 3) + (i & 1)
    if (a.pos_m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wg * 64 + 16 * warp + lane / 4 + 8 * h;
        const int pn = p / txy, px = (p - pn * txy) / a.ty, py = p % a.ty;
        if (p >= box || pn >= s0.an || px >= s0.ax || py >= s0.ay) continue;
        float* dst = O + (((size_t)(s0.n0 + pn) * a.XO + s0.x0 + px) * a.YO +
                          s0.y0 + py) * a.K + s0.k0;
#pragma unroll
        for (int g = 0; g < NW / 8; ++g) {
          const int c = 8 * g + 2 * (lane & 3);
          const float v0 = acc[4 * g + 2 * h], v1 = acc[4 * g + 2 * h + 1];
          if (a.vec && c + 1 < s0.ak) {
            *reinterpret_cast<float2*>(dst + c) = make_float2(v0, v1);
          } else {
            if (c < s0.ak) dst[c] = v0;
            if (c + 1 < s0.ak) dst[c + 1] = v1;
          }
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = wg * 64 + 16 * warp + lane / 4 + 8 * h;
        if (c >= s0.ak) continue;
#pragma unroll
        for (int i = 0; i < NW / 4; ++i) {
          const int p = 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
          const int pn = p / txy, px = (p - pn * txy) / a.ty, py = p % a.ty;
          if (p >= box || pn >= s0.an || px >= s0.ax || py >= s0.ay)
            continue;
          O[(((size_t)(s0.n0 + pn) * a.XO + s0.x0 + px) * a.YO + s0.y0 +
             py) * a.K + s0.k0 + c] = acc[4 * (i >> 1) + 2 * h + (i & 1)];
        }
      }
    }
  }
}

template <int NW>
cudaError_t launch_conv(const CUtensorMap& tx, const CUtensorMap& thi,
                        const CUtensorMap& tlo, float* O, const ConvArgs& a,
                        dim3 grid, size_t smem, cudaStream_t s) {
  static bool smem_set = false;
  if (smem > (size_t)CONV_SMEM_MAX) return cudaErrorInvalidValue;
  // opt in once to the most conv_launch asks for, whatever this call needs
  cudaError_t err =
      allow_smem(conv_kernel_wgmma<NW>, CONV_SMEM_MAX, smem_set);
  if (err != cudaSuccess) return err;
  conv_kernel_wgmma<NW><<<grid, 128 * (a.cw + 1), smem, s>>>(tx, thi, tlo, O,
                                                            a);
  return cudaGetLastError();
}

// The weights for conv_kernel_wgmma: W [K, C, R*S] -> hi and lo, each
// [K, T, RS, bcp], C tile t's channels at [sh, sh + bc) (sh = t*bc mod 4,
// where the tile's pieces start) and zeros around them; for a folded input
// (fs = S > 0: RS = R, one C tile) tap r's row holds W[k, c, r, s] at
// 4 s + c.  Runs once a conv call, so a weight written between calls is
// always seen.  Bound: bytes (W read once, hi and lo written once).
struct ConvWeightArgs {
  int K, C, RS, T, bc, bcp, fs;
};

__global__ void conv_kernel_weights(const float* __restrict__ W,
                                    float* __restrict__ hi,
                                    float* __restrict__ lo,
                                    ConvWeightArgs a) {
  const size_t total = (size_t)a.K * a.T * a.RS * a.bcp;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int cc = o % a.bcp;
    const size_t row = o / a.bcp;
    const int rs = row % a.RS;
    const size_t kt = row / a.RS;
    const int t = kt % a.T;
    const size_t k = kt / a.T;
    float v = 0.f;
    if (a.fs > 0) {
      const int s = cc / 4, c = cc % 4;
      if (c < a.C && s < a.fs) v = W[((k * a.C + c) * a.RS + rs) * a.fs + s];
    } else {
      const int c = cc - ((t * a.bc) & 3);
      if (c >= 0 && c < a.bc)
        v = W[(k * a.C + (size_t)t * a.bc + c) * a.RS + rs];
    }
    const float h = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
    hi[o] = h;
    lo[o] = v - h;
  }
}

// ---------------------------------------------------------------------------
// pool: max over an R x S window with a stride, from -1e30, channels-last
// (I [N, XI, YI, C] at a channel pitch cp, O [N, XO, YO, C])
// Replaces src/repro/lower/exec.py _run_pool.  Bound: bytes.  Design: one
// thread per output element, neighbouring threads on neighbouring channels,
// so every window row a warp reads is one run of channels.
// ---------------------------------------------------------------------------

struct PoolArgs {
  int N, C, XI, YI, XO, YO, R, S, stride, cp;
};

__global__ void pool_kernel(const float* __restrict__ I,
                            float* __restrict__ O, PoolArgs a) {
  const size_t total = (size_t)a.N * a.XO * a.YO * a.C;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int c = o % a.C;
    const size_t pos = o / a.C;
    const int y = pos % a.YO, x = (pos / a.YO) % a.XO;
    const size_t n = pos / ((size_t)a.XO * a.YO);
    const float* in = I + ((n * a.XI + (size_t)x * a.stride) * a.YI +
                           (size_t)y * a.stride) * a.cp + c;
    float m = -1e30f;
    for (int r = 0; r < a.R; ++r)
      for (int s = 0; s < a.S; ++s)
        m = fmaxf(m, in[((size_t)r * a.YI + s) * a.cp]);
    O[o] = m;
  }
}

// ---------------------------------------------------------------------------
// eltwise: O = X0 + X1 + ... (1 to 8 operands a launch, added in operand
// order; the wrapper chains launches for more, each taking the running sum
// as its operand 0)
// Replaces src/repro/lower/exec.py _run_eltwise.  Bound: bytes (each operand
// read once, O written once, 3.35 TB/s).  To reach it, each SM needs many
// bytes in flight.  Design: the operand count is a template parameter, so the
// body unrolls with no branch; a block owns a segment of ELT_THREADS x
// ELT_V float4s (16-byte loads and stores), a thread ELT_V of them from
// every operand, all loads issued before the first add; __launch_bounds__
// asks for ELT_OCC blocks an SM at two operands, half that per doubling of
// the operands.  A scalar tail takes numel % 4; operands or an output that
// are not 16-byte aligned take the scalar path of the same kernel (VEC
// false).  The grid is whole waves: one block a segment, rounded up to a
// multiple of the blocks the SMs hold at once; the blocks past the work exit
// at once.  The sum is taken in the plain version's order, so the two agree
// bit for bit.  Measured on ResNet-50 b64's plans (NVIDIA H100 80GB HBM3,
// PERF.md): short blocks of 4 float4s a thread come within 1% of torch.add,
// where one persistent wave striding over the segments lost 5%, and the
// streaming cache hints (ld.global.nc, st.global.cs) lost 2% to the plain
// loads and stores used here.
// ---------------------------------------------------------------------------

constexpr int ELT_MAX_OPS = 8;
constexpr int ELT_THREADS = 256;  // threads a block
constexpr int ELT_V = 4;          // float4s a thread takes of each operand
constexpr int ELT_OCC = 4;        // blocks an SM at two operands

struct EltArgs {
  const float* x[ELT_MAX_OPS];
  long long numel;
};

template <int NOPS>
constexpr int elt_occupancy() {
  return NOPS <= 2 ? ELT_OCC : NOPS <= 4 ? ELT_OCC / 2 : ELT_OCC / 4;
}

template <int NOPS, bool VEC>
__global__ void __launch_bounds__(ELT_THREADS, elt_occupancy<NOPS>())
eltwise_kernel(EltArgs a, float* __restrict__ O) {
  const long long n4 = VEC ? a.numel / 4 : 0;
  for (long long seg = (long long)blockIdx.x * ELT_THREADS * ELT_V; seg < n4;
       seg += (long long)gridDim.x * ELT_THREADS * ELT_V) {
    float4 v[NOPS][ELT_V];
#pragma unroll
    for (int o = 0; o < NOPS; ++o)
#pragma unroll
      for (int k = 0; k < ELT_V; ++k) {
        const long long i = seg + threadIdx.x + k * ELT_THREADS;
        v[o][k] = i < n4 ? reinterpret_cast<const float4*>(a.x[o])[i]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int k = 0; k < ELT_V; ++k) {
      const long long i = seg + threadIdx.x + k * ELT_THREADS;
      if (i >= n4) continue;
      float4 s = v[0][k];
#pragma unroll
      for (int o = 1; o < NOPS; ++o) {
        s.x = s.x + v[o][k].x;
        s.y = s.y + v[o][k].y;
        s.z = s.z + v[o][k].z;
        s.w = s.w + v[o][k].w;
      }
      reinterpret_cast<float4*>(O)[i] = s;
    }
  }
  // the scalar tail (numel % 4 with VEC), or every element
  for (long long i = 4 * n4 + (long long)blockIdx.x * ELT_THREADS +
                     threadIdx.x;
       i < a.numel; i += (long long)gridDim.x * ELT_THREADS) {
    float s = a.x[0][i];
#pragma unroll
    for (int o = 1; o < NOPS; ++o) s = s + a.x[o][i];
    O[i] = s;
  }
}

// whole waves: one block a segment, rounded up to a multiple of the blocks
// the SMs hold at once
template <int NOPS, bool VEC>
cudaError_t launch_eltwise(const EltArgs& a, float* O, cudaStream_t s) {
  static long long wave = 0;
  if (wave == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, eltwise_kernel<NOPS, VEC>, ELT_THREADS, 0);
    if (err != cudaSuccess) return err;
    wave = (long long)sms * per_sm;
  }
  const long long per_seg = VEC ? 4LL * ELT_THREADS * ELT_V : ELT_THREADS;
  long long blocks = (a.numel + per_seg - 1) / per_seg;
  if (blocks > wave) blocks = (blocks + wave - 1) / wave * wave;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL / wave * wave;
  eltwise_kernel<NOPS, VEC>
      <<<(unsigned)(blocks > 0 ? blocks : 1), ELT_THREADS, 0, s>>>(a, O);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t eltwise_by_ops(int n, const EltArgs& a, float* O,
                           cudaStream_t s) {
  switch (n) {
    case 1: return launch_eltwise<1, VEC>(a, O, s);
    case 2: return launch_eltwise<2, VEC>(a, O, s);
    case 3: return launch_eltwise<3, VEC>(a, O, s);
    case 4: return launch_eltwise<4, VEC>(a, O, s);
    case 5: return launch_eltwise<5, VEC>(a, O, s);
    case 6: return launch_eltwise<6, VEC>(a, O, s);
    case 7: return launch_eltwise<7, VEC>(a, O, s);
    case 8: return launch_eltwise<8, VEC>(a, O, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// attention: O[n] = softmax(Q[n] K[n]^T * D^-1/2) V[n], non-causal, per head
// n; Q [N, X, D], K and V [N, C, D], float32.  The kernels are instantiated
// at D = 16, 32, 64, 128 and 256; another D up to 256 runs at the next of
// them: the wrapper zero-pads Q, K and V (zero columns add nothing to
// Q K^T and give zero output columns, which it slices off) and passes the
// scale of its own D.
// Replaces src/repro/lower/exec.py _run_attention.  Bound: operations,
// 4*N*X*C*D, at the 3xTF32 rate (165 TFLOP/s on the H100 SXM) on the
// tensor-core path; the bytes (each of Q, K, V read once, O written once)
// take under half of that at D = 64.
// Both paths share the plan contract: the Pallas kernel keeps (acc, m, l)
// in output buffers across revisits of the grid, because its grid runs in
// order.  Here blocks run in no order, so the plan's output axes (N, X) are
// the CUDA grid (one head per block row; a plan tile of bx queries spans
// ceil(bx / 64) blocks of 64 query rows) and the KV axis C, wherever it sits
// in the plan's grid, is a loop inside the block over the plan's C tiles in
// plan order, each staged as sub-tiles of 64 keys (masked at the tile's
// ragged edge: p = 0).  (acc, m, l) stay in registers, and
// acc / max(l, 1e-30) is the epilogue.  D is a template parameter.
//
// attention_mma_kernel (D = 16, 32, 64, 128): flash-style on mma.sync
// m16n8k8 in 3xTF32.  Four warps, each owns 16 query rows.  Q is staged
// once; K and V tiles of 64 keys go through a 2-stage cp.async ring (16-byte
// copies, zero-filled past the tile's valid keys), at a row pitch of D + 4
// (conflict-free fragment reads).  Each 64-key stage is two online-softmax
// steps of 32 keys, which keeps S (16 x 32 a warp, hi*hi and corrections
// apart) at 32 registers a thread beside O's D/2:
// - S = Q K^T in 3xTF32 (Q and K split on the fragment load), times
//   D^-1/2; the row max and sum over the accumulator's quad with
//   shuffles; p = expf(s - m) (expf, not __expf: the limit is 1e-5).
// - O = O * alpha + P V in 3xTF32, P V taken per step from zero and added
//   to O in float32 (a chain of tensor-core accumulations over every key
//   loses low bits on each add and broke 1e-5 at 4096 keys).  The m16n8
//   accumulator of S does not
//   have the m16n8k8 A-fragment layout of tf32 (lane (g, t) holds keys 2t
//   and 2t + 1 of its rows, the A fragment wants keys t and t + 4).  No
//   shuffle and no trip through shared memory: the sum over the 8 keys of a
//   k-step may take them in any order, so the kernel takes A column t as
//   key 2t and column t + 4 as key 2t + 1, and reads V's B fragment rows in
//   that same order (rows 2t and 2t + 1).  The fragments stay in registers.
// At D = 256 Q and the ring of 64-key K and V tiles would take 333 KB of
// shared memory, past the 227 KB a block may have, and O 128 of a thread's
// 255 registers before S and the fragments, so D = 256 keeps
// attention_kernel below: the FMA tile of online_softmax.cuh on the CUDA
// cores (67 TFLOP/s), 64 query rows a block.
// ---------------------------------------------------------------------------

struct AttnArgs {
  int N, X, C, bx, bc, sub_x;
  float scale;
};

constexpr int AT_BQ = 64, AT_BK = 64, AT_STEP = 32, AT_THREADS = 128;

template <int D>
constexpr size_t attention_mma_smem() {
  return (size_t)(AT_BQ + 2 * 2 * AT_BK) * (D + 4) * sizeof(float);
}

// rows [0, valid) of `rows` rows of D floats into `dst` at pitch D + 4,
// the rest zero-filled
template <int D>
__device__ __forceinline__ void at_stage(float* dst, const float* src,
                                         int rows, int valid, int tid) {
  constexpr int P = D + 4, Q4 = D / 4;
  for (int idx = tid; idx < rows * Q4; idx += AT_THREADS) {
    const int r = idx / Q4, d = 4 * (idx - r * Q4);
    const bool ok = r < valid;
    cp_async16(dst + r * P + d, ok ? src + (size_t)r * D + d : src,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(AT_THREADS, 1)
attention_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     AttnArgs a) {
  constexpr int P = D + 4, DT = D / 8, NS = AT_STEP / 8;
  extern __shared__ float4 at_smem4[];
  float* qs = reinterpret_cast<float*>(at_smem4);
  float* kv = qs + AT_BQ * P;  // stage b: K tile, then V tile

  const int n = blockIdx.y;
  int x0, ax;
  sub_tile(blockIdx.x, a.sub_x, a.bx, AT_BQ, x0, ax);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, wrow = warp * 16;
  const float* kg = k + (size_t)n * a.C * D;
  const float* vg = v + (size_t)n * a.C * D;
  const int per = (a.bc + AT_BK - 1) / AT_BK;  // key tiles a plan C tile
  const int steps = (a.C / a.bc) * per;
  auto tile_of = [&](int step, int& c0, int& nk) {
    const int ct = step / per;
    c0 = ct * a.bc + (step - ct * per) * AT_BK;
    nk = min(AT_BK, (ct + 1) * a.bc - c0);
  };
  auto load = [&](int step) {
    int c0, nk;
    tile_of(step, c0, nk);
    float* ks = kv + (step % 2) * 2 * AT_BK * P;
    at_stage<D>(ks, kg + (size_t)c0 * D, AT_BK, nk, tid);
    at_stage<D>(ks + AT_BK * P, vg + (size_t)c0 * D, AT_BK, nk, tid);
  };

  at_stage<D>(qs, q + ((size_t)n * a.X + x0) * D, AT_BQ, ax, tid);
  load(0);
  cp_async_commit();

  float acc[DT][4];  // O's rows g and g + 8, columns 8 j + 2 t4 (+ 1)
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // this tile is in; the other buffer is consumed
    if (step + 1 < steps) load(step + 1);
    cp_async_commit();
    int c0, nk;
    tile_of(step, c0, nk);
    const float* ks = kv + (step % 2) * 2 * AT_BK * P;
    const float* vs = ks + AT_BK * P;

    for (int kb = 0; kb < nk; kb += AT_STEP) {  // online-softmax steps
      float sp[NS][4], sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] = sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        uint32_t ah[4], al[4];
        const float* qr = qs + (wrow + g) * P + kk + t4;
        split_tf32(qr[0], ah[0], al[0]);
        split_tf32(qr[8 * P], ah[1], al[1]);
        split_tf32(qr[4], ah[2], al[2]);
        split_tf32(qr[8 * P + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float* kr = ks + (kb + 8 * j + g) * P + kk + t4;
          uint32_t bh[2], bl[2];
          split_tf32(kr[0], bh[0], bl[0]);
          split_tf32(kr[4], bh[1], bl[1]);
          mma_3xtf32(sp[j], sc[j], ah, al, bh, bl);
        }
      }
      // scores of rows g (e = 0, 1) and g + 8 (e = 2, 3), key
      // kb + 8 j + 2 t4 + (e & 1); keys past the tile's edge do not count
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kb + 8 * j + 2 * t4 + (e & 1) < nk;
          sp[j][e] = ok ? (sp[j][e] + sc[j][e]) * a.scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], sp[j][e]);
        }
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mx[h] = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kb + 8 * j + 2 * t4 + (e & 1) < nk;
          sp[j][e] = ok ? expf(sp[j][e] - m[e >> 1]) : 0.f;
          ps[e >> 1] += sp[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        l[h] = l[h] * alpha[h] + ps[h];
      }
      // O = O * alpha + P V, one 8-column tile of O at a time: P V from
      // zero on the tensor cores (hi*hi and the corrections apart), added
      // in float32.  A column t is key 2t, column t + 4 key 2t + 1.
      uint32_t pah[NS][4], pal[NS][4];
#pragma unroll
      for (int kj = 0; kj < NS; ++kj) {
        split_tf32(sp[kj][0], pah[kj][0], pal[kj][0]);
        split_tf32(sp[kj][2], pah[kj][1], pal[kj][1]);
        split_tf32(sp[kj][1], pah[kj][2], pal[kj][2]);
        split_tf32(sp[kj][3], pah[kj][3], pal[kj][3]);
      }
      const float* vr = vs + (kb + 2 * t4) * P + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        float pp[4] = {0.f, 0.f, 0.f, 0.f}, pc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kj = 0; kj < NS; ++kj) {
          uint32_t bh[2], bl[2];
          split_tf32(vr[8 * kj * P + 8 * j], bh[0], bl[0]);
          split_tf32(vr[(8 * kj + 1) * P + 8 * j], bh[1], bl[1]);
          mma_3xtf32(pp, pc, pah[kj], pal[kj], bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = acc[j][e] * alpha[e >> 1] + (pp[e] + pc[e]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    if (row >= ax) continue;
    const float den = fmaxf(l[h], 1e-30f);
    float* orow = o + ((size_t)n * a.X + x0 + row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc[j][2 * h] / den, acc[j][2 * h + 1] / den);
  }
}

template <int D>
__global__ void __launch_bounds__(OS_THREADS)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 AttnArgs a) {
  using Row = SoftmaxRow<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + OS_BQ * Row::PITCH;
  float* vs = ks + OS_BK * Row::PITCH;

  const int n = blockIdx.y;
  int x0, ax;
  sub_tile(blockIdx.x, a.sub_x, a.bx, OS_BQ, x0, ax);
  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int row_lane = (tid & 31) & ~3;
  const float* kg = k + (size_t)n * a.C * D;
  const float* vg = v + (size_t)n * a.C * D;

  stage_rows<float, D, true>(qs, q + ((size_t)n * a.X + x0) * D, OS_BQ, ax,
                             tid);
  Row st;
  st.init();
  for (int ct = 0; ct < a.C / a.bc; ++ct) {              // plan C tiles
    const int c_end = (ct + 1) * a.bc;
    for (int c0 = ct * a.bc; c0 < c_end; c0 += OS_BK) {
      const int nk = min(OS_BK, c_end - c0);
      __syncthreads();  // the previous sub-tile's readers are done
      stage_rows<float, D, true>(ks, kg + (size_t)c0 * D, OS_BK, nk, tid);
      stage_rows<float, D, true>(vs, vg + (size_t)c0 * D, OS_BK, nk, tid);
      __syncthreads();
      // keys past the C tile's ragged edge get p = 0
      st.step(qs + row * Row::PITCH, ks, vs, sub, row_lane, a.scale,
              [nk](int j, float&) { return j < nk; });
    }
  }

  if (row >= ax) return;
  st.template store<float, true>(o + ((size_t)n * a.X + x0 + row) * D, sub);
}

// `mma`: the tensor-core path (D <= 128) or the FMA tile (D = 256)
template <int D, bool MMA>
cudaError_t launch_attention(const float* Q, const float* K, const float* V,
                             float* O, const AttnArgs& a, dim3 grid,
                             size_t smem, cudaStream_t stream) {
  static bool smem_set = false;
  if constexpr (MMA) {
    if (smem != attention_mma_smem<D>()) return cudaErrorInvalidValue;
    const cudaError_t err =
        allow_smem(attention_mma_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    attention_mma_kernel<D><<<grid, AT_THREADS, smem, stream>>>(Q, K, V, O,
                                                                a);
  } else {
    if (smem != online_softmax_smem<D>()) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(attention_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    attention_kernel<D><<<grid, OS_THREADS, smem, stream>>>(Q, K, V, O, a);
  }
  return cudaGetLastError();
}

unsigned grid_1d(size_t work, int threads) {
  const size_t blocks = (work + threads - 1) / threads;
  return (unsigned)(blocks < 65535u * 16u ? blocks : 65535u * 16u);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).  `p` is a host int64 array.
// ---------------------------------------------------------------------------

// p: FcArgs (16 values), then the grid (x, y, z); ws: the workspace
// [n_parts, N, K] when n_parts > 1, else unused
extern "C" int kapla_fc(const float* I, const float* W, float* O, float* ws,
                        const long long* p, void* stream) {
  static_assert(sizeof(FcArgs) == 16 * sizeof(int), "FcArgs layout");
  int v[16];
  for (int i = 0; i < 16; ++i) v[i] = (int)p[i];
  FcArgs a;
  memcpy(&a, v, sizeof(a));
  if (a.tk % 8 != 0 || a.tk < 8 || a.tk > FC_TK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)p[16], (unsigned)p[17], (unsigned)p[18]);
  cudaError_t err;
  switch (a.tk / 8) {
    case 1: err = launch_fc<1>(grid, s, I, W, O, ws, a); break;
    case 2: err = launch_fc<2>(grid, s, I, W, O, ws, a); break;
    case 3: err = launch_fc<3>(grid, s, I, W, O, ws, a); break;
    case 4: err = launch_fc<4>(grid, s, I, W, O, ws, a); break;
    case 5: err = launch_fc<5>(grid, s, I, W, O, ws, a); break;
    case 6: err = launch_fc<6>(grid, s, I, W, O, ws, a); break;
    case 7: err = launch_fc<7>(grid, s, I, W, O, ws, a); break;
    default: err = launch_fc<8>(grid, s, I, W, O, ws, a); break;
  }
  if (err != cudaSuccess) return (int)err;
  if (a.n_parts > 1) {
    size_t blocks = ((size_t)a.N * a.K + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    fc_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(ws, O, a);
  }
  return (int)cudaGetLastError();
}

// p: ConvArgs (31 values), then the input's XI, YI and channel pitch cp,
// the weights' T, the grid (x, y, z), the dynamic shared memory in bytes
// and the wgmma width NW; Whi and Wlo from kapla_conv_weights
extern "C" int kapla_conv(const float* I, const float* Whi, const float* Wlo,
                          float* O, const long long* p, void* stream) {
  constexpr int NA = sizeof(ConvArgs) / sizeof(int);
  static_assert(NA == 31, "ConvArgs layout");
  int v[NA];
  for (int i = 0; i < NA; ++i) v[i] = (int)p[i];
  ConvArgs a;
  memcpy(&a, v, sizeof(a));
  const long long XI = p[NA], YI = p[NA + 1], cp = p[NA + 2];
  const long long T = p[NA + 3], bcp = a.bcp;
  const dim3 grid((unsigned)p[NA + 4], (unsigned)p[NA + 5],
                  (unsigned)p[NA + 6]);
  const size_t smem = (size_t)p[NA + 7];
  const int nw = (int)p[NA + 8];
  const int st = a.stride, box = a.tn * a.tx * a.ty;
  const int mrows = 64 * a.cw;
  if (a.cw < 1 || a.cw > 2 || cp % 4 || bcp % 4 || a.stages < 2 ||
      a.xrows != (a.pos_m ? mrows : nw) || a.wrows != (a.pos_m ? nw : mrows) ||
      box > a.xrows || a.tk > (a.pos_m ? nw : mrows))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, thi, tlo;
  const cuuint64_t xdims[4] = {(cuuint64_t)cp, (cuuint64_t)YI,
                               (cuuint64_t)XI, (cuuint64_t)a.N};
  const cuuint64_t xstr[3] = {(cuuint64_t)cp * 4, (cuuint64_t)(YI * cp * 4),
                              (cuuint64_t)(XI * YI * cp * 4)};
  const cuuint32_t xbox[4] = {32, (cuuint32_t)(a.ty * a.sy),
                              (cuuint32_t)(a.tx * st), (cuuint32_t)a.tn};
  const cuuint32_t xest[4] = {1, (cuuint32_t)a.sy, (cuuint32_t)st, 1};
  const cuuint64_t wdims[4] = {(cuuint64_t)bcp, (cuuint64_t)(a.R * a.S),
                               (cuuint64_t)T, (cuuint64_t)a.K};
  const cuuint64_t wstr[3] = {(cuuint64_t)bcp * 4,
                              (cuuint64_t)(a.R * a.S * bcp * 4),
                              (cuuint64_t)(T * a.R * a.S * bcp * 4)};
  const cuuint32_t wbox[4] = {32, 1, 1, (cuuint32_t)a.wrows};
  const cuuint32_t west[4] = {1, 1, 1, 1};
  cudaError_t err;
  if ((err = make_map_f32_4d(&tx, I, xdims, xstr, xbox, xest)) ||
      (err = make_map_f32_4d(&thi, Whi, wdims, wstr, wbox, west)) ||
      (err = make_map_f32_4d(&tlo, Wlo, wdims, wstr, wbox, west)))
    return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nw) {
    case 8: return (int)launch_conv<8>(tx, thi, tlo, O, a, grid, smem, s);
    case 16: return (int)launch_conv<16>(tx, thi, tlo, O, a, grid, smem, s);
    case 24: return (int)launch_conv<24>(tx, thi, tlo, O, a, grid, smem, s);
    case 32: return (int)launch_conv<32>(tx, thi, tlo, O, a, grid, smem, s);
    case 48: return (int)launch_conv<48>(tx, thi, tlo, O, a, grid, smem, s);
    case 64: return (int)launch_conv<64>(tx, thi, tlo, O, a, grid, smem, s);
    case 96: return (int)launch_conv<96>(tx, thi, tlo, O, a, grid, smem, s);
    case 128: return (int)launch_conv<128>(tx, thi, tlo, O, a, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// p: ConvWeightArgs (K, C, RS, T, bc, bcp, fs); hi and lo [K, T, RS, bcp]
extern "C" int kapla_conv_weights(const float* W, float* hi, float* lo,
                                  const long long* p, void* stream) {
  ConvWeightArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
                   (int)p[5], (int)p[6]};
  const size_t total = (size_t)a.K * a.T * a.RS * a.bcp;
  conv_kernel_weights<<<grid_1d(total, 256), 256, 0, (cudaStream_t)stream>>>(
      W, hi, lo, a);
  return (int)cudaGetLastError();
}

// p: PoolArgs (N, C, XI, YI, XO, YO, R, S, stride, cp)
extern "C" int kapla_pool(const float* I, float* O, const long long* p,
                          void* stream) {
  PoolArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
             (int)p[5], (int)p[6], (int)p[7], (int)p[8], (int)p[9]};
  const size_t total = (size_t)a.N * a.C * a.XO * a.YO;
  pool_kernel<<<grid_1d(total, 256), 256, 0, (cudaStream_t)stream>>>(I, O,
                                                                       a);
  return (int)cudaGetLastError();
}

// p: n_ops (1..8), numel, vec (operands and O 16-byte aligned)
extern "C" int kapla_eltwise(const void* const* xs, float* O,
                             const long long* p, void* stream) {
  const int n = (int)p[0];
  EltArgs a;
  a.numel = p[1];
  if (n < 1 || n > ELT_MAX_OPS || a.numel < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < ELT_MAX_OPS; ++i)
    a.x[i] = i < n ? static_cast<const float*>(xs[i]) : nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(p[2] ? eltwise_by_ops<true>(n, a, O, s)
                    : eltwise_by_ops<false>(n, a, O, s));
}

// p: N, X, C, D (the instantiated head dim the operands are padded to), bx,
// bc, sub_x, the grid (x, y), the dynamic shared memory in bytes, and the
// path (1: attention_mma_kernel, 0: attention_kernel); f: the scale (of the
// layer's own head dim)
extern "C" int kapla_attention(const float* Q, const float* K, const float* V,
                               float* O, const long long* p, const double* f,
                               void* stream) {
  const int D = (int)p[3];
  AttnArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[4], (int)p[5],
             (int)p[6], (float)f[0]};
  const dim3 grid((unsigned)p[7], (unsigned)p[8]);
  const size_t smem = (size_t)p[9];
  const bool mma = p[10] != 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mma) {
    switch (D) {
      case 16:
        return (int)launch_attention<16, true>(Q, K, V, O, a, grid,
                                                      smem, st);
      case 32:
        return (int)launch_attention<32, true>(Q, K, V, O, a, grid,
                                                      smem, st);
      case 64:
        return (int)launch_attention<64, true>(Q, K, V, O, a, grid,
                                                      smem, st);
      case 128:
        return (int)launch_attention<128, true>(Q, K, V, O, a, grid,
                                                      smem, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D != 256) return (int)cudaErrorInvalidValue;
  return (int)launch_attention<256, false>(Q, K, V, O, a, grid, smem, st);
}
