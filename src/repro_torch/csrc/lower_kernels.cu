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
// the plan's order.
//
// All five take float32 and accumulate in float32.  fc, conv and attention
// run their products on the tensor cores in 3xTF32 (tf32_mma.cuh): three
// TF32 products per multiply-add, which keeps the 1e-5 parity with the plain
// versions that a single TF32 product (about three decimal digits) would
// break.  Attention at head dim 256 keeps the FMA tile of online_softmax.cuh
// on the CUDA cores (the tensor-core kernel's tiles would pass the shared
// memory and registers a block has there).  pool and eltwise move bytes and
// run on the CUDA cores.
// Launch geometry (sub-tile sizes, warp layout, channel chunk, C split,
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
// conv: O[N,K,XO,YO] = VALID conv of I[N,C,XI,YI] with W[K,C,R,S], stride
// Replaces src/repro/lower/exec.py _run_conv.  Bound: operations for every
// layer of ResNet-50 and AlexNet, at the 3xTF32 rate (495 TFLOP/s TF32 / 3
// products = 165 TFLOP/s on the H100 SXM); a 1x1 layer with few channels
// comes near the bytes.  The earlier kernel ran FMA on the CUDA cores (67
// TFLOP/s) in 4x4 register tiles and left most threads idle on the plans'
// 1x1 spatial tiles and narrow K tiles.
// Design: an implicit GEMM on mma.sync m16n8k8 in 3xTF32.  A block owns one
// output sub-tile of one plan tile (conv_launch covers each plan tile
// exactly once): M = its positions (tn images x tx rows x ty cols,
// flattened), N = its tk output channels, and the reduction (c, r, s) over
// the channels, C tile by C tile in plan order.  Four warps, laid out wm x wn
// over the block tile (16 MT positions x 8 NT channels a warp; conv_launch
// picks MT, NT and the layout from the plan tile, so a 16 x 128 tile runs
// one warp row of four warp columns and a K = 8 tile four warp rows).
// - Per channel chunk (cc channels, never straddling a plan C tile) the
//   block stages the halo'd input window of its positions,
//   [cc][tn][(tx-1)*stride+R][(ty-1)*stride+S] at a channel pitch of
//   cpitch, and the chunk's W[k0:k0+tk, c0:c0+cc, :, :], which is already
//   reduction-contiguous: the "col" B operand mma wants, [k][j] at pitch ldw
//   (ldw = 4 mod 8: conflict-free B reads).  A 3-stage ring of cp.async
//   copies (16 bytes for W where its rows are aligned, else 4; 4 for the
//   window rows, which are not aligned in general) overlaps the next chunks'
//   loads with this chunk's products; copies past the valid data zero-fill.
// - No im2col buffer: the A fragment of position p and reduction index
//   j = (c*R + r)*S + s is window[pbase[p] + off[j]], with pbase per thread
//   in registers and off[j] = c*cpitch + r*winy + s in a shared table.  The
//   chunk's reduction is padded to a multiple of 8 (jpad) with zero weights
//   (conv1: C = 3 at 7x7 or 11x11); padded entries read channel 0 or a
//   zero-filled channel, so they add exact zeros.
// - Per chunk, hi*hi and the corrections accumulate on the tensor cores in
//   separate registers from zero (at most 16 k-steps: a long chain of
//   tensor-core accumulations loses low bits on every add and broke 1e-5 on
//   r5b.b's 4608-deep reduction), then add into the C tile's sum in
//   float32; when a plan C tile ends its sum is added to the output
//   accumulator: the C tiles add in plan order, and two launches agree bit
//   for bit.
// ---------------------------------------------------------------------------

constexpr int CONV_THREADS = 128, CONV_STAGES = 3;
// the most dynamic shared memory conv_launch asks for (the H100's 227 KB)
constexpr int CONV_SMEM_MAX = 232448;

struct ConvArgs {
  int N, C, K, XI, YI, XO, YO, R, S, stride;
  int bn, bc, bk, bx, by;          // plan block
  int tn, tx, ty, tk, cc;          // CUDA sub-tile and channel chunk
  int sub_n, sub_k, sub_x, sub_y;  // sub-tiles per plan tile
  int wm, wn;                      // warps along positions / channels
  int jpad, ldw, cpitch, stage;    // chunk depth, W and window pitches,
                                   // floats a stage
  int spmax, vec;                  // window elements of one channel; W
                                   // copies of 16 bytes
};

// Channels [c0, c0 + nc) of plan C tile `q / cpt` (chunk `q % cpt`).
__device__ __forceinline__ void conv_chunk(const ConvArgs& a, int cpt, int q,
                                           int& c0, int& nc) {
  const int ct = q / cpt;
  c0 = ct * a.bc + (q - ct * cpt) * a.cc;
  nc = min(a.cc, (ct + 1) * a.bc - c0);
}

// Stage one chunk: the weights W[k0 + k, c0 .. c0 + nc, :, :] as [k][j] at
// pitch ldw (rows k >= ak and j >= nc*R*S zero), then the window of every
// channel of the chunk at pitch cpitch (channels >= nc zero).  `ib` and
// `wb` are the window's origin in I and the block's first weight row.  Each
// thread walks its elements with running (row, column) indices: no
// division in the loops.
__device__ __forceinline__ void conv_stage(float* ws, const float* I,
                                           const float* W, const float* ib,
                                           const float* wb, const int* spo,
                                           const ConvArgs& a, int bnw,
                                           int ak, int sp, int c0, int nc,
                                           int tid) {
  const int RS = a.R * a.S, row = nc * RS;
  const size_t plane_in = (size_t)a.XI * a.YI, wrow = (size_t)a.C * RS;
  const float* wc = wb + (size_t)c0 * RS;
  float* xs = ws + bnw * a.ldw;
  const int w_cols = a.vec ? a.jpad / 4 : a.jpad;
  const int w_dk = CONV_THREADS / w_cols, w_dj = CONV_THREADS % w_cols;
  int k = tid / w_cols, j = tid % w_cols;
  for (int idx = tid; idx < bnw * w_cols; idx += CONV_THREADS) {
    if (a.vec) {
      const int valid = k < ak ? max(0, min(4, row - 4 * j)) : 0;
      cp_async16(ws + k * a.ldw + 4 * j,
                 valid ? wc + (size_t)k * wrow + 4 * j : W, 4 * valid);
    } else {
      const bool ok = k < ak && j < row;
      cp_async4(ws + k * a.ldw + j, ok ? wc + (size_t)k * wrow + j : W,
                ok ? 4 : 0);
    }
    k += w_dk;
    j += w_dj;
    if (j >= w_cols) {
      j -= w_cols;
      ++k;
    }
  }
  const int x_dc = CONV_THREADS / sp, x_ds = CONV_THREADS % sp;
  int c = tid / sp, e = tid % sp;
  for (int idx = tid; idx < a.cc * sp; idx += CONV_THREADS) {
    const bool ok = c < nc;  // channels past a ragged chunk: zeros
    cp_async4(xs + c * a.cpitch + e,
              ok ? ib + (size_t)(c0 + c) * plane_in + spo[e] : I, ok ? 4 : 0);
    c += x_dc;
    e += x_ds;
    if (e >= sp) {
      e -= sp;
      ++c;
    }
  }
}

// Step s of a block's ring: its chunk s into stage s % CONV_STAGES.
__device__ __forceinline__ void conv_stage_step(
    float* sm, const float* I, const float* W, const float* ib,
    const float* wb, const int* spo, const ConvArgs& a, int bnw, int ak,
    int sp, int cpt, int s, int tid) {
  int c0, nc;
  conv_chunk(a, cpt, s, c0, nc);
  conv_stage(sm + (s % CONV_STAGES) * a.stage, I, W, ib, wb, spo, a, bnw,
             ak, sp, c0, nc, tid);
}

template <int MT, int NT>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv_kernel(const float* __restrict__ I, const float* __restrict__ W,
            float* __restrict__ O, ConvArgs a) {
  constexpr int BN_W = 8 * NT;  // channels a warp
  extern __shared__ float4 conv_smem4[];
  float* sm = reinterpret_cast<float*>(conv_smem4);
  int* off = reinterpret_cast<int*>(sm + CONV_STAGES * a.stage);  // [jpad]
  int* spo = off + a.jpad;  // [spmax]: window element -> input offset

  const int ny = (a.YO / a.by) * a.sub_y;
  int n0, an, k0, ak, x0, ax, y0, ay;
  sub_tile(blockIdx.x / ny, a.sub_x, a.bx, a.tx, x0, ax);
  sub_tile(blockIdx.x % ny, a.sub_y, a.by, a.ty, y0, ay);
  sub_tile(blockIdx.y, a.sub_k, a.bk, a.tk, k0, ak);
  sub_tile(blockIdx.z, a.sub_n, a.bn, a.tn, n0, an);
  const int RS = a.R * a.S, st = a.stride;
  const int winx = (ax - 1) * st + a.R, winy = (ay - 1) * st + a.S;
  const int sp = an * winx * winy;
  const int P = an * ax * ay;
  const int bnw = a.wn * BN_W;  // W rows staged (the block tile's width)
  const size_t plane_in = (size_t)a.XI * a.YI;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = (warp / a.wn) * 16 * MT, wcol = (warp % a.wn) * BN_W;

  for (int j = tid; j < a.jpad; j += CONV_THREADS) {
    const int c = j / RS, rs = j - c * RS, r = rs / a.S;
    off[j] = c < a.cc ? c * a.cpitch + r * winy + (rs - r * a.S) : 0;
  }
  for (int s = tid; s < sp; s += CONV_THREADS) {
    const int n = s / (winx * winy), rem = s - n * winx * winy;
    const int i = rem / winy;
    spo[s] = (int)((size_t)n * a.C * plane_in + (size_t)i * a.YI +
                   (rem - i * winy));
  }
  __syncthreads();  // the tables are read by the staging below

  const float* ib = I + (size_t)n0 * a.C * plane_in +
                    (size_t)x0 * st * a.YI + (size_t)y0 * st;
  const float* wb = W + (size_t)k0 * a.C * RS;
  const int cpt = (a.bc + a.cc - 1) / a.cc;  // chunks per plan C tile
  const int steps = (a.C / a.bc) * cpt;

  // window offset of each of this thread's A rows (g and g + 8 of each
  // 16-row tile); rows past the sub-tile read element 0 and are not stored
  int pb[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wrow + mt * 16 + g + 8 * h;
      pb[mt][h] = 0;
      if (p < P) {
        const int pn = p / (ax * ay), rem = p - pn * ax * ay;
        const int px = rem / ay, py = rem - px * ay;
        pb[mt][h] = (pn * winx + px * st) * winy + py * st;
      }
    }
  const bool active = wrow < P && wcol < ak;

  // acc: the output, C tile by C tile; tile: this C tile's partial sum
  float acc[MT][NT][4], tile[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = tile[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < CONV_STAGES - 1; ++s) {
    if (s < steps)
      conv_stage_step(sm, I, W, ib, wb, spo, a, bnw, ak, sp, cpt, s, tid);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<CONV_STAGES - 2>();
    __syncthreads();  // this chunk is in; the one before it is consumed
    if (step + CONV_STAGES - 1 < steps)
      conv_stage_step(sm, I, W, ib, wb, spo, a, bnw, ak, sp, cpt,
                      step + CONV_STAGES - 1, tid);
    cp_async_commit();

    int c0, nc;
    conv_chunk(a, cpt, step, c0, nc);
    const float* ws = sm + (step % CONV_STAGES) * a.stage;
    const float* xs = ws + bnw * a.ldw;
    if (active) {
      // the chunk's products accumulate on the tensor cores from zero (at
      // most 16 k-steps), then add into the tile's sum in float32: a long
      // chain of tensor-core accumulations loses low bits on every add
      float prt[MT][NT][4], cor[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) prt[mt][nt][e] = cor[mt][nt][e] = 0.f;
      const int depth = (nc * RS + 7) & ~7;
#pragma unroll 2
      for (int kk = 0; kk < depth; kk += 8) {
        const int o0 = off[kk + t4], o1 = off[kk + t4 + 4];
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_tf32(xs[pb[mt][0] + o0], ah[mt][0], al[mt][0]);
          split_tf32(xs[pb[mt][1] + o0], ah[mt][1], al[mt][1]);
          split_tf32(xs[pb[mt][0] + o1], ah[mt][2], al[mt][2]);
          split_tf32(xs[pb[mt][1] + o1], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* br = ws + (wcol + nt * 8 + g) * a.ldw + kk + t4;
          uint32_t bh[2], bl[2];
          split_tf32(br[0], bh[0], bl[0]);
          split_tf32(br[4], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(prt[mt][nt], cor[mt][nt], ah[mt], al[mt], bh, bl);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tile[mt][nt][e] += prt[mt][nt][e] + cor[mt][nt][e];
    }
    if (step % cpt == cpt - 1) {  // a plan C tile is done: add it in order
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] += tile[mt][nt][e];
            tile[mt][nt][e] = 0.f;
          }
    }
  }

  if (!active) return;
  const size_t hw = (size_t)a.XO * a.YO;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wrow + mt * 16 + g + 8 * h;
      if (p >= P) continue;
      const int pn = p / (ax * ay), rem = p - pn * ax * ay;
      const int px = rem / ay, py = rem - px * ay;
      float* dst = O + (size_t)(n0 + pn) * a.K * hw + (size_t)k0 * hw +
                   (size_t)(x0 + px) * a.YO + y0 + py;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = wcol + nt * 8 + 2 * t4 + e;
          if (k < ak) dst[(size_t)k * hw] = acc[mt][nt][2 * h + e];
        }
    }
}

template <int MT, int NT>
cudaError_t launch_conv(dim3 grid, size_t smem, cudaStream_t s,
                        const float* I, const float* W, float* O,
                        const ConvArgs& a) {
  static bool smem_set = false;
  if (smem > (size_t)CONV_SMEM_MAX) return cudaErrorInvalidValue;
  // opt in once to the most conv_launch asks for, whatever this call needs
  cudaError_t err = allow_smem(conv_kernel<MT, NT>, CONV_SMEM_MAX, smem_set);
  if (err != cudaSuccess) return err;
  conv_kernel<MT, NT><<<grid, CONV_THREADS, smem, s>>>(I, W, O, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pool: max over an R x S window with a stride, from -1e30
// Replaces src/repro/lower/exec.py _run_pool.  Bound: bytes.  Design: one
// thread per output element; neighbouring threads read neighbouring columns.
// ---------------------------------------------------------------------------

struct PoolArgs {
  int N, C, XI, YI, XO, YO, R, S, stride;
};

__global__ void pool_kernel(const float* __restrict__ I,
                            float* __restrict__ O, PoolArgs a) {
  const size_t total = (size_t)a.N * a.C * a.XO * a.YO;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int y = o % a.YO, x = (o / a.YO) % a.XO;
    const size_t nc = o / ((size_t)a.XO * a.YO);
    const float* in = I + nc * a.XI * a.YI +
                      (size_t)x * a.stride * a.YI + (size_t)y * a.stride;
    float m = -1e30f;
    for (int r = 0; r < a.R; ++r)
      for (int s = 0; s < a.S; ++s) m = fmaxf(m, in[r * a.YI + s]);
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

// p: ConvArgs (32 values), then the grid (x, y, z), the dynamic shared
// memory in bytes, and the warp tile (MT, NT)
extern "C" int kapla_conv(const float* I, const float* W, float* O,
                          const long long* p, void* stream) {
  constexpr int NA = sizeof(ConvArgs) / sizeof(int);
  static_assert(NA == 32, "ConvArgs layout");
  int v[NA];
  for (int i = 0; i < NA; ++i) v[i] = (int)p[i];
  ConvArgs a;
  memcpy(&a, v, sizeof(a));
  const dim3 grid((unsigned)p[NA], (unsigned)p[NA + 1], (unsigned)p[NA + 2]);
  const size_t smem = (size_t)p[NA + 3];
  const int mt = (int)p[NA + 4], nt = (int)p[NA + 5];
  if (a.wm * a.wn * 32 != CONV_THREADS || a.tk > a.wn * 8 * nt ||
      a.tn * a.tx * a.ty > a.wm * 16 * mt || a.jpad % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mt * 10 + nt) {
    case 11: return (int)launch_conv<1, 1>(grid, smem, s, I, W, O, a);
    case 12: return (int)launch_conv<1, 2>(grid, smem, s, I, W, O, a);
    case 13: return (int)launch_conv<1, 3>(grid, smem, s, I, W, O, a);
    case 14: return (int)launch_conv<1, 4>(grid, smem, s, I, W, O, a);
    case 21: return (int)launch_conv<2, 1>(grid, smem, s, I, W, O, a);
    case 22: return (int)launch_conv<2, 2>(grid, smem, s, I, W, O, a);
    case 23: return (int)launch_conv<2, 3>(grid, smem, s, I, W, O, a);
    case 24: return (int)launch_conv<2, 4>(grid, smem, s, I, W, O, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int kapla_pool(const float* I, float* O, const long long* p,
                          void* stream) {
  PoolArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
             (int)p[5], (int)p[6], (int)p[7], (int)p[8]};
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
