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
// All five take float32 and accumulate in float32.  conv, pool, eltwise and
// attention run FMA on the CUDA cores (attention through the FMA tile of
// online_softmax.cuh); fc runs on the tensor cores in 3xTF32, three TF32
// products per multiply-add, which keeps the 1e-5 parity with plain_fc that
// a single TF32 product (about three decimal digits) would break.
// Launch geometry (sub-tile sizes, channel chunk, C split, shared memory,
// grid) is computed by the Python wrappers in repro_torch/lower/exec.py and
// passed in an int64 parameter array; each entry point returns
// cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/backend.py does this).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "online_softmax.cuh"

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo exactly: hi keeps TF32's 19 leading bits, lo = x - hi is the
// rest, of which the tensor core reads the leading 19 bits as TF32 does.
// Two full-rate ALU ops (cvt.rna.tf32 runs at a quarter rate and made the
// split, not the products, the bottleneck).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
          mma_tf32(cor[j], al, bh);
          mma_tf32(cor[j], ah, bl);
          mma_tf32(prt[j], ah, bh);
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
// Replaces src/repro/lower/exec.py _run_conv.  Bound: operations (FP32 FMA
// on the CUDA cores) for the 3x3, 5x5, 7x7 and 11x11 layers; bytes for some
// 1x1 layers with few channels.
// Design: a block owns tk output channels x up to 4*pthr output positions
// (tn images x tx rows x ty cols) of one plan tile; each thread holds 4
// channels x 4 positions.  Per channel chunk it stages only the halo'd input
// window ((tx-1)*stride+R x (ty-1)*stride+S) and the chunk's weights in
// shared memory, then loops c, r, s inside.  Chunks never straddle a plan C
// tile, and the C tiles run in plan order.
// ---------------------------------------------------------------------------

struct ConvArgs {
  int N, C, K, XI, YI, XO, YO, R, S, stride;
  int bn, bc, bk, bx, by;        // plan block
  int tn, tx, ty, tk, cc;        // CUDA sub-tile and channel chunk
  int sub_n, sub_k, sub_x, sub_y;
  int kthr, pthr, ldw;           // threads along k / positions; W row pitch
};

__global__ void conv_kernel(const float* __restrict__ I,
                            const float* __restrict__ W,
                            float* __restrict__ O, ConvArgs a) {
  extern __shared__ float smem[];
  const int RS = a.R * a.S;
  const int ny = (a.YO / a.by) * a.sub_y;
  int n0, an, k0, ak, x0, ax, y0, ay;
  sub_tile(blockIdx.x / ny, a.sub_x, a.bx, a.tx, x0, ax);
  sub_tile(blockIdx.x % ny, a.sub_y, a.by, a.ty, y0, ay);
  sub_tile(blockIdx.y, a.sub_k, a.bk, a.tk, k0, ak);
  sub_tile(blockIdx.z, a.sub_n, a.bn, a.tn, n0, an);
  const int winx = (ax - 1) * a.stride + a.R;
  const int winy = (ay - 1) * a.stride + a.S;
  const int plane = an * winx * winy;        // one channel of the window
  float* w_s = smem;                         // [tk][ldw]: chunk's weights
  float* x_s = smem + a.tk * a.ldw;          // [cc][an][winx][winy]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int kq = tid % a.kthr, pq = tid / a.kthr;
  const int P = an * ax * ay;
  int pbase[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pq + i * a.pthr;
    pbase[i] = 0;
    if (p < P) {
      const int pn = p / (ax * ay), rem = p % (ax * ay);
      const int px = rem / ay, py = rem % ay;
      pbase[i] = (pn * winx + px * a.stride) * winy + py * a.stride;
    }
  }
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int ct = 0; ct < a.C / a.bc; ++ct) {              // plan C tiles
    const int c_end = (ct + 1) * a.bc;
    for (int c0 = ct * a.bc; c0 < c_end; c0 += a.cc) {
      const int nc = min(a.cc, c_end - c0);
      const int row = nc * RS;               // contiguous in W per k
      for (int idx = tid; idx < a.tk * row; idx += nthreads) {
        const int k = idx / row, j = idx % row;
        w_s[k * a.ldw + j] =
            k < ak ? W[(size_t)(k0 + k) * a.C * RS + (size_t)c0 * RS + j]
                   : 0.f;
      }
      for (int idx = tid; idx < nc * plane; idx += nthreads) {
        const int c = idx / plane;
        int rem = idx % plane;
        const int n = rem / (winx * winy);
        rem %= winx * winy;
        const int i = rem / winy, j = rem % winy;
        x_s[idx] = I[(((size_t)(n0 + n) * a.C + c0 + c) * a.XI +
                      x0 * a.stride + i) * a.YI + y0 * a.stride + j];
      }
      __syncthreads();
      const float* wk = w_s + kq * 4 * a.ldw;
      for (int c = 0; c < nc; ++c) {
        for (int r = 0; r < a.R; ++r) {
          for (int s = 0; s < a.S; ++s) {
            const int jw = (c * a.R + r) * a.S + s;
            const float w0 = wk[jw], w1 = wk[a.ldw + jw],
                        w2 = wk[2 * a.ldw + jw], w3 = wk[3 * a.ldw + jw];
            const int off = c * plane + r * winy + s;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float x = x_s[pbase[i] + off];
              part[i][0] = fmaf(x, w0, part[i][0]);
              part[i][1] = fmaf(x, w1, part[i][1]);
              part[i][2] = fmaf(x, w2, part[i][2]);
              part[i][3] = fmaf(x, w3, part[i][3]);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += part[i][j];
        part[i][j] = 0.f;
      }
  }
  const size_t hw = (size_t)a.XO * a.YO;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pq + i * a.pthr;
    if (p >= P) continue;
    const int pn = p / (ax * ay), rem = p % (ax * ay);
    const int px = rem / ay, py = rem % ay;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kq * 4 + j;
      if (k < ak)
        O[((size_t)(n0 + pn) * a.K + k0 + k) * hw +
          (size_t)(x0 + px) * a.YO + y0 + py] = acc[i][j];
    }
  }
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
// eltwise: O = X0 + X1 + ... (up to 8 operands, added in operand order)
// Replaces src/repro/lower/exec.py _run_eltwise.  Bound: bytes.  Design: one
// thread per element; the sum is taken in the same order as the plain
// version, so the two agree bit for bit.
// ---------------------------------------------------------------------------

constexpr int ELT_MAX_OPS = 8;

struct EltArgs {
  const float* x[ELT_MAX_OPS];
  int n_ops;
  long long numel;
};

__global__ void eltwise_kernel(EltArgs a, float* __restrict__ O) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.numel; i += (long long)gridDim.x * blockDim.x) {
    float acc = a.x[0][i];
#pragma unroll                  // constant indices keep a.x out of local memory
    for (int j = 1; j < ELT_MAX_OPS; ++j)
      if (j < a.n_ops) acc = acc + a.x[j][i];
    O[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// attention: O[n] = softmax(Q[n] K[n]^T * D^-1/2) V[n], non-causal, per head
// n; Q [N, X, D], K and V [N, C, D], float32.
// Replaces src/repro/lower/exec.py _run_attention.  Bound: operations,
// 4*N*X*C*D at 67 TFLOP/s FP32 (the bytes, each of Q, K, V read once and O
// written once, take a sixth of that at D = 64).  A right, simple kernel is
// all this version is: it runs on the CUDA cores; wgmma is later work.
// Design: the Pallas kernel keeps (acc, m, l) in output buffers across
// revisits of the grid, because its grid runs in order.  Here blocks run in
// no order, so the plan's output axes (N, X) are the CUDA grid (one head per
// block row; a plan tile of bx queries spans ceil(bx / 64) blocks of 64 query
// rows) and the KV axis C, wherever it sits in the plan's grid, is a loop
// inside the block over the plan's C tiles in plan order, each staged as
// sub-tiles of 64 keys (masked at the tile's ragged edge).  Each sub-tile is
// a step of the online-softmax tile that flash_kernel uses too
// (online_softmax.cuh), so (acc, m, l) stay in registers and
// acc / max(l, 1e-30) is the epilogue.  D is a template parameter.
// ---------------------------------------------------------------------------

struct AttnArgs {
  int N, X, C, bx, bc, sub_x;
  float scale;
};

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

template <int D>
cudaError_t launch_attention(const float* Q, const float* K, const float* V,
                             float* O, const AttnArgs& a, dim3 grid,
                             size_t smem, cudaStream_t stream) {
  static bool smem_set = false;
  if (smem != online_softmax_smem<D>()) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(attention_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  attention_kernel<D><<<grid, OS_THREADS, smem, stream>>>(Q, K, V, O, a);
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

extern "C" int kapla_conv(const float* I, const float* W, float* O,
                          const long long* p, void* stream) {
  static_assert(sizeof(ConvArgs) == 27 * sizeof(int), "ConvArgs layout");
  int v[27];
  for (int i = 0; i < 27; ++i) v[i] = (int)p[i];
  ConvArgs a;
  memcpy(&a, v, sizeof(a));
  dim3 grid((unsigned)p[27], (unsigned)p[28], (unsigned)p[29]);
  conv_kernel<<<grid, (unsigned)p[30], (size_t)p[31],
                (cudaStream_t)stream>>>(I, W, O, a);
  return (int)cudaGetLastError();
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

extern "C" int kapla_eltwise(const void* const* xs, float* O,
                             const long long* p, void* stream) {
  EltArgs a;
  a.n_ops = (int)p[0];
  a.numel = p[1];
  if (a.n_ops < 1 || a.n_ops > ELT_MAX_OPS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < ELT_MAX_OPS; ++i)
    a.x[i] = i < a.n_ops ? static_cast<const float*>(xs[i]) : nullptr;
  eltwise_kernel<<<grid_1d((size_t)a.numel, 256), 256, 0,
                   (cudaStream_t)stream>>>(a, O);
  return (int)cudaGetLastError();
}

extern "C" int kapla_attention(const float* Q, const float* K, const float* V,
                               float* O, const long long* p, void* stream) {
  const int D = (int)p[3];
  AttnArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[4], (int)p[5],
             (int)p[6], (float)(1.0 / sqrt((double)D))};
  const dim3 grid((unsigned)p[7], (unsigned)p[8]);
  const size_t smem = (size_t)p[9];
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return (int)launch_attention<16>(Q, K, V, O, a, grid, smem, st);
    case 32: return (int)launch_attention<32>(Q, K, V, O, a, grid, smem, st);
    case 64: return (int)launch_attention<64>(Q, K, V, O, a, grid, smem, st);
    case 128: return (int)launch_attention<128>(Q, K, V, O, a, grid, smem, st);
    case 256: return (int)launch_attention<256>(Q, K, V, O, a, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
