// Hand-written Hopper (sm_90a) kernels for the layer and network tiers of the
// lowering: fc, conv, max pool, the n-ary eltwise sum and attention.  Each
// runs one KernelPlan (repro_torch/lower/plan.py): the plan's output-indexing
// grid axes become the CUDA grid, and its reduction axis (C) becomes a loop
// inside the block, walked tile by tile in the plan's order.  Every C tile
// accumulates into a partial sum that is then added to the output
// accumulator, which is how the Pallas kernels accumulate into an output
// block across revisits (attention: every C tile is a step of the online
// softmax, whose state stays in registers).
//
// All five take float32, accumulate in float32 with FMA on the CUDA cores (no
// tensor cores: TF32 would break the 1e-5 parity with the plain versions).
// Launch geometry (sub-tile sizes, channel chunk, shared memory, grid) is
// computed by the Python wrappers in repro_torch/lower/exec.py and passed in
// an int64 parameter array; each entry point returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/backend.py does this).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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
// Replaces src/repro/lower/exec.py _run_fc.  Bound: operations for the large
// layers (AlexNet fc6/fc7), bytes of W for batch 64 at small K.  Design: a
// 64x64 output sub-tile per block, 4x4 per thread; the plan's C tiles are
// walked in order, each staged through shared memory in 32-deep slabs.
// ---------------------------------------------------------------------------

constexpr int FC_TN = 64, FC_TK = 64, FC_SLAB = 32, FC_THREADS = 256;

struct FcArgs {
  int N, C, K, bn, bc, bk, sub_n, sub_k;
};

__global__ void __launch_bounds__(FC_THREADS)
fc_kernel(const float* __restrict__ I, const float* __restrict__ W,
          float* __restrict__ O, FcArgs a) {
  __shared__ float xs[FC_SLAB][FC_TN + 1];               // I slab as [c][n]
  __shared__ __align__(16) float ws[FC_SLAB][FC_TK];     // W slab as [c][k]
  int n0, an, k0, ak;
  sub_tile(blockIdx.y, a.sub_n, a.bn, FC_TN, n0, an);
  sub_tile(blockIdx.x, a.sub_k, a.bk, FC_TK, k0, ak);
  const int tid = threadIdx.x, kq = tid % 16, nq = tid / 16;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int ct = 0; ct < a.C / a.bc; ++ct) {              // plan C tiles
    const int c_end = (ct + 1) * a.bc;
    for (int c0 = ct * a.bc; c0 < c_end; c0 += FC_SLAB) {
      const int nc = min(FC_SLAB, c_end - c0);
      for (int idx = tid; idx < FC_SLAB * FC_TN; idx += FC_THREADS) {
        const int n = idx / FC_SLAB, c = idx % FC_SLAB;
        xs[c][n] = (n < an && c < nc)
                       ? I[(size_t)(n0 + n) * a.C + c0 + c] : 0.f;
      }
      for (int idx = tid; idx < FC_SLAB * FC_TK; idx += FC_THREADS) {
        const int c = idx / FC_TK, k = idx % FC_TK;
        ws[c][k] = (k < ak && c < nc)
                       ? W[(size_t)(c0 + c) * a.K + k0 + k] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(&ws[c][kq * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = xs[c][nq + 16 * i];
          part[i][0] = fmaf(x, w.x, part[i][0]);
          part[i][1] = fmaf(x, w.y, part[i][1]);
          part[i][2] = fmaf(x, w.z, part[i][2]);
          part[i][3] = fmaf(x, w.w, part[i][3]);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = nq + 16 * i;
    if (n >= an) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kq * 4 + j;
      if (k < ak) O[(size_t)(n0 + n) * a.K + k0 + k] = acc[i][j];
    }
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

extern "C" int kapla_fc(const float* I, const float* W, float* O,
                        const long long* p, void* stream) {
  FcArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3],
           (int)p[4], (int)p[5], (int)p[6], (int)p[7]};
  dim3 grid((unsigned)p[8], (unsigned)p[9]);
  fc_kernel<<<grid, FC_THREADS, 0, (cudaStream_t)stream>>>(I, W, O, a);
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
