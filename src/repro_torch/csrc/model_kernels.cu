// Hand-written Hopper (sm_90a) kernels for the model zoo's prefill: flash
// attention (dense and hybrid blocks) and the Mamba2 SSD intra-chunk term
// (Mamba2 blocks).
//
// Both take float32 or bfloat16 activations, compute and accumulate in
// float32 with FMA on the CUDA cores, and write the output in the input's
// type.  No tensor cores yet: this is the simple, right version; wgmma and
// TMA are later work (PERF.md has each kernel's time beside its bound).
// Each entry point takes a host int64 parameter array (and flash a host
// double array for the scale and soft-cap), launches on the given stream and
// returns cudaGetLastError().  The Python wrappers (repro_torch/kernels/
// flash_attention.py and ssd_scan.py) check shapes, types and contiguity.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/backend.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

// ---------------------------------------------------------------------------
// flash attention: o = softmax(mask(softcap(q k^T * scale))) v, per head,
// GQA head h reading KV head h / (H / KV); queries right-aligned into the
// keys (query row r sits at absolute position r + Sk - Sq).
// Replaces src/repro/kernels/flash_attention.py flash_attention and
// _flash_kernel.  Bound: in bf16 at the serve shapes, operations on the
// tensor cores; this version runs on the CUDA cores, so it is far from that
// bound.  Design: one block per (b*H + h, 64-query tile), looping over the
// key tiles of 64 with the online-softmax tile of online_softmax.cuh (K and V
// staged as float32, (acc, m, l) in registers).  Tiles wholly above the
// causal diagonal or left of the window are skipped (their p is 0, so
// skipping is exact); the mask zeroes p of the rest.
// ---------------------------------------------------------------------------

struct FlashArgs {
  int B, H, KV, Sq, Sk, causal, window;
  float scale, softcap;
};

template <typename T, int D>
__global__ void __launch_bounds__(OS_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, FlashArgs a) {
  using Row = SoftmaxRow<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + OS_BQ * Row::PITCH;
  float* vs = ks + OS_BK * Row::PITCH;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.KV);
  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int row_lane = (tid & 31) & ~3;
  const int q0 = blockIdx.x * OS_BQ;
  const int q_offset = a.Sk - a.Sq;
  const T* qg = q + (size_t)bh * a.Sq * D;
  const T* kg = k + (size_t)(b * a.KV + hk) * a.Sk * D;
  const T* vg = v + (size_t)(b * a.KV + hk) * a.Sk * D;

  stage_rows<T, D, false>(qs, qg + (size_t)q0 * D, OS_BQ, a.Sq - q0, tid);

  // key tiles that can hold an unmasked key for some row of this block
  const int qlo = q0 + q_offset;
  const int qhi = min(q0 + OS_BQ, a.Sq) - 1 + q_offset;
  int kt_begin = 0, kt_end = (a.Sk + OS_BK - 1) / OS_BK;
  if (a.causal) kt_end = min(kt_end, max(qhi, 0) / OS_BK + 1);
  if (a.window > 0) kt_begin = max(0, qlo - a.window + 1) / OS_BK;

  const int qpos = q0 + row + q_offset;
  Row st;
  st.init();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * OS_BK;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, D, false>(ks, kg + (size_t)k0 * D, OS_BK, a.Sk - k0, tid);
    stage_rows<T, D, false>(vs, vg + (size_t)k0 * D, OS_BK, a.Sk - k0, tid);
    __syncthreads();
    // soft-cap, then the mask
    st.step(qs + row * Row::PITCH, ks, vs, sub, row_lane, a.scale,
            [&](int j, float& x) {
              const int kpos = k0 + j;
              if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
              bool ok = kpos < a.Sk;
              if (a.causal) ok = ok && kpos <= qpos;
              if (a.window > 0) ok = ok && kpos > qpos - a.window;
              return ok;
            });
  }

  if (q0 + row >= a.Sq) return;
  st.template store<T, false>(o + ((size_t)bh * a.Sq + q0 + row) * D, sub);
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* o, const FlashArgs& a, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t smem = online_softmax_smem<D>();
  cudaError_t err = allow_smem(flash_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.Sq + OS_BQ - 1) / OS_BQ), (unsigned)(a.B * a.H));
  flash_kernel<T, D><<<grid, OS_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t flash_by_dim(int D, const void* q, const void* k, const void* v,
                         void* o, const FlashArgs& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_flash<T, 16>(q, k, v, o, a, stream);
    case 32: return launch_flash<T, 32>(q, k, v, o, a, stream);
    case 64: return launch_flash<T, 64>(q, k, v, o, a, stream);
    case 128: return launch_flash<T, 128>(q, k, v, o, a, stream);
    case 256: return launch_flash<T, 256>(q, k, v, o, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// SSD intra-chunk term (Mamba2):
//   y[l] = sum_{m <= l} (C[l] . B[m]) * exp(acum[l] - acum[m]) * dt[m] * x[m]
// per (b, h, chunk); B and C are shared across heads (G = 1).
// Replaces src/repro/kernels/ssd_scan.py ssd_intra_chunk and
// _ssd_intra_kernel.  Bound: operations (two chained Lc x Lc products per
// block against one read of a few KB); float32 on the CUDA cores, since
// TF32 would change the operands.  Design: one block per (b*H + h, chunk),
// 256 threads as a 16 x 16 grid.  Phase 1 forms the [Lc, Lc] scores C B^T,
// 8 x 8 per thread, staging C and B through shared memory 32 state columns
// at a time; then applies the decay, dt and the causal mask, evaluating
// exp only on and below the diagonal (above it exp overflows to inf and
// inf * 0 would give NaN), and writes the scores to shared memory (64 KB,
// dynamic).  Phase 2 stages x into the space C and B used and forms
// y = scores @ x, 8 x 4 per thread.  Takes Lc <= 128 and P <= 64 (the
// models use Lc = 128, P = 64); any state width N.
// ---------------------------------------------------------------------------

constexpr int SSD_L = 128, SSD_P = 64, SSD_NB = 32, SSD_THREADS = 256;
constexpr int SSD_SPITCH = SSD_L + 1;  // scores row pitch
constexpr int SSD_CPITCH = SSD_L + 4;  // staged C^T / B^T row pitch
constexpr size_t SSD_SMEM =
    (size_t)(SSD_L * SSD_SPITCH + 2 * SSD_NB * SSD_CPITCH) * sizeof(float);
static_assert(SSD_L * SSD_P <= 2 * SSD_NB * SSD_CPITCH,
              "x must fit where C and B were staged");

struct SsdArgs {
  int B, H, NC, Lc, P, N;
};

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ acum,
                 const float* __restrict__ bmat,
                 const float* __restrict__ cmat, T* __restrict__ y,
                 SsdArgs a) {
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);  // [SSD_L][SSD_SPITCH]
  float* stage = sc + SSD_L * SSD_SPITCH;
  float* cs = stage;                        // C^T chunk [SSD_NB][SSD_CPITCH]
  float* bs = stage + SSD_NB * SSD_CPITCH;  // B^T chunk
  float* xs = stage;                        // x [SSD_L][SSD_P], phase 2

  const int ch = blockIdx.x, bh = blockIdx.y, b = bh / a.H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = ((size_t)bh * a.NC + ch) * a.Lc;  // into x, dt, acum
  const float* cg = cmat + ((size_t)b * a.NC + ch) * a.Lc * a.N;
  const float* bg = bmat + ((size_t)b * a.NC + ch) * a.Lc * a.N;

  // phase 1: scores[l][m] = C[l] . B[m] for l = ty + 16 i, m = tx + 16 j
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < a.N; n0 += SSD_NB) {
    __syncthreads();
    for (int idx = tid; idx < SSD_L * SSD_NB; idx += SSD_THREADS) {
      const int r = idx / SSD_NB, n = idx % SSD_NB;
      const bool in = r < a.Lc && n0 + n < a.N;
      const size_t off = (size_t)r * a.N + n0 + n;
      cs[n * SSD_CPITCH + r] = in ? cg[off] : 0.f;
      bs[n * SSD_CPITCH + r] = in ? bg[off] : 0.f;
    }
    __syncthreads();
    for (int n = 0; n < SSD_NB; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] = cs[n * SSD_CPITCH + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[n * SSD_CPITCH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
  }

  // decay, dt and the causal mask; exp only where l >= m
  float al[8], am[8], dm[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    al[i] = r < a.Lc ? acum[row0 + r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = tx + 16 * j;
    am[j] = r < a.Lc ? acum[row0 + r] : 0.f;
    dm[j] = r < a.Lc ? dt[row0 + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int mm = tx + 16 * j;
      float val = 0.f;
      if (mm <= l && l < a.Lc) val = acc[i][j] * expf(al[i] - am[j]) * dm[j];
      sc[l * SSD_SPITCH + mm] = val;
    }
  }
  __syncthreads();  // scores written; C and B no longer read

  const T* xg = x + row0 * a.P;
  for (int idx = tid; idx < SSD_L * SSD_P; idx += SSD_THREADS) {
    const int r = idx / SSD_P, p = idx % SSD_P;
    xs[idx] = r < a.Lc && p < a.P ? to_f32(xg[(size_t)r * a.P + p]) : 0.f;
  }
  __syncthreads();

  // phase 2: y[l][p] = sum_m scores[l][m] x[m][p], l = ty + 16 i, p = tx + 16 j
  float yacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
  for (int mm = 0; mm < a.Lc; ++mm) {
    float xv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = xs[mm * SSD_P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sv = sc[(ty + 16 * i) * SSD_SPITCH + mm];
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(sv, xv[j], yacc[i][j]);
    }
  }
  T* yg = y + row0 * a.P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = ty + 16 * i;
    if (l >= a.Lc) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < a.P) yg[(size_t)l * a.P + p] = from_f32<T>(yacc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_ssd(const void* x, const float* dt, const float* acum,
                       const float* bmat, const float* cmat, void* y,
                       const SsdArgs& a, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t err = allow_smem(ssd_intra_kernel<T>, SSD_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)a.NC, (unsigned)(a.B * a.H));
  ssd_intra_kernel<T><<<grid, SSD_THREADS, SSD_SMEM, stream>>>(
      static_cast<const T*>(x), dt, acum, bmat, cmat, static_cast<T*>(y), a);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).  dtype code: 0 float32, 1 bfloat16.
// ---------------------------------------------------------------------------

// p: B, H, KV, Sq, Sk, D, causal, window, dtype; f: scale, softcap
extern "C" int kapla_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* p, const double* f,
                                     void* stream) {
  FlashArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
              (int)p[6], (int)p[7], (float)f[0], (float)f[1]};
  const int D = (int)p[5], dtype = (int)p[8];
  if (a.KV <= 0 || a.H % a.KV != 0 || a.Sq <= 0 || a.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)flash_by_dim<float>(D, q, k, v, o, a, s);
  if (dtype == 1)
    return (int)flash_by_dim<__nv_bfloat16>(D, q, k, v, o, a, s);
  return (int)cudaErrorInvalidValue;
}

// p: B, H, NC, Lc, P, N, dtype
extern "C" int kapla_ssd_intra_chunk(const void* x, const float* dt,
                                     const float* acum, const float* bmat,
                                     const float* cmat, void* y,
                                     const long long* p, void* stream) {
  SsdArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
            (int)p[5]};
  const int dtype = (int)p[6];
  if (a.Lc <= 0 || a.Lc > SSD_L || a.P <= 0 || a.P > SSD_P || a.N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_ssd<float>(x, dt, acum, bmat, cmat, y, a, s);
  if (dtype == 1)
    return (int)launch_ssd<__nv_bfloat16>(x, dt, acum, bmat, cmat, y, a, s);
  return (int)cudaErrorInvalidValue;
}
