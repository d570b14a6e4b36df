// The online-softmax attention tile, f32 FMA on the CUDA cores, shared by
// two kernels: attention_kernel (lower_kernels.cu, the layer tier; replaces
// src/repro/lower/exec.py _run_attention) and flash_kernel (model_kernels.cu,
// the FMA path of flash attention, which replaces src/repro/kernels/
// flash_attention.py _flash_kernel for float32 at every head dim and bf16 at
// 16 and 32; bf16 at 64, 128 and 256 runs flash_wgmma_kernel on the tensor
// cores instead).  Bound: operations at the CUDA cores' FP32 rate (67 TFLOP/s
// on the H100 SXM).  Each kernel owns its grid, its key range and its mask;
// this header holds what they do alike.
//
// Layout: 256 threads for 64 query rows, four threads per row.  Q, K and V
// tiles sit in dynamic shared memory as float32 at a row pitch of D + 4
// (float4-aligned, rows shift banks by 4): 64 query rows, then 64 key rows,
// then 64 value rows.  Each thread scores 16 keys of its row (keys sub,
// sub + 4, ...), the row's max and sum are reduced over its four lanes with
// shuffles, and each thread keeps a quarter of the row's float32 accumulator
// in registers, with m and l.  A masked key gets p = 0 from the mask, never
// from exp underflow, so a row whose keys in a tile are all masked
// (m = -1e30) adds nothing.  The epilogue is acc / max(l, 1e-30).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int OS_BQ = 64, OS_BK = 64, OS_THREADS = 256;
constexpr int OS_KPT = OS_BK / 4;  // keys scored per thread

template <int D>
constexpr size_t online_softmax_smem() {
  return (size_t)(OS_BQ + 2 * OS_BK) * (D + 4) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// instantiation; the attribute stays set for the life of the context).
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// Stage `rows` rows of D values (row stride D in global memory) into `dst`
// at pitch D + 4 as float32; rows from `valid` on are zero.  VEC reads
// float4s (float only, 16-byte aligned rows), else one element at a time.
template <typename T, int D, bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int rows,
                                           int valid, int tid) {
  constexpr int PITCH = D + 4;
  if constexpr (VEC) {
    static_assert(sizeof(T) == sizeof(float), "float4 staging is for f32");
    for (int idx = tid; idx < rows * D / 4; idx += OS_THREADS) {
      const int r = idx / (D / 4), d = 4 * (idx % (D / 4));
      *reinterpret_cast<float4*>(dst + r * PITCH + d) =
          r < valid
              ? *reinterpret_cast<const float4*>(src + (size_t)r * D + d)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = tid; idx < rows * D; idx += OS_THREADS) {
      const int r = idx / D, d = idx % D;
      dst[r * PITCH + d] = r < valid ? to_f32(src[(size_t)r * D + d]) : 0.f;
    }
  }
}

// One query row's online-softmax state, a quarter per lane.
template <int D>
struct SoftmaxRow {
  static_assert(D % 16 == 0, "each thread owns D/16 float4 chunks");
  static constexpr int PITCH = D + 4;
  static constexpr int NCH = D / 16;
  float m, l;
  float4 acc[NCH];

  __device__ __forceinline__ void init() {
    m = NEG_INF;
    l = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // One staged tile of OS_BK keys.  `qrow` is this row's staged query, `sub`
  // the lane's place in its row (0..3), `row_lane` the row's first lane.
  // `keep(j, x)` sees key j of the tile (0..63) and its score x (already
  // times `scale`); it may transform x (a soft-cap) and returns whether the
  // key counts.
  template <typename Keep>
  __device__ __forceinline__ void step(const float* qrow, const float* ks,
                                       const float* vs, int sub, int row_lane,
                                       float scale, Keep keep) {
    // s[i]: this row's score against key sub + 4 i
    float s[OS_KPT];
#pragma unroll
    for (int i = 0; i < OS_KPT; ++i) s[i] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int i = 0; i < OS_KPT; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (sub + 4 * i) * PITCH + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    unsigned kept = 0;
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < OS_KPT; ++i) {
      float x = s[i] * scale;
      const bool ok = keep(sub + 4 * i, x);
      s[i] = ok ? x : NEG_INF;
      kept |= (unsigned)ok << i;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < OS_KPT; ++i) {
      s[i] = (kept >> i) & 1u ? expf(s[i] - m_new) : 0.f;
      psum += s[i];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;

    // acc = acc * alpha + p @ v; p of key j lives in lane (row, j % 4)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < OS_BK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, s[j / 4], row_lane | (j & 3));
      const float* vrow = vs + j * PITCH;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vrow + 4 * (sub + 4 * c));
        acc[c].x = fmaf(pj, vv.x, acc[c].x);
        acc[c].y = fmaf(pj, vv.y, acc[c].y);
        acc[c].z = fmaf(pj, vv.z, acc[c].z);
        acc[c].w = fmaf(pj, vv.w, acc[c].w);
      }
    }
  }

  // The epilogue: this lane's quarter of acc / max(l, 1e-30) into the
  // output row `orow`.  VEC writes float4s (float only, 16-byte aligned).
  template <typename T, bool VEC>
  __device__ __forceinline__ void store(T* orow, int sub) const {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = 4 * (sub + 4 * c);
      if constexpr (VEC) {
        static_assert(sizeof(T) == sizeof(float), "float4 store is for f32");
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[c].x / denom, acc[c].y / denom, acc[c].z / denom,
                        acc[c].w / denom);
      } else {
        orow[d + 0] = from_f32<T>(acc[c].x / denom);
        orow[d + 1] = from_f32<T>(acc[c].y / denom);
        orow[d + 2] = from_f32<T>(acc[c].z / denom);
        orow[d + 3] = from_f32<T>(acc[c].w / denom);
      }
    }
  }
};

}  // namespace
