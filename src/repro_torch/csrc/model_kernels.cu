// Hand-written Hopper (sm_90a) kernels for the model zoo's prefill: flash
// attention (dense and hybrid blocks) and the Mamba2 SSD intra-chunk term
// (Mamba2 blocks).
//
// Flash attention has two kernels, and the wrapper (repro_torch/kernels/
// flash_attention.py, its `PATHS` table) names which one runs:
// - flash_wgmma_kernel, bf16 at head dims 64, 128 and 256: the tensor-core
//   kernel (wgmma fed by TMA, warp-specialised; below);
// - flash_kernel, float32 at every head dim and bf16 at 16 and 32: f32 FMA on
//   the CUDA cores through the online-softmax tile of online_softmax.cuh,
//   which the layer tier's attention_kernel shares.
// Both compute and accumulate in float32 and write the output in the input's
// type.  The SSD kernel is f32 FMA on the CUDA cores.
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

#include "hopper.cuh"
#include "online_softmax.cuh"

namespace {

// ---------------------------------------------------------------------------
// flash attention: o = softmax(mask(softcap(q k^T * scale))) v, per head,
// GQA head h reading KV head h / (H / KV); queries right-aligned into the
// keys (query row r sits at absolute position r + Sk - Sq).
// Both kernels replace src/repro/kernels/flash_attention.py flash_attention
// and _flash_kernel.  Tiles wholly above the causal diagonal or left of the
// window are skipped (their p is 0, so skipping is exact); the mask zeroes p
// of the rest.
//
// flash_kernel, the FMA path (float32; bf16 at D 16 and 32).  Bound: in f32,
// operations at the CUDA cores' FP32 rate.  Design: one block per (b*H + h,
// 64-query tile), looping over the key tiles of 64 with the online-softmax
// tile of online_softmax.cuh (K and V staged as float32, (acc, m, l) in
// registers).
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
// flash_wgmma_kernel, the tensor-core path (bf16, D in {64, 128, 256}).
// Bound: at the serve shapes, bytes (each of q, k, v, o once) and bf16
// tensor-core operations are within 2x of each other (Qwen2.5-3B prefill:
// 0.0113 ms of bytes, 0.0087 ms of operations at 989 TFLOP/s).  Design: one
// CTA per (b*H + h, 128-query tile): two consumer warpgroups of 64 query rows
// and a producer warpgroup in which one warp issues every TMA copy.  The
// producer warpgroup drops to 40 registers a thread with setmaxnreg and the
// consumers rise to 232 (384 threads at the launch's 168 registers are
// exactly 128 x 40 + 256 x 232).
// - The producer loads Q once by TMA, then K and V tiles of 64 keys (128 at
//   D 64) into a 2-stage ring in shared memory (128-byte swizzle; one full
//   and one empty mbarrier a stage), so the next tile's copy overlaps this
//   tile's math.
// - Each consumer warpgroup computes S = Q K^T with wgmma m64nBKk16 (both
//   from shared memory, f32 accumulate), applies scale, soft-cap and mask,
//   runs the online softmax on S in registers (a row's values sit in 4 lanes
//   of the wgmma accumulator layout; max and sum reduce over them), rescales
//   O, rounds P to bf16 in registers and accumulates O += P V with wgmma (P
//   the register A operand, V MN-major from shared memory).
// - The epilogue writes O / max(l, 1e-30) as bf16 over the warpgroup's Q
//   rows in shared memory and stores them by TMA.
// - Registers: a consumer thread holds O (D/2 floats), S and P.  ptxas
//   compiles the consumers within the launch's 168 registers, so D 256 runs
//   in two passes over the keys, each holding half of O's columns (64
//   floats) and recomputing S: the first pass stores its half straight from
//   registers (Q is still needed), the second through shared memory by TMA.
// q, k, v and o are described as 3-D [B*H (or B*KV), S, D] maps, so a box
// that runs past S reads zeros (the ragged edge) instead of the next head.
// Masking: a masked score is -inf, and the softmax subtracts 0 while a row's
// max is still -inf, so a masked key's p is exactly 0.
// ---------------------------------------------------------------------------

constexpr int FW_BQ = 128, FW_STAGES = 2, FW_CONSUMERS = 256;
constexpr int FW_THREADS = FW_CONSUMERS + 128;

template <int D>
struct FwTile {
  static_assert(D == 64 || D == 128 || D == 256, "wgmma flash head dim");
  static constexpr int BK = D == 64 ? 128 : 64;  // keys a stage
  static constexpr int CB = D / 64;              // 128-byte column blocks
  static constexpr int ON = D < 128 ? D : 128;   // O columns a pass holds
  static constexpr int PASSES = D / ON;
  static constexpr uint32_t Q_BYTES = FW_BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // K or V, one stage
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * FW_STAGES * KV_BYTES + 8 * (1 + 2 * FW_STAGES);
};

// The K-major descriptor of k16 step `kk` of a [rows, D] tile whose
// column blocks are `block_bytes` apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk,
                                                uint32_t block_bytes) {
  return desc_sw128(tile + (kk / 4) * block_bytes + (kk % 4) * 32, 16, 1024);
}

template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   __nv_bfloat16* __restrict__ og, FlashArgs a) {
  using T = FwTile<D>;
  constexpr int BK = T::BK, ON = T::ON;
  extern __shared__ uint8_t fw_smem[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fw_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + T::Q_BYTES;
  uint8_t* vs = ks + FW_STAGES * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + FW_STAGES * T::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + FW_STAGES;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int bkv = b * a.KV + h / (a.H / a.KV);
  const int q0 = blockIdx.x * FW_BQ;
  const int q_offset = a.Sk - a.Sq;
  // key tiles that can hold an unmasked key for some row of this CTA
  const int qlo = q0 + q_offset;
  const int qhi = min(q0 + FW_BQ, a.Sq) - 1 + q_offset;
  int kt_begin = 0, kt_end = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_end = min(kt_end, max(qhi, 0) / BK + 1);
  if (a.window > 0) kt_begin = max(0, qlo - a.window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FW_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= FW_CONSUMERS) {
    // ---- producer warpgroup: one thread issues the TMA copies ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == FW_CONSUMERS) {
      mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::CB; ++c)
        tma_load_3d(qs + c * FW_BQ * 128, &tq, q_full, 64 * c, q0, bh);
      int stage = 0, phase = 0;
      for (int pass = 0; pass < T::PASSES; ++pass)
        for (int kt = kt_begin; kt < kt_end; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], 2 * T::KV_BYTES);
          uint8_t* kd = ks + stage * T::KV_BYTES;
          uint8_t* vd = vs + stage * T::KV_BYTES;
          for (int c = 0; c < T::CB; ++c) {
            tma_load_3d(kd + c * BK * 128, &tk, &full[stage], 64 * c,
                        kt * BK, bkv);
            tma_load_3d(vd + c * BK * 128, &tv, &full[stage], 64 * c,
                        kt * BK, bkv);
          }
          if (++stage == FW_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    // ---- two consumer warpgroups ----
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int lane = tid % 32, quad = lane % 4;
    const int r_a = (tid / 32) * 16 + lane / 4;  // rows r_a and r_a + 8
    const int qpos_a = q0 + wg * 64 + r_a + q_offset, qpos_b = qpos_a + 8;
    const int wq_lo = q0 + wg * 64 + q_offset, wq_hi = wq_lo + 63;
    constexpr float LOG2E = 1.4426950408889634f;
    const float scale_log2 = a.scale * LOG2E;
    const uint32_t q_tile = smem_u32(qs) + wg * 64 * 128;

    mbar_wait(q_full, 0);
    int stage = 0, phase = 0;
    for (int pass = 0; pass < T::PASSES; ++pass) {
      float o[ON / 2];
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) o[i] = 0.f;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t k_tile = smem_u32(ks + stage * T::KV_BYTES);
        const uint32_t v_tile = smem_u32(vs + stage * T::KV_BYTES);

        // S = Q K^T (the first k-step writes S, so S is not carried over)
        float s[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(s, kmajor_desc(q_tile, kk, FW_BQ * 128),
                       kmajor_desc(k_tile, kk, BK * 128), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // scale, soft-cap (before the mask), mask; in log2 units
        const int k0 = kt * BK;
        if (a.softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            s[i] = tanhf(s[i] * a.scale / a.softcap) * a.softcap * LOG2E;
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
        }
        const bool edge = k0 + BK > a.Sk ||
                          (a.causal && k0 + BK - 1 > wq_lo) ||
                          (a.window > 0 && k0 <= wq_hi - a.window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int kpos = k0 + (i / 4) * 8 + quad * 2 + (i & 1);
            const int qpos = (i & 2) ? qpos_b : qpos_a;
            bool ok = kpos < a.Sk;
            if (a.causal) ok = ok && kpos <= qpos;
            if (a.window > 0) ok = ok && kpos > qpos - a.window;
            if (!ok) s[i] = -INFINITY;
          }
        }

        // online softmax: rows a (i & 2 == 0) and b, each over 4 lanes
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          if (i & 2)
            mx_b = fmaxf(mx_b, s[i]);
          else
            mx_a = fmaxf(mx_a, s[i]);
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
        const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
        const float alpha_a = exp2f(m_a - base_a);
        const float alpha_b = exp2f(m_b - base_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] = exp2f(s[i] - ((i & 2) ? base_b : base_a));
          if (i & 2)
            sum_b += s[i];
          else
            sum_a += s[i];
        }
        l_a = l_a * alpha_a + sum_a;  // this lane's part; reduced at the end
        l_b = l_b * alpha_b + sum_b;
#pragma unroll
        for (int i = 0; i < ON / 2; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;

        // P in bf16: k16 step c is accumulator columns 16c..16c+15
        uint32_t p[BK / 16][4];
#pragma unroll
        for (int c = 0; c < BK / 16; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                s[8 * c + 2 * j], s[8 * c + 2 * j + 1]);
            p[c][j] = *reinterpret_cast<const uint32_t*>(&v2);
          }

        // O += P V over this pass's columns of V
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < BK / 16; ++c)
          wgmma_rs_tb<ON>(o, p[c],
                          desc_sw128(v_tile + c * 16 * 128 +
                                         pass * (ON / 64) * BK * 128,
                                     BK * 128, 1024),
                          1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        mbar_arrive(&empty[stage]);
        if (++stage == FW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue: O / max(l, 1e-30) in bf16 for this pass's columns
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
      if (pass + 1 < T::PASSES) {
        // Q is still needed: straight to global memory
#pragma unroll
        for (int i = 0; i < ON / 2; i += 2) {
          const int row = q0 + wg * 64 + r_a + ((i & 2) ? 8 : 0);
          const int col = pass * ON + (i / 4) * 8 + quad * 2;
          const float den = (i & 2) ? den_b : den_a;
          if (row < a.Sq)
            *reinterpret_cast<__nv_bfloat162*>(
                og + ((size_t)bh * a.Sq + row) * D + col) =
                __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
        }
        continue;
      }
      named_barrier(1 + wg, 128);  // every S wgmma of the warpgroup is done
#pragma unroll
      for (int i = 0; i < ON / 2; i += 2) {
        const int row = wg * 64 + r_a + ((i & 2) ? 8 : 0);
        const int col = pass * ON + (i / 4) * 8 + quad * 2;
        const float den = (i & 2) ? den_b : den_a;
        const int cb = col / 64, chunk = (col % 64) / 8;
        *reinterpret_cast<__nv_bfloat162*>(
            qs + cb * FW_BQ * 128 + row * 128 + ((chunk ^ (row % 8)) * 16) +
            (col % 8) * 2) = __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (tid == 0 && q0 + wg * 64 < a.Sq) {
        for (int c = pass * ON / 64; c < T::CB; ++c)
          tma_store_3d(&to, qs + c * FW_BQ * 128 + wg * 64 * 128, 64 * c,
                       q0 + wg * 64, bh);
        tma_store_commit_and_wait();
      }
    }
  }
}

template <int D>
cudaError_t launch_flash_wgmma(const void* q, const void* k, const void* v,
                               void* o, const FlashArgs& a,
                               cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t smem = FwTile<D>::SMEM;
  cudaError_t err = allow_smem(flash_wgmma_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  const int BK = FwTile<D>::BK;
  if ((err = make_map_bf16_3d(&tq, q, a.B * a.H, a.Sq, D, FW_BQ)) ||
      (err = make_map_bf16_3d(&tk, k, a.B * a.KV, a.Sk, D, BK)) ||
      (err = make_map_bf16_3d(&tv, v, a.B * a.KV, a.Sk, D, BK)) ||
      (err = make_map_bf16_3d(&to, o, a.B * a.H, a.Sq, D, 64)))
    return err;
  dim3 grid((unsigned)((a.Sq + FW_BQ - 1) / FW_BQ), (unsigned)(a.B * a.H));
  flash_wgmma_kernel<D><<<grid, FW_THREADS, smem, stream>>>(
      tq, tk, tv, to, static_cast<__nv_bfloat16*>(o), a);
  return cudaGetLastError();
}

cudaError_t flash_wgmma_by_dim(int D, const void* q, const void* k,
                               const void* v, void* o, const FlashArgs& a,
                               cudaStream_t stream) {
  switch (D) {
    case 64: return launch_flash_wgmma<64>(q, k, v, o, a, stream);
    case 128: return launch_flash_wgmma<128>(q, k, v, o, a, stream);
    case 256: return launch_flash_wgmma<256>(q, k, v, o, a, stream);
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

// p: B, H, KV, Sq, Sk, D, causal, window, dtype, path (0 the FMA tile, 1
// the tensor-core kernel, bf16 only); f: scale, softcap
extern "C" int kapla_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* p, const double* f,
                                     void* stream) {
  FlashArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
              (int)p[6], (int)p[7], (float)f[0], (float)f[1]};
  const int D = (int)p[5], dtype = (int)p[8], path = (int)p[9];
  if (a.KV <= 0 || a.H % a.KV != 0 || a.Sq <= 0 || a.Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == 1)
    return dtype == 1 ? (int)flash_wgmma_by_dim(D, q, k, v, o, a, s)
                      : (int)cudaErrorInvalidValue;
  if (path != 0) return (int)cudaErrorInvalidValue;
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
