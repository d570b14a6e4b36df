// Hand-written Hopper (sm_90a) kernels for the model zoo: flash attention
// (dense and hybrid blocks) and the Mamba2 SSD intra-chunk term (Mamba2
// blocks) in the forward, and the training step's multi-tensor AdamW (the
// gradients' global norm and the clipped update over every leaf at once).
//
// Flash attention has two kernels, and the wrapper (repro_torch/kernels/
// flash_attention.py, its `PATHS` table) names which one runs:
// - flash_wgmma_kernel, bf16 at head dims 64, 128, 224 and 256: the tensor-core
//   kernel (wgmma fed by TMA, warp-specialised; below);
// - flash_kernel, float32 at every head dim and bf16 at 16 and 32: f32 FMA on
//   the CUDA cores through the online-softmax tile of online_softmax.cuh,
//   which the layer tier's attention_kernel shares.
// Both compute and accumulate in float32 and write the output in the input's
// type.  The SSD intra-chunk kernel runs its two products on the tensor
// cores in 3xTF32 (tf32_mma.cuh), float32 inside, x's type at the output.
// Each entry point takes a host int64 parameter array (and flash and AdamW a
// host double array of scalars), launches on the given stream and returns
// cudaGetLastError().  The Python wrappers (repro_torch/kernels/
// flash_attention.py, ssd_scan.py and multi_tensor.py) check shapes, types
// and contiguity.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/backend.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "online_softmax.cuh"
#include "tf32_mma.cuh"

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

// lse: null, or [B, H, Sq] float32 that receives each query row's
// log-sum-exp of its (scaled, soft-capped, masked) scores in natural-log
// units, m + log(max(l, 1e-30)), for the backward (kernels/ops.py
// flash_attention_vjp); the reference's _chunked_attention_jnp(...,
// return_lse=True).
struct FlashArgs {
  int B, H, KV, Sq, Sk, causal, window;
  float scale, softcap;
  float* lse;
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
  // m and l are already reduced over the row's 4 lanes (SoftmaxRow::step)
  if (a.lse != nullptr && sub == 0)
    a.lse[(size_t)bh * a.Sq + q0 + row] = st.m + logf(fmaxf(st.l, 1e-30f));
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
// flash_wgmma_kernel, the tensor-core path (bf16, D in {64, 128, 224, 256}).
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
// - D 224 (Zamba2-7B's shared attention) is laid out as D 256: the last
//   128-byte column block of each tile is half past D, and TMA fills it
//   with zeros (reads) and drops it (the epilogue's store).  S takes the 14
//   k16 steps of D alone; the second pass's P V runs over 128 columns, of
//   which 96 are D's (its last 32 are zeros, never stored).
// q, k, v and o are described as 3-D [B*H (or B*KV), S, D] maps, so a box
// that runs past S (or, at D 224, past D) reads zeros (the ragged edge)
// instead of the next head or row.
// Masking: a masked score is -inf, and the softmax subtracts 0 while a row's
// max is still -inf, so a masked key's p is exactly 0.
// ---------------------------------------------------------------------------

constexpr int FW_BQ = 128, FW_STAGES = 2, FW_CONSUMERS = 256;
constexpr int FW_THREADS = FW_CONSUMERS + 128;

template <int D>
struct FwTile {
  static_assert(D == 64 || D == 128 || D == 224 || D == 256,
                "wgmma flash head dim");
  static constexpr int BK = D == 64 ? 128 : 64;  // keys a stage
  static constexpr int CB = (D + 63) / 64;       // 128-byte column blocks
  static constexpr int ON = D < 128 ? D : 128;   // O columns a pass holds
  static constexpr int PASSES = (D + ON - 1) / ON;
  static constexpr uint32_t Q_BYTES = FW_BQ * CB * 128;
  static constexpr uint32_t KV_BYTES = BK * CB * 128;  // K or V, one stage
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
      if (a.lse != nullptr && pass + 1 == T::PASSES && quad == 0) {
        // m is in log2 units here: lse = (m2 + log2(l)) ln 2; a row with no
        // unmasked key (m2 = -inf) gets the plain version's -1e30
        constexpr float LN2 = 0.6931471805599453f;
        const int row_a = q0 + wg * 64 + r_a;
        if (row_a < a.Sq)
          a.lse[(size_t)bh * a.Sq + row_a] =
              m_a == -INFINITY ? -1e30f : (m_a + log2f(den_a)) * LN2;
        if (row_a + 8 < a.Sq)
          a.lse[(size_t)bh * a.Sq + row_a + 8] =
              m_b == -INFINITY ? -1e30f : (m_b + log2f(den_b)) * LN2;
      }
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
    case 224: return launch_flash_wgmma<224>(q, k, v, o, a, stream);
    case 256: return launch_flash_wgmma<256>(q, k, v, o, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// SSD intra-chunk term (Mamba2):
//   y[l] = sum_{m <= l} (C[l] . B[m]) * exp(acum[l] - acum[m]) * dt[m] * x[m]
// per (b, h, chunk); B and C come in G groups, head h reading group
// h / (H / G) (G = 1: shared by every head).
// Replaces src/repro/kernels/ssd_scan.py ssd_intra_chunk and
// _ssd_intra_kernel.  Bound: bytes at the models' shapes (Zamba2-1.2B's
// prefill reads x and writes y, 67 MB a launch in bf16, against 2.2 GFLOP
// that take less time at the 3xTF32 rate).  Design, for the tensor cores:
// - G = C B^T once per (b, chunk, head group).  One block per (b * NC + chunk,
//   group of hg heads; ssd_scan.py ssd_launch picks hg and passes it): G
//   depends on no head, so the block forms each 128 x 128 tile of it once and
//   applies it to every head of its group.  A block's heads never straddle
//   two B/C groups: each B/C group of H / G heads gets blocks of its own
//   (blockIdx.y = group * its blocks + block), and B and C are laid out
//   [B, NC, G, Lc, N], so a group's chunk is one [Lc, N] slab.  Eight warps, each owning a
//   16-row strip of the tile; a warp keeps its strip of G in registers (16
//   m16n8 accumulators) across the heads.
// - Both products in 3xTF32 on mma.sync m16n8k8 (tf32_mma.cuh): G over the
//   state N in chunks of 64 (8 k-steps, summed from zero, the partial sums
//   added in float32); S @ x per 32-key step from zero (the small products
//   first, then S_hi x_hi, one accumulator per 8-column tile), added to y in
//   float32.  A single TF32 product would break the 1e-5 limit on f32.  With
//   bf16 x, x is exact in TF32, so S @ x takes two products (S's high and low
//   parts against x), not three, and x's B fragments come from
//   ldmatrix.trans.
// - The m16n8 accumulator of G is not the tf32 A-fragment layout (a lane
//   holds keys 2t and 2t + 1; the fragment wants t and t + 4), so each 8-key
//   step takes A column t as key 2t and column t + 4 as key 2t + 1, and
//   reads x's B fragment rows in that order (attention_mma_kernel's P V
//   permutation).  S never leaves the registers.
// - The decay, factored, and no exp above the diagonal (there it overflows
//   to inf, and inf * 0 would give NaN).  Per tile pair and head, each key's
//   u_m = exp(e_b - acum_m) dt_m, with e_b the acum of its 8-key block's
//   last valid key, and each block's step c_b = exp(e_{b+1} - e_b): acum
//   falls along the keys, so both are at most 1 (times dt) and neither can
//   overflow, whatever the decay.  A row's factor exp(acum_l - e_b) is at
//   most 1 at every block wholly below the row's own: one expf at the first
//   of them (on the diagonal tile the row's block less one; below it, the
//   last), stepped down the blocks by c_b (the key steps run last first),
//   0 above, all by selects.  The row's own 8-key block on the diagonal
//   takes exp(acum_l - acum_m) dt_m directly, keys to the row only: a table
//   of 8 per row and head, formed once per diagonal tile and read in a
//   warp-uniform branch.  An underflow is a decay truly below float's
//   range.
// - Causal skipping and balance.  On the diagonal tile strip s needs keys
//   [0, 16 s + 16) only: 2 s + 2 of the 16 k-steps (rounded up to whole
//   32-key steps, and G to whole halves of 8 column tiles), so the last
//   strip does 8x the first's work.  Warp w runs on SM sub-partition w % 4,
//   whose tensor core its partner w + 4 shares; warp w < 4 takes strip w and
//   warp w + 4 strip 7 - w, so every sub-partition gets strips s and 7 - s,
//   18 of the tile's 72 k-step units.  Tiles below the diagonal are full.
// - x of the next (head, P tile) streams in with cp.async into the other
//   half of a double buffer while the current one computes; the first of a
//   tile pair loads under the G computation.  Each warp stages its strip of
//   the output and writes it along the rows in 16-byte stores.
// - What bounds it: not the tensor cores but the instructions around them
//   with two warps a sub-partition (255 registers: one block an SM).  The
//   row factor's update is therefore selects, not a branch per k-step (its
//   expf inlined at 32 sites); see PERF.md.
// - Any Lc and P: 128-row tiles of Lc, walking the key tiles at or below
//   each row tile; 64-column tiles of P.  Rows, keys and columns past the
//   edge are zero-filled and masked.  With more than one row tile, the key
//   tiles' partial sums of a row tile go through a float32 workspace (y
//   itself in f32) in key-tile order, each thread rereading what it wrote.
// ---------------------------------------------------------------------------

constexpr int SSD_T = 128;           // rows of a row tile, keys of a key tile
constexpr int SSD_PT = 64;           // columns of a P tile
constexpr int SSD_NB = 64;           // state columns of a staged B/C chunk
constexpr int SSD_THREADS = 256;     // eight warps, a 16-row strip each
constexpr int SSD_BCP = SSD_NB + 4;  // B/C row pitch: conflict-free fragments
constexpr int SSD_HG = 8;            // the most heads a block
constexpr int SSD_KB = SSD_T / 8;    // 8-key blocks of a key tile
// a head's decays of a key tile, one block of floats: acum, u, dt, the
// 8-key blocks' steps c and 8 a row for the rows' own blocks on the
// diagonal (one base pointer a head: the offsets are immediates)
constexpr int SSD_KA = 0, SSD_KU = SSD_T, SSD_KDT = 2 * SSD_T,
              SSD_KC = 3 * SSD_T, SSD_KOWN = 3 * SSD_T + SSD_KB,
              SSD_KH = SSD_KOWN + 8 * SSD_T;

// x staging pitch in elements: rows 2t of a B fragment fall in distinct
// banks (f32: 68 floats; bf16: 72 halves, 36 words)
template <typename T>
struct SsdX;
template <>
struct SsdX<float> {
  static constexpr int PITCH = SSD_PT + 4;
};
template <>
struct SsdX<__nv_bfloat16> {
  static constexpr int PITCH = SSD_PT + 8;
};

template <typename T>
constexpr size_t ssd_smem() {
  return (size_t)2 * SSD_T * SSD_BCP * sizeof(float) +  // C and B chunks
         (size_t)3 * SSD_T * SsdX<T>::PITCH * sizeof(T) +  // x ring, y tile
         (size_t)SSD_HG * SSD_KH * sizeof(float);  // decays
}

struct SsdArgs {
  int B, H, NC, Lc, P, N;
  int hg;     // heads a block
  int G;      // groups of B and C; H / G heads read each
  int xvec;   // x rows 16-byte aligned: 16-byte cp.async, else element loads
  int bcvec;  // B and C rows 16-byte aligned: 16-byte cp.async, else 4-byte
};

// four 8 x 8 bf16 tiles of x, transposed: lane (g, t) gets {x[2t][g],
// x[2t + 1][g]} of tile q in r[q], the tf32 B fragment's two rows (keys 2t
// and 2t + 1 of a column) of the key permutation; lane l gives the address
// of row l % 8 of tile l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two adjacent outputs into the staged tile (an even column)
__device__ __forceinline__ void ssd_put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void ssd_put2(__nv_bfloat16* p, float v0,
                                         float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// B or C rows [0, valid) of a tile, state columns [n0, n0 + SSD_NB), into
// `dst` at pitch SSD_BCP; the rest zero-filled
__device__ __forceinline__ void ssd_stage_bc(float* dst, const float* src,
                                             int valid, int n0, int N,
                                             bool vec, int tid) {
  const int nw = min(SSD_NB, N - n0);
  if (vec) {
    for (int idx = tid; idx < SSD_T * (SSD_NB / 4); idx += SSD_THREADS) {
      const int r = idx / (SSD_NB / 4), c = 4 * (idx % (SSD_NB / 4));
      const int bytes = r < valid ? 4 * max(0, min(4, nw - c)) : 0;
      cp_async16(dst + r * SSD_BCP + c,
                 bytes ? src + (size_t)r * N + n0 + c : src, bytes);
    }
  } else {
    for (int idx = tid; idx < SSD_T * SSD_NB; idx += SSD_THREADS) {
      const int r = idx / SSD_NB, c = idx % SSD_NB;
      const bool ok = r < valid && c < nw;
      cp_async4(dst + r * SSD_BCP + c, ok ? src + (size_t)r * N + n0 + c : src,
                ok ? 4 : 0);
    }
  }
}

// x rows [0, nk) and columns [0, pw) of one (head, key tile, P tile), row
// stride P, into `dst` at SsdX<T>::PITCH; the rest of the 128 x 64 tile zero
template <typename T>
__device__ __forceinline__ void ssd_stage_x(T* dst, const T* src, int nk,
                                            int pw, int P, bool vec,
                                            int tid) {
  constexpr int XP = SsdX<T>::PITCH, E = 16 / sizeof(T);
  if (vec) {  // P * sizeof(T) is a multiple of 16, so pw a multiple of E
    for (int idx = tid; idx < SSD_T * (SSD_PT / E); idx += SSD_THREADS) {
      const int r = idx / (SSD_PT / E), c = E * (idx % (SSD_PT / E));
      const bool ok = r < nk && c < pw;
      cp_async16(reinterpret_cast<float*>(dst + r * XP + c),
                 reinterpret_cast<const float*>(
                     ok ? src + (size_t)r * P + c : src),
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < SSD_T * SSD_PT; idx += SSD_THREADS) {
      const int r = idx / SSD_PT, c = idx % SSD_PT;
      dst[r * XP + c] =
          r < nk && c < pw ? src[(size_t)r * P + c] : from_f32<T>(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS, 1)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ acum,
                 const float* __restrict__ bmat,
                 const float* __restrict__ cmat, T* y, float* ws,
                 SsdArgs a) {
  constexpr int XP = SsdX<T>::PITCH;
  constexpr bool F32 = sizeof(T) == sizeof(float);
  extern __shared__ float4 ssd_smem4[];
  float* cs = reinterpret_cast<float*>(ssd_smem4);  // C chunk [T][BCP]
  float* bs = cs + SSD_T * SSD_BCP;                  // B chunk [T][BCP]
  T* xs = reinterpret_cast<T*>(bs + SSD_T * SSD_BCP);  // 2 x [T][XP]
  T* ys = xs + 2 * SSD_T * XP;  // the output tile [T][XP], staged
  // per head of the group, its decays of the key tile [HG][KH]
  float* kdec = reinterpret_cast<float*>(ys + SSD_T * XP);

  const int bc = blockIdx.x;  // b * NC + chunk
  const int b = bc / a.NC, ch = bc - b * a.NC;
  // the B/C group of the block, and its heads within the group's
  const int hpg = a.H / a.G, bpg = (hpg + a.hg - 1) / a.hg;
  const int grp = blockIdx.y / bpg;
  const int h0 = grp * hpg + (blockIdx.y - grp * bpg) * a.hg;
  const int nh = min(a.hg, (grp + 1) * hpg - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // warp w runs on SM sub-partition w % 4 with warp w + 4: strips s and
  // 7 - s there
  const int r0 = 16 * (warp < 4 ? warp : 11 - warp);  // the warp's strip
  const int rt = (a.Lc + SSD_T - 1) / SSD_T;
  const int pt = (a.P + SSD_PT - 1) / SSD_PT;
  const int items = nh * pt;  // (head, P tile) pairs of a tile pair
  const float* cg = cmat + ((size_t)bc * a.G + grp) * a.Lc * a.N;
  const float* bg = bmat + ((size_t)bc * a.G + grp) * a.Lc * a.N;
  // element (b, h0 + hh, ch, 0) of dt, acum and, times P, of x and y
  const size_t row0 = (((size_t)b * a.H + h0) * a.NC + ch) * a.Lc;
  auto head_row = [&](int hh) { return row0 + (size_t)hh * a.NC * a.Lc; };
  // stage x of item q (a head, a P tile) of key tile j into slot `buf`
  auto load_item = [&](int j, int q, int buf) {
    const int hh = q / pt, p0 = (q - hh * pt) * SSD_PT;
    const size_t row = head_row(hh) + (size_t)j * SSD_T;
    ssd_stage_x<T>(xs + buf * SSD_T * XP, x + row * a.P + p0,
                   min(SSD_T, a.Lc - j * SSD_T), min(SSD_PT, a.P - p0), a.P,
                   a.xvec, tid);
  };

  for (int i = 0; i < rt; ++i) {
    const int nr = min(SSD_T, a.Lc - i * SSD_T);
    for (int j = 0; j <= i; ++j) {
      const bool diag = j == i;
      const int nk = min(SSD_T, a.Lc - j * SSD_T);
      // k-steps (8 keys, an n-tile of G) the strip needs
      const int kt =
          r0 < nr ? ((diag ? min(r0 + 16, nk) : nk) + 7) / 8 : 0;
      __syncthreads();  // the previous tile pair's readers are done
      load_item(j, 0, 0);
      for (int idx = tid; idx < nh * SSD_T; idx += SSD_THREADS) {
        const int hh = idx / SSD_T, k = idx % SSD_T;
        const size_t e = head_row(hh) + (size_t)j * SSD_T + k;
        const bool ok = k < nk;  // else zero-filled
        float* kh = kdec + hh * SSD_KH;
        cp_async4(kh + SSD_KA + k, ok ? acum + e : acum, ok ? 4 : 0);
        cp_async4(kh + SSD_KDT + k, ok ? dt + e : dt, ok ? 4 : 0);
      }
      cp_async_commit();

      // G = C_i B_j^T, this warp's 16 rows by keys [0, 8 kt) (whole
      // halves of 8 n-tiles), kept in registers across the heads
      float G[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[n][e] = 0.f;
      for (int n0 = 0; n0 < a.N; n0 += SSD_NB) {
        if (n0) __syncthreads();  // the previous chunk's readers are done
        ssd_stage_bc(cs, cg + (size_t)i * SSD_T * a.N, nr, n0, a.N, a.bcvec,
                     tid);
        ssd_stage_bc(bs, bg + (size_t)j * SSD_T * a.N, nk, n0, a.N, a.bcvec,
                     tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int ksteps = (min(SSD_NB, a.N - n0) + 7) / 8;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (8 * half >= kt) break;
          float sp[8][4];  // this chunk's sum from zero, small products first
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[q][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < SSD_NB / 8; ++kk) {
            if (kk >= ksteps) break;
            uint32_t ah[4], al[4];
            const float* cr = cs + (r0 + g) * SSD_BCP + 8 * kk + t4;
            split_tf32(cr[0], ah[0], al[0]);
            split_tf32(cr[8 * SSD_BCP], ah[1], al[1]);
            split_tf32(cr[4], ah[2], al[2]);
            split_tf32(cr[8 * SSD_BCP + 4], ah[3], al[3]);
#pragma unroll
            for (int q = 0; q < 8; ++q) {  // whole halves: no branch
              const float* br =
                  bs + (8 * (8 * half + q) + g) * SSD_BCP + 8 * kk + t4;
              uint32_t bh[2], bl[2];
              split_tf32(br[0], bh[0], bl[0]);
              split_tf32(br[4], bh[1], bl[1]);
              mma_tf32(sp[q], al, bh);
              mma_tf32(sp[q], ah, bl);
              mma_tf32(sp[q], ah, bh);
            }
          }
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) G[8 * half + q][e] += sp[q][e];
        }
      }

      // the decay, factored at each 8-key block's last valid key e_b: per
      // key u_m = exp(e_b - acum_m) dt_m <= dt_m, per block c_b =
      // exp(e_{b+1} - e_b) <= 1 (a row's factor exp(acum_l - e_b) steps
      // down the blocks by it); keys past the tile get u = 0
      for (int idx = tid; idx < nh * SSD_T; idx += SSD_THREADS) {
        const int hh = idx / SSD_T, m = idx % SSD_T;
        float* kh = kdec + hh * SSD_KH;
        const float* ah = kh + SSD_KA;
        kh[SSD_KU + m] =
            m < nk ? expf(ah[min(m | 7, nk - 1)] - ah[m]) * kh[SSD_KDT + m]
                   : 0.f;
        if (m < SSD_KB)  // the last block has no step below it
          kh[SSD_KC + m] =
              m < SSD_KB - 1 ? expf(ah[min(8 * m + 15, nk - 1)] -
                                    ah[min(8 * m + 7, nk - 1)])
                             : 0.f;
      }
      // on the diagonal, row l's own block: exp(acum_l - acum_m) dt_m for
      // its keys m <= l, 0 past them and past the tile's rows
      if (diag)
        for (int idx = tid; idx < nh * SSD_T * 8; idx += SSD_THREADS) {
          const int hh = idx / (SSD_T * 8), l = (idx / 8) % SSD_T;
          const int m = (l & ~7) + (idx & 7);
          float* kh = kdec + hh * SSD_KH;
          const bool on = m <= l && l < nk;
          kh[SSD_KOWN + idx % (SSD_T * 8)] =
              on ? expf(on ? kh[SSD_KA + l] - kh[SSD_KA + m] : 0.f) *
                       kh[SSD_KDT + m]
                 : 0.f;
        }
      __syncthreads();

      // every (head, P tile) of the group: y_i += S_ij(h) @ x_j(h)
      for (int q = 0; q < items; ++q) {
        cp_async_wait<0>();
        __syncthreads();  // item q is in; the other slot's readers are done
        if (q + 1 < items) load_item(j, q + 1, (q + 1) & 1);
        cp_async_commit();
        if (kt == 0) continue;  // the strip is past the chunk's last row
        const int hh = q / pt, p0 = (q - hh * pt) * SSD_PT;
        const int pw = min(SSD_PT, a.P - p0);
        const T* xb = xs + (q & 1) * SSD_T * XP;
        const float* kh = kdec + hh * SSD_KH;
        const size_t hrow = head_row(hh) + (size_t)i * SSD_T;
        // the lane's rows r0 + g + 8 hr: the block kd where the factor
        // starts (on the diagonal the one before the row's own, ro + hr - 1
        // with ro = r0 / 8, perhaps none; below it the last, for both) and
        // the factor there, exp(acum_l - e_kd) <= 1 (acum -inf past the
        // tile's rows, so their factor is 0); above kd the factor is 0
        float fac[2];
        int kd[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = r0 + g + 8 * hr;
          kd[hr] = diag ? (r0 >> 3) + hr - 1 : kt - 1;
          const float al = row >= nr ? __int_as_float(0xff800000)  // -inf
                               : diag ? kh[SSD_KA + row] : acum[hrow + row];
          fac[hr] = kd[hr] < 0
                        ? 0.f
                        : expf(al - kh[SSD_KA + min(8 * kd[hr] + 7, nk - 1)]);
        }
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        // 32-key steps, last first (the rows' factors step down the
        // blocks); a step's k-steps past kt have S = 0.  Inside a step no
        // branch: the 8 column tiles' chains interleave.
        const int steps = (kt + 3) / 4;
#pragma unroll
        for (int s4 = 3; s4 >= 0; --s4) {
          if (s4 >= steps) continue;
          float pp[8][4];  // the small products first, then S_hi x_hi
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pp[n][e] = 0.f;
#pragma unroll
          for (int kj = 3; kj >= 0; --kj) {
            const int kk = 4 * s4 + kj, m = 8 * kk + 2 * t4;
            const float ck = kh[SSD_KC + kk];
            float f[2];  // selects, no branch
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              fac[hr] = kk < kd[hr] ? fac[hr] * ck : fac[hr];
              f[hr] = kk > kd[hr] ? 0.f : fac[hr];
            }
            const float2 um =
                *reinterpret_cast<const float2*>(kh + SSD_KU + m);
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = G[kk][e] * f[e >> 1] * ((e & 1) ? um.y : um.x);
            if (diag && kk > kd[0] && kk <= kd[1] + 1) {  // warp-uniform
              // the own block of rows 8 kk + g (rows r0 + g + 8 hr with
              // kk == kd[hr] + 1), keys m and m + 1
              const float2 own = *reinterpret_cast<const float2*>(
                  kh + SSD_KOWN + 8 * (8 * kk + g) + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (kk == kd[e >> 1] + 1)
                  v[e] = G[kk][e] * ((e & 1) ? own.y : own.x);
            }
            // S's A fragment: column t4 is key m, column t4 + 4 key m + 1.
            // Keys past the tile have u = 0 and G = 0: S = 0 with no mask.
            uint32_t pah[4], pal[4];
            split_tf32(v[0], pah[0], pal[0]);
            split_tf32(v[2], pah[1], pal[1]);
            split_tf32(v[1], pah[2], pal[2]);
            split_tf32(v[3], pah[3], pal[3]);
            const int k0 = 8 * kk;
            if constexpr (F32) {
              const T* xk = xb + (k0 + 2 * t4) * XP + g;
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                uint32_t bh[2], bl[2];
                split_tf32(to_f32(xk[8 * n]), bh[0], bl[0]);
                split_tf32(to_f32(xk[8 * n + XP]), bh[1], bl[1]);
                mma_tf32(pp[n], pal, bh);
                mma_tf32(pp[n], pah, bl);
                mma_tf32(pp[n], pah, bh);
              }
            } else {  // bf16 is exact in TF32: x's low part is zero
#pragma unroll
              for (int n4 = 0; n4 < 2; ++n4) {
                uint32_t w[4];
                ldmatrix_x4_trans(w, xb + (k0 + (lane & 7)) * XP +
                                         8 * (4 * n4 + (lane >> 3)));
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int n = 4 * n4 + q;
                  const uint32_t bh[2] = {w[q] << 16, w[q] & 0xffff0000u};
                  mma_tf32(pp[n], pal, bh);
                  mma_tf32(pp[n], pah, bh);
                }
              }
            }
          }
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += pp[n][e];
        }

        // rows r0 + g (+ 8), columns p0 + 8 n + 2 t4 (+ 1); below the
        // diagonal into the workspace, on it through the staged tile
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = r0 + g + 8 * hr;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int col = 8 * n + 2 * t4;
            float v0 = acc[n][2 * hr], v1 = acc[n][2 * hr + 1];
            if (rt > 1 && row < nr && col < pw) {  // key tiles in order
              float* w = ws + (hrow + row) * a.P + p0 + col;
              const bool two = col + 1 < pw;
              if (j > 0) {
                v0 = w[0] + v0;
                if (two) v1 = w[1] + v1;
              }
              if (!diag) {
                w[0] = v0;
                if (two) w[1] = v1;
              }
            }
            ssd_put2(ys + row * XP + col, v0, v1);
          }
        }
        if (!diag) continue;
        __syncwarp();
        // the strip's rows to y: 16-byte stores along each row
        const int rows = min(16, nr - r0);
        T* yg = y + (hrow + r0) * a.P + p0;
        if (a.xvec) {  // P * sizeof(T) a multiple of 16, so pw too
          constexpr int E = 16 / sizeof(T);
          const int cpr = pw / E;
          for (int idx = lane; idx < rows * cpr; idx += 32) {
            const int r = idx / cpr, c = E * (idx - r * cpr);
            *reinterpret_cast<float4*>(yg + (size_t)r * a.P + c) =
                *reinterpret_cast<const float4*>(ys + (r0 + r) * XP + c);
          }
        } else {
          for (int idx = lane; idx < rows * pw; idx += 32) {
            const int r = idx / pw, c = idx - r * pw;
            yg[(size_t)r * a.P + c] = ys[(r0 + r) * XP + c];
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_ssd(const void* x, const float* dt, const float* acum,
                       const float* bmat, const float* cmat, void* y,
                       float* ws, const SsdArgs& a, dim3 grid, size_t smem,
                       cudaStream_t stream) {
  static bool smem_set = false;
  if (smem != ssd_smem<T>()) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_intra_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) return err;
  ssd_intra_kernel<T><<<grid, SSD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, acum, bmat, cmat, static_cast<T*>(y), ws,
      a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Multi-tensor AdamW (repro_torch/kernels/multi_tensor.py): the gradients'
// global norm and the clipped AdamW update over every leaf of a parameter
// tree in a few launches, where the per-leaf PyTorch path
// (optim/optimizers.py) issues about 30 kernels a leaf.  Bound: bytes; the
// update reads a bf16 parameter and gradient and the f32 moments and writes
// the parameter and both moments back (22 B a bf16 element); a sum of
// squares reads the gradient once.
//
// Design: a launch takes up to MT_*_LEAVES leaves, their addresses, sizes
// and first blocks in a kernel-argument struct passed by value (the wrapper
// packs them in leaf order, multi_tensor.py plan()), so a captured graph
// holds them and no table is copied from the host.  Block b of a launch
// finds its leaf by a binary search of the leaves' first blocks and takes
// MT_CHUNK elements of it, so a 64-element leaf and a 103 M-element head
// share one launch.  A thread takes 8 consecutive elements at a time in
// 16-byte loads where every pointer of the leaf is 16-byte aligned
// (MT_CHUNK is a multiple of 8, so every chunk starts aligned), else one
// element at a time; a leaf's last chunk ends in a scalar tail.
//
// mt_sumsq_kernel: each block's sum of squares of its chunk in f32 (each
// thread over its elements in order, then a fixed tree over the block) into
// its own partial; mt_total_kernel, one block, sums the partials in f64 in
// a fixed order and writes the f32 sum of squares, whose root the wrapper
// takes (a sharded update all-reduces the sums first).  No atomics: the
// sum has the same bits on every run.
//
// mt_adamw_kernel: per element, in f32, each operation rounded once as the
// per-leaf path's PyTorch kernels round it (the intrinsics keep nvcc from
// contracting a multiply and an add into an FMA):
//   g = to_grad_type(g * scale)     (the clip; no scale, no clip)
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * (g * g)
//   p = to_param_type(p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p))
// with bc1, bc2 and the scale read through device pointers, so a replayed
// graph reads each step's.  Given the same scale the result equals the
// per-leaf path's bit for bit.
// ---------------------------------------------------------------------------

constexpr int MT_THREADS = 256;
constexpr int MT_CHUNK = 16384;
constexpr int MT_SUMSQ_LEAVES = 160;
constexpr int MT_ADAMW_LEAVES = 80;
constexpr int MT_TOTAL_THREADS = 1024;
// the classic limit of a kernel's arguments, which every toolkit takes
constexpr size_t MT_ARG_BYTES = 4096;

struct MtSumsqArgs {
  long long n[MT_SUMSQ_LEAVES];
  const void* g[MT_SUMSQ_LEAVES];
  int start[MT_SUMSQ_LEAVES + 1];     // each leaf's first block, then all
  unsigned char bf16[MT_SUMSQ_LEAVES];
  unsigned char vec[MT_SUMSQ_LEAVES];
  int count;
  float* partials;                     // one a block of the launch
};

struct MtAdamwArgs {
  long long n[MT_ADAMW_LEAVES];
  void* p[MT_ADAMW_LEAVES];
  const void* g[MT_ADAMW_LEAVES];
  float* m[MT_ADAMW_LEAVES];
  float* v[MT_ADAMW_LEAVES];
  int start[MT_ADAMW_LEAVES + 1];
  unsigned char bf16[MT_ADAMW_LEAVES];  // the parameter's and gradient's type
  unsigned char vec[MT_ADAMW_LEAVES];
  int count;
  const float* bc1;
  const float* bc2;
  const float* scale;                  // null: no clip
  float lr, b1, omb1, b2, omb2, eps, wd;
};

static_assert(sizeof(MtSumsqArgs) <= MT_ARG_BYTES, "sumsq arguments");
static_assert(sizeof(MtAdamwArgs) <= MT_ARG_BYTES, "adamw arguments");
static_assert(MT_CHUNK % (8 * MT_THREADS) == 0, "chunks of whole vectors");

// the leaf of block b: the last whose first block is at most b (a leaf of
// no element is never packed)
__device__ __forceinline__ int mt_leaf(const int* start, int count, int b) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <bool BF16>
__device__ __forceinline__ float mt_load(const void* base, long long e) {
  if (BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[e]);
  return static_cast<const float*>(base)[e];
}

template <bool BF16>
__device__ __forceinline__ void mt_store(void* base, long long e, float x) {
  if (BF16)
    static_cast<__nv_bfloat16*>(base)[e] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[e] = x;
}

// 8 elements from e on, 16-byte aligned: one uint4 of bf16, two float4s
template <bool BF16>
__device__ __forceinline__ void mt_load8(const void* base, long long e,
                                         float (&x)[8]) {
  if (BF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + e);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + e);
    const float4 a = q[0], b = q[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

template <bool BF16>
__device__ __forceinline__ void mt_store8(void* base, long long e,
                                          const float (&x)[8]) {
  if (BF16) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + e) = u;
  } else {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(base) + e);
    q[0] = make_float4(x[0], x[1], x[2], x[3]);
    q[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// the sum of v over the block's threads in a fixed order, to every thread
// (the block a whole number of warps)
template <typename T>
__device__ __forceinline__ T mt_block_sum(T v, T* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
  return s;
}

template <bool BF16>
__device__ __forceinline__ float mt_sumsq_chunk(const void* g, long long lo,
                                                long long hi, bool vec) {
  float acc = 0.f;
  long long tail = lo;
  if (vec) {
    const long long nv = (hi - lo) >> 3;
    for (long long k = threadIdx.x; k < nv; k += MT_THREADS) {
      float x[8];
      mt_load8<BF16>(g, lo + 8 * k, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += x[j] * x[j];
    }
    tail = lo + 8 * nv;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += MT_THREADS) {
    const float x = mt_load<BF16>(g, e);
    acc += x * x;
  }
  return acc;
}

__global__ void __launch_bounds__(MT_THREADS)
mt_sumsq_kernel(const __grid_constant__ MtSumsqArgs a) {
  __shared__ float warp_sums[MT_THREADS / 32];
  const int b = blockIdx.x;
  const int i = mt_leaf(a.start, a.count, b);
  const long long lo = (long long)(b - a.start[i]) * MT_CHUNK;
  const long long hi = min(a.n[i], lo + MT_CHUNK);
  const float acc = a.bf16[i]
                        ? mt_sumsq_chunk<true>(a.g[i], lo, hi, a.vec[i])
                        : mt_sumsq_chunk<false>(a.g[i], lo, hi, a.vec[i]);
  const float s = mt_block_sum(acc, warp_sums);
  if (threadIdx.x == 0) a.partials[b] = s;
}

__global__ void __launch_bounds__(MT_TOTAL_THREADS)
mt_total_kernel(const float* partials, long long n, float* out) {
  __shared__ double warp_sums[MT_TOTAL_THREADS / 32];
  double acc = 0.0;
  for (long long k = threadIdx.x; k < n; k += MT_TOTAL_THREADS)
    acc += (double)partials[k];
  const double s = mt_block_sum(acc, warp_sums);
  if (threadIdx.x == 0) *out = (float)s;
}

struct MtAdamwConsts {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, scale;
  bool clip;
};

template <bool BF16>
__device__ __forceinline__ void mt_adamw_elem(float& p, float g, float& m,
                                              float& v,
                                              const MtAdamwConsts& c) {
  if (c.clip) {
    g = __fmul_rn(g, c.scale);
    if (BF16) g = __bfloat162float(__float2bfloat16_rn(g));
  }
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float dir = __fdiv_rn(__fdiv_rn(m, c.bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)),
                                        c.eps));
  p = __fsub_rn(p, __fmul_rn(c.lr, __fadd_rn(dir, __fmul_rn(c.wd, p))));
}

template <bool BF16>
__device__ __forceinline__ void mt_adamw_chunk(void* p, const void* g,
                                               float* m, float* v,
                                               long long lo, long long hi,
                                               bool vec,
                                               const MtAdamwConsts& c) {
  long long tail = lo;
  if (vec) {
    const long long nv = (hi - lo) >> 3;
    for (long long k = threadIdx.x; k < nv; k += MT_THREADS) {
      const long long e = lo + 8 * k;
      float pf[8], gf[8], mf[8], vf[8];
      mt_load8<BF16>(p, e, pf);
      mt_load8<BF16>(g, e, gf);
      mt_load8<false>(m, e, mf);
      mt_load8<false>(v, e, vf);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mt_adamw_elem<BF16>(pf[j], gf[j], mf[j], vf[j], c);
      mt_store8<BF16>(p, e, pf);
      mt_store8<false>(m, e, mf);
      mt_store8<false>(v, e, vf);
    }
    tail = lo + 8 * nv;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += MT_THREADS) {
    float pf = mt_load<BF16>(p, e), mf = m[e], vf = v[e];
    mt_adamw_elem<BF16>(pf, mt_load<BF16>(g, e), mf, vf, c);
    mt_store<BF16>(p, e, pf);
    m[e] = mf;
    v[e] = vf;
  }
}

__global__ void __launch_bounds__(MT_THREADS)
mt_adamw_kernel(const __grid_constant__ MtAdamwArgs a) {
  const int b = blockIdx.x;
  const int i = mt_leaf(a.start, a.count, b);
  const long long lo = (long long)(b - a.start[i]) * MT_CHUNK;
  const long long hi = min(a.n[i], lo + MT_CHUNK);
  const MtAdamwConsts c{a.lr, a.b1, a.omb1, a.b2, a.omb2, a.eps, a.wd,
                        *a.bc1, *a.bc2, a.scale ? *a.scale : 1.f,
                        a.scale != nullptr};
  if (a.bf16[i])
    mt_adamw_chunk<true>(a.p[i], a.g[i], a.m[i], a.v[i], lo, hi, a.vec[i],
                         c);
  else
    mt_adamw_chunk<false>(a.p[i], a.g[i], a.m[i], a.v[i], lo, hi, a.vec[i],
                          c);
}

// A launch's leaves from the wrapper's table t: the leaf count, the blocks,
// then `fields` int64s a leaf, starting with its elements, its first block,
// bf16 and vec (the pointers follow, read by the caller).  False unless
// they fit the struct and each leaf has its elements' blocks, in order.
template <typename Args, int L>
bool mt_fill(const long long* t, int fields, Args& a, int& blocks) {
  if (t[0] <= 0 || t[0] > L || t[1] <= 0 || t[1] >= (1LL << 31))
    return false;
  a.count = (int)t[0];
  blocks = (int)t[1];
  const long long* leaf = t + 2;
  for (int i = 0; i < a.count; ++i, leaf += fields) {
    a.n[i] = leaf[0];
    a.start[i] = (int)leaf[1];
    a.bf16[i] = (unsigned char)leaf[2];
    a.vec[i] = (unsigned char)leaf[3];
    const long long last = i + 1 < a.count ? leaf[fields + 1] : blocks;
    if (a.n[i] <= 0 || (i == 0 && a.start[0] != 0) ||
        last - a.start[i] != (a.n[i] + MT_CHUNK - 1) / MT_CHUNK)
      return false;
  }
  a.start[a.count] = blocks;
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).  dtype code: 0 float32, 1 bfloat16.
// ---------------------------------------------------------------------------

// p: B, H, KV, Sq, Sk, D, causal, window, dtype, path (0 the FMA tile, 1
// the tensor-core kernel, bf16 only); f: scale, softcap; lse: null, or the
// float32 [B, H, Sq] log-sum-exp output (FlashArgs)
extern "C" int kapla_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     const long long* p, const double* f,
                                     void* stream) {
  FlashArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
              (int)p[6], (int)p[7], (float)f[0], (float)f[1], lse};
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


// p: B, H, NC, Lc, P, N, dtype, hg, xvec, bcvec, grid (x, y), the dynamic
// shared memory in bytes, G (ssd_scan.py ssd_launch); ws: a float32 workspace
// [B, H, NC, Lc, P] where Lc > 128 (y itself for float32), else unused
extern "C" int kapla_ssd_intra_chunk(const void* x, const float* dt,
                                     const float* acum, const float* bmat,
                                     const float* cmat, void* y, float* ws,
                                     const long long* p, void* stream) {
  SsdArgs a{(int)p[0], (int)p[1], (int)p[2], (int)p[3], (int)p[4],
            (int)p[5], (int)p[7], (int)p[13], (int)p[8], (int)p[9]};
  const int dtype = (int)p[6];
  const dim3 grid((unsigned)p[10], (unsigned)p[11]);
  const size_t smem = (size_t)p[12];
  if (a.Lc <= 0 || a.P <= 0 || a.N <= 0 || a.hg <= 0 || a.hg > SSD_HG ||
      a.G <= 0 || a.H % a.G != 0 ||
      (long long)grid.x != (long long)a.B * a.NC ||
      (int)grid.y != a.G * ((a.H / a.G + a.hg - 1) / a.hg) ||
      (a.Lc > SSD_T && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_ssd<float>(x, dt, acum, bmat, cmat, y, ws, a, grid,
                                  smem, s);
  if (dtype == 1)
    return (int)launch_ssd<__nv_bfloat16>(x, dt, acum, bmat, cmat, y, ws, a,
                                          grid, smem, s);
  return (int)cudaErrorInvalidValue;
}


// t: the leaf count, the blocks, then per leaf its elements, first block,
// bf16 (1) or float32 (0), vec (16-byte loads) and the gradient's address
// (multi_tensor.py); partials: a float32 a block of the launch
extern "C" int kapla_mt_sumsq(const long long* t, float* partials,
                              void* stream) {
  MtSumsqArgs a;
  int blocks = 0;
  if (partials == nullptr ||
      !mt_fill<MtSumsqArgs, MT_SUMSQ_LEAVES>(t, 5, a, blocks))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.count; ++i)
    a.g[i] = reinterpret_cast<const void*>(t[2 + 5 * i + 4]);
  a.partials = partials;
  mt_sumsq_kernel<<<blocks, MT_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// p: the count of partials; out: their sum, float32
extern "C" int kapla_mt_total(const float* partials, const long long* p,
                              float* out, void* stream) {
  if (p[0] <= 0 || partials == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  mt_total_kernel<<<1, MT_TOTAL_THREADS, 0, (cudaStream_t)stream>>>(
      partials, p[0], out);
  return (int)cudaGetLastError();
}

// t: as kapla_mt_sumsq's, each leaf's fields followed by the addresses of
// its parameter, gradient, m and v; f: lr, b1, 1 - b1, b2, 1 - b2, eps,
// weight decay (each rounded to float32 here, as PyTorch rounds a Python
// float for a float32 tensor); bc1, bc2: the bias corrections, 0-d float32
// on the card; scale: the clip's, or null
extern "C" int kapla_mt_adamw(const long long* t, const double* f,
                              const float* bc1, const float* bc2,
                              const float* scale, void* stream) {
  MtAdamwArgs a;
  int blocks = 0;
  if (bc1 == nullptr || bc2 == nullptr ||
      !mt_fill<MtAdamwArgs, MT_ADAMW_LEAVES>(t, 8, a, blocks))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.count; ++i) {
    const long long* leaf = t + 2 + 8 * i;
    a.p[i] = reinterpret_cast<void*>(leaf[4]);
    a.g[i] = reinterpret_cast<const void*>(leaf[5]);
    a.m[i] = reinterpret_cast<float*>(leaf[6]);
    a.v[i] = reinterpret_cast<float*>(leaf[7]);
  }
  a.bc1 = bc1;
  a.bc2 = bc2;
  a.scale = scale;
  a.lr = (float)f[0];
  a.b1 = (float)f[1];
  a.omb1 = (float)f[2];
  a.b2 = (float)f[3];
  a.omb2 = (float)f[4];
  a.eps = (float)f[5];
  a.wd = (float)f[6];
  mt_adamw_kernel<<<blocks, MT_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
