// Float32 on the tensor cores: the helpers that fc, conv and attention
// (lower_kernels.cu) are built from.
//
// - cp.async: 16-byte and 4-byte copies from device memory into shared
//   memory that zero-fill past `bytes` (0 copies nothing and writes zeros),
//   commit and wait_group, for the kernels' rings of stages.
// - 3xTF32: x = hi + lo, hi = tf32(x) by masking, lo = x - hi (exact).  A
//   multiply-add a*b is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, three TF32
//   products on mma.sync; the kernels keep hi*hi and the two corrections in
//   separate accumulators and add them at the end of a reduction tile,
//   which keeps float32 accuracy (a single TF32 product keeps ~3 digits).
// - mma.sync m16n8k8 .tf32 with a float32 accumulator.  Fragments (PTX ISA,
//   "mma.m16n8k8", g = lane / 4, t = lane % 4): A a0 (row g, col t), a1
//   (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (row t, col g), b1
//   (t + 4, g); C c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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
// split, not the products, fc's bottleneck).
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

// One 3xTF32 multiply-add of a split A fragment by a split B fragment: the
// corrections into `cor`, hi*hi into `prt`.
__device__ __forceinline__ void mma_3xtf32(float (&prt)[4], float (&cor)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(cor, al, bh);
  mma_tf32(cor, ah, bl);
  mma_tf32(prt, ah, bh);
}

}  // namespace
