// Tensor-core building blocks shared by the port's bf16 short-sequence
// attention kernels: K1 (csrc/fused_attention.cu) and K1-p
// (csrc/fused_attention_packed.cu, through csrc/k1_arithmetic.cuh). Hopper,
// sm_90a; included once by each source, inside no namespace of its own.
//
// cp.async 16-byte copies into shared memory, mma.sync m16n8k16 (bf16 in,
// f32 sums) and ldmatrix B operands (plain and transposed). Fragment layout
// of m16n8k16 for lane = 4 g + t: A rows g and g + 8, columns 2 t, 2 t + 1
// (+ 8); B column g, rows 2 t, 2 t + 1 (+ 8); C rows g and g + 8, columns
// 2 t, 2 t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// -0.7 * FLT_MAX rounded to f32 (bits 0xff333332), the JAX package's
// DEFAULT_MASK_VALUE and the port's NEG, bit for bit
constexpr float kNeg = -0x1.666664p+127f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// B operands of two n8 tiles (b[0..1] for rows n0..n0+7, b[2..3] for
// n0+8..n0+15) from a row-major tile whose rows are the product's n and
// columns its k (k0..k0+15): S = Q K^T reads K this way.
__device__ __forceinline__ void load_b_rows(uint32_t* b, const bf16* x, int ld, int n0, int k0,
                                            int lane) {
  const int r = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = k0 + (((lane >> 3) & 1) << 3);
  ldsm_x4(b, x + r * ld + c);
}

// B operands of two n8 tiles (columns n0..n0+7 and n0+8..n0+15) from a
// row-major tile whose rows are the product's k (k0..k0+15): O = P V reads V
// this way, transposed by ldmatrix.
__device__ __forceinline__ void load_b_cols(uint32_t* b, const bf16* x, int ld, int k0, int n0,
                                            int lane) {
  const int r = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int c = n0 + ((lane >> 4) << 3);
  ldsm_x4_trans(b, x + r * ld + c);
}

}  // namespace
