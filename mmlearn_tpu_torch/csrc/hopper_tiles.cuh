// Hopper building blocks of the port's kernels on wgmma and TMA, sm_90a:
// flash attention (K3, csrc/flash_attention.cu) and the quantizing int8
// product (K5, csrc/int8_matmul.cu); included once by a source.
//
// - mbarriers: init, arrive (also with the bytes TMA will land) and a
//   parity wait that stops the kernel (a failed launch, never a hung card)
//   after about ten seconds;
// - TMA: 2-d and 4-d tile loads through a CUtensorMap (encoded on the host
//   by encode_tiled(), passed as a __grid_constant__ parameter) that
//   complete on an mbarrier;
// - wgmma: shared-memory descriptors of swizzled tiles, fence, commit and
//   wait, m64nNk16 products (bf16 in, f32 accumulators) with both operands
//   in shared memory (SS, N = 64) or A in registers (RS, N = 32 or 64), and
//   the m64n256k32 product of s8 operands into s32 accumulators (SS);
// - setmaxnreg, to move registers from a producer warpgroup to consumers.
//
// Tiles are rows of 64 or 128 bytes (one swizzle span: D bf16 at D = 32 or
// 64, a 32-column span of a wider row, or 128 s8 of K) written by TMA with
// the matching swizzle (64-byte or 128-byte), each tile 1024-byte aligned. One descriptor serves both readings of a bf16
// tile: as a K-major operand (its rows are the product's M or N, D its
// contraction, stepped by 32 bytes a k16 slice) and, with the instruction's
// transpose flag, as an MN-major B operand (its rows are the contraction,
// stepped by 16 rows a slice, D the product's N). An s8 tile is always read
// K-major (the instruction has no transpose for integers), stepped by 32
// bytes a k32 slice: the same descriptor as a bf16 tile of 128-byte rows.
// SBO is 8 rows; LBO is unused (the contraction never leaves one swizzle
// span, N never exceeds one: a wider row is split into spans, each its own
// tile, and a product over it into one product a span).
//
// Accumulator layout of m64nN (f32 or s32) for thread 32 w + 4 g + t of a
// warpgroup: d[4 c + e] is row 16 w + g + 8 (e / 2), column 8 c + 2 t + e % 2.
// The A operand in registers of m64k16 has the layout of mma.sync m16n8k16 on
// each warp's 16 rows, so an accumulator's columns 16 kc .. 16 kc + 15 pack
// into the A operand of the next product (as_a).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// cycles a thread waits on an mbarrier before it stops the kernel
constexpr long long kSpinLimit = 1LL << 34;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// after a thread's inits, before the block's barrier: visible to TMA too
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival, and `bytes` more to land by TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kSpinLimit) __trap();
  }
}

// ------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// The box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst; completes its bytes on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the box of `map` at coordinates (c0, c1), innermost first
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// ------------------------------------------------------------ setmaxnreg

// the warpgroup's registers a thread, down to (or up to) N; every warp of
// the warpgroup executes it
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ----------------------------------------------------------------- wgmma

// Descriptor of a tile of 64-byte (D = 32) or 128-byte (D = 64) rows written
// by TMA with the swizzle of that span, 1024-byte aligned.
template <int kRowBytes>
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  static_assert(kRowBytes == 64 || kRowBytes == 128, "rows of one swizzle span");
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // 128-byte or 64-byte swizzle
  constexpr uint64_t kSbo = 8 * kRowBytes;                 // 8-row groups
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         ((kSbo >> 4) << 32) | (kLayout << 62);
}
// the descriptor moved by `bytes` (a multiple of 16)
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that a wgmma
// in flight owns across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// the same for A operands in registers: live until the product has read them
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
// A operand (m64k16, bf16) of accumulator columns 16 kc .. 16 kc + 15
template <int N>
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&d)[N], int kc) {
  a[0] = pack_bf16(d[8 * kc + 0], d[8 * kc + 1]);
  a[1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
}

#define HOPPER_D8(b)                                                                        \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
      "+f"(d[b + 6]), "+f"(d[b + 7])

// d (m64 x N, f32) = A B + (accumulate ? d : 0), bf16 operands. SS: A and B
// by descriptor, both K-major (the scores: N = 64, a key tile); RS: A in
// registers, kTransB = 1 reads B MN-major (N = D).
template <int N>
struct Mma;

template <>
struct Mma<32> {
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : HOPPER_D8(0), HOPPER_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
};

#define HOPPER_R8(b)                                                                        \
  "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), \
      "+r"(d[b + 6]), "+r"(d[b + 7])

// d (m64 x 256, s32) = A B + (accumulate ? d : 0), s8 operands by
// descriptor, both K-major: an exact integer sum
__device__ __forceinline__ void mma_s8_n256(int (&d)[128], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40), HOPPER_R8(48), HOPPER_R8(56),
        HOPPER_R8(64), HOPPER_R8(72), HOPPER_R8(80), HOPPER_R8(88),
        HOPPER_R8(96), HOPPER_R8(104), HOPPER_R8(112), HOPPER_R8(120)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef HOPPER_R8
#undef HOPPER_D8

}  // namespace hopper
