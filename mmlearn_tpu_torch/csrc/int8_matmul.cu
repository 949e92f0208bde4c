// Quantizing int8 matrix product y = x . (qw * sw) (+ bias) (kernel K5),
// Hopper sm_90a.
//
// Replaces the TPU kernel mmlearn_tpu/ops/int8_matmul.py `_qmm_kernel` (:63,
// launched by `int8_qmm` :104, pallas_call :135). Same function, for each row
// i of x (M, K) and each output column j:
//
//   sx_i  = max(max_k |x_ik|, 1e-6) / 127                       (f32)
//   q_ik  = round_half_even(x_ik / sx_i)                        (s8)
//   acc   = sum_k q_ik * qw_jk                                  (s32, exact)
//   y_ij  = float(acc) * (sx_i * sw_j), rounded to x's type
//   (+ bias_j: float(y_ij) + float(bias_j), rounded to x's type again, the
//   two roundings of the separate add `y + bias` it takes the place of)
//
// qw is the weight quantized per output column, kept as (N, K) rows with K
// contiguous (torch's own weight layout); sw holds its N f32 scales. Bit-level
// points: the row is divided by its scale (IEEE division: the build has no
// fast math), rounded half to even (__float2int_rn), the s32 sum is converted
// with round-to-nearest (__int2float_rn; at K = 3072 it reaches 4.9e7 > 2^24,
// so neither the conversion nor an f32 accumulation would be exact), sx_i *
// sw_j is formed before it multiplies, and the epilogue's products and sums
// are __fmul_rn / __fadd_rn, which the compiler does not contract into FMAs.
//
// What bounds it on the H100. At the image tower's fc1 (M = 256 * 197 =
// 50,432, K = 768, N = 3,072) the product is 2.38e11 int8 operations over
// the 1,979 TOP/s dense int8 peak = 0.120 ms, against 390 MB (x in bf16, qw,
// y in bf16) over 3.35 TB/s = 0.116 ms: bound by operations, barely.
//
// Design: two paths, chosen by shape before any launch (not a fallback).
//
// The TMA path (K % 16 == 0, x and qw 16-byte aligned: every product of the
// towers) is two launches, counted as one K5 call:
//   1. quantize: one warp a row, 16-byte loads; the row's absmax, then the
//      row again (from L1) divided, rounded and written as s8, with its scale,
//      to device memory (the qx and sx scratch the wrapper allocates);
//   2. the product on wgmma m64n256k32 .s32.s8.s8: a persistent block on each
//      SM of two consumer warpgroups (64 rows each: a 128 x 256 tile) and a
//      producer warpgroup whose one thread brings 128-byte slices of K of qx
//      (128 rows) and qw (256 rows) by TMA through 2-d tensor maps (128-byte
//      swizzle, zeros past M, N and K) into a ring of three 48 KB stages,
//      each with a full and an empty mbarrier; setmaxnreg gives the consumers
//      232 registers (the 128 s32 accumulators of their m64n256 tile) and
//      the producer 40. Tiles go N-fastest over the persistent blocks, so the
//      132 tiles in flight share about eleven 128-row strips of qx and the
//      whole weight, which stays in L2 (2.4 MB at fc1): qx and qw come from
//      device memory about once. The epilogue dequantizes (and adds the
//      bias) from the accumulators; a bf16 output with N % 8 == 0 is written
//      into a 64 KB staging tile in shared memory (128-byte swizzle, no bank
//      conflicts) and stored by TMA while the next tile's products run, any
//      other output straight from the registers.
// Quantizing in a pass of its own moves x once more (0.035 ms of bytes at
// fc1, 0.14 ms at fc2) but lets both operands stream by TMA; PERF.md holds
// the measurement.
//
// The byte path (any other K, or a misaligned operand): the first design's kernel on
// mma.sync m16n8k32. One block of 8 warps owns BM rows of x (64, or 32 or 16
// where K is long; see pick_bm), quantizes them into shared memory with byte
// loads and sweeps every output column, the weight streaming through two
// shared-memory buffers of 128 columns x 64 bytes of K; K zero-padded to a
// multiple of 64 in shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kMaxK = 8192;            // supports_int8_qmm's limit
constexpr size_t kSmemLimit = 232448;  // 227 KB a block

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// y = float(acc) * (sr * sc) in x's type
template <typename T>
__device__ __forceinline__ T dequantize(int acc, float sr, float sc) {
  return from_float<T>(__fmul_rn(__int2float_rn(acc), __fmul_rn(sr, sc)));
}
// then y + b in x's type (b: the bias in x's type, widened)
template <typename T>
__device__ __forceinline__ T add_bias(T y, float b) {
  return from_float<T>(__fadd_rn(to_float(y), b));
}
template <typename T>
__device__ __forceinline__ T dequantize(int acc, float sr, float sc, const T* bias, int col) {
  const T y = dequantize<T>(acc, sr, sc);
  return bias == nullptr ? y : add_bias(y, to_float(bias[col]));
}

__device__ __forceinline__ uint32_t pack4(const int* q) {
  return (static_cast<uint32_t>(q[0]) & 0xffu) | ((static_cast<uint32_t>(q[1]) & 0xffu) << 8) |
         ((static_cast<uint32_t>(q[2]) & 0xffu) << 16) |
         ((static_cast<uint32_t>(q[3]) & 0xffu) << 24);
}

// Quantize one row of x (k values) into dst (kp bytes, zero past k); returns
// the row's scale. One warp. kVec: k % 16 == 0 and 16-byte aligned rows.
template <typename T, bool kVec>
__device__ __forceinline__ float quantize_row(const T* __restrict__ src, int8_t* dst, int k,
                                              int kp, int lane) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  float amax = 0.f;
  if constexpr (kVec) {
    for (int c = lane * E; c < k; c += 32 * E) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(to_float(e[i])));
    }
  } else {
    for (int c = lane; c < k; c += 32) amax = fmaxf(amax, fabsf(to_float(src[c])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax, 1e-6f) / 127.0f;
  if constexpr (kVec) {
    for (int c = lane * E; c < k; c += 32 * E) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + c);
      const T* e = reinterpret_cast<const T*>(&v);
      int q[E];
#pragma unroll
      for (int i = 0; i < E; ++i) q[i] = __float2int_rn(to_float(e[i]) / s);
      if constexpr (E == 8) {
        *reinterpret_cast<uint2*>(dst + c) = make_uint2(pack4(q), pack4(q + 4));
      } else {
        *reinterpret_cast<uint32_t*>(dst + c) = pack4(q);
      }
    }
  } else {
    for (int c = lane; c < k; c += 32) dst[c] = static_cast<int8_t>(__float2int_rn(to_float(src[c]) / s));
  }
  for (int c = k + lane; c < kp; c += 32) dst[c] = 0;
  return s;
}

// ============================================================ TMA path

constexpr int kQuantWarps = 8;          // quantize: rows a block
constexpr int kTileM = 128;             // product: rows of a tile (two warpgroups)
constexpr int kTileN = 256;             // columns of a tile
constexpr int kSliceK = 128;            // bytes of K a stage: one 128-byte swizzle span
constexpr int kStages = 3;
constexpr int kATile = kTileM * kSliceK;  // 16 KB
constexpr int kBTile = kTileN * kSliceK;  // 32 KB
constexpr int kOutBox = 64;               // bf16 output staged as 64 x 64 boxes (128-byte rows)
constexpr int kOutTile = kTileM * kTileN * 2;  // 64 KB: both warpgroups' rows
constexpr int kGemmThreads = 384;         // producer warpgroup + two consumer warpgroups
// per consumer warpgroup: the tile's column scales (f32) and bias (bf16)
constexpr int kEpilogue = kTileN * (4 + 2);
constexpr int kGemmSmem =
    1024 + kStages * (kATile + kBTile) + kOutTile + 2 * kEpilogue + 2 * kStages * 8;

template <typename T>
__global__ void __launch_bounds__(32 * kQuantWarps)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ qx, float* __restrict__ sx,
                         int m, int k) {
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const long long base = static_cast<long long>(row) * k;
  const float s = quantize_row<T, true>(x + base, qx + base, k, k, lane);
  if (lane == 0) sx[row] = s;
}

// generic-proxy writes to shared memory visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup `cw` (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}
// the box at smem to `map` at coordinates (c0, c1), in the bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the dynamic shared memory, 1024-byte aligned (the swizzle's period)
__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, bf16 a, bf16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// kStore: bf16 output with N % 8 == 0, staged in shared memory and written
// by TMA while the next tile's products run; otherwise stored from the
// registers.
template <typename T, bool kStore>
__global__ void __launch_bounds__(kGemmThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_out, const float* __restrict__ sx,
                     const float* __restrict__ sw, const T* __restrict__ bias,
                     T* __restrict__ out, int m, int n, int k) {
  uint8_t* a_s = aligned_smem();                    // kStages x (128 rows x 128 bytes)
  uint8_t* b_s = a_s + kStages * kATile;            // kStages x (256 rows x 128 bytes)
  uint8_t* o_s = b_s + kStages * kBTile;            // per warpgroup 4 boxes of 64 x 64 bf16
  uint8_t* e_s = o_s + kOutTile;                    // per warpgroup the tile's scales, bias
  uint64_t* full = reinterpret_cast<uint64_t*>(e_s + 2 * kEpilogue);
  uint64_t* empty = full + kStages;
  const int tiles_n = (n + kTileN - 1) / kTileN;
  const int tiles = (m + kTileM - 1) / kTileM * tiles_n;
  const int slices = (k + kSliceK - 1) / kSliceK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);   // the producer, with the bytes
      mbar_init(empty + s, 2);  // thread 0 of each consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread starts the copies
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&map_a);
      tma_prefetch(&map_b);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kTileM, n0 = tile % tiles_n * kTileN;
        for (int ks = 0; ks < slices; ++ks, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, kATile + kBTile);
          tma_load_2d(a_s + s * kATile, &map_a, full + s, ks * kSliceK, m0);
          tma_load_2d(b_s + s * kBTile, &map_b, full + s, ks * kSliceK, n0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 cw .. 64 cw + 63
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const int g = lane / 4, t = lane % 4;
  const bool pairs = n % 2 == 0;
  int acc[kTileN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kTileM, n0 = tile % tiles_n * kTileN;
    for (int ks = 0; ks < slices; ++ks, ++it) {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      const uint64_t a_desc = tile_desc<kSliceK>(a_s + s * kATile + cw * 64 * kSliceK);
      const uint64_t b_desc = tile_desc<kSliceK>(b_s + s * kBTile);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kSliceK / 32; ++kc)
        mma_s8_n256(acc, desc_add(a_desc, 32 * kc), desc_add(b_desc, 32 * kc), ks + kc > 0);
      wgmma_commit();
      if (ks > 0) {  // the slice before this one is read: its stage is free
        wgmma_wait<1>();
        if (tw == 0) mbar_arrive(empty + (it - 1) % kStages);
      }
    }
    float* sw_s = reinterpret_cast<float*>(e_s + cw * kEpilogue);
    bf16* bias_s = reinterpret_cast<bf16*>(sw_s + kTileN);
    if constexpr (kStore) {
      // the tile's column scales and bias while its last products run (every
      // thread of the warpgroup has read the last tile's at its second
      // barrier below)
      for (int j = tw; j < kTileN; j += 128) {
        const bool in = n0 + j < n;
        sw_s[j] = in ? sw[n0 + j] : 0.f;
        if (bias != nullptr) bias_s[j] = in ? bias[n0 + j] : from_float<bf16>(0.f);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tw == 0) mbar_arrive(empty + (it - 1) % kStages);

    // dequantize (and add the bias): row lo and hi of this thread, columns
    // 8 c + 2 t and 8 c + 2 t + 1
    const int r_lo = m0 + 64 * cw + 16 * warp + g, r_hi = r_lo + 8;
    const float s_lo = r_lo < m ? sx[r_lo] : 0.f, s_hi = r_hi < m ? sx[r_hi] : 0.f;
    if constexpr (kStore) {
      // this warpgroup's 64 rows as four boxes of 64 columns, 128-byte rows
      // in the 128-byte swizzle: chunk c % 8 of row r lands at (c % 8) ^ (r % 8)
      uint8_t* stage = o_s + cw * (kOutTile / 2);
      if (tw == 0) bulk_wait_read();  // the last tile's stores have read it
      warpgroup_sync(cw);             // and the scales and bias are in place
      const int r = 16 * warp + g;  // and r + 8: the same r % 8
#pragma unroll
      for (int c = 0; c < kTileN / 8; ++c) {
        const int j = 8 * c + 2 * t;  // past n: not stored
        const float2 sc = *reinterpret_cast<const float2*>(sw_s + j);
        float2 bb = make_float2(0.f, 0.f);
        if (bias != nullptr) bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_s + j));
        uint8_t* box = stage + (c / 8) * (kOutBox * 128) + (((c % 8) ^ g) * 16) + t * 4;
        __nv_bfloat162 lo, hi;
        lo.x = dequantize<bf16>(acc[4 * c + 0], s_lo, sc.x);
        lo.y = dequantize<bf16>(acc[4 * c + 1], s_lo, sc.y);
        hi.x = dequantize<bf16>(acc[4 * c + 2], s_hi, sc.x);
        hi.y = dequantize<bf16>(acc[4 * c + 3], s_hi, sc.y);
        if (bias != nullptr) {
          lo.x = add_bias(lo.x, bb.x);
          lo.y = add_bias(lo.y, bb.y);
          hi.x = add_bias(hi.x, bb.x);
          hi.y = add_bias(hi.y, bb.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(box + r * 128) = lo;
        *reinterpret_cast<__nv_bfloat162*>(box + (r + 8) * 128) = hi;
      }
      fence_proxy_async();
      warpgroup_sync(cw);
      if (tw == 0) {
#pragma unroll
        for (int b = 0; b < kTileN / kOutBox; ++b)
          tma_store_2d(&map_out, stage + b * (kOutBox * 128), n0 + b * kOutBox, m0 + 64 * cw);
        bulk_commit();
      }
      continue;
    }
    T* o_lo = out + static_cast<long long>(r_lo) * n;
    T* o_hi = out + static_cast<long long>(r_hi) * n;
#pragma unroll
    for (int c = 0; c < kTileN / 8; ++c) {
      const int col = n0 + 8 * c + 2 * t;
      if (pairs && col < n) {  // col + 1 < n too
        const float2 sc = *reinterpret_cast<const float2*>(sw + col);
        if (r_lo < m)
          store_pair(o_lo + col, dequantize<T>(acc[4 * c + 0], s_lo, sc.x, bias, col),
                     dequantize<T>(acc[4 * c + 1], s_lo, sc.y, bias, col + 1));
        if (r_hi < m)
          store_pair(o_hi + col, dequantize<T>(acc[4 * c + 2], s_hi, sc.x, bias, col),
                     dequantize<T>(acc[4 * c + 3], s_hi, sc.y, bias, col + 1));
      } else if (!pairs) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= n) continue;
          const float sc = sw[col + e];
          if (r_lo < m) o_lo[col + e] = dequantize<T>(acc[4 * c + e], s_lo, sc, bias, col + e);
          if (r_hi < m) o_hi[col + e] = dequantize<T>(acc[4 * c + 2 + e], s_hi, sc, bias, col + e);
        }
      }
    }
  }
  if (kStore && tw == 0) bulk_wait_read();  // shared memory outlives the stores' reads
}

// Binds the calling thread to its current device's primary context: encoding
// a tensor map needs a current context, and the autograd engine's thread may
// have none (a first backward).
cudaError_t bind_context() {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? cudaSetDevice(device) : err;
}

// The tensor map of a (rows, cols) row-major matrix of `type` (elements of
// `elem` bytes) in boxes of 128 bytes of a row by box_rows rows, 128-byte
// swizzle; loads see zeros past its edges, stores stop at them.
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                     int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t gstride[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), gdim, gstride, box, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // CUresult and cudaError_t share the codes an encode returns
  return static_cast<cudaError_t>(r);
}

template <typename T, bool kStore>
cudaError_t run_tma(const void* x, const void* qw, const void* sw, const void* bias, void* out,
                    void* qx, void* sx, int m, int k, int n, cudaStream_t stream) {
  static int sms = 0;
  cudaError_t err;
  CUtensorMap map_a, map_b, map_out{};
  constexpr CUtensorMapDataType kS8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if ((err = bind_context()) || (err = make_map(&map_a, kS8, 1, qx, m, k, kTileM)) ||
      (err = make_map(&map_b, kS8, 1, qw, n, k, kTileN)) ||
      (kStore && (err = make_map(&map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, m, n,
                                 kOutBox))))
    return err;
  if (sms == 0) {
    int device;
    if ((err = cudaGetDevice(&device)) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
      return err;
  }
  if ((err = cudaFuncSetAttribute(int8_gemm_kernel<T, kStore>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem)))
    return err;
  quantize_rows_kernel<T><<<(m + kQuantWarps - 1) / kQuantWarps, 32 * kQuantWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(qx), static_cast<float*>(sx), m, k);
  if ((err = cudaGetLastError())) return err;
  const int tiles = (m + kTileM - 1) / kTileM * ((n + kTileN - 1) / kTileN);
  int8_gemm_kernel<T, kStore><<<tiles < sms ? tiles : sms, kGemmThreads, kGemmSmem, stream>>>(
      map_a, map_b, map_out, static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const T*>(bias), static_cast<T*>(out), m, n, k);
  return cudaGetLastError();
}

// =========================================================== byte path

constexpr int kThreads = 256;          // 8 warps
constexpr int kBlockN = 128;           // output columns per tile
constexpr int kBlockK = 64;            // bytes of K per weight chunk
constexpr int kPad = 32;               // row padding in shared memory (bytes)
constexpr int kLdW = kBlockK + kPad;   // weight chunk row stride

// Row strides of 32 or 96 mod 128 bytes put the 8-byte fragment loads of a
// half warp (4 rows x 4 lanes) on 32 different banks.

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

size_t smem_bytes(int bm, int k) {
  return static_cast<size_t>(bm) * (round_up(k, kBlockK) + kPad) +
         2 * kBlockN * kLdW + bm * sizeof(float);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// BM rows a block; WM warps along M and 8 / WM along N.
template <typename T, int BM, int WM>
__global__ void __launch_bounds__(kThreads)
    int8_qmm_bytes_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                          const float* __restrict__ sw, const T* __restrict__ bias,
                          T* __restrict__ out, int m, int k, int n) {
  constexpr int WN = 8 / WM;
  constexpr int kWarpM = BM / WM;       // rows a warp
  constexpr int kWarpN = kBlockN / WN;  // columns a warp
  constexpr int MT = kWarpM / 16;
  constexpr int NT = kWarpN / 8;
  static_assert(MT >= 1 && NT >= 1, "warp tile");

  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = round_up(k, kBlockK);
  const int ldx = kp + kPad;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  int8_t* wbuf = xq + BM * ldx;
  float* sx = reinterpret_cast<float*>(wbuf + 2 * kBlockN * kLdW);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;

  // ---- 1. quantize the block's rows into shared memory
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int gr = row0 + r;
    int8_t* dst = xq + r * ldx;
    if (gr >= m) {
      for (int c = lane * 4; c < kp; c += 128) *reinterpret_cast<uint32_t*>(dst + c) = 0u;
      if (lane == 0) sx[r] = 0.f;
      continue;
    }
    const float s = quantize_row<T, false>(x + static_cast<size_t>(gr) * k, dst, k, kp, lane);
    if (lane == 0) sx[r] = s;
  }

  // ---- 2. sweep the weight: tile = (128 columns, 64 bytes of K)
  const int ktiles = kp / kBlockK;
  const int tiles = (n + kBlockN - 1) / kBlockN * ktiles;
  auto load_tile = [&](int tile, int buf) {
    const int n0 = tile / ktiles * kBlockN, k0 = tile % ktiles * kBlockK;
    int8_t* dst = wbuf + buf * kBlockN * kLdW;
    for (int i = threadIdx.x; i < kBlockN * kBlockK; i += kThreads) {
      const int r = i / kBlockK, c = i % kBlockK;
      dst[r * kLdW + c] = (n0 + r < n && k0 + c < k)
                              ? qw[static_cast<size_t>(n0 + r) * k + k0 + c]
                              : static_cast<int8_t>(0);
    }
  };

  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_tile(0, 0);
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load_tile(it + 1, (it + 1) & 1);
    __syncthreads();  // this chunk (and, at it == 0, the quantized rows) visible
    const int kc = it % ktiles;
    const int8_t* wb = wbuf + (it & 1) * kBlockN * kLdW + (wn * kWarpN + g) * kLdW + t * 8;
    const int8_t* xa = xq + (wm * kWarpM + g) * ldx + kc * kBlockK + t * 8;
#pragma unroll
    for (int kk = 0; kk < kBlockK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint2 lo = *reinterpret_cast<const uint2*>(xa + i * 16 * ldx + kk);
        const uint2 hi = *reinterpret_cast<const uint2*>(xa + (i * 16 + 8) * ldx + kk);
        a[i][0] = lo.x;  // rows g,     k 0-3 of the fragment
        a[i][1] = hi.x;  // rows g + 8, k 0-3
        a[i][2] = lo.y;  // rows g,     k 16-19
        a[i][3] = hi.y;  // rows g + 8, k 16-19
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 v = *reinterpret_cast<const uint2*>(wb + j * 8 * kLdW + kk);
        b[j][0] = v.x;
        b[j][1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }

    if (kc == ktiles - 1) {  // ---- 3. dequantize and store this tile
      const int n0 = it / ktiles * kBlockN + wn * kWarpN;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = wm * kWarpM + i * 16 + g + half * 8;
          const int gr = row0 + rl;
          if (gr >= m) continue;
          const float sr = sx[rl];
          T* orow = out + static_cast<size_t>(gr) * n;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gc = n0 + j * 8 + t * 2 + e;
              if (gc < n) orow[gc] = dequantize<T>(acc[i][j][half * 2 + e], sr, sw[gc], bias, gc);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

template <typename T, int BM, int WM>
cudaError_t launch_bytes(const void* x, const void* qw, const void* sw, const void* bias,
                         void* out, int m, int k, int n, cudaStream_t stream) {
  auto kernel = int8_qmm_bytes_kernel<T, BM, WM>;
  const size_t smem = smem_bytes(BM, k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(m + BM - 1) / BM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw), static_cast<const float*>(sw),
      static_cast<const T*>(bias), static_cast<T*>(out), m, k, n);
  return cudaGetLastError();
}

// The most rows a block whose quantized copy of x and weight buffers fit.
int pick_bm(int k) {
  const int candidates[] = {64, 32, 16};
  for (int bm : candidates)
    if (smem_bytes(bm, k) <= kSmemLimit) return bm;
  return 0;
}

template <typename T>
cudaError_t run_bytes(const void* x, const void* qw, const void* sw, const void* bias, void* out,
                      int m, int k, int n, cudaStream_t s) {
  switch (pick_bm(k)) {
    case 64: return launch_bytes<T, 64, 2>(x, qw, sw, bias, out, m, k, n, s);
    case 32: return launch_bytes<T, 32, 2>(x, qw, sw, bias, out, m, k, n, s);
    case 16: return launch_bytes<T, 16, 1>(x, qw, sw, bias, out, m, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The TMA path. x: (m, k) row-major, dtype 0 = float32, 1 = bfloat16; qw:
// (n, k) int8 row-major; sw: n float32; bias: n in x's type, or null; out:
// (m, n) in x's type; qx: (m, k) int8 and sx: m float32, scratch. k a
// multiple of 16 up to 8192, x and qw 16-byte aligned. Launches the quantize
// pass and the product on `stream` without synchronising; returns the
// launches' cudaError_t (0 on success).
int mmlearn_int8_qmm(const void* x, const void* qw, const void* sw, const void* bias, void* out,
                     void* qx, void* sx, int m, int k, int n, int dtype, void* stream) {
  if (m < 1 || n < 1 || k < 16 || k > kMaxK || k % 16 != 0 || !aligned16(x) || !aligned16(qw) ||
      !aligned16(qx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(run_tma<float, false>(x, qw, sw, bias, out, qx, sx, m, k, n, s));
  if (dtype == 1 && n % 8 == 0 && aligned16(out))
    return static_cast<int>(run_tma<bf16, true>(x, qw, sw, bias, out, qx, sx, m, k, n, s));
  if (dtype == 1)
    return static_cast<int>(run_tma<bf16, false>(x, qw, sw, bias, out, qx, sx, m, k, n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The byte path: the same operands without the scratch, any 1 <= k <= 8192
// and any alignment.
int mmlearn_int8_qmm_bytes(const void* x, const void* qw, const void* sw, const void* bias,
                           void* out, int m, int k, int n, int dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(run_bytes<float>(x, qw, sw, bias, out, m, k, n, s));
  if (dtype == 1) return static_cast<int>(run_bytes<bf16>(x, qw, sw, bias, out, m, k, n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mmlearn_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
