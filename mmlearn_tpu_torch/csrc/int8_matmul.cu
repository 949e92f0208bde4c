// Quantizing int8 matrix product y = x . (qw * sw) (kernel K5), Hopper sm_90a.
//
// Replaces the TPU kernel mmlearn_tpu/ops/int8_matmul.py `_qmm_kernel` (:63,
// launched by `int8_qmm` :104, pallas_call :135). Same function, for each row
// i of x (M, K) and each output column j:
//
//   sx_i  = max(max_k |x_ik|, 1e-6) / 127                       (f32)
//   q_ik  = round_half_even(x_ik / sx_i)                        (s8)
//   acc   = sum_k q_ik * qw_jk                                  (s32, exact)
//   y_ij  = float(acc) * (sx_i * sw_j), rounded to x's type
//
// qw is the weight quantized per output column, kept as (N, K) rows with K
// contiguous (torch's own weight layout, and the `col` B operand of the
// tensor-core instruction); sw holds its N f32 scales. Bit-level points: the
// row is divided by its scale (IEEE division: the build has no fast math),
// rounded half to even (__float2int_rn), the s32 sum is converted with
// round-to-nearest (__int2float_rn; at K = 3072 it reaches 4.9e7 > 2^24, so
// neither the conversion nor an f32 accumulation would be exact), and
// sx_i * sw_j is formed before it multiplies.
//
// Design. One block of 256 threads (8 warps) owns BM rows of x (64, or 32 or
// 16 where K is long; see pick_bm) and sweeps every output column itself, as
// the TPU kernel's n-innermost grid reuses its quantized block:
//   1. each warp takes rows; it reads a row once for its absmax (16-byte
//      loads) and again, from the cache, to quantize it into shared memory.
//      The s8 copy of x and its scales never touch device memory, and x
//      comes from device memory once per row block;
//   2. the weight streams through two shared-memory buffers of 128 columns x
//      64 bytes of K (cp.async, the next chunk in flight while the tensor
//      cores work on this one); each warp computes a (BM/2 or BM) x (32 or
//      16) piece of the 128-column tile with
//      mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, fragments read from
//      shared memory 8 bytes at a time. Both operands take their 8 bytes
//      from the same 8 consecutive k, so the products pair the same k: the
//      fragments' k order differs from the instruction's, the sum does not;
//   3. after the last chunk of K a tile is dequantized and stored with its
//      edges masked, and the next 128 columns start.
// Ragged M, N and K are masked: K is zero-padded to a multiple of 64 in
// shared memory, rows past M and columns past N are neither read nor
// written. K a multiple of 16 with 16-byte aligned operands takes the vector
// and cp.async loads; any other K takes byte loads.
//
// What bounds it on the H100. At the image tower's fc1 (M = 256 * 197 =
// 50,432, K = 768, N = 3,072) the product is 2.38e11 int8 operations over
// the 1,979 TOP/s dense int8 peak = 0.120 ms, against 390 MB (x in bf16, qw,
// y in bf16) over 3.35 TB/s = 0.116 ms: it is bound by operations, barely.
// The same product in bf16 at its 989 TFLOP/s peak takes 0.241 ms. This
// kernel uses the legacy mma.sync path, one block of 8 warps per 64 rows and
// a full __syncthreads per 64-byte chunk, and reads the weight from L2 once
// per row block (M / 64 times), so it is far from that bound; wgmma, TMA and
// a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kBlockN = 128;           // output columns per tile
constexpr int kBlockK = 64;            // bytes of K per weight chunk
constexpr int kPad = 32;               // row padding in shared memory (bytes)
constexpr int kLdW = kBlockK + kPad;   // weight chunk row stride
constexpr int kMaxK = 8192;            // supports_int8_qmm's limit
constexpr size_t kSmemLimit = 232448;  // 227 KB a block

// Row strides of 32 or 96 mod 128 bytes put the 8-byte fragment loads of a
// half warp (4 rows x 4 lanes) on 32 different banks.

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

size_t smem_bytes(int bm, int k) {
  return static_cast<size_t>(bm) * (round_up(k, kBlockK) + kPad) +
         2 * kBlockN * kLdW + bm * sizeof(float);
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack4(const int* q) {
  return (static_cast<uint32_t>(q[0]) & 0xffu) | ((static_cast<uint32_t>(q[1]) & 0xffu) << 8) |
         ((static_cast<uint32_t>(q[2]) & 0xffu) << 16) |
         ((static_cast<uint32_t>(q[3]) & 0xffu) << 24);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Quantize row `gr` of x (k values) into dst (kp bytes, zero past k); returns
// the row's scale. One warp.
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

// BM rows a block; WM warps along M and 8 / WM along N. kFast: K % 16 == 0
// and 16-byte aligned operands (vector loads of x, cp.async of the weight).
template <typename T, int BM, int WM, bool kFast>
__global__ void __launch_bounds__(kThreads)
    int8_qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                    const float* __restrict__ sw, T* __restrict__ out, int m, int k, int n) {
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
    const float s = quantize_row<T, kFast>(x + static_cast<size_t>(gr) * k, dst, k, kp, lane);
    if (lane == 0) sx[r] = s;
  }

  // ---- 2. sweep the weight: tile = (128 columns, 64 bytes of K)
  const int ktiles = kp / kBlockK;
  const int tiles = (n + kBlockN - 1) / kBlockN * ktiles;
  auto load_tile = [&](int tile, int buf) {
    const int n0 = tile / ktiles * kBlockN, k0 = tile % ktiles * kBlockK;
    int8_t* dst = wbuf + buf * kBlockN * kLdW;
    if constexpr (kFast) {
      for (int i = threadIdx.x; i < kBlockN * (kBlockK / 16); i += kThreads) {
        const int r = i / (kBlockK / 16), c = i % (kBlockK / 16) * 16;
        const bool ok = n0 + r < n && k0 + c < k;  // K % 16 == 0: chunks are whole
        const int8_t* src = ok ? qw + static_cast<size_t>(n0 + r) * k + k0 + c : qw;
        cp_async16(dst + r * kLdW + c, src, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kBlockN * kBlockK; i += kThreads) {
        const int r = i / kBlockK, c = i % kBlockK;
        dst[r * kLdW + c] = (n0 + r < n && k0 + c < k)
                                ? qw[static_cast<size_t>(n0 + r) * k + k0 + c]
                                : static_cast<int8_t>(0);
      }
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
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      load_tile(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
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
              if (gc < n) {
                orow[gc] = from_float<T>(__int2float_rn(acc[i][j][half * 2 + e]) * (sr * sw[gc]));
              }
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

template <typename T, int BM, int WM, bool kFast>
int launch(const void* x, const void* qw, const void* sw, void* out, int m, int k, int n,
           cudaStream_t stream) {
  auto kernel = int8_qmm_kernel<T, BM, WM, kFast>;
  const size_t smem = smem_bytes(BM, k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(m + BM - 1) / BM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw), static_cast<const float*>(sw),
      static_cast<T*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// The most rows a block whose quantized copy of x and weight buffers fit.
int pick_bm(int k) {
  const int candidates[] = {64, 32, 16};
  for (int bm : candidates)
    if (smem_bytes(bm, k) <= kSmemLimit) return bm;
  return 0;
}

template <typename T, bool kFast>
int dispatch(const void* x, const void* qw, const void* sw, void* out, int m, int k, int n,
             cudaStream_t s) {
  switch (pick_bm(k)) {
    case 64: return launch<T, 64, 2, kFast>(x, qw, sw, out, m, k, n, s);
    case 32: return launch<T, 32, 2, kFast>(x, qw, sw, out, m, k, n, s);
    case 16: return launch<T, 16, 1, kFast>(x, qw, sw, out, m, k, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run(const void* x, const void* qw, const void* sw, void* out, int m, int k, int n,
        cudaStream_t s) {
  const bool fast = k % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  return fast ? dispatch<T, true>(x, qw, sw, out, m, k, n, s)
              : dispatch<T, false>(x, qw, sw, out, m, k, n, s);
}

}  // namespace

extern "C" {

// x: (m, k) row-major, dtype 0 = float32, 1 = bfloat16; qw: (n, k) int8
// row-major; sw: n float32; out: (m, n) in x's type. 1 <= k <= 8192.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
int mmlearn_int8_qmm(const void* x, const void* qw, const void* sw, void* out, int m, int k,
                     int n, int dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, qw, sw, out, m, k, n, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, qw, sw, out, m, k, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mmlearn_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
