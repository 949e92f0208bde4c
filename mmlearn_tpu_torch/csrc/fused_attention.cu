// Fused short-sequence multi-head attention, forward (Hopper, sm_90a).
//
// Replaces the TPU kernel mmlearn_tpu/ops/fused_attention.py `_fwd_kernel`
// (:173, launched by `_fwd_pallas` :655). Same function: exact softmax
// attention over a sequence of N <= 2048 tokens that reads the head-major
// packed projection in place -- for head h, q at column h*3D, k at h*3D+D,
// v at h*3D+2D, row stride H*3*D -- and writes (B, N, H*D) with no permute
// before or after. Scores and softmax statistics are f32; masked and
// causal-excluded scores take the finite value NEG = -0.7 * FLT_MAX (the TPU
// kernel's `_NEG`), so a row whose every key is masked averages V over all N
// keys, as the TPU kernel does.
//
// Design. One thread block per (sample, head, tile of 64 query rows). K and V
// stream through shared memory in tiles of 64 keys, with an online softmax in
// f32 across the tiles, so every N the dispatch admits runs: K/V of one head
// at N = 2048 (2048 x 64 x 2 B x 2 = 512 KB) would not fit the SM's 227 KB.
// The TPU kernel normalises p / l and rounds it to the input type before the
// PV product; this kernel rounds the unnormalised p to the input type, sums
// P V in f32 and divides by l at the end, the same function to within one
// rounding of the input type. Ragged edges (N = 197, 77) are masked on every
// load and store; keys past N score -inf so they drop out exactly. Under a
// causal mask with no key mask, key tiles wholly above the diagonal are
// skipped: each row then still sees key 0, so they add exp(NEG - m) = 0. With
// a key mask no tile is skipped, because a row whose visible keys are all
// masked must average V over all N keys.
//
// The arithmetic is scalar f32 FMAs: each of the 256 threads owns a 4 x 4
// block of the 64 x 64 score tile and 4 rows x D/16 columns of the output.
// What bounds it on the H100: at N = 197, D = 64 a head costs about
// 4 * 197^2 * 64 = 9.9 MFLOP against about 197 * 64 * 2 B * 4 = 100 KB moved,
// so it is far from the memory roof; the scalar loops and their shared-memory
// reads bound it, with occupancy. Tensor-core `mma.sync`/`wgmma` tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per thread block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kLdP = kBlockK + 1;
constexpr float kNeg = -0.7f * FLT_MAX;

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

template <int D>
constexpr size_t smem_bytes() {
  // q and k tiles padded to D + 1 floats a row (no bank conflicts when 16
  // threads read 16 rows at one column), v unpadded, p padded.
  return sizeof(float) *
         (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fused_mha_fwd_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         T* __restrict__ out, int n, int num_heads, float scale,
                         int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * kLd;
  float* v_s = k_s + kBlockK * kLd;
  float* p_s = v_s + kBlockK * D;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16 j; output columns tx + 16 c
  const int ty = tid >> 4;  // rows 4 ty .. 4 ty + 3

  const int64_t row_stride = static_cast<int64_t>(num_heads) * 3 * D;
  const T* head = qkv + static_cast<int64_t>(b) * n * row_stride +
                  static_cast<int64_t>(h) * 3 * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    q_s[r * kLd + c] = row < n ? to_float(head[row * row_stride + c]) : 0.f;
  }

  float m_run[4], l_run[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = (causal && !key_valid) ? min(n, q0 + kBlockQ) : n;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's k_s / v_s / p_s are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (row < n) {
        const T* src = head + row * row_stride;
        kv = to_float(src[D + c]);
        vv = to_float(src[2 * D + c]);
      }
      k_s[r * kLd + c] = kv;
      v_s[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + 4 * ty + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kcol = k0 + tx + 16 * j;
        float v;
        if (kcol >= n) {
          v = -INFINITY;  // past the sequence: contributes exactly nothing
        } else {
          v = s[i][j] * scale;
          if (key_valid && !key_valid[kcol]) v = kNeg;
          if (causal && kcol > qrow) v = kNeg;
        }
        s[i][j] = v;
        row_max = fmaxf(row_max, v);
      }
      // the 16 threads of a row group are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      // finite from the first tile on: key 0 is never past the sequence
      const float m_new = fmaxf(m_run[i], row_max);
      const float alpha = expf(m_run[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        // P V runs on p rounded to the input type, as the TPU kernel's does
        p_s[(4 * ty + i) * kLdP + tx + 16 * j] = to_float(from_float<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_run[i] = l_run[i] * alpha + row_sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * ty + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_s[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + 4 * ty + i;
    if (qrow >= n) continue;
    T* dst = out + (static_cast<int64_t>(b) * n + qrow) * num_heads * D +
             static_cast<int64_t>(h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dst[tx + 16 * c] = from_float<T>(acc[i][c] / l_run[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* mask, void* out, int batch, int n,
                   int num_heads, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(fused_mha_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, num_heads, batch);
  fused_mha_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), n, num_heads, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask: (batch, n) bytes, 1 = attend, or
// null. Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
int mmlearn_fused_mha_fwd(const void* qkv, const void* mask, void* out, int batch,
                          int n, int num_heads, int head_dim, int dtype, float scale,
                          int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch<float, 32>(qkv, mask, out, batch, n, num_heads, scale, causal, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(qkv, mask, out, batch, n, num_heads, scale, causal, s);
  if (dtype == 1 && head_dim == 32)
    return launch<__nv_bfloat16, 32>(qkv, mask, out, batch, n, num_heads, scale,
                                     causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(qkv, mask, out, batch, n, num_heads, scale,
                                     causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mmlearn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
