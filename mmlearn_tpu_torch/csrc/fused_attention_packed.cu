// Head-grouped fused attention for small head dims, forward and backward
// (Hopper, sm_90a).
//
// Replaces the TPU kernels mmlearn_tpu/ops/fused_attention.py
// `_fwd_kernel_packed` (:425) and `_bwd_kernel_packed` (:448), launched by
// `_fwd_pallas` :655 and `_bwd_pallas` :683 when `_packed_enabled` (:298).
// Same function as K1 (csrc/fused_attention.cu): exact softmax attention over
// N <= 2048 tokens on the head-major packed projection, f32 scores and
// statistics, masked and causal-excluded scores at the finite NEG = -0.7 *
// FLT_MAX, and K1's backward, so the plain versions of K1 hold both.
//
// What the TPU kernel does, and what this one does instead. The TPU body
// handles all P = 128 / D heads of a sample in one program and lays K and V
// out block-diagonally, (P * N, 128), so one 128-deep, 128-wide matmul gives
// every head's scores; the cross-head blocks are structural zeros, and dK/dV
// pay P times the MACs. That fills the TPU's 128 x 128 matrix unit and has no
// use here: the block-diagonal layout is not carried over, and no zero is
// multiplied.
//
// What the design is about on Hopper is the small head dim. Head-major, one
// head's q, k or v row is D values (64 bytes at D = 32 in bf16) at a stride
// of 3 H D, so K1's per-head blocks read half cache lines, one head at a
// time. One head group's P * 3 * D slab, [h0_q | h0_k | h0_v | h1_q | ...],
// is contiguous: 384 values a token at D = 32 and at D = 64 (768 bytes in
// bf16). So one block takes one (sample, head group, tile of rows) and
// - loads each token's slab (q, k|v or dout of all P heads) with 16-byte
//   vector loads into shared memory, once for all P heads, and the tile's
//   key-mask flags once for the group;
// - computes each head's f32 scores, softmax and products in turn from
//   shared memory, with K1's arithmetic (scalar f32 FMAs, 256 threads, each
//   4 or 2 rows by 2 columns of a score tile, the head's running state in
//   registers);
// - writes its outputs through shared memory as 16-byte vector stores: the
//   group's (N, P * D) output slab, its dq segments, its dk|dv segments.
//
// Bound: the bytes are K1's at the same shape (qkv and out read or written
// once; the backward also dout and dqkv), and the work is K1's: 4 N^2 D
// operations a head forward, 10 backward (two recomputed products). The
// scalar loops over shared memory bound it, as they bound K1, far from the
// memory roof; tensor cores (`mma.sync`/`wgmma`) and TMA are later work.
//
// Backward, as K1's: no log-sum-exp from the forward. A dQ kernel recomputes
// each row's max and sum with the forward's online loop, writes them with
// delta = sum(dout * out) to an f32 (3, B, H, N) scratch, then a dK/dV kernel
// reads them. Nothing is accumulated across blocks, so dqkv is deterministic.
// p is rounded to the input type before dV = p^T dout, ds = p (dp - delta)
// scale before dQ = ds K and dK = ds^T Q, and ds is zero at masked scores
// (exact autodiff of the masked softmax; the TPU kernel differs only on rows
// whose every key is masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr float kNeg = -0.7f * FLT_MAX;

// tile shapes: forward and dQ take 64 query rows against 32-key tiles; dK/dV
// takes 64 keys against 32-row query tiles
constexpr int kFwdRows = 64, kFwdKeys = 32;
constexpr int kKvKeys = 64, kKvRows = 32;

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

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// values of T in one 16-byte vector
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
};

// one 16-byte load, widened to f32 (bf16 to f32 is exact: the high half)
__device__ __forceinline__ void widen(const float* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dst[2 * k] = __uint_as_float(w[k] << 16);  // the lower address is the low half
    dst[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Rows row0 .. row0 + ROWS - 1 of the P heads of one group: for head h, the
// NSEG * D contiguous values at column h * head_stride of each row of `src`
// (row stride `row_stride`), in 16-byte vectors. Segment s of head h, row r
// lands at dst_s[(h * ROWS + r) * (D + 1) + c], f32 (the row padded by one
// float: no bank conflicts when 16 threads read 16 rows at one column). Rows
// past n read as 0.
template <typename T, int D, int P, int ROWS, int NSEG>
__device__ __forceinline__ void load_heads(float* dst0, float* dst1, const T* src,
                                           int64_t row_stride, int head_stride, int row0,
                                           int n, int tid) {
  constexpr int kVec = Vec<T>::kN;
  static_assert(D % kVec == 0, "a vector must stay inside one head's segment");
  constexpr int kPerHead = NSEG * D / kVec;
  constexpr int kPerRow = P * kPerHead;
  for (int i = tid; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, rem = i % kPerRow;
    const int h = rem / kPerHead, e = (rem % kPerHead) * kVec;
    const int row = row0 + r;
    float vals[kVec];
    if (row < n) {
      widen(src + row * row_stride + h * head_stride + e, vals);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) vals[k] = 0.f;
    }
    const int s = e / D, c = e % D;
    float* dst = (s == 0 ? dst0 : dst1) + (h * ROWS + r) * (D + 1) + c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) dst[k] = vals[k];
  }
}

// The reverse: stage is [ROWS][P][NSEG * D] of T in shared memory; head h's
// NSEG * D values of row r go to column h * head_stride of row row0 + r of
// `dst`, in 16-byte vectors; rows past n are not written.
template <typename T, int D, int P, int ROWS, int NSEG>
__device__ __forceinline__ void store_heads(T* dst, int64_t row_stride, int head_stride,
                                            const T* stage, int row0, int n, int tid) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kPerHead = NSEG * D / kVec;
  constexpr int kPerRow = P * kPerHead;
  for (int i = tid; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, rem = i % kPerRow;
    const int h = rem / kPerHead, e = (rem % kPerHead) * kVec;
    const int row = row0 + r;
    if (row < n) {
      *reinterpret_cast<uint4*>(dst + row * row_stride + h * head_stride + e) =
          *reinterpret_cast<const uint4*>(stage + (r * P + h) * NSEG * D + e);
    }
  }
}

// acc[i][j] = sum_d a[R ty + i][d] * b[tx + 16 j][d] over two padded tiles,
// in the order of d
template <int D, int R, int C>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float acc[R][C]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(R * ty + i) * kLd + d];
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the 16 threads of a row group are one half of a warp
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// per key of a tile: -1 past the sequence, 0 masked by the key mask, 1 visible
__device__ __forceinline__ void load_key_flags(int* key_s, const uint8_t* key_valid, int k0,
                                               int keys, int n, int tid) {
  if (tid < keys) {
    const int kcol = k0 + tid;
    key_s[tid] = kcol >= n ? -1 : (key_valid && !key_valid[kcol]) ? 0 : 1;
  }
}

template <int D>
__host__ __device__ constexpr int group_heads() {
  return 128 / D;
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  constexpr int P = group_heads<D>(), kLd = D + 1;
  // q of every head, k and v of every head, one head's p tile, key flags
  return sizeof(float) * (P * kFwdRows * kLd + 2 * P * kFwdKeys * kLd +
                          kFwdRows * (kFwdKeys + 1) + kFwdKeys);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    packed_fwd_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                      T* __restrict__ out, int n, int num_heads, float scale, int causal) {
  constexpr int P = group_heads<D>();
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  constexpr int R = kFwdRows / 16, C = kFwdKeys / 16;
  constexpr int kLdP = kFwdKeys + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + P * kFwdRows * kLd;
  float* v_s = k_s + P * kFwdKeys * kLd;
  float* p_s = v_s + P * kFwdKeys * kLd;
  int* key_s = reinterpret_cast<int*>(p_s + kFwdRows * kLdP);

  const int q0 = blockIdx.x * kFwdRows;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16 j; output columns tx + 16 c
  const int ty = tid >> 4;  // rows R ty .. R ty + R - 1

  const int64_t row_stride = static_cast<int64_t>(num_heads) * 3 * D;
  const T* group = qkv + static_cast<int64_t>(b) * n * row_stride +
                   static_cast<int64_t>(grp) * P * 3 * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;

  load_heads<T, D, P, kFwdRows, 1>(q_s, nullptr, group, row_stride, 3 * D, q0, n, tid);

  float m_run[P][R], l_run[P][R], acc[P][R][kCols];
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m_run[h][i] = -INFINITY;
      l_run[h][i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[h][i][c] = 0.f;
    }

  // causal with no key mask: key tiles wholly above the diagonal add
  // exp(NEG - m) = 0 (each row still sees key 0), so they are skipped
  const int kv_end = (causal && !key_valid) ? min(n, q0 + kFwdRows) : n;
  for (int k0 = 0; k0 < kv_end; k0 += kFwdKeys) {
    __syncthreads();  // the previous tile's k_s / v_s / key_s are consumed
    load_heads<T, D, P, kFwdKeys, 2>(k_s, v_s, group + D, row_stride, 3 * D, k0, n, tid);
    load_key_flags(key_s, key_valid, k0, kFwdKeys, n, tid);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < P; ++h) {
      float s[R][C];
      tile_dot<D, R, C>(q_s + h * kFwdRows * kLd, k_s + h * kFwdKeys * kLd, ty, tx, s);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qrow = q0 + R * ty + i;
        float row_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int kj = tx + 16 * j;
          const int flag = key_s[kj];
          float v;
          if (flag < 0) {
            v = -INFINITY;  // past the sequence: contributes exactly nothing
          } else {
            v = (flag == 0 || (causal && k0 + kj > qrow)) ? kNeg : s[i][j] * scale;
          }
          s[i][j] = v;
          row_max = fmaxf(row_max, v);
        }
        // finite from the first tile on: key 0 is never past the sequence
        const float m_new = fmaxf(m_run[h][i], half_warp_max(row_max));
        const float alpha = expf(m_run[h][i] - m_new);
        float row_sum = 0.f;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float p = expf(s[i][j] - m_new);
          row_sum += p;
          // P V runs on p rounded to the input type, as K1's does
          p_s[(R * ty + i) * kLdP + tx + 16 * j] = round_to<T>(p);
        }
        l_run[h][i] = l_run[h][i] * alpha + half_warp_sum(row_sum);
        m_run[h][i] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[h][i][c] *= alpha;
      }
      __syncthreads();
      const float* vh = v_s + h * kFwdKeys * kLd;
#pragma unroll 4
      for (int kk = 0; kk < kFwdKeys; ++kk) {
        float pv[R], vv[kCols];
#pragma unroll
        for (int i = 0; i < R; ++i) pv[i] = p_s[(R * ty + i) * kLdP + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vh[kk * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[h][i][c] = fmaf(pv[i], vv[c], acc[h][i][c]);
      }
      __syncthreads();  // p_s is free for the next head
    }
  }

  // the group's (rows, P * D) output slab, staged in shared memory (q_s is
  // no longer read: the last barrier of the loop passed), then 16-byte stores
  T* o_s = reinterpret_cast<T*>(smem);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        o_s[((R * ty + i) * P + h) * D + tx + 16 * c] =
            from_float<T>(acc[h][i][c] / l_run[h][i]);
  __syncthreads();
  const int64_t o_stride = static_cast<int64_t>(num_heads) * D;
  store_heads<T, D, P, kFwdRows, 1>(
      out + static_cast<int64_t>(b) * n * o_stride + static_cast<int64_t>(grp) * P * D,
      o_stride, D, o_s, q0, n, tid);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int P = group_heads<D>(), kLd = D + 1;
  // q and dout of every head, k and v of every head, one head's ds tile, key
  // flags (q_s is followed by do_s, then k_s and v_s: the forward output
  // is staged across k_s and v_s, P * 64 rows)
  return sizeof(float) * (2 * P * kFwdRows * kLd + 2 * P * kFwdKeys * kLd +
                          kFwdRows * (kFwdKeys + 1) + kFwdKeys);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    packed_bwd_dq_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const T* __restrict__ out, const T* __restrict__ dout,
                         T* __restrict__ dqkv, float* __restrict__ stats, int n,
                         int num_heads, float scale, int causal) {
  constexpr int P = group_heads<D>();
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  constexpr int R = kFwdRows / 16, C = kFwdKeys / 16;
  constexpr int kLdP = kFwdKeys + 1;
  static_assert(2 * kFwdKeys == kFwdRows, "k_s and v_s together hold one row tile");
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + P * kFwdRows * kLd;
  float* k_s = do_s + P * kFwdRows * kLd;
  float* v_s = k_s + P * kFwdKeys * kLd;
  float* ds_s = v_s + P * kFwdKeys * kLd;
  int* key_s = reinterpret_cast<int*>(ds_s + kFwdRows * kLdP);

  const int q0 = blockIdx.x * kFwdRows;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int64_t row_stride = static_cast<int64_t>(num_heads) * 3 * D;
  const int64_t o_stride = static_cast<int64_t>(num_heads) * D;
  const int64_t qkv_off = static_cast<int64_t>(b) * n * row_stride +
                          static_cast<int64_t>(grp) * P * 3 * D;
  const int64_t o_off = static_cast<int64_t>(b) * n * o_stride +
                        static_cast<int64_t>(grp) * P * D;
  const T* group = qkv + qkv_off;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;

  load_heads<T, D, P, kFwdRows, 1>(q_s, nullptr, group, row_stride, 3 * D, q0, n, tid);
  load_heads<T, D, P, kFwdRows, 1>(do_s, nullptr, dout + o_off, o_stride, D, q0, n, tid);
  float* o_s = k_s;  // the forward's output of the rows, across k_s and v_s
  load_heads<T, D, P, kFwdRows, 1>(o_s, nullptr, out + o_off, o_stride, D, q0, n, tid);
  __syncthreads();

  // delta = sum(dout * out) over each head's dims, f32
  float delta[P][R];
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = (h * kFwdRows + R * ty + i) * kLd;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) part += do_s[r + tx + 16 * c] * o_s[r + tx + 16 * c];
      delta[h][i] = half_warp_sum(part);
    }

  // sweep 1: the rows' softmax statistics, by the forward's online loop
  float m_run[P][R], l_run[P][R];
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m_run[h][i] = -INFINITY;
      l_run[h][i] = 0.f;
    }
  const int kv_end = (causal && !key_valid) ? min(n, q0 + kFwdRows) : n;
  float s[R][C];
  for (int k0 = 0; k0 < kv_end; k0 += kFwdKeys) {
    __syncthreads();  // o_s (first pass) or the previous tile is consumed
    load_heads<T, D, P, kFwdKeys, 1>(k_s, nullptr, group + D, row_stride, 3 * D, k0, n, tid);
    load_key_flags(key_s, key_valid, k0, kFwdKeys, n, tid);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < P; ++h) {
      tile_dot<D, R, C>(q_s + h * kFwdRows * kLd, k_s + h * kFwdKeys * kLd, ty, tx, s);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qrow = q0 + R * ty + i;
        float row_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int kj = tx + 16 * j;
          const int flag = key_s[kj];
          float v = -INFINITY;
          if (flag >= 0)
            v = (flag == 0 || (causal && k0 + kj > qrow)) ? kNeg : s[i][j] * scale;
          s[i][j] = v;
          row_max = fmaxf(row_max, v);
        }
        const float m_new = fmaxf(m_run[h][i], half_warp_max(row_max));
        float row_sum = 0.f;
#pragma unroll
        for (int j = 0; j < C; ++j) row_sum += expf(s[i][j] - m_new);
        l_run[h][i] = l_run[h][i] * expf(m_run[h][i] - m_new) + half_warp_sum(row_sum);
        m_run[h][i] = m_new;
      }
    }
  }

  // the dK/dV kernel reads the statistics of every query row
  const int64_t plane = static_cast<int64_t>(gridDim.z) * num_heads * n;
  if (tx == 0) {
#pragma unroll
    for (int h = 0; h < P; ++h) {
      const int64_t row_base =
          (static_cast<int64_t>(b) * num_heads + static_cast<int64_t>(grp) * P + h) * n;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qrow = q0 + R * ty + i;
        if (qrow < n) {
          stats[row_base + qrow] = m_run[h][i];
          stats[plane + row_base + qrow] = l_run[h][i];
          stats[2 * plane + row_base + qrow] = delta[h][i];
        }
      }
    }
  }

  // sweep 2: ds, then dQ += ds K
  float dq[P][R][kCols];
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) dq[h][i][c] = 0.f;
  float dp[R][C];
  for (int k0 = 0; k0 < kv_end; k0 += kFwdKeys) {
    __syncthreads();  // the previous tile's k_s / v_s / key_s are consumed
    load_heads<T, D, P, kFwdKeys, 2>(k_s, v_s, group + D, row_stride, 3 * D, k0, n, tid);
    load_key_flags(key_s, key_valid, k0, kFwdKeys, n, tid);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < P; ++h) {
      const float* kh = k_s + h * kFwdKeys * kLd;
      tile_dot<D, R, C>(q_s + h * kFwdRows * kLd, kh, ty, tx, s);
      tile_dot<D, R, C>(do_s + h * kFwdRows * kLd, v_s + h * kFwdKeys * kLd, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qrow = q0 + R * ty + i;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int kj = tx + 16 * j;
          const int flag = key_s[kj];
          float ds = 0.f;
          if (flag > 0 && !(causal && k0 + kj > qrow)) {
            const float p = expf(s[i][j] * scale - m_run[h][i]) / l_run[h][i];
            ds = p * (dp[i][j] - delta[h][i]) * scale;
          }
          ds_s[(R * ty + i) * kLdP + kj] = round_to<T>(ds);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kFwdKeys; ++kk) {
        float dsv[R], kv[kCols];
#pragma unroll
        for (int i = 0; i < R; ++i) dsv[i] = ds_s[(R * ty + i) * kLdP + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) kv[c] = kh[kk * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) dq[h][i][c] = fmaf(dsv[i], kv[c], dq[h][i][c]);
      }
      __syncthreads();  // ds_s is free for the next head
    }
  }

  // the heads' dq segments, staged over q_s (no longer read), 16-byte stores
  T* stage = reinterpret_cast<T*>(smem);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        stage[((R * ty + i) * P + h) * D + tx + 16 * c] = from_float<T>(dq[h][i][c]);
  __syncthreads();
  store_heads<T, D, P, kFwdRows, 1>(dqkv + qkv_off, row_stride, 3 * D, stage, q0, n, tid);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int P = group_heads<D>(), kLd = D + 1;
  // k and v of every head, q and dout of every head, one head's p^T and
  // ds^T tiles, the query rows' m, l and delta of every head, key flags
  return sizeof(float) * (2 * P * kKvKeys * kLd + 2 * P * kKvRows * kLd +
                          2 * kKvKeys * (kKvRows + 1) + 3 * P * kKvRows + kKvKeys);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    packed_bwd_dkv_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                          const T* __restrict__ dout, T* __restrict__ dqkv,
                          const float* __restrict__ stats, int n, int num_heads, float scale,
                          int causal) {
  constexpr int P = group_heads<D>();
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  constexpr int R = kKvKeys / 16, C = kKvRows / 16;
  constexpr int kLdP = kKvRows + 1;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + P * kKvKeys * kLd;
  float* q_s = v_s + P * kKvKeys * kLd;
  float* do_s = q_s + P * kKvRows * kLd;
  float* pt_s = do_s + P * kKvRows * kLd;
  float* dst_s = pt_s + kKvKeys * kLdP;
  float* m_s = dst_s + kKvKeys * kLdP;  // [P][kKvRows] each
  float* l_s = m_s + P * kKvRows;
  float* d_s = l_s + P * kKvRows;
  int* key_s = reinterpret_cast<int*>(d_s + P * kKvRows);

  const int k0 = blockIdx.x * kKvKeys;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // query columns tx + 16 j; output columns tx + 16 c
  const int ty = tid >> 4;  // key rows R ty .. R ty + R - 1

  const int64_t row_stride = static_cast<int64_t>(num_heads) * 3 * D;
  const int64_t o_stride = static_cast<int64_t>(num_heads) * D;
  const int64_t qkv_off = static_cast<int64_t>(b) * n * row_stride +
                          static_cast<int64_t>(grp) * P * 3 * D;
  const T* group = qkv + qkv_off;
  const T* do_group =
      dout + static_cast<int64_t>(b) * n * o_stride + static_cast<int64_t>(grp) * P * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * num_heads * n;
  const int64_t row_base =
      (static_cast<int64_t>(b) * num_heads + static_cast<int64_t>(grp) * P) * n;

  load_heads<T, D, P, kKvKeys, 2>(k_s, v_s, group + D, row_stride, 3 * D, k0, n, tid);
  load_key_flags(key_s, key_valid, k0, kKvKeys, n, tid);

  float dk[P][R][kCols], dv[P][R][kCols];
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) dk[h][i][c] = dv[h][i][c] = 0.f;

  // causal with no key mask: a query tile wholly before this key tile sees
  // none of its keys (with a key mask, a row whose keys are all masked
  // spreads p = 1/N over every key, so no tile is skipped)
  const int q_begin = (causal && !key_valid) ? k0 : 0;
  float st[R][C], dpt[R][C];
  for (int q0 = q_begin; q0 < n; q0 += kKvRows) {
    __syncthreads();  // the previous tile's q_s / do_s / stats are consumed
    load_heads<T, D, P, kKvRows, 1>(q_s, nullptr, group, row_stride, 3 * D, q0, n, tid);
    load_heads<T, D, P, kKvRows, 1>(do_s, nullptr, do_group, o_stride, D, q0, n, tid);
    if (tid < P * kKvRows) {
      const int h = tid / kKvRows, r = tid % kKvRows;
      const int qrow = q0 + r;
      const bool live = qrow < n;
      const int64_t at = row_base + static_cast<int64_t>(h) * n + qrow;
      m_s[tid] = live ? stats[at] : 0.f;
      l_s[tid] = live ? stats[plane + at] : 1.f;
      d_s[tid] = live ? stats[2 * plane + at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < P; ++h) {
      const float* qh = q_s + h * kKvRows * kLd;
      const float* doh = do_s + h * kKvRows * kLd;
      tile_dot<D, R, C>(k_s + h * kKvKeys * kLd, qh, ty, tx, st);
      tile_dot<D, R, C>(v_s + h * kKvKeys * kLd, doh, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int ki = R * ty + i;
        const int kcol = k0 + ki;
        const int flag = key_s[ki];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int qj = tx + 16 * j;
          const int qrow = q0 + qj;
          float p = 0.f, ds = 0.f;
          if (flag >= 0 && qrow < n) {
            const bool masked = flag == 0 || (causal && kcol > qrow);
            const float v = masked ? kNeg : st[i][j] * scale;
            p = expf(v - m_s[h * kKvRows + qj]) / l_s[h * kKvRows + qj];
            if (!masked) ds = p * (dpt[i][j] - d_s[h * kKvRows + qj]) * scale;
          }
          pt_s[ki * kLdP + qj] = round_to<T>(p);
          dst_s[ki * kLdP + qj] = round_to<T>(ds);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kKvRows; ++qq) {
        float pv[R], dsv[R], dov[kCols], qv[kCols];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = pt_s[(R * ty + i) * kLdP + qq];
          dsv[i] = dst_s[(R * ty + i) * kLdP + qq];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dov[c] = doh[qq * kLd + tx + 16 * c];
          qv[c] = qh[qq * kLd + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv[h][i][c] = fmaf(pv[i], dov[c], dv[h][i][c]);
            dk[h][i][c] = fmaf(dsv[i], qv[c], dk[h][i][c]);
          }
      }
      __syncthreads();  // pt_s / dst_s are free for the next head
    }
  }

  // the heads' dk|dv segments, staged over k_s and v_s (no longer read),
  // 16-byte stores
  T* stage = reinterpret_cast<T*>(smem);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        T* row = stage + ((R * ty + i) * P + h) * 2 * D;
        row[tx + 16 * c] = from_float<T>(dk[h][i][c]);
        row[D + tx + 16 * c] = from_float<T>(dv[h][i][c]);
      }
  __syncthreads();
  store_heads<T, D, P, kKvKeys, 2>(dqkv + qkv_off + D, row_stride, 3 * D, stage, k0, n, tid);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const void* qkv, const void* mask, void* out, int batch, int n,
                       int num_heads, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(packed_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kFwdRows - 1) / kFwdRows, num_heads / group_heads<D>(), batch);
  packed_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(mask), static_cast<T*>(out), n,
      num_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* qkv, const void* mask, const void* out, const void* dout,
                       void* dqkv, void* stats, int batch, int n, int num_heads, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<D>();
  constexpr size_t smem_dkv = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(packed_bwd_dq_kernel<T, D>, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(packed_bwd_dkv_kernel<T, D>, smem_dkv);
  if (err != cudaSuccess) return err;
  const int groups = num_heads / group_heads<D>();
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  packed_bwd_dq_kernel<T, D><<<dim3((n + kFwdRows - 1) / kFwdRows, groups, batch), kThreads,
                               smem_dq, stream>>>(
      static_cast<const T*>(qkv), m, static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), static_cast<float*>(stats), n, num_heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_bwd_dkv_kernel<T, D><<<dim3((n + kKvKeys - 1) / kKvKeys, groups, batch), kThreads,
                                smem_dkv, stream>>>(
      static_cast<const T*>(qkv), m, static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<const float*>(stats), n, num_heads, scale, causal);
  return cudaGetLastError();
}

bool supported(int n, int num_heads, int head_dim, int dtype) {
  return (dtype == 0 || dtype == 1) && (head_dim == 32 || head_dim == 64) && n >= 1 &&
         n <= 2048 && num_heads % (128 / head_dim) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 32 or 64, num_heads a multiple
// of 128 / head_dim; every pointer 16-byte aligned but the mask, which is
// (batch, n) bytes, 1 = attend, or null. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
int mmlearn_fused_mha_packed_fwd(const void* qkv, const void* mask, void* out, int batch,
                                 int n, int num_heads, int head_dim, int dtype, float scale,
                                 int causal, void* stream) {
  if (!supported(n, num_heads, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch_fwd<float, 32>(qkv, mask, out, batch, n, num_heads, scale, causal, s);
  if (dtype == 0)
    return launch_fwd<float, 64>(qkv, mask, out, batch, n, num_heads, scale, causal, s);
  if (head_dim == 32)
    return launch_fwd<__nv_bfloat16, 32>(qkv, mask, out, batch, n, num_heads, scale, causal,
                                         s);
  return launch_fwd<__nv_bfloat16, 64>(qkv, mask, out, batch, n, num_heads, scale, causal, s);
}

// The backward: dqkv (same shape, type and packing as qkv) from qkv, the
// forward's output `out` and its cotangent `dout` (batch, n, heads *
// head_dim), and the mask. `stats` is f32 scratch of 3 * batch * heads * n
// values. Two launches on `stream`, no synchronisation; returns the first
// failing launch's cudaError_t (0 on success).
int mmlearn_fused_mha_packed_bwd(const void* qkv, const void* mask, const void* out,
                                 const void* dout, void* dqkv, void* stats, int batch, int n,
                                 int num_heads, int head_dim, int dtype, float scale,
                                 int causal, void* stream) {
  if (!supported(n, num_heads, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch_bwd<float, 32>(qkv, mask, out, dout, dqkv, stats, batch, n, num_heads,
                                 scale, causal, s);
  if (dtype == 0)
    return launch_bwd<float, 64>(qkv, mask, out, dout, dqkv, stats, batch, n, num_heads,
                                 scale, causal, s);
  if (head_dim == 32)
    return launch_bwd<__nv_bfloat16, 32>(qkv, mask, out, dout, dqkv, stats, batch, n,
                                         num_heads, scale, causal, s);
  return launch_bwd<__nv_bfloat16, 64>(qkv, mask, out, dout, dqkv, stats, batch, n,
                                       num_heads, scale, causal, s);
}

const char* mmlearn_packed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
