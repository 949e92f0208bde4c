// Blocked online-softmax attention for long sequences, forward and backward
// (kernel K3), Hopper sm_90a.
//
// Replaces the TPU kernels of mmlearn_tpu/ops/flash_attention.py:
//   K3f  `_flash_kernel` (:76, launched by `_flash_forward_pallas` :161);
//   K3b  `_bwd_dkv_kernel` (:267) and `_bwd_dq_kernel` (:344), launched by
//        `_flash_backward_pallas` (:412).
// Same functions, on q (B, H, N_q, D), k and v (B, H, N_k, D), each read
// through its own batch, head and row strides (unit stride along D), and an
// optional (B, N_k) key-validity mask of bytes:
//   s    = (q . k) * scale in f32; NEG = -0.7 * FLT_MAX where the key is
//          masked or (causal) past the diagonal key <= row + N_k - N_q;
//          keys at and past N_k are left out (-inf), not padded;
//   K3f  out = softmax(s) v with an online max, normaliser and f32
//        accumulator across key tiles; lse = m + log(l) (f32, (B, H, N_q));
//   K3b  p = exp(s - lse), dv = p^T do (p rounded to the input type),
//        dp = do v^T, ds = p (dp - delta) scale (rounded to the input type),
//        dk = ds^T q, dq = ds k; delta = rowsum(do * out) in f32, which the
//        JAX package leaves to XLA, is summed by the dQ kernel from its own
//        rows of do and out and written for the dK/dV kernel after it.
// Where the port follows the JAX package's reference path (_attention_xla
// and its autodiff) and not the TPU kernel: a row whose every key is masked
// averages V over the N_k keys only (the TPU kernel pads keys to its tile);
// in the backward such a row (lse == NEG) has p = 1 / N_k at every key, and
// ds is zero at every masked score, so its dq and its share of dk are zero.
//
// Design. Tiles of 64 query rows by 64 keys, 4 warps of 16 rows (or 16 keys)
// each; nothing crosses a block, so every kernel needs one pass and no
// atomics:
//   K3f     one block per (q tile, head, sample); K and V tiles stream
//           through two shared-memory buffers (cp.async, the next tile in
//           flight while this one is used); the running max, normaliser and
//           accumulator stay in registers; under a causal mask without a key
//           mask, key tiles wholly above the diagonal are skipped;
//   K3b-dq  one block per (q tile, head, sample), launched first: it sums
//           delta for its rows (writing it out), then k and v stream over
//           the key tiles; dQ stays in registers;
//   K3b-dkv one block per (key tile, head, sample); q, do, lse, delta stream
//           over the query tiles; dK and dV stay in registers.
// bf16 uses the tensor cores: mma.sync m16n8k16 (bf16 in, f32 sums), B
// operands from shared memory by ldmatrix (transposed where the product
// contracts over rows), and the score accumulators reused in registers as
// the A operand of the next product (P V, P^T dO, dS K, dS^T Q); those
// helpers are in attention_tiles.cuh, shared with K1. f32 keeps full f32
// arithmetic: a scalar kernel, one thread a row (or key).
//
// What bounds it on the H100. At B = 64, H = 12, N = 785, D = 64 the forward
// is 4 B H N^2 D = 1.2e11 operations (0.12 ms at 989 TFLOP/s) against q, k,
// v and out, 4 B H N D * 2 bytes = 309 MB (0.092 ms at 3.35 TB/s): bound by
// operations, by a margin that grows with N, and the scores never leave the
// chip. This first version is mma.sync with a
// two-stage cp.async pipeline and one 64 x 64 tile a block; wgmma, TMA and
// warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kTile = 64;              // query rows and keys a tile
constexpr int kWarps = 4;              // 16 rows (or keys) each
constexpr int kThreads = 32 * kWarps;
constexpr int kScalarRows = 64;        // f32 kernels: one thread a row (or key)
constexpr int kScalarTile = 32;        // f32 kernels: keys (or queries) a tile

struct Layout {  // element strides of one (B, H, N, D) operand
  long long b, h, n;
};

struct Problem {
  int heads, n_q, n_k;
  int causal;
  int off;     // n_k - n_q: key j is causal-visible from row i when j <= i + off
  int skip;    // causal without a key mask and off >= 0: every row sees key 0,
               // and tiles wholly past the diagonal contribute nothing
  float scale;
  float log_nk;
};

__device__ __forceinline__ bool causal_hidden(const Problem& pr, int row, int col) {
  return pr.causal && col > row + pr.off;
}

// Start copying rows r0..r0+63 of a (rows, D) bf16 operand into a padded
// shared tile (zeros past `rows`).
template <int D>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, long long ld, int r0,
                                           int rows, int tid) {
  constexpr int kLd = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * kLd + c, ok ? src + (r0 + r) * ld + c : src, ok ? 16 : 0);
  }
}

// 1 where key k0 + j may be seen (the mask's byte), for j < 64; 1 without a
// mask. Keys past n_k are told apart by their index.
__device__ __forceinline__ void valid_tile(uint8_t* dst, const uint8_t* valid, int k0, int n_k,
                                           int tid) {
  if (tid < kTile) dst[tid] = (!valid || (k0 + tid < n_k && valid[k0 + tid])) ? 1 : 0;
}

// ------------------------------------------------------- bf16: K3f forward

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ out, float* __restrict__ lse, Layout lq, Layout lk,
                     Layout lv, Layout lo, Problem pr) {
  constexpr int kLd = D + 8;  // 16-byte rows, conflict-free ldmatrix
  constexpr int kNt = kTile / 8;
  __shared__ __align__(16) bf16 k_s[2][kTile * kLd];
  __shared__ __align__(16) bf16 v_s[2][kTile * kLd];
  __shared__ uint8_t valid_s[2][kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qh = q + b * lq.b + h * lq.h;
  const bf16* kh = k + b * lk.b + h * lk.h;
  const bf16* vh = v + b * lv.b + h * lv.h;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;

  uint32_t qa[D / 16][4];
  load_a<D>(qa, qh, lq.n, q0 + warp * 16, pr.n_q, lane);

  const int kv_end = pr.skip ? min(pr.n_k, q0 + kTile + pr.off) : pr.n_k;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  auto load = [&](int it, int buf) {
    tile_async<D>(k_s[buf], kh, lk.n, it * kTile, pr.n_k, tid);
    tile_async<D>(v_s[buf], vh, lv.n, it * kTile, pr.n_k, tid);
    valid_tile(valid_s[buf], valid, it * kTile, pr.n_k, tid);
    cp_async_commit();
  };

  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  load(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * kTile;

    float s[kNt][4];
#pragma unroll
    for (int i = 0; i < kNt; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t bb[4];
        load_b_rows(bb, k_s[buf], kLd, np * 16, kc * 16, lane);
        mma_bf16(s[2 * np], qa[kc], bb);
        mma_bf16(s[2 * np + 1], qa[kc], bb + 2);
      }
    }

    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t + (e & 1);
        const int col = k0 + j, row = e < 2 ? row_lo : row_hi;
        float x;
        if (col >= pr.n_k) {
          x = -INFINITY;
        } else if (!valid_s[buf][j] || causal_hidden(pr, row, col)) {
          x = kNeg;
        } else {
          x = s[nt][e] * pr.scale;
        }
        s[nt][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
    }
    // the four lanes of a row hold its 64 columns
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // key k0 is in range, so the new max is finite (at least NEG)
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = __expf(m_lo - mn_lo), a_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    // each lane sums its own columns; the lanes of a row add up at the end
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn_lo);
      s[nt][1] = __expf(s[nt][1] - mn_lo);
      s[nt][2] = __expf(s[nt][2] - mn_hi);
      s[nt][3] = __expf(s[nt][3] - mn_hi);
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= a_lo;
      acc[dn][1] *= a_lo;
      acc[dn][2] *= a_hi;
      acc[dn][3] *= a_hi;
    }
    // acc += p v, p rounded to bf16 (the TPU kernel's p.astype(v.dtype))
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4];
      scores_as_a(pa, s, kc);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        load_b_cols(bb, v_s[buf], kLd, kc * 16, dp * 16, lane);
        mma_bf16(acc[2 * dp], pa, bb);
        mma_bf16(acc[2 * dp + 1], pa, bb + 2);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float sl_lo = l_lo == 0.f ? 1.f : l_lo, sl_hi = l_hi == 0.f ? 1.f : l_hi;
  bf16* oh = out + b * lo.b + h * lo.h;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (row_lo < pr.n_q)
      *reinterpret_cast<uint32_t*>(oh + row_lo * lo.n + c) =
          pack_bf16(acc[dn][0] / sl_lo, acc[dn][1] / sl_lo);
    if (row_hi < pr.n_q)
      *reinterpret_cast<uint32_t*>(oh + row_hi * lo.n + c) =
          pack_bf16(acc[dn][2] / sl_hi, acc[dn][3] / sl_hi);
  }
  if (t == 0) {
    float* lh = lse + (static_cast<long long>(b) * pr.heads + h) * pr.n_q;
    if (row_lo < pr.n_q) lh[row_lo] = m_lo + logf(sl_lo);
    if (row_hi < pr.n_q) lh[row_hi] = m_hi + logf(sl_hi);
  }
}

// --------------------------------------------------- bf16: K3b dK/dV kernel

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Layout lq, Layout lk, Layout lv, Layout ldo,
                         Layout ldk, Layout ldv, Problem pr) {
  constexpr int kLd = D + 8;
  constexpr int kNt = kTile / 8;
  __shared__ __align__(16) bf16 q_s[2][kTile * kLd];
  __shared__ __align__(16) bf16 do_s[2][kTile * kLd];
  __shared__ float lse_s[2][kTile], delta_s[2][kTile], pm_s[2][kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qh = q + b * lq.b + h * lq.h;
  const bf16* doh = dout + b * ldo.b + h * ldo.h;
  const long long bh = static_cast<long long>(b) * pr.heads + h;
  const float* lse_h = lse + bh * pr.n_q;
  const float* delta_h = delta + bh * pr.n_q;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;
  const bool ok_lo = key_lo < pr.n_k && (!valid || valid[key_lo]);
  const bool ok_hi = key_hi < pr.n_k && (!valid || valid[key_hi]);

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + b * lk.b + h * lk.h, lk.n, k0 + warp * 16, pr.n_k, lane);
  load_a<D>(va, v + b * lv.b + h * lv.h, lv.n, k0 + warp * 16, pr.n_k, lane);

  // under `skip` a query tile reaches this key tile when its last row does
  const int i_start = (pr.skip && k0 > pr.off) ? (k0 - pr.off) / kTile : 0;
  const int i_end = (pr.n_q + kTile - 1) / kTile;
  auto load = [&](int it, int buf) {
    const int r0 = it * kTile;
    tile_async<D>(q_s[buf], qh, lq.n, r0, pr.n_q, tid);
    tile_async<D>(do_s[buf], doh, ldo.n, r0, pr.n_q, tid);
    if (tid < kTile) {
      // rows past n_q: p = 0 (lse = +inf), ds = 0
      const int r = r0 + tid;
      const float l = r < pr.n_q ? lse_h[r] : INFINITY;
      lse_s[buf][tid] = l;
      delta_s[buf][tid] = r < pr.n_q ? delta_h[r] : 0.f;
      // exp(NEG - lse) / N_k: 1 / N_k on a row whose every key is masked
      pm_s[buf][tid] = __expf((kNeg - l) - pr.log_nk);
    }
    cp_async_commit();
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  if (i_start < i_end) load(i_start, 0);
  for (int it = i_start; it < i_end; ++it) {
    const int buf = (it - i_start) & 1;
    if (it + 1 < i_end) {
      load(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = it * kTile;

    // s^T = k q^T and dp^T = v do^T: rows are this warp's keys
    float st[kNt][4], dpt[kNt][4];
#pragma unroll
    for (int i = 0; i < kNt; ++i) {
      st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t bb[4];
        load_b_rows(bb, q_s[buf], kLd, np * 16, kc * 16, lane);
        mma_bf16(st[2 * np], ka[kc], bb);
        mma_bf16(st[2 * np + 1], ka[kc], bb + 2);
        load_b_rows(bb, do_s[buf], kLd, np * 16, kc * 16, lane);
        mma_bf16(dpt[2 * np], va[kc], bb);
        mma_bf16(dpt[2 * np + 1], va[kc], bb + 2);
      }
    }
    // st becomes p^T, dpt becomes ds^T
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t + (e & 1);  // query in the tile
        const int key = e < 2 ? key_lo : key_hi;
        const bool vis = (e < 2 ? ok_lo : ok_hi) && !causal_hidden(pr, r0 + j, key);
        const float p = vis ? __expf(st[nt][e] * pr.scale - lse_s[buf][j]) : pm_s[buf][j];
        dpt[nt][e] = vis ? p * (dpt[nt][e] - delta_s[buf][j]) * pr.scale : 0.f;
        st[nt][e] = p;
      }
    }
    // dv += p^T do, dk += ds^T q (the TPU kernel's casts to the input type)
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4], sa[4];
      scores_as_a(pa, st, kc);
      scores_as_a(sa, dpt, kc);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        load_b_cols(bb, do_s[buf], kLd, kc * 16, dp * 16, lane);
        mma_bf16(dv_acc[2 * dp], pa, bb);
        mma_bf16(dv_acc[2 * dp + 1], pa, bb + 2);
        load_b_cols(bb, q_s[buf], kLd, kc * 16, dp * 16, lane);
        mma_bf16(dk_acc[2 * dp], sa, bb);
        mma_bf16(dk_acc[2 * dp + 1], sa, bb + 2);
      }
    }
    __syncthreads();
  }

  bf16* dkh = dk + b * ldk.b + h * ldk.h;
  bf16* dvh = dv + b * ldv.b + h * ldv.h;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (key_lo < pr.n_k) {
      *reinterpret_cast<uint32_t*>(dkh + key_lo * ldk.n + c) =
          pack_bf16(dk_acc[dn][0], dk_acc[dn][1]);
      *reinterpret_cast<uint32_t*>(dvh + key_lo * ldv.n + c) =
          pack_bf16(dv_acc[dn][0], dv_acc[dn][1]);
    }
    if (key_hi < pr.n_k) {
      *reinterpret_cast<uint32_t*>(dkh + key_hi * ldk.n + c) =
          pack_bf16(dk_acc[dn][2], dk_acc[dn][3]);
      *reinterpret_cast<uint32_t*>(dvh + key_hi * ldv.n + c) =
          pack_bf16(dv_acc[dn][2], dv_acc[dn][3]);
    }
  }
}

// ------------------------------------------------------ bf16: K3b dQ kernel

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                        const bf16* __restrict__ dout, const bf16* __restrict__ out,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        bf16* __restrict__ dq, Layout lq, Layout lk, Layout lv, Layout ldo,
                        Layout lout, Layout ldq, Problem pr) {
  constexpr int kLd = D + 8;
  constexpr int kNt = kTile / 8;
  __shared__ __align__(16) bf16 k_s[2][kTile * kLd];
  __shared__ __align__(16) bf16 v_s[2][kTile * kLd];
  __shared__ uint8_t valid_s[2][kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* kh = k + b * lk.b + h * lk.h;
  const bf16* vh = v + b * lv.b + h * lv.h;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;
  const long long bh = static_cast<long long>(b) * pr.heads + h;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const float lse_lo = row_lo < pr.n_q ? lse[bh * pr.n_q + row_lo] : INFINITY;
  const float lse_hi = row_hi < pr.n_q ? lse[bh * pr.n_q + row_hi] : INFINITY;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, q + b * lq.b + h * lq.h, lq.n, q0 + warp * 16, pr.n_q, lane);
  load_a<D>(da, dout + b * ldo.b + h * ldo.h, ldo.n, q0 + warp * 16, pr.n_q, lane);

  // delta = rowsum(do * out) in f32: each thread's columns of its two rows
  // (the do fragments in registers, the same columns of out), summed over
  // the 4 threads of a row; written for the dK/dV kernel
  const bf16* oh = out + b * lout.b + h * lout.h;
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = 16 * kc + 2 * t;
    dl_lo += dot_pair(da[kc][0], load_pair(oh, lout.n, row_lo, c, pr.n_q)) +
             dot_pair(da[kc][2], load_pair(oh, lout.n, row_lo, c + 8, pr.n_q));
    dl_hi += dot_pair(da[kc][1], load_pair(oh, lout.n, row_hi, c, pr.n_q)) +
             dot_pair(da[kc][3], load_pair(oh, lout.n, row_hi, c + 8, pr.n_q));
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, m);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, m);
  }
  if (t == 0 && row_lo < pr.n_q) delta[bh * pr.n_q + row_lo] = dl_lo;
  if (t == 0 && row_hi < pr.n_q) delta[bh * pr.n_q + row_hi] = dl_hi;

  const int kv_end = pr.skip ? min(pr.n_k, q0 + kTile + pr.off) : pr.n_k;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  auto load = [&](int it, int buf) {
    tile_async<D>(k_s[buf], kh, lk.n, it * kTile, pr.n_k, tid);
    tile_async<D>(v_s[buf], vh, lv.n, it * kTile, pr.n_k, tid);
    valid_tile(valid_s[buf], valid, it * kTile, pr.n_k, tid);
    cp_async_commit();
  };

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  load(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * kTile;

    float s[kNt][4], dp[kNt][4];
#pragma unroll
    for (int i = 0; i < kNt; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t bb[4];
        load_b_rows(bb, k_s[buf], kLd, np * 16, kc * 16, lane);
        mma_bf16(s[2 * np], qa[kc], bb);
        mma_bf16(s[2 * np + 1], qa[kc], bb + 2);
        load_b_rows(bb, v_s[buf], kLd, np * 16, kc * 16, lane);
        mma_bf16(dp[2 * np], da[kc], bb);
        mma_bf16(dp[2 * np + 1], da[kc], bb + 2);
      }
    }
    // s becomes ds: zero at every masked score and past the keys
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t + (e & 1);
        const int col = k0 + j;
        const bool lo = e < 2;
        const bool vis = col < pr.n_k && valid_s[buf][j] &&
                         !causal_hidden(pr, lo ? row_lo : row_hi, col);
        const float p = __expf(s[nt][e] * pr.scale - (lo ? lse_lo : lse_hi));
        s[nt][e] = vis ? p * (dp[nt][e] - (lo ? dl_lo : dl_hi)) * pr.scale : 0.f;
      }
    }
    // dq += ds k (ds rounded to bf16, the TPU kernel's ds.astype(k.dtype))
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t sa[4];
      scores_as_a(sa, s, kc);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bb[4];
        load_b_cols(bb, k_s[buf], kLd, kc * 16, dn * 16, lane);
        mma_bf16(acc[2 * dn], sa, bb);
        mma_bf16(acc[2 * dn + 1], sa, bb + 2);
      }
    }
    __syncthreads();
  }

  bf16* dqh = dq + b * ldq.b + h * ldq.h;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (row_lo < pr.n_q)
      *reinterpret_cast<uint32_t*>(dqh + row_lo * ldq.n + c) = pack_bf16(acc[dn][0], acc[dn][1]);
    if (row_hi < pr.n_q)
      *reinterpret_cast<uint32_t*>(dqh + row_hi * ldq.n + c) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// ------------------------------------------------------- f32: scalar kernels
//
// Full f32 arithmetic (the tensor cores would round to TF32). One thread a
// query row (a key in dK/dV); key (query) tiles of 32 in shared memory, read
// by every thread at one address (a broadcast).

template <int D>
__global__ void __launch_bounds__(kScalarRows)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ lse, Layout lq, Layout lk,
                         Layout lv, Layout lo, Problem pr) {
  __shared__ float k_s[kScalarTile][D], v_s[kScalarTile][D];
  __shared__ uint8_t valid_s[kScalarTile];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kScalarRows + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kh = k + b * lk.b + h * lk.h;
  const float* vh = v + b * lv.b + h * lv.h;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;

  float qr[D], acc[D];
  const float* qrow = q + b * lq.b + h * lq.h + row * lq.n;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = row < pr.n_q ? qrow[c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int kv_end = pr.skip ? min(pr.n_k, blockIdx.x * kScalarRows + kScalarRows + pr.off)
                             : pr.n_k;
  for (int k0 = 0; k0 < kv_end; k0 += kScalarTile) {
    __syncthreads();
    for (int i = tid; i < kScalarTile * D; i += kScalarRows) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < pr.n_k;
      k_s[r][c] = ok ? kh[(k0 + r) * lk.n + c] : 0.f;
      v_s[r][c] = ok ? vh[(k0 + r) * lv.n + c] : 0.f;
    }
    if (tid < kScalarTile)
      valid_s[tid] = (!valid || (k0 + tid < pr.n_k && valid[k0 + tid])) ? 1 : 0;
    __syncthreads();
    const int j_end = min(kScalarTile, pr.n_k - k0);
    for (int j = 0; j < j_end; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], k_s[j][c], dot);
      const float x = (!valid_s[j] || causal_hidden(pr, row, k0 + j)) ? kNeg : dot * pr.scale;
      if (x > m) {
        const float a = expf(m - x);
        l *= a;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] *= a;
        m = x;
      }
      const float p = expf(x - m);
      l += p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, v_s[j][c], acc[c]);
    }
  }
  if (row >= pr.n_q) return;
  const float sl = l == 0.f ? 1.f : l;
  float* orow = out + b * lo.b + h * lo.h + row * lo.n;
#pragma unroll
  for (int c = 0; c < D; ++c) orow[c] = acc[c] / sl;
  lse[(static_cast<long long>(b) * pr.heads + h) * pr.n_q + row] = m + logf(sl);
}

template <int D>
__global__ void __launch_bounds__(kScalarRows)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const uint8_t* __restrict__ mask,
                            const float* __restrict__ dout, const float* __restrict__ out,
                            const float* __restrict__ lse, float* __restrict__ delta,
                            float* __restrict__ dq, Layout lq, Layout lk, Layout lv,
                            Layout ldo, Layout lout, Layout ldq, Problem pr) {
  __shared__ float k_s[kScalarTile][D], v_s[kScalarTile][D];
  __shared__ float do_s[kScalarRows][D + 1];  // one row a thread, padded
  __shared__ uint8_t valid_s[kScalarTile];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kScalarRows + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kh = k + b * lk.b + h * lk.h;
  const float* vh = v + b * lv.b + h * lv.h;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;
  const long long bh = static_cast<long long>(b) * pr.heads + h;
  const bool live = row < pr.n_q;
  const float l_row = live ? lse[bh * pr.n_q + row] : INFINITY;

  float qr[D], acc[D];
  const float* qrow = q + b * lq.b + h * lq.h + row * lq.n;
  const float* drow = dout + b * ldo.b + h * ldo.h + row * ldo.n;
  const float* orow = out + b * lout.b + h * lout.h + row * lout.n;
  float d_row = 0.f;  // delta = rowsum(do * out), written for the dK/dV kernel
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = live ? qrow[c] : 0.f;
    do_s[tid][c] = live ? drow[c] : 0.f;
    d_row = fmaf(do_s[tid][c], live ? orow[c] : 0.f, d_row);
    acc[c] = 0.f;
  }
  if (live) delta[bh * pr.n_q + row] = d_row;
  const int kv_end = pr.skip ? min(pr.n_k, blockIdx.x * kScalarRows + kScalarRows + pr.off)
                             : pr.n_k;
  for (int k0 = 0; k0 < kv_end; k0 += kScalarTile) {
    __syncthreads();
    for (int i = tid; i < kScalarTile * D; i += kScalarRows) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < pr.n_k;
      k_s[r][c] = ok ? kh[(k0 + r) * lk.n + c] : 0.f;
      v_s[r][c] = ok ? vh[(k0 + r) * lv.n + c] : 0.f;
    }
    if (tid < kScalarTile)
      valid_s[tid] = (!valid || (k0 + tid < pr.n_k && valid[k0 + tid])) ? 1 : 0;
    __syncthreads();
    const int j_end = min(kScalarTile, pr.n_k - k0);
    for (int j = 0; j < j_end; ++j) {
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dot = fmaf(qr[c], k_s[j][c], dot);
        dpv = fmaf(do_s[tid][c], v_s[j][c], dpv);
      }
      const bool vis = valid_s[j] && !causal_hidden(pr, row, k0 + j);
      const float ds = vis ? expf(dot * pr.scale - l_row) * (dpv - d_row) * pr.scale : 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, k_s[j][c], acc[c]);
    }
  }
  if (!live) return;
  float* dqr = dq + b * ldq.b + h * ldq.h + row * ldq.n;
#pragma unroll
  for (int c = 0; c < D; ++c) dqr[c] = acc[c];
}

template <int D>
__global__ void __launch_bounds__(kScalarRows)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ mask,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk,
                             float* __restrict__ dv, Layout lq, Layout lk, Layout lv, Layout ldo,
                             Layout ldk, Layout ldv, Problem pr) {
  __shared__ float q_s[kScalarTile][D], do_s[kScalarTile][D];
  __shared__ float v_s[kScalarRows][D + 1];  // one key's v a thread, padded
  __shared__ float lse_s[kScalarTile], delta_s[kScalarTile], pm_s[kScalarTile];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kScalarRows;
  const int key = k0 + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qh = q + b * lq.b + h * lq.h;
  const float* doh = dout + b * ldo.b + h * ldo.h;
  const long long bh = static_cast<long long>(b) * pr.heads + h;
  const bool live = key < pr.n_k;
  const bool ok = live && (!mask || mask[static_cast<long long>(b) * pr.n_k + key]);

  float kr[D], dk_acc[D], dv_acc[D];
  const float* krow = k + b * lk.b + h * lk.h + key * lk.n;
  const float* vrow = v + b * lv.b + h * lv.h + key * lv.n;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kr[c] = live ? krow[c] : 0.f;
    v_s[tid][c] = live ? vrow[c] : 0.f;
    dk_acc[c] = dv_acc[c] = 0.f;
  }
  const int i_start = (pr.skip && k0 > pr.off) ? (k0 - pr.off) / kScalarTile * kScalarTile : 0;
  for (int i0 = i_start; i0 < pr.n_q; i0 += kScalarTile) {
    __syncthreads();
    for (int i = tid; i < kScalarTile * D; i += kScalarRows) {
      const int r = i / D, c = i % D;
      const bool in = i0 + r < pr.n_q;
      q_s[r][c] = in ? qh[(i0 + r) * lq.n + c] : 0.f;
      do_s[r][c] = in ? doh[(i0 + r) * ldo.n + c] : 0.f;
    }
    if (tid < kScalarTile) {
      const int r = i0 + tid;
      const float l = r < pr.n_q ? lse[bh * pr.n_q + r] : INFINITY;
      lse_s[tid] = l;
      delta_s[tid] = r < pr.n_q ? delta[bh * pr.n_q + r] : 0.f;
      pm_s[tid] = expf((kNeg - l) - pr.log_nk);
    }
    __syncthreads();
    const int i_cnt = min(kScalarTile, pr.n_q - i0);
    for (int i = 0; i < i_cnt; ++i) {
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dot = fmaf(kr[c], q_s[i][c], dot);
        dpv = fmaf(do_s[i][c], v_s[tid][c], dpv);
      }
      const bool vis = ok && !causal_hidden(pr, i0 + i, key);
      const float p = vis ? expf(dot * pr.scale - lse_s[i]) : pm_s[i];
      const float ds = vis ? p * (dpv - delta_s[i]) * pr.scale : 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dv_acc[c] = fmaf(p, do_s[i][c], dv_acc[c]);
        dk_acc[c] = fmaf(ds, q_s[i][c], dk_acc[c]);
      }
    }
  }
  if (!live) return;
  float* dkr = dk + b * ldk.b + h * ldk.h + key * ldk.n;
  float* dvr = dv + b * ldv.b + h * ldv.h + key * ldv.n;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dkr[c] = dk_acc[c];
    dvr[c] = dv_acc[c];
  }
}

// ------------------------------------------------------------------ launch

Problem make_problem(int heads, int n_q, int n_k, float scale, int causal, bool has_mask) {
  Problem pr;
  pr.heads = heads;
  pr.n_q = n_q;
  pr.n_k = n_k;
  pr.causal = causal;
  pr.off = n_k - n_q;
  pr.skip = causal && !has_mask && n_k >= n_q;
  pr.scale = scale;
  pr.log_nk = logf(static_cast<float>(n_k));
  return pr;
}

Layout layout(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       void* out, float* lse, const long long* st, int batch, int dtype,
                       const Problem& pr, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((pr.n_q + kTile - 1) / kTile, pr.heads, batch);
    flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<bf16*>(out), lse, layout(st, 0), layout(st, 1), layout(st, 2),
        layout(st, 3), pr);
  } else {
    const dim3 grid((pr.n_q + kScalarRows - 1) / kScalarRows, pr.heads, batch);
    flash_fwd_f32_kernel<D><<<grid, kScalarRows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<float*>(out), lse, layout(st, 0),
        layout(st, 1), layout(st, 2), layout(st, 3), pr);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       const void* dout, const void* out, const float* lse, float* delta,
                       void* dq, void* dk, void* dv, const long long* st, int batch, int dtype,
                       const Problem& pr, cudaStream_t stream) {
  // strides: q 0, k 1, v 2, dout 3, out 4, dq 5, dk 6, dv 7. dQ first: it
  // writes the delta that dK/dV reads.
  if (dtype == 1) {
    const dim3 grid_q((pr.n_q + kTile - 1) / kTile, pr.heads, batch);
    flash_bwd_dq_kernel<D><<<grid_q, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), static_cast<const bf16*>(out), lse, delta,
        static_cast<bf16*>(dq), layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3),
        layout(st, 4), layout(st, 5), pr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid_kv((pr.n_k + kTile - 1) / kTile, pr.heads, batch);
    flash_bwd_dkv_kernel<D><<<grid_kv, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3),
        layout(st, 6), layout(st, 7), pr);
  } else {
    const dim3 grid_q((pr.n_q + kScalarRows - 1) / kScalarRows, pr.heads, batch);
    flash_bwd_dq_f32_kernel<D><<<grid_q, kScalarRows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(dout),
        static_cast<const float*>(out), lse, delta, static_cast<float*>(dq), layout(st, 0),
        layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4), layout(st, 5), pr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid_kv((pr.n_k + kScalarRows - 1) / kScalarRows, pr.heads, batch);
    flash_bwd_dkv_f32_kernel<D><<<grid_kv, kScalarRows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), layout(st, 0), layout(st, 1),
        layout(st, 2), layout(st, 3), layout(st, 6), layout(st, 7), pr);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 32 or 64. mask: (batch, n_k)
// bytes, 1 = attend, or null. strides: batch, head and row strides in
// elements of q, k, v, out (12 values; every row 16-byte aligned). lse:
// (batch, heads, n_q) f32. Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success).
int mmlearn_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                      void* lse, const long long* strides, int batch, int heads, int n_q,
                      int n_k, int head_dim, int dtype, float scale, int causal, void* stream) {
  const Problem pr = make_problem(heads, n_q, n_k, scale, causal, mask != nullptr);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 32) return launch_fwd<32>(q, k, v, m, out, l, strides, batch, dtype, pr, s);
  if (head_dim == 64) return launch_fwd<64>(q, k, v, m, out, l, strides, batch, dtype, pr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: dq, dk, dv (the inputs' shapes and type) from q, k, v, the
// mask, the cotangent `dout` of the output, the forward's output and lse
// ((batch, heads, n_q) f32). delta: a (batch, heads, n_q) f32 buffer that
// receives rowsum(dout * out). strides: q, k, v, dout, out, dq, dk, dv (24
// values). Two launches on `stream` (dQ, then dK/dV), no synchronisation;
// returns the first failing launch's cudaError_t.
int mmlearn_flash_bwd(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* out, const void* lse, void* delta,
                      void* dq, void* dk, void* dv, const long long* strides, int batch,
                      int heads, int n_q, int n_k, int head_dim, int dtype, float scale,
                      int causal, void* stream) {
  const Problem pr = make_problem(heads, n_q, n_k, scale, causal, mask != nullptr);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 32)
    return launch_bwd<32>(q, k, v, m, dout, out, l, d, dq, dk, dv, strides, batch, dtype, pr,
                          s);
  if (head_dim == 64)
    return launch_bwd<64>(q, k, v, m, dout, out, l, d, dq, dk, dv, strides, batch, dtype, pr,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mmlearn_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
