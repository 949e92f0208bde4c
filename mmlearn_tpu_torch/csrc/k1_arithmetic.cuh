// K1's bf16 arithmetic, shared by K1 (csrc/fused_attention.cu) and its
// head-grouped variant K1-p (csrc/fused_attention_packed.cu), so that both
// compute the same bits from the same inputs. Hopper, sm_90a; included once
// by each source, inside no namespace of its own.
//
// What is here, per (sample, head), and what each kernel of the two sources
// builds around it:
//   - the forward's 16-row strip (fwd_strip): the strip's scores against the
//     head's K in shared memory on mma.sync, each row's max and sum over the
//     whole row in registers (or two sweeps of 64-key chunks past 224 keys),
//     p / l rounded to bf16, then P V on mma.sync, written to the output;
//   - the backward's p and ds of every (query, key) pair (ds_head) with the
//     plain version's own f32 arithmetic (FMA chains over d, PyTorch's sum
//     orders, IEEE exp and division), rounded to bf16 into query-major
//     (nq, nq) planes, from the head's K and V in shared memory (load_kv_rows
//     or a caller's own copy, in the same layout);
//   - the backward's products from those planes (grad_head): dv = p^T dout,
//     dk = ds^T q and dq = ds k on mma.sync.
// The routines take where the operands lie in shared memory (and, for the
// forward, their row pitch); the callers decide how they get there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Shared-memory rows of a head's operand: n rounded up to 32, zeros past n,
// so that the products run over pairs of 16-key (16-row) groups with no
// check between the two.
__host__ __device__ __forceinline__ int kv_rows(int n) { return (n + 31) & ~31; }

// The head dim as the tensor cores take it: D rounded up to 16 (88 -> 96;
// 32, 64 and 80 stay). A head's operands in shared memory hold kDp<D>
// columns, those past D zeros, so the contraction over D of Q K^T, and the
// n16 tiles over D of P V and of the backward's products, read zeros there;
// nothing past column D is written out.
template <int D>
constexpr int kDp = (D + 15) & ~15;
// The bf16 row pitch in shared memory of such an operand: kDp + 8, so the 8
// rows an ldmatrix reads (16 bytes each) fall in 8 different groups of 4
// banks at every D the kernels take (pitches of 80, 144, 176 and 208 bytes).
template <int D>
constexpr int kPitch = kDp<D> + 8;

// Start copying rows 0 .. kv_rows(n) - 1 of a (n, D) operand with row
// stride `ld` into shared memory rows of kPitch; columns D .. kDp - 1 and
// rows past n are zeros.
template <int D>
__device__ __forceinline__ void rows_async(bf16* dst, const bf16* src, long long ld, int n,
                                           int tid) {
  constexpr int kChunks = kDp<D> / 8;  // 16-byte chunks a row
  const int total = kv_rows(n) * kChunks;
  for (int i = tid; i < total; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < n && c < D;
    cp_async16(dst + r * kPitch<D> + c, ok ? src + r * ld + c : src, ok ? 16 : 0);
  }
}

// A warp starts copying rows r0 .. r0 + 15 of a (n, D) operand into its own
// 16 shared-memory rows of kPitch (zeros past n and past column D).
template <int D>
__device__ __forceinline__ void strip_async(bf16* dst, const bf16* src, long long ld, int r0,
                                            int n, int lane) {
  constexpr int kChunks = kDp<D> / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < n && c < D;
    cp_async16(dst + r * kPitch<D> + c, ok ? src + (r0 + r) * ld + c : src, ok ? 16 : 0);
  }
}

// A operands of a warp's 16 staged rows by kDp, by ldmatrix: a[kc] covers
// columns 16 kc .. 16 kc + 15 (lanes 0-15 address rows 0-15 at column 16 kc,
// lanes 16-31 the same rows at 16 kc + 8).
template <int D>
__device__ __forceinline__ void strip_a(uint32_t (*a)[4], const bf16* stage, int lane) {
#pragma unroll
  for (int kc = 0; kc < kDp<D> / 16; ++kc)
    ldsm_x4(a[kc], stage + (lane & 15) * kPitch<D> + 16 * kc + ((lane >> 4) << 3));
}

// The largest of each row's values in s[0 .. 2 cg), over the four lanes of
// the row.
template <int G>
__device__ __forceinline__ void row_max(const float (&s)[2 * G][4], int cg, float& mx_lo,
                                        float& mx_hi) {
  mx_lo = mx_hi = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2 * G; ++nt) {
    if (nt < 2 * cg) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, m));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, m));
  }
}

// s = exp(s - m) in place over s[0 .. 2 cg); this lane's part of each row's
// sum is added to sum_lo / sum_hi.
template <int G>
__device__ __forceinline__ void exp_sum(float (&s)[2 * G][4], int cg, float m_lo, float m_hi,
                                        float& sum_lo, float& sum_hi) {
#pragma unroll
  for (int nt = 0; nt < 2 * G; ++nt) {
    if (nt < 2 * cg) {
      s[nt][0] = expf(s[nt][0] - m_lo);
      s[nt][1] = expf(s[nt][1] - m_lo);
      s[nt][2] = expf(s[nt][2] - m_hi);
      s[nt][3] = expf(s[nt][3] - m_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
  }
}

// What a warp's forward strip needs to score its rows: the strip's Q in A
// fragments, the head's K (rows of pitch LD) and key flags in shared memory,
// and the mask rule.
template <int D>
struct FwdStrip {
  uint32_t qa[kDp<D> / 16][4];
  const bf16* k_s;
  const uint8_t* valid_s;
  int n, row_lo;
  bool plain;  // no key mask and not causal: only keys past n are left out
  int causal;
  float scale;
};

// s = the scaled scores of the strip's 16 rows against keys 16 g0 .. 16 (g0
// + cg) - 1 (cg <= G, even): NEG where the key is masked or causal-hidden,
// -inf past n.
template <int D, int G, int LD>
__device__ __forceinline__ void score_chunk(float (&s)[2 * G][4], const FwdStrip<D>& st, int g0,
                                            int cg, int lane) {
#pragma unroll
  for (int i = 0; i < 2 * G; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  // groups in pairs: a pair's 8 B loads and 16 products, four accumulator
  // chains, issue with no check between them
#pragma unroll
  for (int j = 0; j < G; j += 2) {
    if (j < cg) {
#pragma unroll
      for (int kc = 0; kc < kDp<D> / 16; ++kc) {
#pragma unroll
        for (int jj = j; jj < j + 2; ++jj) {
          uint32_t bb[4];
          load_b_rows(bb, st.k_s, LD, (g0 + jj) * 16, kc * 16, lane);
          mma_bf16(s[2 * jj], st.qa[kc], bb);
          mma_bf16(s[2 * jj + 1], st.qa[kc], bb + 2);
        }
      }
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * G; ++nt) {
    if (nt < 2 * cg) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g0 * 16 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? st.row_lo : st.row_lo + 8;
        float x;
        if (col >= st.n) {
          x = -INFINITY;
        } else if (!st.plain && (!st.valid_s[col] || (st.causal && col > row))) {
          x = kNeg;
        } else {
          x = s[nt][e] * st.scale;
        }
        s[nt][e] = x;
      }
    }
  }
}

// acc += round(p * inv) V over keys 16 g0 .. 16 (g0 + cg) - 1 (cg even),
// where s holds p = exp(s - m): p / l is rounded to bf16, as the TPU kernel
// rounds. V's rows have pitch LD (kDp columns; acc's past D stay 0).
template <int D, int G, int LD>
__device__ __forceinline__ void pv_chunk(float (&acc)[kDp<D> / 8][4], const float (&s)[2 * G][4],
                                         int g0, int cg, float inv_lo, float inv_hi,
                                         const bf16* v_s, int lane) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if ((j & ~1) < cg) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0] * inv_lo, s[2 * j][1] * inv_lo);
      pa[1] = pack_bf16(s[2 * j][2] * inv_hi, s[2 * j][3] * inv_hi);
      pa[2] = pack_bf16(s[2 * j + 1][0] * inv_lo, s[2 * j + 1][1] * inv_lo);
      pa[3] = pack_bf16(s[2 * j + 1][2] * inv_hi, s[2 * j + 1][3] * inv_hi);
#pragma unroll
      for (int dp = 0; dp < kDp<D> / 16; ++dp) {
        uint32_t bb[4];
        load_b_cols(bb, v_s, LD, (g0 + j) * 16, dp * 16, lane);
        mma_bf16(acc[2 * dp], pa, bb);
        mma_bf16(acc[2 * dp + 1], pa, bb + 2);
      }
    }
  }
}

// One warp's forward strip: rows r0 .. r0 + 15 of a head, whose Q is in
// st.qa, against the K (st.k_s) and V (v_s) rows of pitch LD in shared
// memory; writes the rows of the output oh (row stride o_stride). G: the
// 16-key groups of scores a warp holds in registers; with kOneSweep (N <= 16
// G) a strip's whole rows, else chunks of G groups in two sweeps. skip:
// causal with no key mask, so the strip stops at its diagonal (each row
// still sees key 0, so the skipped keys add exp(NEG - m) = 0).
template <int D, int G, bool kOneSweep, int LD>
__device__ __forceinline__ void fwd_strip(FwdStrip<D>& st, const bf16* v_s, int r0, bool skip,
                                          bf16* oh, long long o_stride, int lane) {
  const int n = st.n;
  const int g = lane >> 2, t = lane & 3;
  st.row_lo = r0 + g;
  // key groups this strip sees, even
  const int ng = kv_rows(skip ? min(n, r0 + 16) : n) >> 4;

  // each row's max m and sum l: over the whole row, or a first sweep over
  // chunks of G groups with an online rescale
  float s[2 * G][4];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for (int g0 = 0; g0 < ng; g0 += G) {
    const int cg = kOneSweep ? ng : min(G, ng - g0);
    score_chunk<D, G, LD>(s, st, g0, cg, lane);
    float mx_lo, mx_hi;
    row_max<G>(s, cg, mx_lo, mx_hi);
    // key 0 is in the first chunk, so the max is finite (at least NEG)
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    l_lo *= expf(m_lo - mn_lo);
    l_hi *= expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    exp_sum<G>(s, cg, m_lo, m_hi, l_lo, l_hi);
    if (kOneSweep) break;
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, m);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, m);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;

  // acc = round(p / l) V: from the scores held, or a second sweep that
  // recomputes them chunk by chunk
  float acc[kDp<D> / 8][4];
#pragma unroll
  for (int i = 0; i < kDp<D> / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if constexpr (kOneSweep) {
    pv_chunk<D, G, LD>(acc, s, 0, ng, inv_lo, inv_hi, v_s, lane);
  } else {
    for (int g0 = 0; g0 < ng; g0 += G) {
      const int cg = min(G, ng - g0);
      score_chunk<D, G, LD>(s, st, g0, cg, lane);
      float unused_lo = 0.f, unused_hi = 0.f;
      exp_sum<G>(s, cg, m_lo, m_hi, unused_lo, unused_hi);
      pv_chunk<D, G, LD>(acc, s, g0, cg, inv_lo, inv_hi, v_s, lane);
    }
  }

  const int row_lo = r0 + g, row_hi = row_lo + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (row_lo < n)
      *reinterpret_cast<uint32_t*>(oh + row_lo * o_stride + c) = pack_bf16(acc[dn][0], acc[dn][1]);
    if (row_hi < n)
      *reinterpret_cast<uint32_t*>(oh + row_hi * o_stride + c) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// ------------------------------------------------------- the backward
//
// The plain version rounds p and ds to bf16 from f32 values, and a
// last-bit difference in either moves a rounding: in an early causal row
// (p ~ 1/2, ds ~ 1) that is a whole ulp of ds times a row of q in dK (up to
// 6.5e-3 at the text tower's grid). So the first kernel computes p and ds
// bit for bit as the plain version does on the card, and only the products
// after the roundings go to the tensor cores, in the second kernel:
//   - s = q . k and dp = dout . v as f32 FMA chains over d = 0 .. D - 1 from
//     0, the order of cuBLAS's f32 GEMM (not mma.sync, whose sums round
//     elsewhere), s then times scale;
//   - m the row's max, e = expf(s - m), l summed as PyTorch's warp softmax
//     sums a row (lane L of 32 adds keys L, L + 32, ... in order, then an
//     xor butterfly 16 .. 1), p = e / l;
//   - delta = rowsum(dout * out) as PyTorch sums D products over a warp:
//     lane L adds columns L, L + 32, ... below D in order, then the same
//     butterfly;
//   - ds = (p (dp - delta)) scale, zero where masked; p and ds rounded to
//     nearest even.
// A warp of the first kernel takes TM rows at a time, lane L the keys L, L +
// 32, ..., so a lane's part of a row's sum, and the butterfly, are
// PyTorch's as they stand. Keys past n score -inf and add exp(-inf) = 0 to
// a lane's sum, so the bits do not depend on ITS (the keys a lane holds) as
// long as 32 ITS >= n. The statistics come from the chains: the forward's
// tensor-core scores (another last bit) are not used, and the forward saves
// nothing for the backward.

// Query and key rows of the backward's p and ds planes: n rounded up to 16.
// A transposed operand xt[d * ldt + row] in shared memory has rows of ldt =
// a multiple of 64 plus 8 bf16, so the words of an mma B operand (lane 4 g
// + t: row g, word t) lie in 32 different banks; zeros past n.
__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ __forceinline__ int t_ld(int n) { return ((n + 63) & ~63) + 8; }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// two bf16 at p (4-byte aligned), shared or device memory
__device__ __forceinline__ uint32_t word_at(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two consecutive values of a row of K or V in shared memory as f32: kept
// in f32 (one 8-byte load), or in bf16 past 224 keys (one 4-byte load).
__device__ __forceinline__ float2 pair_at(const float* y) {
  return *reinterpret_cast<const float2*>(y);
}
__device__ __forceinline__ float2 pair_at(const bf16* y) {
  const uint32_t w = word_at(y);
  return make_float2(bf16_lo(w), bf16_hi(w));
}

// c[r][it] = sum over d of x[d][r] y[lane + 32 it][d], each an f32 FMA chain
// over d = 0 .. D - 1 from 0. x: TM rows transposed in f32 (x[d * TM + r]);
// y: rows of D + 2 values in shared memory (so that the 32 lanes' rows lie
// in different banks).
template <int D, int TM, int ITS, typename T>
__device__ __forceinline__ void chain_rows(float (&c)[TM][ITS], const float* x, const T* y,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int it = 0; it < ITS; ++it) c[r][it] = 0.f;
  const T* yl = y + lane * (D + 2);
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float2 yv[ITS];
#pragma unroll
    for (int it = 0; it < ITS; ++it) yv[it] = pair_at(yl + it * 32 * (D + 2) + d);
    float x0[TM], x1[TM];
#pragma unroll
    for (int r = 0; r < TM; r += 2) {
      const float2 a = *reinterpret_cast<const float2*>(x + d * TM + r);
      const float2 z = *reinterpret_cast<const float2*>(x + (d + 1) * TM + r);
      x0[r] = a.x;
      x0[r + 1] = a.y;
      x1[r] = z.x;
      x1[r + 1] = z.y;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int it = 0; it < ITS; ++it) c[r][it] = __fmaf_rn(x0[r], yv[it].x, c[r][it]);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int it = 0; it < ITS; ++it) c[r][it] = __fmaf_rn(x1[r], yv[it].y, c[r][it]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

constexpr int kDsWarps = 8;  // warps of a block of the backward's first kernel
constexpr int kDsThreads = 32 * kDsWarps;

__device__ __forceinline__ void store_pair(float* dst, uint32_t w) {
  *reinterpret_cast<float2*>(dst) = make_float2(bf16_lo(w), bf16_hi(w));
}
__device__ __forceinline__ void store_pair(bf16* dst, uint32_t w) {
  *reinterpret_cast<uint32_t*>(dst) = w;
}
// 8 bf16 (16 bytes) into a row of K or V in shared memory
template <typename T>
__device__ __forceinline__ void store_eight(T* dst, uint4 x) {
  store_pair(dst, x.x);
  store_pair(dst + 2, x.y);
  store_pair(dst + 4, x.z);
  store_pair(dst + 6, x.w);
}

// Copy an (n, D) operand with row stride ld into shared memory transposed,
// xt[d * ldt + row], zeros for rows n .. ldt - 1: a thread takes two rows
// and 8 columns (two 16-byte loads, eight 4-byte stores).
template <int D, int kThreadsT>
__device__ __forceinline__ void load_transposed(bf16* xt, int ldt, const bf16* src, long long ld,
                                                int n, int tid) {
  const int pairs = ldt / 2, total = pairs * (D / 8);
  for (int base = 0; base < total; base += 4 * kThreadsT) {  // 4 pairs a thread in flight
    uint4 x0[4], x1[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + tid + u * kThreadsT, k0 = 2 * (i % pairs), c = (i / pairs) * 8;
      x0[u] = x1[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && k0 < n) x0[u] = *reinterpret_cast<const uint4*>(src + k0 * ld + c);
      if (i < total && k0 + 1 < n)
        x1[u] = *reinterpret_cast<const uint4*>(src + (k0 + 1) * ld + c);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + tid + u * kThreadsT, k0 = 2 * (i % pairs), c = (i / pairs) * 8;
      if (i >= total) continue;
      const uint32_t a[4] = {x0[u].x, x0[u].y, x0[u].z, x0[u].w};
      const uint32_t z[4] = {x1[u].x, x1[u].y, x1[u].z, x1[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // columns c + 2 j and c + 2 j + 1 of both rows
        *reinterpret_cast<uint32_t*>(xt + (c + 2 * j) * ldt + k0) =
            __byte_perm(a[j], z[j], 0x5410);
        *reinterpret_cast<uint32_t*>(xt + (c + 2 * j + 1) * ldt + k0) =
            __byte_perm(a[j], z[j], 0x7632);
      }
    }
  }
}

__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// dst rows r and r + 8 (columns 2 t, 2 t + 1 of 8 dn + ...) of a warp's 16 x kDp
// f32 accumulators, into a bf16 (rows, D) operand with row stride ld (the
// columns past D are not written).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int r, int n,
                                           const float (&acc)[kDp<D> / 8][4], int t) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (r < n) *reinterpret_cast<uint32_t*>(dst + r * ld + c) = pack_bf16(acc[dn][0], acc[dn][1]);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * ld + c) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// Shared memory of grad_head: two transposed (kDp, t_ld(n)) bf16 operands.
// Their rows D .. kDp - 1 are never written: they are the n dimension of
// every product here, so they make only the accumulators' columns past D,
// which store_rows leaves out.
template <int D>
size_t grad_smem_bytes(int n) {
  return 2 * static_cast<size_t>(kDp<D>) * t_ld(n) * sizeof(bf16);
}

// The second kernel's work for head h of sample b, by a block of kThreads:
// dv = p^T dout and dk = ds^T q over key strips (q and dout transposed in
// shared memory), then dq = ds k over query strips (k transposed), all on
// the tensor cores from the planes of the first kernel. With causal and no
// key mask (skip) a key strip starts, and a query strip stops, at its
// diagonal. Ends with every warp still reading k^T: a caller that reuses
// smem synchronises first.
template <int D>
__device__ __forceinline__ void grad_head(unsigned char* smem, const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ dout,
                                          const bf16* __restrict__ p_s,
                                          const bf16* __restrict__ ds_s, bf16* __restrict__ dqkv,
                                          int n, int heads, int skip, int h, int b) {
  const int ldt = t_ld(n), nq = round16(n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* xa = reinterpret_cast<bf16*>(smem);
  bf16* xb = xa + kDp<D> * ldt;

  const long long row_stride = 3LL * heads * D;
  const long long o_stride = static_cast<long long>(heads) * D;
  const long long head_off = static_cast<long long>(b) * n * row_stride + 3LL * h * D;
  const bf16* head = qkv + head_off;
  bf16* dh = dqkv + head_off;
  const bf16* doh = dout + static_cast<long long>(b) * n * o_stride + static_cast<long long>(h) * D;
  const long long plane = (static_cast<long long>(b) * heads + h) * nq * nq;
  const bf16* pp = p_s + plane;
  const bf16* dsp = ds_s + plane;

  load_transposed<D, kThreads>(xa, ldt, head, row_stride, n, tid);  // q^T
  load_transposed<D, kThreads>(xb, ldt, doh, o_stride, n, tid);     // dout^T
  __syncthreads();
  for (int k0 = warp * 16; k0 < n; k0 += kWarps * 16) {
    float dk[kDp<D> / 8][4], dv[kDp<D> / 8][4];
#pragma unroll
    for (int i = 0; i < kDp<D> / 8; ++i) {
      dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
      dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }
#pragma unroll 4
    for (int r0 = skip ? k0 : 0; r0 < nq; r0 += 16) {
      // the (rows r0.., keys k0..) blocks of p and ds, transposed by 8 x 8
      // into A operands of p^T and ds^T (keys by rows)
      const long long at = static_cast<long long>(r0 + g) * nq + k0 + 2 * t;
      const uint32_t pa[4] = {transpose8x8(word_at(pp + at)), transpose8x8(word_at(pp + at + 8)),
                              transpose8x8(word_at(pp + at + 8 * nq)),
                              transpose8x8(word_at(pp + at + 8 * nq + 8))};
      const uint32_t da[4] = {transpose8x8(word_at(dsp + at)),
                              transpose8x8(word_at(dsp + at + 8)),
                              transpose8x8(word_at(dsp + at + 8 * nq)),
                              transpose8x8(word_at(dsp + at + 8 * nq + 8))};
#pragma unroll
      for (int j = 0; j < kDp<D> / 16; ++j) {  // columns 16 j .. 16 j + 15 of dv and dk
        uint32_t bd[4], bq[4];
        load_b_rows(bd, xb, ldt, 16 * j, r0, lane);
        load_b_rows(bq, xa, ldt, 16 * j, r0, lane);
        mma_bf16(dv[2 * j], pa, bd);
        mma_bf16(dv[2 * j + 1], pa, bd + 2);
        mma_bf16(dk[2 * j], da, bq);
        mma_bf16(dk[2 * j + 1], da, bq + 2);
      }
    }
    store_rows<D>(dh + D, row_stride, k0 + g, n, dk, t);
    store_rows<D>(dh + 2 * D, row_stride, k0 + g, n, dv, t);
  }

  __syncthreads();  // every warp is done with q^T
  load_transposed<D, kThreads>(xa, ldt, head + D, row_stride, n, tid);  // k^T
  __syncthreads();
  for (int r0 = warp * 16; r0 < n; r0 += kWarps * 16) {
    float acc[kDp<D> / 8][4];
#pragma unroll
    for (int i = 0; i < kDp<D> / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const int kend = skip ? r0 + 16 : nq;
#pragma unroll 4
    for (int key0 = 0; key0 < kend; key0 += 16) {
      const long long at = static_cast<long long>(r0 + g) * nq + key0 + 2 * t;
      const uint32_t da[4] = {word_at(dsp + at), word_at(dsp + at + 8 * nq), word_at(dsp + at + 8),
                              word_at(dsp + at + 8 * nq + 8)};
#pragma unroll
      for (int j = 0; j < kDp<D> / 16; ++j) {
        uint32_t bk[4];
        load_b_rows(bk, xa, ldt, 16 * j, key0, lane);
        mma_bf16(acc[2 * j], da, bk);
        mma_bf16(acc[2 * j + 1], da, bk + 2);
      }
    }
    store_rows<D>(dh, row_stride, r0 + g, n, acc, t);
  }
}

// The first kernel's shared memory for one head, in this order: K and V in
// rows of D + 2 values of T (kKeys = 32 ITS rows, zeros past n), each warp's
// q and dout rows transposed in f32, each warp's p and ds rows in bf16
// (with K and V in f32 only: past 224 keys shared memory holds K and V in
// bf16 and no more), the key flags.
template <int D, int TM, int ITS, typename T>
constexpr size_t ds_smem_bytes() {
  return 2 * 32 * ITS * (D + 2) * sizeof(T) + kDsWarps * 2 * D * TM * sizeof(float) +
         (sizeof(T) == sizeof(float) ? kDsWarps * 2 * TM * 32 * ITS * sizeof(bf16) : 0) +
         32 * ITS;
}

// The head's K and V (columns D and 2 D of `head`, row stride 3 H D) into
// rows of D + 2 values of T, zeros past n, and the key flags: 16-byte
// chunks, 8 a thread loaded before any is stored.
template <int D, int ITS, typename T>
__device__ __forceinline__ void load_kv_rows(T* k_s, T* v_s, uint8_t* valid_s, const bf16* head,
                                             long long row_stride, const uint8_t* valid, int n,
                                             int tid) {
  constexpr int kLd = D + 2;
  constexpr int kKeys = 32 * ITS;
  constexpr int kChunks = kKeys * (D / 8);
  for (int base = 0; base < kChunks; base += 8 * kDsThreads) {
    uint4 kc[8], vc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = base + tid + j * kDsThreads, r = i / (D / 8), c = 8 * (i % (D / 8));
      kc[j] = vc[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kChunks && r < n) {
        kc[j] = *reinterpret_cast<const uint4*>(head + r * row_stride + D + c);
        vc[j] = *reinterpret_cast<const uint4*>(head + r * row_stride + 2 * D + c);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = base + tid + j * kDsThreads, r = i / (D / 8), c = 8 * (i % (D / 8));
      if (i < kChunks) {
        store_eight(k_s + r * kLd + c, kc[j]);
        store_eight(v_s + r * kLd + c, vc[j]);
      }
    }
  }
  for (int i = tid; i < kKeys; i += kDsThreads) valid_s[i] = i < n && (!valid || valid[i]);
}

// The first kernel's work for one (sample, head) by a block of kDsWarps
// warps, the head's K and V already in shared memory (layout of
// ds_smem_bytes) with its key flags: p and ds of every (query, key) pair,
// rounded to bf16, into the query-major planes p_s + plane and ds_s + plane
// of (nq, nq), nq = n rounded up to 16 (rows and keys past n hold finite
// values, ds = 0). A warp takes TM query rows at a time, lane L keys L + 32
// it, it < ITS. head: the head's q (row stride row_stride); oh, doh: its
// out and dout (row stride o_stride); qt, dot, stage: the warp's own rows.
template <int D, int TM, int ITS, typename T>
__device__ __forceinline__ void ds_head(const T* k_s, const T* v_s, float* qt, float* dot,
                                        bf16* stage, const uint8_t* valid_s, const bf16* head,
                                        const bf16* oh, const bf16* doh, long long row_stride,
                                        long long o_stride, bf16* p_s, bf16* ds_s,
                                        long long plane, int n, bool plain, int causal,
                                        float scale, int warp, int lane) {
  constexpr int kKeys = 32 * ITS;
  constexpr int kStage = sizeof(T) == sizeof(float) ? 2 * TM * kKeys : 0;
  const int nq = round16(n);
  // a lane's words of a set of TM rows of q and dout (the next set's are
  // loaded while the current one is computed): TM D / 2 words over the warp
  constexpr int kRowWords = TM * D / 2;
  constexpr int kWords = (kRowWords + 31) / 32;
  // columns lane + 32 j of a row, for delta and out
  constexpr int kLaneCols = (D + 31) / 32;
  uint32_t qw[kWords], dw[kWords];
  auto fetch = [&](int rs) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int i = lane + 32 * k, r = i % TM, c = 2 * (i / TM);
      const bool ok = rs + r < n && i < kRowWords;
      qw[k] = ok ? word_at(head + (rs + r) * row_stride + c) : 0u;
      dw[k] = ok ? word_at(doh + (rs + r) * o_stride + c) : 0u;
    }
  };
  fetch(warp * TM);
  for (int r0 = warp * TM; r0 < nq; r0 += kDsWarps * TM) {
    __syncwarp();  // every lane is done with the last rows
    if (r0 >= n) {  // rows past n: p = ds = 0
      for (int i = lane; i < 2 * TM * (nq / 8); i += 32) {
        const int row = i / (nq / 8), c = 8 * (i % (nq / 8));
        *reinterpret_cast<uint4*>((row < TM ? p_s : ds_s) + plane +
                                  static_cast<long long>(r0 + row % TM) * nq + c) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int i = lane + 32 * k, r = i % TM, c = 2 * (i / TM);
      if (kRowWords % 32 != 0 && i >= kRowWords) continue;
      qt[c * TM + r] = bf16_lo(qw[k]);
      qt[(c + 1) * TM + r] = bf16_hi(qw[k]);
      dot[c * TM + r] = bf16_lo(dw[k]);
      dot[(c + 1) * TM + r] = bf16_hi(dw[k]);
    }
    __syncwarp();  // the rows are written
    if (r0 + kDsWarps * TM < nq) fetch(r0 + kDsWarps * TM);
    // out at columns lane, lane + 32, ... below D, for delta
    float ov[TM][kLaneCols];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        ov[r][j] = r0 + r < n && lane + 32 * j < D
                       ? __bfloat162float(oh[(r0 + r) * o_stride + lane + 32 * j])
                       : 0.f;

    float s[TM][ITS];
    chain_rows<D, TM, ITS>(s, qt, k_s, lane);
    // delta of each row as PyTorch sums it: lane L adds dout * out at
    // columns L, L + 32, ... below D, then the butterfly
    float delta[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        if (D % 32 == 0 || lane + 32 * j < D)
          part = __fadd_rn(part, __fmul_rn(dot[(lane + 32 * j) * TM + r], ov[r][j]));
      delta[r] = warp_sum(part);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = r0 + r;
      float m = -INFINITY;
#pragma unroll
      for (int it = 0; it < ITS; ++it) {
        const int key = lane + 32 * it;
        float x;
        if (key >= n) {
          x = -INFINITY;
        } else if (!plain && (!valid_s[key] || (causal && key > row))) {
          x = kNeg;
        } else {
          x = __fmul_rn(s[r][it], scale);
        }
        s[r][it] = x;
        m = fmaxf(m, x);
      }
      m = warp_max(m);
      float part = 0.f;
#pragma unroll
      for (int it = 0; it < ITS; ++it) {
        s[r][it] = expf(__fsub_rn(s[r][it], m));
        part = __fadd_rn(part, s[r][it]);
      }
      const float l = warp_sum(part);
#pragma unroll
      for (int it = 0; it < ITS; ++it) s[r][it] = __fdiv_rn(s[r][it], l);
    }

    float dp[TM][ITS];
    chain_rows<D, TM, ITS>(dp, dot, v_s, lane);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = r0 + r;
#pragma unroll
      for (int it = 0; it < ITS; ++it) {
        const int key = lane + 32 * it;
        const bool vis = key < n && (plain || (valid_s[key] && !(causal && key > row)));
        const float ds =
            vis ? __fmul_rn(__fmul_rn(s[r][it], __fsub_rn(dp[r][it], delta[r])), scale) : 0.f;
        if constexpr (kStage > 0) {
          stage[r * kKeys + key] = __float2bfloat16_rn(s[r][it]);
          stage[(TM + r) * kKeys + key] = __float2bfloat16_rn(ds);
        } else if (key < nq) {
          const long long at = plane + static_cast<long long>(row) * nq + key;
          p_s[at] = __float2bfloat16_rn(s[r][it]);
          ds_s[at] = __float2bfloat16_rn(ds);
        }
      }
    }
    __syncwarp();
    // rows of nq keys of each plane, 8 keys a chunk
    for (int i = lane; kStage > 0 && i < 2 * TM * (nq / 8); i += 32) {
      const int row = i / (nq / 8), c = 8 * (i % (nq / 8));  // row: plane * TM + r
      bf16* dst = (row < TM ? p_s : ds_s) + plane +
                  static_cast<long long>(r0 + row % TM) * nq + c;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(stage + row * kKeys + c);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
