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
//        accumulator across key tiles, p rounded to the input type before
//        its product with v; lse = m + log(l) (f32, (B, H, N_q));
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
// What bounds it on the H100. At B = 64, H = 12, N = 785, D = 64 (the 448-px
// step) the forward is 4 B H N^2 D = 1.21e11 operations, 0.1225 ms at 989
// TFLOP/s, against q, k, v and out, 4 B H N D * 2 bytes = 309 MB, 0.092 ms at
// 3.35 TB/s; the backward's five products are 3.03e11 operations (0.306 ms)
// and K3b computes seven (the dQ pass recomputes s and dp: 0.429 ms). At B =
// 1, N = 16,385 the forward is 8.25e11 operations (0.834 ms) against 101 MB
// (0.030 ms). Bound by operations, by a margin that grows with N: the scores
// never leave the chip. Beside the tensor cores, every score costs an
// exponential on the SFUs (16 a clock an SM), and at D = 64 a 64 x 64 tile's
// 4,096 exponentials take as long as its two products: the softmax has to
// run while the tensor cores work, and its code has to be lean.
//
// Design. Every bf16 product is a wgmma (m64nNk16, bf16 in, f32
// accumulators; Hopper's full tensor-core rate, which mma.sync does not
// reach), issued by the block's one consumer warpgroup for 64 query rows (64
// keys in dK/dV); one producer warp beside it. The producer's lane 0 brings
// tiles of 64 rows by TMA from the operands' own strided views (a 4-d tensor
// map each, encoded on the host for every call from the view's pointer,
// extents and strides; rows past the end land as zeros, swizzled as the
// wgmma descriptors read them) into a ring of kStages = 4 shared-memory
// stages, each with a full and an empty mbarrier; its lanes also write what
// a stage needs beside the tiles (the key mask's bytes, or the rows' lse and
// delta). The consumers wait on full and thread 0 arrives on empty once the
// last product of the stage has completed: every read of the stage feeds
// that product. Two tiles are in flight in the consumer: the products of
// tile i run while the scores of tile i + 1 arrive and their softmax (or p
// and ds) is computed; a tile with nothing masked, causal-hidden or past the
// keys (the main path) takes a branch-free path with one FFMA and one EX2 a
// score.
//   K3f     a block per (64 query rows, head, sample): Q once, K and V
//           stream; S = Q K^T (SS), the online softmax in registers, O +=
//           P V (RS: P from the score accumulators rounded to bf16, V read
//           MN-major through the descriptor);
//   K3b-dq  per (64 query rows, head, sample), launched first: delta of its
//           rows (from O and dO in device memory, f32, written out); Q and
//           dO once, K and V stream; S = Q K^T, dP = dO V^T (SS), ds in
//           registers, dQ += dS K (RS, K read MN-major);
//   K3b-dkv per (64 keys, head, sample): K and V once; Q, dO and the rows'
//           lse and delta stream; S^T = K Q^T, dP^T = V dO^T (SS), p and ds
//           in registers, dV += P^T dO and dK += dS^T Q (RS, dO and Q read
//           MN-major).
// One consumer warpgroup a block beat two or three sharing the stream (more
// blocks an SM, 3 in K3f; measured in PERF.md), as four stages beat three
// and six. No atomics, so the gradients are the same bits from run to run;
// the cost is the dQ pass's recomputed S and dP (seven products a tile pair,
// against five with an atomic dQ). Under a causal mask without a key mask,
// key (or query) tiles wholly past the diagonal are skipped. The gradients
// are written through arbitrary strides, so K3b writes dq, dk and dv straight
// into the three views of a packed (B, N, H, 3, D) buffer, the gradient of
// the packed projection. f32 keeps full f32 arithmetic: a scalar kernel, one
// thread a row (or key).
// Head dims 32 and 64 keep one swizzle span a tile row (Tile). At 80 and 88
// (vit_huge, vit_giant) a 160- or 176-byte row is three spans of 32 columns,
// each a sub-tile of its own, a TMA box and a 64-byte swizzle; the last box
// reaches column 96 past the tensor map's extent D, so TMA lands zeros there
// (no host-side padded copy). The contractions over D take their k16 slices
// span by span (5 at D = 80, 6 at 88); the products over D are one N = 32
// wgmma a span (96 columns, those past D never written). D = 128 (the ring's
// head dim beside 64) is four such spans: a tile is 16 KB, twice D = 64's, and
// the 64-row tiles and four stages still fit one block an SM (145 KB forward,
// 161 KB dQ, 163 KB dK/dV of the 227 KB), as at D = 80 and 88 (121-124 KB):
// fewer stages would free room for a second block but starve the one
// consumer warpgroup's two tiles in flight, and 64 rows is the m64 of wgmma.
// The f32 scalar kernels take key (query) tiles of 8 at D = 128, so their
// static shared memory stays under 48 KB.
//
// The ring's forward hop (mmlearn_tpu/ops/ring_attention.py `_block_attn_flash`
// :125, `_flash_forward_pallas` with out_dtype=float32) is K3f with an f32
// output: for bf16 q, k, v the kernel writes its f32 accumulator divided by
// the row's normaliser straight to an f32 buffer (flash_fwd_kernel<D, float>),
// with no bf16 rounding of the output, so the ring's log-sum-exp merge runs in
// f32 as the JAX package's does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

// -0.7 * FLT_MAX rounded to f32 (bits 0xff333332), the JAX package's
// DEFAULT_MASK_VALUE and the port's NEG, bit for bit
constexpr float kNeg = -0x1.666664p+127f;

constexpr int kTile = 64;        // rows (keys) of a tile: one warpgroup's m64
constexpr int kStages = 4;       // stages of the ring
constexpr int kThreads = 160;    // the consumer warpgroup and the producer warp
constexpr int kScalarRows = 64;  // f32 kernels: one thread a row (or key)
// f32 kernels: keys (or queries) a tile; 8 at D = 128, where 32 rows of k and
// v beside a row a thread of do (or v) would pass the 48 KB of static shared
// memory
template <int D>
__host__ __device__ constexpr int scalar_tile() {
  return D > 88 ? 8 : 32;
}

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

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (MUFU.EX2; the fast exponential the kernels take as e^y = 2^(y log2 e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------- bf16: the tiles

// Where the rows, heads and batch of an operand went among its tensor map's
// coordinates 1..3 (coordinate 0 is D).
struct MapDims {
  int n, h, b;
};

// A tile: 64 rows of an operand, in column spans of one swizzle each. At D =
// 32 and 64 one span (rows of 64 or 128 bytes, the swizzle of that width).
// At D = 80 and 88 three spans of 32 columns (64-byte rows, 64-byte
// swizzle), each its own TMA box and its own 4 KB sub-tile, the last
// reaching column 96: TMA fills the columns past D with zeros, so the
// contraction over D reads zeros there, and the products over D (N = 32 a
// span) make columns past D that are never written out. Every wgmma
// operand then lies in one span: a K-major k16 slice of the contraction
// over D in the span that holds its 16 columns, an MN-major one (rows the
// contraction, D the product's N) one N = span product a span.
template <int D>
struct Tile {
  static constexpr int kSpanCols = D <= 64 ? D : 32;
  static constexpr int kSpans = (D + kSpanCols - 1) / kSpanCols;
  static constexpr int kRowBytes = 2 * kSpanCols;       // a span's row: one swizzle span
  static constexpr int kSpanBytes = kTile * kRowBytes;  // a multiple of 1024
  static constexpr int kBytes = kSpans * kSpanBytes;
  static constexpr int kSliceRows = 16 * kRowBytes;  // bytes of 16 rows: one k16 slice, MN-major
  static constexpr int kSlices = (D + 15) / 16;      // k16 slices of the contraction over D
  static constexpr int kAcc = kSpanCols / 2;         // f32 accumulators a thread, a span
  static __device__ __forceinline__ uint64_t desc(const uint8_t* tile) {
    return tile_desc<kRowBytes>(tile);
  }
  // bytes from a tile's descriptor to k16 slice kc of the contraction over D
  __host__ __device__ static constexpr uint32_t slice(int kc) {
    return (kc / (kSpanCols / 16)) * kSpanBytes + 32 * (kc % (kSpanCols / 16));
  }
  // bytes from a tile's descriptor to rows 16 kc .. 16 kc + 15 of span sp,
  // read MN-major
  __host__ __device__ static constexpr uint32_t rows(int sp, int kc) {
    return sp * kSpanBytes + kc * kSliceRows;
  }
};

// rows row .. row + 63 of head h of sample b, by TMA: one box a span
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, MapDims md,
                                          uint64_t* bar, int row, int h, int b) {
  const int c1 = md.n == 1 ? row : md.h == 1 ? h : b;
  const int c2 = md.n == 2 ? row : md.h == 2 ? h : b;
  const int c3 = md.n == 3 ? row : md.h == 3 ? h : b;
#pragma unroll
  for (int sp = 0; sp < Tile<D>::kSpans; ++sp)
    tma_load_4d(dst + sp * Tile<D>::kSpanBytes, map, bar, sp * Tile<D>::kSpanCols, c1, c2, c3);
}

// one accumulator of a (64, D) product: kSpans spans of N = kSpanCols
template <int D>
using Acc = float[Tile<D>::kSpans][Tile<D>::kAcc];

template <int D>
__device__ __forceinline__ void zero_acc(Acc<D>& r) {
#pragma unroll
  for (int sp = 0; sp < Tile<D>::kSpans; ++sp)
#pragma unroll
    for (int i = 0; i < Tile<D>::kAcc; ++i) r[sp][i] = 0.f;
}
template <int D>
__device__ __forceinline__ void fence_acc(Acc<D>& r) {
#pragma unroll
  for (int sp = 0; sp < Tile<D>::kSpans; ++sp) fence_regs(r[sp]);
}
// acc += A B over the 64 rows (keys or queries) of a tile whose rows are
// the contraction, read MN-major at descriptor b, A the four k16 slices in
// registers
template <int D>
__device__ __forceinline__ void rs_product(Acc<D>& acc, const uint32_t (&a)[kTile / 16][4],
                                           uint64_t b) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc)
#pragma unroll
    for (int sp = 0; sp < Tile<D>::kSpans; ++sp)
      Mma<Tile<D>::kSpanCols>::template rs<1>(acc[sp], a[kc], desc_add(b, Tile<D>::rows(sp, kc)),
                                              1);
}
// acc (f32, rows row_lo and row_hi of this thread) rounded to bf16 into the
// rows of an (n, D) operand with row stride ld: columns below D only
// (OutT float: the f32 values as they are, two a store)
template <int D, typename OutT = bf16>
__device__ __forceinline__ void store_acc(OutT* x, long long ld, const Acc<D>& acc, int row_lo,
                                          int row_hi, int rows, int t, float s_lo = 1.f,
                                          float s_hi = 1.f, bool divide = false) {
  constexpr bool kF32 = sizeof(OutT) == 4;
#pragma unroll
  for (int sp = 0; sp < Tile<D>::kSpans; ++sp) {
#pragma unroll
    for (int c = 0; c < Tile<D>::kSpanCols / 8; ++c) {
      const int col = sp * Tile<D>::kSpanCols + 8 * c + 2 * t;
      if (col >= D) continue;
      const float* a = acc[sp] + 4 * c;
      const float x0 = divide ? a[0] / s_lo : a[0], x1 = divide ? a[1] / s_lo : a[1];
      const float x2 = divide ? a[2] / s_hi : a[2], x3 = divide ? a[3] / s_hi : a[3];
      if constexpr (kF32) {
        if (row_lo < rows) *reinterpret_cast<float2*>(x + row_lo * ld + col) = make_float2(x0, x1);
        if (row_hi < rows) *reinterpret_cast<float2*>(x + row_hi * ld + col) = make_float2(x2, x3);
      } else {
        if (row_lo < rows) *reinterpret_cast<uint32_t*>(x + row_lo * ld + col) = pack_bf16(x0, x1);
        if (row_hi < rows) *reinterpret_cast<uint32_t*>(x + row_hi * ld + col) = pack_bf16(x2, x3);
      }
    }
  }
}

// the dynamic shared memory, 1024-byte aligned (the swizzle's period)
__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
}

// Two bf16 of row `row` at column `col` (even) of a (rows, D) operand, 0
// past its rows.
__device__ __forceinline__ uint32_t load_pair(const bf16* x, long long ld, int row, int col,
                                              int rows) {
  return row < rows ? *reinterpret_cast<const uint32_t*>(x + row * ld + col) : 0u;
}
// a0 * b0 + a1 * b1 of two packed bf16 pairs, in f32
__device__ __forceinline__ float dot_pair(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return fmaf(x.x, y.x, x.y * y.y);
}

// ------------------------------------------------------- bf16: K3f forward

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + (1 + 2 * kStages) * Tile<D>::kBytes + kStages * kTile + (1 + 2 * kStages) * 8;
}

// The forward's online softmax for one key tile of scores `sc` (q . k, f32,
// m64 x 64, this thread's two rows): scaled, -inf past n_k, NEG where masked
// or causal-hidden; the running max and sum move on and sc becomes p
// (unnormalised). Returns in a_lo, a_hi the factors that rescale the
// accumulator. kPlain: a tile with nothing hidden, past n_k or masked (the
// main path), so no test an element; the max is taken before the scale (a
// positive factor) and p = 2^(s scale log2 e - m log2 e) in one FFMA.
struct OnlineSoftmax {
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  template <bool kPlain>
  __device__ __forceinline__ void step(float (&sc)[kTile / 2], float& a_lo, float& a_hi,
                                       const Problem& pr, const uint8_t* valid_t, bool masked,
                                       int k0, int row_lo, int row_hi, int t) {
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * c + e];
        if (!kPlain) {
          const int j = 8 * c + 2 * t + (e & 1), col = k0 + j;
          const bool vis = (!masked || valid_t[j]) &&
                           !causal_hidden(pr, e < 2 ? row_lo : row_hi, col);
          x = col < pr.n_k ? (vis ? x * pr.scale : kNeg) : -INFINITY;
          sc[4 * c + e] = x;
        }
        if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
    }
    // the four lanes of a row hold its columns
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    if (kPlain) {
      mx_lo *= pr.scale;
      mx_hi *= pr.scale;
    }
    // key k0 is in range, so the new max is finite (at least NEG)
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    a_lo = ex2((m_lo - mn_lo) * kLog2e);
    a_hi = ex2((m_hi - mn_hi) * kLog2e);
    m_lo = mn_lo;
    m_hi = mn_hi;
    const float c2 = pr.scale * kLog2e, mb_lo = mn_lo * kLog2e, mb_hi = mn_hi * kLog2e;
    // each lane sums its own columns; the lanes of a row add up at the end
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[4 * c + e];
        sc[4 * c + e] = kPlain ? ex2(fmaf(x, c2, e < 2 ? -mb_lo : -mb_hi))
                               : ex2((x - (e < 2 ? mn_lo : mn_hi)) * kLog2e);
      }
      s_lo += sc[4 * c + 0] + sc[4 * c + 1];
      s_hi += sc[4 * c + 2] + sc[4 * c + 3];
    }
    l_lo = fmaf(l_lo, a_lo, s_lo);
    l_hi = fmaf(l_hi, a_hi, s_hi);
  }
};

// OutT: bf16, or float for the ring's hop (the f32 accumulator divided by
// the normaliser, with no bf16 rounding)
template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, MapDims dim_q, MapDims dim_k,
                     MapDims dim_v, const uint8_t* __restrict__ mask, OutT* __restrict__ out,
                     float* __restrict__ lse, Layout lo, Problem pr) {
  using T = Tile<D>;
  uint8_t* q_s = aligned_smem();
  uint8_t* k_s = q_s + T::kBytes;                // kStages tiles
  uint8_t* v_s = k_s + kStages * T::kBytes;      // kStages tiles
  uint8_t* valid_s = v_s + kStages * T::kBytes;  // kStages x 64 mask bytes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(valid_s + kStages * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  // under `skip`, key tiles wholly past the diagonal of the block's rows
  const int kv_end = pr.skip ? min(pr.n_k, q0 + kTile + pr.off) : pr.n_k;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);  // the producer's lanes, lane 0 with the bytes
      mbar_init(empty + s, 1);  // the consumers' thread 0
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_k);
      tma_prefetch(&map_v);
      mbar_arrive_expect_tx(q_full, T::kBytes);
      load_tile<D>(q_s, &map_q, dim_q, q_full, q0, h, b);
    }
    const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
      if (valid) {
        for (int j = lane; j < kTile; j += 32) {
          const int key = it * kTile + j;
          valid_s[s * kTile + j] = key < pr.n_k && valid[key];
        }
      }
      // each lane arrives after its own stores; lane 0 also sets the bytes
      if (lane == 0) {
        mbar_arrive_expect_tx(full + s, 2 * T::kBytes);
        load_tile<D>(k_s + s * T::kBytes, &map_k, dim_k, full + s, it * kTile, h, b);
        load_tile<D>(v_s + s * T::kBytes, &map_v, dim_v, full + s, it * kTile, h, b);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  const int tw = threadIdx.x, warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const uint64_t q_desc = T::desc(q_s);
  const bool masked = mask != nullptr;

  Acc<D> o;
  zero_acc<D>(o);
  OnlineSoftmax sm;
  float a_lo, a_hi;
  // s = q k^T of key tile `it` into sc (issued, not waited for)
  float sc[kTile / 2];
  auto scores = [&](int it) {
    const int s = it % kStages;
    mbar_wait(full + s, (it / kStages) & 1);
    const uint64_t k_desc = T::desc(k_s + s * T::kBytes);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < T::kSlices; ++kc)
      Mma<kTile>::ss(sc, desc_add(q_desc, T::slice(kc)), desc_add(k_desc, T::slice(kc)), kc);
    wgmma_commit();
  };
  auto softmax = [&](int it) {
    const int k0 = it * kTile;
    const uint8_t* valid_t = valid_s + (it % kStages) * kTile;
    if (!masked && !pr.causal && k0 + kTile <= pr.n_k)
      sm.template step<true>(sc, a_lo, a_hi, pr, valid_t, masked, k0, row_lo, row_hi, t);
    else
      sm.template step<false>(sc, a_lo, a_hi, pr, valid_t, masked, k0, row_lo, row_hi, t);
  };
  // o += p v of key tile `it` (issued, not waited for), p rounded to bf16
  // (the TPU kernel's p.astype(v.dtype))
  uint32_t pa[kTile / 16][4];
  auto values = [&](int it) {
    wgmma_fence();
    rs_product<D>(o, pa, T::desc(v_s + (it % kStages) * T::kBytes));
    wgmma_commit();
  };

  // Two key tiles in flight: while o += p v of tile it runs, s of tile it + 1
  // is computed, then its softmax; once the product is done, its p becomes
  // the next A operand and o is rescaled.
  mbar_wait(q_full, 0);
  scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) as_a(pa[kc], sc, kc);
  for (int it = 0; it + 1 < n_tiles; ++it) {
    scores(it + 1);
    values(it);
    wgmma_wait<1>();  // the scores of tile it + 1
    fence_regs(sc);
    softmax(it + 1);
    wgmma_wait<0>();  // o += p v of tile it
    fence_acc<D>(o);
    fence_regs(pa);
    if (tw == 0) mbar_arrive(empty + it % kStages);
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) as_a(pa[kc], sc, kc);
#pragma unroll
    for (int sp = 0; sp < T::kSpans; ++sp) {
#pragma unroll
      for (int c = 0; c < T::kSpanCols / 8; ++c) {
        o[sp][4 * c + 0] *= a_lo;
        o[sp][4 * c + 1] *= a_lo;
        o[sp][4 * c + 2] *= a_hi;
        o[sp][4 * c + 3] *= a_hi;
      }
    }
  }
  values(n_tiles - 1);
  wgmma_wait<0>();
  fence_acc<D>(o);
  fence_regs(pa);

  float l_lo = sm.l_lo, l_hi = sm.l_hi;
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float sl_lo = l_lo == 0.f ? 1.f : l_lo, sl_hi = l_hi == 0.f ? 1.f : l_hi;
  store_acc<D, OutT>(out + b * lo.b + h * lo.h, lo.n, o, row_lo, row_hi, pr.n_q, t, sl_lo,
                     sl_hi, true);
  if (t == 0) {
    float* lh = lse + (static_cast<long long>(b) * pr.heads + h) * pr.n_q;
    if (row_lo < pr.n_q) lh[row_lo] = sm.m_lo + logf(sl_lo);
    if (row_hi < pr.n_q) lh[row_hi] = sm.m_hi + logf(sl_hi);
  }
}

// ------------------------------------------------------ bf16: K3b dQ kernel

template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + (2 + 2 * kStages) * Tile<D>::kBytes + kStages * kTile + (1 + 2 * kStages) * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do, MapDims dim_q,
                        MapDims dim_k, MapDims dim_v, MapDims dim_do,
                        const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                        const bf16* __restrict__ out, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, Layout ldo, Layout lout,
                        Layout ldq, Problem pr) {
  using T = Tile<D>;
  uint8_t* q_s = aligned_smem();
  uint8_t* do_s = q_s + T::kBytes;
  uint8_t* k_s = do_s + T::kBytes;               // kStages tiles
  uint8_t* v_s = k_s + kStages * T::kBytes;      // kStages tiles
  uint8_t* valid_s = v_s + kStages * T::kBytes;  // kStages x 64 mask bytes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(valid_s + kStages * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_end = pr.skip ? min(pr.n_k, q0 + kTile + pr.off) : pr.n_k;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_k);
      tma_prefetch(&map_v);
      tma_prefetch(&map_do);
      mbar_arrive_expect_tx(q_full, 2 * T::kBytes);
      load_tile<D>(q_s, &map_q, dim_q, q_full, q0, h, b);
      load_tile<D>(do_s, &map_do, dim_do, q_full, q0, h, b);
    }
    const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
      if (valid) {
        for (int j = lane; j < kTile; j += 32) {
          const int key = it * kTile + j;
          valid_s[s * kTile + j] = key < pr.n_k && valid[key];
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + s, 2 * T::kBytes);
        load_tile<D>(k_s + s * T::kBytes, &map_k, dim_k, full + s, it * kTile, h, b);
        load_tile<D>(v_s + s * T::kBytes, &map_v, dim_v, full + s, it * kTile, h, b);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  const int tw = threadIdx.x, warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const long long bh = static_cast<long long>(b) * pr.heads + h;
  const float lse_lo = row_lo < pr.n_q ? lse[bh * pr.n_q + row_lo] : INFINITY;
  const float lse_hi = row_hi < pr.n_q ? lse[bh * pr.n_q + row_hi] : INFINITY;

  // delta = rowsum(do * out) in f32: each thread's columns 16 kc + 2 t (+ 8)
  // of its two rows, summed over the 4 threads of a row; written for the
  // dK/dV kernel
  const bf16* doh = dout + b * ldo.b + h * ldo.h;
  const bf16* oh = out + b * lout.b + h * lout.h;
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = 16 * kc + 2 * t;
    dl_lo += dot_pair(load_pair(doh, ldo.n, row_lo, c, pr.n_q),
                      load_pair(oh, lout.n, row_lo, c, pr.n_q)) +
             dot_pair(load_pair(doh, ldo.n, row_lo, c + 8, pr.n_q),
                      load_pair(oh, lout.n, row_lo, c + 8, pr.n_q));
    dl_hi += dot_pair(load_pair(doh, ldo.n, row_hi, c, pr.n_q),
                      load_pair(oh, lout.n, row_hi, c, pr.n_q)) +
             dot_pair(load_pair(doh, ldo.n, row_hi, c + 8, pr.n_q),
                      load_pair(oh, lout.n, row_hi, c + 8, pr.n_q));
  }
  if constexpr (D % 16 != 0) {  // the last 8 columns (D = 88)
    const int c = D - 8 + 2 * t;
    dl_lo += dot_pair(load_pair(doh, ldo.n, row_lo, c, pr.n_q),
                      load_pair(oh, lout.n, row_lo, c, pr.n_q));
    dl_hi += dot_pair(load_pair(doh, ldo.n, row_hi, c, pr.n_q),
                      load_pair(oh, lout.n, row_hi, c, pr.n_q));
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, m);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, m);
  }
  if (t == 0 && row_lo < pr.n_q) delta[bh * pr.n_q + row_lo] = dl_lo;
  if (t == 0 && row_hi < pr.n_q) delta[bh * pr.n_q + row_hi] = dl_hi;

  const uint64_t q_desc = T::desc(q_s);
  const uint64_t do_desc = T::desc(do_s);
  const bool masked = mask != nullptr;
  Acc<D> acc;
  zero_acc<D>(acc);
  // s = q k^T and dp = do v^T of key tile `it` (issued, not waited for)
  float sc[kTile / 2], dp[kTile / 2];
  auto scores = [&](int it) {
    const int s = it % kStages;
    mbar_wait(full + s, (it / kStages) & 1);
    const uint64_t k_desc = T::desc(k_s + s * T::kBytes);
    const uint64_t v_desc = T::desc(v_s + s * T::kBytes);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < T::kSlices; ++kc)
      Mma<kTile>::ss(sc, desc_add(q_desc, T::slice(kc)), desc_add(k_desc, T::slice(kc)), kc);
#pragma unroll
    for (int kc = 0; kc < T::kSlices; ++kc)
      Mma<kTile>::ss(dp, desc_add(do_desc, T::slice(kc)), desc_add(v_desc, T::slice(kc)), kc);
    wgmma_commit();
  };
  // sc becomes ds = p (dp - delta) scale, p = 2^(s scale log2 e - lse log2 e):
  // zero at every masked score and past the keys (the general tile; the
  // plain one, with nothing hidden, tests nothing)
  const float c2 = pr.scale * kLog2e;
  const float lb_lo = lse_lo * kLog2e, lb_hi = lse_hi * kLog2e;
  const float ds_lo = dl_lo * pr.scale, ds_hi = dl_hi * pr.scale;
  auto grad_scores = [&](int it) {
    const int k0 = it * kTile;
    const uint8_t* valid_t = valid_s + (it % kStages) * kTile;
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float p = ex2(fmaf(sc[4 * c + e], c2, lo ? -lb_lo : -lb_hi));
        sc[4 * c + e] = p * fmaf(dp[4 * c + e], pr.scale, lo ? -ds_lo : -ds_hi);
      }
    }
    if (masked || pr.causal || k0 + kTile > pr.n_k) {
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * c + 2 * t + (e & 1), col = k0 + j;
          const bool vis = col < pr.n_k && (!masked || valid_t[j]) &&
                           !causal_hidden(pr, e < 2 ? row_lo : row_hi, col);
          sc[4 * c + e] = vis ? sc[4 * c + e] : 0.f;
        }
      }
    }
  };
  // dq += ds k of key tile `it` (issued), ds rounded to bf16 (the TPU
  // kernel's ds.astype(k.dtype))
  uint32_t sa[kTile / 16][4];
  auto dq_step = [&](int it) {
    wgmma_fence();
    rs_product<D>(acc, sa, T::desc(k_s + (it % kStages) * T::kBytes));
    wgmma_commit();
  };

  // Two key tiles in flight: while dq += ds k of tile it runs, s and dp of
  // tile it + 1 are computed, then its ds.
  mbar_wait(q_full, 0);
  scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  grad_scores(0);
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) as_a(sa[kc], sc, kc);
  for (int it = 0; it + 1 < n_tiles; ++it) {
    scores(it + 1);
    dq_step(it);
    wgmma_wait<1>();  // s and dp of tile it + 1
    fence_regs(sc);
    fence_regs(dp);
    grad_scores(it + 1);
    wgmma_wait<0>();  // dq += ds k of tile it
    fence_acc<D>(acc);
    fence_regs(sa);
    if (tw == 0) mbar_arrive(empty + it % kStages);
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) as_a(sa[kc], sc, kc);
  }
  dq_step(n_tiles - 1);
  wgmma_wait<0>();
  fence_acc<D>(acc);
  fence_regs(sa);

  store_acc<D>(dq + b * ldq.b + h * ldq.h, ldq.n, acc, row_lo, row_hi, pr.n_q, t);
}

// --------------------------------------------------- bf16: K3b dK/dV kernel

template <int D>
constexpr int dkv_smem_bytes() {
  return 1024 + (2 + 2 * kStages) * Tile<D>::kBytes + kStages * kTile * 12 +
         (1 + 2 * kStages) * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, MapDims dim_q,
                         MapDims dim_k, MapDims dim_v, MapDims dim_do,
                         const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Layout ldk, Layout ldv, Problem pr) {
  using T = Tile<D>;
  uint8_t* k_s = aligned_smem();
  uint8_t* v_s = k_s + T::kBytes;
  uint8_t* q_s = v_s + T::kBytes;             // kStages tiles
  uint8_t* do_s = q_s + kStages * T::kBytes;  // kStages tiles
  // kStages x 64 each: lse log2 e, delta scale, lse
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * T::kBytes);
  float* delta_s = lse_s + kStages * kTile;
  float* lse_n = delta_s + kStages * kTile;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lse_n + kStages * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  // under `skip` a query tile reaches this block's keys when its last row does
  const int i_start = (pr.skip && k0 > pr.off) ? (k0 - pr.off) / kTile : 0;
  const int n_tiles = (pr.n_q + kTile - 1) / kTile - i_start;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const long long bh = static_cast<long long>(b) * pr.heads + h;
  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_k);
      tma_prefetch(&map_v);
      tma_prefetch(&map_do);
      mbar_arrive_expect_tx(kv_full, 2 * T::kBytes);
      load_tile<D>(k_s, &map_k, dim_k, kv_full, k0, h, b);
      load_tile<D>(v_s, &map_v, dim_v, kv_full, k0, h, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages, r0 = (i_start + i) * kTile;
      mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
      for (int j = lane; j < kTile; j += 32) {
        // rows past n_q: p = 0 (lse = +inf), ds = 0
        const int r = r0 + j;
        const float l = r < pr.n_q ? lse[bh * pr.n_q + r] : INFINITY;
        lse_n[s * kTile + j] = l;
        lse_s[s * kTile + j] = l * kLog2e;
        delta_s[s * kTile + j] = r < pr.n_q ? delta[bh * pr.n_q + r] * pr.scale : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + s, 2 * T::kBytes);
        load_tile<D>(q_s + s * T::kBytes, &map_q, dim_q, full + s, r0, h, b);
        load_tile<D>(do_s + s * T::kBytes, &map_do, dim_do, full + s, r0, h, b);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  const int tw = threadIdx.x, warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * pr.n_k : nullptr;
  const bool ok_lo = key_lo < pr.n_k && (!valid || valid[key_lo]);
  const bool ok_hi = key_hi < pr.n_k && (!valid || valid[key_hi]);
  const bool plain = !mask && !pr.causal;
  const uint64_t k_desc = T::desc(k_s);
  const uint64_t v_desc = T::desc(v_s);

  Acc<D> dk_acc, dv_acc;
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);
  // s^T = k q^T and dp^T = v do^T of query tile `i` of the block (issued,
  // not waited for): rows are this block's keys
  float st[kTile / 2], dpt[kTile / 2];
  auto scores = [&](int i) {
    const int s = i % kStages;
    mbar_wait(full + s, (i / kStages) & 1);
    const uint64_t q_desc = T::desc(q_s + s * T::kBytes);
    const uint64_t do_desc = T::desc(do_s + s * T::kBytes);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < T::kSlices; ++kc)
      Mma<kTile>::ss(st, desc_add(k_desc, T::slice(kc)), desc_add(q_desc, T::slice(kc)), kc);
#pragma unroll
    for (int kc = 0; kc < T::kSlices; ++kc)
      Mma<kTile>::ss(dpt, desc_add(v_desc, T::slice(kc)), desc_add(do_desc, T::slice(kc)), kc);
    wgmma_commit();
  };
  // st becomes p^T, dpt becomes ds^T: p = 2^(s scale log2 e - lse log2 e), ds
  // = p (dp - delta) scale, both from the stage's lse log2 e and delta scale
  // of each query; where hidden (the general tile) p = exp(NEG - lse) / N_k,
  // 1 / N_k on a row whose every key is masked and else 0, and ds = 0
  const float c2 = pr.scale * kLog2e;
  auto grad_scores = [&](int i) {
    const int s = i % kStages, r0 = (i_start + i) * kTile;
    const float* lb_t = lse_s + s * kTile;
    const float* ds_t = delta_s + s * kTile;
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
      const float2 lb = *reinterpret_cast<const float2*>(lb_t + 8 * c + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(ds_t + 8 * c + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(st[4 * c + e], c2, -(e & 1 ? lb.y : lb.x)));
        dpt[4 * c + e] = p * fmaf(dpt[4 * c + e], pr.scale, -(e & 1 ? dl.y : dl.x));
        st[4 * c + e] = p;
      }
    }
    if (!plain) {
      const float* lse_t = lse_n + s * kTile;
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * c + 2 * t + (e & 1);  // query in the tile
          const bool vis = (e < 2 ? ok_lo : ok_hi) &&
                           !causal_hidden(pr, r0 + j, e < 2 ? key_lo : key_hi);
          if (!vis) {
            st[4 * c + e] = ex2(((kNeg - lse_t[j]) - pr.log_nk) * kLog2e);
            dpt[4 * c + e] = 0.f;
          }
        }
      }
    }
  };
  // dv += p^T do, dk += ds^T q of query tile `i` (issued), both rounded to
  // the input type first (the TPU kernel's casts)
  uint32_t pa[kTile / 16][4], sa[kTile / 16][4];
  auto dkv_step = [&](int i) {
    const uint64_t q_desc = T::desc(q_s + (i % kStages) * T::kBytes);
    const uint64_t do_desc = T::desc(do_s + (i % kStages) * T::kBytes);
    wgmma_fence();
    if constexpr (T::kSpans == 1) {  // D = 32, 64: the two products interleaved
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        Mma<D>::template rs<1>(dv_acc[0], pa[kc], desc_add(do_desc, kc * T::kSliceRows), 1);
        Mma<D>::template rs<1>(dk_acc[0], sa[kc], desc_add(q_desc, kc * T::kSliceRows), 1);
      }
    } else {
      rs_product<D>(dv_acc, pa, do_desc);
      rs_product<D>(dk_acc, sa, q_desc);
    }
    wgmma_commit();
  };
  auto pack = [&]() {
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      as_a(pa[kc], st, kc);
      as_a(sa[kc], dpt, kc);
    }
  };

  // Two query tiles in flight: while dv and dk of tile i accumulate, s^T and
  // dp^T of tile i + 1 are computed, then its p^T and ds^T.
  mbar_wait(kv_full, 0);
  scores(0);
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  grad_scores(0);
  pack();
  for (int i = 0; i + 1 < n_tiles; ++i) {
    scores(i + 1);
    dkv_step(i);
    wgmma_wait<1>();  // s^T and dp^T of tile i + 1
    fence_regs(st);
    fence_regs(dpt);
    grad_scores(i + 1);
    wgmma_wait<0>();  // dv and dk of tile i
    fence_acc<D>(dv_acc);
    fence_acc<D>(dk_acc);
    fence_regs(pa);
    fence_regs(sa);
    if (tw == 0) mbar_arrive(empty + i % kStages);
    pack();
  }
  dkv_step(n_tiles - 1);
  wgmma_wait<0>();
  fence_acc<D>(dv_acc);
  fence_acc<D>(dk_acc);
  fence_regs(pa);
  fence_regs(sa);

  store_acc<D>(dk + b * ldk.b + h * ldk.h, ldk.n, dk_acc, key_lo, key_hi, pr.n_k, t);
  store_acc<D>(dv + b * ldv.b + h * ldv.h, ldv.n, dv_acc, key_lo, key_hi, pr.n_k, t);
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
  constexpr int kST = scalar_tile<D>();
  __shared__ float k_s[kST][D], v_s[kST][D];
  __shared__ uint8_t valid_s[kST];
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
  for (int k0 = 0; k0 < kv_end; k0 += kST) {
    __syncthreads();
    for (int i = tid; i < kST * D; i += kScalarRows) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < pr.n_k;
      k_s[r][c] = ok ? kh[(k0 + r) * lk.n + c] : 0.f;
      v_s[r][c] = ok ? vh[(k0 + r) * lv.n + c] : 0.f;
    }
    if (tid < kST)
      valid_s[tid] = (!valid || (k0 + tid < pr.n_k && valid[k0 + tid])) ? 1 : 0;
    __syncthreads();
    const int j_end = min(kST, pr.n_k - k0);
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
  constexpr int kST = scalar_tile<D>();
  __shared__ float k_s[kST][D], v_s[kST][D];
  __shared__ float do_s[kScalarRows][D + 1];  // one row a thread, padded
  __shared__ uint8_t valid_s[kST];
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
  for (int k0 = 0; k0 < kv_end; k0 += kST) {
    __syncthreads();
    for (int i = tid; i < kST * D; i += kScalarRows) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < pr.n_k;
      k_s[r][c] = ok ? kh[(k0 + r) * lk.n + c] : 0.f;
      v_s[r][c] = ok ? vh[(k0 + r) * lv.n + c] : 0.f;
    }
    if (tid < kST)
      valid_s[tid] = (!valid || (k0 + tid < pr.n_k && valid[k0 + tid])) ? 1 : 0;
    __syncthreads();
    const int j_end = min(kST, pr.n_k - k0);
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
  constexpr int kST = scalar_tile<D>();
  __shared__ float q_s[kST][D], do_s[kST][D];
  __shared__ float v_s[kScalarRows][D + 1];  // one key's v a thread, padded
  __shared__ float lse_s[kST], delta_s[kST], pm_s[kST];
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
  const int i_start = (pr.skip && k0 > pr.off) ? (k0 - pr.off) / kST * kST : 0;
  for (int i0 = i_start; i0 < pr.n_q; i0 += kST) {
    __syncthreads();
    for (int i = tid; i < kST * D; i += kScalarRows) {
      const int r = i / D, c = i % D;
      const bool in = i0 + r < pr.n_q;
      q_s[r][c] = in ? qh[(i0 + r) * lq.n + c] : 0.f;
      do_s[r][c] = in ? doh[(i0 + r) * ldo.n + c] : 0.f;
    }
    if (tid < kST) {
      const int r = i0 + tid;
      const float l = r < pr.n_q ? lse[bh * pr.n_q + r] : INFINITY;
      lse_s[tid] = l;
      delta_s[tid] = r < pr.n_q ? delta[bh * pr.n_q + r] : 0.f;
      pm_s[tid] = expf((kNeg - l) - pr.log_nk);
    }
    __syncthreads();
    const int i_cnt = min(kST, pr.n_q - i0);
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

// What the last failing call of this thread was doing, for its message.
thread_local const char* g_step = "";

// The tensor map of a (batch, heads, rows, d) bf16 operand at `base`, read
// through its element strides `l` in boxes of 64 rows by `cols` (a tile's
// span: D at D = 32 and 64, 32 at D = 80 and 88, where a box past column d
// lands zeros), swizzled for wgmma (128-byte rows at 64 columns, 64-byte at
// 32). The three outer dims go in order of stride, dims of extent 1 last
// (their stride never read); `dims` says where each went.
cudaError_t make_map(CUtensorMap* map, MapDims* dims, const char* what, const void* base,
                     Layout l, int batch, int heads, int rows, int d, int cols) {
  g_step = what;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  struct Dim {
    int which;  // 0 rows, 1 heads, 2 batch
    long long extent, stride;
  } v[3] = {{0, rows, l.n}, {1, heads, l.h}, {2, batch, l.b}};
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0; --j) {
      const Dim &x = v[j], &y = v[j - 1];
      const bool before = (x.extent > 1) != (y.extent > 1) ? x.extent > 1 : x.stride < y.stride;
      if (!before) break;
      const Dim tmp = v[j];
      v[j] = v[j - 1];
      v[j - 1] = tmp;
    }
  }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(d), 1, 1, 1};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  int slot[3];
  cuuint64_t span = 2ull * d;  // bytes spanned by the dims so far
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = static_cast<cuuint64_t>(v[i].extent);
    gstride[i] = v[i].extent > 1 ? 2ull * static_cast<cuuint64_t>(v[i].stride) : span;
    span = gstride[i] * gdim[i + 1];
    box[i + 1] = v[i].which == 0 ? kTile : 1;
    slot[v[i].which] = i + 1;
  }
  *dims = MapDims{slot[0], slot[1], slot[2]};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // the driver's codes are the runtime's for the errors an encode returns
  return static_cast<cudaError_t>(r);
}

// Binds the calling thread to its current device's primary context. The
// tensor maps are encoded through the driver, which needs a current context,
// and a thread that has made no runtime call yet has none (the autograd
// engine's thread, on a first backward: PyTorch selects a device only when it
// differs from the current one).
cudaError_t bind_context() {
  g_step = "the device's context";
  int device;
  cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? cudaSetDevice(device) : err;
}

// the bf16 forward with output type OutT
template <int D, typename OutT>
cudaError_t launch_fwd_bf16(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                            MapDims dq, MapDims dk, MapDims dv, const uint8_t* mask, void* out,
                            float* lse, Layout lo, int batch, const Problem& pr,
                            cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<D>();
  g_step = "the forward's shared memory";
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  g_step = "the forward's launch";
  const dim3 grid((pr.n_q + kTile - 1) / kTile, pr.heads, batch);
  flash_fwd_kernel<D, OutT><<<grid, kThreads, kSmem, stream>>>(
      mq, mk, mv, dq, dk, dv, mask, static_cast<OutT*>(out), lse, lo, pr);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       void* out, float* lse, const long long* st, int batch, int dtype,
                       int out_f32, const Problem& pr, cudaStream_t stream) {
  if (dtype == 1) {
    CUtensorMap mq, mk, mv;
    MapDims dq, dk, dv;
    cudaError_t err;
    if ((err = bind_context()) ||
        (err = make_map(&mq, &dq, "q's tensor map", q, layout(st, 0), batch, pr.heads, pr.n_q,
                        D, Tile<D>::kSpanCols)) ||
        (err = make_map(&mk, &dk, "k's tensor map", k, layout(st, 1), batch, pr.heads, pr.n_k,
                        D, Tile<D>::kSpanCols)) ||
        (err = make_map(&mv, &dv, "v's tensor map", v, layout(st, 2), batch, pr.heads, pr.n_k,
                        D, Tile<D>::kSpanCols)))
      return err;
    return out_f32 ? launch_fwd_bf16<D, float>(mq, mk, mv, dq, dk, dv, mask, out, lse,
                                               layout(st, 3), batch, pr, stream)
                   : launch_fwd_bf16<D, bf16>(mq, mk, mv, dq, dk, dv, mask, out, lse,
                                              layout(st, 3), batch, pr, stream);
  } else {
    g_step = "the forward's launch";
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
    CUtensorMap mq, mk, mv, mdo;
    MapDims nq, nk, nv, ndo;
    cudaError_t err;
    if ((err = bind_context()) ||
        (err = make_map(&mq, &nq, "q's tensor map", q, layout(st, 0), batch, pr.heads, pr.n_q,
                        D, Tile<D>::kSpanCols)) ||
        (err = make_map(&mk, &nk, "k's tensor map", k, layout(st, 1), batch, pr.heads, pr.n_k,
                        D, Tile<D>::kSpanCols)) ||
        (err = make_map(&mv, &nv, "v's tensor map", v, layout(st, 2), batch, pr.heads, pr.n_k,
                        D, Tile<D>::kSpanCols)) ||
        (err = make_map(&mdo, &ndo, "dout's tensor map", dout, layout(st, 3), batch, pr.heads,
                        pr.n_q, D, Tile<D>::kSpanCols)))
      return err;
    constexpr int kSmemQ = dq_smem_bytes<D>(), kSmemKV = dkv_smem_bytes<D>();
    g_step = "the backward's shared memory";
    if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ)) ||
        (err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV)))
      return err;
    g_step = "the dQ kernel's launch";
    const dim3 grid_q((pr.n_q + kTile - 1) / kTile, pr.heads, batch);
    flash_bwd_dq_kernel<D><<<grid_q, kThreads, kSmemQ, stream>>>(
        mq, mk, mv, mdo, nq, nk, nv, ndo, mask, static_cast<const bf16*>(dout),
        static_cast<const bf16*>(out), lse, delta, static_cast<bf16*>(dq), layout(st, 3),
        layout(st, 4), layout(st, 5), pr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    g_step = "the dK/dV kernel's launch";
    const dim3 grid_kv((pr.n_k + kTile - 1) / kTile, pr.heads, batch);
    flash_bwd_dkv_kernel<D><<<grid_kv, kThreads, kSmemKV, stream>>>(
        mq, mk, mv, mdo, nq, nk, nv, ndo, mask, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), layout(st, 6), layout(st, 7), pr);
  } else {
    g_step = "the dQ kernel's launch";
    const dim3 grid_q((pr.n_q + kScalarRows - 1) / kScalarRows, pr.heads, batch);
    flash_bwd_dq_f32_kernel<D><<<grid_q, kScalarRows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(dout),
        static_cast<const float*>(out), lse, delta, static_cast<float*>(dq), layout(st, 0),
        layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4), layout(st, 5), pr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    g_step = "the dK/dV kernel's launch";
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

// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64, 80, 88 or 128. mask:
// (batch, n_k) bytes, 1 = attend, or null. strides: batch, head and row
// strides in elements of q, k, v, out (12 values; every row 16-byte aligned).
// out_f32: the output is f32 (bf16 inputs; f32 inputs always write f32).
// lse: (batch, heads, n_q) f32. Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success), or that of the tensor
// maps' encoding (bf16).
int mmlearn_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                      void* lse, const long long* strides, int batch, int heads, int n_q,
                      int n_k, int head_dim, int dtype, float scale, int causal, int out_f32,
                      void* stream) {
  const Problem pr = make_problem(heads, n_q, n_k, scale, causal, mask != nullptr);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32: return launch_fwd<32>(q, k, v, m, out, l, strides, batch, dtype, out_f32, pr, s);
    case 64: return launch_fwd<64>(q, k, v, m, out, l, strides, batch, dtype, out_f32, pr, s);
    case 80: return launch_fwd<80>(q, k, v, m, out, l, strides, batch, dtype, out_f32, pr, s);
    case 88: return launch_fwd<88>(q, k, v, m, out, l, strides, batch, dtype, out_f32, pr, s);
    case 128: return launch_fwd<128>(q, k, v, m, out, l, strides, batch, dtype, out_f32, pr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: dq, dk, dv (the inputs' shapes and type) from q, k, v, the
// mask, the cotangent `dout` of the output, the forward's output and lse
// ((batch, heads, n_q) f32). delta: a (batch, heads, n_q) f32 buffer that
// receives rowsum(dout * out). strides: q, k, v, dout, out, dq, dk, dv (24
// values); dq, dk and dv may be views of one buffer. Two launches on
// `stream` (dQ, then dK/dV), no synchronisation; returns the first failing
// launch's cudaError_t.
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
  if (head_dim == 80)
    return launch_bwd<80>(q, k, v, m, dout, out, l, d, dq, dk, dv, strides, batch, dtype, pr,
                          s);
  if (head_dim == 88)
    return launch_bwd<88>(q, k, v, m, dout, out, l, d, dq, dk, dv, strides, batch, dtype, pr,
                          s);
  if (head_dim == 128)
    return launch_bwd<128>(q, k, v, m, dout, out, l, d, dq, dk, dv, strides, batch, dtype, pr,
                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The message of a failed call's error: what this thread was doing, then
// CUDA's name for the error.
const char* mmlearn_flash_error_string(int err) {
  thread_local char text[256];
  snprintf(text, sizeof(text), "%s: %s", g_step,
           cudaGetErrorString(static_cast<cudaError_t>(err)));
  return text;
}

}  // extern "C"
