// Fused short-sequence multi-head attention, forward and backward (kernel
// K1), Hopper sm_90a.
//
// Replaces the TPU kernels of mmlearn_tpu/ops/fused_attention.py:
//   K1f `_fwd_kernel` (:173, launched by `_fwd_pallas` :655);
//   K1b `_bwd_kernel` (:207, launched by `_bwd_pallas` :683).
// Same functions, on the head-major packed projection read in place -- for
// head h, q at column h*3D, k at h*3D+D, v at h*3D+2D, row stride H*3*D --
// writing (B, N, H*D) and, in the backward, dqkv in qkv's packing, with no
// permute before or after:
//   s   = (q . k) * scale in f32; masked and causal-excluded scores take the
//         finite NEG = -0.7 * FLT_MAX (the TPU kernel's `_NEG`), so a row
//         that sees no key averages V over all N keys; keys past N are left
//         out (-inf), never padded;
//   K1f p = softmax(s) over the whole row in f32, rounded to the input type
//       as p / l (the TPU kernel's p.astype(v.dtype)), out = p V summed in
//       f32;
//   K1b p = exp(s - m) / l, dv = p^T dout (p rounded to the input type),
//       dp = dout v^T, ds = p (dp - delta) scale (rounded), dq = ds k,
//       dk = ds^T q, delta = rowsum(dout * out) in f32. ds is zero at every
//       masked score: exact autodiff of the masked softmax, the gradient the
//       JAX package computes off the TPU (its TPU kernel differs only on rows
//       that see no key). Such a row has m = NEG and l = N, so its p is
//       1 / N at every key, masked scores taken at NEG.
//
// What bounds it on the H100. At the paths' lengths the work is small
// against the bytes: a head of the image tower (N = 197, D = 64) is 4 N^2 D
// = 9.9 MFLOP forward against q, k, v read and out written once, about 100
// KB in bf16 -- 99 operations a byte, a third of the 295 at which the
// tensor cores and not the memory would bound it. The forward reads each
// operand once, keeps the scores on the chip and leaves the arithmetic to
// the tensor cores. The backward is bound by something else: p and ds are
// rounded to bf16, and a last-bit difference from the plain version moves
// a rounding (below), so K1b computes them with the plain version's own
// f32 arithmetic, 2 N^2 D FMAs a head on the FP32 pipes (18.3 G FMA for the
// image layer at b256: 0.62 ms at the H100's 29.7 T FMA/s), plus an IEEE
// exp and division a score.
//
// K1f (bf16). One block of 4 warps per (head, sample), grid (H, B):
//   - the head's K and V are copied whole into shared memory once, by
//     cp.async 16-byte copies, rows padded to D + 8 bf16 so ldmatrix is free
//     of bank conflicts and their count to a multiple of 32 with zeros: 2 x
//     224 x 72 x 2 B = 63 KB at N = 197, D = 64, and 216 KB at N = 768,
//     D = 64, the longest that supports_fused admits (allowed with
//     cudaFuncSetAttribute);
//   - each warp takes strips of 16 query rows, round robin, so a ragged
//     length costs at most 31 padded keys and 15 padded rows of work (224
//     keys for 197, 96 for 77 and 84, 128 for 118), not most of a 64-row
//     tile; a warp stages its next strip of Q in shared memory by cp.async
//     while it computes the current one;
//   - both products are mma.sync m16n8k16 (bf16 in, f32 sums) with ldmatrix
//     B operands and the score accumulators packed in registers as P V's A
//     operand, the helpers of attention_tiles.cuh, shared with K3. Keys go
//     in pairs of 16-groups, so a pair's loads and products issue with no
//     check between them;
//   - a warp holds its 16 rows' scores over the whole row in registers (up
//     to 128 or 224 keys, by instance), so the softmax is taken over the
//     whole row as the TPU kernel does and p / l is rounded before P V.
//     Past 224 keys, a first sweep over 64-key chunks takes each row's max
//     and sum (online rescale), and a second recomputes the scores and forms
//     p / l: the same rounding, at 1.5x the score work, off the paths'
//     shapes;
//   - causal with no key mask: a query strip stops at its diagonal (each
//     row still sees key 0, so the skipped keys add exp(NEG - m) = 0). With
//     a key mask nothing is skipped: a row that sees no key averages V over
//     all N.
// K1f is bound by latency: mma.sync with few warps an SM (the whole-row
// scores take 128-168 registers a thread, so 3-4 blocks of 4 warps fit) and
// blocks that load before they compute. wgmma from shared memory, and TMA
// loads overlapped across heads, are later work.
//
// K1b (bf16): two kernels on the stream, nothing accumulated across blocks,
// so dqkv is deterministic (the backward section of k1_arithmetic.cuh says
// how p and ds are taken bit for bit): the first computes p and ds for every (query, key)
// pair, one block of 8 warps per (head, sample), K and V whole in shared
// memory, and writes them in bf16 to (B, H, nq, nq) planes (4 B H nq^2
// bytes of scratch, 0.53 GB at the image layer's b256); the second reads the
// planes back and forms dv = p^T dout and dk = ds^T q over 16-key strips and
// dq = ds k over 16-row strips on mma.sync (q, dout and k transposed in
// shared memory; 8 x 8 transposes of the planes' fragments by movmatrix),
// with the causal diagonal skip of K1f. No statistics pass: the rows' max
// and sum come from the first kernel's own scores, whole rows in registers.
//
// The f32 route is scalar f32 FMAs (tensor cores would round to TF32): 64 x
// 64 tiles, 4 x 4 values a thread; its backward recomputes the rows' max
// and sum in a first sweep of its dQ kernel and passes them, with delta, to
// its dK/dV kernel through an f32 (3, B, H, N) scratch.
//
// Head dims 32, 64, 80 (vit_huge) and 88 (vit_giant). The tensor-core
// routines work on kDp = D rounded up to 16 columns: at D = 88 a head's
// rows in shared memory hold 96, so Q K^T contracts over 6 k16 steps and P V
// and the backward's products make 12 n8 tiles, of which the 11 below D are
// written. The pad columns of Q and K are zeros (zero-filled by cp.async,
// never the next columns of the head-major packing): a contraction needs
// them zero in one operand at least; elsewhere the pad only makes the
// columns past D that are never written. K1b's first kernel needs no
// padding (its f32 chains run over d < D); its row of delta sums columns L,
// L + 32, L + 64 below D a lane, as PyTorch's reduction does. supports_fused
// admits 336 keys at D = 80 (the backward's first kernel then holds K and V
// in bf16 for 352 keys, 126 KB) and 208 at D = 88 (f32, 224 keys, 213 KB).
// The f32 scalar kernels hold D / 16 columns a thread, rounded up (the last
// only below D).
//
// The bf16 kernels' per-strip and per-head work (fwd_strip, ds_head,
// grad_head) lives in k1_arithmetic.cuh, shared with the head-grouped
// K1f-p/K1b-p (csrc/fused_attention_packed.cu), which compute the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "k1_arithmetic.cuh"

namespace {

// ------------------------------------------------- bf16: tensor-core kernels

// Bytes of shared memory for two whole (kv_rows(n), D) bf16 operands in rows
// of kPitch and `extra` bytes a row.
template <int D>
size_t operands_bytes(int n, int extra) {
  return static_cast<size_t>(kv_rows(n)) * (2 * kPitch<D> * sizeof(bf16) + extra);
}

// K1f: one block of 4 warps per (head, sample), each warp a 16-row strip at
// a time (fwd_strip). G: the 16-key groups of scores a warp holds in
// registers; with kOneSweep (N <= 16 G) a strip's whole rows, else chunks of
// G groups in two sweeps. The instances and their register budgets
// (launch_fwd_bf16) were chosen by timing on the H100 at the paths' shapes:
// three blocks an SM where the scores fit 168 registers a thread (14
// groups: the image tower and the I-JEPA teacher; 64-key chunks past 224
// keys), else the compiler's choice. At D = 80 and 88 whole rows of 224 keys
// and the wider accumulators (kDp / 8 tiles) need more than 168 registers,
// so those instances run two blocks an SM.
template <int D, int G, bool kOneSweep>
__global__ void __launch_bounds__(kThreads,
                                  G == 14 && D > 64 ? 2 : (G == 14 || !kOneSweep) ? 3 : 1)
    fused_mha_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         bf16* __restrict__ out, int n, int heads, float scale, int causal) {
  constexpr int kLd = kPitch<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = kv_rows(n);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + rows * kLd;
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(v_s + rows * kLd);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row_stride = 3LL * heads * D;
  const long long o_stride = static_cast<long long>(heads) * D;
  const bf16* head = qkv + static_cast<long long>(b) * n * row_stride + 3LL * h * D;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * n : nullptr;
  // the warp's next query strip, copied while it computes the current one
  bf16* q_stage = reinterpret_cast<bf16*>(valid_s + rows) + warp * 16 * kLd;

  rows_async<D>(k_s, head + D, row_stride, n, tid);
  rows_async<D>(v_s, head + 2 * D, row_stride, n, tid);
  cp_async_commit();
  strip_async<D>(q_stage, head, row_stride, warp * 16, n, lane);
  cp_async_commit();
  for (int i = tid; i < rows; i += kThreads) valid_s[i] = i < n && (!valid || valid[i]);

  FwdStrip<D> st;
  st.k_s = k_s;
  st.valid_s = valid_s;
  st.n = n;
  st.plain = !valid && !causal;
  st.causal = causal;
  st.scale = scale;
  const bool skip = causal && !valid;
  bf16* oh = out + static_cast<long long>(b) * n * o_stride + static_cast<long long>(h) * D;

  cp_async_wait<0>();
  __syncthreads();

  for (int r0 = warp * 16; r0 < n; r0 += kWarps * 16) {
    cp_async_wait<0>();
    __syncwarp();
    strip_a<D>(st.qa, q_stage, lane);
    __syncwarp();  // every lane has read the stage before it is refilled
    if (r0 + kWarps * 16 < n)
      strip_async<D>(q_stage, head, row_stride, r0 + kWarps * 16, n, lane);
    cp_async_commit();
    fwd_strip<D, G, kOneSweep, kLd>(st, v_s, r0, skip, oh, o_stride, lane);
  }
}

// ------------------------------------------------------- K1b (bf16)
//
// Two kernels on the stream, nothing accumulated across blocks (the
// backward section of k1_arithmetic.cuh says how p and ds are taken bit for
// bit): one block per (head, sample) each.

// K1b, second kernel: the products from the planes (grad_head).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    fused_mha_bwd_grad_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                              const bf16* __restrict__ p_s, const bf16* __restrict__ ds_s,
                              bf16* __restrict__ dqkv, int n, int heads, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  grad_head<D>(smem, qkv, dout, p_s, ds_s, dqkv, n, heads, skip, blockIdx.x, blockIdx.y);
}

// K1b, first kernel: p and ds of every (query, key) pair into the planes
// (ds_head). One block of 8 warps per (head, sample) holds the head's K and
// V in shared memory, in f32 (T = float) or, past 224 keys, bf16.
template <int D, int TM, int ITS, typename T>
__global__ void __launch_bounds__(kDsThreads, 1)
    fused_mha_bwd_ds_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                            const bf16* __restrict__ out, const bf16* __restrict__ dout,
                            bf16* __restrict__ p_s, bf16* __restrict__ ds_s, int n, int heads,
                            float scale, int causal) {
  constexpr int kLd = D + 2;
  constexpr int kKeys = 32 * ITS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = round16(n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kKeys * kLd;
  float* strips = reinterpret_cast<float*>(v_s + kKeys * kLd);
  float* qt = strips + warp * 2 * D * TM;
  float* dot = qt + D * TM;
  // each warp's p and ds rows in bf16, copied out as 16-byte chunks (not past
  // 224 keys, where shared memory holds K and V in bf16 and no more)
  constexpr int kStage = sizeof(T) == sizeof(float) ? 2 * TM * kKeys : 0;
  bf16* stage = reinterpret_cast<bf16*>(strips + kDsWarps * 2 * D * TM) + warp * kStage;
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(stage + (kDsWarps - warp) * kStage);

  const long long row_stride = 3LL * heads * D;
  const long long o_stride = static_cast<long long>(heads) * D;
  const bf16* head = qkv + static_cast<long long>(b) * n * row_stride + 3LL * h * D;
  const long long o_off = static_cast<long long>(b) * n * o_stride + static_cast<long long>(h) * D;
  const long long plane = (static_cast<long long>(b) * heads + h) * nq * nq;
  const uint8_t* valid = mask ? mask + static_cast<long long>(b) * n : nullptr;

  load_kv_rows<D, ITS>(k_s, v_s, valid_s, head, row_stride, valid, n, tid);
  __syncthreads();
  ds_head<D, TM, ITS>(k_s, v_s, qt, dot, stage, valid_s, head, out + o_off, dout + o_off,
                      row_stride, o_stride, p_s, ds_s, plane, n, !valid && !causal, causal,
                      scale, warp, lane);
}

template <int D, int G, bool kOneSweep>
cudaError_t launch_fwd_bf16_g(const void* qkv, const void* mask, void* out, int batch, int n,
                              int heads, float scale, int causal, cudaStream_t stream) {
  // K, V and the key flags, and each warp's staged query strip
  const size_t smem = operands_bytes<D>(n, 1) + kWarps * 16 * kPitch<D> * sizeof(bf16);
  cudaError_t err = allow_smem(fused_mha_fwd_kernel<D, G, kOneSweep>, smem);
  if (err != cudaSuccess) return err;
  fused_mha_fwd_kernel<D, G, kOneSweep><<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      n, heads, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_bf16(const void* qkv, const void* mask, void* out, int batch,
                            int n, int heads, float scale, int causal, cudaStream_t stream) {
  const int groups = kv_rows(n) / 16;
#define K1F_LAUNCH(G, ONE) \
  launch_fwd_bf16_g<D, G, ONE>(qkv, mask, out, batch, n, heads, scale, causal, stream)
  if (groups <= 8) return K1F_LAUNCH(8, true);      // text, I-JEPA student and predictor
  if (groups <= 14) return K1F_LAUNCH(14, true);    // image (197), I-JEPA teacher (196)
  return K1F_LAUNCH(4, false);                      // past 224 keys: two sweeps
#undef K1F_LAUNCH
}

template <int D, int TM, int ITS, typename T>
cudaError_t launch_bwd_ds(const void* qkv, const void* mask, const void* out, const void* dout,
                          bf16* p_s, bf16* ds_s, int batch, int n, int heads, float scale,
                          int causal, cudaStream_t stream) {
  constexpr size_t smem = ds_smem_bytes<D, TM, ITS, T>();
  cudaError_t err = allow_smem(fused_mha_bwd_ds_kernel<D, TM, ITS, T>, smem);
  if (err != cudaSuccess) return err;
  fused_mha_bwd_ds_kernel<D, TM, ITS, T><<<dim3(heads, batch), kDsThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), p_s, ds_s, n, heads, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const void* qkv, const void* mask, const void* out,
                            const void* dout, void* dqkv, void* scratch, int batch, int n,
                            int heads, float scale, int causal, cudaStream_t stream) {
  const int nq = round16(n);
  bf16* p_s = static_cast<bf16*>(scratch);
  bf16* ds_s = p_s + static_cast<long long>(batch) * heads * nq * nq;
  // the first kernel's instances: a lane's keys in registers, ITS of them (up
  // to 128, 224 and 768 keys), for 4 rows at a time with K and V in f32,
  // past 224 keys 2 rows with K and V in bf16. At D = 80 past 224 keys, 352
  // (supports_fused admits 336 there; 768 keys of D + 2 bf16 would not fit
  // 227 KB); at D = 88 it admits 208.
  constexpr int kLongIts = D <= 64 ? 24 : 11;
#define K1B_DS(TM, ITS, T)                                                                  \
  launch_bwd_ds<D, TM, ITS, T>(qkv, mask, out, dout, p_s, ds_s, batch, n, heads, scale, \
                               causal, stream)
  if (n > 32 * kLongIts) return cudaErrorInvalidValue;
  cudaError_t err = n <= 128 ? K1B_DS(4, 4, float) : n <= 224 ? K1B_DS(4, 7, float)
                                                              : K1B_DS(2, kLongIts, bf16);
#undef K1B_DS
  if (err != cudaSuccess) return err;
  // then the products, from the planes: q and dout (then k) transposed
  const size_t smem = grad_smem_bytes<D>(n);
  err = allow_smem(fused_mha_bwd_grad_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  fused_mha_bwd_grad_kernel<D><<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), p_s, ds_s,
      static_cast<bf16*>(dqkv), n, heads, causal && !mask);
  return cudaGetLastError();
}

// ------------------------------------------------------- f32: scalar kernels

constexpr int kBlockQ = 64;          // query rows per thread block
constexpr int kBlockK = 64;          // keys per shared-memory tile
constexpr int kScalarThreads = 256;  // 16 row groups x 16 column groups
constexpr int kLdP = kBlockK + 1;

// Output columns a thread of the scalar kernels holds, tx + 16 c: D / 16
// rounded up; at D = 88 the last one exists for tx < 8 only (col_in).
template <int D>
constexpr int kScalarCols = (D + 15) / 16;
template <int D>
__device__ __forceinline__ bool col_in(int tx, int c) {
  return D % 16 == 0 || tx + 16 * c < D;
}

template <int D>
constexpr size_t smem_bytes() {
  // q and k tiles padded to D + 1 floats a row (no bank conflicts when 16
  // threads read 16 rows at one column), v unpadded, p padded.
  return sizeof(float) *
         (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kLdP);
}

template <int D>
__global__ void __launch_bounds__(kScalarThreads)
    fused_mha_fwd_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                             float* __restrict__ out, int n,
                             int num_heads, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kCols = kScalarCols<D>;  // output columns per thread
  extern __shared__ float smem_f[];
  float* q_s = smem_f;
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
  const float* head = qkv + static_cast<int64_t>(b) * n * row_stride +
                      static_cast<int64_t>(h) * 3 * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;

  for (int i = tid; i < kBlockQ * D; i += kScalarThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    q_s[r * kLd + c] = row < n ? head[row * row_stride + c] : 0.f;
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
    for (int i = tid; i < kBlockK * D; i += kScalarThreads) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (row < n) {
        const float* src = head + row * row_stride;
        kv = src[D + c];
        vv = src[2 * D + c];
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
        p_s[(4 * ty + i) * kLdP + tx + 16 * j] = p;
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
      for (int c = 0; c < kCols; ++c) vv[c] = col_in<D>(tx, c) ? v_s[kk * D + tx + 16 * c] : 0.f;
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
    float* dst = out + (static_cast<int64_t>(b) * n + qrow) * num_heads * D +
                 static_cast<int64_t>(h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (col_in<D>(tx, c)) dst[tx + 16 * c] = acc[i][c] / l_run[i];
  }
}

// rows row0 .. row0 + 63 of a (n, D) slice with row stride `stride` into a
// tile padded to D + 1 floats a row; rows past n read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t stride,
                                          int row0, int n, int tid) {
  for (int i = tid; i < 64 * D; i += kScalarThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < n ? src[row * stride + c] : 0.f;
  }
}

// acc[i][j] = sum_d a[4 ty + i][d] * b[tx + 16 j][d] over two padded tiles,
// in the order of d (the same sums in both kernels, and in the forward)
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float acc[4][4]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool score_masked(const uint8_t* key_valid, int causal,
                                             int qrow, int kcol) {
  return (key_valid && !key_valid[kcol]) || (causal && kcol > qrow);
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t bwd_dq_smem_bytes() {
  // q, dout, k and v tiles padded to D + 1 floats a row, and the ds tile
  return sizeof(float) * (4 * 64 * (D + 1) + kBlockQ * kLdP);
}

template <int D>
constexpr size_t bwd_dkv_smem_bytes() {
  // k, v, q and dout tiles, the p^T and ds^T tiles, the query rows' m, l, delta
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * kBlockK * kLdP + 3 * kBlockQ);
}

// dQ: one block per (sample, head, 64-row query tile). A first sweep over
// the key tiles recomputes the row max m and sum l with the forward's online
// loop; delta = sum(dout * out). The block writes m, l and delta of its rows
// to the (3, B, H, N) scratch, then sweeps the key tiles again: s, p = exp(s
// - m) / l, dp = dout V^T, ds, and dQ += ds K.
template <int D>
__global__ void __launch_bounds__(kScalarThreads)
    fused_mha_bwd_dq_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                                const float* __restrict__ out, const float* __restrict__ dout,
                                float* __restrict__ dqkv, float* __restrict__ stats, int n,
                                int num_heads, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kCols = kScalarCols<D>;
  extern __shared__ float smem_f[];
  float* q_s = smem_f;
  float* do_s = q_s + kBlockQ * kLd;
  float* k_s = do_s + kBlockQ * kLd;
  float* v_s = k_s + kBlockK * kLd;
  float* ds_s = v_s + kBlockK * kLd;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int64_t row_stride = static_cast<int64_t>(num_heads) * 3 * D;
  const int64_t o_stride = static_cast<int64_t>(num_heads) * D;
  const float* head = qkv + static_cast<int64_t>(b) * n * row_stride +
                      static_cast<int64_t>(h) * 3 * D;
  const int64_t o_off = static_cast<int64_t>(b) * n * o_stride + static_cast<int64_t>(h) * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;

  load_tile<D>(q_s, head, row_stride, q0, n, tid);
  load_tile<D>(do_s, dout + o_off, o_stride, q0, n, tid);
  __syncthreads();

  // delta = sum(dout * out) over the head dim, f32
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + 4 * ty + i;
    float part = 0.f;
    if (qrow < n) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (col_in<D>(tx, c))
          part += do_s[(4 * ty + i) * kLd + tx + 16 * c] *
                  out[o_off + qrow * o_stride + tx + 16 * c];
    }
    delta[i] = half_warp_sum(part);
  }

  // sweep 1: the rows' softmax statistics, by the forward's online loop
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  const int kv_end = (causal && !key_valid) ? min(n, q0 + kBlockQ) : n;
  float s[4][4];
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();
    load_tile<D>(k_s, head + D, row_stride, k0, n, tid);
    __syncthreads();
    tile_dot<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + 4 * ty + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kcol = k0 + tx + 16 * j;
        float v = -INFINITY;
        if (kcol < n) v = score_masked(key_valid, causal, qrow, kcol) ? kNeg : s[i][j] * scale;
        s[i][j] = v;
        row_max = fmaxf(row_max, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_run[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) row_sum += expf(s[i][j] - m_new);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + half_warp_sum(row_sum);
      m_run[i] = m_new;
    }
  }

  // the dK/dV kernel reads the statistics of every query row
  const int64_t plane = static_cast<int64_t>(gridDim.z) * num_heads * n;
  const int64_t row_base = (static_cast<int64_t>(b) * num_heads + h) * n;
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + 4 * ty + i;
      if (qrow < n) {
        stats[row_base + qrow] = m_run[i];
        stats[plane + row_base + qrow] = l_run[i];
        stats[2 * plane + row_base + qrow] = delta[i];
      }
    }
  }

  // sweep 2: ds, then dQ += ds K
  float dq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;
  float dp[4][4];
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's k_s / v_s / ds_s are consumed
    load_tile<D>(k_s, head + D, row_stride, k0, n, tid);
    load_tile<D>(v_s, head + 2 * D, row_stride, k0, n, tid);
    __syncthreads();
    tile_dot<D>(q_s, k_s, ty, tx, s);
    tile_dot<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kcol = k0 + tx + 16 * j;
        float ds = 0.f;
        if (kcol < n && !score_masked(key_valid, causal, qrow, kcol)) {
          const float p = expf(s[i][j] * scale - m_run[i]) / l_run[i];
          ds = p * (dp[i][j] - delta[i]) * scale;
        }
        ds_s[(4 * ty + i) * kLdP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(4 * ty + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = col_in<D>(tx, c) ? k_s[kk * kLd + tx + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + 4 * ty + i;
    if (qrow >= n) continue;
    float* dst = dqkv + static_cast<int64_t>(b) * n * row_stride + qrow * row_stride +
                 static_cast<int64_t>(h) * 3 * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (col_in<D>(tx, c)) dst[tx + 16 * c] = dq[i][c];
  }
}

// dK/dV: one block per (sample, head, 64-key tile), looping over the query
// tiles: s^T and dp^T from the tiles, p and ds from the scratch statistics,
// dV += p^T dout and dK += ds^T Q.
template <int D>
__global__ void __launch_bounds__(kScalarThreads)
    fused_mha_bwd_dkv_f32_kernel(const float* __restrict__ qkv,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ dout, float* __restrict__ dqkv,
                                 const float* __restrict__ stats, int n, int num_heads,
                                 float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kCols = kScalarCols<D>;
  extern __shared__ float smem_f[];
  float* k_s = smem_f;
  float* v_s = k_s + kBlockK * kLd;
  float* q_s = v_s + kBlockK * kLd;
  float* do_s = q_s + kBlockQ * kLd;
  float* pt_s = do_s + kBlockQ * kLd;
  float* dst_s = pt_s + kBlockK * kLdP;
  float* m_s = dst_s + kBlockK * kLdP;
  float* l_s = m_s + kBlockQ;
  float* d_s = l_s + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // query columns tx + 16 j; output columns tx + 16 c
  const int ty = tid >> 4;  // key rows 4 ty .. 4 ty + 3

  const int64_t row_stride = static_cast<int64_t>(num_heads) * 3 * D;
  const int64_t o_stride = static_cast<int64_t>(num_heads) * D;
  const float* head = qkv + static_cast<int64_t>(b) * n * row_stride +
                      static_cast<int64_t>(h) * 3 * D;
  const float* do_head =
      dout + static_cast<int64_t>(b) * n * o_stride + static_cast<int64_t>(h) * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * num_heads * n;
  const int64_t row_base = (static_cast<int64_t>(b) * num_heads + h) * n;

  load_tile<D>(k_s, head + D, row_stride, k0, n, tid);
  load_tile<D>(v_s, head + 2 * D, row_stride, k0, n, tid);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal with no key mask: a query tile wholly before this key tile sees
  // none of its keys (with a key mask, a row whose keys are all masked
  // spreads p = 1/N over every key, so no tile is skipped)
  const int q_begin = (causal && !key_valid) ? k0 : 0;
  float st[4][4], dpt[4][4];
  for (int q0 = q_begin; q0 < n; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's q_s / do_s / pt_s / dst_s are consumed
    load_tile<D>(q_s, head, row_stride, q0, n, tid);
    load_tile<D>(do_s, do_head, o_stride, q0, n, tid);
    if (tid < kBlockQ) {
      const int qrow = q0 + tid;
      const bool live = qrow < n;
      m_s[tid] = live ? stats[row_base + qrow] : 0.f;
      l_s[tid] = live ? stats[plane + row_base + qrow] : 1.f;
      d_s[tid] = live ? stats[2 * plane + row_base + qrow] : 0.f;
    }
    __syncthreads();
    tile_dot<D>(k_s, q_s, ty, tx, st);
    tile_dot<D>(v_s, do_s, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kcol = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j;
        const int qrow = q0 + qj;
        float p = 0.f, ds = 0.f;
        if (kcol < n && qrow < n) {
          const bool masked = score_masked(key_valid, causal, qrow, kcol);
          const float v = masked ? kNeg : st[i][j] * scale;
          p = expf(v - m_s[qj]) / l_s[qj];
          if (!masked) ds = p * (dpt[i][j] - d_s[qj]) * scale;
        }
        pt_s[(4 * ty + i) * kLdP + qj] = p;
        dst_s[(4 * ty + i) * kLdP + qj] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float pv[4], dsv[4], dov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt_s[(4 * ty + i) * kLdP + qq];
        dsv[i] = dst_s[(4 * ty + i) * kLdP + qq];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = col_in<D>(tx, c) ? do_s[qq * kLd + tx + 16 * c] : 0.f;
        qv[c] = col_in<D>(tx, c) ? q_s[qq * kLd + tx + 16 * c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = k0 + 4 * ty + i;
    if (krow >= n) continue;
    float* dst = dqkv + static_cast<int64_t>(b) * n * row_stride + krow * row_stride +
                 static_cast<int64_t>(h) * 3 * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (!col_in<D>(tx, c)) continue;
      dst[D + tx + 16 * c] = dk[i][c];
      dst[2 * D + tx + 16 * c] = dv[i][c];
    }
  }
}

template <int D>
cudaError_t launch_fwd_f32(const void* qkv, const void* mask, void* out, int batch,
                           int n, int num_heads, float scale, int causal,
                           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem(fused_mha_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, num_heads, batch);
  fused_mha_fwd_f32_kernel<D><<<grid, kScalarThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), n, num_heads, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const void* qkv, const void* mask, const void* out,
                           const void* dout, void* dqkv, void* stats, int batch, int n,
                           int num_heads, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem_dq = bwd_dq_smem_bytes<D>();
  constexpr size_t smem_dkv = bwd_dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(fused_mha_bwd_dq_f32_kernel<D>, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(fused_mha_bwd_dkv_f32_kernel<D>, smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, num_heads, batch);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  fused_mha_bwd_dq_f32_kernel<D><<<grid, kScalarThreads, smem_dq, stream>>>(
      static_cast<const float*>(qkv), m, static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<float*>(dqkv), static_cast<float*>(stats),
      n, num_heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_mha_bwd_dkv_f32_kernel<D><<<grid, kScalarThreads, smem_dkv, stream>>>(
      static_cast<const float*>(qkv), m, static_cast<const float*>(dout),
      static_cast<float*>(dqkv), static_cast<const float*>(stats), n, num_heads, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64, 80 or 88. mask: (batch, n)
// bytes, 1 = attend, or null. bf16 needs qkv 16-byte aligned. Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).
int mmlearn_fused_mha_fwd(const void* qkv, const void* mask, void* out, int batch, int n,
                          int num_heads, int head_dim, int dtype, float scale, int causal,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1F_HEAD_DIM(D)                                                                  \
  if (head_dim == D)                                                                     \
    return dtype == 0 ? launch_fwd_f32<D>(qkv, mask, out, batch, n, num_heads, scale, causal, s) \
         : dtype == 1 ? launch_fwd_bf16<D>(qkv, mask, out, batch, n, num_heads, scale, causal, s) \
                      : cudaErrorInvalidValue;
  K1F_HEAD_DIM(32)
  K1F_HEAD_DIM(64)
  K1F_HEAD_DIM(80)
  K1F_HEAD_DIM(88)
#undef K1F_HEAD_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: dqkv (same shape, type and packing as qkv) from qkv, the
// forward's output `out`, the cotangent `dout` (batch, n, heads * head_dim)
// and the mask. `scratch`: in bf16, 2 * batch * heads * nq * nq bf16 (nq =
// n rounded up to 16: p and ds, query-major; qkv and dout 16-byte aligned),
// in f32, 3 * batch * heads * n floats (max, sum, delta). Two launches on
// `stream`, no synchronisation; returns the first failing launch's
// cudaError_t (0 on success).
int mmlearn_fused_mha_bwd(const void* qkv, const void* mask, const void* out,
                          const void* dout, void* dqkv, void* scratch, int batch, int n,
                          int num_heads, int head_dim, int dtype, float scale, int causal,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1B_HEAD_DIM(D)                                                                        \
  if (head_dim == D)                                                                           \
    return dtype == 0   ? launch_bwd_f32<D>(qkv, mask, out, dout, dqkv, scratch, batch, n,      \
                                            num_heads, scale, causal, s)                       \
           : dtype == 1 ? launch_bwd_bf16<D>(qkv, mask, out, dout, dqkv, scratch, batch, n,     \
                                             num_heads, scale, causal, s)                      \
                        : cudaErrorInvalidValue;
  K1B_HEAD_DIM(32)
  K1B_HEAD_DIM(64)
  K1B_HEAD_DIM(80)
  K1B_HEAD_DIM(88)
#undef K1B_HEAD_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mmlearn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
