// Head-grouped fused attention for small head dims, forward and backward
// (K1f-p / K1b-p), Hopper sm_90a.
//
// Replaces the TPU kernels mmlearn_tpu/ops/fused_attention.py
// `_fwd_kernel_packed` (:425) and `_bwd_kernel_packed` (:448), launched by
// `_fwd_pallas` :655 and `_bwd_pallas` :683 when `_packed_enabled` (:298).
// Same function as K1 (csrc/fused_attention.cu): exact softmax attention
// over a short sequence on the head-major packed projection, masked and
// causal-excluded scores at the finite NEG = -0.7 * FLT_MAX, and K1's
// backward. In bf16 it is K1's arithmetic as well, the routines of
// k1_arithmetic.cuh, so its output and dqkv equal K1's bit for bit; only
// the data movement differs.
//
// What the TPU kernel does, and what this one does instead. The TPU body
// handles all P = 128 / D heads of a sample in one program and lays K and V
// out block-diagonally, (P * N, 128), so one 128-deep, 128-wide matmul gives
// every head's scores; the cross-head blocks are structural zeros, and dK/dV
// pay P times the MACs. That fills the TPU's 128 x 128 matrix unit and has no
// use here: the block-diagonal layout is not carried over, no zero is
// multiplied and no head enters another head's sums.
//
// What the head group is for on the H100. Head-major, one head group's P *
// 3 * D slab of a token is contiguous (384 values, 768 bytes in bf16, at D =
// 32 and 64), and within it a head's k and v are 2 D contiguous values, so a
// head's K and V rows are one 128- or 256-byte copy a token. The blocks are
// persistent, each over a share of the (sample, head group) units, so the
// next head's K and V load while the current head computes, within a group
// and from one unit to the next: K1's blocks load their head before they
// compute.
//   - K1f-p (packed_fwd_kernel): a ring of `stages` head buffers in shared
//     memory (as many as fit the 227 KB a block may use, up to 8), each
//     filled by one warp's 16-byte cp.async copies that complete an
//     mbarrier; 12 or 16 warps (8 past 224 keys) claim (head, 16-row strip)
//     items in order from one stream, so a ragged length leaves no warp idle
//     at a head's end, and run K1f's strip on the ring buffer; the warp that
//     finishes a head's last strip refills its buffer with the head `stages`
//     later. Past 384 keys at D = 64 one head fills the ring: no overlap, as
//     K1f.
//   - K1b-p (packed_bwd_ds_kernel, packed_bwd_grad_kernel): K1b's two
//     kernels. The first, p and ds into the (2, B, H, nq, nq) bf16 planes,
//     keeps the current head's K and V in f32 (K1b's layout) and, below 225
//     keys, copies the next head's rows by cp.async into a bf16 buffer while
//     the current head computes (two f32 heads do not fit: 118 KB each at N
//     = 196, D = 64); the second, the products from the planes, is K1b's
//     second kernel, one block per (head, sample).
// Bound: the bytes are K1's at the same shape; the forward is bound by
// mma.sync latency with 12-16 warps an SM, as K1f (its strip runs longer in
// this loop than in K1f's: tools/k1p_strip_cycles.py), the backward by the
// FP32 FMA chains of its first kernel, as K1b (fused_attention.cu says why).
//
// The f32 route is scalar f32 FMAs (tensor cores would round to TF32), PR
// 3's design: one block per (sample, head group, tile of rows) loads each
// token's slab with 16-byte vector loads for all P heads and computes each
// head's online softmax and products in turn from shared memory; its
// backward recomputes each row's max and sum in a dQ kernel and passes them
// with delta to a dK/dV kernel through an f32 (3, B, H, N) scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "k1_arithmetic.cuh"

namespace {

// ------------------------------------------------- bf16: K1's arithmetic

constexpr int kMaxStages = 8;  // buffers of the forward's ring of heads
// cycles a warp waits on a ring slot before it stops the kernel (about ten
// seconds): a fault shows as a failed launch, never as a hung card
constexpr long long kSpinLimit = 1LL << 34;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// one arrival on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}
// whether the phase of bar with this parity has completed (or the one two
// before it: the caller tells them apart)
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// A block's share of the (sample, head group) units of a persistent grid:
// units blockIdx.x, blockIdx.x + gridDim.x, ..., each P heads, taken as
// slots 0, 1, ... (slot j: head j % P of the block's unit j / P).
struct Slots {
  int groups, count;
  __device__ Slots(int batch, int heads, int P) : groups(heads / P) {
    const long long units = static_cast<long long>(batch) * groups;
    count = blockIdx.x < units ? static_cast<int>((units - 1 - blockIdx.x) / gridDim.x + 1) * P
                               : 0;
  }
  // the sample and the head of slot j
  __device__ void head_of(int j, int P, int& b, int& h) const {
    const long long u = blockIdx.x + static_cast<long long>(j / P) * gridDim.x;
    b = static_cast<int>(u / groups);
    h = static_cast<int>(u % groups) * P + j % P;
  }
};

// Bytes of one slot of the forward's ring at length n: kv_rows(n) rows of
// [k | v | 8 pad] bf16, a pitch of 2 D + 8 (272 or 144 bytes, an odd number
// of 16-byte chunks, so the 8 rows an ldmatrix reads lie in distinct banks),
// then the sample's key flags.
template <int D>
__host__ __device__ __forceinline__ int slot_bytes(int n) {
  return kv_rows(n) * (2 * (2 * D + 8) + 1);
}
// The rest of the forward's shared memory: each warp's staged query strip,
// then each ring buffer's barrier, strip counter and slot tag, and the
// block's item counter.
template <int D, int W>
constexpr int fwd_fixed_bytes() {
  return W * 16 * (D + 8) * static_cast<int>(sizeof(bf16)) + kMaxStages * (8 + 4 + 4) + 16;
}

// K1f-p. A persistent block of W warps over the (sample, head group) units
// of its share; the heads of its units are slots of a ring of `stages`
// buffers in shared memory. Slot j's K and V rows (k and v of a head are
// contiguous in a token, 2 D values) come by one warp's 16-byte cp.async
// copies into ring buffer j % stages, with the sample's key flags, and
// complete its barrier (each lane arrives once for its flags and once when
// its copies land: 64 arrivals). The
// block's work is one stream of (slot, 16-row strip) items: each warp
// stages its next strip's Q by cp.async,
// waits for its slot's barrier, and runs K1f's fwd_strip on the ring
// buffer. Each finished strip counts on its buffer; the warp that finishes
// a slot's last strip refills the buffer with slot j + stages, so the next
// heads' K and V arrive while the current ones compute, across heads and
// across units. Warps claim items in order from a counter, not by a fixed
// stride: a warp that refilled a buffer takes fewer, so the items in flight
// stay within about one slot (with a fixed stride that warp fell behind and
// held every other warp at the ring). No block-wide barrier after the start.
template <int D, int G, bool kOneSweep, int W>
__global__ void __launch_bounds__(32 * W, 1)
    packed_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                      bf16* __restrict__ out, int batch, int n, int heads, float scale,
                      int causal, int stages) {
  constexpr int P = 128 / D;
  constexpr int kLdS = 2 * D + 8;  // a ring row: [k | v | 8 pad]
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = kv_rows(n);
  const int slot_size = slot_bytes<D>(n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* q_stage = reinterpret_cast<bf16*>(smem + stages * slot_size) + warp * 16 * (D + 8);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + stages * slot_size + W * 16 * (D + 8) * sizeof(bf16));
  int* done = reinterpret_cast<int*>(full + kMaxStages);
  int* tag = done + kMaxStages;  // the slot a buffer was last loaded with
  int* claims = tag + kMaxStages;  // items claimed so far

  const Slots slots(batch, heads, P);
  const int strips = (n + 15) >> 4;
  const int items = slots.count * strips;
  const long long row_stride = 3LL * heads * D;
  const long long o_stride = static_cast<long long>(heads) * D;
  auto buffer = [&](int j) { return smem + (j % stages) * slot_size; };

  // until slot j is in its buffer. A buffer's barrier completes once a
  // load; a warp may reach slot j while the buffer's load before it (slot j
  // - stages) is still on its way, and the parity of that phase is j's. So
  // the slot's tag, written before the load's arrivals, confirms it (the
  // load of j is issued only after every strip of j - stages, so the tag
  // reads j only once that phase has completed). A fault stops the kernel
  // after about ten seconds instead of hanging the card.
  auto wait_slot = [&](int j) {
    const long long start = clock64();
    while (!(mbar_try_wait(full + j % stages, (j / stages) & 1) &&
             *reinterpret_cast<volatile int*>(tag + j % stages) == j)) {
      if (clock64() - start > kSpinLimit) __trap();
    }
  };

  // warp-wide: slot j's K and V rows and its sample's key flags into ring
  // buffer j % stages, the copies committed as a group of their own; its
  // barrier completes when all have landed
  auto load_slot = [&](int j) {
    int b, h;
    slots.head_of(j, P, b, h);
    bf16* dst = reinterpret_cast<bf16*>(buffer(j));
    uint8_t* valid_s = reinterpret_cast<uint8_t*>(dst + rows * kLdS);
    const uint8_t* valid = mask ? mask + static_cast<long long>(b) * n : nullptr;
    uint64_t* bar = full + j % stages;
    const bf16* src = qkv + static_cast<long long>(b) * n * row_stride + 3LL * h * D + D;
    constexpr int kChunks = D / 4;  // 16-byte chunks of a row's [k | v]
    for (int i = lane; i < n * kChunks; i += 32) {
      const int r = i / kChunks, c = 8 * (i % kChunks);
      cp_async16(dst + r * kLdS + c, src + r * row_stride + c, 16);
    }
    cp_async_arrive(bar);
    cp_async_commit();
    for (int i = lane; i < rows; i += 32) valid_s[i] = i < n && (!valid || valid[i]);
    if (lane == 0) tag[j % stages] = j;
    mbar_arrive(bar);  // releases the flags and the tag to the waiting warps
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 64);
      done[s] = 0;
      tag[s] = -1;
    }
    *claims = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows n .. rows - 1 of every buffer stay zero: the copies fill rows < n
  const int pad_chunks = (rows - n) * (kLdS / 8);
  for (int i = tid; i < stages * pad_chunks; i += 32 * W) {
    const int s = i / pad_chunks, c = i % pad_chunks;
    *reinterpret_cast<uint4*>(smem + s * slot_size + (n * kLdS + 8 * c) * sizeof(bf16)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  FwdStrip<D> st;
  st.n = n;
  st.plain = !mask && !causal;
  st.causal = causal;
  st.scale = scale;
  const bool skip = causal && !mask;
  // start copying the Q strip of item i into the warp's stage
  auto stage_q = [&](int i) {
    int b, h;
    slots.head_of(i / strips, P, b, h);
    const bf16* q = qkv + static_cast<long long>(b) * n * row_stride + 3LL * h * D;
    strip_async<D>(q_stage, q, row_stride, (i % strips) * 16, n, lane);
  };
  auto claim = [&]() {
    int i = 0;
    if (lane == 0) i = atomicAdd(claims, 1);
    return __shfl_sync(0xffffffffu, i, 0);
  };
  int i = claim();
  if (i < items) stage_q(i);
  cp_async_commit();
  // the first slots' K and V, a warp each. After each strip's Q a warp
  // commits one more group, its copies of a slot's K and V or an empty one,
  // so that its next wait leaves a refill in flight
  if (warp < stages && warp < slots.count) {
    load_slot(warp);
  } else {
    cp_async_commit();
  }
  while (i < items) {
    const int j = i / strips, r0 = (i % strips) * 16;
    int b, h;
    slots.head_of(j, P, b, h);
    wait_slot(j);
    cp_async_wait<1>();  // all but the group committed after this strip's Q
    __syncwarp();
    strip_a<D>(st.qa, q_stage, lane);
    __syncwarp();  // every lane has read the stage before it is refilled
    const int next = claim();
    if (next < items) stage_q(next);
    cp_async_commit();
    const unsigned char* buf = buffer(j);
    st.k_s = reinterpret_cast<const bf16*>(buf);
    st.valid_s = buf + rows * kLdS * sizeof(bf16);
    fwd_strip<D, G, kOneSweep, kLdS>(st, st.k_s + D, r0, skip,
                                     out + static_cast<long long>(b) * n * o_stride +
                                         static_cast<long long>(h) * D,
                                     o_stride, lane);
    // the strip is done with the buffer (its reads fed the output stores
    // above, and a warp's shared-memory accesses complete in order); the
    // slot's last strip refills it
    __syncwarp();
    int last = 0;
    if (lane == 0) last = (atomicAdd(done + j % stages, 1) + 1) % strips == 0;
    if (__shfl_sync(0xffffffffu, last, 0) && j + stages < slots.count) {
      load_slot(j + stages);
    } else {
      cp_async_commit();  // an empty group in its place
    }
    i = next;
  }
}

// K1b-p, first kernel: K1b's p and ds (ds_head) for every head of the
// block's units. A persistent block of 8 warps takes the heads of its share
// one at a time, as K1b's block takes its one head, with K and V in f32 in
// K1b's layout; below 225 keys the next head's [k | v] rows are copied by
// cp.async into a bf16 buffer while the current head computes, then widened
// (exactly) into the f32 rows at the switch. Past 224 keys K and V are kept
// in bf16, as K1b keeps them, and there is no room for a second head: each
// head's rows are loaded before it computes.
template <int D, int TM, int ITS, typename T>
__global__ void __launch_bounds__(kDsThreads, 1)
    packed_bwd_ds_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const bf16* __restrict__ out, const bf16* __restrict__ dout,
                         bf16* __restrict__ p_s, bf16* __restrict__ ds_s, int batch, int n,
                         int heads, float scale, int causal) {
  constexpr int P = 128 / D;
  constexpr int kLd = D + 2;
  constexpr int kKeys = 32 * ITS;
  constexpr bool kPrefetch = sizeof(T) == sizeof(float);
  constexpr int kStage = kPrefetch ? 2 * TM * kKeys : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kKeys * kLd;
  float* strips = reinterpret_cast<float*>(v_s + kKeys * kLd);
  float* qt = strips + warp * 2 * D * TM;
  float* dot = qt + D * TM;
  bf16* stages = reinterpret_cast<bf16*>(strips + kDsWarps * 2 * D * TM);
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(stages + kDsWarps * kStage);
  bf16* next = reinterpret_cast<bf16*>(valid_s + kKeys);  // n rows of [k | v]

  const Slots slots(batch, heads, P);
  const int nq = round16(n);
  const long long row_stride = 3LL * heads * D;
  const long long o_stride = static_cast<long long>(heads) * D;
  auto prefetch = [&](int j) {
    int b, h;
    slots.head_of(j, P, b, h);
    const bf16* src = qkv + static_cast<long long>(b) * n * row_stride + 3LL * h * D + D;
    for (int i = tid; i < n * (D / 4); i += kDsThreads) {
      const int r = i / (D / 4), c = 8 * (i % (D / 4));
      cp_async16(next + r * 2 * D + c, src + r * row_stride + c, 16);
    }
    cp_async_commit();
  };
  if constexpr (kPrefetch) {
    // rows n .. kKeys - 1 of K and V stay zero: each head fills rows < n
    for (int i = tid; i < (kKeys - n) * kLd; i += kDsThreads) {
      k_s[n * kLd + i] = 0.f;
      v_s[n * kLd + i] = 0.f;
    }
    if (slots.count > 0) prefetch(0);
  }
  for (int j = 0; j < slots.count; ++j) {
    int b, h;
    slots.head_of(j, P, b, h);
    const bf16* head = qkv + static_cast<long long>(b) * n * row_stride + 3LL * h * D;
    const uint8_t* valid = mask ? mask + static_cast<long long>(b) * n : nullptr;
    if constexpr (kPrefetch) {
      cp_async_wait<0>();
      __syncthreads();  // the head's rows have landed; every warp is done with the last head
      for (int i = tid; i < n * (D / 4); i += kDsThreads) {
        const int r = i / (D / 4), c = 8 * (i % (D / 4));
        const uint4 x = *reinterpret_cast<const uint4*>(next + r * 2 * D + c);
        store_eight(c < D ? k_s + r * kLd + c : v_s + r * kLd + c - D, x);
      }
      for (int i = tid; i < kKeys; i += kDsThreads) valid_s[i] = i < n && (!valid || valid[i]);
      __syncthreads();  // K, V and the flags are in place; the buffer is free
      if (j + 1 < slots.count) prefetch(j + 1);
    } else {
      __syncthreads();  // every warp is done with the last head
      load_kv_rows<D, ITS>(k_s, v_s, valid_s, head, row_stride, valid, n, tid);
      __syncthreads();
    }
    const long long o_off =
        static_cast<long long>(b) * n * o_stride + static_cast<long long>(h) * D;
    ds_head<D, TM, ITS>(k_s, v_s, qt, dot, stages + warp * kStage, valid_s, head, out + o_off,
                        dout + o_off, row_stride, o_stride, p_s, ds_s,
                        (static_cast<long long>(b) * heads + h) * nq * nq, n, !mask && !causal,
                        causal, scale, warp, lane);
  }
}

// K1b-p, second kernel: K1b's products from the planes (grad_head), one
// block per (head, sample), as K1b's.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    packed_bwd_grad_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           const bf16* __restrict__ p_s, const bf16* __restrict__ ds_s,
                           bf16* __restrict__ dqkv, int n, int heads, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  grad_head<D>(smem, qkv, dout, p_s, ds_s, dqkv, n, heads, skip, blockIdx.x, blockIdx.y);
}

// The grid of a persistent kernel: as many blocks as are resident at once,
// at most one a (sample, head group) unit.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, size_t smem, long long units, int* grid) {
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(units < resident ? units : resident);
  return cudaSuccess;
}

template <int D, int G, bool kOneSweep, int W>
cudaError_t launch_fwd_bf16_g(const void* qkv, const void* mask, void* out, int batch, int n,
                              int heads, float scale, int causal, int stages,
                              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(stages) * slot_bytes<D>(n) + fwd_fixed_bytes<D, W>();
  auto kernel = packed_fwd_kernel<D, G, kOneSweep, W>;
  cudaError_t err = allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = resident_grid(kernel, 32 * W, smem, static_cast<long long>(batch) * heads / (128 / D),
                        &grid);
  if (err != cudaSuccess || grid == 0) return err;
  kernel<<<grid, 32 * W, smem, stream>>>(static_cast<const bf16*>(qkv),
                                         static_cast<const uint8_t*>(mask),
                                         static_cast<bf16*>(out), batch, n, heads, scale, causal,
                                         stages);
  return cudaGetLastError();
}

// K1f's instances (the 16-key groups held in registers and the sweeps, by
// length), each with its warps a block, as many as the instance's
// registers allow: 16 for whole rows of up to 128 keys at D = 32 (125
// registers a thread: K1f's 4 blocks of 4 an SM), 12 for the other whole-row
// instances (at most 168: K1f's 3 blocks of 4), 8 past 224 keys (room for a
// head of 768 keys and the warps' Q strips). `stages`: the ring's buffers,
// chosen by the caller (ops/fused_attention.py, packed_fwd_plan) to fit the
// 227 KB a block may use.
template <int D>
cudaError_t launch_fwd_bf16(const void* qkv, const void* mask, void* out, int batch, int n,
                            int heads, float scale, int causal, int stages,
                            cudaStream_t stream) {
  if (stages < 1 || stages > kMaxStages) return cudaErrorInvalidValue;
  const int groups = kv_rows(n) / 16;
#define K1FP_LAUNCH(G, ONE, W) \
  launch_fwd_bf16_g<D, G, ONE, W>(qkv, mask, out, batch, n, heads, scale, causal, stages, stream)
  if (groups <= 8) return D == 32 ? K1FP_LAUNCH(8, true, 16) : K1FP_LAUNCH(8, true, 12);
  if (groups <= 14) return K1FP_LAUNCH(14, true, 12);
  return K1FP_LAUNCH(4, false, 8);
#undef K1FP_LAUNCH
}

template <int D, int TM, int ITS, typename T>
cudaError_t launch_bwd_ds(const void* qkv, const void* mask, const void* out, const void* dout,
                          bf16* p_s, bf16* ds_s, int batch, int n, int heads, float scale,
                          int causal, cudaStream_t stream) {
  // K1b's shared memory, and below 225 keys the next head's rows in bf16
  const size_t smem = ds_smem_bytes<D, TM, ITS, T>() +
                      (sizeof(T) == sizeof(float) ? static_cast<size_t>(n) * 2 * D * sizeof(bf16)
                                                  : 0);
  auto kernel = packed_bwd_ds_kernel<D, TM, ITS, T>;
  cudaError_t err = allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = resident_grid(kernel, kDsThreads, smem,
                        static_cast<long long>(batch) * heads / (128 / D), &grid);
  if (err != cudaSuccess || grid == 0) return err;
  kernel<<<grid, kDsThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), p_s, ds_s, batch, n, heads,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const void* qkv, const void* mask, const void* out,
                            const void* dout, void* dqkv, void* scratch, int batch, int n,
                            int heads, float scale, int causal, cudaStream_t stream) {
  const int nq = round16(n);
  bf16* p_s = static_cast<bf16*>(scratch);
  bf16* ds_s = p_s + static_cast<long long>(batch) * heads * nq * nq;
  // a lane's keys in registers, ITS of them (up to 96, 128, 224 and 768 keys:
  // the bits do not depend on ITS), for 4 rows at a time with K and V in f32,
  // past 224 keys 2 rows with K and V in bf16, as K1b
#define K1BP_DS(TM, ITS, T)                                                                 \
  launch_bwd_ds<D, TM, ITS, T>(qkv, mask, out, dout, p_s, ds_s, batch, n, heads, scale, \
                               causal, stream)
  cudaError_t err = n <= 96    ? K1BP_DS(4, 3, float)
                    : n <= 128 ? K1BP_DS(4, 4, float)
                    : n <= 224 ? K1BP_DS(4, 7, float)
                               : K1BP_DS(2, 24, bf16);
#undef K1BP_DS
  if (err != cudaSuccess) return err;
  const size_t smem = grad_smem_bytes<D>(n);
  err = allow_smem(packed_bwd_grad_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  packed_bwd_grad_kernel<D><<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), p_s, ds_s,
      static_cast<bf16*>(dqkv), n, heads, causal && !mask);
  return cudaGetLastError();
}

// ------------------------------------------------------- f32: scalar kernels

constexpr int kF32Threads = 256;  // 16 row groups x 16 column groups

// tile shapes: forward and dQ take 64 query rows against 32-key tiles; dK/dV
// takes 64 keys against 32-row query tiles
constexpr int kFwdRows = 64, kFwdKeys = 32;
constexpr int kKvKeys = 64, kKvRows = 32;

// four floats in one 16-byte load
__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Rows row0 .. row0 + ROWS - 1 of the P heads of one group: for head h, the
// NSEG * D contiguous values at column h * head_stride of each row of `src`
// (row stride `row_stride`), in 16-byte vectors. Segment s of head h, row r
// lands at dst_s[(h * ROWS + r) * (D + 1) + c], f32 (the row padded by one
// float: no bank conflicts when 16 threads read 16 rows at one column). Rows
// past n read as 0.
template <int D, int P, int ROWS, int NSEG>
__device__ __forceinline__ void load_heads(float* dst0, float* dst1, const float* src,
                                           int64_t row_stride, int head_stride, int row0,
                                           int n, int tid) {
  constexpr int kVec = 4;  // floats in a 16-byte vector
  static_assert(D % kVec == 0, "a vector must stay inside one head's segment");
  constexpr int kPerHead = NSEG * D / kVec;
  constexpr int kPerRow = P * kPerHead;
  for (int i = tid; i < ROWS * kPerRow; i += kF32Threads) {
    const int r = i / kPerRow, rem = i % kPerRow;
    const int h = rem / kPerHead, e = (rem % kPerHead) * kVec;
    const int row = row0 + r;
    float vals[kVec];
    if (row < n) {
      load4(src + row * row_stride + h * head_stride + e, vals);
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

// The reverse: stage is [ROWS][P][NSEG * D] f32 in shared memory; head h's
// NSEG * D values of row r go to column h * head_stride of row row0 + r of
// `dst`, in 16-byte vectors; rows past n are not written.
template <int D, int P, int ROWS, int NSEG>
__device__ __forceinline__ void store_heads(float* dst, int64_t row_stride, int head_stride,
                                            const float* stage, int row0, int n, int tid) {
  constexpr int kVec = 4;  // floats in a 16-byte vector
  constexpr int kPerHead = NSEG * D / kVec;
  constexpr int kPerRow = P * kPerHead;
  for (int i = tid; i < ROWS * kPerRow; i += kF32Threads) {
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
constexpr size_t fwd_f32_smem_bytes() {
  constexpr int P = group_heads<D>(), kLd = D + 1;
  // q of every head, k and v of every head, one head's p tile, key flags
  return sizeof(float) * (P * kFwdRows * kLd + 2 * P * kFwdKeys * kLd +
                          kFwdRows * (kFwdKeys + 1) + kFwdKeys);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    packed_fwd_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                          float* __restrict__ out, int n, int num_heads, float scale,
                          int causal) {
  constexpr int P = group_heads<D>();
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  constexpr int R = kFwdRows / 16, C = kFwdKeys / 16;
  constexpr int kLdP = kFwdKeys + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;
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
  const float* group = qkv + static_cast<int64_t>(b) * n * row_stride +
                       static_cast<int64_t>(grp) * P * 3 * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;

  load_heads<D, P, kFwdRows, 1>(q_s, nullptr, group, row_stride, 3 * D, q0, n, tid);

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
    load_heads<D, P, kFwdKeys, 2>(k_s, v_s, group + D, row_stride, 3 * D, k0, n, tid);
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
          p_s[(R * ty + i) * kLdP + tx + 16 * j] = p;
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
  float* o_s = smem_f;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        o_s[((R * ty + i) * P + h) * D + tx + 16 * c] =
            acc[h][i][c] / l_run[h][i];
  __syncthreads();
  const int64_t o_stride = static_cast<int64_t>(num_heads) * D;
  store_heads<D, P, kFwdRows, 1>(
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

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    packed_bwd_dq_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         const float* __restrict__ out, const float* __restrict__ dout,
                         float* __restrict__ dqkv, float* __restrict__ stats, int n,
                         int num_heads, float scale, int causal) {
  constexpr int P = group_heads<D>();
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  constexpr int R = kFwdRows / 16, C = kFwdKeys / 16;
  constexpr int kLdP = kFwdKeys + 1;
  static_assert(2 * kFwdKeys == kFwdRows, "k_s and v_s together hold one row tile");
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;
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
  const float* group = qkv + qkv_off;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;

  load_heads<D, P, kFwdRows, 1>(q_s, nullptr, group, row_stride, 3 * D, q0, n, tid);
  load_heads<D, P, kFwdRows, 1>(do_s, nullptr, dout + o_off, o_stride, D, q0, n, tid);
  float* o_s = k_s;  // the forward's output of the rows, across k_s and v_s
  load_heads<D, P, kFwdRows, 1>(o_s, nullptr, out + o_off, o_stride, D, q0, n, tid);
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
    load_heads<D, P, kFwdKeys, 1>(k_s, nullptr, group + D, row_stride, 3 * D, k0, n, tid);
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
    load_heads<D, P, kFwdKeys, 2>(k_s, v_s, group + D, row_stride, 3 * D, k0, n, tid);
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
          ds_s[(R * ty + i) * kLdP + kj] = ds;
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
  float* stage = smem_f;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        stage[((R * ty + i) * P + h) * D + tx + 16 * c] = dq[h][i][c];
  __syncthreads();
  store_heads<D, P, kFwdRows, 1>(dqkv + qkv_off, row_stride, 3 * D, stage, q0, n, tid);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int P = group_heads<D>(), kLd = D + 1;
  // k and v of every head, q and dout of every head, one head's p^T and
  // ds^T tiles, the query rows' m, l and delta of every head, key flags
  return sizeof(float) * (2 * P * kKvKeys * kLd + 2 * P * kKvRows * kLd +
                          2 * kKvKeys * (kKvRows + 1) + 3 * P * kKvRows + kKvKeys);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    packed_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                          const float* __restrict__ dout, float* __restrict__ dqkv,
                          const float* __restrict__ stats, int n, int num_heads, float scale,
                          int causal) {
  constexpr int P = group_heads<D>();
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  constexpr int R = kKvKeys / 16, C = kKvRows / 16;
  constexpr int kLdP = kKvRows + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* k_s = smem_f;
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
  const float* group = qkv + qkv_off;
  const float* do_group =
      dout + static_cast<int64_t>(b) * n * o_stride + static_cast<int64_t>(grp) * P * D;
  const uint8_t* key_valid = mask ? mask + static_cast<int64_t>(b) * n : nullptr;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * num_heads * n;
  const int64_t row_base =
      (static_cast<int64_t>(b) * num_heads + static_cast<int64_t>(grp) * P) * n;

  load_heads<D, P, kKvKeys, 2>(k_s, v_s, group + D, row_stride, 3 * D, k0, n, tid);
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
    load_heads<D, P, kKvRows, 1>(q_s, nullptr, group, row_stride, 3 * D, q0, n, tid);
    load_heads<D, P, kKvRows, 1>(do_s, nullptr, do_group, o_stride, D, q0, n, tid);
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
          pt_s[ki * kLdP + qj] = p;
          dst_s[ki * kLdP + qj] = ds;
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
  float* stage = smem_f;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float* row = stage + ((R * ty + i) * P + h) * 2 * D;
        row[tx + 16 * c] = dk[h][i][c];
        row[D + tx + 16 * c] = dv[h][i][c];
      }
  __syncthreads();
  store_heads<D, P, kKvKeys, 2>(dqkv + qkv_off + D, row_stride, 3 * D, stage, k0, n, tid);
}

template <int D>
cudaError_t launch_fwd_f32(const void* qkv, const void* mask, void* out, int batch, int n,
                           int num_heads, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_f32_smem_bytes<D>();
  cudaError_t err = allow_smem(packed_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kFwdRows - 1) / kFwdRows, num_heads / group_heads<D>(), batch);
  packed_fwd_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), n, num_heads, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const void* qkv, const void* mask, const void* out, const void* dout,
                           void* dqkv, void* stats, int batch, int n, int num_heads,
                           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<D>();
  constexpr size_t smem_dkv = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(packed_bwd_dq_f32_kernel<D>, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(packed_bwd_dkv_f32_kernel<D>, smem_dkv);
  if (err != cudaSuccess) return err;
  const int groups = num_heads / group_heads<D>();
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  packed_bwd_dq_f32_kernel<D><<<dim3((n + kFwdRows - 1) / kFwdRows, groups, batch),
                                 kF32Threads, smem_dq, stream>>>(
      static_cast<const float*>(qkv), m, static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<float*>(dqkv), static_cast<float*>(stats), n,
      num_heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_bwd_dkv_f32_kernel<D><<<dim3((n + kKvKeys - 1) / kKvKeys, groups, batch),
                                  kF32Threads, smem_dkv, stream>>>(
      static_cast<const float*>(qkv), m, static_cast<const float*>(dout), static_cast<float*>(dqkv),
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
// (batch, n) bytes, 1 = attend, or null. stages (bf16 only, 1 .. 4): the
// forward's ring of head buffers, whose shared memory must fit a block.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).
int mmlearn_fused_mha_packed_fwd(const void* qkv, const void* mask, void* out, int batch,
                                 int n, int num_heads, int head_dim, int dtype, float scale,
                                 int causal, int stages, void* stream) {
  if (!supported(n, num_heads, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch_fwd_f32<32>(qkv, mask, out, batch, n, num_heads, scale, causal, s);
  if (dtype == 0)
    return launch_fwd_f32<64>(qkv, mask, out, batch, n, num_heads, scale, causal, s);
  if (head_dim == 32)
    return launch_fwd_bf16<32>(qkv, mask, out, batch, n, num_heads, scale, causal, stages, s);
  return launch_fwd_bf16<64>(qkv, mask, out, batch, n, num_heads, scale, causal, stages, s);
}

// The backward: dqkv (same shape, type and packing as qkv) from qkv, the
// forward's output `out` and its cotangent `dout` (batch, n, heads *
// head_dim), and the mask. `scratch`: in bf16, 2 * batch * heads * nq * nq
// bf16 (nq = n rounded up to 16: p and ds, query-major), in f32, 3 * batch *
// heads * n floats (max, sum, delta). Two launches on `stream`, no
// synchronisation; returns the first failing launch's cudaError_t (0 on
// success).
int mmlearn_fused_mha_packed_bwd(const void* qkv, const void* mask, const void* out,
                                 const void* dout, void* dqkv, void* scratch, int batch, int n,
                                 int num_heads, int head_dim, int dtype, float scale,
                                 int causal, void* stream) {
  if (!supported(n, num_heads, head_dim, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch_bwd_f32<32>(qkv, mask, out, dout, dqkv, scratch, batch, n, num_heads,
                                     scale, causal, s);
  if (dtype == 0)
    return launch_bwd_f32<64>(qkv, mask, out, dout, dqkv, scratch, batch, n, num_heads,
                                     scale, causal, s);
  if (head_dim == 32)
    return launch_bwd_bf16<32>(qkv, mask, out, dout, dqkv, scratch, batch, n, num_heads, scale,
                               causal, s);
  return launch_bwd_bf16<64>(qkv, mask, out, dout, dqkv, scratch, batch, n, num_heads, scale,
                             causal, s);
}

const char* mmlearn_packed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
