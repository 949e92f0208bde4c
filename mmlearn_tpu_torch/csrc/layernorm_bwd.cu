// LayerNorm and residual-add + LayerNorm backward (kernel K2b), Hopper sm_90a.
//
// Replaces the TPU kernels of mmlearn_tpu/ops/fused_norm.py `_bwd_kernel`
// (:144) and `_bwd_add_kernel` (:177), launched by `_bwd_pallas` (:227). Same
// function, for each row of x (rows, C) with its cotangent dy (and, in the
// add variant, the residual's cotangent dr):
//
//   mean, rstd = the row's f32 mean and 1 / sqrt(var + eps), two passes
//   xhat       = (x - mean) rstd,  dxhat = dy gamma
//   dx         = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) (+ dr),
//                in f32, rounded once to x's type
//   dgamma     = sum over rows of dy xhat,  dbeta = sum over rows of dy (f32)
//
// What bounds it on the H100: each element is read from x, dy (and dr) and
// written to dx once with some twenty FLOPs, so it is bound by memory: at
// (256 x 197, 768) in bf16 the 232 MB take 0.069 ms at 3.35 TB/s.
//
// Design. One launch a backward, no atomics on values:
//   rows    one warp a row, persistent blocks (three of four warps an SM,
//           one of eight with dr), each warp taking rows warp, warp + all
//           warps, ...; gamma in shared memory. A lane holds
//           E = 8 or 4 elements a vector (16 or 8 bytes) and NV <= 4 vectors
//           of the row (C = 32 E NV: 768 and 512 as 3 and 2 16-byte vectors
//           in bf16, 384 as 3 8-byte ones), so no lane is padded. While a
//           row is reduced the next row's x, dy and dr are already loading
//           into a second set of registers. Mean and variance are two passes
//           over the row in registers, as ln_bwd_reference takes them;
//   columns each lane keeps its columns' partial sums over all its rows:
//           dbeta's in registers, dgamma's compensated (Kahan: a lane adds
//           some forty rows, and a plain f32 sum of dy xhat put the total up
//           to 1e-4 off the plain version at 120,832 rows; dbeta's sums of dy
//           read 2e-5 plain) in its own slots of shared memory, which leaves
//           the registers for the rows in flight, what the kernel's speed
//           depends on. At the end the block's warps add theirs in
//           f64 into shared memory in warp order and the block writes one f64
//           partial row pair. Then, in two levels so that no one block reads
//           them all, the last block of each group of 16 (a counter a group,
//           __threadfence) adds its group's partials in block order, and the
//           last group to finish adds the group sums in group order and
//           rounds them to f32; each resets its counter. So dgamma / dbeta
//           are the same bits on every run;
//   other C (not 32 E NV with NV <= 4, or a misaligned operand): the wide
//           kernel, one block of 512 threads a row, a thread taking columns
//           t, t + 512, ... (up to C = 8192) with scalar loads, the same
//           column sums. A dispatch by shape, not a fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxC = 8192;
// rows kernel: warps a block, and the blocks an SM holds (by registers):
// three of four warps, or with dr one of eight (the faster of the layouts
// tried at C = 768 and 384, PERF.md)
template <bool kDr>
__host__ __device__ constexpr int row_warps() {
  return kDr ? 8 : 4;
}
template <bool kDr>
__host__ __device__ constexpr int row_blocks() {
  return kDr ? 1 : 3;
}
constexpr int kWideThreads = 512;             // wide kernel: threads a block (a row)
constexpr int kWideCols = kMaxC / kWideThreads;  // columns a thread, at most
constexpr int kGroup = 16;                    // blocks a group of the column sums
constexpr int kCounters = 1024;               // counters the caller zeroes, at most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
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

// s + v with the compensation c (Kahan): s - c is the sum so far
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kBytes of consecutive elements of T, loaded and stored as one vector
template <int kBytes>
struct Raw;
template <>
struct Raw<16> {
  typedef uint4 type;
};
template <>
struct Raw<8> {
  typedef uint2 type;
};

template <typename T, int kBytes>
struct Pack {
  static constexpr int E = kBytes / static_cast<int>(sizeof(T));
  typename Raw<kBytes>::type raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldcs(reinterpret_cast<const typename Raw<kBytes>::type*>(p));
  }
  __device__ __forceinline__ float operator[](int i) const {
    return to_float(reinterpret_cast<const T*>(&raw)[i]);
  }
  __device__ __forceinline__ void set(int i, float v) { reinterpret_cast<T*>(&raw)[i] = from_float<T>(v); }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<typename Raw<kBytes>::type*>(p) = raw;
  }
};

// Rows [0, rows) of src (rows of c2 doubles, c2 even) added in row order into
// dst; the block's threads take column pairs, kGroup 16-byte loads in
// flight each.
template <typename D>
__device__ void sum_rows(const double* src, int rows, int c2, D* dst) {
  for (int j = threadIdx.x; 2 * j < c2; j += blockDim.x) {
    double s0 = 0.0, s1 = 0.0;
    for (int b0 = 0; b0 < rows; b0 += kGroup) {
      double2 v[kGroup];
#pragma unroll
      for (int b = 0; b < kGroup; ++b)
        if (b0 + b < rows)
          v[b] = __ldcg(reinterpret_cast<const double2*>(src + static_cast<long long>(b0 + b) * c2) + j);
#pragma unroll
      for (int b = 0; b < kGroup; ++b)
        if (b0 + b < rows) {
          s0 += v[b].x;
          s1 += v[b].y;
        }
    }
    dst[2 * j] = static_cast<D>(s0);
    dst[2 * j + 1] = static_cast<D>(s1);
  }
}

// The column sums of every block's partials, in a fixed order, by the blocks
// that finish last: the last block of each group of kGroup blocks adds its
// group's partials in block order into a group row; the last group to finish
// adds the group rows in group order into sums (dgamma, then dbeta). part:
// (blocks + groups, 2, c) f64, this block's row pair already written;
// counters: groups + 1 zeros, left zero.
__device__ void finish_column_sums(double* part, unsigned* counters, float* sums, int c) {
  __shared__ bool last;
  const int blocks = gridDim.x, groups = (blocks + kGroup - 1) / kGroup;
  const int group = blockIdx.x / kGroup;
  const int members = min(kGroup, blocks - group * kGroup);
  const int c2 = 2 * c;
  __threadfence();  // this block's partials visible to the group's last block
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + group, 1u) == members - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows(part + static_cast<long long>(group) * kGroup * c2, members, c2,
           part + static_cast<long long>(blocks + group) * c2);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    counters[group] = 0u;
    last = atomicAdd(counters + groups, 1u) == groups - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows(part + static_cast<long long>(blocks) * c2, groups, c2, sums);
  if (threadIdx.x == 0) counters[groups] = 0u;
}

// ------------------------------------------------------ the rows kernel

// E consecutive gammas from shared memory, as 16- or 8-byte vectors
template <int E>
__device__ __forceinline__ void load_gamma(const float* p, float (&g)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int u = 0; u < E / 4; ++u) {
      const float4 v = reinterpret_cast<const float4*>(p)[u];
      g[4 * u] = v.x;
      g[4 * u + 1] = v.y;
      g[4 * u + 2] = v.z;
      g[4 * u + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    g[0] = v.x;
    g[1] = v.y;
  }
}

// Bytes in flight are what bounds it, and registers what bounds the warps
// an SM holds: dgamma's compensated sums (two floats a column) live in
// shared memory, each lane's own slots, 8-byte vectors lane-major (no bank
// conflicts); so does gamma; xhat is recomputed where it is used. Each warp
// has two rows in flight.
template <typename T, int kBytes, int NV, bool kDr>
__global__ void __launch_bounds__(32 * row_warps<kDr>(), row_blocks<kDr>())
    ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const T* __restrict__ dy, const T* __restrict__ dr, T* __restrict__ dx,
                       double* __restrict__ part, unsigned* counters, float* __restrict__ sums,
                       int rows, int c, float eps) {
  typedef Pack<T, kBytes> P;
  constexpr int E = P::E;
  constexpr int kRowWarps = row_warps<kDr>();
  // (2, c) f64: the block's partials; gamma; per warp dgamma's sums and
  // their compensations, float2 [2][NV][E / 2][32]
  extern __shared__ double red[];
  float* gs = reinterpret_cast<float*>(red + 2 * c);
  for (int j = threadIdx.x; j < c; j += blockDim.x) gs[j] = gamma[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* ks = reinterpret_cast<float2*>(gs + c) + warp * (2 * NV * (E / 2) * 32) + lane;
  float2* kc = ks + NV * (E / 2) * 32;
#pragma unroll
  for (int u = 0; u < NV * (E / 2); ++u) ks[32 * u] = kc[32 * u] = make_float2(0.f, 0.f);
  __syncthreads();
  // vector i of a lane covers columns (32 i + lane) E .. + E - 1
  float pb[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) pb[i][e] = 0.f;

  P xv[NV], gv[NV], rv[NV];  // this row's x, dy, dr
  auto load = [&](int row, P(&a)[NV], P(&b)[NV], P(&d)[NV]) {
    const long long base = static_cast<long long>(row) * c + lane * E;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      a[i].load(x + base + 32 * E * i);
      b[i].load(dy + base + 32 * E * i);
      if (kDr) d[i].load(dr + base + 32 * E * i);
    }
  };
  const int stride = gridDim.x * kRowWarps;
  int row = blockIdx.x * kRowWarps + warp;
  if (row < rows) load(row, xv, gv, rv);
  for (; row < rows; row += stride) {
    P xn[NV], gn[NV], rn[NV];  // the next row's, in flight meanwhile
    if (row + stride < rows) load(row + stride, xn, gn, rn);

    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) s += xv[i][e];
    const float mean = warp_sum(s) / c;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xc = xv[i][e] - mean;
        q += xc * xc;
      }
    const float rstd = rsqrtf(warp_sum(q) / c + eps);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float g[E];
      load_gamma<E>(gs + (32 * i + lane) * E, g);
#pragma unroll
      for (int u = 0; u < E / 2; ++u) {
        float2 sum = ks[32 * (i * (E / 2) + u)], comp = kc[32 * (i * (E / 2) + u)];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * u + h;
          const float d = gv[i][e], xh = (xv[i][e] - mean) * rstd;
          const float dxh = d * g[e];
          c1 += dxh;
          c2 += dxh * xh;
          kahan_add(h ? sum.y : sum.x, h ? comp.y : comp.x, d * xh);
          pb[i][e] += d;
        }
        ks[32 * (i * (E / 2) + u)] = sum;
        kc[32 * (i * (E / 2) + u)] = comp;
      }
    }
    c1 = warp_sum(c1) / c;
    c2 = warp_sum(c2) / c;
    const long long base = static_cast<long long>(row) * c + lane * E;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float g[E];
      load_gamma<E>(gs + (32 * i + lane) * E, g);
      P out;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (xv[i][e] - mean) * rstd;
        float v = rstd * (gv[i][e] * g[e] - c1 - xh * c2);
        if (kDr) v += rv[i][e];
        out.set(e, v);
      }
      out.store(dx + base + 32 * E * i);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xv[i] = xn[i];
      gv[i] = gn[i];
      if (kDr) rv[i] = rn[i];
    }
  }

  // the block's partials in f64: warp 0 writes, each next warp adds, in order
  for (int w = 0; w < kRowWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = (32 * i + lane) * E + e;
          const float2 sum = ks[32 * (i * (E / 2) + e / 2)], comp = kc[32 * (i * (E / 2) + e / 2)];
          const double g = static_cast<double>(e % 2 ? sum.y : sum.x) - (e % 2 ? comp.y : comp.x);
          const double b = pb[i][e];
          red[col] = w == 0 ? g : red[col] + g;
          red[c + col] = w == 0 ? b : red[c + col] + b;
        }
    }
    __syncthreads();
  }
  double* mine = part + static_cast<long long>(blockIdx.x) * 2 * c;
  for (int j = threadIdx.x; j < 2 * c; j += blockDim.x) mine[j] = red[j];
  finish_column_sums(part, counters, sums, c);
}

// ------------------------------------------------------ the wide kernel

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch free from the last call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWideThreads / 32; ++w) s += scratch[w];
  return s;
}

template <typename T, bool kDr>
__global__ void __launch_bounds__(kWideThreads, 1)
    ln_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const T* __restrict__ dy, const T* __restrict__ dr, T* __restrict__ dx,
                       double* __restrict__ part, unsigned* counters, float* __restrict__ sums,
                       int rows, int c, float eps) {
  __shared__ float scratch[kWideThreads / 32];
  const int t = threadIdx.x;
  float pg[kWideCols], cg[kWideCols], pb[kWideCols], g[kWideCols];
#pragma unroll
  for (int j = 0; j < kWideCols; ++j) {
    const int col = t + kWideThreads * j;
    pg[j] = cg[j] = pb[j] = 0.f;
    g[j] = col < c ? gamma[col] : 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = static_cast<long long>(row) * c;
    float xh[kWideCols], d[kWideCols];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kWideCols; ++j) {
      const int col = t + kWideThreads * j;
      xh[j] = col < c ? to_float(x[base + col]) : 0.f;
      d[j] = col < c ? to_float(dy[base + col]) : 0.f;
      s += xh[j];
    }
    const float mean = block_sum(s, scratch) / c;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kWideCols; ++j) {
      const int col = t + kWideThreads * j;
      xh[j] = col < c ? xh[j] - mean : 0.f;
      q += xh[j] * xh[j];
    }
    const float rstd = rsqrtf(block_sum(q, scratch) / c + eps);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int j = 0; j < kWideCols; ++j) {
      xh[j] *= rstd;
      const float dxh = d[j] * g[j];
      c1 += dxh;
      c2 += dxh * xh[j];
      kahan_add(pg[j], cg[j], d[j] * xh[j]);
      pb[j] += d[j];
    }
    c1 = block_sum(c1, scratch) / c;
    c2 = block_sum(c2, scratch) / c;
#pragma unroll
    for (int j = 0; j < kWideCols; ++j) {
      const int col = t + kWideThreads * j;
      if (col < c) {
        float v = rstd * (d[j] * g[j] - c1 - xh[j] * c2);
        if (kDr) v += to_float(dr[base + col]);
        dx[base + col] = from_float<T>(v);
      }
    }
  }
  // a column belongs to one thread: its partials are the block's
  double* mine = part + static_cast<long long>(blockIdx.x) * 2 * c;
#pragma unroll
  for (int j = 0; j < kWideCols; ++j) {
    const int col = t + kWideThreads * j;
    if (col < c) {
      mine[col] = static_cast<double>(pg[j]) - cg[j];
      mine[c + col] = pb[j];
    }
  }
  finish_column_sums(part, counters, sums, c);
}

// ------------------------------------------------------------ the host

struct Args {
  const void *x, *gamma, *dy, *dr;
  void *dx, *part, *counters, *sums;
  int rows, c;
  float eps;
};

// The rows kernel's vector (16 or 8 bytes) and vectors a lane for C, or 0
// where the wide kernel takes it: C = 32 E NV, NV <= 4, every row pointer
// aligned to the vector.
void rows_shape(int c, int elem, bool aligned16, bool aligned8, int* bytes, int* nv) {
  *bytes = *nv = 0;
  for (int b : {16, 8}) {
    const int per_warp = 32 * (b / elem);
    const bool ok = b == 16 ? aligned16 : aligned8;
    if (ok && c % per_warp == 0 && c / per_warp <= 4) {
      *bytes = b;
      *nv = c / per_warp;
      return;
    }
  }
}

template <typename K>
int grid_for(K kernel, int threads, size_t smem, int rows_per_block, int rows) {
  int device, sms, per_sm = 0;
  if (cudaGetDevice(&device) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem))
    return -1;
  const int need = (rows + rows_per_block - 1) / rows_per_block;
  return need < sms * per_sm ? need : sms * per_sm;
}

// the rows kernel's shared memory: the block's f64 partials, gamma, and
// each warp's compensated dgamma sums (two floats a column)
size_t rows_smem(int c, int warps) {
  return 2 * c * sizeof(double) + c * sizeof(float) + warps * 2 * c * sizeof(float);
}

template <typename T, int kBytes, int NV, bool kDr>
int plan_rows(int rows, int c) {
  constexpr int warps = row_warps<kDr>();
  const size_t smem = rows_smem(c, warps);  // past 48 KB only by the attribute
  if (cudaFuncSetAttribute(ln_bwd_rows_kernel<T, kBytes, NV, kDr>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))
    return -1;
  return grid_for(ln_bwd_rows_kernel<T, kBytes, NV, kDr>, 32 * warps, smem, warps, rows);
}
template <typename T, int kBytes, int NV, bool kDr>
cudaError_t launch_rows(const Args& a, int blocks, cudaStream_t s) {
  constexpr int warps = row_warps<kDr>();
  ln_bwd_rows_kernel<T, kBytes, NV, kDr><<<blocks, 32 * warps, rows_smem(a.c, warps), s>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.gamma),
      static_cast<const T*>(a.dy), static_cast<const T*>(a.dr), static_cast<T*>(a.dx),
      static_cast<double*>(a.part), static_cast<unsigned*>(a.counters),
      static_cast<float*>(a.sums), a.rows, a.c, a.eps);
  return cudaGetLastError();
}
template <typename T, bool kDr>
cudaError_t launch_wide(const Args& a, int blocks, cudaStream_t s) {
  ln_bwd_wide_kernel<T, kDr><<<blocks, kWideThreads, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.gamma),
      static_cast<const T*>(a.dy), static_cast<const T*>(a.dr), static_cast<T*>(a.dx),
      static_cast<double*>(a.part), static_cast<unsigned*>(a.counters),
      static_cast<float*>(a.sums), a.rows, a.c, a.eps);
  return cudaGetLastError();
}

// One entry for planning (a == nullptr: the blocks into *blocks) and
// launching (the blocks given): the kernel instance for (dtype, C,
// alignment, dr).
template <typename T, bool kDr>
cudaError_t dispatch(const Args* a, int rows, int c, bool al16, bool al8, int* blocks,
                     cudaStream_t s) {
  int bytes, nv;
  rows_shape(c, sizeof(T), al16, al8, &bytes, &nv);
  int planned = -1;
#define MMLEARN_ROWS(B, N)                                          \
  if (bytes == B && nv == N) {                                      \
    if (a != nullptr) return launch_rows<T, B, N, kDr>(*a, *blocks, s); \
    planned = plan_rows<T, B, N, kDr>(rows, c);                     \
  } else
  MMLEARN_ROWS(16, 1) MMLEARN_ROWS(16, 2) MMLEARN_ROWS(16, 3) MMLEARN_ROWS(16, 4)
  MMLEARN_ROWS(8, 1) MMLEARN_ROWS(8, 2) MMLEARN_ROWS(8, 3) MMLEARN_ROWS(8, 4) {
    if (a != nullptr) return launch_wide<T, kDr>(*a, *blocks, s);
    planned = grid_for(ln_bwd_wide_kernel<T, kDr>, kWideThreads, 0, 1, rows);
  }
#undef MMLEARN_ROWS
  if (planned < 1 || (planned + kGroup - 1) / kGroup + 1 > kCounters)
    return cudaErrorInvalidConfiguration;
  *blocks = planned;
  return cudaSuccess;
}

cudaError_t route(const Args* a, int rows, int c, int dtype, bool has_dr, bool al16, bool al8,
                  int* blocks, cudaStream_t s) {
  if (rows < 1 || c < 1 || c > kMaxC) return cudaErrorInvalidValue;
  if (dtype == 0)
    return has_dr ? dispatch<float, true>(a, rows, c, al16, al8, blocks, s)
                  : dispatch<float, false>(a, rows, c, al16, al8, blocks, s);
  if (dtype == 1)
    return has_dr ? dispatch<bf16, true>(a, rows, c, al16, al8, blocks, s)
                  : dispatch<bf16, false>(a, rows, c, al16, al8, blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The blocks the backward of (rows, c) launches, into *blocks, and the rows
// of its (part_rows, 2, c) f64 partials, into *part_rows. align: the largest
// of 16, 8, 4 that divides every row pointer (x, dy, dr, dx, in bytes).
// Returns 0, or a cudaError_t.
int mmlearn_ln_bwd_plan(int rows, int c, int dtype, int has_dr, int align, int* blocks,
                        int* part_rows) {
  const cudaError_t err =
      route(nullptr, rows, c, dtype, has_dr != 0, align >= 16, align >= 8, blocks, nullptr);
  if (err == cudaSuccess) *part_rows = *blocks + (*blocks + kGroup - 1) / kGroup;
  return static_cast<int>(err);
}

// x, dy, dr (or null), dx: (rows, c) row-major, dtype 0 = float32, 1 =
// bfloat16; gamma: c float32; part: the planned partials, f64 scratch;
// counters: 1024 unsigned ints, zero before the launch and after it, and
// used by no other launch while this one runs (the caller keeps a set a
// stream); sums:
// (2, c) float32, dgamma then dbeta. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
int mmlearn_ln_bwd(const void* x, const void* gamma, const void* dy, const void* dr, void* dx,
                   void* part, void* counters, void* sums, int rows, int c, int dtype, int align,
                   int blocks, float eps, void* stream) {
  const Args a{x, gamma, dy, dr, dx, part, counters, sums, rows, c, eps};
  return static_cast<int>(route(&a, rows, c, dtype, dr != nullptr, align >= 16, align >= 8,
                                &blocks, static_cast<cudaStream_t>(stream)));
}

const char* mmlearn_ln_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
