// LayerNorm and residual-add + LayerNorm forward (kernel K2f), Hopper sm_90a.
//
// Replaces the TPU kernels of mmlearn_tpu/ops/fused_norm.py `_fwd_kernel`
// (:126) and `_fwd_add_kernel` (:139), launched by `_fwd_pallas` (:191). Same
// function, for each row of x (rows, C), C <= 8192, in bf16 or f32:
//
//   r     = x + branch, rounded once to x's type (the add variant only; it
//           is written, and the statistics below are those of the rounded r)
//   mean  = the row's f32 mean, var = the f32 mean of (x - mean)^2: two
//           passes over the row, as ln_reference takes them
//   y     = (x - mean) rsqrt(var + eps) gamma + beta in f32 (gamma, beta f32),
//           rounded once to x's type
//
// What bounds it on the H100: one read of x (and branch) and one write of y
// (and r) a value with a few FLOPs each, so memory: at (256 x 197, 768) in
// bf16 LN moves 155 MB, 0.046 ms at 3.35 TB/s.
//
// Its bits. The rows kernel computes the bits of the kernel it replaced,
// the port's first K2f (Triton, one program of next_pow2(C) lanes a row,
// BLOCK / 256 warps of eight values a thread), read from the machine code
// Triton generated for it on the H100: a thread's eight values summed in
// order, a butterfly over the warp's lanes (offsets 16 .. 1), then one over
// the warps (BLOCK / 512 .. 1); rcp = the approximate reciprocal of C (its
// division, unscaled for any C here); x - mean as fma(rcp, -sum, x), one
// rounding; var = rcp times the squares' sum, taken as before (x1 x1, then
// fused multiply-adds of x0 x0, x2 x2, ...); the approximate rsqrt of var +
// eps; y = fma((x - mean) rstd, gamma, beta); and in bf16 r by add.bf16x2.
// Nothing requires those bits now. A last-bit difference in y moves a bf16
// rounding, which the checks that hold whole runs on the card to other runs
// of the same numbers (the CPU's, a model-split one's, an f32 copy's) read
// through every layer; their limits sit at about twice the largest reading
// of three sound LayerNorms (this kernel, its plain version on the card and
// F.layer_norm; tools/noise_limits.py), so a kernel with its own order of
// sums and exact operations is held by the same limits.
//
// Design. The memory's rate needs bytes in flight (some 15-20 KB an SM at
// its latency), rows in order (rows far apart in flight at once read slower),
// and warps (registers) to hold them:
//   rows   C a multiple of 8, 128 < C <= 2048: one warp a row, blocks of four
//          warps over consecutive rows, one block for every four rows. Lane
//          L holds what the first kernel's threads L, L + 32, ... held: W =
//          next_pow2(C) / 256 vectors of eight values (16 bytes in bf16; value
//          by value where a row pointer is not 16-byte aligned, with the same
//          bits), the last ones masked where C is not a power of two, so C =
//          1280 and 1408 keep five and six of eight. gamma and beta come
//          through L1. Persistent blocks (a loop over rows with the next row
//          loading meanwhile) and two or three rows a warp read 2-10% slower
//          at the towers' grids (PERF.md, PR 20);
//   wide   every other C: one block of 512 threads a row, a thread taking
//          columns t, t + 512, ... with scalar loads, the sums across warps
//          through shared memory, the same elementwise operations (its own
//          order of sums). A dispatch by shape, not a fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxC = 8192;
constexpr int kRowWarps = 4;                     // rows kernel: warps (rows) a block
constexpr int kMaxW = 8;                         // rows kernel: vectors a lane, at most
constexpr int kWideThreads = 512;                // wide kernel: threads a block (a row)
constexpr int kWideCols = kMaxC / kWideThreads;  // columns a thread, at most

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

// The first kernel's operations, as its machine code does them
__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
// x - sum / C, the division's product fused into the subtraction
__device__ __forceinline__ float centre(float x, float sum, float rcp) {
  return __fmaf_rn(rcp, -sum, x);
}
__device__ __forceinline__ float rstd_of(float var, float eps) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(eps, var)));
  return r;
}
__device__ __forceinline__ float normalize(float xc, float rstd, float g, float b) {
  return __fmaf_rn(__fmul_rn(xc, rstd), g, b);
}
// r = x + branch in x's type: add.bf16x2 on two bf16 at a time, f32 adds
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b, bf16*) {
  uint32_t r;
  asm("add.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b, float*) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}

// the warp's butterfly (offsets 16 .. 1), each lane adding the other's value
// to its own; every lane ends with the same sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Eight consecutive values of a row: 16-byte accesses where the row
// pointer is aligned to them (vec), else one access a value.
template <typename T>
struct Vec8 {
  static constexpr int kWords = 8 * sizeof(T) / 4;  // 32-bit words
  uint32_t w[kWords];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void load(const T* p, bool vec) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i)
        *reinterpret_cast<uint4*>(w + 4 * i) = reinterpret_cast<const uint4*>(p)[i];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) reinterpret_cast<T*>(w)[k] = p[k];
    }
  }
  __device__ __forceinline__ void store(T* p, bool vec) const {
    if (vec) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i)
        reinterpret_cast<uint4*>(p)[i] = *reinterpret_cast<const uint4*>(w + 4 * i);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = reinterpret_cast<const T*>(w)[k];
    }
  }
  __device__ __forceinline__ float operator[](int k) const {
    return to_float(reinterpret_cast<const T*>(w)[k]);
  }
  __device__ __forceinline__ void set(int k, float v) {
    reinterpret_cast<T*>(w)[k] = from_float<T>(v);
  }
};

// The row's sum from each vector's partial sum s[v] (lane L's s[v] is
// what the first kernel's thread 32 v + L held): the warp's butterfly for
// each v, then the butterfly over the W warps, warp 0's value.
template <int W>
__device__ __forceinline__ float row_sum(float (&s)[W]) {
#pragma unroll
  for (int v = 0; v < W; ++v) s[v] = warp_sum(s[v]);
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    float t[W];
#pragma unroll
    for (int v = 0; v < W; ++v) t[v] = __fadd_rn(s[v], s[v ^ o]);
#pragma unroll
    for (int v = 0; v < W; ++v) s[v] = t[v];
  }
  return s[0];
}

// ------------------------------------------------------ the rows kernel

template <typename T, int W, bool kAdd>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ branch,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       T* __restrict__ r, T* __restrict__ y, int rows, int c, float eps,
                       bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // vector v of a lane: values 8 (32 v + lane) .. + 7, masked past the row
  auto on = [&](int v) { return 8 * (32 * v + lane) < c; };
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
  if (row >= rows) return;
  const long long base = row * c + 8 * lane;

  Vec8<T> xv[W], bv[W];  // the row's x and branch
#pragma unroll
  for (int v = 0; v < W; ++v)
    if (on(v)) {
      xv[v].load(x + base + 256 * v, vec);
      if (kAdd) bv[v].load(branch + base + 256 * v, vec);
    } else {
      xv[v].zero();
    }
  const float rcp = rcp_approx(static_cast<float>(c));
  float s[W];
#pragma unroll
  for (int v = 0; v < W; ++v) {
    if (kAdd && on(v)) {
#pragma unroll
      for (int i = 0; i < Vec8<T>::kWords; ++i)
        xv[v].w[i] = add2(xv[v].w[i], bv[v].w[i], static_cast<T*>(nullptr));
      xv[v].store(r + base + 256 * v, vec);
    }
    s[v] = xv[v][0];
#pragma unroll
    for (int k = 1; k < 8; ++k) s[v] = __fadd_rn(s[v], xv[v][k]);
  }
  const float sum = row_sum<W>(s);
  float xc[W][8];
#pragma unroll
  for (int v = 0; v < W; ++v) {
#pragma unroll
    for (int k = 0; k < 8; ++k) xc[v][k] = on(v) ? centre(xv[v][k], sum, rcp) : 0.f;
    s[v] = __fmaf_rn(xc[v][0], xc[v][0], __fmul_rn(xc[v][1], xc[v][1]));
#pragma unroll
    for (int k = 2; k < 8; ++k) s[v] = __fmaf_rn(xc[v][k], xc[v][k], s[v]);
  }
  const float rstd = rstd_of(__fmul_rn(rcp, row_sum<W>(s)), eps);
#pragma unroll
  for (int v = 0; v < W; ++v)
    if (on(v)) {
      const int col = 8 * (32 * v + lane);
      Vec8<T> out;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(gamma + col) + h);
        const float4 b = __ldg(reinterpret_cast<const float4*>(beta + col) + h);
        out.set(4 * h, normalize(xc[v][4 * h], rstd, g.x, b.x));
        out.set(4 * h + 1, normalize(xc[v][4 * h + 1], rstd, g.y, b.y));
        out.set(4 * h + 2, normalize(xc[v][4 * h + 2], rstd, g.z, b.z));
        out.set(4 * h + 3, normalize(xc[v][4 * h + 3], rstd, g.w, b.w));
      }
      out.store(y + base + 256 * v, vec);
    }
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

template <typename T, bool kAdd>
__global__ void __launch_bounds__(kWideThreads)
    ln_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ branch,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       T* __restrict__ r, T* __restrict__ y, int rows, int c, float eps) {
  __shared__ float scratch[kWideThreads / 32];
  const int t = threadIdx.x;
  const float rcp = rcp_approx(static_cast<float>(c));
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = static_cast<long long>(row) * c;
    float v[kWideCols];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kWideCols; ++j) {
      const int col = t + kWideThreads * j;
      v[j] = 0.f;
      if (col < c) {
        T xv = x[base + col];
        if (kAdd) {
          xv = from_float<T>(__fadd_rn(to_float(xv), to_float(branch[base + col])));
          r[base + col] = xv;
        }
        v[j] = to_float(xv);
      }
      s += v[j];
    }
    const float sum = block_sum(s, scratch);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kWideCols; ++j) {
      v[j] = t + kWideThreads * j < c ? centre(v[j], sum, rcp) : 0.f;
      q = __fmaf_rn(v[j], v[j], q);
    }
    const float rstd = rstd_of(__fmul_rn(rcp, block_sum(q, scratch)), eps);
#pragma unroll
    for (int j = 0; j < kWideCols; ++j) {
      const int col = t + kWideThreads * j;
      if (col < c) y[base + col] = from_float<T>(normalize(v[j], rstd, gamma[col], beta[col]));
    }
  }
}

// ------------------------------------------------------------ the host

struct Args {
  const void *x, *branch, *gamma, *beta;
  void *r, *y;
  int rows, c;
  float eps;
};

// The rows kernel's access to a vector (16 bytes where every row pointer is
// aligned to them, else elem bytes a value) and its vectors a lane for C,
// or 0 and 0 where the wide kernel takes it: C a multiple of 8 with
// 128 < C <= 2048. ops/fused_norm.py `fwd_route` mirrors it.
void rows_shape(int c, int elem, int align, int* bytes, int* nv) {
  *bytes = *nv = 0;
  if (c % 8 != 0 || c <= 128 || c > 256 * kMaxW) return;
  int block = 256;
  while (block < c) block *= 2;
  *bytes = align >= 16 ? 16 : elem;
  *nv = block / 256;
}

// the wide kernel's grid: a block a row, at most as many as the SMs hold
template <typename K>
int wide_grid(K kernel, int rows) {
  int device, sms, per_sm = 0;
  if (cudaGetDevice(&device) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, 0))
    return -1;
  return rows < sms * per_sm ? rows : sms * per_sm;
}

// the rows kernel's grid: a block for every kRowWarps rows
int rows_grid(int rows) { return (rows + kRowWarps - 1) / kRowWarps; }

template <typename T, int W, bool kAdd>
cudaError_t launch_rows(const Args& a, int blocks, bool vec, cudaStream_t s) {
  ln_fwd_rows_kernel<T, W, kAdd><<<blocks, 32 * kRowWarps, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.branch),
      static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<T*>(a.r), static_cast<T*>(a.y), a.rows, a.c, a.eps, vec);
  return cudaGetLastError();
}
template <typename T, bool kAdd>
cudaError_t launch_wide(const Args& a, int blocks, cudaStream_t s) {
  ln_fwd_wide_kernel<T, kAdd><<<blocks, kWideThreads, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.branch),
      static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<T*>(a.r), static_cast<T*>(a.y), a.rows, a.c, a.eps);
  return cudaGetLastError();
}

// One entry for planning (a == nullptr: the blocks into *blocks) and
// launching (the blocks given): the kernel instance for (dtype, C,
// alignment, add).
template <typename T, bool kAdd>
cudaError_t dispatch(const Args* a, int rows, int c, int align, int* blocks, cudaStream_t s) {
  int bytes, nv;
  rows_shape(c, sizeof(T), align, &bytes, &nv);
  const bool vec = bytes == 16;
  int planned = -1;
#define MMLEARN_ROWS(N)                                                    \
  if (nv == N) {                                                           \
    if (a != nullptr) return launch_rows<T, N, kAdd>(*a, *blocks, vec, s); \
    planned = rows_grid(rows);                                             \
  } else
  MMLEARN_ROWS(1) MMLEARN_ROWS(2) MMLEARN_ROWS(4) MMLEARN_ROWS(8) {
    if (a != nullptr) return launch_wide<T, kAdd>(*a, *blocks, s);
    planned = wide_grid(ln_fwd_wide_kernel<T, kAdd>, rows);
  }
#undef MMLEARN_ROWS
  if (planned < 1) return cudaErrorInvalidConfiguration;
  *blocks = planned;
  return cudaSuccess;
}

cudaError_t route(const Args* a, int rows, int c, int dtype, bool has_add, int align,
                  int* blocks, cudaStream_t s) {
  if (rows < 1 || c < 1 || c > kMaxC) return cudaErrorInvalidValue;
  if (dtype == 0)
    return has_add ? dispatch<float, true>(a, rows, c, align, blocks, s)
                   : dispatch<float, false>(a, rows, c, align, blocks, s);
  if (dtype == 1)
    return has_add ? dispatch<bf16, true>(a, rows, c, align, blocks, s)
                   : dispatch<bf16, false>(a, rows, c, align, blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The forward of (rows, c) in dtype (0 = float32, 1 = bfloat16), with
// (has_add) or without the residual add: the rows kernel's bytes an access
// and vectors a lane into *bytes and *nv (0 and 0: the wide kernel), and
// the blocks it launches into *blocks. align: the largest of 16, 8, 4, 1
// that divides every row pointer (x, branch, r, y, in bytes). Returns 0, or
// a cudaError_t.
int mmlearn_ln_fwd_plan(int rows, int c, int dtype, int has_add, int align, int* bytes, int* nv,
                        int* blocks) {
  *bytes = *nv = 0;
  if (dtype == 0 || dtype == 1) rows_shape(c, dtype == 0 ? 4 : 2, align, bytes, nv);
  return static_cast<int>(route(nullptr, rows, c, dtype, has_add != 0, align, blocks, nullptr));
}

// x, branch (or null), r (null without branch), y: (rows, c) row-major;
// gamma, beta: c float32, 16-byte aligned. Launches the planned blocks on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).
int mmlearn_ln_fwd(const void* x, const void* branch, const void* gamma, const void* beta,
                   void* r, void* y, int rows, int c, int dtype, int align, int blocks, float eps,
                   void* stream) {
  const Args a{x, branch, gamma, beta, r, y, rows, c, eps};
  return static_cast<int>(route(&a, rows, c, dtype, branch != nullptr, align, &blocks,
                                static_cast<cudaStream_t>(stream)));
}

const char* mmlearn_ln_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
