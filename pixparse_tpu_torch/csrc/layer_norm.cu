// LayerNorm forward and backward for Hopper (sm_90a), bound through plain C
// entry points (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernels
//   pixparse_tpu/ops/layer_norm.py::_fwd_kernel   (one-pass LN, fp32 stats)
//   pixparse_tpu/ops/layer_norm.py::_bwd_kernel   (dx, dscale, dbias)
// over rows of width D:
//   forward:  mu = mean(x), var = mean((x - mu)^2), xhat = (x - mu) rsqrt(var + eps)
//             y = xhat * w + b                      written in x's dtype
//   backward: dxh = dy * w, m1 = mean(dxh), m2 = mean(dxh * xhat)
//             dx = rstd * (dxh - m1 - xhat * m2)    written in x's dtype
//             dw = sum_rows dy * xhat, db = sum_rows dy   fp32
// No statistics are saved: the backward recomputes them from x, as the TPU
// kernel does.
//
// What bounds it on an H100: a few operations per element against the
// element's bytes, far below the ~295 FLOP/byte ridge: the bytes of x and y
// (forward) or x, dy and dx (backward), each read or written once.
//
// What the forward does about it (it reads x once and writes y once):
// - one wave of persistent blocks (SMs x the kernel's own occupancy; plan:
//   ops/layer_norm.py::layer_norm_plan), so no block pays its start-up
//   for a few rows. Block i walks row groups i, i + n_blocks, ... : at any
//   moment the blocks read one stretch of x, and that was faster than the
//   backward's contiguous ranges at all eight shapes of a donut step (1-5%,
//   H100 by the busy timer, variants built and timed in turns in one run);
// - a row takes TR threads, the backward's shape: D / 8 rounded up to a
//   power of two, at most 32, so narrow rows share a warp (16 lanes a row
//   at D = 128, no lane idle); above D = 512 64 to 256 threads, their sums
//   exchanged behind a named barrier of the row's warps; each thread takes
//   U rows of a group at once;
// - the next group's x is in flight while the current group is reduced:
//   each thread loads its share of it into registers as raw 16-byte vectors
//   before the current group's two reductions (register double-buffering);
//   y is stored from registers as 16-byte vectors. Measured no better in the
//   same runs: the backward's bulk-copy ring (4 stages; equal at the wide
//   shapes, 11% slower at (3070, 1024)), prefetching two groups ahead,
//   holding the rows raw instead of as floats, 3 or 4 blocks per SM (spills)
//   and twice the rows a thread. What is left is near x.clone()'s time on
//   the same rows (1.03-1.07x; PERF.md);
// - a thread's columns are the same in every row, so its columns of w and b
//   are loaded once per block and stay in registers.
//
// What the backward does about it:
// - one wave of persistent blocks (SMs x the kernel's own occupancy; plan:
//   ops/layer_norm.py::layer_norm_plan), each walking a contiguous range
//   of row groups. One thread keeps the next groups' x and dy in flight by
//   1-D bulk copies (a group is G whole rows, one contiguous run of bytes)
//   through a 3-stage mbarrier ring of <= 16 KB per operand, so the loads of
//   the next groups overlap the current group's reductions;
// - a row takes TR threads, a power of two: D / 8 rounded up, at most 32,
//   so narrow rows share a warp (16 lanes a row at D = 128, no lane idle);
//   wider rows take K = 2 chunks of 8 a thread and 64 to 256 threads (2 to 8
//   warps, their sums exchanged through shared memory behind a named barrier
//   of the row's warps); each thread takes U rows of a group at once (U * K
//   <= 4 in bf16, 2 in fp32), for independent work between the reductions;
// - each thread's columns are the same in every row, so it sums dy * xhat
//   and dy for them in registers over all its rows; the block adds its row
//   slots' sums once, in a fixed order, into one fp32 partial, and a second
//   kernel of 2D / 32 blocks sums the ~SMs x occupancy partials column by
//   column, again in a fixed order: deterministic, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using pixparse::smem_addr;
using namespace pixparse::hopper;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

constexpr int kThreads = 256;  // both row kernels

// A row takes TR threads (a power of two), each K chunks of 8 columns; each
// thread takes U rows of a group of G = (256 / TR) * U rows.
template <typename T, int TR, int K>
struct RowShape {
  static constexpr int kU = (sizeof(T) == 2 ? 4 : 2) / K > 0 ? (sizeof(T) == 2 ? 4 : 2) / K : 1;
  static constexpr int kSlots = kThreads / TR;  // rows at once
  static constexpr int kGroup = kSlots * kU;
  static constexpr int kRowWarps = TR > 32 ? TR / 32 : 1;
  static constexpr int kMinBlocks = K * kU <= 4 && K <= 2 ? 2 : 1;  // the backward's
};

// Sum of NV values over a row's TR threads: shuffles inside the warp, then
// (TR > 32) the row's warps in a fixed order through `red` ([slots][NV][row
// warps]) behind a named barrier of the row's threads (id 1 + slot).
template <int TR, int NV>
__device__ __forceinline__ void row_reduce(float (&v)[NV], float* red) {
  constexpr int kWidth = TR < 32 ? TR : 32;
#pragma unroll
  for (int s = kWidth / 2; s > 0; s >>= 1)
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], s);
  if constexpr (TR > 32) {
    constexpr int kW = TR / 32;
    const int slot = threadIdx.x / TR, wr = (threadIdx.x / 32) % kW;
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int j = 0; j < NV; ++j) red[(slot * NV + j) * kW + wr] = v[j];
    named_bar_sync(1 + slot, TR);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kW; ++i) sum += red[(slot * NV + j) * kW + i];
      v[j] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Eight elements of T as loaded: one 16-byte vector in bf16, two in fp32.
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load_raw8(const T* p, Raw8<T>& r) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
    r.u[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);  // read once: streaming
}

__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r, float (&f)[8]) {
  const uint4 u = r.u[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(r.u[i].x);
    f[4 * i + 1] = __uint_as_float(r.u[i].y);
    f[4 * i + 2] = __uint_as_float(r.u[i].z);
    f[4 * i + 3] = __uint_as_float(r.u[i].w);
  }
}

// Block i takes groups i, i + n_blocks, i + 2 n_blocks, ...
// (ops/layer_norm.py::layer_norm_fwd_groups).
template <typename T, int TR, int K>
__global__ void __launch_bounds__(kThreads, 2)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y, int R, int D, float eps) {
  using Shape = RowShape<T, TR, K>;
  constexpr int U = Shape::kU, P = Shape::kSlots, G = Shape::kGroup;
  __shared__ float red[2][P * U * Shape::kRowWarps];
  const int tid = threadIdx.x, slot = tid / TR, lane_r = tid % TR;
  const int n_chunks = D / 8;
  const long long n_groups = (R + G - 1) / G;
  const int n_mine = static_cast<int>((n_groups - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // the block's g-th group
  auto row0_of = [&](int g) { return (static_cast<long long>(g) * gridDim.x + blockIdx.x) * G; };

  float wv[K][8], bv[K][8];  // this thread's columns: the same in every row
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = lane_r + TR * i;
    if (c < n_chunks) {
      load8(w + c * 8, wv[i]);
      load8(b + c * 8, bv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) wv[i][e] = bv[i][e] = 0.f;
    }
  }
  Raw8<T> next[U][K];  // the next group's x, as loaded
  auto fetch = [&](int g) {
    const long long row0 = row0_of(g);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = row0 + slot + P * u;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = lane_r + TR * i;
        if (row < R && c < n_chunks) load_raw8(x + row * D + c * 8, next[u][i]);
      }
    }
  };
  if (n_mine > 0) fetch(0);
  for (int g = 0; g < n_mine; ++g) {
    const long long row0 = row0_of(g);
    float v[U][K][8], sum[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = row0 + slot + P * u < R;  // rows past R: zeros, stored nowhere
      sum[u] = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (live && lane_r + TR * i < n_chunks) {
          unpack8(next[u][i], v[u][i]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[u][i][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[u] += v[u][i][e];
      }
    }
    if (g + 1 < n_mine) fetch(g + 1);  // in flight through this group's reductions
    row_reduce<TR, U>(sum, red[0]);
    float mu[U], sq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mu[u] = sum[u] / D;
      sq[u] = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (lane_r + TR * i < n_chunks) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[u][i][e] - mu[u];
            sq[u] += d * d;
          }
        }
      }
    }
    row_reduce<TR, U>(sq, red[1]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = row0 + slot + P * u;
      if (row >= R) continue;
      const float rstd = rsqrtf(sq[u] / D + eps);
      T* yr = y + row * D;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = lane_r + TR * i;
        if (c >= n_chunks) continue;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = (v[u][i][e] - mu[u]) * rstd * wv[i][e] + bv[i][e];
        store8(yr + c * 8, o);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdStages = 3;
constexpr int kSumCols = 32;      // columns per block of the partial-sum kernel
constexpr int kSumThreads = 1024;  // its warps split the partials

// Groups [n_groups * i / n_blocks, n_groups * (i + 1) / n_blocks) for block i
// (ops/layer_norm.py::layer_norm_bwd_row_ranges mirrors it). The block's
// sums of dy * xhat and dy go to partial[blockIdx.x] ([2][D]).
template <typename T, int TR, int K>
__global__ void __launch_bounds__(kThreads, (RowShape<T, TR, K>::kMinBlocks))
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ partial, int R, int D, float eps) {
  using Shape = RowShape<T, TR, K>;
  constexpr int U = Shape::kU, P = Shape::kSlots, G = Shape::kGroup;
  constexpr int kRedFloats = P * 2 * U * Shape::kRowWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kBwdStages];
  __shared__ float red[3][kRedFloats];
  const int tid = threadIdx.x, slot = tid / TR, lane_r = tid % TR;
  const int n_chunks = D / 8;
  const long long n_groups = (R + G - 1) / G;
  const int g0 = static_cast<int>(n_groups * blockIdx.x / gridDim.x);
  const int n_local = static_cast<int>(n_groups * (blockIdx.x + 1) / gridDim.x) - g0;
  const int tile = G * D * static_cast<int>(sizeof(T));  // bytes of one operand a stage
  const uint32_t base = smem_addr(smem), bar0 = smem_addr(bars);
  auto xs = [&](int s) { return reinterpret_cast<const T*>(smem + 2 * s * tile); };
  auto gs = [&](int s) { return reinterpret_cast<const T*>(smem + (2 * s + 1) * tile); };

  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int j) {  // one thread: group g0 + j into stage j % kBwdStages
    const int s = j % kBwdStages;
    const long long row0 = static_cast<long long>(g0 + j) * G;
    const uint32_t bytes = static_cast<uint32_t>(min(static_cast<long long>(G), R - row0) * D *
                                                 static_cast<long long>(sizeof(T)));
    mbar_expect_tx(bar0 + 8 * s, 2 * bytes);
    bulk_load(base + 2 * s * tile, x + row0 * D, bytes, bar0 + 8 * s);
    bulk_load(base + (2 * s + 1) * tile, dy + row0 * D, bytes, bar0 + 8 * s);
  };
  if (tid == 0)
    for (int j = 0; j < kBwdStages && j < n_local; ++j) issue(j);

  float acc_w[K][8], acc_b[K][8];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_w[i][e] = acc_b[i][e] = 0.f;

  for (int j = 0; j < n_local; ++j) {
    const int s = j % kBwdStages;
    mbar_wait(bar0 + 8 * s, (j / kBwdStages) & 1);
    const long long row0 = static_cast<long long>(g0 + j) * G;
    float v[U][K][8], g[U][K][8];
    float sum[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = slot + P * u;
      const bool live = row0 + rr < R;  // rows past R: zeros, which add nothing
      sum[u] = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = lane_r + TR * i;
        if (live && c < n_chunks) {
          load8(xs(s) + rr * D + c * 8, v[u][i]);
          load8(gs(s) + rr * D + c * 8, g[u][i]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[u][i][e] = g[u][i][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[u] += v[u][i][e];
      }
    }
    row_reduce<TR, U>(sum, red[0]);
    float mu[U], sq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mu[u] = sum[u] / D;
      sq[u] = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (lane_r + TR * i < n_chunks) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[u][i][e] - mu[u];
            sq[u] += d * d;
          }
        }
      }
    }
    row_reduce<TR, U>(sq, red[1]);
    // xhat in place of x, dy * w in place of dy; dweight/dbias in registers;
    // the means of dxh and dxh * xhat
    float rstd[U], m[2 * U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rstd[u] = rsqrtf(sq[u] / D + eps);
      m[2 * u] = m[2 * u + 1] = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = lane_r + TR * i;
        if (c >= n_chunks) continue;
        float wv[8];
        load8(w + c * 8, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (v[u][i][e] - mu[u]) * rstd[u];
          const float dxh = g[u][i][e] * wv[e];
          acc_w[i][e] += g[u][i][e] * xh;
          acc_b[i][e] += g[u][i][e];
          v[u][i][e] = xh;
          g[u][i][e] = dxh;
          m[2 * u] += dxh;
          m[2 * u + 1] += dxh * xh;
        }
      }
    }
    row_reduce<TR, 2 * U>(m, red[2]);
    __syncthreads();  // stage s is free: the next group's loads go out now
    if (tid == 0 && j + kBwdStages < n_local) issue(j + kBwdStages);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = row0 + slot + P * u;
      if (row >= R) continue;
      const float m1 = m[2 * u] / D, m2 = m[2 * u + 1] / D;
      T* dxr = dx + row * D;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = lane_r + TR * i;
        if (c >= n_chunks) continue;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = rstd[u] * (g[u][i][e] - m1 - v[u][i][e] * m2);
        store8(dxr + c * 8, o);
      }
    }
  }

  // the block's row slots summed in order (the ring is free: every group
  // issued was waited for); the partial-sum grid may launch now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);  // [P][2][D]
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = lane_r + TR * i;
    if (c >= n_chunks) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sums[slot * 2 * D + c * 8 + e] = acc_w[i][e];
      sums[slot * 2 * D + D + c * 8 + e] = acc_b[i][e];
    }
  }
  __syncthreads();
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * D;
  for (int col = tid; col < 2 * D; col += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) t += sums[p * 2 * D + col];
    out[col] = t;
  }
}

// dw (the first D) and db (the next D) = the sum of the n_blocks partials:
// a block per 32 columns, warp w summing partials w, w + 32, ... in order,
// then the 32 warps' sums in order. Launched as the row kernel's
// programmatic dependent: it waits for that grid's memory here.
__global__ void __launch_bounds__(kSumThreads) ln_partial_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, float* __restrict__ db,
    int n_blocks, int D) {
  constexpr int kW = kSumThreads / 32;
  __shared__ float part[kW][kSumCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * kSumCols + lane;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float s = 0.f;
  if (col < 2 * D) {
#pragma unroll 4
    for (int i = warp; i < n_blocks; i += kW) s += partial[static_cast<long long>(i) * 2 * D + col];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= 2 * D) return;
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kW; ++i) t += part[i][lane];
  if (col < D) dw[col] = t;
  else db[col - D] = t;
}

struct FwdLaunch {
  const void* x;
  const float *w, *b;
  void* y;
  int R, D, n_blocks;
  float eps;
  cudaStream_t stream;
  template <typename T, int TR, int K>
  int run() const {
    constexpr int G = RowShape<T, TR, K>::kGroup;
    if (n_blocks > (R + G - 1) / G) return static_cast<int>(cudaErrorInvalidValue);
    ln_fwd_kernel<T, TR, K><<<n_blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, b, static_cast<T*>(y), R, D, eps);
    return static_cast<int>(cudaGetLastError());
  }
};

// Blocks of the forward kernel for width D that one SM holds at once.
struct FwdOccupancy {
  template <typename T, int TR, int K>
  int run() const {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ln_fwd_kernel<T, TR, K>, kThreads, 0) !=
        cudaSuccess)
      return 0;
    return n;
  }
};

template <typename T, int TR, int K>
size_t bwd_smem(int D) {
  return static_cast<size_t>(kBwdStages) * 2 * RowShape<T, TR, K>::kGroup * D * sizeof(T);
}

template <typename T, int TR, int K>
cudaError_t bwd_prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(ln_bwd_kernel<T, TR, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct BwdLaunch {
  const void* x;
  const float* w;
  const void* dy;
  void* dx;
  float *partial, *dw, *db;
  int R, D, n_blocks;
  float eps;
  cudaStream_t stream;
  template <typename T, int TR, int K>
  int run() const {
    constexpr int G = RowShape<T, TR, K>::kGroup;
    if (n_blocks > (R + G - 1) / G) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = bwd_smem<T, TR, K>(D);
    const cudaError_t err = bwd_prepare<T, TR, K>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ln_bwd_kernel<T, TR, K><<<n_blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), w, static_cast<const T*>(dy), static_cast<T*>(dx), partial, R, D,
        eps);
    // the partial sums launch while the row kernel's last blocks run
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((2 * D + kSumCols - 1) / kSumCols);
    cfg.blockDim = dim3(kSumThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, ln_partial_sum_kernel,
                                             static_cast<const float*>(partial), dw, db, n_blocks, D);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
};

// Blocks of the backward kernel for width D that one SM holds at once.
struct BwdOccupancy {
  int D;
  template <typename T, int TR, int K>
  int run() const {
    const size_t smem = bwd_smem<T, TR, K>(D);
    if (bwd_prepare<T, TR, K>(smem) != cudaSuccess) return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ln_bwd_kernel<T, TR, K>, kThreads,
                                                      smem) != cudaSuccess)
      return 0;
    return n;
  }
};

// Both row kernels' (TR, K) for width D (ops/layer_norm.py::layer_norm_config
// mirrors it): TR = D / 8 rounded up to a power of two, at most 32; doubled
// while a thread would hold more than 2 chunks, up to 256; K = 4 beyond.
template <typename T, typename Launch>
int dispatch(int D, const Launch& l) {
  const int n = D / 8;
  int tr = 1;
  while (tr < n && tr < 32) tr *= 2;
  while ((n + tr - 1) / tr > 2 && tr < 256) tr *= 2;
  const int k = (n + tr - 1) / tr;
  switch (tr) {
    case 1: return l.template run<T, 1, 1>();
    case 2: return l.template run<T, 2, 1>();
    case 4: return l.template run<T, 4, 1>();
    case 8: return l.template run<T, 8, 1>();
    case 16: return l.template run<T, 16, 1>();
    case 32: return k == 1 ? l.template run<T, 32, 1>() : l.template run<T, 32, 2>();
    case 64: return l.template run<T, 64, 2>();
    case 128: return l.template run<T, 128, 2>();
    default: return k <= 2 ? l.template run<T, 256, 2>() : l.template run<T, 256, 4>();
  }
}

bool width_ok(int D) { return D > 0 && D % 8 == 0 && D <= 8192; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). x and y are
// contiguous (R, D) matrices, 16-byte aligned, w and b (D,) fp32; D a
// multiple of 8 up to 8192. n_blocks from ops/layer_norm.py::
// layer_norm_plan (1 .. the row groups of R). Returns the CUDA error
// code of the launch (0 = success).
extern "C" int pixparse_layer_norm_fwd(int dtype, const void* x, const void* w, const void* b,
                                       void* y, int R, int D, int n_blocks, float eps,
                                       void* stream) {
  if (R < 0 || !width_ok(D) || (R > 0 && n_blocks <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const FwdLaunch l{x, static_cast<const float*>(w), static_cast<const float*>(b), y, R, D,
                    n_blocks, eps, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, l);
  if (dtype == 0) return dispatch<float>(D, l);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the forward kernel for (dtype, D) one SM holds at once (its
// registers); 0 on error.
extern "C" int pixparse_layer_norm_fwd_blocks_per_sm(int dtype, int D) {
  if (!width_ok(D)) return 0;
  const FwdOccupancy l{};
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, l);
  if (dtype == 0) return dispatch<float>(D, l);
  return 0;
}

// As above, plus dy (R, D) in x's dtype; outputs dx (R, D) in x's dtype and
// dw, db (D,) fp32. x and dy 16-byte aligned (their row groups are bulk
// copies). partial is (n_blocks, 2, D) fp32 scratch; n_blocks from
// ops/layer_norm.py::layer_norm_plan (1 .. the row groups of R).
extern "C" int pixparse_layer_norm_bwd(int dtype, const void* x, const void* w, const void* dy,
                                       void* dx, void* partial, void* dw, void* db, int R, int D,
                                       int n_blocks, float eps, void* stream) {
  if (R <= 0 || !width_ok(D) || n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdLaunch l{x, static_cast<const float*>(w), dy, dx, static_cast<float*>(partial),
                    static_cast<float*>(dw), static_cast<float*>(db), R, D, n_blocks, eps,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, l);
  if (dtype == 0) return dispatch<float>(D, l);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the backward kernel for (dtype, D) one SM holds at once (its
// registers and shared memory); 0 on error.
extern "C" int pixparse_layer_norm_bwd_blocks_per_sm(int dtype, int D) {
  if (!width_ok(D)) return 0;
  const BwdOccupancy l{D};
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, l);
  if (dtype == 0) return dispatch<float>(D, l);
  return 0;
}
