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
// What the design does about it:
// - a row lives in registers: one warp per row up to D = 2048 (each lane
//   holds K chunks of 8 elements, read and written as 16-byte vectors), S = 2
//   or 4 warps per row up to D = 8192; the statistics are two-pass in fp32
//   (the mean, then the centred sum of squares), as in the TPU kernel, and
//   reduced by warp shuffles (and a fixed-order sum across the row's warps);
// - the TPU backward adds dscale/dbias into one output block across its
//   sequential grid; here each block sums its rows into shared memory (each
//   column of a row group has one owning thread), writes one fp32 partial,
//   and a second small kernel sums the partials column by column in a fixed
//   order: deterministic, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBwdBlocks = 1024;
constexpr int kReduceThreads = 256;

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

// Sum of `NV` values over the row: the warp's lanes, then (S > 1) the row's
// S warps in a fixed order through `red` ([NV][kWarps]). Every thread of the
// block must call it (it holds barriers when S > 1).
template <int S, int NV>
__device__ __forceinline__ void row_sum(float (&v)[NV], float* red) {
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], s);
  if (S == 1) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous call's readers are done
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < NV; ++j) red[j * kWarps + warp] = v[j];
  __syncthreads();
  const int first = (warp / S) * S;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < S; ++i) sum += red[j * kWarps + first + i];
    v[j] = sum;
  }
}

// Chunk (8 elements) i of this thread's share of a row.
template <int S>
__device__ __forceinline__ int chunk_of(int i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return lane + 32 * ((warp % S) + S * i);
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads) ln_fwd_kernel(const T* __restrict__ x,
                                                          const float* __restrict__ w,
                                                          const float* __restrict__ b,
                                                          T* __restrict__ y, int R, int D,
                                                          float eps) {
  constexpr int kRows = kWarps / S;  // rows per block
  __shared__ float red[kWarps];
  const int row = blockIdx.x * kRows + (threadIdx.x / 32) / S;
  const bool live = row < R;  // no early return: S > 1 holds barriers
  const int n_chunks = D / 8;
  const T* xr = x + (long long)row * D;
  float v[K][8];
  float sum[1] = {0.f};
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = chunk_of<S>(i);
    if (live && c < n_chunks) {
      load8(xr + c * 8, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[0] += v[i][e];
  }
  row_sum<S, 1>(sum, red);
  const float mu = sum[0] / D;
  float sq[1] = {0.f};
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (chunk_of<S>(i) < n_chunks) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mu;
        sq[0] += d * d;
      }
    }
  }
  row_sum<S, 1>(sq, red);
  const float rstd = rsqrtf(sq[0] / D + eps);
  if (!live) return;  // the last barrier is behind every thread
  T* yr = y + (long long)row * D;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = chunk_of<S>(i);
    if (c >= n_chunks) continue;
    float wv[8], bv[8], o[8];
    load8(w + c * 8, wv);
    load8(b + c * 8, bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = (v[i][e] - mu) * rstd * wv[e] + bv[e];
    store8(yr + c * 8, o);
  }
}

// Rows blockIdx.x * kRows + r, stepping gridDim.x * kRows; the block's sums
// of dy * xhat and dy go to shared memory ([kRows][2][D] fp32), then to
// partial[blockIdx.x] ([2][D]).
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ partial, int R, int D, float eps) {
  constexpr int kRows = kWarps / S;
  extern __shared__ float acc[];
  __shared__ float red[2 * kWarps];
  for (int i = threadIdx.x; i < kRows * 2 * D; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const int rgrp = (threadIdx.x / 32) / S;
  float* acc_w = acc + rgrp * 2 * D;
  float* acc_b = acc_w + D;
  const int n_chunks = D / 8;
  for (int row0 = blockIdx.x * kRows; row0 < R; row0 += gridDim.x * kRows) {  // uniform
    const int row = row0 + rgrp;
    const bool live = row < R;
    const T* xr = x + (long long)row * D;
    const T* gr = dy + (long long)row * D;
    float v[K][8], g[K][8];
    float sum[1] = {0.f};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int c = chunk_of<S>(i);
      if (live && c < n_chunks) {
        load8(xr + c * 8, v[i]);
        load8(gr + c * 8, g[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = g[i][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[0] += v[i][e];
    }
    row_sum<S, 1>(sum, red);
    const float mu = sum[0] / D;
    float sq[1] = {0.f};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (chunk_of<S>(i) < n_chunks) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[i][e] - mu;
          sq[0] += d * d;
        }
      }
    }
    row_sum<S, 1>(sq, red);
    const float rstd = rsqrtf(sq[0] / D + eps);
    // xhat in place of x; the means of dxh and dxh * xhat
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int c = chunk_of<S>(i);
      if (c >= n_chunks) continue;
      float wv[8];
      load8(w + c * 8, wv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = (v[i][e] - mu) * rstd;
        const float dxh = g[i][e] * wv[e];
        m[0] += dxh;
        m[1] += dxh * v[i][e];
      }
    }
    row_sum<S, 2>(m, red);
    const float m1 = m[0] / D, m2 = m[1] / D;
    if (live) {
      T* dxr = dx + (long long)row * D;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = chunk_of<S>(i);
        if (c >= n_chunks) continue;
        float wv[8], o[8];
        load8(w + c * 8, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = rstd * (g[i][e] * wv[e] - m1 - v[i][e] * m2);
          acc_w[c * 8 + e] += g[i][e] * v[i][e];  // one owning thread per column
          acc_b[c * 8 + e] += g[i][e];
        }
        store8(dxr + c * 8, o);
      }
    }
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * 2 * D;
  for (int col = threadIdx.x; col < 2 * D; col += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += acc[r * 2 * D + col];
    out[col] = s;
  }
}

// dw (the first D) and db (the next D) = sum over the blocks' partials.
__global__ void __launch_bounds__(kReduceThreads) ln_partial_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, float* __restrict__ db,
    int n_blocks, int D) {
  const int col = blockIdx.x * kReduceThreads + threadIdx.x;
  if (col >= 2 * D) return;
  float s = 0.f;
  for (int i = 0; i < n_blocks; ++i) s += partial[(long long)i * 2 * D + col];
  if (col < D) dw[col] = s;
  else db[col - D] = s;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T, int K, int S>
int launch_fwd(const void* x, const float* w, const float* b, void* y, int R, int D, float eps,
               cudaStream_t stream) {
  constexpr int kRows = kWarps / S;
  ln_fwd_kernel<T, K, S><<<(R + kRows - 1) / kRows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), R, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, int S>
int launch_bwd(const void* x, const float* w, const void* dy, void* dx, float* partial, float* dw,
               float* db, int R, int D, int n_blocks, float eps, cudaStream_t stream) {
  constexpr int kRows = kWarps / S;
  const size_t smem = sizeof(float) * kRows * 2 * D;
  const int err = allow_smem(ln_bwd_kernel<T, K, S>, smem);
  if (err) return err;
  ln_bwd_kernel<T, K, S><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(dy), static_cast<T*>(dx), partial, R, D,
      eps);
  ln_partial_reduce_kernel<<<(2 * D + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                             stream>>>(partial, dw, db, n_blocks, D);
  return static_cast<int>(cudaGetLastError());
}

struct FwdLaunch {
  const void* x;
  const float *w, *b;
  void* y;
  int R, D;
  float eps;
  cudaStream_t stream;
  template <typename T, int K, int S>
  int run() const {
    return launch_fwd<T, K, S>(x, w, b, y, R, D, eps, stream);
  }
};

struct BwdLaunch {
  const void* x;
  const float* w;
  const void* dy;
  void* dx;
  float *partial, *dw, *db;
  int R, D, n_blocks;
  float eps;
  cudaStream_t stream;
  template <typename T, int K, int S>
  int run() const {
    return launch_bwd<T, K, S>(x, w, dy, dx, partial, dw, db, R, D, n_blocks, eps, stream);
  }
};

// The (K, S) shape for width D: K chunks of 8 per lane, S warps per row.
template <typename T, typename Launch>
int dispatch(int D, const Launch& l) {
  const int per_lane = (D / 8 + 31) / 32;
  if (per_lane <= 1) return l.template run<T, 1, 1>();
  if (per_lane <= 2) return l.template run<T, 2, 1>();
  if (per_lane <= 4) return l.template run<T, 4, 1>();
  if (per_lane <= 8) return l.template run<T, 8, 1>();
  if (per_lane <= 16) return l.template run<T, 8, 2>();
  return l.template run<T, 8, 4>();
}

bool width_ok(int D) { return D > 0 && D % 8 == 0 && D <= 8192; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). x and y are
// contiguous (R, D) matrices, w and b (D,) fp32; D a multiple of 8 up to
// 8192. Returns the CUDA error code of the launch (0 = success).
extern "C" int pixparse_layer_norm_fwd(int dtype, const void* x, const void* w, const void* b,
                                       void* y, int R, int D, float eps, void* stream) {
  if (R < 0 || !width_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const FwdLaunch l{x, static_cast<const float*>(w), static_cast<const float*>(b), y, R, D, eps,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, l);
  if (dtype == 0) return dispatch<float>(D, l);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, plus dy (R, D) in x's dtype; outputs dx (R, D) in x's dtype and
// dw, db (D,) fp32. partial is (n_blocks, 2, D) fp32 scratch, 1 <= n_blocks
// <= 1024 (pixparse_layer_norm_bwd_blocks gives the count the launch uses).
extern "C" int pixparse_layer_norm_bwd(int dtype, const void* x, const void* w, const void* dy,
                                       void* dx, void* partial, void* dw, void* db, int R, int D,
                                       int n_blocks, float eps, void* stream) {
  if (R <= 0 || !width_ok(D) || n_blocks <= 0 || n_blocks > kMaxBwdBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdLaunch l{x, static_cast<const float*>(w), dy, dx, static_cast<float*>(partial),
                    static_cast<float*>(dw), static_cast<float*>(db), R, D, n_blocks, eps,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, l);
  if (dtype == 0) return dispatch<float>(D, l);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's block count for R rows: about one block per 4 rows, at most
// 1024 (each block then walks its rows with a stride).
extern "C" int pixparse_layer_norm_bwd_blocks(int R) {
  const int n = (R + kWarps - 1) / kWarps;
  return n < 1 ? 1 : (n > kMaxBwdBlocks ? kMaxBwdBlocks : n);
}
