// Single-token decode attention over int8 (B, Lk, H*D) KV caches for Hopper
// (sm_90a), bound through a plain C entry point (ctypes; see
// pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/decode_attention.py::_decode_attn_q8_kernel
// with its exact semantics, per (sample, head):
//   q_i8, qs = quantize(q)                       (absmax / 127, half to even)
//   s   = (int32(q_i8 . k_i8[j]) * qs) * (k_scale[j] * Dh^-0.5)
//   p   = masked softmax of s (fully masked rows give p = 0)
//   pv_i8, ps = quantize(p * v_scale)            over the head's whole row
//   o   = int32(sum_j pv_i8[j] * v_i8[j]) * ps
// Both integer products are exact int32 sums.
//
// What bounds it on an H100: a step reads each valid key's int8 K and V row
// (2 bytes per cache element) and two fp32 scales, and does ~4 integer
// operations per element: it is bound by those bytes at 3.35 TB/s (cruller_base
// cross cache at B = 16: 26.3 MB with the scales, 7.9 us).
//
// What the design does about it: the quantization of p * v_scale needs the
// head's global row max of p * v_scale, so a split over the keys (as the bf16
// kernel does) would need a second pass. Instead one block of 8 warps owns a
// (sample, head) pair and keeps the head's whole score row in shared memory
// (Lk fp32 + Lk int8: 24 KB at Lk = 4864):
// - q is quantized by one warp; each thread then takes keys j = tid,
//   tid + 256, ...: a masked key is not read, a valid one is one 16-byte
//   vector load per 16 bytes of its head row (8 loads in flight per thread),
//   dotted with __dp4a;
// - block reductions give the row max, the sum, the max of p * v_scale and
//   the last key with a non-zero pv_i8; p * v_scale is quantized in shared
//   memory;
// - p v: each thread owns a 16-byte column chunk of the head row and a
//   stripe of keys up to that last key (8 rows in flight), accumulates 16
//   int32 sums, and the stripes are summed through shared memory.
// B * H blocks (128 at donut_base B = 8) is fewer than four per SM; this is
// the simple first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Block-wide max / sum; `red` holds kWarps floats. Every thread gets the result.
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  return r;
}

// Symmetric int8 quantization with the scale of a row whose absmax is `am`.
__device__ __forceinline__ float q8_scale(float am) { return (am > 0.f ? am : 127.f) / 127.f; }
__device__ __forceinline__ int q8(float x, float scale) {
  return static_cast<int>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attn_q8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const uint8_t* __restrict__ mask, T* __restrict__ o, int H, int Lk, long long q_bs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale) {
  constexpr int kChunks = D / 16;                 // 16-byte chunks of a head row
  constexpr int kStripes = kThreads / kChunks;    // key stripes in p v
  extern __shared__ __align__(16) unsigned char smem[];
  int* red_i = reinterpret_cast<int*>(smem);     // kStripes x D int32 partial sums
  float* s_row = reinterpret_cast<float*>(red_i + kStripes * D);  // Lk scores, then p * vs
  int8_t* pv_row = reinterpret_cast<int8_t*>(s_row + Lk);
  __shared__ float red[kWarps];
  __shared__ __align__(16) int8_t q_i8[D];
  __shared__ float q_scale;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* ks = k_scale + ((long long)b * H + h) * Lk;
  const float* vs = v_scale + ((long long)b * H + h) * Lk;
  const uint8_t* mrow = mask + (long long)b * Lk;

  // q of this head -> int8 (one warp)
  if (tid < 32) {
    constexpr int kPer = D / 32;
    float x[kPer];
    float am = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      x[i] = to_float(q[(long long)b * q_bs + h * D + tid * kPer + i]);
      am = fmaxf(am, fabsf(x[i]));
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, s));
    const float qs = q8_scale(am);
#pragma unroll
    for (int i = 0; i < kPer; ++i) q_i8[tid * kPer + i] = static_cast<int8_t>(q8(x[i], qs));
    if (tid == 0) q_scale = qs;
  }
  __syncthreads();
  int qw[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) qw[i] = reinterpret_cast<const int*>(q_i8)[i];
  const float qs = q_scale;

  // scores; masked keys are not read. kKeys keys per pass, their loads
  // issued together (8 vector loads in flight per thread).
  constexpr int kKeys = kChunks >= 8 ? 1 : 8 / kChunks;
  const int8_t* kb = k + b * k_bs + h * D;
  float m = kNegInf;
  for (int j0 = tid; j0 < Lk; j0 += kKeys * kThreads) {
    int4 w[kKeys][kChunks];
    bool live[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int j = j0 + u * kThreads;
      live[u] = j < Lk && mrow[j];
      if (live[u]) {
        const int4* kr = reinterpret_cast<const int4*>(kb + j * k_rs);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) w[u][c] = kr[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= Lk) break;
      float x = kNegInf;
      if (live[u]) {
        int dot = 0;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          dot = __dp4a(qw[4 * c + 0], w[u][c].x, dot);
          dot = __dp4a(qw[4 * c + 1], w[u][c].y, dot);
          dot = __dp4a(qw[4 * c + 2], w[u][c].z, dot);
          dot = __dp4a(qw[4 * c + 3], w[u][c].w, dot);
        }
        x = (static_cast<float>(dot) * qs) * (ks[j] * scale);
      }
      s_row[j] = x;
      m = fmaxf(m, x);
    }
  }
  m = block_max(m, red);
  const bool dead = m <= kNegInf * 0.5f;

  float l = 0.f;
  for (int j = tid; j < Lk; j += kThreads) {
    const float e = expf(s_row[j] - m);
    s_row[j] = e;
    l += e;
  }
  l = block_sum(l, red);
  const float l_div = (l == 0.f) ? 1.f : l;

  // p * v_scale, its row absmax, then int8 over the row
  float am = 0.f;
  for (int j = tid; j < Lk; j += kThreads) {
    const float p = dead ? 0.f : s_row[j] / l_div;
    const float pv = p * vs[j];
    s_row[j] = pv;
    am = fmaxf(am, fabsf(pv));
  }
  const float ps = q8_scale(block_max(am, red));
  int last = -1;  // the last key whose pv_i8 is not 0
  for (int j = tid; j < Lk; j += kThreads) {
    const int x = q8(s_row[j], ps);
    pv_row[j] = static_cast<int8_t>(x);
    if (x != 0) last = j;
  }
  const int n_keys = static_cast<int>(block_max(static_cast<float>(last), red)) + 1;

  // o = sum_j pv_i8[j] v_i8[j]: thread = (stripe, 16-byte chunk)
  const int chunk = tid % kChunks, stripe = tid / kChunks;
  int acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  const int8_t* vb = v + b * v_bs + h * D + chunk * 16;
  constexpr int kRows = 8;  // rows per pass, their loads issued together
  for (int j0 = stripe; j0 < n_keys; j0 += kRows * kStripes) {
    int4 w[kRows];
    int p[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = j0 + u * kStripes;
      p[u] = j < n_keys ? pv_row[j] : 0;
      if (p[u] != 0) w[u] = *reinterpret_cast<const int4*>(vb + j * v_rs);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (p[u] == 0) continue;
      const int words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * i + e] += p[u] * static_cast<int>(static_cast<int8_t>(words[i] >> (8 * e)));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) red_i[stripe * D + chunk * 16 + i] = acc[i];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    int sum = 0;
    for (int r = 0; r < kStripes; ++r) sum += red_i[r * D + d];
    store(o + ((long long)b * H + h) * D + d, static_cast<float>(sum) * ps);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const uint8_t* mask, void* o, int B, int H, int Lk, long long q_bs, long long k_bs,
           long long k_rs, long long v_bs, long long v_rs, float scale, cudaStream_t stream) {
  constexpr int kStripes = kThreads / (D / 16);
  const size_t smem = (size_t)kStripes * D * sizeof(int) + (size_t)Lk * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_q8_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attn_q8_kernel<T, D><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ks,
      vs, mask, static_cast<T*>(o), H, Lk, q_bs, k_bs, k_rs, v_bs, v_rs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16. q is (B, 1, H*D) with batch
// stride q_bs; k/v are int8 (B, Lk, H*D) with batch/row strides (16-byte
// aligned rows); k_scale/v_scale are contiguous (B, H, Lk) fp32; mask is a
// contiguous (B, Lk) uint8 (bool); o is a contiguous (B, 1, H*D) tensor.
// Strides are in elements. Returns the CUDA error code of the launch.
extern "C" int pixparse_decode_attn_q8_fwd(int dtype, const void* q, const void* k, const void* v,
                                           const void* k_scale, const void* v_scale,
                                           const void* mask, void* o, int B, int H, int Lk, int D,
                                           long long q_bs, long long k_bs, long long k_rs,
                                           long long v_bs, long long v_rs, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
#define PIXPARSE_Q8_ARGS q, k, v, ks, vs, m, o, B, H, Lk, q_bs, k_bs, k_rs, v_bs, v_rs, scale, s
  if (dtype == 1) {
    switch (D) {
      case 32: return launch<__nv_bfloat16, 32>(PIXPARSE_Q8_ARGS);
      case 64: return launch<__nv_bfloat16, 64>(PIXPARSE_Q8_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(PIXPARSE_Q8_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32>(PIXPARSE_Q8_ARGS);
      case 64: return launch<float, 64>(PIXPARSE_Q8_ARGS);
      case 128: return launch<float, 128>(PIXPARSE_Q8_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef PIXPARSE_Q8_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
