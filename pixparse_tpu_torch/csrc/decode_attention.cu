// Single-token decode attention over flat (B, Lk, H*D) KV caches for Hopper
// (sm_90a), bound through a plain C entry point (ctypes; see
// pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/decode_attention.py::_decode_attn_kernel
// : one query per sample attends over its key/value cache for all heads,
// with a per-key validity mask (> 0 = attend); fully masked rows give zeros.
//
// What bounds it on an H100: a decode step does ~4 FLOP per cache element
// (2 for q.k, 2 for p.v) against 2 bytes read for it, so it is bound by the
// bytes of K and V it streams from device memory (3.35 TB/s): 50.3 MB for a
// cruller_base cross cache at B=16, 15 us.
//
// What the design does about it:
// - every byte of K and V is read once, with 16-byte vector loads, and a
//   key that the mask drops is not read at all; each block first finds its
//   sample's last valid key from the mask, so the self cache is read only up
//   to the tokens written so far;
// - one (sample, head) pair alone is 192 blocks at B=16, too few to keep
//   132 SMs' loads in flight, so the keys are split over `n_split` blocks
//   (flash-decoding): each block keeps an online softmax over its share and
//   writes (max, sum, acc) partials, and a second small kernel combines
//   them;
// - inside a block a group of D/8 (bf16) lanes holds one key row of one
//   head; the q.k dot is a shuffle reduction inside the group, so a warp
//   works on several keys at once.
// Unlike the TPU kernel, p is not rounded to the cache dtype before p.v
// (it is kept in fp32); the difference is within the bf16 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
  __device__ __forceinline__ static float to_t(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 to_t(float x) { return __float2bfloat16(x); }
};

// Online-softmax merge of state (m_o, l_o) into (m, l); returns the scale
// factors for this state's and the other state's accumulators.
__device__ __forceinline__ void merge_scales(float& m, float& l, float m_o, float l_o, float& a,
                                             float& c) {
  const float m_new = fmaxf(m, m_o);
  const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
  a = exp2f(m - m_use);
  c = exp2f(m_o - m_use);
  l = l * a + l_o * c;
  m = m_new;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) decode_attn_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, float* __restrict__ work, int H, int Lk, long long q_bs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs, long long m_bs,
    int n_split, float scale_log2) {
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kLanesPerKey = D / kVec;
  constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / kLanesPerKey, sub = lane % kLanesPerKey;

  // last valid key of this sample: nothing after it is read
  __shared__ int s_end[kWarps];
  const uint8_t* mrow = mask + b * m_bs;
  int end = 0;
  for (int j = threadIdx.x; j < Lk; j += blockDim.x)
    if (mrow[j]) end = j + 1;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) end = max(end, __shfl_xor_sync(0xffffffffu, end, s));
  if (lane == 0) s_end[warp] = end;
  __syncthreads();
  end = max(max(s_end[0], s_end[1]), max(s_end[2], s_end[3]));
  const int chunk = (end + n_split - 1) / n_split;
  const int lo = split * chunk;
  const int hi = min(lo + chunk, end);

  float qf[kVec];
  Vec16<T>::load(q + b * q_bs + h * D + sub * kVec, qf);
#pragma unroll
  for (int i = 0; i < kVec; ++i) qf[i] *= scale_log2;
  const T* kb = k + b * k_bs + h * D + sub * kVec;
  const T* vb = v + b * v_bs + h * D + sub * kVec;

  float m = -INFINITY, l = 0.f, acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  // the loop bound is warp-uniform, so the group shuffles stay converged
  for (int base = lo + warp * kKeysPerWarp; base < hi; base += kWarps * kKeysPerWarp) {
    const int j = base + grp;
    const bool valid = j < hi && mrow[j] != 0;
    float kv[kVec], vv[kVec];
    float dot = 0.f;
    if (valid) {
      Vec16<T>::load(kb + j * k_rs, kv);
      Vec16<T>::load(vb + j * v_rs, vv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qf[i], kv[i], dot);
    }
#pragma unroll
    for (int s = kLanesPerKey / 2; s > 0; s >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, s);
    const float x = valid ? dot : -INFINITY;
    const float m_new = fmaxf(m, x);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = exp2f(m - m_use);
    const float p = exp2f(x - m_use);
    l = l * alpha + p;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = acc[i] * alpha + (valid ? p * vv[i] : 0.f);
  }

  // merge the key groups of the warp (lanes with the same `sub`)
#pragma unroll
  for (int s = kLanesPerKey; s < 32; s <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, s);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, s);
    float a, c;
    merge_scales(m, l, m_o, l_o, a, c);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = acc[i] * a + __shfl_xor_sync(0xffffffffu, acc[i], s) * c;
  }

  // merge the warps through shared memory, write this split's partial
  __shared__ float s_m[kWarps], s_l[kWarps], s_acc[kWarps][D];
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) s_acc[warp][sub * kVec + i] = acc[i];
    if (sub == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mm = s_m[0], ll = s_l[0], aa = s_acc[0][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      float a, c;
      merge_scales(mm, ll, s_m[w], s_l[w], a, c);
      aa = aa * a + s_acc[w][d] * c;
    }
    float* out = work + (((long long)b * H + h) * n_split + split) * (D + 2);
    out[d] = aa;
    if (d == 0) {
      out[D] = mm;
      out[D + 1] = ll;
    }
  }
}

template <typename T, int D>
__global__ void decode_attn_combine_kernel(const float* __restrict__ work, T* __restrict__ o,
                                           int H, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* w = work + ((long long)b * H + h) * n_split * (D + 2);
  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* part = w + s * (D + 2);
    float a, c;
    merge_scales(m, l, part[D], part[D + 1], a, c);
    acc = acc * a + part[d] * c;
  }
  o[((long long)b * H + h) * D + d] = Vec16<T>::to_t(l > 0.f ? acc / l : 0.f);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, void* work,
           int B, int H, int Lk, long long q_bs, long long k_bs, long long k_rs, long long v_bs,
           long long v_rs, long long m_bs, int n_split, float scale, cudaStream_t stream) {
  decode_attn_partial_kernel<T, D><<<dim3(n_split, H, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(work), H, Lk, q_bs, k_bs, k_rs,
      v_bs, v_rs, m_bs, n_split, scale * kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_combine_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(
      static_cast<const float*>(work), static_cast<T*>(o), H, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is (B, 1, H*D) with batch stride
// q_bs; k/v are (B, Lk, H*D) with batch/row strides; mask is (B, Lk) uint8
// (bool) with batch stride m_bs; o is a contiguous (B, 1, H*D) tensor of
// the q dtype; work holds B*H*n_split*(D+2) floats. Strides are in
// elements. Returns the CUDA error code of the launches (0 = success).
extern "C" int pixparse_decode_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* mask, void* o, void* work, int B, int H,
                                        int Lk, int D, long long q_bs, long long k_bs,
                                        long long k_rs, long long v_bs, long long v_rs,
                                        long long m_bs, int n_split, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || n_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define PIXPARSE_DECODE_ARGS \
  q, k, v, mask, o, work, B, H, Lk, q_bs, k_bs, k_rs, v_bs, v_rs, m_bs, n_split, scale, s
  if (dtype == 1) {
    switch (D) {
      case 32: return launch<__nv_bfloat16, 32>(PIXPARSE_DECODE_ARGS);
      case 64: return launch<__nv_bfloat16, 64>(PIXPARSE_DECODE_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(PIXPARSE_DECODE_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32>(PIXPARSE_DECODE_ARGS);
      case 64: return launch<float, 64>(PIXPARSE_DECODE_ARGS);
      case 128: return launch<float, 128>(PIXPARSE_DECODE_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef PIXPARSE_DECODE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
