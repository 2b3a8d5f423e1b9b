// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry
// point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU forward kernels
//   pixparse_tpu/ops/flash_attention.py::_fwd_kernel_single  (one key block)
//   pixparse_tpu/ops/flash_attention.py::_fwd_kernel         (online softmax)
// with one kernel: o = softmax(q k^T * scale + masks) v plus the per-row
// natural logsumexp, optional bottom-right causal masking (query i sees keys
// <= i + Lk - Lq) and per-sample key lengths. Fully masked rows give o = 0
// and lse = -1e30, as the TPU kernel does.
//
// What bounds it on an H100: at the ViT encode (B=16, L=1009, H=12, D=64,
// bf16) the two products are 4*B*H*L^2*D = 5.0e10 FLOP against 99 MB of
// q/k/v/o, i.e. ~500 FLOP per byte, well above the card's ~295 FLOP/byte
// ridge: it is bound by tensor-core throughput, and the score matrix must
// never reach device memory.
//
// What the design does about it: one block of 4 warps per (query tile of 64
// rows, head, sample), 16 query rows per warp. Q stays in registers as
// mma.sync A fragments; K and V tiles of 64 keys are staged through shared
// memory; both products run on the tensor cores through mma.sync m16n8k16
// (bf16 in, fp32 accumulate); the online softmax runs on the score
// fragments in registers and P feeds the second product straight from
// those registers, so scores never leave the SM. q/k/v are read in the
// packed (B, L, H*D) projection layout through their strides: no head-split
// copy. This is the simple first version: no wgmma, TMA, cp.async
// double-buffering or warp specialisation yet.
//
// fp32 inputs take a SIMT kernel (fp32 FMA, no tensor cores) with the same
// semantics; it exists for the fp32 parity path, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace pixparse;

constexpr float kDeadLse = -1e30f;  // lse of a fully masked row

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ kv_lens, int H, int Lq, int Lk,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, int causal, float scale_log2) {
  constexpr int kBlockM = 64;  // 4 warps x 16 query rows
  constexpr int kBlockN = 64;  // keys per shared-memory tile
  constexpr int kLds = D + 8;  // padded row: spreads the fragment loads over banks
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockN / 8;
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kLds];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kLds];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = qt * kBlockM;
  const int r_lo = row0 + warp * 16 + g;  // this thread's two query rows
  const int r_hi = r_lo + 8;

  const __nv_bfloat16* qb = q + b * q_bs + h * D;
  const __nv_bfloat16* kb = k + b * k_bs + h * D;
  const __nv_bfloat16* vb = v + b * v_bs + h * D;

  // Q tile -> A fragments in registers, staged through sK.
  load_tile_bf16<D, kBlockM>(sK, qb, q_rs, row0, Lq);
  __syncthreads();
  uint32_t qa[kKSteps][4];
  {
    const __nv_bfloat16* base = sK + (warp * 16 + g) * kLds + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      qa[kk][0] = ld_u32(base + kk * 16);
      qa[kk][1] = ld_u32(base + 8 * kLds + kk * 16);
      qa[kk][2] = ld_u32(base + kk * 16 + 8);
      qa[kk][3] = ld_u32(base + 8 * kLds + kk * 16 + 8);
    }
  }

  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  // keys any row of this block may see
  const int n_end = causal ? min(kv_len, min(row0 + kBlockM, Lq) + off) : kv_len;

  float m[2] = {-INFINITY, -INFINITY};  // running row max (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed (and Q staging done)
    load_tile_bf16<D, kBlockN>(sK, kb, k_rs, n0, Lk);
    load_tile_bf16<D, kBlockN>(sV, vb, v_rs, n0, Lk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kp = sK + (j * 8 + g) * kLds + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        mma_bf16_16816(s[j], qa[kk], ld_u32(kp + kk * 16), ld_u32(kp + kk * 16 + 8));
    }

    // masks + scale, tile row max
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? r_lo : r_hi;
        const bool ok = col < kv_len && (!causal || col <= row + off);
        const float x = ok ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      m_use[i] = (m_new == -INFINITY) ? 0.f : m_new;  // no keys yet: keep p = 0
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // P rounded to bf16 as the PV operand; l sums the rounded values (the
    // TPU kernel's rounding, flash_attention.py _fwd_kernel_single)
    uint32_t pa[kNTiles][2];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(exp2f(s[j][0] - m_use[0]),
                                                      exp2f(s[j][1] - m_use[0]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(exp2f(s[j][2] - m_use[1]),
                                                      exp2f(s[j][3] - m_use[1]));
      const float2 lof = __bfloat1622float2(lo), hif = __bfloat1622float2(hi);
      l[0] += lof.x + lof.y;
      l[1] += hif.x + hif.y;
      pa[j][0] = bf16x2_bits(lo);
      pa[j][1] = bf16x2_bits(hi);
    }

    // O += P V: the score accumulators are already laid out as A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
      const __nv_bfloat16* vp = sV + (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        const __nv_bfloat16* p = vp + n * 8;
        const uint32_t b0 = u16(p) | (u16(p + kLds) << 16);
        const uint32_t b1 = u16(p + 8 * kLds) | (u16(p + 9 * kLds) << 16);
        mma_bf16_16816(acc[n], a, b0, b1);
      }
    }
  }

  const long long o_rs = (long long)H * D;
  __nv_bfloat16* ob = o + (long long)b * Lq * o_rs + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = i ? r_hi : r_lo;
    if (row >= Lq) continue;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = ob + row * o_rs + 2 * t;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (t == 0)
      lse[((long long)b * H + h) * Lq + row] = live ? (m[i] + log2f(l[i])) * kLn2 : kDeadLse;
  }
}

// fp32 path: one warp per query row at a time (4 rows per warp), lanes split
// the head dim for P V and the keys of a 32-key tile for Q K^T.
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kv_lens, int H,
    int Lq, int Lk, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, int causal, float scale) {
  constexpr int kRowsPerWarp = 4;
  constexpr int kBlockM = 4 * kRowsPerWarp;
  constexpr int kBlockN = 32;
  constexpr int kPerLane = D / 32;
  __shared__ float sQ[kBlockM][D];
  __shared__ float sK[kBlockN][D + 1];
  __shared__ float sV[kBlockN][D + 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = qt * kBlockM;
  const float* qb = q + b * q_bs + h * D;
  const float* kb = k + b * k_bs + h * D;
  const float* vb = v + b * v_bs + h * D;

  for (int i = threadIdx.x; i < kBlockM * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    sQ[r][c] = (row0 + r < Lq) ? qb[(long long)(row0 + r) * q_rs + c] : 0.f;
  }

  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  const int n_end = causal ? min(kv_len, min(row0 + kBlockM, Lq) + off) : kv_len;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockN * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < Lk;
      sK[r][c] = in ? kb[(long long)(n0 + r) * k_rs + c] : 0.f;
      sV[r][c] = in ? vb[(long long)(n0 + r) * v_rs + c] : 0.f;
    }
    __syncthreads();
    const int col = n0 + lane;  // this lane's key
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp * kRowsPerWarp + r;
      const int row = row0 + lr;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[lr][d], sK[lane][d], dot);
      const bool ok = col < kv_len && (!causal || col <= row + off);
      const float x = ok ? dot * scale : -INFINITY;
      float tmax = x;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, s));
      const float m_new = fmaxf(m[r], tmax);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      const float p = expf(x - m_use);
      float psum = p;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, s);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kBlockN; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[r][i] = fmaf(pj, sV[j][lane + 32 * i], acc[r][i]);
      }
    }
  }

  const long long o_rs = (long long)H * D;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= Lq) continue;
    const bool live = l[r] > 0.f;
    const float inv = live ? 1.f / l[r] : 0.f;
    float* orow = o + (long long)b * Lq * o_rs + row * o_rs + h * D;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) orow[lane + 32 * i] = acc[r][i] * inv;
    if (lane == 0)
      lse[((long long)b * H + h) * Lq + row] = live ? m[r] + logf(l[r]) : kDeadLse;
  }
}

template <int D>
void launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                 const int* kv_lens, int B, int H, int Lq, int Lk, long long q_bs,
                 long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                 int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Lq + 63) / 64, H, B);
  flash_fwd_bf16_kernel<D><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), kv_lens, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, causal,
      scale * kLog2e);
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                const int* kv_lens, int B, int H, int Lq, int Lk, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, int causal,
                float scale, cudaStream_t stream) {
  const dim3 grid((Lq + 15) / 16, H, B);
  flash_fwd_f32_kernel<D><<<grid, 128, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), kv_lens, H, Lq, Lk, q_bs, q_rs, k_bs,
      k_rs, v_bs, v_rs, causal, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; o is a
// contiguous (B, Lq, H, D) tensor and lse a contiguous (B, H, Lq) fp32
// tensor. kv_lens is a (B,) int32 device pointer or NULL. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int pixparse_flash_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                       void* o, void* lse, const void* kv_lens, int B, int H,
                                       int Lq, int Lk, int D, long long q_bs, long long q_rs,
                                       long long k_bs, long long k_rs, long long v_bs,
                                       long long v_rs, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  if (B <= 0 || H <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
#define PIXPARSE_FLASH_ARGS \
  q, k, v, o, lse, lens, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, causal, scale, s
  if (dtype == 1) {
    switch (D) {
      case 32: launch_bf16<32>(PIXPARSE_FLASH_ARGS); break;
      case 64: launch_bf16<64>(PIXPARSE_FLASH_ARGS); break;
      case 128: launch_bf16<128>(PIXPARSE_FLASH_ARGS); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 32: launch_f32<32>(PIXPARSE_FLASH_ARGS); break;
      case 64: launch_f32<64>(PIXPARSE_FLASH_ARGS); break;
      case 128: launch_f32<128>(PIXPARSE_FLASH_ARGS); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PIXPARSE_FLASH_ARGS
  return static_cast<int>(cudaGetLastError());
}
