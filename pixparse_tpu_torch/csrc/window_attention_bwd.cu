// Swin window attention backward for Hopper (sm_90a), bound through a plain
// C entry point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/window_attention.py::_bwd_kernel
// : per window of ww tokens and per head, from q, k, v (the forward's inputs,
// no lse saved) and do,
//   s  = q k^T * scale + bias[h] + mask[w % nW]      fp32, row max and sum
//   p  = softmax(s)                                  fp32
//   dv = bf16(p)^T do,   dp = do v^T                 fp32 accumulation
//   ds = p * (dp - sum_j p dp)                       fp32, from the unrounded p
//   dq = bf16(ds * scale) k,  dk = bf16(ds * scale)^T q
//   dbias[h] = sum over every window of ds           fp32
// with q/k/v/do (nB, ww, C = H * Dh), windows ordered b * nW + w.
//
// What bounds it on an H100: at donut_base's stage 0 in training (B = 2,
// 2560x1920: 6144 windows of ww = 100, H = 4, Dh = 32, bf16) the five
// products are 10 * ww^2 * C = 12.8 MFLOP per window against 7 * ww * C * 2 =
// 179 KB of q/k/v/do/dq/dk/dv, ~70 FLOP per byte, far below the card's ~295
// FLOP/byte ridge: the bytes bound it, plus the shift mask (123 MB fp32)
// read once.
//
// What the design does about it:
// - the TPU kernel carries dbias from grid step to grid step; blocks here run
//   in parallel, so each block sums ds over its own windows in shared memory
//   (every (query, key) pair of the block has one owning thread: no atomics),
//   writes one fp32 partial, and a second small kernel sums the partials of
//   each head in a fixed order: the result is deterministic;
// - a block owns (a run of window positions w, up to 8 images, head h), so
//   its windows share bias[h] and, per w, mask[w]; bias and mask are read
//   through the L1 cache at the score step (no per-block bias + mask copy:
//   shared memory holds the tiles, p / ds and the dbias partial instead);
// - q, k, v and do of a window are read in place through their row strides
//   into shared memory by cp.async (q/k/v are column slices of the fused qkv
//   projection), rows past ww zero-filled to the next multiple of 16;
// - one warp per 16-row tile: it recomputes s and the softmax for its query
//   rows (the whole key row in registers, as the forward), dp = do v^T, ds;
//   then bf16(p) goes to shared memory and the same warps, now owning 16-key
//   tiles, accumulate dv = p^T do by transposed ldmatrix loads of p; then
//   bf16(ds * scale) replaces p, each warp forms dq for its query rows from its
//   registers and dk = ds^T q for its key tile. All products are mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate). Padded rows carry p = ds = 0, padded
//   keys p = 0, and only the ww real rows are stored.
// This is the simple first version: mma.sync, no wgmma or TMA.
//
// fp32 inputs take a SIMT kernel (fp32 FMA, no tensor cores) with the same
// semantics and the same partials; it exists for the fp32 parity path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace pixparse;

constexpr int kMaxTokens = 144;  // window 12
constexpr int kF32Warps = 4;
constexpr int kReduceThreads = 256;

// The block's work: windows b * period + w for w in [w0, w1), b in [b0, b1),
// head h; `part` indexes the block's dbias partial among the head's.
struct BwdWork {
  int h, w0, w1, b0, b1, part;
};

__device__ __forceinline__ BwdWork bwd_work(int n_images, int period, int H, int w_per_block,
                                            int images_per_block) {
  const int n_chunks = (n_images + images_per_block - 1) / images_per_block;
  int idx = blockIdx.x;  // ((w-group * n_chunks) + chunk) * H + h: neighbours share w
  BwdWork bw;
  bw.h = idx % H;
  idx /= H;
  const int chunk = idx % n_chunks;
  const int wg = idx / n_chunks;
  bw.w0 = wg * w_per_block;
  bw.w1 = min(bw.w0 + w_per_block, period);
  bw.b0 = chunk * images_per_block;
  bw.b1 = min(bw.b0 + images_per_block, n_images);
  bw.part = wg * n_chunks + chunk;
  return bw;
}

template <int D, int kRowTiles>
__global__ void __launch_bounds__(kRowTiles * 32) window_attn_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ bias, const float* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ partial,
    int n_images, int period, int N, int H, int w_per_block, int images_per_block, int n_parts,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long do_bs, long long do_rs, float scale) {
  constexpr int kLds = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNPad = kRowTiles * 16;
  constexpr int kKeyTiles = kNPad / 8;
  constexpr int kLdp = kNPad + 8;  // p / ds tile row stride
  constexpr int kTile = kNPad * kLds;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTile;
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sDO = sV + kTile;
  __nv_bfloat16* sPS = sDO + kTile;                             // bf16(p), then bf16(ds * scale)
  float* sDB = reinterpret_cast<float*>(sPS + kNPad * kLdp);  // this block's sum of ds, N x N

  const BwdWork bw = bwd_work(n_images, period, H, w_per_block, images_per_block);
  const int C = H * D;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) sDB[i] = 0.f;
  const float* bias_h = bias + (long long)bw.h * N * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16;  // the warp's query rows, then its key rows
  const int r_lo = row0 + g, r_hi = r_lo + 8;

  for (int w = bw.w0; w < bw.w1; ++w) {
    const float* mask_w = mask ? mask + (long long)w * N * N : nullptr;
    for (int b = bw.b0; b < bw.b1; ++b) {
      const long long win = (long long)b * period + w;
      load_rows_async<D>(sQ, q + win * q_bs + bw.h * D, q_rs, N, kNPad);
      load_rows_async<D>(sK, k + win * k_bs + bw.h * D, k_rs, N, kNPad);
      load_rows_async<D>(sV, v + win * v_bs + bw.h * D, v_rs, N, kNPad);
      load_rows_async<D>(sDO, dout + win * do_bs + bw.h * D, do_rs, N, kNPad);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // s = q k^T over the whole (padded) key row
      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t qa[4];
        load_a_frag(qa, sQ, kLds, row0, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < kKeyTiles; j += 2) {
          uint32_t bk[4];
          load_b_frag_nk(bk, sK, kLds, j * 8, kk * 16, lane);
          mma_bf16_16816(s[j], qa, bk[0], bk[1]);
          mma_bf16_16816(s[j + 1], qa, bk[2], bk[3]);
        }
      }
      // scale, bias, mask (in the TPU kernel's order); padded keys -inf
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const int row = (e < 2) ? r_lo : r_hi;
          float x = -INFINITY;
          if (col < N) {
            x = s[j][e] * scale;
            if (row < N) {
              x += __ldg(bias_h + row * N + col);
              if (mask_w) x += __ldg(mask_w + row * N + col);
            }
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] *= kLog2e;
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], kLog2e, -mx[e >> 1]));  // exp(x - max)
          l[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] = 1.f / l[i];
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= l[e >> 1];  // p, fp32

      // dp = do v^T
      float dp[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t da[4];
        load_a_frag(da, sDO, kLds, row0, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < kKeyTiles; j += 2) {
          uint32_t bv[4];
          load_b_frag_nk(bv, sV, kLds, j * 8, kk * 16, lane);
          mma_bf16_16816(dp[j], da, bv[0], bv[1]);
          mma_bf16_16816(dp[j + 1], da, bv[2], bv[3]);
        }
      }
      // ds = p (dp - sum_j p dp); rows past the window carry p = ds = 0
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += s[j][e] * dp[j][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const int row = (e < 2) ? r_lo : r_hi;
          float ds = s[j][e] * (dp[j][e] - rs[e >> 1]);
          if (row >= N) s[j][e] = ds = 0.f;
          else if (col < N) sDB[row * N + col] += ds;  // one owning thread per pair
          dp[j][e] = ds;
        }
        *reinterpret_cast<uint32_t*>(sPS + r_lo * kLdp + j * 8 + 2 * t) = pack_bf16(s[j][0], s[j][1]);
        *reinterpret_cast<uint32_t*>(sPS + r_hi * kLdp + j * 8 + 2 * t) = pack_bf16(s[j][2], s[j][3]);
      }
      __syncthreads();

      float acc[kDTiles][4];
      // dv for this warp's key rows: dv[j, :] = sum_i p[i, j] do[i, :]
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kRowTiles; ++kk) {
        uint32_t pa[4];
        load_a_frag_trans(pa, sPS, kLdp, row0, kk * 16, lane);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bb[4];
          load_b_frag_kn(bb, sDO, kLds, kk * 16, n2 * 16, lane);
          mma_bf16_16816(acc[2 * n2], pa, bb[0], bb[1]);
          mma_bf16_16816(acc[2 * n2 + 1], pa, bb[2], bb[3]);
        }
      }
      __nv_bfloat16* dvb = dv + win * (long long)N * C + bw.h * D + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i ? r_hi : r_lo;
        if (row >= N) continue;
#pragma unroll
        for (int n = 0; n < kDTiles; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)row * C + n * 8) =
              __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      __syncthreads();  // every warp is done reading p

      // bf16(ds * scale) replaces p; dq for this warp's query rows straight
      // from the registers (the same rounding as the shared copy)
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        *reinterpret_cast<uint32_t*>(sPS + r_lo * kLdp + j * 8 + 2 * t) =
            pack_bf16(dp[j][0] * scale, dp[j][1] * scale);
        *reinterpret_cast<uint32_t*>(sPS + r_hi * kLdp + j * 8 + 2 * t) =
            pack_bf16(dp[j][2] * scale, dp[j][3] * scale);
      }
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(dp[2 * kk][0] * scale, dp[2 * kk][1] * scale),
                               pack_bf16(dp[2 * kk][2] * scale, dp[2 * kk][3] * scale),
                               pack_bf16(dp[2 * kk + 1][0] * scale, dp[2 * kk + 1][1] * scale),
                               pack_bf16(dp[2 * kk + 1][2] * scale, dp[2 * kk + 1][3] * scale)};
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bk[4];
          load_b_frag_kn(bk, sK, kLds, kk * 16, n2 * 16, lane);
          mma_bf16_16816(acc[2 * n2], a, bk[0], bk[1]);
          mma_bf16_16816(acc[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }
      __nv_bfloat16* dqb = dq + win * (long long)N * C + bw.h * D + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i ? r_hi : r_lo;
        if (row >= N) continue;
#pragma unroll
        for (int n = 0; n < kDTiles; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)row * C + n * 8) =
              __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      __syncthreads();  // ds is in shared memory

      // dk for this warp's key rows: dk[j, :] = sum_i bf16(ds * scale)[i, j] q[i, :]
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kRowTiles; ++kk) {
        uint32_t da[4];
        load_a_frag_trans(da, sPS, kLdp, row0, kk * 16, lane);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t bq[4];
          load_b_frag_kn(bq, sQ, kLds, kk * 16, n2 * 16, lane);
          mma_bf16_16816(acc[2 * n2], da, bq[0], bq[1]);
          mma_bf16_16816(acc[2 * n2 + 1], da, bq[2], bq[3]);
        }
      }
      __nv_bfloat16* dkb = dk + win * (long long)N * C + bw.h * D + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i ? r_hi : r_lo;
        if (row >= N) continue;
#pragma unroll
        for (int n = 0; n < kDTiles; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)row * C + n * 8) =
              __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      __syncthreads();  // the tiles are refilled for the next window
    }
  }
  float* part = partial + ((long long)bw.h * n_parts + bw.part) * N * N;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) part[i] = sDB[i];
}

// fp32 path: one warp per query row at a time (lanes split the keys), p and
// ds rows in shared memory, then threads over (row, channel) for dq, dk, dv.
// q/k/v/do are read through the L1 cache; the dbias partial lives in device
// memory, each element owned by one thread of the block.
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32) window_attn_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ mask,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ partial, int n_images, int period, int N, int H, int w_per_block,
    int images_per_block, int n_parts, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, long long do_bs, long long do_rs,
    float scale) {
  constexpr int kKeysPerLane = (kMaxTokens + 31) / 32;
  extern __shared__ float smem_f[];
  float* sP = smem_f;      // N x N
  float* sDS = sP + N * N;  // N x N, unscaled

  const BwdWork bw = bwd_work(n_images, period, H, w_per_block, images_per_block);
  const int C = H * D;
  float* part = partial + ((long long)bw.h * n_parts + bw.part) * N * N;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) part[i] = 0.f;
  __syncthreads();
  const float* bias_h = bias + (long long)bw.h * N * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int w = bw.w0; w < bw.w1; ++w) {
    const float* mask_w = mask ? mask + (long long)w * N * N : nullptr;
    for (int b = bw.b0; b < bw.b1; ++b) {
      const long long win = (long long)b * period + w;
      const float* qw = q + win * q_bs + bw.h * D;
      const float* kw = k + win * k_bs + bw.h * D;
      const float* vw = v + win * v_bs + bw.h * D;
      const float* dw = dout + win * do_bs + bw.h * D;
      for (int row = warp; row < N; row += kF32Warps) {
        float sc[kKeysPerLane], dpv[kKeysPerLane];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          const int col = lane + 32 * i;
          float x = -INFINITY, dd = 0.f;
          if (col < N) {
            float dot = 0.f;
            for (int d = 0; d < D; ++d) {
              dot = fmaf(qw[row * q_rs + d], kw[col * k_rs + d], dot);
              dd = fmaf(dw[row * do_rs + d], vw[col * v_rs + d], dd);
            }
            x = dot * scale + bias_h[row * N + col];
            if (mask_w) x += mask_w[row * N + col];
          }
          sc[i] = x;
          dpv[i] = dd;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
        float l = 0.f;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          sc[i] = expf(sc[i] - mx);
          l += sc[i];
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) l += __shfl_xor_sync(0xffffffffu, l, s);
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          sc[i] /= l;
          rs += sc[i] * dpv[i];
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, s);
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          const int col = lane + 32 * i;
          if (col < N) {
            const float ds = sc[i] * (dpv[i] - rs);
            sP[row * N + col] = sc[i];
            sDS[row * N + col] = ds;
            part[row * N + col] += ds;
          }
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
        const int r = idx / D, d = idx % D;
        float aq = 0.f, ak = 0.f, av = 0.f;
        for (int c = 0; c < N; ++c) {
          aq = fmaf(sDS[r * N + c] * scale, kw[c * k_rs + d], aq);
          ak = fmaf(sDS[c * N + r] * scale, qw[c * q_rs + d], ak);
          av = fmaf(sP[c * N + r], dw[c * do_rs + d], av);
        }
        const long long o = win * (long long)N * C + (long long)r * C + bw.h * D + d;
        dq[o] = aq;
        dk[o] = ak;
        dv[o] = av;
      }
      __syncthreads();  // p and ds are rewritten for the next window
    }
  }
}

// dbias[h, e] = sum over the head's partials, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads) dbias_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dbias, int H, int n_parts, int NN) {
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= H * NN) return;
  const int h = idx / NN, e = idx % NN;
  const float* p = partial + (long long)h * n_parts * NN + e;
  float sum = 0.f;
  for (int i = 0; i < n_parts; ++i) sum += p[(long long)i * NN];
  dbias[idx] = sum;
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

struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *mask;
  void *dq, *dk, *dv;
  float* partial;
  int n_images, period, N, H, w_per_block, images_per_block, n_parts, grid;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  float scale;
  cudaStream_t stream;
};

template <int D, int kRowTiles>
int launch_bf16_tiles(const Args& a) {
  constexpr int kNPad = kRowTiles * 16;
  const size_t smem = (4ull * kNPad * (D + 8) + 1ull * kNPad * (kNPad + 8)) *
                          sizeof(__nv_bfloat16) +
                      sizeof(float) * a.N * a.N;
  const int err = allow_smem(window_attn_bwd_bf16_kernel<D, kRowTiles>, smem);
  if (err) return err;
  window_attn_bwd_bf16_kernel<D, kRowTiles><<<a.grid, kRowTiles * 32, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.bias,
      a.mask, static_cast<__nv_bfloat16*>(a.dq), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.partial, a.n_images, a.period, a.N, a.H, a.w_per_block,
      a.images_per_block, a.n_parts, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.do_bs,
      a.do_rs, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a) {
  switch ((a.N + 15) / 16) {
    case 1: return launch_bf16_tiles<D, 1>(a);
    case 2: return launch_bf16_tiles<D, 2>(a);
    case 3: return launch_bf16_tiles<D, 3>(a);
    case 4: return launch_bf16_tiles<D, 4>(a);
    case 5: return launch_bf16_tiles<D, 5>(a);
    case 6: return launch_bf16_tiles<D, 6>(a);
    case 7: return launch_bf16_tiles<D, 7>(a);
    case 8: return launch_bf16_tiles<D, 8>(a);
    case 9: return launch_bf16_tiles<D, 9>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int launch_f32(const Args& a) {
  const size_t smem = 2ull * a.N * a.N * sizeof(float);
  const int err = allow_smem(window_attn_bwd_f32_kernel<D>, smem);
  if (err) return err;
  window_attn_bwd_f32_kernel<D><<<a.grid, kF32Warps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.bias, a.mask,
      static_cast<float*>(a.dq), static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.partial,
      a.n_images, a.period, a.N, a.H, a.w_per_block, a.images_per_block, a.n_parts, a.q_bs,
      a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.do_bs, a.do_rs, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/do are (nB, N, H*D) with batch and
// row strides in elements (channels contiguous); bias is a contiguous
// (H, N, N) fp32 tensor; mask a contiguous (period, N, N) fp32 tensor or NULL
// (period then is any divisor of nB: windows b * period + w share nothing).
// A block takes w_per_block window positions of images_per_block images and
// one head; partial is (H, n_parts, N, N) fp32 scratch with n_parts =
// ceil(period / w_per_block) * ceil((nB / period) / images_per_block). dq,
// dk, dv are contiguous (nB, N, H*D) tensors of the q dtype, dbias a (H, N, N)
// fp32 tensor, every element written. Returns the CUDA error code of the
// launches (0 = success).
extern "C" int pixparse_window_attn_bwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* dout, const void* bias, const void* mask,
                                        void* dq, void* dk, void* dv, void* partial, void* dbias,
                                        int nB, int period, int N, int H, int D, int w_per_block,
                                        int images_per_block, long long q_bs, long long q_rs,
                                        long long k_bs, long long k_rs, long long v_bs,
                                        long long v_rs, long long do_bs, long long do_rs,
                                        float scale, void* stream) {
  if (nB <= 0 || H <= 0 || period <= 0 || nB % period || N <= 0 || N > kMaxTokens ||
      w_per_block <= 0 || images_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.partial = static_cast<float*>(partial);
  a.n_images = nB / period;
  a.period = period;
  a.N = N;
  a.H = H;
  a.w_per_block = w_per_block;
  a.images_per_block = images_per_block;
  const int n_groups = (period + w_per_block - 1) / w_per_block;
  const int n_chunks = (a.n_images + images_per_block - 1) / images_per_block;
  a.n_parts = n_groups * n_chunks;
  a.grid = a.n_parts * H;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.do_bs = do_bs;
  a.do_rs = do_rs;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch (D) {
      case 16: err = launch_bf16<16>(a); break;
      case 32: err = launch_bf16<32>(a); break;
      case 64: err = launch_bf16<64>(a); break;
      default: break;
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: err = launch_f32<16>(a); break;
      case 32: err = launch_f32<32>(a); break;
      case 64: err = launch_f32<64>(a); break;
      default: break;
    }
  }
  if (err) return err;
  const int NN = N * N;
  dbias_reduce_kernel<<<(H * NN + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                        a.stream>>>(static_cast<const float*>(partial),
                                    static_cast<float*>(dbias), H, a.n_parts, NN);
  return static_cast<int>(cudaGetLastError());
}
