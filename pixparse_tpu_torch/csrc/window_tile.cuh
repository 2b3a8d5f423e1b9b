// One window of Swin window attention on tiles already in shared memory,
// shared by the window-attention forward (window_attention.cu: q/k/v rows of
// partitioned windows, kernel #14) and the banded probe (window_band.cu: the
// same rows gathered straight from the NHWC qkv map, kernel #17). The two
// kernels differ only in where a window's rows live in device memory; this
// is the arithmetic between the loads and the stores.
//
// Each warp takes one 16-row tile of the window (kRowTiles = n_pad / 16
// warps): s = q k^T on mma.sync m16n8k16 (bf16 in, fp32 accumulate) over the
// whole padded key row in registers, times the scale, plus the fp32 bias
// (bias[h], or bias[h] + mask[w], row-major N x N in shared memory); padded
// keys -inf; row max and sum reduced across the quad; p rounded to bf16
// straight from the accumulators into the A fragments of p v. Only the N
// real rows are stored, each at row_ptr(row) (D contiguous bf16 channels).
// Every loop over keys has a compile-time trip count.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace pixparse {

template <int D, int kRowTiles, typename RowPtr>
__device__ __forceinline__ void window_tile_attend(const __nv_bfloat16* sQ,
                                                   const __nv_bfloat16* sK,
                                                   const __nv_bfloat16* sV, const float* sBM,
                                                   int N, float scale, RowPtr row_ptr) {
  constexpr int kLds = D + 8;  // the tiles' padded row stride
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kKeyTiles = kRowTiles * 2;  // n_pad / 8
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16;
  const int r_lo = row0 + g, r_hi = r_lo + 8;

  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) load_a_frag(qa[kk], sQ, kLds, row0, kk * 16, lane);

  // s = q k^T over the whole (padded) key row
  float s[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; j += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t bk[4];
      load_b_frag_nk(bk, sK, kLds, j * 8, kk * 16, lane);
      mma_bf16_16816(s[j], qa[kk], bk[0], bk[1]);
      mma_bf16_16816(s[j + 1], qa[kk], bk[2], bk[3]);
    }
  }

  // scale, then bias (+ mask); padded keys -inf; row max over the quad
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
        if (row < N) x += sBM[row * N + col];  // rows past the window are never stored
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
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }

  // o = p v, p normalised and rounded to bf16 in the A fragments
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]),
        pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]),
        pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]),
        pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t bv[4];
      load_b_frag_kn(bv, sV, kLds, kk * 16, n2 * 16, lane);
      mma_bf16_16816(acc[2 * n2], a, bv[0], bv[1]);
      mma_bf16_16816(acc[2 * n2 + 1], a, bv[2], bv[3]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r_hi : r_lo;
    if (row >= N) continue;
    __nv_bfloat16* orow = row_ptr(row) + 2 * t;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

}  // namespace pixparse
