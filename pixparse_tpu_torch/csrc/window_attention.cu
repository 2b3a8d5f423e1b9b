// Swin window attention forward for Hopper (sm_90a), bound through a plain C
// entry point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/window_attention.py::_fwd_kernel
// : per window of ww tokens and per head,
//   o = softmax(q k^T * Dh^-0.5 + bias[h] + mask[w % nW]) v
// with q/k/v (nB, ww, C = H * Dh), windows ordered b * nW + w. The scale
// multiplies the fp32 product before the bias is added, the softmax runs in
// fp32 and p is rounded to the input dtype before p v (bf16), as the TPU
// kernel does.
//
// What bounds it on an H100: at donut_base's stage 0 (B = 8, 2560x1920:
// 24576 windows of ww = 100, H = 4, Dh = 32, bf16) the two products are
// 4 * ww^2 * C = 5.1 MFLOP per window against 4 * ww * C * 2 = 102 KB of
// q/k/v/o, ~50 FLOP per byte, far below the card's ~295 FLOP/byte ridge:
// it is bound by the bytes of q, k, v and o, plus the shift mask (nW x ww x
// ww fp32, 123 MB at stage 0, more than the 50 MB L2), read once.
//
// What the design does about it:
// - one block per (window position w, chunk of up to 8 images, head h),
//   one warp per 16 rows of the window (7 warps at ww = 100): every window of the block shares bias[h] and mask[w], so the
//   block adds the two once into shared memory (ww x ww fp32) and reads the
//   sum for every window; consecutive blocks share w, so each mask row is
//   fetched from device memory about once. (The TPU kernel adds bias and
//   mask to each score in turn; adding them first differs by at most one
//   fp32 rounding of a logit, and not at all for Swin's 0 / -1e9 masks.)
// - q, k and v of a window (ww x Dh each) are read in place through their
//   row stride (they are column slices of the fused qkv projection, stride
//   3C: no copy) into shared memory by cp.async, rows past ww zero-filled to
//   the next multiple of 16;
// - each warp takes its 16-row tile of the window: s = q k^T on mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate) for the whole key row at once (up to
//   144 keys in registers; the row count is a template parameter, so every
//   loop over keys is unrolled), scale, bias and mask added in registers, padded
//   keys set to -inf, row max and sum reduced across the quad, p rounded to
//   bf16 straight from the accumulators into A fragments of p v; only the ww
//   real rows are stored. Scores never leave the SM. That per-window
//   arithmetic is window_tile.cuh's window_tile_attend, which the banded
//   probe (window_band.cu) shares; this file does the loads and the layout.
// This is the simple first version: mma.sync, no wgmma or TMA.
//
// fp32 inputs take a SIMT kernel (fp32 FMA, no tensor cores) with the same
// semantics; it exists for the fp32 parity path, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "window_tile.cuh"

namespace {

using namespace pixparse;

constexpr int kMaxTokens = 144;           // window 12
constexpr int kWarps = 4;  // fp32 kernel
constexpr int kImagesPerBlock = 8;        // windows per block, one per image

// bias[h] + mask[w] -> shared memory (N * N fp32), once per block.
__device__ __forceinline__ void load_bias_mask(float* dst, const float* bias_h,
                                               const float* mask_w, int n2) {
  for (int i = threadIdx.x; i < n2; i += blockDim.x)
    dst[i] = mask_w ? bias_h[i] + mask_w[i] : bias_h[i];
}

// The block's work: windows b * period + w for b in [b0, b1), head h.
struct BlockWork {
  int w, h, b0, b1;
};

__device__ __forceinline__ BlockWork block_work(int n_images, int H) {
  const int n_chunks = (n_images + kImagesPerBlock - 1) / kImagesPerBlock;
  int idx = blockIdx.x;  // ((w * n_chunks) + chunk) * H + h: neighbours share w
  BlockWork bw;
  bw.h = idx % H;
  idx /= H;
  const int chunk = idx % n_chunks;
  bw.w = idx / n_chunks;
  bw.b0 = chunk * kImagesPerBlock;
  bw.b1 = min(bw.b0 + kImagesPerBlock, n_images);
  return bw;
}

// One warp per 16-row tile of the window: kRowTiles = n_pad / 16 warps, and
// every loop over keys has a compile-time trip count (no guards, so the
// compiler interleaves the fragment loads, products and exponentials).
template <int D, int kRowTiles>
__global__ void __launch_bounds__(kRowTiles * 32) window_attn_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ o, int n_images, int period,
    int N, int H, long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, float scale) {
  constexpr int kLds = D + 8;  // padded row: spreads the fragment loads over banks
  constexpr int kNPad = kRowTiles * 16;
  constexpr int kTile = kNPad * kLds;  // one q, k or v tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTile;
  __nv_bfloat16* sV = sK + kTile;
  float* sBM = reinterpret_cast<float*>(sV + kTile);  // bias[h] + mask[w]

  const BlockWork bw = block_work(n_images, H);
  const int C = H * D;
  load_bias_mask(sBM, bias + (long long)bw.h * N * N,
                 mask ? mask + (long long)bw.w * N * N : nullptr, N * N);
  for (int b = bw.b0; b < bw.b1; ++b) {
    const long long win = (long long)b * period + bw.w;
    load_rows_async<D>(sQ, q + win * q_bs + bw.h * D, q_rs, N, kNPad);
    load_rows_async<D>(sK, k + win * k_bs + bw.h * D, k_rs, N, kNPad);
    load_rows_async<D>(sV, v + win * v_bs + bw.h * D, v_rs, N, kNPad);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    window_tile_attend<D, kRowTiles>(sQ, sK, sV, sBM, N, scale, [&](int row) {
      return o + win * (long long)N * C + (long long)row * C + bw.h * D;
    });
    __syncthreads();  // the tiles are refilled for the next window
  }
}

// fp32 path: one warp per query row at a time; lanes split the keys for the
// scores and the head dim for p v.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) window_attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ o,
    int n_images, int period, int N, int H, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, float scale) {
  constexpr int kLds = D + 1;
  constexpr int kKeysPerLane = (kMaxTokens + 31) / 32;
  extern __shared__ float smem_f[];
  float* sQ = smem_f;
  float* sK = sQ + N * kLds;
  float* sV = sK + N * kLds;
  float* sP = sV + N * kLds;  // one probability row per warp
  float* sBM = sP + kWarps * kMaxTokens;  // bias[h] + mask[w]

  const BlockWork bw = block_work(n_images, H);
  const int C = H * D;
  load_bias_mask(sBM, bias + (long long)bw.h * N * N,
                 mask ? mask + (long long)bw.w * N * N : nullptr, N * N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_row = sP + warp * kMaxTokens;

  for (int b = bw.b0; b < bw.b1; ++b) {
    const long long win = (long long)b * period + bw.w;
    __syncthreads();
    for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      sQ[r * kLds + c] = q[win * q_bs + (long long)r * q_rs + bw.h * D + c];
      sK[r * kLds + c] = k[win * k_bs + (long long)r * k_rs + bw.h * D + c];
      sV[r * kLds + c] = v[win * v_bs + (long long)r * v_rs + bw.h * D + c];
    }
    __syncthreads();
    for (int row = warp; row < N; row += kWarps) {
      float sc[kKeysPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int col = lane + 32 * i;
        float x = -INFINITY;
        if (col < N) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(sQ[row * kLds + d], sK[col * kLds + d], dot);
          x = dot * scale + sBM[row * N + col];
        }
        sc[i] = x;
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
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int col = lane + 32 * i;
        if (col < N) p_row[col] = sc[i] / l;
      }
      __syncwarp();
      float* orow = o + win * (long long)N * C + (long long)row * C + bw.h * D;
      for (int d = lane; d < D; d += 32) {
        float acc = 0.f;
        for (int c = 0; c < N; ++c) acc = fmaf(p_row[c], sV[c * kLds + d], acc);
        orow[d] = acc;
      }
      __syncwarp();  // p_row is rewritten by this warp's next row
    }
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int D, int kRowTiles>
int launch_bf16_tiles(const void* q, const void* k, const void* v, const float* bias,
                      const float* mask, void* o, int n_images, int period, int N, int H,
                      long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                      long long v_bs, long long v_rs, float scale, cudaStream_t stream) {
  const size_t smem =
      3ull * kRowTiles * 16 * (D + 8) * sizeof(__nv_bfloat16) + sizeof(float) * N * N;
  const int grid = period * ((n_images + kImagesPerBlock - 1) / kImagesPerBlock) * H;
  const int err = allow_smem(window_attn_bf16_kernel<D, kRowTiles>, smem);
  if (err) return err;
  window_attn_bf16_kernel<D, kRowTiles><<<grid, kRowTiles * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, mask, static_cast<__nv_bfloat16*>(o), n_images,
      period, N, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, const float* mask,
                void* o, int n_images, int period, int N, int H, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
                cudaStream_t stream) {
#define PIXPARSE_TILES_ARGS \
  q, k, v, bias, mask, o, n_images, period, N, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, stream
  switch ((N + 15) / 16) {
    case 1: return launch_bf16_tiles<D, 1>(PIXPARSE_TILES_ARGS);
    case 2: return launch_bf16_tiles<D, 2>(PIXPARSE_TILES_ARGS);
    case 3: return launch_bf16_tiles<D, 3>(PIXPARSE_TILES_ARGS);
    case 4: return launch_bf16_tiles<D, 4>(PIXPARSE_TILES_ARGS);
    case 5: return launch_bf16_tiles<D, 5>(PIXPARSE_TILES_ARGS);
    case 6: return launch_bf16_tiles<D, 6>(PIXPARSE_TILES_ARGS);
    case 7: return launch_bf16_tiles<D, 7>(PIXPARSE_TILES_ARGS);
    case 8: return launch_bf16_tiles<D, 8>(PIXPARSE_TILES_ARGS);
    case 9: return launch_bf16_tiles<D, 9>(PIXPARSE_TILES_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PIXPARSE_TILES_ARGS
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const float* bias, const float* mask,
               void* o, int n_images, int period, int N, int H, long long q_bs, long long q_rs,
               long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
               cudaStream_t stream) {
  const size_t smem = (3ull * N * (D + 1) + kWarps * kMaxTokens + N * N) * sizeof(float);
  const int grid = period * ((n_images + kImagesPerBlock - 1) / kImagesPerBlock) * H;
  const int err = allow_smem(window_attn_f32_kernel<D>, smem);
  if (err) return err;
  window_attn_f32_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, mask, static_cast<float*>(o), n_images, period, N, H, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v are (nB, N, H*D) with batch and
// row strides in elements (channels contiguous); bias is a contiguous
// (H, N, N) fp32 tensor; mask a contiguous (period, N, N) fp32 tensor or
// NULL (then period = 1); o is a contiguous (nB, N, H*D) tensor of the q
// dtype. nB must be a multiple of period. Returns the CUDA error code of the
// launch (0 = success).
extern "C" int pixparse_window_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* bias, const void* mask, void* o, int nB,
                                        int period, int N, int H, int D, long long q_bs,
                                        long long q_rs, long long k_bs, long long k_rs,
                                        long long v_bs, long long v_rs, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nB <= 0 || H <= 0 || period <= 0 || nB % period || N <= 0 || N > kMaxTokens)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  const int n_images = nB / period;
#define PIXPARSE_WINDOW_ARGS \
  q, k, v, b, m, o, n_images, period, N, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, s
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_bf16<16>(PIXPARSE_WINDOW_ARGS);
      case 32: return launch_bf16<32>(PIXPARSE_WINDOW_ARGS);
      case 64: return launch_bf16<64>(PIXPARSE_WINDOW_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(PIXPARSE_WINDOW_ARGS);
      case 32: return launch_f32<32>(PIXPARSE_WINDOW_ARGS);
      case 64: return launch_f32<64>(PIXPARSE_WINDOW_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef PIXPARSE_WINDOW_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
