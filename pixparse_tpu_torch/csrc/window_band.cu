// Banded Swin window attention for Hopper (sm_90a): window attention read
// straight from the NHWC qkv map, with no partition or reverse copy. Bound
// through a plain C entry point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   tools/window_band_probe.py::band_fwd_kernel
// : qkv (B, Hp, Wp, 3C) -> o (B, Hp, Wp, C), per window (b, i, j) of
// win x win pixels and per head h,
//   o = softmax(q k^T * Dh^-0.5 + bias[h]) v      (no shift mask)
// where row r of the window is the pixel (b, i*win + r / win, j*win + r % win)
// and q, k, v of head h are its channels h*Dh, C + h*Dh and 2C + h*Dh. The
// arithmetic is kernel #14's (window_attention.cu): fp32 scores, the scale
// before the bias, p rounded to bf16 before p v. The per-window part is
// shared with it: window_tile.cuh's window_tile_attend, a template on where
// the output rows go. Only the addressing differs.
//
// What bounds it on an H100: the bytes of qkv read once and o written once
// (at the probe's stage 0, 4 x 320 x 240 x 3 x 128 bf16 in and a third of
// that out, 315 MB, 0.094 ms at 3.35 TB/s); 4 * ww^2 * C FLOP per window is
// ~50 FLOP per byte, far below the ~295 FLOP/byte ridge.
//
// What the design does about it:
// - the TPU tile was a band of tbw windows along a window row, because a
//   (1, win, tbw * win, 3C) block of NHWC is contiguous and the window then
//   needed a (win, win, C) -> (ww, C) relayout in VMEM. Here the gather is
//   address arithmetic: each of a window's win rows is win contiguous
//   pixels, so every 16-byte vector of q, k or v goes global -> shared by
//   cp.async from its own NHWC address (pixel stride 3C, row stride Wp * 3C),
//   rows past ww zero-filled to the next multiple of 16. o rows are stored to
//   their NHWC addresses (pixel stride C). No copy of the map is made. tbw is
//   not a parameter of this kernel: the wrapper accepts it only to check the
//   TPU probe's geometry.
// - one block per (run of up to 4 consecutive windows, head h), one warp per
//   16-row tile of the window: the block loads bias[h] into shared memory
//   once for its windows; blocks are ordered run * H + h, so the H blocks of
//   a run read the same pixels' channel slices at about the same time. (Runs
//   of 4 keep the probe's stage-2 map, 192 windows, at ~6 blocks per SM.)
// The simple first version: mma.sync, cp.async, no wgmma or TMA; bf16 only,
// window 10 and head dim 32 only (the probe's geometries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "window_tile.cuh"

namespace {

using namespace pixparse;

// Built for the probe's one geometry: window 10 (100 rows, 7 row tiles of
// 16), head dim 32. The Swin encoder's shapes come when it uses the kernel.
constexpr int kWin = 10;
constexpr int kHeadDim = 32;
constexpr int kBandRowTiles = (kWin * kWin + 15) / 16;
constexpr int kWindowsPerBlock = 4;

// The win x win pixels of a window (row r = pixel (r / win, r % win) from
// `src`, pixel stride `ps`, map-row stride `rs`, D channels each) -> shared
// memory with padded row stride D + 8, by cp.async; rows [n, n_pad) zero.
template <int D>
__device__ __forceinline__ void load_window_async(__nv_bfloat16* smem, const __nv_bfloat16* src,
                                                  int win, long long ps, long long rs, int n,
                                                  int n_pad) {
  constexpr int kVecPerRow = D / 8;
  constexpr int kLds = D + 8;
  for (int i = threadIdx.x; i < n_pad * kVecPerRow; i += blockDim.x) {
    const int r = i / kVecPerRow, c = i % kVecPerRow;
    const bool in = r < n;
    const long long off = in ? (r / win) * rs + (r % win) * ps : 0;
    cp_async_16(smem + r * kLds + c * 8, src + off + c * 8, in);
  }
}

template <int D, int kRowTiles>
__global__ void __launch_bounds__(kRowTiles * 32) window_band_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int n_windows, int nwh, int nww, int win, int Wp, int H,
    float scale) {
  constexpr int kLds = D + 8;
  constexpr int kNPad = kRowTiles * 16;
  constexpr int kTile = kNPad * kLds;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTile;
  __nv_bfloat16* sV = sK + kTile;
  float* sB = reinterpret_cast<float*>(sV + kTile);  // bias[h]

  const int h = blockIdx.x % H;
  const int w0 = (blockIdx.x / H) * kWindowsPerBlock;
  const int w1 = min(w0 + kWindowsPerBlock, n_windows);
  const int N = win * win;
  const int C = H * D;
  const long long ps = 3LL * C, rs = (long long)Wp * 3 * C;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) sB[i] = bias[(long long)h * N * N + i];

  for (int w = w0; w < w1; ++w) {
    const int b = w / (nwh * nww), i = (w / nww) % nwh, j = w % nww;
    // pixel index of the window's first row: (b, i * win, j * win)
    const long long p0 = ((long long)b * nwh * win + (long long)i * win) * Wp + (long long)j * win;
    const __nv_bfloat16* src = qkv + p0 * 3 * C + h * D;
    load_window_async<D>(sQ, src, win, ps, rs, N, kNPad);
    load_window_async<D>(sK, src + C, win, ps, rs, N, kNPad);
    load_window_async<D>(sV, src + 2 * C, win, ps, rs, N, kNPad);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    window_tile_attend<D, kRowTiles>(sQ, sK, sV, sB, N, scale, [&](int row) {
      return o + (p0 + (long long)(row / win) * Wp + row % win) * C + h * D;
    });
    __syncthreads();  // the tiles are refilled for the next window
  }
}

template <int D, int kRowTiles>
int launch_tiles(const void* qkv, const float* bias, void* o, int B, int nwh, int nww, int win,
                 int Wp, int H, float scale, cudaStream_t stream) {
  const int N = win * win;
  const size_t smem =
      3ull * kRowTiles * 16 * (D + 8) * sizeof(__nv_bfloat16) + sizeof(float) * N * N;
  const int n_windows = B * nwh * nww;
  const int grid = (n_windows + kWindowsPerBlock - 1) / kWindowsPerBlock * H;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_band_kernel<D, kRowTiles>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_band_kernel<D, kRowTiles><<<grid, kRowTiles * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), bias, static_cast<__nv_bfloat16*>(o), n_windows,
      nwh, nww, win, Wp, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: contiguous (B, Hp, Wp, 3 * H * D) bf16; bias: contiguous (H, win^2,
// win^2) fp32; o: contiguous (B, Hp, Wp, H * D) bf16. win must be 10 and D
// 32; Hp and Wp must be multiples of win. Returns the CUDA error code of the
// launch (0 = success).
extern "C" int pixparse_window_band_fwd(const void* qkv, const void* bias, void* o, int B, int Hp,
                                        int Wp, int win, int H, int D, float scale,
                                        void* stream) {
  if (B <= 0 || Hp <= 0 || Wp <= 0 || H <= 0 || win != kWin || D != kHeadDim || Hp % win ||
      Wp % win)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiles<kHeadDim, kBandRowTiles>(qkv, static_cast<const float*>(bias), o, B,
                                               Hp / win, Wp / win, win, Wp, H, scale,
                                               static_cast<cudaStream_t>(stream));
}
