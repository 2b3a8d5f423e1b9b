// Banded Swin window attention for Hopper (sm_90a): window attention read
// straight from the NHWC qkv map, with no partition or reverse copy. Bound
// through plain C entry points (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   tools/window_band_probe.py::band_fwd_kernel
// : qkv (B, Hp, Wp, 3C) -> o (B, Hp, Wp, C), per window (b, i, j) of
// win x win pixels and per head h,
//   o = softmax(q k^T * Dh^-0.5 + bias[h]) v      (no shift mask)
// where row r of the window is the pixel (b, i*win + r / win, j*win + r % win)
// and q, k, v of head h are its channels h*Dh, C + h*Dh and 2C + h*Dh. The
// arithmetic is kernel #14's (window_attention.cu): fp32 scores, the scale
// before the bias, p rounded to bf16 before p v.
//
// What bounds it on an H100: the bytes of qkv read once and o written once
// (at the probe's stage 0, 4 x 320 x 240 x 3 x 128 bf16 in and a third of
// that out, 315 MB, 0.094 ms at 3.35 TB/s); 4 * ww^2 * C FLOP per window is
// ~50 FLOP per byte, far below the ~295 FLOP/byte ridge.
//
// What the design does about it: it is kernel #14's, the same kernel
// (window_ring.cuh's window_fwd_ring_kernel) over another source of rows.
// - One wave of persistent blocks: block r * H + h walks run r of head h's
//   windows (ops/window_attention.py::window_plan with period 1: no mask),
//   bias[h] in shared memory for the whole run by one bulk copy.
// - One producer thread keeps the windows' q, k and v tiles in flight by TMA
//   through a ring of up to six stages (mbarriers; no block-wide barrier).
//   The gather is one copy per tile: the NHWC qkv map is one 4-D tensor map
//   (channel, x, y, image) = (3C, Wp, Hp, B), box (Dh, win, win, 1); the box
//   at (part * C + h * Dh, j * win, i * win, b) lands window (b, i, j)'s
//   head slice as ww rows of Dh in _window_partition's row order, swizzled
//   as #14's 2-D boxes are (the swizzle is keyed on the shared-memory
//   address, and the rows are packed the same). q, k and v are three boxes
//   of the one map. The box fills rows [0, ww) only: the kernel zeroes the
//   pad rows up to the next multiple of 16 once, before the first copy.
// - Two units of one warp per 16-row tile take the run's windows in turns
//   (14 warps at ww = 100): #14's score step and p v on mma.sync; #14's
//   combiner warp has no mask to add and returns at once. o is stored from
//   the accumulators to its NHWC addresses (pixel stride C, map row stride
//   Wp * C), as #14 stores its rows: a TMA store would need a staging tile
//   and a barrier across each unit's warps, and the stores already move the
//   same 64-byte row slices as #14's.
// bf16 only; head dim 16, 32 or 64 and windows of at most 144 tokens (the
// shapes the ring takes); other shapes return an error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "window_ring.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::window;

// The kernel's source of rows: window n of the map, row-major over (image,
// window row, window column), is (b, i, j); tile t (q, k, v) of window n,
// head h, is the box of the one 4-D map at (t * C + h * D, j * win, i * win,
// b), and its row r the pixel (b, i * win + r / win, j * win + r % win).
template <int D>
struct Banded {
  CUtensorMap map;
  int nwh, nww, win, Wp, C;  // windows down and across an image
  __device__ __forceinline__ void window(int n, int& b, int& i, int& j) const {
    b = n / (nwh * nww);
    const int r = n - b * nwh * nww;
    i = r / nww;
    j = r - i * nww;
  }
  __device__ __forceinline__ void operator()(uint32_t dst, int t, int n, int h,
                                             uint32_t bar) const {
    int b, i, j;
    window(n, b, i, j);
    tma_load_4d(dst, &map, bar, t * C + h * D, j * win, i * win, b);
  }
  // the pixel (b, i * win, j * win), and row r's pixel from it
  __device__ __forceinline__ long long row0(int n) const {
    int b, i, j;
    window(n, b, i, j);
    return ((static_cast<long long>(b) * nwh * win + i * win) * Wp + j * win) * C;
  }
  __device__ __forceinline__ long long row_off(int r) const {
    return (static_cast<long long>(r / win) * Wp + r % win) * C;
  }
};

// The 4-D map (3C, Wp, Hp, B) over the contiguous NHWC qkv map, boxes of
// (D, win, win, 1), swizzled by one row of D bf16 as the ring's tiles are.
template <int D>
bool make_band_map(CUtensorMap* map, const void* qkv, int B, int Hp, int Wp, int C, int win) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return false;
  const cuuint64_t px = 3ull * C * 2;  // bytes of one pixel
  const cuuint64_t dims[4] = {3ull * C, static_cast<cuuint64_t>(Wp), static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {px, px * Wp, px * Wp * Hp};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(win),
                             static_cast<cuuint32_t>(win), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = D == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(qkv), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct BandArgs {
  const void* qkv;
  const float* bias;
  void* o;
  int B, Hp, Wp, win, H, N, nn, ldb, runs;
  float scale;
  cudaStream_t stream;
};

// #14's ring without a mask, each tile's box N rows (not npad).
template <int D, int kRowTiles>
struct Launch {
  static int run(const BandArgs& a) {
    RingLayout L;
    if (!fwd_ring<D, kRowTiles>(a.nn, false, a.N, &L)) return kInvalid;
    Banded<D> src;
    src.nwh = a.Hp / a.win;
    src.nww = a.Wp / a.win;
    src.win = a.win;
    src.Wp = a.Wp;
    src.C = a.H * D;
    if (!make_band_map<D>(&src.map, a.qkv, a.B, a.Hp, a.Wp, src.C, a.win)) return kInvalid;
    return fwd_launch<D, kRowTiles>(src, L, a.bias, nullptr, a.o, a.B * src.nwh * src.nww, 1,
                                    a.N, a.H, a.runs, a.nn, a.ldb, a.scale, a.stream);
  }
};

template <int D, int kRowTiles>
struct ConfigBand {
  static int run(int N, int nn, Config* cfg) {
    return fwd_config<D, kRowTiles, Banded<D>>(nn, false, N, cfg);
  }
};

}  // namespace

// qkv: contiguous (B, Hp, Wp, 3 * H * D) bf16, 16-byte aligned; bias: (H,
// nn) fp32 tables of N = win^2 rows of ldb floats (what window_ring.cuh's
// table_ldb / table_nn give); o: contiguous (B, Hp, Wp, H * D) bf16. D is
// 16, 32 or 64, win^2 at most 144, Hp and Wp multiples of win. The grid is
// H * runs blocks (ops/window_attention.py::window_plan over the B * (Hp /
// win) * (Wp / win) windows, period 1). Returns the CUDA error code of the
// launch (0 = success).
extern "C" int pixparse_window_band_fwd(const void* qkv, const void* bias, void* o, int B, int Hp,
                                        int Wp, int win, int H, int D, int nn, int ldb, int runs,
                                        float scale, void* stream) {
  const int N = win * win;
  if (B <= 0 || H <= 0 || win <= 0 || Hp <= 0 || Wp <= 0 || Hp % win || Wp % win ||
      N > kMaxTokens || runs <= 0 || nn != table_nn(N) || ldb != table_ldb(N))
    return kInvalid;
  const BandArgs a{qkv, static_cast<const float*>(bias), o, B, Hp, Wp, win, H, N, nn, ldb, runs,
                   scale, static_cast<cudaStream_t>(stream)};
  return by_shape<Launch>(N, D, a);
}

// The launch configuration at window `win` and head dim D, for the plan:
// out[] as window_ring.cuh's config_out writes it. Returns a CUDA error code
// (0 = success).
extern "C" int pixparse_window_band_config(int win, int D, int* out) {
  const int N = win * win;
  if (win <= 0 || N > kMaxTokens) return kInvalid;
  Config cfg;
  const int err = by_shape<ConfigBand>(N, D, N, table_nn(N), &cfg);
  if (err) return err;
  config_out(cfg, out);
  return 0;
}
