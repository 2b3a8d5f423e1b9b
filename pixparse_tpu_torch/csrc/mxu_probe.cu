// Tensor-core contraction-width probe for Hopper (sm_90a), bound through a
// plain C entry point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernels
//   tools/mxu_probe.py::kern_k64, kern_k128, kern_k64x2
// : o (M, N) fp32 = sum over dots r = 0 .. n_dots-1 of
//   a[r % S][:, c(r) .. c(r) + K) @ b[r % S][c(r) .. c(r) + K, :)
// with bf16 a (S, M, W), b (S, W, N) and fp32 accumulation, S = 32 slabs:
//   k64   : W = K = 64,  n_dots = 2R, c = 0
//   k128  : W = K = 128, n_dots = R,  c = 0
//   k64x2 : W = 128, K = 64, n_dots = 2R, c = 64 * (r % 2): each dot takes
//           a 64-wide slice out of a 128-wide buffer (the packed-head layout)
// The three do the same useful work, 128 * R MACs per output element. The
// question: does a K = 64 contraction (the head dim of the port's attention)
// feed the tensor cores at a lower rate than K = 128, and does slicing 64
// columns out of a packed 128-wide row cost rate?
//
// Repeats. The TPU grid runs the whole sum G times in sequence on one core.
// Here repeat g writes its own (M, N) slab out[g]; every slab is the same
// sum in the same order (no split over K), so they are bit-identical (the
// wrapper returns all G, and the checks hold that). The G slabs are written
// once each: G * M * N * 4 bytes (134 MB at the tool's size) count in the
// bound beside a and b.
//
// What bounds it: operations, 2 * G * R * M * N * 128 useful FLOP (550 GFLOP
// at the tool's size, 0.556 ms at 989 TFLOP/s bf16), against 6 MB of
// operands (L2-resident) and the 134 MB of slabs. Hopper's full tensor-core
// rate is reached only by wgmma fed from shared memory that TMA fills.
//
// Design (the CE products' mainloop, fused_ce.cu, made persistent):
// - A persistent grid of one block per SM walks the (output tile, repeat)
//   pairs: block x takes pairs x, x + grid, ... (pair p = repeat * tiles +
//   tile). The launch sizes the grid itself, one wave: min(pairs, SMs x
//   blocks per SM) (tools/mxu_probe.py::probe_schedule mirrors the walk).
//   Output tiles are 128 x BN, BN = 256 where N allows, else 128.
// - Every dot is cut into 64-deep k-tiles (one 128-byte swizzled panel):
//   k-tile q of dot r reads columns c(r) + 64 q of a[r % S] and the same
//   rows of b[r % S]. One producer thread issues each k-tile's A box (128
//   rows x 64 columns of the 2-D map over a as (S * M, W)) and BN / 64 B
//   boxes (64 rows x 64 columns of the map over b as (S * W, N)) into a
//   4-stage mbarrier ring. The packed slice is only a box coordinate, so
//   k64x2 copies the same bytes as k64, and k128 two k-tiles a dot.
// - Two consumer warpgroups own 64 rows each of the tile and issue wgmma
//   m64nBNk16 from shared memory: A K-major, B N-major (the transpose bit,
//   b is stored N-contiguous). setmaxnreg moves registers from the producer
//   to the consumers (BN / 2 fp32 accumulators a thread). A consumer
//   releases a stage after wgmma.wait_group(1) shows the next k-tile's
//   products issued and this one's done: no block-wide barrier anywhere.
// - The producer runs ahead across tiles, so while the consumers store one
//   tile's fp32 slab (plain stores from the accumulators, 128 KB at BN =
//   256; no shared memory is left for a staging tile beside the 192 KB
//   ring) the ring already holds the next tile's first four k-tiles, and the
//   next mainloop starts as soon as the stores are issued.
// pixparse_mxu_probe_blocks_per_sm reports the occupancy (one block of 384
// threads per SM).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::hopper;

constexpr int kBM = 128;  // output rows of a tile: two consumer warpgroups x 64
constexpr int kBK = 64;   // depth of a k-tile: one 128-byte swizzled panel
constexpr int kStages = 4;
constexpr int kPanelBytes = 64 * 128;  // a 64 x 64 bf16 panel
constexpr int kThreads = 384;          // producer warpgroup + two consumer warpgroups

template <int BN>
struct Smem {
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  // + up to 1023 bytes to align the dynamic shared memory to 1024
  static constexpr int kBytes = kBarOffset + 2 * kStages * 8 + 1024;
};

// kW: the buffer's width (a's columns, b's rows); kK: one dot's depth.
template <int kW, int kK, int BN>
__global__ void __launch_bounds__(kThreads, 1) mxu_probe_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    float* __restrict__ out, int M, int N, int slabs, int n_dots, int n_pairs) {
  using Sm = Smem<BN>;
  constexpr bool kPacked = kW != kK;
  constexpr int kTilesPerDot = kK / kBK;
  extern __shared__ __align__(16) unsigned char probe_smem[];
  const uint32_t base = (smem_addr(probe_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + Sm::kBarOffset;
  auto sA = [&](int s) { return base + s * Sm::kStageBytes; };
  auto sB = [&](int s) { return sA(s) + Sm::kABytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int tiles_n = N / BN, tiles = (M / kBM) * tiles_n;
  const int k_tiles = n_dots * kTilesPerDot;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load, across all pairs ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // k-tiles issued by this block
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        const int tile = pair % tiles;
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          const int r = kt / kTilesPerDot, slab = r % slabs;
          // the k-tile's first column of a (row of b): the dot's slice, then
          // its 64-deep part
          const int c = (kPacked ? (r & 1) * kK : 0) + (kt % kTilesPerDot) * kBK;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), Sm::kStageBytes);
          tma_load_2d(sA(s), &tm_a, full(s), c, slab * M + m0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_2d(sB(s) + p * kPanelBytes, &tm_b, full(s), n0 + 64 * p, slab * kW + c);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 output rows each ----
  setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[BN / 2];
  int it = 0;  // k-tiles consumed by this block
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    const int tile = pair % tiles, repeat = pair / tiles;
    const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<BN, 0, 1>(acc, desc_kmajor<64, kBM>(sA(s), cw * 64, kk),
                           desc_mnmajor(sB(s), kk, kPanelBytes), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's products are done: free its stage
      if (kt > 0) mbar_arrive(empty((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty((it - 1) % kStages));  // the tile's last k-tile

    // this repeat's slab: accumulator register 4j + 2h + e is row 16w + g +
    // 8h, column 8j + 2t + e of this warpgroup's 64 x BN tile (hopper.cuh)
    float* o = out + static_cast<long long>(repeat) * M * N;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* orow = o + static_cast<long long>(m0 + cw * 64 + w * 16 + g + 8 * hr) * N + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

template <int kW, int kK, int BN>
int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(mxu_probe_kernel<kW, kK, BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Smem<BN>::kBytes));
}

// Blocks of one instantiation that fit one SM at once, times the SMs of the
// current device (asked once per device), or 0.
template <int kW, int kK, int BN>
int wave_blocks() {
  static int blocks[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (!blocks[device]) {
    int sms = 0, per_sm = 0;
    if (allow_smem<kW, kK, BN>() != 0 ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mxu_probe_kernel<kW, kK, BN>,
                                                      kThreads, Smem<BN>::kBytes) != cudaSuccess)
      return 0;
    blocks[device] = sms * per_sm;
  }
  return blocks[device];
}

template <int kW, int kK, int BN>
int launch(const void* a, const void* b, void* out, int M, int N, int slabs, int n_dots,
           int repeats, cudaStream_t stream) {
  const int wave = wave_blocks<kW, kK, BN>();
  if (wave <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap ta, tb;
  if (!make_map_2d(&ta, a, static_cast<long long>(slabs) * M, kW, kW, kBM) ||
      !make_map_2d(&tb, b, static_cast<long long>(slabs) * kW, N, N, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pairs = (M / kBM) * (N / BN) * repeats;
  mxu_probe_kernel<kW, kK, BN><<<min(n_pairs, wave), kThreads, Smem<BN>::kBytes, stream>>>(
      ta, tb, static_cast<float*>(out), M, N, slabs, n_dots, n_pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int kW, int kK>
int launch_bn(const void* a, const void* b, void* out, int M, int N, int slabs, int n_dots,
              int repeats, cudaStream_t stream) {
  return N % 256 == 0 ? launch<kW, kK, 256>(a, b, out, M, N, slabs, n_dots, repeats, stream)
                      : launch<kW, kK, 128>(a, b, out, M, N, slabs, n_dots, repeats, stream);
}

template <int kW, int kK>
int blocks_per_sm() {
  int n = 0;
  if (allow_smem<kW, kK, 256>() != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mxu_probe_kernel<kW, kK, 256>, kThreads,
                                                    Smem<256>::kBytes) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// variant: 0 = k64 (a (S, M, 64), b (S, 64, N)), 1 = k128 (a (S, M, 128),
// b (S, 128, N)), 2 = k64x2 (a (S, M, 128), b (S, 128, N), 64-wide slices),
// contiguous bf16, 16-byte aligned; out: contiguous (repeats, M, N) fp32.
// M and N multiples of 128; n_dots the number of dots (2R for k64 and
// k64x2, R for k128); the (tile, repeat) pairs must fit an int. Returns the
// CUDA error code of the launch (0 = success).
extern "C" int pixparse_mxu_probe(int variant, const void* a, const void* b, void* out, int M,
                                  int N, int slabs, int n_dots, int repeats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || M % kBM || N % 128 || slabs <= 0 || n_dots <= 0 || repeats <= 0 ||
      static_cast<long long>(M / kBM) * (N / 128) * repeats > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return launch_bn<64, 64>(a, b, out, M, N, slabs, n_dots, repeats, s);
    case 1: return launch_bn<128, 128>(a, b, out, M, N, slabs, n_dots, repeats, s);
    case 2: return launch_bn<128, 64>(a, b, out, M, N, slabs, n_dots, repeats, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of a variant that fit one SM at once (its occupancy, at BN = 256),
// or -1.
extern "C" int pixparse_mxu_probe_blocks_per_sm(int variant) {
  switch (variant) {
    case 0: return blocks_per_sm<64, 64>();
    case 1: return blocks_per_sm<128, 128>();
    case 2: return blocks_per_sm<128, 64>();
    default: return -1;
  }
}
