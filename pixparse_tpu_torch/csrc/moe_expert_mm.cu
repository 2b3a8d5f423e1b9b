// Grouped expert products of a mixture-of-experts layer for Hopper (sm_90a),
// bound through plain C entry points (ctypes; see
// pixparse_tpu_torch/ops/_build.py and ops/moe.py).
//
// Replaces no TPU kernel: the JAX package has no expert layer. It was added
// for the latent-attention, 64-expert decoder of models/moonlight.py, whose
// routed experts are the largest single part of a train step.
//
// The rows of a layer's (token, slot) pairs are sorted by expert, so that
// the rows of expert e are [o_e, o_{e+1}) with the offsets o (E + 1 int32)
// on the device; no count is read by the host. Two kernels serve every
// product of the layer, forward and backward:
//
//   moe_expert_mm_kernel<kn>   C[o_e + i, :] = A[o_e + i, :] . B_e
//       for every expert e in one launch. B_e is the e-th (N, K) matrix of a
//       stacked (E, N, K) weight (kn = 0: C = A B_e^T, the forward products
//       [gate|up] and down) or the e-th (K, N) one (kn = 1: C = A B_e, the
//       backward's dX and dH through the same weights).
//   moe_expert_wgrad_kernel    C_e = A[o_e:o_{e+1}]^T . B[o_e:o_{e+1}]
//       the weight gradients, the expert's rows as the reduction: (M, N)
//       for every expert, zeros for an expert without rows.
//
// What bounds it on an H100: the products, 2 * rows * K * N operations each
// (at cruller_moonlight, B = 8: 97536 rows, 0.56 TFLOP for [gate|up], about
// 0.57 ms at 989 TFLOP/s); an expert's weight (11.5 MB for [gate|up]) is
// read once per row tile from L2, its rows once per column tile.
// What the design does about it: one launch per product walks (column tile,
// row tile) with the row tiles of all experts laid end to end; each block
// finds its expert from the offsets, so the grid is sized on the host from
// the row count alone (rows / 128 + E tiles, the surplus blocks exit). Blocks
// with neighbouring indices share a row tile (column tiles fastest) and the
// blocks in flight cover about one expert, whose weight then stays in L2.
// Each block owns a 128 x 128 output tile: 4 warps of 64 x 64, mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) from shared memory filled by a
// 3-stage cp.async ring of 64-deep K tiles (110.6 KB of shared memory, two
// blocks an SM); rows past an expert's end are
// zero-filled and not stored. The result is rounded once to bf16. No
// atomics: every output element has one owner, so results repeat bit for
// bit. A first kernel, right and simple: the wgmma + TMA mainloop of
// fused_ce.cu is the way to more of the tensor cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace pixparse;

constexpr int kBM = 128;  // output rows of a block
constexpr int kBN = 128;  // output columns of a block
constexpr int kBK = 64;   // depth of a K tile
constexpr int kStages = 3;
constexpr int kWarpsM = 2, kWarpsN = 2;  // 4 warps of 64 x 64 outputs
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;
constexpr int kMI = kWM / 16;  // m16 tiles a warp
constexpr int kNI = kWN / 8;   // n8 tiles a warp
constexpr int kLdK = kBK + 8;  // row stride of a tile stored [row][k]
constexpr int kLdN = kBN + 8;  // ... of a tile stored [k][column]
constexpr int kLdM = kBM + 8;  // ... of a transposed A tile stored [k][row]
constexpr int kMaxExperts = 256;

// Shared memory of one stage, in bf16 elements.
constexpr int kTileA = kBM * kLdK;     // A rows [row][k]
constexpr int kTileAT = kBK * kLdM;    // A^T [k][row] (wgrad)
constexpr int kTileBNK = kBN * kLdK;   // B_e stored (N, K)
constexpr int kTileBKN = kBK * kLdN;   // B stored (K, N)
constexpr int kSmemMm = kStages * (kTileA + (kTileBNK > kTileBKN ? kTileBNK : kTileBKN)) * 2;
constexpr int kSmemWgrad = kStages * (kTileAT + kTileBKN) * 2;

__device__ __forceinline__ void mma_tile_k16(float (&acc)[kMI][kNI][4],
                                             const uint32_t (&a)[kMI][4],
                                             const uint32_t (&b)[kNI / 2][4]) {
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNI / 2; ++nj) {
      mma_bf16_16816(acc[mi][2 * nj], a[mi], b[nj][0], b[nj][1]);
      mma_bf16_16816(acc[mi][2 * nj + 1], a[mi], b[nj][2], b[nj][3]);
    }
}

// The warp's 64 x 64 accumulators, rounded to bf16, into rows [row0, row0 +
// 64) and columns [col0, col0 + 64) of a row-major C tile with row stride
// ldc; rows at or past nrows are not stored.
__device__ __forceinline__ void store_acc(const float (&acc)[kMI][kNI][4], __nv_bfloat16* c,
                                          long long ldc, int row0, int col0, int nrows,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 16 + g + 8 * h;
        if (r < nrows) {
          const int col = col0 + ni * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(c + (long long)r * ldc + col) =
              pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
      }
}

// Finds the block's expert and rows from the offsets: the row tiles of the
// experts lie end to end in expert order. Returns false for a surplus
// block. Warp 0 walks the offsets: each lane sums the tiles of up to
// kMaxExperts / 32 neighbouring experts, a warp scan places the lanes' runs,
// and the lane whose run holds the block's tile finds its expert; the
// answer goes through shared memory.
__device__ __forceinline__ bool locate_tile(const int* offsets, int E, int tile, int* e_out,
                                            int* row0_out, int* row1_out) {
  __shared__ int s_e, s_row0, s_row1;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32;
    const int e0 = min(E, lane * per), e1 = min(E, e0 + per);
    int mine = 0;
    for (int e = e0; e < e1; ++e) mine += (offsets[e + 1] - offsets[e] + kBM - 1) / kBM;
    int before = mine;  // inclusive scan, then exclusive
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, before, d);
      if (lane >= d) before += v;
    }
    before -= mine;
    if (lane == 0) s_e = -1;
    __syncwarp();
    if (tile >= before && tile < before + mine) {
      int seen = before;
      for (int e = e0; e < e1; ++e) {
        const int a = offsets[e], b = offsets[e + 1];
        const int tiles = (b - a + kBM - 1) / kBM;
        if (tile < seen + tiles) {
          s_e = e;
          s_row0 = a + (tile - seen) * kBM;
          s_row1 = b;
          break;
        }
        seen += tiles;
      }
    }
  }
  __syncthreads();
  *e_out = s_e;
  *row0_out = s_row0;
  *row1_out = s_row1;
  return s_e >= 0;
}

template <int kKN>
__global__ void __launch_bounds__(kThreads, 2)
    moe_expert_mm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                         __nv_bfloat16* __restrict__ c, const int* __restrict__ offsets, int E,
                         int N, int K) {
  extern __shared__ __align__(16) unsigned char mm_smem[];
  int e, row0, row_end;
  if (!locate_tile(offsets, E, blockIdx.y, &e, &row0, &row_end)) return;
  const int nrows = min(kBM, row_end - row0);  // this tile's rows of the expert
  const int n0 = blockIdx.x * kBN;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(mm_smem);
  __nv_bfloat16* sB = sA + kStages * kTileA;
  constexpr int kTileB = kKN ? kTileBKN : kTileBNK;
  const __nv_bfloat16* a_rows = a + (long long)row0 * K;
  const __nv_bfloat16* b_e = b + (long long)e * N * K;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* ta = sA + s * kTileA;
    __nv_bfloat16* tb = sB + s * kTileB;
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 8) / kThreads; ++i) {  // A: 128 rows x kBK / 8 vectors
      const int v = threadIdx.x + i * kThreads;
      const int r = v / (kBK / 8), cv = v % (kBK / 8);
      const bool in = r < nrows;
      cp_async_16(ta + r * kLdK + cv * 8, a_rows + (in ? (long long)r * K : 0) + k0 + cv * 8, in);
    }
    if constexpr (kKN) {  // B_e (K, N): kBK rows of k x 16 vectors of columns
#pragma unroll
      for (int i = 0; i < (kBK * kBN / 8) / kThreads; ++i) {
        const int v = threadIdx.x + i * kThreads;
        const int r = v >> 4, cv = v & 15;
        cp_async_16(tb + r * kLdN + cv * 8, b_e + (long long)(k0 + r) * N + n0 + cv * 8, true);
      }
    } else {  // B_e (N, K): 128 rows of n x kBK / 8 vectors of k
#pragma unroll
      for (int i = 0; i < (kBN * kBK / 8) / kThreads; ++i) {
        const int v = threadIdx.x + i * kThreads;
        const int r = v / (kBK / 8), cv = v % (kBK / 8);
        cp_async_16(tb + r * kLdK + cv * 8, b_e + (long long)(n0 + r) * K + k0 + cv * 8, true);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0.f;

  const int k_tiles = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt arrived; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();
    const __nv_bfloat16* ta = sA + (kt % kStages) * kTileA;
    const __nv_bfloat16* tb = sB + (kt % kStages) * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMI][4], bf[kNI / 2][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) load_a_frag(af[mi], ta, kLdK, wm + mi * 16, kk, lane);
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        if constexpr (kKN)
          load_b_frag_kn(bf[nj], tb, kLdN, kk, wn + nj * 16, lane);
        else
          load_b_frag_nk(bf[nj], tb, kLdK, wn + nj * 16, kk, lane);
      }
      mma_tile_k16(acc, af, bf);
    }
  }
  cp_async_wait<0>();
  store_acc(acc, c + (long long)row0 * N, N, wm, n0 + wn, nrows, lane);
}

__global__ void __launch_bounds__(kThreads, 2)
    moe_expert_wgrad_kernel(const __nv_bfloat16* __restrict__ a,
                            const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ c,
                            const int* __restrict__ offsets, int M, int N) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int r0 = offsets[e], rows = offsets[e + 1] - r0;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(wg_smem);  // [k][m]
  __nv_bfloat16* sB = sA + kStages * kTileAT;                       // [k][n]

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* ta = sA + s * kTileAT;
    __nv_bfloat16* tb = sB + s * kTileBKN;
#pragma unroll
    for (int i = 0; i < (kBK * kBM / 8) / kThreads; ++i) {  // kBK rows x 16 vectors each
      const int v = threadIdx.x + i * kThreads;
      const int r = v >> 4, cv = v & 15;
      const bool in = k0 + r < rows;
      const long long row = in ? (long long)(r0 + k0 + r) : 0;
      cp_async_16(ta + r * kLdM + cv * 8, a + row * M + m0 + cv * 8, in);
      cp_async_16(tb + r * kLdN + cv * 8, b + row * N + n0 + cv * 8, in);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0.f;

  const int k_tiles = (rows + kBK - 1) / kBK;  // 0 for an expert without rows
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();
    const __nv_bfloat16* ta = sA + (kt % kStages) * kTileAT;
    const __nv_bfloat16* tb = sB + (kt % kStages) * kTileBKN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMI][4], bf[kNI / 2][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) load_a_frag_trans(af[mi], ta, kLdM, wm + mi * 16, kk, lane);
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) load_b_frag_kn(bf[nj], tb, kLdN, kk, wn + nj * 16, lane);
      mma_tile_k16(acc, af, bf);
    }
  }
  cp_async_wait<0>();
  store_acc(acc, c + (long long)e * M * N + (long long)m0 * N, N, wm, n0 + wn, kBM, lane);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// a: (R, K) bf16 rows sorted by expert; b: the stacked (E, N, K) weight
// (b_kn = 0: c = a b_e^T) or (E, K, N) (b_kn = 1: c = a b_e); c: (R, N) bf16;
// offsets: (E + 1) int32 on the device, offsets[0] = 0, offsets[E] = R.
// row_tiles: the grid's row tiles, at least R / 128 + E (ceil). N a multiple
// of 128, K of 64, all pointers 16-byte aligned. Rows of c outside every
// expert's range are not written. Returns the CUDA error code (0 = success).
extern "C" int pixparse_moe_expert_mm(const void* a, const void* b, void* c, const void* offsets,
                                      int E, int N, int K, int b_kn, int row_tiles,
                                      void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0 || E > kMaxExperts || N <= 0 || K <= 0 || N % kBN || K % kBK || row_tiles < 0 ||
      row_tiles > 65535 || !aligned16(a) || !aligned16(b) || !aligned16(c))
    return invalid;
  if (row_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kBN, row_tiles);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* cp = static_cast<__nv_bfloat16*>(c);
  const int* op = static_cast<const int*>(offsets);
  cudaError_t err;
  if (b_kn) {
    err = cudaFuncSetAttribute(moe_expert_mm_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMm);
    if (err != cudaSuccess) return static_cast<int>(err);
    moe_expert_mm_kernel<1><<<grid, kThreads, kSmemMm, s>>>(ap, bp, cp, op, E, N, K);
  } else {
    err = cudaFuncSetAttribute(moe_expert_mm_kernel<0>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMm);
    if (err != cudaSuccess) return static_cast<int>(err);
    moe_expert_mm_kernel<0><<<grid, kThreads, kSmemMm, s>>>(ap, bp, cp, op, E, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// a: (R, M) and b: (R, N) bf16 rows sorted by expert; c: (E, M, N) bf16,
// c_e = a[o_e:o_{e+1}]^T b[o_e:o_{e+1}], every element written (zeros for an
// expert without rows). M and N multiples of 128, pointers 16-byte aligned.
extern "C" int pixparse_moe_expert_wgrad(const void* a, const void* b, void* c,
                                         const void* offsets, int E, int M, int N,
                                         void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || M % kBM || N % kBN || M / kBM > 65535 ||
      !aligned16(a) || !aligned16(b) || !aligned16(c))
    return invalid;
  cudaError_t err = cudaFuncSetAttribute(moe_expert_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemWgrad);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / kBN, M / kBM, E);
  moe_expert_wgrad_kernel<<<grid, kThreads, kSmemWgrad, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(c), static_cast<const int*>(offsets), M, N);
  return static_cast<int>(cudaGetLastError());
}
