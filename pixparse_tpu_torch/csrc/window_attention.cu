// Swin window attention forward for Hopper (sm_90a), bound through a plain C
// entry point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/window_attention.py::_fwd_kernel
// : per window of ww tokens and per head,
//   o = softmax(q k^T * Dh^-0.5 + bias[h] + mask[w % nW]) v
// with q/k/v (nB, ww, C = H * Dh), windows ordered b * nW + w. The scale
// multiplies the fp32 product, then bias + mask is added (summed once per
// window position: at most one fp32 rounding of a logit from the TPU
// kernel's order, none for Swin's 0 / -1e9 masks), the softmax runs in fp32
// and p is rounded to the input dtype before p v (bf16), as the TPU kernel
// does.
//
// What bounds it on an H100: at donut_base's stage 0 (B = 8, 2560x1920:
// 24576 windows of ww = 100, H = 4, Dh = 32, bf16) the two products are
// 4 * ww^2 * C = 5.1 MFLOP per window against 4 * ww * C * 2 = 102 KB of
// q/k/v/o, ~50 FLOP per byte, far below the card's ~295 FLOP/byte ridge:
// it is bound by the bytes of q, k, v and o, plus the shift mask (nW x ww x
// ww fp32, 123 MB at stage 0, more than the 50 MB L2), read once.
//
// What the design does about it (the ring, the plan and the score step are
// window_ring.cuh's, shared with the backward):
// - persistent blocks, one wave: block (head h, run r) walks a static,
//   balanced run of (window position, image) items of head h
//   (ops/window_attention.py::window_plan). bias[h] comes into shared
//   memory once per run by one bulk copy; with a mask, mask[w] comes once
//   per window position into one of two slots, where a combiner warp adds
//   bias[h] to it; the scores read that one table;
// - one producer thread keeps each window's q, k and v tiles (one head's
//   Dh channels, read in place through the row stride: q/k/v are column
//   slices of the fused qkv projection) in flight by TMA through a ring of
//   four to six stages (a 3-D tensor map per operand zero-fills the rows
//   past ww), so the loads of the next windows overlap the products of
//   this one; the consumers wait on the stage's mbarrier and release it, no
//   block-wide barrier;
// - two units of one warp per 16-row tile (7 warps at ww = 100) take the
//   run's items in turns, so 14 warps share one copy of bias and mask. A
//   warp needs no other warp's results: s = q k^T on mma.sync m16n8k16
//   (bf16 in, fp32 accumulate) for its whole key row in registers, scale,
//   bias, mask, padded keys -inf, row max and sum reduced across the quad,
//   p rounded to bf16 straight from the accumulators into the A fragments
//   of p v; only the ww real rows are stored.
// mma.sync, not wgmma: a warp's 16 rows pad ww = 100 to 112 (wgmma's
// 64-row tiles to 128), and each warp walks its rows with no barrier.
//
// fp32 inputs take a SIMT kernel (fp32 FMA, no tensor cores) over the same
// runs; it exists for the fp32 parity path, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "window_ring.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::window;

constexpr int kWarps = 4;      // fp32 kernel
constexpr int kMaxStages = 6;  // bf16 kernel's ring

template <int kRowTiles>
struct FwdShape {
  static constexpr int kUnits = kRowTiles <= 7 ? 2 : 1;
  static constexpr int kConsumers = kUnits * kRowTiles * 32;
  static constexpr int kThreads = kConsumers + 64;  // + the producer and combiner warps
};

template <int D, int kRowTiles>
__global__ void __launch_bounds__(FwdShape<kRowTiles>::kThreads, 1) window_fwd_ring_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ o, const RingLayout L,
    int n_images, int period, int N, int H, int runs, int nn, int ldb, float scale) {
  using S = FwdShape<kRowTiles>;
  constexpr int kKeyTiles = 2 * kRowTiles;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const RingBars rb{base + static_cast<uint32_t>(L.bar_off), L.stages, L.slots};
  const Run run = block_run(H, runs, period * n_images);
  init_ring(rb, kRowTiles * 32, S::kConsumers);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == S::kUnits * kRowTiles) {  // the producer warp
    if (lane == 0) {
      const CUtensorMap* const maps[3] = {&tm_q, &tm_k, &tm_v};
      produce<D, 3, false>(L, rb, base, gbase, maps, run, n_images, period, bias, mask, nn, lane);
    }
    return;
  }
  if (warp == S::kUnits * kRowTiles + 1) {  // the combiner warp
    if (L.slots) combine(L, rb, gbase, run, n_images, lane);
    return;
  }
  const int unit = warp / kRowTiles, row0 = (warp % kRowTiles) * 16;
  const int t = lane % 4, r_lo = row0 + lane / 4;
  const int C = H * D;
  const float* sBias = reinterpret_cast<const float*>(gbase + L.bias_off);
  if (L.bias_smem) mbar_wait(rb.bias_full(), 0);
  const int len = run.end - run.begin, w_first = run.begin / n_images;
  for (int n = unit; n < len; n += S::kUnits) {
    const int i = run.begin + n, w = i / n_images, b = i - w * n_images;
    const float* table = sBias;  // or its window position's bias + mask
    if (L.slots) {
      const int j = w - w_first, slot = j % L.slots;
      table = reinterpret_cast<const float*>(gbase + L.slot_off + slot * L.table_bytes);
      mbar_wait(rb.slot_ready(slot), (j / L.slots) & 1);
    }
    const int st = n % L.stages;
    mbar_wait(rb.tile_full(st), (n / L.stages) & 1);
    const uint32_t sQ = base + L.stage_off + st * 3 * L.tile_bytes;
    const uint32_t sK = sQ + L.tile_bytes, sV = sK + L.tile_bytes;

    float s[kKeyTiles][4];
    rows_x_rows<D, kRowTiles>(s, sQ, sK, row0, lane);
    float inv[2];
    softmax_rows<kRowTiles, false>(s, table, table, N, ldb, scale, r_lo, t, inv);
    release_masks(rb, L, run, n_images, n, S::kUnits);

    // o = p v, p normalised and rounded to bf16 in the A fragments
    float acc[kDTiles][4];
#pragma unroll
    for (int d = 0; d < kDTiles; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]),
                             pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]),
                             pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]),
                             pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bv[4];
        b_frag_kn<D>(bv, sV, kk * 16, n2 * 16, lane);
        mma_bf16_16816(acc[2 * n2], a, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * n2 + 1], a, bv[2], bv[3]);
      }
    }
    mbar_arrive(rb.tile_empty(st));  // this thread's reads of the stage are done

    __nv_bfloat16* ob = o + (static_cast<long long>(b) * period + w) * N * C + run.h * D + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r_lo + 8 * hr;
      if (row >= N) continue;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row) * C + d * 8) =
            __floats2bfloat162_rn(acc[d][2 * hr], acc[d][2 * hr + 1]);
    }
  }
}

// fp32 path: one warp per query row at a time; lanes split the keys for the
// scores and the head dim for p v. bias[h] + mask[w] is summed into shared
// memory whenever the run reaches a new window position.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) window_attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ o,
    int n_images, int period, int N, int H, int runs, int nn, int ldb, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale) {
  constexpr int kLds = D + 1;
  constexpr int kKeysPerLane = (kMaxTokens + 31) / 32;
  extern __shared__ float smem_f[];
  float* sQ = smem_f;
  float* sK = sQ + N * kLds;
  float* sV = sK + N * kLds;
  float* sP = sV + N * kLds;  // one probability row per warp
  float* sBM = sP + kWarps * kMaxTokens;  // bias[h] + mask[w]

  const Run run = block_run(H, runs, period * n_images);
  const int C = H * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_row = sP + warp * kMaxTokens;
  const float* bias_h = bias + static_cast<long long>(run.h) * nn;
  int w_cur = -1;

  for (int i = run.begin; i < run.end; ++i) {
    const int w = i / n_images, b = i - w * n_images;
    const long long win = static_cast<long long>(b) * period + w;
    __syncthreads();
    if (w != w_cur) {
      const float* mask_w = mask ? mask + static_cast<long long>(w) * nn : nullptr;
      for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
        const int r = e / N, c = e % N;
        sBM[e] = mask_w ? bias_h[r * ldb + c] + mask_w[r * ldb + c] : bias_h[r * ldb + c];
      }
      w_cur = w;
    }
    for (int e = threadIdx.x; e < N * D; e += blockDim.x) {
      const int r = e / D, c = e % D;
      sQ[r * kLds + c] = q[win * q_bs + static_cast<long long>(r) * q_rs + run.h * D + c];
      sK[r * kLds + c] = k[win * k_bs + static_cast<long long>(r) * k_rs + run.h * D + c];
      sV[r * kLds + c] = v[win * v_bs + static_cast<long long>(r) * v_rs + run.h * D + c];
    }
    __syncthreads();
    for (int row = warp; row < N; row += kWarps) {
      float sc[kKeysPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        const int col = lane + 32 * e;
        float x = -INFINITY;
        if (col < N) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(sQ[row * kLds + d], sK[col * kLds + d], dot);
          x = dot * scale + sBM[row * N + col];
        }
        sc[e] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      float l = 0.f;
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        sc[e] = expf(sc[e] - mx);
        l += sc[e];
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) l += __shfl_xor_sync(0xffffffffu, l, s);
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        const int col = lane + 32 * e;
        if (col < N) p_row[col] = sc[e] / l;
      }
      __syncwarp();
      float* orow = o + win * N * C + static_cast<long long>(row) * C + run.h * D;
      for (int d = lane; d < D; d += 32) {
        float acc = 0.f;
        for (int c = 0; c < N; ++c) acc = fmaf(p_row[c], sV[c * kLds + d], acc);
        orow[d] = acc;
      }
      __syncwarp();  // p_row is rewritten by this warp's next row
    }
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  const float *bias, *mask;
  void* o;
  int n_images, period, N, H, runs, nn, ldb;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;
  cudaStream_t stream;
};

template <int D, int kRowTiles>
bool ring_bf16(int nn, bool has_mask, RingLayout* L) {
  return choose_ring(L, 3, 16 * kRowTiles, D, nn, has_mask, true, 0, kMaxStages,
                     max_smem_optin());
}

template <int D, int kRowTiles>
struct ConfigBf16 {
  static int run(int nn, bool has_mask, Config* cfg) {
    if (!ring_bf16<D, kRowTiles>(nn, has_mask, &cfg->L)) return kInvalid;
    cfg->threads = FwdShape<kRowTiles>::kThreads;
    return occupancy<window_fwd_ring_kernel<D, kRowTiles>>(cfg);
  }
};

template <int D, int kRowTiles>
struct LaunchBf16 {
  static int run(const FwdArgs& a) {
    RingLayout L;
    if (!ring_bf16<D, kRowTiles>(a.nn, a.mask != nullptr, &L)) return kInvalid;
    const int err = allow_smem<window_fwd_ring_kernel<D, kRowTiles>>(L.smem);
    if (err) return err;
    const int nB = a.n_images * a.period, C = a.H * D, npad = 16 * kRowTiles;
    CUtensorMap tq, tk, tv;
    if (!make_window_map<D>(&tq, a.q, C, a.N, nB, npad, a.q_rs, a.q_bs) ||
        !make_window_map<D>(&tk, a.k, C, a.N, nB, npad, a.k_rs, a.k_bs) ||
        !make_window_map<D>(&tv, a.v, C, a.N, nB, npad, a.v_rs, a.v_bs))
      return kInvalid;
    window_fwd_ring_kernel<D, kRowTiles>
        <<<a.H * a.runs, FwdShape<kRowTiles>::kThreads, L.smem, a.stream>>>(
            tq, tk, tv, a.bias, a.mask, static_cast<__nv_bfloat16*>(a.o), L, a.n_images,
            a.period, a.N, a.H, a.runs, a.nn, a.ldb, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int D>
int f32_smem(int N) {
  return static_cast<int>((3ull * N * (D + 1) + kWarps * kMaxTokens + N * N) * sizeof(float));
}

template <int D>
struct ConfigF32 {
  static int run(int N, Config* cfg) {
    cfg->L = RingLayout{};
    cfg->L.smem = f32_smem<D>(N);
    cfg->threads = kWarps * 32;
    return occupancy<window_attn_f32_kernel<D>>(cfg);
  }
};

template <int D>
struct LaunchF32 {
  static int run(const FwdArgs& a) {
    const int smem = f32_smem<D>(a.N);
    const int err = allow_smem<window_attn_f32_kernel<D>>(smem);
    if (err) return err;
    window_attn_f32_kernel<D><<<a.H * a.runs, kWarps * 32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.bias, a.mask, static_cast<float*>(a.o), a.n_images,
        a.period, a.N, a.H, a.runs, a.nn, a.ldb, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs,
        a.v_rs, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v are (nB, N, H*D) with batch and
// row strides in elements (channels contiguous, rows 16-byte aligned); bias
// is (H, nn) fp32 and mask (period, nn) fp32 or NULL (then period is 1),
// each table N rows of ldb floats (ldb = N rounded up to even, nn = N * ldb
// rounded up to a multiple of 4: what table_ldb / table_nn give); o is a
// contiguous (nB, N, H*D) tensor of the q dtype. nB must be a multiple of
// period. The grid is H * runs blocks (ops/window_attention.py::window_plan).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pixparse_window_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* bias, const void* mask, void* o, int nB,
                                        int period, int N, int H, int D, int nn, int ldb,
                                        int runs, long long q_bs, long long q_rs, long long k_bs,
                                        long long k_rs, long long v_bs, long long v_rs,
                                        float scale, void* stream) {
  if (nB <= 0 || H <= 0 || period <= 0 || nB % period || N <= 0 || N > kMaxTokens ||
      runs <= 0 || nn != table_nn(N) || ldb != table_ldb(N))
    return kInvalid;
  FwdArgs a{q, k, v, static_cast<const float*>(bias), static_cast<const float*>(mask), o,
            nB / period, period, N, H, runs, nn, ldb, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale,
            static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return by_shape<LaunchBf16>(N, D, a);
  if (dtype == 0) return by_head_dim<LaunchF32>(D, a);
  return kInvalid;
}

// The launch configuration of (dtype, N, D, with or without a mask), for
// the plan: out[] as window_ring.cuh's config_out writes it (blocks per SM
// from the kernel's registers and shared memory). Returns a CUDA error code
// (0 = success).
extern "C" int pixparse_window_attn_fwd_config(int dtype, int N, int D, int has_mask, int* out) {
  if (N <= 0 || N > kMaxTokens) return kInvalid;
  Config cfg;
  int err = kInvalid;
  if (dtype == 1) err = by_shape<ConfigBf16>(N, D, table_nn(N), has_mask != 0, &cfg);
  if (dtype == 0) err = by_head_dim<ConfigF32>(D, N, &cfg);
  if (err) return err;
  config_out(cfg, out);
  return 0;
}
