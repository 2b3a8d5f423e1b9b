// Swin window attention backward for Hopper (sm_90a), bound through a plain
// C entry point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/window_attention.py::_bwd_kernel
// : per window of ww tokens and per head, from q, k, v (the forward's inputs,
// no lse saved) and do,
//   s  = q k^T * scale + (bias[h] + mask[w % nW])    fp32, row max and sum
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
// What the design does about it (the ring, the plan and the score step are
// window_ring.cuh's, shared with the forward):
// - persistent blocks, one wave: block (head h, run r) walks a static,
//   balanced run of (window position, image) items of head h
//   (ops/window_attention.py::window_plan). bias[h] comes into shared
//   memory once per run by one bulk copy; with a mask, mask[w] comes once
//   per window position into one of two slots, where the producer warp
//   adds bias[h] to it (at most one fp32 rounding of a logit from the TPU
//   kernel's order, none for Swin's 0 / -1e9 masks);
// - one producer thread keeps each window's q, k, v and do tiles in flight
//   by TMA through a ring of two (with a mask) or three stages (3-D tensor
//   maps read q/k/v in place through their row stride and zero-fill the
//   rows past ww), so the next window's loads overlap this one's products;
// - dbias: the block stays on one head, so each consumer thread keeps the
//   running sum of ds for the (query, key) pairs it owns in registers for
//   the whole run and writes them once, as the block's fp32 partial; a
//   second small kernel sums each head's partials in a fixed order, so the
//   result is deterministic (no atomics) and shared memory takes no
//   per-window read-modify-write;
// - one warp per 16-row tile (7 warps at ww = 100) recomputes s and the
//   softmax for its query rows (the whole key row in registers), dp = do
//   v^T and ds; bf16(p) and bf16(ds * scale) go to two shared tiles (by
//   stmatrix, a 16 x 16 block an instruction), each warp forms dq for its
//   query rows from its registers, then dv = p^T do and dk = ds^T q for
//   its 16-key tile by transposed ldmatrix loads of the two tiles (two
//   warps a tile, each half the keys, spilled at 128 registers and were
//   slower). The tiles' hand-over is two mbarriers, each thread arriving
//   where its part is done and waiting only where it needs the others': the
//   write of window n + 1's tiles waits for window n's reads while the
//   thread has already done n + 1's scores, and dq runs between the write
//   and the wait for everyone's. All products are mma.sync m16n8k16 (bf16
//   in, fp32 accumulate). Padded rows carry p = ds = 0, padded keys p = 0,
//   and only the ww real rows are stored.
// mma.sync, not wgmma: each thread's accumulator pairs are the (query, key)
// pairs whose dbias it sums, with one warp per 16 rows (ww = 100 pads to
// 112, not wgmma's 128).
// At window 12 with Dh = 64 (ww > 128) the table, the ring and the p / ds
// tiles do not all fit in shared memory: there bias and mask are read
// through the L1 cache per score instead.
//
// fp32 inputs take a SIMT kernel (fp32 FMA, no tensor cores) over the same
// runs and partials; it exists for the fp32 parity path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "window_ring.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::window;

constexpr int kF32Warps = 4;
constexpr int kReduceThreads = 256;
constexpr int kMaxStages = 3;

template <int kRowTiles>
struct BwdShape {
  static constexpr int kNPad = 16 * kRowTiles;
  static constexpr int kLdp = kNPad + 8;  // p / ds tile row stride
  static constexpr int kPSBytes = kNPad * kLdp * 2;
  // the p and ds tiles, then the mbarriers that order their writes and reads
  static constexpr int kExtraBytes = 2 * kPSBytes + 16;
  static constexpr int kConsumers = kRowTiles * 32;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
};

// kBmSmem: the scores' table (bias[h], or bias + mask) in shared memory
// (false only where it does not fit beside the ring and the p / ds tiles,
// at ww > 128 with Dh = 64: bias and mask read through the L1 cache then).
template <int D, int kRowTiles, bool kBmSmem>
__global__ void __launch_bounds__(BwdShape<kRowTiles>::kThreads, 1) window_bwd_ring_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ bias, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ partial, const RingLayout L,
    int n_images, int period, int N, int H, int runs, int nn, int ldb, float scale) {
  using S = BwdShape<kRowTiles>;
  constexpr int kKeyTiles = 2 * kRowTiles;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const RingBars rb{base + static_cast<uint32_t>(L.bar_off), L.stages, L.slots};
  const Run run = block_run(H, runs, period * n_images);
  // ps_full: every consumer thread has written its share of item n's p and
  // ds tiles; ps_free: every consumer thread is done reading item n's
  const uint32_t ps_full = base + L.extra_off + 2 * S::kPSBytes, ps_free = ps_full + 8;
  if (threadIdx.x == 0) {
    mbar_init(ps_full, S::kConsumers);
    mbar_init(ps_free, S::kConsumers);
  }
  init_ring(rb, S::kConsumers, S::kConsumers);  // (fences the inits above too)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kRowTiles) {  // the producer warp
    const WindowMaps<D, 4> load{{&tm_q, &tm_k, &tm_v, &tm_do}};
    produce<4, true>(L, rb, base, gbase, load, run, n_images, period, bias, mask, nn, lane);
    return;
  }
  const int row0 = warp * 16;
  const int t = lane % 4, r_lo = row0 + lane / 4;
  const int C = H * D;
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(gbase + L.extra_off);  // bf16(p)
  __nv_bfloat16* sDS = sP + S::kNPad * S::kLdp;                               // bf16(ds * scale)
  const float* bias_src = kBmSmem ? reinterpret_cast<const float*>(gbase + L.bias_off)
                                  : bias + static_cast<long long>(run.h) * nn;
  if (L.bias_smem) mbar_wait(rb.bias_full(), 0);
  const int len = run.end - run.begin, w_first = run.begin / n_images;

  float db[kKeyTiles][4];  // this run's sum of ds over the pairs this thread owns
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) db[j][0] = db[j][1] = db[j][2] = db[j][3] = 0.f;

  for (int n = 0; n < len; ++n) {
    const int i = run.begin + n, w = i / n_images, b = i - w * n_images;
    // the scores' table: bias[h], or its window position's bias + mask
    // (in shared memory); bias and mask apart where they are read from
    // device memory
    const float* table = bias_src;
    const float* mask_src = bias_src;
    if (mask) {
      if constexpr (kBmSmem) {
        const int j = w - w_first, slot = j % L.slots;
        table = reinterpret_cast<const float*>(gbase + L.slot_off + slot * L.table_bytes);
        mbar_wait(rb.slot_ready(slot), (j / L.slots) & 1);
      } else {
        mask_src = mask + static_cast<long long>(w) * nn;
      }
    }
    const int st = n % L.stages;
    mbar_wait(rb.tile_full(st), (n / L.stages) & 1);
    const uint32_t sQ = base + L.stage_off + st * 4 * L.tile_bytes;
    const uint32_t sK = sQ + L.tile_bytes, sV = sK + L.tile_bytes, sDO = sV + L.tile_bytes;

    // p = softmax(s), fp32, for this warp's query rows
    float s[kKeyTiles][4];
    rows_x_rows<D, kRowTiles>(s, sQ, sK, row0, lane);
    float inv[2];
    if (!kBmSmem && mask)
      softmax_rows<kRowTiles, true>(s, bias_src, mask_src, N, ldb, scale, r_lo, t, inv);
    else
      softmax_rows<kRowTiles, false>(s, table, table, N, ldb, scale, r_lo, t, inv);
    release_masks(rb, L, run, n_images, n, 1);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];

    // dp = do v^T (the same product form as q k^T)
    float dp[kKeyTiles][4];
    rows_x_rows<D, kRowTiles>(dp, sDO, sV, row0, lane);

    // ds = p (dp - sum_j p dp); rows past the window carry p = ds = 0
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += s[j][e] * dp[j][e];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ds = s[j][e] * (dp[j][e] - rs[e >> 1]);
        if (r_lo + 8 * (e >> 1) >= N) s[j][e] = ds = 0.f;
        db[j][e] += ds;
        dp[j][e] = ds;
      }
    }

    // bf16(p) and bf16(ds * scale) to the shared tiles, once every thread
    // is done reading the previous window's
    mbar_wait(ps_free, (n & 1) ^ 1);
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {  // one 16 x 16 block a stmatrix
      const int off = (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kLdp + kk * 16 +
                      (lane >> 4) * 8;
      stsm_x4(smem_addr(sP + off),
              {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])});
      stsm_x4(smem_addr(sDS + off),
              {pack_bf16(dp[2 * kk][0] * scale, dp[2 * kk][1] * scale),
               pack_bf16(dp[2 * kk][2] * scale, dp[2 * kk][3] * scale),
               pack_bf16(dp[2 * kk + 1][0] * scale, dp[2 * kk + 1][1] * scale),
               pack_bf16(dp[2 * kk + 1][2] * scale, dp[2 * kk + 1][3] * scale)});
    }
    mbar_arrive(ps_full);

    const long long win = static_cast<long long>(b) * period + w;
    float acc[kDTiles][4];
    auto store = [&](__nv_bfloat16* out) {
      __nv_bfloat16* ob = out + win * N * C + run.h * D + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r_lo + 8 * hr;
        if (row >= N) continue;
#pragma unroll
        for (int d = 0; d < kDTiles; ++d)
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row) * C + d * 8) =
              __floats2bfloat162_rn(acc[d][2 * hr], acc[d][2 * hr + 1]);
      }
    };
    auto zero = [&] {
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    };

    // dq for this warp's query rows, bf16(ds * scale) straight from the
    // registers (the same rounding as the shared copy), while the other
    // warps finish their tiles
    zero();
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(dp[2 * kk][0] * scale, dp[2 * kk][1] * scale),
                             pack_bf16(dp[2 * kk][2] * scale, dp[2 * kk][3] * scale),
                             pack_bf16(dp[2 * kk + 1][0] * scale, dp[2 * kk + 1][1] * scale),
                             pack_bf16(dp[2 * kk + 1][2] * scale, dp[2 * kk + 1][3] * scale)};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bk[4];
        b_frag_kn<D>(bk, sK, kk * 16, n2 * 16, lane);
        mma_bf16_16816(acc[2 * n2], a, bk[0], bk[1]);
        mma_bf16_16816(acc[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }
    store(dq);
    mbar_wait(ps_full, n & 1);  // both tiles are complete

    // dv for this warp's key rows: dv[j, :] = sum_i bf16(p)[i, j] do[i, :]
    zero();
#pragma unroll
    for (int kk = 0; kk < kRowTiles; ++kk) {
      uint32_t pa[4];
      load_a_frag_trans(pa, sP, S::kLdp, row0, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bb[4];
        b_frag_kn<D>(bb, sDO, kk * 16, n2 * 16, lane);
        mma_bf16_16816(acc[2 * n2], pa, bb[0], bb[1]);
        mma_bf16_16816(acc[2 * n2 + 1], pa, bb[2], bb[3]);
      }
    }
    store(dv);

    // dk for this warp's key rows: dk[j, :] = sum_i bf16(ds * scale)[i, j] q[i, :]
    zero();
#pragma unroll
    for (int kk = 0; kk < kRowTiles; ++kk) {
      uint32_t da[4];
      load_a_frag_trans(da, sDS, S::kLdp, row0, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bq[4];
        b_frag_kn<D>(bq, sQ, kk * 16, n2 * 16, lane);
        mma_bf16_16816(acc[2 * n2], da, bq[0], bq[1]);
        mma_bf16_16816(acc[2 * n2 + 1], da, bq[2], bq[3]);
      }
    }
    mbar_arrive(ps_free);            // this thread's reads of the p and ds tiles are done
    mbar_arrive(rb.tile_empty(st));  // and of the stage
    store(dk);
  }

  // the run's dbias partial: one write per owned (query, key) pair
  float* part = partial + (static_cast<long long>(run.h) * runs + run.r) * N * N;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r_lo + 8 * (e >> 1), col = j * 8 + 2 * t + (e & 1);
      if (row < N && col < N) part[row * N + col] = db[j][e];
    }
  }
}

// fp32 path: one warp per query row at a time (lanes split the keys), p and
// ds rows in shared memory, then threads over (row, channel) for dq, dk, dv.
// q/k/v/do, bias and mask are read through the L1 cache; the dbias partial
// lives in device memory, each element owned by one thread of the block.
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32) window_attn_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ mask,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ partial, int n_images, int period, int N, int H, int runs, int nn,
    int ldb, long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, long long do_bs, long long do_rs, float scale) {
  constexpr int kKeysPerLane = (kMaxTokens + 31) / 32;
  extern __shared__ float smem_f[];
  float* sP = smem_f;       // N x N
  float* sDS = sP + N * N;  // N x N, unscaled

  const Run run = block_run(H, runs, period * n_images);
  const int C = H * D;
  float* part = partial + (static_cast<long long>(run.h) * runs + run.r) * N * N;
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) part[e] = 0.f;
  __syncthreads();
  const float* bias_h = bias + static_cast<long long>(run.h) * nn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = run.begin; i < run.end; ++i) {
    const int w = i / n_images, b = i - w * n_images;
    const float* mask_w = mask ? mask + static_cast<long long>(w) * nn : nullptr;
    const long long win = static_cast<long long>(b) * period + w;
    const float* qw = q + win * q_bs + run.h * D;
    const float* kw = k + win * k_bs + run.h * D;
    const float* vw = v + win * v_bs + run.h * D;
    const float* dw = dout + win * do_bs + run.h * D;
    for (int row = warp; row < N; row += kF32Warps) {
      float sc[kKeysPerLane], dpv[kKeysPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        const int col = lane + 32 * e;
        float x = -INFINITY, dd = 0.f;
        if (col < N) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) {
            dot = fmaf(qw[row * q_rs + d], kw[col * k_rs + d], dot);
            dd = fmaf(dw[row * do_rs + d], vw[col * v_rs + d], dd);
          }
          x = dot * scale + bias_h[row * ldb + col];
          if (mask_w) x += mask_w[row * ldb + col];
        }
        sc[e] = x;
        dpv[e] = dd;
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
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        sc[e] /= l;
        rs += sc[e] * dpv[e];
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, s);
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        const int col = lane + 32 * e;
        if (col < N) {
          const float ds = sc[e] * (dpv[e] - rs);
          sP[row * N + col] = sc[e];
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
      const long long o = win * N * C + static_cast<long long>(r) * C + run.h * D + d;
      dq[o] = aq;
      dk[o] = ak;
      dv[o] = av;
    }
    __syncthreads();  // p and ds are rewritten for the next window
  }
}

// dbias[h, e] = sum over the head's partials, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads) dbias_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dbias, int H, int n_parts, int NN) {
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= H * NN) return;
  const int h = idx / NN, e = idx % NN;
  const float* p = partial + static_cast<long long>(h) * n_parts * NN + e;
  float sum = 0.f;
  for (int i = 0; i < n_parts; ++i) sum += p[static_cast<long long>(i) * NN];
  dbias[idx] = sum;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *mask;
  void *dq, *dk, *dv;
  float* partial;
  int n_images, period, N, H, runs, nn, ldb;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  float scale;
  cudaStream_t stream;
};

// The bf16 kernel's ring at (N, D): bias and mask in shared memory where
// they fit beside two stages (or one), else read through the L1 cache
// (kBmSmem false, instantiated for the widest windows only).
template <int D, int kRowTiles>
bool ring_bf16(int nn, bool has_mask, RingLayout* L) {
  using S = BwdShape<kRowTiles>;
  const int max_smem = max_smem_optin();
  if (choose_ring(L, 4, S::kNPad, D, nn, has_mask, true, S::kExtraBytes, kMaxStages, max_smem))
    return true;
  if (kRowTiles < 8) return false;
  return choose_ring(L, 4, S::kNPad, D, nn, has_mask, false, S::kExtraBytes, kMaxStages,
                     max_smem);
}

template <int D, int kRowTiles, bool kBmSmem>
int launch_ring(const Args& a, const RingLayout& L) {
  const int err = allow_smem<window_bwd_ring_kernel<D, kRowTiles, kBmSmem>>(L.smem);
  if (err) return err;
  const int nB = a.n_images * a.period, C = a.H * D, npad = BwdShape<kRowTiles>::kNPad;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_window_map<D>(&tq, a.q, C, a.N, nB, npad, a.q_rs, a.q_bs) ||
      !make_window_map<D>(&tk, a.k, C, a.N, nB, npad, a.k_rs, a.k_bs) ||
      !make_window_map<D>(&tv, a.v, C, a.N, nB, npad, a.v_rs, a.v_bs) ||
      !make_window_map<D>(&tdo, a.dout, C, a.N, nB, npad, a.do_rs, a.do_bs))
    return kInvalid;
  window_bwd_ring_kernel<D, kRowTiles, kBmSmem>
      <<<a.H * a.runs, BwdShape<kRowTiles>::kThreads, L.smem, a.stream>>>(
          tq, tk, tv, tdo, a.bias, a.mask, static_cast<__nv_bfloat16*>(a.dq),
          static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.partial, L,
          a.n_images, a.period, a.N, a.H, a.runs, a.nn, a.ldb, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// tables read from device memory: only where neither bias nor a mask slot
// fits in shared memory
inline bool tables_in_global(const RingLayout& L) { return !L.bias_smem && !L.slots; }

template <int D, int kRowTiles>
struct ConfigBf16 {
  static int run(int nn, bool has_mask, Config* cfg) {
    if (!ring_bf16<D, kRowTiles>(nn, has_mask, &cfg->L)) return kInvalid;
    cfg->threads = BwdShape<kRowTiles>::kThreads;
    if constexpr (kRowTiles >= 8) {
      if (tables_in_global(cfg->L))
        return occupancy<window_bwd_ring_kernel<D, kRowTiles, false>>(cfg);
    }
    return occupancy<window_bwd_ring_kernel<D, kRowTiles, true>>(cfg);
  }
};

template <int D, int kRowTiles>
struct LaunchBf16 {
  static int run(const Args& a) {
    RingLayout L;
    if (!ring_bf16<D, kRowTiles>(a.nn, a.mask != nullptr, &L)) return kInvalid;
    if constexpr (kRowTiles >= 8) {
      if (tables_in_global(L)) return launch_ring<D, kRowTiles, false>(a, L);
    }
    return launch_ring<D, kRowTiles, true>(a, L);
  }
};

template <int D>
int f32_smem(int N) {
  return static_cast<int>(2ull * N * N * sizeof(float));
}

template <int D>
struct ConfigF32 {
  static int run(int N, Config* cfg) {
    cfg->L = RingLayout{};
    cfg->L.smem = f32_smem<D>(N);
    cfg->threads = kF32Warps * 32;
    return occupancy<window_attn_bwd_f32_kernel<D>>(cfg);
  }
};

template <int D>
struct LaunchF32 {
  static int run(const Args& a) {
    const int smem = f32_smem<D>(a.N);
    const int err = allow_smem<window_attn_bwd_f32_kernel<D>>(smem);
    if (err) return err;
    window_attn_bwd_f32_kernel<D><<<a.H * a.runs, kF32Warps * 32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.bias, a.mask,
        static_cast<float*>(a.dq), static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.partial, a.n_images, a.period, a.N, a.H, a.runs, a.nn, a.ldb, a.q_bs, a.q_rs, a.k_bs,
        a.k_rs, a.v_bs, a.v_rs, a.do_bs, a.do_rs, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/do are (nB, N, H*D) with batch
// and row strides in elements (channels contiguous, rows 16-byte aligned);
// bias is (H, nn) fp32 and mask (period, nn) fp32 or NULL (then period is
// 1), each table N rows of ldb floats (ldb = N rounded up to even, nn = N *
// ldb rounded up to a multiple of 4). The grid is H * runs blocks
// (ops/window_attention.py::window_plan), block r * H + h taking run r of
// head h; partial is (H, runs, N, N) fp32 scratch, one partial per block.
// dq, dk, dv are contiguous (nB, N, H*D) tensors of the q dtype, dbias a
// contiguous (H, N, N) fp32 tensor, every element written. Returns the CUDA
// error code of the launches (0 = success).
extern "C" int pixparse_window_attn_bwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* dout, const void* bias, const void* mask,
                                        void* dq, void* dk, void* dv, void* partial, void* dbias,
                                        int nB, int period, int N, int H, int D, int nn, int ldb,
                                        int runs, long long q_bs, long long q_rs, long long k_bs,
                                        long long k_rs, long long v_bs, long long v_rs,
                                        long long do_bs, long long do_rs, float scale,
                                        void* stream) {
  if (nB <= 0 || H <= 0 || period <= 0 || nB % period || N <= 0 || N > kMaxTokens ||
      runs <= 0 || nn != table_nn(N) || ldb != table_ldb(N))
    return kInvalid;
  Args a{q, k, v, dout, static_cast<const float*>(bias), static_cast<const float*>(mask),
         dq, dk, dv, static_cast<float*>(partial), nB / period, period, N, H, runs, nn, ldb,
         q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, scale,
         static_cast<cudaStream_t>(stream)};
  int err = kInvalid;
  if (dtype == 1) err = by_shape<LaunchBf16>(N, D, a);
  if (dtype == 0) err = by_head_dim<LaunchF32>(D, a);
  if (err) return err;
  const int NN = N * N;
  dbias_reduce_kernel<<<(H * NN + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                        a.stream>>>(static_cast<const float*>(partial),
                                    static_cast<float*>(dbias), H, runs, NN);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration of (dtype, N, D, with or without a mask), for
// the plan: out[] as window_ring.cuh's config_out writes it (blocks per SM
// from the kernel's registers and shared memory). Returns a CUDA error code
// (0 = success).
extern "C" int pixparse_window_attn_bwd_config(int dtype, int N, int D, int has_mask, int* out) {
  if (N <= 0 || N > kMaxTokens) return kInvalid;
  Config cfg;
  int err = kInvalid;
  if (dtype == 1) err = by_shape<ConfigBf16>(N, D, table_nn(N), has_mask != 0, &cfg);
  if (dtype == 0) err = by_head_dim<ConfigF32>(D, N, &cfg);
  if (err) return err;
  config_out(cfg, out);
  return 0;
}
