// Fused tied-head cross entropy for Hopper (sm_90a), bound through plain C
// entry points (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernels
//   pixparse_tpu/ops/loss.py::_ce_fwd_kernel   (per-token lse and target logit)
//   pixparse_tpu/ops/loss.py::_ce_bwd_kernel   (dh and dE)
// The logits s = h E^T of T tokens against a vocabulary of V rows are
// computed tile by tile on the tensor cores and never reach device memory:
//   forward:  lse[t] = logsumexp_v s[t, v],  tgt[t] = s[t, target[t]]
//   backward: g = (exp(s - lse) - onehot(target)) * coef   rounded to h's dtype
//             dh = g E,  dE = g^T h                         fp32 accumulation
// Ignored tokens carry target -1 (matches no column) and coef 0. Vocabulary
// rows >= V (V = 50265 is odd, the last tile is ragged) are masked in the
// kernel; the table is never padded in device memory.
//
// What bounds it on an H100: at T = 16368, V = 50265, D = 768 each product is
// 2*T*V*D = 1.26e12 FLOP against ~100 MB of operands, far above the card's
// ~295 FLOP/byte ridge: tensor-core throughput bounds it, as long as the
// (T, V) logits stay on the SM.
//
// What the design does about it. The TPU kernel walks a sequential grid and
// carries accumulators from step to step; here blocks are independent, so
// every reduction is a loop inside one block, and the backward is two
// deterministic passes that each recompute s (no atomics):
// - all kernels keep one operand tile `X` resident in shared memory over the
//   whole depth D and stream the other operand `Y` past it in chunks of
//   64 rows x 64 columns through a 3-stage cp.async ring; the products are
//   mma.sync m16n8k16 with ldmatrix operand loads;
// - forward: X = 64 tokens; a block walks the whole vocabulary, each thread
//   keeps an online (max, sum-exp, target logit) over the columns it owns,
//   and the partials are merged once at the end;
// - backward dh: X = 64 tokens (16 warps), Y = vocabulary tiles of 64 rows. Per tile: phase 1 streams Y's 64-column
//   chunks as slices of the depth to build s (64 x 64), g goes to shared
//   memory in bf16, phase 2 streams the same chunks again (an L2 hit) as
//   slices of the output width and accumulates dh (64 x D) in fp32
//   registers, written once;
// - backward dE: the same kernel with the roles swapped (X = 64 vocabulary
//   rows, Y = token tiles), s^T and g^T directly, dE (64 x D) in registers;
// - at D = 1024 the (64 x D) fp32 accumulator would need 128 registers a
//   thread of the 512-thread block before any operand, so the output is split
//   into two 512-column halves (blockIdx.y): each block still builds s over the
//   whole depth (phase 1 is done twice in all) and accumulates only its half
//   in phase 2. Chosen over a 32-row resident tile, which re-reads the
//   streamed operand twice as often (measured 1.55x slower at D = 768 on an
//   H100), and over a wider block (the 64-row tile's 16 warps already fill
//   the block): the split costs 1.5x the tensor-core work of one pass but
//   only 1.5x, not 2x, the streamed bytes.
// This is the simple first version: the resident tile is as tall as the
// (rows x D) fp32 accumulator allows in registers, and the streamed operand is
// re-read from L2 once per resident tile (T/64 or V/64 times), which is what
// limits it: at 32 rows the two passes measured ~3.5 TB/s of L2 traffic.
// wgmma/TMA, clusters that share the streamed tiles and taller resident tiles
// are later work.
//
// fp32 inputs take SIMT kernels (one block per row, fp32 FMA) with the same
// semantics, for the fp32 parity path, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace pixparse;

constexpr float kDeadLse = -1e30f;
constexpr float kLseFloor = -0.5e30f;
constexpr int kChunk = 64;       // rows and columns of a streamed chunk
constexpr int kLdc = kChunk + 8; // padded chunk row stride
constexpr int kStages = 3;
constexpr int kFwdWarps = 8;
// Backward: 4 warps share each 16-row m-tile of a 64-row resident tile, whose
// (64 x D) fp32 accumulator fits the 128 registers a thread of a 512-thread
// block may hold up to D = 768; wider outputs are split into column parts.
constexpr int kBwdWarps = 16;
constexpr int kBwdRows = 4 * kBwdWarps;

// 64 x 64 chunk of Y (rows y0.., columns c0..) -> shared memory, rows >= ny
// zero-filled. 512 16-byte pieces over the block's threads.
template <int kThreads>
__device__ __forceinline__ void fetch_chunk(__nv_bfloat16* sbuf, const __nv_bfloat16* Y, int D,
                                            int y0, int ny, int c0) {
#pragma unroll
  for (int i = 0; i < 512 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = (idx & 7) * 8;
    const bool valid = y0 + r < ny;
    const __nv_bfloat16* src = Y + (long long)(valid ? y0 + r : 0) * D + c0 + c;
    cp_async_16(sbuf + r * kLdc + c, src, valid);
  }
}

// How a block's warps share a (BM x 64) score tile: warp -> one 16-row m-tile
// and kNT neighbouring 8-column n-tiles.
template <int BM, int kWarps>
struct WarpMap {
  static constexpr int kMTiles = BM / 16;
  static constexpr int kWarpsPerM = kWarps / kMTiles;
  static constexpr int kNT = 8 / kWarpsPerM;
};

// s += X[:, c0 : c0 + 64] * chunk^T for this warp's part of the score tile.
template <int kNT>
__device__ __forceinline__ void score_chunk(float (&s)[kNT][4],
                                            const __nv_bfloat16* sX, int ldx,
                                            const __nv_bfloat16* sY, int c0, int mt, int ng,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    uint32_t xa[4];
    load_a_frag(xa, sX, ldx, mt * 16, c0 + kk * 16, lane);
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      uint32_t b[4];
      load_b_frag_nk(b, sY, kLdc, (ng * kNT + 2 * jp) * 8, kk * 16, lane);
      mma_bf16_16816(s[2 * jp], xa, b[0], b[1]);
      mma_bf16_16816(s[2 * jp + 1], xa, b[2], b[3]);
    }
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return (64 * (D + 8) + kStages * kChunk * kLdc) * (int)sizeof(__nv_bfloat16) +
         2 * 64 * 3 * (int)sizeof(float);
}

template <int D>
constexpr int bwd_smem_bytes() {
  constexpr int BM = kBwdRows;
  return (BM * (D + 8) + kStages * kChunk * kLdc + BM * kLdc) * (int)sizeof(__nv_bfloat16) +
         kChunk * 3 * (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kFwdWarps * 32) ce_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ e,
    const int* __restrict__ target, float* __restrict__ lse_out, float* __restrict__ tgt_out,
    int T, int V) {
  constexpr int BM = 64;
  constexpr int kThreads = kFwdWarps * 32;
  constexpr int kLdx = D + 8;
  constexpr int kNC = D / kChunk;
  constexpr int kNT = WarpMap<BM, kFwdWarps>::kNT;                // 4
  constexpr int kWarpsPerM = WarpMap<BM, kFwdWarps>::kWarpsPerM;  // 2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sY = sX + BM * kLdx;
  float* sStat = reinterpret_cast<float*>(sY + kStages * kChunk * kLdc);  // [2][64][3]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = warp / kWarpsPerM, ng = warp % kWarpsPerM;
  const int t0 = blockIdx.x * BM;

  load_tile_bf16<D, BM>(sX, h, D, t0, T);
  int tgt_id[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = t0 + mt * 16 + g + 8 * i;
    tgt_id[i] = row < T ? target[row] : -1;
  }

  // per-thread online softmax over the columns this thread owns (log2 domain)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tl[2] = {0.f, 0.f};

  const int n_vt = (V + kChunk - 1) / kChunk;
  const int total = n_vt * kNC;
  auto fetch = [&](int j) {
    if (j < total)
      fetch_chunk<kThreads>(sY + (j % kStages) * kChunk * kLdc, e, D, (j / kNC) * kChunk, V,
                            (j % kNC) * kChunk);
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  int j = 0;
  for (int vt = 0; vt < n_vt; ++vt) {
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int c = 0; c < kNC; ++c, ++j) {
      cp_async_wait<1>();
      __syncthreads();
      fetch(j + 2);
      score_chunk<kNT>(s, sX, kLdx, sY + (j % kStages) * kChunk * kLdc, c * kChunk, mt, ng, lane);
    }
    // masks, target logit, online (max, sum-exp)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int el = 0; el < 4; ++el) {
        const int i = el >> 1;
        const int col = vt * kChunk + (ng * kNT + n) * 8 + 2 * t + (el & 1);
        if (col == tgt_id[i]) tl[i] += s[n][el];
        const float x = col < V ? s[n][el] * kLog2e : -INFINITY;
        s[n][el] = x;
        tmax[i] = fmaxf(tmax[i], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], tmax[i]);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        sum += exp2f(s[n][2 * i] - m_use) + exp2f(s[n][2 * i + 1] - m_use);
      l[i] = l[i] * exp2f(m[i] - m_use) + sum;
      m[i] = m_new;
    }
  }
  cp_async_wait<0>();

  // merge the 4 lanes of a quad, then the warps that share the rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[i], sh);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[i], sh);
      const float m_new = fmaxf(m[i], m_o);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      l[i] = l[i] * exp2f(m[i] - m_use) + l_o * exp2f(m_o - m_use);
      m[i] = m_new;
      tl[i] += __shfl_xor_sync(0xffffffffu, tl[i], sh);
    }
    if (t == 0) {
      float* st = sStat + (ng * BM + mt * 16 + g + 8 * i) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = tl[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < BM && t0 + threadIdx.x < T) {
    const float* a = sStat + threadIdx.x * 3;
    const float* b = sStat + (BM + threadIdx.x) * 3;
    const float m_new = fmaxf(a[0], b[0]);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    const float lsum = a[1] * exp2f(a[0] - m_use) + b[1] * exp2f(b[0] - m_use);
    lse_out[t0 + threadIdx.x] = lsum > 0.f ? (m_use + log2f(lsum)) * kLn2 : kDeadLse;
    tgt_out[t0 + threadIdx.x] = a[2] + b[2];
  }
}

// ---------------------------------------------------------------------------
// backward: out (nx, D) = G Y with G (nx, ny) built tile by tile from
// s = X Y^T. kTokensAreRows: X = h, Y = E, out = dh; else X = E, Y = h,
// out = dE.
// ---------------------------------------------------------------------------

// Output column parts a block of the backward accumulates (blockIdx.y picks
// one): the whole width up to D = 768, halves above.
template <int D>
__host__ __device__ constexpr int bwd_parts() {
  return D > 768 ? 2 : 1;
}

template <int D, bool kTokensAreRows>
__global__ void __launch_bounds__(kBwdWarps * 32, 1) ce_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ Y,
    const int* __restrict__ target, const float* __restrict__ lse,
    const float* __restrict__ coef, __nv_bfloat16* __restrict__ out, int nx, int ny, int T,
    int V) {
  constexpr int kWarps = kBwdWarps;
  constexpr int BM = kBwdRows;
  constexpr int kThreads = kWarps * 32;
  constexpr int kLdx = D + 8;
  constexpr int kNC = D / kChunk;
  constexpr int kOutNC = kNC / bwd_parts<D>();  // output chunks of this block
  constexpr int kStepsPerTile = kNC + kOutNC;   // streamed chunks per Y tile
  constexpr int kNT = WarpMap<BM, kWarps>::kNT;                // 2
  constexpr int kWarpsPerM = WarpMap<BM, kWarps>::kWarpsPerM;  // 4
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sY = sX + BM * kLdx;
  __nv_bfloat16* sG = sY + kStages * kChunk * kLdc;
  float* sLse = reinterpret_cast<float*>(sG + BM * kLdc);  // per streamed token
  float* sCoef = sLse + kChunk;
  int* sTgt = reinterpret_cast<int*>(sCoef + kChunk);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = warp / kWarpsPerM, ng = warp % kWarpsPerM;
  const int x0 = blockIdx.x * BM;
  const int out_c0 = blockIdx.y * kOutNC;  // first output chunk of this block

  load_tile_bf16<D, BM>(sX, X, D, x0, nx);

  // per-row token stats when tokens are rows
  float row_lse2[2] = {0.f, 0.f}, row_coef[2] = {0.f, 0.f};
  int row_tgt[2] = {-1, -1};
  if (kTokensAreRows) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = x0 + mt * 16 + g + 8 * i;
      if (row < T) {
        row_lse2[i] = fmaxf(lse[row], kLseFloor) * kLog2e;
        row_coef[i] = coef[row];
        row_tgt[i] = target[row];
      }
    }
  }

  float acc[kOutNC][kNT][4];
#pragma unroll
  for (int c = 0; c < kOutNC; ++c)
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.f;

  const int n_yt = (ny + kChunk - 1) / kChunk;
  // per tile: the kNC chunks of the depth (phase 1), then this block's
  // kOutNC output chunks again (phase 2)
  const int total = n_yt * kStepsPerTile;
  auto fetch = [&](int j) {
    if (j < total) {
      const int r = j % kStepsPerTile;
      const int c = r < kNC ? r : out_c0 + (r - kNC);
      fetch_chunk<kThreads>(sY + (j % kStages) * kChunk * kLdc, Y, D,
                            (j / kStepsPerTile) * kChunk, ny, c * kChunk);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  int j = 0;
  for (int yt = 0; yt < n_yt; ++yt) {
    const int y0 = yt * kChunk;
    if (!kTokensAreRows && threadIdx.x < kChunk) {
      // stats of this tile's tokens: the previous tile's readers are at least
      // one barrier behind, this tile's at least one barrier ahead
      const int tok = y0 + threadIdx.x;
      const bool in = tok < T;
      sLse[threadIdx.x] = in ? fmaxf(lse[tok], kLseFloor) * kLog2e : 0.f;
      sCoef[threadIdx.x] = in ? coef[tok] : 0.f;
      sTgt[threadIdx.x] = in ? target[tok] : -1;
    }
    // phase 1: s = X Y^T over the depth
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c, ++j) {
      cp_async_wait<1>();
      __syncthreads();
      fetch(j + 2);
      score_chunk<kNT>(s, sX, kLdx, sY + (j % kStages) * kChunk * kLdc, c * kChunk, mt, ng, lane);
    }
    // g = (p - onehot) * coef, rounded to bf16, into shared memory
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float gv[4];
#pragma unroll
      for (int el = 0; el < 4; ++el) {
        const int i = el >> 1;
        const int lr = mt * 16 + g + 8 * i;
        const int lc = (ng * kNT + n) * 8 + 2 * t + (el & 1);
        int vocab, tgt_id;
        float lse2, cf;
        if (kTokensAreRows) {
          vocab = y0 + lc;
          tgt_id = row_tgt[i];
          lse2 = row_lse2[i];
          cf = row_coef[i];
        } else {
          vocab = x0 + lr;
          tgt_id = sTgt[lc];
          lse2 = sLse[lc];
          cf = sCoef[lc];
        }
        const float p = vocab < V ? exp2f(s[n][el] * kLog2e - lse2) : 0.f;
        gv[el] = (p - (vocab == tgt_id ? 1.f : 0.f)) * cf;
      }
      const int lr = mt * 16 + g;
      const int lc = (ng * kNT + n) * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sG + lr * kLdc + lc) = pack_bf16(gv[0], gv[1]);
      *reinterpret_cast<uint32_t*>(sG + (lr + 8) * kLdc + lc) = pack_bf16(gv[2], gv[3]);
    }
    // phase 2: out[:, chunk out_c0 + c] += G * Y[:, that chunk] (contraction
    // over Y's rows); the barrier of the first step publishes G
#pragma unroll
    for (int c = 0; c < kOutNC; ++c, ++j) {
      cp_async_wait<1>();
      __syncthreads();
      fetch(j + 2);
      const __nv_bfloat16* buf = sY + (j % kStages) * kChunk * kLdc;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t ga[4], b[4];
        load_a_frag(ga, sG, kLdc, mt * 16, kk * 16, lane);
        load_b_frag_kn(b, buf, kLdc, kk * 16, ng * 16, lane);
        mma_bf16_16816(acc[c][0], ga, b[0], b[1]);
        mma_bf16_16816(acc[c][1], ga, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = x0 + mt * 16 + g + 8 * i;
    if (row >= nx) continue;
#pragma unroll
    for (int c = 0; c < kOutNC; ++c)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D + (out_c0 + c) * kChunk +
                                           ng * 16 +
                                           n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[c][n][2 * i], acc[c][n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32 SIMT kernels: one block of 128 threads per row of X
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32MaxD = 1024;

__device__ __forceinline__ float dot_row(const float* __restrict__ sx, const float* __restrict__ y,
                                         int D) {
  float acc = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 yv = *reinterpret_cast<const float4*>(y + d);
    acc = fmaf(sx[d], yv.x, acc);
    acc = fmaf(sx[d + 1], yv.y, acc);
    acc = fmaf(sx[d + 2], yv.z, acc);
    acc = fmaf(sx[d + 3], yv.w, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kF32Threads) ce_fwd_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ e, const int* __restrict__ target,
    float* __restrict__ lse_out, float* __restrict__ tgt_out, int V, int D) {
  __shared__ __align__(16) float sx[kF32MaxD];
  __shared__ float sm[kF32Threads], sl[kF32Threads], st[kF32Threads];
  const int tok = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += kF32Threads) sx[d] = h[(long long)tok * D + d];
  __syncthreads();
  const int tgt_id = target[tok];
  float m = -INFINITY, l = 0.f, tl = 0.f;
  for (int v = threadIdx.x; v < V; v += kF32Threads) {
    const float s = dot_row(sx, e + (long long)v * D, D);
    if (v == tgt_id) tl = s;
    const float m_new = fmaxf(m, s);
    l = l * expf(m - m_new) + expf(s - m_new);
    m = m_new;
  }
  sm[threadIdx.x] = m;
  sl[threadIdx.x] = l;
  st[threadIdx.x] = tl;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = -INFINITY, ll = 0.f, tt = 0.f;
    for (int i = 0; i < kF32Threads; ++i) {
      if (sl[i] > 0.f) {
        const float m_new = fmaxf(mm, sm[i]);
        ll = ll * expf(mm - m_new) + sl[i] * expf(sm[i] - m_new);
        mm = m_new;
      }
      tt += st[i];
    }
    lse_out[tok] = ll > 0.f ? mm + logf(ll) : kDeadLse;
    tgt_out[tok] = tt;
  }
}

template <bool kTokensAreRows>
__global__ void __launch_bounds__(kF32Threads) ce_bwd_f32_kernel(
    const float* __restrict__ X, const float* __restrict__ Y, const int* __restrict__ target,
    const float* __restrict__ lse, const float* __restrict__ coef, float* __restrict__ out,
    int ny, int V, int D) {
  constexpr int kPer = kF32MaxD / kF32Threads;
  __shared__ __align__(16) float sx[kF32MaxD];
  __shared__ float sg[kF32Threads];
  const int x = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += kF32Threads) sx[d] = X[(long long)x * D + d];
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int y0 = 0; y0 < ny; y0 += kF32Threads) {
    __syncthreads();
    const int y = y0 + threadIdx.x;
    float gval = 0.f;
    if (y < ny) {
      const int tok = kTokensAreRows ? x : y;
      const int vocab = kTokensAreRows ? y : x;
      const float cf = coef[tok];
      if (cf != 0.f) {
        const float s = dot_row(sx, Y + (long long)y * D, D);
        const float p = vocab < V ? expf(s - fmaxf(lse[tok], kLseFloor)) : 0.f;
        gval = (p - (vocab == target[tok] ? 1.f : 0.f)) * cf;
      }
    }
    sg[threadIdx.x] = gval;
    __syncthreads();
    const int n = min(kF32Threads, ny - y0);
    for (int jj = 0; jj < n; ++jj) {
      const float gj = sg[jj];
      if (gj == 0.f) continue;
      const float* yrow = Y + (long long)(y0 + jj) * D;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = threadIdx.x + i * kF32Threads;
        if (d < D) acc[i] = fmaf(gj, yrow[d], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = threadIdx.x + i * kF32Threads;
    if (d < D) out[(long long)x * D + d] = acc[i];
  }
}

template <int D>
int launch_fwd_bf16(const void* h, const void* e, const int* target, float* lse, float* tgt,
                    int T, int V, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_bf16_kernel<D><<<(T + 63) / 64, kFwdWarps * 32, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(e), target, lse,
      tgt, T, V);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_bf16(const void* h, const void* e, const int* target, const float* lse,
                    const float* coef, void* dh, void* de, int T, int V, cudaStream_t stream) {
  constexpr int kWarps = kBwdWarps;
  constexpr int BM = kBwdRows;
  constexpr int kSmem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(ce_bwd_bf16_kernel<D, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ce_bwd_bf16_kernel<D, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const __nv_bfloat16* hp = static_cast<const __nv_bfloat16*>(h);
  const __nv_bfloat16* ep = static_cast<const __nv_bfloat16*>(e);
  ce_bwd_bf16_kernel<D, true><<<dim3((T + BM - 1) / BM, bwd_parts<D>()), kWarps * 32, kSmem,
                                  stream>>>(
      hp, ep, target, lse, coef, static_cast<__nv_bfloat16*>(dh), T, V, T, V);
  ce_bwd_bf16_kernel<D, false><<<dim3((V + BM - 1) / BM, bwd_parts<D>()), kWarps * 32, kSmem,
                                   stream>>>(
      ep, hp, target, lse, coef, static_cast<__nv_bfloat16*>(de), V, T, T, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and e share it). h is a contiguous
// (T, D) matrix, e a contiguous (V, D) table, target (T,) int32 with -1 for
// ignored tokens; lse and tgt are (T,) fp32 outputs. bf16 takes D in
// {64, 768, 1024}; fp32 any D <= 1024 that is a multiple of 4. Returns
// the CUDA error code (0 = success).
extern "C" int pixparse_fused_ce_fwd(int dtype, const void* h, const void* e, const void* target,
                                     void* lse, void* tgt, int T, int V, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(target);
  float* lp = static_cast<float*>(lse);
  float* gp = static_cast<float*>(tgt);
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_fwd_bf16<64>(h, e, tp, lp, gp, T, V, s);
      case 768: return launch_fwd_bf16<768>(h, e, tp, lp, gp, T, V, s);
      case 1024: return launch_fwd_bf16<1024>(h, e, tp, lp, gp, T, V, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0 && D <= kF32MaxD && D % 4 == 0) {
    ce_fwd_f32_kernel<<<T, kF32Threads, 0, s>>>(static_cast<const float*>(h),
                                                static_cast<const float*>(e), tp, lp, gp, V, D);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, plus lse (T,) from the forward and coef (T,) fp32, the loss's
// derivative with respect to each token's nll (0 for ignored tokens).
// Outputs dh (T, D) and de (V, D) in the inputs' dtype, every element written.
extern "C" int pixparse_fused_ce_bwd(int dtype, const void* h, const void* e, const void* target,
                                     const void* lse, const void* coef, void* dh, void* de, int T,
                                     int V, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(target);
  const float* lp = static_cast<const float*>(lse);
  const float* cp = static_cast<const float*>(coef);
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_bwd_bf16<64>(h, e, tp, lp, cp, dh, de, T, V, s);
      case 768: return launch_bwd_bf16<768>(h, e, tp, lp, cp, dh, de, T, V, s);
      case 1024: return launch_bwd_bf16<1024>(h, e, tp, lp, cp, dh, de, T, V, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0 && D <= kF32MaxD && D % 4 == 0) {
    const float* hp = static_cast<const float*>(h);
    const float* ep = static_cast<const float*>(e);
    ce_bwd_f32_kernel<true><<<T, kF32Threads, 0, s>>>(hp, ep, tp, lp, cp,
                                                      static_cast<float*>(dh), V, V, D);
    ce_bwd_f32_kernel<false><<<V, kF32Threads, 0, s>>>(ep, hp, tp, lp, cp,
                                                       static_cast<float*>(de), T, V, D);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
