// Flash-attention backward for Hopper (sm_90a), bound through a plain C entry
// point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU backward kernels
//   pixparse_tpu/ops/flash_attention.py::_bwd_kernel_single      (one block)
//   pixparse_tpu/ops/flash_attention.py::_bwd_dq_kernel_single   (one key block)
//   pixparse_tpu/ops/flash_attention.py::_bwd_dkv_kernel_single  (one query block)
//   pixparse_tpu/ops/flash_attention.py::_bwd_dq_kernel          (multi-block)
//   pixparse_tpu/ops/flash_attention.py::_bwd_dkv_kernel         (multi-block)
// which all compute the same function, tiled differently for the TPU's
// VMEM: from q, k, v, do, the forward's per-row logsumexp `lse` and
// delta = sum(do * o) per row,
//   p  = exp(q k^T * scale + masks - lse)      rounded to the value dtype
//   dv = p^T do
//   dp = do v^T
//   ds = p * (dp - delta) * scale              rounded to the q dtype
//   dq = ds k,   dk = ds^T q
// with the forward's bottom-right causal mask and per-sample key lengths.
// lse is clamped at -0.5e30 so fully masked rows give p = 0.
//
// What bounds it on an H100: five products of 2*B*H*Lq*Lk*D FLOP each
// (1.25e11 at the ViT site B=16, L=1009, H=12, D=64) against ~200 MB of
// q/k/v/do/dq/dk/dv: ~600 FLOP per byte, above the card's ~295 FLOP/byte
// ridge, so it is bound by tensor-core throughput and neither scores nor p
// may reach device memory.
//
// What the design does about it: blocks run in parallel and share nothing,
// so a gradient that sums over queries (dk, dv) and one that sums over keys
// (dq) get a kernel each, and both are deterministic (no atomics):
// - dK/dV kernel: one block of 4 warps per (tile of 64 keys, head, sample),
//   16 keys per warp. It loops over the query tiles that can see its keys,
//   recomputes s^T = k q^T and dp^T = v do^T on the tensor cores
//   (mma.sync m16n8k16), forms p^T and ds^T in registers, and feeds them as
//   A fragments straight into dv += p^T do and dk += ds^T q, accumulated in
//   fp32 registers and written once.
// - dQ kernel: one block per (tile of 64 queries, head, sample); loops over
//   key tiles up to the causal / key-length limit, dq += ds k.
// That is 7 products instead of the one-pass TPU kernel's 5 (s and dp are
// computed twice); the price of having no sequential grid. q/k/v/do are read
// in place through their strides ((H, D) contiguous), gradients are written
// head-merged (B, L, H, D). This is the simple first version: synchronous
// tile loads, no wgmma/TMA, no pipelining.
//
// fp32 inputs take SIMT kernels (fp32 FMA) with the same semantics; they
// exist for the fp32 parity path, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace pixparse;

constexpr float kLseFloor = -0.5e30f;
constexpr int kTile = 64;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Lq)
  const float* delta;  // (B, H, Lq)
  const int* kv_lens;  // (B,) or NULL
  void* dq;            // (B, Lq, H, D) contiguous
  void* dk;            // (B, Lk, H, D) contiguous
  void* dv;
  int H, Lq, Lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  int causal;
  float scale;
};

template <int D>
constexpr int bwd_smem_bytes() {
  return 4 * kTile * (D + 8) * (int)sizeof(__nv_bfloat16) + 2 * kTile * (int)sizeof(float);
}

// p and ds of one accumulator element, from the recomputed score `s` and
// `dp`; `lse2` is lse * log2(e), already clamped.
__device__ __forceinline__ void p_and_ds(bool ok, float s, float dp, float lse2, float delta,
                                         float scale, float scale_log2, float& p, float& ds) {
  const float pf = ok ? exp2f(s * scale_log2 - lse2) : 0.f;
  p = __bfloat162float(__float2bfloat16_rn(pf));  // rounded like the dv operand
  ds = p * (dp - delta) * scale;
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(BwdArgs a) {
  constexpr int kLds = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile * kLds;
  __nv_bfloat16* sQ = sV + kTile * kLds;
  __nv_bfloat16* sdO = sQ + kTile * kLds;
  float* sLse = reinterpret_cast<float*>(sdO + kTile * kLds);
  float* sDelta = sLse + kTile;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = kt * kTile;
  const int Lq = a.Lq, Lk = a.Lk, H = a.H;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * D;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * D;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + b * a.do_bs + h * D;
  const float* lse_row = a.lse + ((long long)b * H + h) * Lq;
  const float* delta_row = a.delta + ((long long)b * H + h) * Lq;

  const int kv_len = a.kv_lens ? min(max(a.kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  const float scale_log2 = a.scale * kLog2e;

  load_tile_bf16<D, kTile>(sK, kb, a.k_rs, key0, Lk);
  load_tile_bf16<D, kTile>(sV, vb, a.v_rs, key0, Lk);

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // first query that can see key0 under the causal mask: i >= key0 - off
  int q_begin = a.causal ? max(0, key0 - off) : 0;
  q_begin = (q_begin / kTile) * kTile;
  if (key0 >= kv_len) q_begin = Lq;  // no key of this tile is valid: zeros

  for (int q0 = q_begin; q0 < Lq; q0 += kTile) {
    __syncthreads();  // previous tile consumed
    load_tile_bf16<D, kTile>(sQ, qb, a.q_rs, q0, Lq);
    load_tile_bf16<D, kTile>(sdO, dob, a.do_rs, q0, Lq);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < Lq ? fmaxf(lse_row[r], kLseFloor) * kLog2e : 0.f;
      sDelta[threadIdx.x] = r < Lq ? delta_row[r] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's 16 keys x 64 queries
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, sK, kLds, warp * 16, kk * 16, lane);
      load_a_frag(va, sV, kLds, warp * 16, kk * 16, lane);
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        uint32_t bq[4], bd[4];
        load_b_frag_nk(bq, sQ, kLds, jp * 16, kk * 16, lane);
        load_b_frag_nk(bd, sdO, kLds, jp * 16, kk * 16, lane);
        mma_bf16_16816(s[2 * jp], ka, bq[0], bq[1]);
        mma_bf16_16816(s[2 * jp + 1], ka, bq[2], bq[3]);
        mma_bf16_16816(dp[2 * jp], va, bd[0], bd[1]);
        mma_bf16_16816(dp[2 * jp + 1], va, bd[2], bd[3]);
      }
    }

    // p^T and ds^T, rounded to bf16, as A fragments
    uint32_t pa[kNTiles][2], dsa[kNTiles][2];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + warp * 16 + g + ((e >> 1) ? 8 : 0);
        const int lc = j * 8 + 2 * t + (e & 1);
        const int query = q0 + lc;
        const bool ok = key < kv_len && query < Lq && (!a.causal || key <= query + off);
        p_and_ds(ok, s[j][e], dp[j][e], sLse[lc], sDelta[lc], a.scale, scale_log2, p[e], ds[e]);
      }
      pa[j][0] = pack_bf16(p[0], p[1]);
      pa[j][1] = pack_bf16(p[2], p[3]);
      dsa[j][0] = pack_bf16(ds[0], ds[1]);
      dsa[j][1] = pack_bf16(ds[2], ds[3]);
    }

    // dv += p^T do, dk += ds^T q (contraction over the 64 queries)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t ap[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
      const uint32_t ads[4] = {dsa[2 * kk][0], dsa[2 * kk][1], dsa[2 * kk + 1][0],
                               dsa[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t bd[4], bq[4];
        load_b_frag_kn(bd, sdO, kLds, kk * 16, np * 16, lane);
        load_b_frag_kn(bq, sQ, kLds, kk * 16, np * 16, lane);
        mma_bf16_16816(dv[2 * np], ap, bd[0], bd[1]);
        mma_bf16_16816(dv[2 * np + 1], ap, bd[2], bd[3]);
        mma_bf16_16816(dk[2 * np], ads, bq[0], bq[1]);
        mma_bf16_16816(dk[2 * np + 1], ads, bq[2], bq[3]);
      }
    }
  }

  const long long o_rs = (long long)H * D;
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk) + (long long)b * Lk * o_rs + h * D;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv) + (long long)b * Lk * o_rs + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + warp * 16 + g + 8 * i;
    if (key >= Lk) continue;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      const long long at = key * o_rs + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
          __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16_kernel(BwdArgs a) {
  constexpr int kLds = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile * kLds;
  __nv_bfloat16* sQ = sV + kTile * kLds;
  __nv_bfloat16* sdO = sQ + kTile * kLds;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = qt * kTile;
  const int Lq = a.Lq, Lk = a.Lk, H = a.H;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * D;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * D;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + b * a.do_bs + h * D;
  const float* lse_row = a.lse + ((long long)b * H + h) * Lq;
  const float* delta_row = a.delta + ((long long)b * H + h) * Lq;

  const int kv_len = a.kv_lens ? min(max(a.kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  const float scale_log2 = a.scale * kLog2e;
  const int n_end = a.causal ? min(kv_len, min(row0 + kTile, Lq) + off) : kv_len;

  load_tile_bf16<D, kTile>(sQ, qb, a.q_rs, row0, Lq);
  load_tile_bf16<D, kTile>(sdO, dob, a.do_rs, row0, Lq);

  // this thread's two query rows
  int rows[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = row0 + warp * 16 + g + 8 * i;
    const bool in = rows[i] < Lq;
    lse2[i] = in ? fmaxf(lse_row[rows[i]], kLseFloor) * kLog2e : 0.f;
    delta[i] = in ? delta_row[rows[i]] : 0.f;
  }

  float dq[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int n0 = 0; n0 < n_end; n0 += kTile) {
    __syncthreads();  // previous tile consumed (and the Q/dO loads done)
    load_tile_bf16<D, kTile>(sK, kb, a.k_rs, n0, Lk);
    load_tile_bf16<D, kTile>(sV, vb, a.v_rs, n0, Lk);
    __syncthreads();

    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qa[4], da[4];
      load_a_frag(qa, sQ, kLds, warp * 16, kk * 16, lane);
      load_a_frag(da, sdO, kLds, warp * 16, kk * 16, lane);
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        uint32_t bk[4], bv[4];
        load_b_frag_nk(bk, sK, kLds, jp * 16, kk * 16, lane);
        load_b_frag_nk(bv, sV, kLds, jp * 16, kk * 16, lane);
        mma_bf16_16816(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16_16816(s[2 * jp + 1], qa, bk[2], bk[3]);
        mma_bf16_16816(dp[2 * jp], da, bv[0], bv[1]);
        mma_bf16_16816(dp[2 * jp + 1], da, bv[2], bv[3]);
      }
    }

    uint32_t dsa[kNTiles][2];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < kv_len && rows[i] < Lq && (!a.causal || col <= rows[i] + off);
        float p;
        p_and_ds(ok, s[j][e], dp[j][e], lse2[i], delta[i], a.scale, scale_log2, p, ds[e]);
      }
      dsa[j][0] = pack_bf16(ds[0], ds[1]);
      dsa[j][1] = pack_bf16(ds[2], ds[3]);
    }

    // dq += ds k (contraction over the 64 keys)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t ads[4] = {dsa[2 * kk][0], dsa[2 * kk][1], dsa[2 * kk + 1][0],
                               dsa[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t bk[4];
        load_b_frag_kn(bk, sK, kLds, kk * 16, np * 16, lane);
        mma_bf16_16816(dq[2 * np], ads, bk[0], bk[1]);
        mma_bf16_16816(dq[2 * np + 1], ads, bk[2], bk[3]);
      }
    }
  }

  const long long o_rs = (long long)H * D;
  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(a.dq) + (long long)b * Lq * o_rs + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Lq) continue;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + rows[i] * o_rs + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32 SIMT kernels: a warp works on one row at a time; lanes split the 32
// rows of the other side's tile for the dots and the head dim for the sums.
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 8;   // rows of the block's own side (2 per warp)
constexpr int kF32Tile = 32;  // rows of the streamed side per tile

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(BwdArgs a) {
  constexpr int kPerLane = D / 32;
  __shared__ float sQ[kF32Rows][D];
  __shared__ float sdO[kF32Rows][D];
  __shared__ float sK[kF32Tile][D + 1];
  __shared__ float sV[kF32Tile][D + 1];

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kF32Rows;
  const int Lq = a.Lq, Lk = a.Lk, H = a.H;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_bs + h * D;
  const float* lse_row = a.lse + ((long long)b * H + h) * Lq;
  const float* delta_row = a.delta + ((long long)b * H + h) * Lq;

  for (int i = threadIdx.x; i < kF32Rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = row0 + r < Lq;
    sQ[r][c] = in ? qb[(long long)(row0 + r) * a.q_rs + c] : 0.f;
    sdO[r][c] = in ? dob[(long long)(row0 + r) * a.do_rs + c] : 0.f;
  }

  const int kv_len = a.kv_lens ? min(max(a.kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  const int n_end = a.causal ? min(kv_len, min(row0 + kF32Rows, Lq) + off) : kv_len;

  float acc[2][kPerLane];
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 2 + r;
    lse[r] = row < Lq ? fmaxf(lse_row[row], kLseFloor) : 0.f;
    delta[r] = row < Lq ? delta_row[row] : 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int n0 = 0; n0 < n_end; n0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < Lk;
      sK[r][c] = in ? kb[(long long)(n0 + r) * a.k_rs + c] : 0.f;
      sV[r][c] = in ? vb[(long long)(n0 + r) * a.v_rs + c] : 0.f;
    }
    __syncthreads();
    const int col = n0 + lane;  // this lane's key
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = warp * 2 + r;
      const int row = row0 + lr;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        dot = fmaf(sQ[lr][d], sK[lane][d], dot);
        dpv = fmaf(sdO[lr][d], sV[lane][d], dpv);
      }
      const bool ok = col < kv_len && row < Lq && (!a.causal || col <= row + off);
      const float p = ok ? expf(dot * a.scale - lse[r]) : 0.f;
      const float ds = p * (dpv - delta[r]) * a.scale;
      for (int j = 0; j < kF32Tile; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[r][i] = fmaf(dsj, sK[j][lane + 32 * i], acc[r][i]);
      }
    }
  }

  const long long o_rs = (long long)H * D;
  float* dqb = static_cast<float*>(a.dq) + (long long)b * Lq * o_rs + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 2 + r;
    if (row >= Lq) continue;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) dqb[row * o_rs + lane + 32 * i] = acc[r][i];
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_f32_kernel(BwdArgs a) {
  constexpr int kPerLane = D / 32;
  __shared__ float sK[kF32Rows][D];
  __shared__ float sV[kF32Rows][D];
  __shared__ float sQ[kF32Tile][D + 1];
  __shared__ float sdO[kF32Tile][D + 1];
  __shared__ float sLse[kF32Tile];
  __shared__ float sDelta[kF32Tile];

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key0 = blockIdx.x * kF32Rows;
  const int Lq = a.Lq, Lk = a.Lk, H = a.H;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_bs + h * D;
  const float* lse_row = a.lse + ((long long)b * H + h) * Lq;
  const float* delta_row = a.delta + ((long long)b * H + h) * Lq;

  for (int i = threadIdx.x; i < kF32Rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = key0 + r < Lk;
    sK[r][c] = in ? kb[(long long)(key0 + r) * a.k_rs + c] : 0.f;
    sV[r][c] = in ? vb[(long long)(key0 + r) * a.v_rs + c] : 0.f;
  }

  const int kv_len = a.kv_lens ? min(max(a.kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  int q_begin = a.causal ? max(0, key0 - off) : 0;
  q_begin = (q_begin / kF32Tile) * kF32Tile;
  if (key0 >= kv_len) q_begin = Lq;

  float dk[2][kPerLane], dv[2][kPerLane];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) dk[r][i] = dv[r][i] = 0.f;

  for (int q0 = q_begin; q0 < Lq; q0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < Lq;
      sQ[r][c] = in ? qb[(long long)(q0 + r) * a.q_rs + c] : 0.f;
      sdO[r][c] = in ? dob[(long long)(q0 + r) * a.do_rs + c] : 0.f;
    }
    if (threadIdx.x < kF32Tile) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < Lq ? fmaxf(lse_row[r], kLseFloor) : 0.f;
      sDelta[threadIdx.x] = r < Lq ? delta_row[r] : 0.f;
    }
    __syncthreads();
    const int query = q0 + lane;  // this lane's query
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = warp * 2 + r;
      const int key = key0 + lr;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        dot = fmaf(sQ[lane][d], sK[lr][d], dot);
        dpv = fmaf(sdO[lane][d], sV[lr][d], dpv);
      }
      const bool ok = key < kv_len && query < Lq && (!a.causal || key <= query + off);
      const float p = ok ? expf(dot * a.scale - sLse[lane]) : 0.f;
      const float ds = p * (dpv - sDelta[lane]) * a.scale;
      for (int j = 0; j < kF32Tile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          dv[r][i] = fmaf(pj, sdO[j][lane + 32 * i], dv[r][i]);
          dk[r][i] = fmaf(dsj, sQ[j][lane + 32 * i], dk[r][i]);
        }
      }
    }
  }

  const long long o_rs = (long long)H * D;
  float* dkb = static_cast<float*>(a.dk) + (long long)b * Lk * o_rs + h * D;
  float* dvb = static_cast<float*>(a.dv) + (long long)b * Lk * o_rs + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + warp * 2 + r;
    if (key >= Lk) continue;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      dkb[key * o_rs + lane + 32 * i] = dk[r][i];
      dvb[key * o_rs + lane + 32 * i] = dv[r][i];
    }
  }
}

template <int D>
int launch_bf16(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.Lk > 0) {
    const dim3 grid((a.Lk + kTile - 1) / kTile, a.H, B);
    flash_bwd_dkv_bf16_kernel<D><<<grid, 128, kSmem, stream>>>(a);
  }
  if (a.Lq > 0) {
    const dim3 grid((a.Lq + kTile - 1) / kTile, a.H, B);
    flash_bwd_dq_bf16_kernel<D><<<grid, 128, kSmem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const BwdArgs& a, int B, cudaStream_t stream) {
  if (a.Lk > 0) {
    const dim3 grid((a.Lk + kF32Rows - 1) / kF32Rows, a.H, B);
    flash_bwd_dkv_f32_kernel<D><<<grid, 128, 0, stream>>>(a);
  }
  if (a.Lq > 0) {
    const dim3 grid((a.Lq + kF32Rows - 1) / kF32Rows, a.H, B);
    flash_bwd_dq_f32_kernel<D><<<grid, 128, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; q/k/v/dout are
// read through (batch, row) strides with (H, D) contiguous; lse and delta
// are contiguous (B, H, Lq) fp32; dq is a contiguous (B, Lq, H, D) tensor and
// dk, dv contiguous (B, Lk, H, D). kv_lens is a (B,) int32 device pointer or
// NULL. Launches the dK/dV kernel and the dQ kernel; returns the CUDA error
// code (0 = success).
extern "C" int pixparse_flash_attn_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* kv_lens, void* dq, void* dk, void* dv, int B,
                                       int H, int Lq, int Lk, int D, long long q_bs,
                                       long long q_rs, long long k_bs, long long k_rs,
                                       long long v_bs, long long v_rs, long long do_bs,
                                       long long do_rs, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.Lq = Lq; a.Lk = Lk;
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.do_bs = do_bs; a.do_rs = do_rs;
  a.causal = causal; a.scale = scale;
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(a, B, s);
      case 64: return launch_bf16<64>(a, B, s);
      case 128: return launch_bf16<128>(a, B, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(a, B, s);
      case 64: return launch_f32<64>(a, B, s);
      case 128: return launch_f32<128>(a, B, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
