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
// What the design does about it: every product is a wgmma fed by TMA, in
// blocks of a producer warpgroup (one thread issues the TMA loads through
// an mbarrier ring; setmaxnreg gives its registers up) and two consumer
// warpgroups of 64 rows each. Blocks run in parallel and share nothing, so
// a gradient that sums over queries (dk, dv) and one that sums over keys
// (dq) get a kernel each, both deterministic (no atomics):
// - dK/dV kernel, per 128 keys: K and V are loaded once; Q, dO tiles of 64
//   queries stream through the ring, with lse (clamped, in log2 units) and
//   delta * scale staged beside them by the producer warp. s^T = K q^T and
//   dp^T = V do^T by wgmma from shared memory (q and do stored [query][d]
//   are K-major), in two groups: p^T is formed while dp^T is still on the
//   tensor cores, dv += p^T do is issued before ds^T is formed, then
//   dk += ds^T q; p^T and ds^T are the register A operands, do and q read
//   through the transposed (MN-major) descriptor.
// - dQ kernel, per 128 queries: Q and dO loaded once; K, V tiles of 64 keys
//   stream; s = Q k^T and dp = dO v^T (p formed while dp runs), then
//   dq += ds k (k transposed). Causal grids start with the longest tiles.
// The elementwise work between the products is what limits these kernels
// as much as the tensor cores (PERF.md): masks only on tiles that straddle
// an edge, exp2 by the special-function unit, p rounded once by the packed
// conversion that also forms the A operand.
// That is 7 products instead of the one-pass TPU kernel's 5 (s and dp are
// computed twice); the price of determinism without a sequential grid.
// q/k/v/do are read in place through 4-D tensor maps over their strides
// ((H, D) contiguous); gradients are written head-merged (B, L, H, D).
// Masks are applied only on tiles that straddle an edge.
//
// fp32 inputs take SIMT kernels (fp32 FMA) with the same semantics; they
// exist for the fp32 parity path, not for speed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::hopper;

constexpr float kLseFloor = -0.5e30f;

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

// Block shapes of both kernels: kOwn rows of the block's own side (2
// consumer warpgroups x 64), tiles of kStream rows of the other side.
template <int D>
struct BwdCfg {
  static constexpr int kOwn = 128;
  static constexpr int kStream = 64;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kOwnBytes = kOwn * D * 2;        // one own-side tile
  static constexpr int kStreamBytes = kStream * D * 2;  // one streamed tile
  // + lse2 and delta (512 bytes), padded so that every tile stays 1024-aligned
  static constexpr int kStageBytes = 2 * kStreamBytes + 1024;
  static constexpr int kBarOffset = 2 * kOwnBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + (2 * kStages + 1) * 8 + 1024;
};

// ds of one element from p (already rounded to bf16), dp, and delta * scale:
// p * (dp - delta) * scale.
__device__ __forceinline__ float ds_of(float p, float dp, float scale, float delta_scaled) {
  return p * fmaf(dp, scale, -delta_scaled);
}

template <int D>
__global__ void __launch_bounds__(384, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int kS = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::kOwnBytes;
  const uint32_t bars = base + C::kBarOffset;  // full[kS], empty[kS], kv
  auto sQ = [&](int s) { return base + 2 * C::kOwnBytes + s * C::kStageBytes; };
  auto sdO = [&](int s) { return sQ(s) + C::kStreamBytes; };
  auto sStat = [&](int s) {  // lse2[64], delta[64]
    return reinterpret_cast<float*>(smem_raw + (sQ(s) + 2 * C::kStreamBytes - smem_addr(smem_raw)));
  };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };
  const uint32_t kvbar = bars + 16 * kS;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Lq = a.Lq, Lk = a.Lk, H = a.H;
  const int key0 = kt * C::kOwn;
  const int kv_len = a.kv_lens ? min(max(a.kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  // first query tile that can see key0 under the causal mask: i >= key0 - off
  int q_begin = a.causal ? max(0, key0 - off) : 0;
  q_begin = (q_begin / C::kStream) * C::kStream;
  if (key0 >= kv_len) q_begin = Lq;  // no key of this block is valid: zeros
  const int n_tiles = q_begin < Lq ? (Lq - q_begin + C::kStream - 1) / C::kStream : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 33);    // the TMA arrival + the producer warp's 32 stat stores
      mbar_init(empty(s), 256);  // every consumer thread
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: warp 0 ----
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x;
    if (threadIdx.x < 32 && n_tiles > 0) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * C::kOwnBytes);
        tma_load_rows<D, C::kOwn>(sK, &tm_k, kvbar, h, key0, b);
        tma_load_rows<D, C::kOwn>(sV, &tm_v, kvbar, h, key0, b);
      }
      const float* lse_row = a.lse + ((long long)b * H + h) * Lq;
      const float* delta_row = a.delta + ((long long)b * H + h) * Lq;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kS;
        const int q0 = q_begin + it * C::kStream;
        mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * C::kStreamBytes);
          tma_load_rows<D, C::kStream>(sQ(s), &tm_q, full(s), h, q0, b);
          tma_load_rows<D, C::kStream>(sdO(s), &tm_do, full(s), h, q0, b);
        }
        float* st = sStat(s);
#pragma unroll
        for (int r = lane; r < C::kStream; r += 32) {
          const int q = q0 + r;
          st[r] = q < Lq ? fmaxf(lse_row[q], kLseFloor) * kLog2e : INFINITY;  // p = 0 past Lq
          st[C::kStream + r] = q < Lq ? delta_row[q] * a.scale : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int k0 = key0 + cw * 64;  // this warpgroup's first key
    const int my_key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
    const float scale = a.scale, scale_log2 = a.scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_tiles > 0) mbar_wait(kvbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kS;
      const int q0 = q_begin + it * C::kStream;
      mbar_wait(full(s), (it / kS) & 1);
      // some (query, key) pair of this tile is visible
      if (k0 < kv_len && (!a.causal || k0 <= q0 + C::kStream - 1 + off)) {
        float st[32], dpt[32];  // s^T, dp^T: 64 keys x 64 queries
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        // two groups: p^T is formed while dp^T is still on the tensor cores
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, desc_kmajor<D, C::kOwn>(sK, cw * 64, kk),
                       desc_kmajor<D, C::kStream>(sQ(s), 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, desc_kmajor<D, C::kOwn>(sV, cw * 64, kk),
                       desc_kmajor<D, C::kStream>(sdO(s), 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // masks only where the tile straddles an edge: s = -inf gives p = 0
        if (k0 + 64 > kv_len || (a.causal && k0 + 63 > q0 + off)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = my_key[(i >> 1) & 1];
            const int query = q0 + 8 * (i / 4) + 2 * t + (i & 1);
            if (key >= kv_len || (a.causal && key > query + off)) st[i] = -INFINITY;
          }
        }
        const float* stat = sStat(s);  // lse2[64], delta * scale[64]
        // p^T first: dv += p^T do starts on the tensor cores while ds^T is formed
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * t);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * j + 2 * hr;
            pa[j / 2][2 * (j & 1) + hr] =
                pack_bf16(fast_exp2(fmaf(st[i], scale_log2, -l2.x)),
                          fast_exp2(fmaf(st[i + 1], scale_log2, -l2.y)));
          }
        }
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_rows<D, C::kStream>(dv, pa[kk], sdO(s), kk);
        wgmma_commit();
        wgmma_wait<1>();  // dp^T is ready; dv's product may still run
        fence_regs(dpt);
        // ds^T = p^T (dp^T - delta) * scale, then dk += ds^T q: both
        // contractions run over the tile's 64 queries
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(stat + C::kStream + 8 * j + 2 * t);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * j + 2 * hr;
            const uint32_t p = pa[j / 2][2 * (j & 1) + hr];
            dsa[j / 2][2 * (j & 1) + hr] = pack_bf16(ds_of(bf16_lo(p), dpt[i], scale, dl.x),
                                                     ds_of(bf16_hi(p), dpt[i + 1], scale, dl.y));
          }
        }
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_rows<D, C::kStream>(dk, dsa[kk], sQ(s), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(empty(s));
    }

    const long long o_rs = (long long)H * D;
    __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk) + (long long)b * Lk * o_rs + h * D;
    __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv) + (long long)b * Lk * o_rs + h * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = my_key[hr];
      if (key >= Lk) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const long long at = key * o_rs + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
            __floats2bfloat162_rn(dk[4 * j + 2 * hr], dk[4 * j + 2 * hr + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
            __floats2bfloat162_rn(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int kS = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + C::kOwnBytes;
  const uint32_t bars = base + C::kBarOffset;  // full[kS], empty[kS], q
  auto sK = [&](int s) { return base + 2 * C::kOwnBytes + s * C::kStageBytes; };
  auto sV = [&](int s) { return sK(s) + C::kStreamBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };
  const uint32_t qbar = bars + 16 * kS;

  int qt, h, b;
  if (a.causal) {  // the longest query tiles first
    h = blockIdx.x;
    b = blockIdx.y;
    qt = gridDim.z - 1 - blockIdx.z;
  } else {
    qt = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  const int Lq = a.Lq, Lk = a.Lk, H = a.H;
  const int row0 = qt * C::kOwn;
  const int kv_len = a.kv_lens ? min(max(a.kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  const int n_end = a.causal ? min(kv_len, min(row0 + C::kOwn, Lq) + off) : kv_len;
  const int n_tiles = n_end > 0 ? (n_end + C::kStream - 1) / C::kStream : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, 2 * C::kOwnBytes);
      tma_load_rows<D, C::kOwn>(sQ, &tm_q, qbar, h, row0, b);
      tma_load_rows<D, C::kOwn>(sdO, &tm_do, qbar, h, row0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kS;
        mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::kStreamBytes);
        tma_load_rows<D, C::kStream>(sK(s), &tm_k, full(s), h, it * C::kStream, b);
        tma_load_rows<D, C::kStream>(sV(s), &tm_v, full(s), h, it * C::kStream, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = row0 + cw * 64;
    const int my_row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const float scale = a.scale, scale_log2 = a.scale * kLog2e;
    const int wg_end =
        r0 >= Lq ? 0 : (a.causal ? min(kv_len, min(r0 + 64, Lq) + off) : kv_len);
    const float* lse_row = a.lse + ((long long)b * H + h) * Lq;
    const float* delta_row = a.delta + ((long long)b * H + h) * Lq;
    float lse2[2], delta[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool in = my_row[hr] < Lq;
      lse2[hr] = in ? fmaxf(lse_row[my_row[hr]], kLseFloor) * kLog2e : INFINITY;
      delta[hr] = in ? delta_row[my_row[hr]] * scale : 0.f;  // delta * scale
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (n_tiles > 0) mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kS;
      const int n0 = it * C::kStream;
      mbar_wait(full(s), (it / kS) & 1);
      if (n0 < wg_end) {
        float sc[32], dp[32];  // 64 queries x 64 keys
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        // two groups: p is formed while dp is still on the tensor cores
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, desc_kmajor<D, C::kOwn>(sQ, cw * 64, kk),
                       desc_kmajor<D, C::kStream>(sK(s), 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, desc_kmajor<D, C::kOwn>(sdO, cw * 64, kk),
                       desc_kmajor<D, C::kStream>(sV(s), 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        if (n0 + C::kStream > kv_len || (a.causal && n0 + C::kStream - 1 > r0 + off)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = n0 + 8 * (i / 4) + 2 * t + (i & 1);
            if (col >= kv_len || (a.causal && col > my_row[(i >> 1) & 1] + off)) sc[i] = -INFINITY;
          }
        }
        uint32_t pp[16];  // p, rounded to bf16 and packed in A-operand order
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int hr = (i >> 1) & 1;
          pp[i / 2] = pack_bf16(fast_exp2(fmaf(sc[i], scale_log2, -lse2[hr])),
                                fast_exp2(fmaf(sc[i + 1], scale_log2, -lse2[hr])));
        }
        wgmma_wait<0>();
        fence_regs(dp);
        uint32_t dsa[4][4];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int hr = (i >> 1) & 1;
          dsa[i / 8][(i / 2) % 4] = pack_bf16(ds_of(bf16_lo(pp[i / 2]), dp[i], scale, delta[hr]),
                                              ds_of(bf16_hi(pp[i / 2]), dp[i + 1], scale, delta[hr]));
        }
        // dq += ds k: contraction over the tile's 64 keys
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_rows<D, C::kStream>(dq, dsa[kk], sK(s), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      mbar_arrive(empty(s));
    }

    const long long o_rs = (long long)H * D;
    __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(a.dq) + (long long)b * Lq * o_rs + h * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (my_row[hr] >= Lq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dqb + my_row[hr] * o_rs + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dq[4 * j + 2 * hr], dq[4 * j + 2 * hr + 1]);
    }
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
  using C = BwdCfg<D>;
  const int H = a.H, Lq = a.Lq, Lk = a.Lk;
  // an empty side is never loaded; its maps only need a valid base
  const void* q = Lq > 0 ? a.q : a.k;
  const void* dout = Lq > 0 ? a.dout : a.k;
  const void* k = Lk > 0 ? a.k : a.q;
  const void* v = Lk > 0 ? a.v : a.q;
  // the dK/dV kernel streams q/do and owns k/v; the dQ kernel the reverse
  CUtensorMap q_s, do_s, k_o, v_o, q_o, do_o, k_s, v_s;
  if (!make_tensor_map<D, C::kStream>(&q_s, q, H, Lq, B, a.q_rs, a.q_bs) ||
      !make_tensor_map<D, C::kStream>(&do_s, dout, H, Lq, B, a.do_rs, a.do_bs) ||
      !make_tensor_map<D, C::kOwn>(&k_o, k, H, Lk, B, a.k_rs, a.k_bs) ||
      !make_tensor_map<D, C::kOwn>(&v_o, v, H, Lk, B, a.v_rs, a.v_bs) ||
      !make_tensor_map<D, C::kOwn>(&q_o, q, H, Lq, B, a.q_rs, a.q_bs) ||
      !make_tensor_map<D, C::kOwn>(&do_o, dout, H, Lq, B, a.do_rs, a.do_bs) ||
      !make_tensor_map<D, C::kStream>(&k_s, k, H, Lk, B, a.k_rs, a.k_bs) ||
      !make_tensor_map<D, C::kStream>(&v_s, v, H, Lk, B, a.v_rs, a.v_bs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Lk > 0) {
    const dim3 grid((Lk + C::kOwn - 1) / C::kOwn, H, B);
    flash_bwd_dkv_wgmma_kernel<D><<<grid, 384, C::kSmem, stream>>>(q_s, k_o, v_o, do_s, a);
  }
  if (Lq > 0) {
    const int n_qt = (Lq + C::kOwn - 1) / C::kOwn;
    const dim3 grid = a.causal ? dim3(H, B, n_qt) : dim3(n_qt, H, B);
    flash_bwd_dq_wgmma_kernel<D><<<grid, 384, C::kSmem, stream>>>(q_o, k_s, v_s, do_o, a);
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
