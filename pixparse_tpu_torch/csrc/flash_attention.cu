// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry
// point (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU forward kernels
//   pixparse_tpu/ops/flash_attention.py::_fwd_kernel_single  (one key block)
//   pixparse_tpu/ops/flash_attention.py::_fwd_kernel         (online softmax)
// with one kernel: o = softmax(q k^T * scale + masks) v plus the per-row
// natural logsumexp, optional bottom-right causal masking (query i sees keys
// <= i + Lk - Lq) and per-sample key lengths. p is rounded to bf16 before
// p v and the row sum is taken over the rounded p. Fully masked rows give
// o = 0 and lse = -1e30, as the TPU kernel does.
//
// What bounds it on an H100: at the ViT encode (B=16, L=1009, H=12, D=64,
// bf16) the two products are 4*B*H*L^2*D = 5.0e10 FLOP against 99 MB of
// q/k/v/o, i.e. ~500 FLOP per byte, well above the card's ~295 FLOP/byte
// ridge: it is bound by tensor-core throughput, and the score matrix must
// never reach device memory.
//
// What the design does about it: the tensor cores' full rate is reached
// only through wgmma, fed from shared memory that TMA fills while the
// tensor cores work. Persistent blocks (one per SM) of three warpgroups walk
// over work tiles of 128 query rows of one (head, sample), longest first
// under the causal mask:
// - a producer warpgroup (registers given up with setmaxnreg) whose one
//   thread loads each work tile's Q into one of two buffers and streams K
//   and V tiles of 128 keys through a ring of stages by TMA, each stage and
//   Q buffer with a "full" and an "empty" mbarrier; the ring runs on across
//   work tiles, so the next tile's loads overlap this one's last products
//   and its epilogue. The tensor maps are 4-D (D, H, L, B) over the
//   caller's strides, so q/k/v are read in place (e.g. as views of a fused
//   qkv projection) and rows past a sample's last read as zeros;
// - two consumer warpgroups of 64 query rows each (registers taken with
//   setmaxnreg). Per key tile: S = Q K^T by wgmma m64n128k16 with both
//   operands in shared memory (K stored [key][d] is already K-major); the
//   online softmax on the accumulator fragments (row max over the quad by
//   two shuffles, exp2 with the scale folded into log2 e); O += P V by
//   wgmma with P straight from registers (the S accumulator rounded to bf16
//   is the A-operand layout) and V read through the transposed (MN-major)
//   descriptor. Each S is issued together with the previous tile's P V, so
//   a softmax runs while the tensor cores work, and the two warpgroups take
//   turns to issue (named barriers), so one's products run during the
//   other's softmax. Masks are applied only on tiles that straddle the
//   causal diagonal or the key-length edge; tiles a warpgroup cannot see
//   are skipped.
// Shared memory uses the 128-byte swizzle for D >= 64 (D = 128 as two
// 64-column panels) and the 64-byte swizzle for D = 32, the same in TMA and
// in the wgmma descriptors (hopper.cuh).
//
// fp32 inputs take a SIMT kernel (fp32 FMA, no tensor cores) with the same
// semantics; it exists for the fp32 parity path, not for speed.

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

constexpr float kDeadLse = -1e30f;  // lse of a fully masked row

template <int D>
struct FwdCfg {
  static constexpr int kBlockM = 128;  // query rows per work tile: 2 consumer warpgroups x 64
  static constexpr int kBlockN = 128;  // keys per tile
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kBlockM * D * 2;   // one of the two Q buffers
  static constexpr int kKVBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kBarOffset = 2 * kQBytes + kStages * 2 * kKVBytes;
  // + up to 1023 bytes to align the dynamic shared memory to 1024
  static constexpr int kSmem = kBarOffset + (2 * kStages + 4) * 8 + 1024;
};

// One work tile: 128 query rows of one (head, sample), and the keys they
// may see.
struct FwdWork {
  int qt, h, b, row0, kv_len, n_tiles;
};

// Work tiles are numbered so that the longest come first under the causal
// mask (all query tiles of one row index, then the next shorter one), and
// so that neighbours share a (sample, head) without it (K/V reuse in L2).
__device__ __forceinline__ FwdWork fwd_work(int item, int n_qt, int H, int B, int Lq, int Lk,
                                            const int* kv_lens, int causal, int block_m,
                                            int block_n) {
  FwdWork w;
  if (causal) {
    const int hb = item % (H * B);
    w.qt = n_qt - 1 - item / (H * B);
    w.h = hb % H;
    w.b = hb / H;
  } else {
    w.qt = item % n_qt;
    w.h = (item / n_qt) % H;
    w.b = item / (n_qt * H);
  }
  w.row0 = w.qt * block_m;
  w.kv_len = kv_lens ? min(max(kv_lens[w.b], 0), Lk) : Lk;
  // keys any row of this tile may see
  const int n_end =
      causal ? min(w.kv_len, min(w.row0 + block_m, Lq) + Lk - Lq) : w.kv_len;
  w.n_tiles = n_end > 0 ? (n_end + block_n - 1) / block_n : 0;
  return w;
}

template <int D>
__global__ void __launch_bounds__(384, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ kv_lens, int H, int Lq, int Lk, int causal,
    float scale_log2, int B, int n_items) {
  using C = FwdCfg<D>;
  constexpr int kS = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kBarOffset;
  auto sQ = [&](int qb) { return base + qb * C::kQBytes; };
  auto sK = [&](int s) { return base + 2 * C::kQBytes + s * 2 * C::kKVBytes; };
  auto sV = [&](int s) { return sK(s) + C::kKVBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };
  auto q_full = [&](int qb) { return bars + 8 * (2 * kS + qb); };
  auto q_empty = [&](int qb) { return bars + 8 * (2 * kS + 2 + qb); };
  const int n_qt = (Lq + C::kBlockM - 1) / C::kBlockM;
  const int off = Lk - Lq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Persistent blocks: block x takes work tiles x, x + gridDim.x, ...; the
  // K/V ring and the two Q buffers run on across work tiles, so one tile's
  // loads overlap the previous tile's last products and its epilogue.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int ring = 0, local = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++local) {
        const FwdWork w = fwd_work(item, n_qt, H, B, Lq, Lk, kv_lens, causal, C::kBlockM, C::kBlockN);
        const int qb = local & 1;
        mbar_wait(q_empty(qb), ((local >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), C::kQBytes);
        tma_load_rows<D, C::kBlockM>(sQ(qb), &tm_q, q_full(qb), w.h, w.row0, w.b);
        for (int it = 0; it < w.n_tiles; ++it, ++ring) {
          const int s = ring % kS;
          mbar_wait(empty(s), ((ring / kS) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * C::kKVBytes);
          tma_load_rows<D, C::kBlockN>(sK(s), &tm_k, full(s), w.h, it * C::kBlockN, w.b);
          tma_load_rows<D, C::kBlockN>(sV(s), &tm_v, full(s), w.h, it * C::kBlockN, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // The two warpgroups take turns to issue their products (named barriers
    // 1 and 2, warpgroup 0 first), so one's products run while the other
    // does its softmax.
    auto my_turn = [&] { named_bar_sync(1 + cw, 256); };
    auto their_turn = [&] { named_bar_arrive(2 - cw, 256); };
    if (cw == 1) their_turn();

    int ring = 0, local = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++local) {
      const FwdWork w = fwd_work(item, n_qt, H, B, Lq, Lk, kv_lens, causal, C::kBlockM, C::kBlockN);
      const int r0 = w.row0 + cw * 64;  // this warpgroup's first row
      const int my_row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
      // keys this warpgroup's rows may see: a prefix of the tile's key tiles
      const int wg_end =
          r0 >= Lq ? 0 : (causal ? min(w.kv_len, min(r0 + 64, Lq) + off) : w.kv_len);
      const int wg_tiles =
          wg_end > 0 ? min(w.n_tiles, (wg_end + C::kBlockN - 1) / C::kBlockN) : 0;
      const int qb = local & 1;
      const uint32_t q_tile = sQ(qb);

      float m[2] = {-INFINITY, -INFINITY};  // running row max (log2 domain)
      float l[2] = {0.f, 0.f};              // this thread's share of the row sums
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      uint32_t pa[8][4];  // P of the previous key tile, bf16 A operands
      float sc[64];

      // Key tile it's S = Q K^T is issued together with the P V of tile
      // it - 1, so the softmax of tile it runs while the tensor cores do
      // that P V; the last tile's P V is issued after the loop.
      mbar_wait(q_full(qb), (local >> 1) & 1);
      for (int it = 0; it < wg_tiles; ++it) {
        const int s = (ring + it) % kS, s_prev = (ring + it + kS - 1) % kS;
        const int n0 = it * C::kBlockN;
        mbar_wait(full(s), ((ring + it) / kS) & 1);
        my_turn();
        fence_regs(sc);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n128(sc, desc_kmajor<D, C::kBlockM>(q_tile, cw * 64, kk),
                        desc_kmajor<D, C::kBlockN>(sK(s), 0, kk), kk > 0);
        wgmma_commit();
        if (it > 0) {
#pragma unroll
          for (int kk = 0; kk < C::kBlockN / 16; ++kk)
            wgmma_rs_rows<D, C::kBlockN>(acc, pa[kk], sV(s_prev), kk);
          wgmma_commit();
          their_turn();
          wgmma_wait<1>();  // S is ready; the previous P V may still run
        } else {
          their_turn();
          wgmma_wait<0>();
        }
        fence_regs(sc);

        // masks, only where the tile straddles an edge
        if (n0 + C::kBlockN > w.kv_len || (causal && n0 + C::kBlockN - 1 > r0 + off)) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int col = n0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = my_row[(i >> 1) & 1];
            if (col >= w.kv_len || (causal && col > row + off)) sc[i] = -INFINITY;
          }
        }
        // online softmax: tile row max, p = exp2(s * scale - m) rounded to
        // bf16 (the P V operand); l sums the rounded values
        float m_use[2], alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float m_new = fmaxf(m[hr], tmax * scale_log2);
          m_use[hr] = (m_new == -INFINITY) ? 0.f : m_new;  // no keys yet: keep p = 0
          alpha[hr] = fast_exp2(m[hr] - m_use[hr]);
          m[hr] = m_new;
          l[hr] *= alpha[hr];
        }
        uint32_t pn[32];  // this tile's P, packed in A-operand order
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int hr = (i >> 1) & 1;
          const uint32_t u = pack_bf16(fast_exp2(fmaf(sc[i], scale_log2, -m_use[hr])),
                                       fast_exp2(fmaf(sc[i + 1], scale_log2, -m_use[hr])));
          l[hr] += bf16_lo(u) + bf16_hi(u);
          pn[i / 2] = u;
        }

        // the previous P V is done: its V stage is free, O can be rescaled
        wgmma_wait<0>();
        fence_regs(acc);
        if (it > 0) mbar_arrive(empty(s_prev));
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) pa[kk][x] = pn[4 * kk + x];
      }
      mbar_arrive(q_empty(qb));  // every S of this work tile is done
      if (wg_tiles > 0) {        // the last key tile's P V
        const int s_last = (ring + wg_tiles - 1) % kS;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kBlockN / 16; ++kk)
          wgmma_rs_rows<D, C::kBlockN>(acc, pa[kk], sV(s_last), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty(s_last));
      }
      // key tiles past this warpgroup's rows: release them unread, keep
      // taking turns
      for (int it = wg_tiles; it < w.n_tiles; ++it) {
        const int s = (ring + it) % kS;
        mbar_wait(full(s), ((ring + it) / kS) & 1);
        my_turn();
        their_turn();
        mbar_arrive(empty(s));
      }
      ring += w.n_tiles;

      // epilogue: o = acc / l in (B, Lq, H, D), lse in (B, H, Lq)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
        const int row = my_row[hr];
        if (row >= Lq) continue;
        const bool live = l[hr] > 0.f;
        const float inv = live ? 1.f / l[hr] : 0.f;
        __nv_bfloat16* orow = o + (((long long)w.b * Lq + row) * H + w.h) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
        if (t == 0)
          lse[((long long)w.b * H + w.h) * Lq + row] =
              live ? (m[hr] + log2f(l[hr])) * kLn2 : kDeadLse;
      }
    }
    if (cw == 0) my_turn();  // warpgroup 1's last turn, so no arrival is left over
  }
}

// fp32 path: one warp per query row at a time (4 rows per warp), lanes split
// the head dim for P V and the keys of a 32-key tile for Q K^T.
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kv_lens, int H,
    int Lq, int Lk, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, int causal, float scale) {
  constexpr int kRowsPerWarp = 4;
  constexpr int kBlockM = 4 * kRowsPerWarp;
  constexpr int kBlockN = 32;
  constexpr int kPerLane = D / 32;
  __shared__ float sQ[kBlockM][D];
  __shared__ float sK[kBlockN][D + 1];
  __shared__ float sV[kBlockN][D + 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = qt * kBlockM;
  const float* qb = q + b * q_bs + h * D;
  const float* kb = k + b * k_bs + h * D;
  const float* vb = v + b * v_bs + h * D;

  for (int i = threadIdx.x; i < kBlockM * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    sQ[r][c] = (row0 + r < Lq) ? qb[(long long)(row0 + r) * q_rs + c] : 0.f;
  }

  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Lk) : Lk;
  const int off = Lk - Lq;
  const int n_end = causal ? min(kv_len, min(row0 + kBlockM, Lq) + off) : kv_len;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockN * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < Lk;
      sK[r][c] = in ? kb[(long long)(n0 + r) * k_rs + c] : 0.f;
      sV[r][c] = in ? vb[(long long)(n0 + r) * v_rs + c] : 0.f;
    }
    __syncthreads();
    const int col = n0 + lane;  // this lane's key
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp * kRowsPerWarp + r;
      const int row = row0 + lr;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[lr][d], sK[lane][d], dot);
      const bool ok = col < kv_len && (!causal || col <= row + off);
      const float x = ok ? dot * scale : -INFINITY;
      float tmax = x;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, s));
      const float m_new = fmaxf(m[r], tmax);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      const float p = expf(x - m_use);
      float psum = p;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, s);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kBlockN; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[r][i] = fmaf(pj, sV[j][lane + 32 * i], acc[r][i]);
      }
    }
  }

  const long long o_rs = (long long)H * D;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= Lq) continue;
    const bool live = l[r] > 0.f;
    const float inv = live ? 1.f / l[r] : 0.f;
    float* orow = o + (long long)b * Lq * o_rs + row * o_rs + h * D;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) orow[lane + 32 * i] = acc[r][i] * inv;
    if (lane == 0)
      lse[((long long)b * H + h) * Lq + row] = live ? m[r] + logf(l[r]) : kDeadLse;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                const int* kv_lens, int B, int H, int Lq, int Lk, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, int causal,
                float scale, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap tq, tk, tv;
  // with no keys no K/V tile is loaded; the maps only need a valid base
  const void* kb = Lk > 0 ? k : q;
  const void* vb = Lk > 0 ? v : q;
  if (!make_tensor_map<D, C::kBlockM>(&tq, q, H, Lq, B, q_rs, q_bs) ||
      !make_tensor_map<D, C::kBlockN>(&tk, kb, H, Lk, B, k_rs, k_bs) ||
      !make_tensor_map<D, C::kBlockN>(&tv, vb, H, Lk, B, v_rs, v_bs))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, n_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  // one persistent block per SM (or per work tile, if fewer)
  const int n_items = (Lq + C::kBlockM - 1) / C::kBlockM * H * B;
  const dim3 grid(n_items < n_sm ? n_items : n_sm);
  flash_fwd_wgmma_kernel<D><<<grid, 384, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), kv_lens, H, Lq, Lk,
      causal, scale * kLog2e, B, n_items);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                const int* kv_lens, int B, int H, int Lq, int Lk, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, int causal,
                float scale, cudaStream_t stream) {
  const dim3 grid((Lq + 15) / 16, H, B);
  flash_fwd_f32_kernel<D><<<grid, 128, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), kv_lens, H, Lq, Lk, q_bs, q_rs, k_bs,
      k_rs, v_bs, v_rs, causal, scale);
}


}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; o is a
// contiguous (B, Lq, H, D) tensor and lse a contiguous (B, H, Lq) fp32
// tensor. kv_lens is a (B,) int32 device pointer or NULL. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int pixparse_flash_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                       void* o, void* lse, const void* kv_lens, int B, int H,
                                       int Lq, int Lk, int D, long long q_bs, long long q_rs,
                                       long long k_bs, long long k_rs, long long v_bs,
                                       long long v_rs, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  if (B <= 0 || H <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
#define PIXPARSE_FLASH_ARGS \
  q, k, v, o, lse, lens, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, causal, scale, s
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(PIXPARSE_FLASH_ARGS);
      case 64: return launch_bf16<64>(PIXPARSE_FLASH_ARGS);
      case 128: return launch_bf16<128>(PIXPARSE_FLASH_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 32: launch_f32<32>(PIXPARSE_FLASH_ARGS); break;
      case 64: launch_f32<64>(PIXPARSE_FLASH_ARGS); break;
      case 128: launch_f32<128>(PIXPARSE_FLASH_ARGS); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PIXPARSE_FLASH_ARGS
  return static_cast<int>(cudaGetLastError());
}
