// Fused tied-head cross entropy for Hopper (sm_90a), bound through plain C
// entry points (ctypes; see pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernels
//   pixparse_tpu/ops/loss.py::_ce_fwd_kernel   (per-token lse and target logit)
//   pixparse_tpu/ops/loss.py::_ce_bwd_kernel   (dh and dE)
// For T tokens h (T, D) against a vocabulary table E of V rows, s = h E^T:
//   forward:  lse[t] = logsumexp_v s[t, v],  tgt[t] = s[t, target[t]]
//   backward: g = (exp(s - max(lse, -0.5e30)) - onehot(target)) * coef,
//             rounded to bf16;  dh = g E,  dE = g^T h,  fp32 accumulation,
//             each rounded once to bf16
// Ignored tokens carry target -1 (matches no column) and coef 0, so their
// rows of dh are exactly 0. The table is never padded in device memory.
//
// Forward (bf16): one wgmma + TMA product F over the whole vocabulary, then
// a small merge. What bounds it on an H100: the logits' product, 2*T*V*D
// FLOP (1.26e12 at cruller_base: 1.28 ms at 989 TFLOP/s); its bytes (h and
// E once) are far smaller. F runs the backward's mainloop below (as K1:
// h and E K-major, 128 x 256 output tiles, blocks in groups of 8 token tiles
// so a wave shares E in L2), with the tensor map over all of E (TMA reads
// zeros past V: no chunks, no workspace). Its epilogue reduces each row of
// the tile to (max, sum of exp2 relative to it) over the columns < V, and
// the tile that holds a row's target column writes its logit to tgt. The
// (m, l) pairs go to an fp32 buffer of ceil(V / 256) x T pairs from the
// caller (25.8 MB at cruller_base); a second kernel merges each row's in
// vocabulary-tile order into lse (DEAD_LSE where the sum is 0) and zeroes
// tgt where the target matches no column. The logits never reach device
// memory.
//
// Backward (bf16): three wgmma + TMA products per vocabulary chunk.
// What bounds it on an H100: the three products, 6*T*V*D FLOP (3.8e12 at
// cruller_base, T = 16368, V = 50265, D = 768: 3.8 ms at 989 TFLOP/s),
// against the logits' gradient g, which has to pass through device memory
// once it is no longer recomputed: ~3 x 2*T*V bytes (written once, read
// twice; 4.9 GB, 1.5 ms at 3.35 TB/s). The tensor cores bound it, and
// their full rate is reached only through wgmma fed by TMA.
// What the design does about it. The vocabulary is cut into chunks of Vc
// rows (a multiple of 256, chosen by the caller so that a (T, Vc) bf16
// workspace stays within ~256 MiB; ops/loss.py::_ce_bwd_plan), and for each
// chunk [v0, v1), in order, on the caller's stream:
//   K1  G = epilogue(h E[v0:v1]^T)     M = T,  N = Vc, K = D
//       both operands K-major; the epilogue reads lse, coef and target per
//       row and writes g in bf16 to the workspace (columns >= V write 0;
//       rows >= T are not stored);
//   K2  dE[v0:v1] = G^T h              M = Vc, N = D,  K = T
//       complete within the chunk, rounded once to bf16. A = G^T is read
//       from the (token, vocab) workspace through the wgmma transpose bit
//       for A (MN-major, one 64-column panel per consumer warpgroup), so no
//       transposed copy of g is written (that would cost 2*T*Vc more bytes
//       a chunk); B = h is MN-major too;
//   K3  dh_acc (+)= G E[v0:v1]         M = T,  N = D,  K = Vc
//       B = E is MN-major. dh_acc is fp32 (T, D): the first chunk writes
//       it, later ones add to it in chunk order, the last rounds it to bf16
//       into dh (one chunk: straight to dh). No atomics: every output
//       element has one owner, so the result is bit-for-bit repeatable.
// Each product (and F) is one launch of the same warp-specialised mainloop:
// one producer thread keeps a 4-stage mbarrier ring of 64-deep K tiles in
// flight by TMA (2-D tensor maps, 128B swizzle; rows and columns past the
// matrix's edge read as zeros), two consumer warpgroups own 64 rows each of
// a 128 x BN output tile and issue wgmma m64nBNk16 from shared memory
// (BN = 256 for K1, F and at D = 1024, 192 at D = 768, 64 at D = 64);
// setmaxnreg moves registers from the producer to the consumers. No (rows x
// D) accumulator has to fit the registers: each block owns one 128 x BN
// output tile. Compared with the mma.sync kernel this replaces (12*T*V*D of
// work at D = 1024, the logits built twice), the logits are built once.
//
// fp32 inputs take SIMT kernels (one block per row, fp32 FMA) with the same
// semantics, for the fp32 parity path, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::hopper;

constexpr float kDeadLse = -1e30f;
constexpr float kLseFloor = -0.5e30f;

// ---------------------------------------------------------------------------
// bf16: the forward's product and the backward's three products of a
// vocabulary chunk, one TMA + wgmma mainloop
// ---------------------------------------------------------------------------

constexpr int kGemmM = 128;  // output rows of a block: two consumer warpgroups x 64
constexpr int kGemmK = 64;   // depth of a K tile: one 128-byte swizzled panel
constexpr int kGemmStages = 4;
constexpr int kPanelBytes = 64 * 128;  // a 64 x 64 bf16 panel
constexpr int kVocabTile = 256;  // N tile of K1 and the forward; chunk starts are multiples of it

// The backward's K1, K2, K3 and the forward's logits product (F).
enum CeProduct { kProductG = 0, kProductDE = 1, kProductDH = 2, kProductLse = 3 };

// Output columns of a K2/K3 block: the whole width at D = 64, a quarter at
// D = 768 and 1024, an eighth at D = 2048.
__host__ __device__ constexpr int ce_bwd_bn(int D) { return D == 64 ? 64 : D == 768 ? 192 : 256; }

template <int kProduct, int BN>
struct GemmCfg {
  // Operands stored MN-major (the wgmma transpose bit): K2's A (G read as
  // G^T) and B (h), K3's B (E). The others are K-major.
  static constexpr int kTA = kProduct == kProductDE;
  static constexpr int kTB = kProduct == kProductDE || kProduct == kProductDH;
  static constexpr int kABytes = kGemmM * kGemmK * 2;
  static constexpr int kBBytes = BN * kGemmK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarOffset = kGemmStages * kStageBytes;
  // + up to 1023 bytes to align the dynamic shared memory to 1024
  static constexpr int kSmem = kBarOffset + 2 * kGemmStages * 8 + 1024;
};

struct CeGemmArgs {
  const int* target;
  const float* lse;
  const float* coef;
  float2* part;        // F: (m, l) per vocabulary tile and row, (n_tiles, T)
  float* tgt;          // F: the target's logit (T,)
  __nv_bfloat16* g;    // K1: the (T, ldg) workspace
  __nv_bfloat16* out;  // K2: dE (V, D); K3: dh (T, D)
  float* acc;          // K3: dh_acc (T, D) fp32
  int T, D, v0, nv;    // nv = v1 - v0, this chunk's vocabulary rows
  int ldg, k_tiles;
  int first, last;     // K3: this chunk is the first / the last
  int m_tiles, n_tiles;  // output tiles: 128 rows, BN columns
};

// One 128 x BN output tile of product kProduct (a 1-D grid of m_tiles x
// n_tiles blocks). tm_a / tm_b: 2-D maps whose boxes are one 64-column panel and
// 128 rows (K-major A), 256 rows (K1's B) or 64 rows (MN-major operands).
template <int kProduct, int BN>
__global__ void __launch_bounds__(384, 1) ce_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const CeGemmArgs args) {
  using C = GemmCfg<kProduct, BN>;
  constexpr int kS = kGemmStages;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  const uint32_t base = (smem_addr(gemm_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kBarOffset;
  auto sA = [&](int s) { return base + s * C::kStageBytes; };
  auto sB = [&](int s) { return sA(s) + C::kABytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };
  // Blocks walk the output tiles in groups of kGroup tile rows, rows
  // fastest. K1: groups of 8 token tiles, so a wave of blocks shares its h
  // rows and its E rows in L2 (rows of E fastest re-read the whole chunk of
  // E for every token tile: 0.73 against 1.01 ms at donut_base, H100).
  // F walks the tiles as K1 does. K2, K3: the D / BN blocks of one output
  // row tile run side by side and share its A operand.
  constexpr int kGroup = kProduct == kProductG || kProduct == kProductLse ? 8 : 1;
  const int per_group = kGroup * args.n_tiles;
  const int first = blockIdx.x / per_group * kGroup, r = blockIdx.x % per_group;
  const int rows = min(args.m_tiles - first, kGroup);
  const int n0 = (r / rows) * BN, m0 = (first + r % rows) * kGemmM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < args.k_tiles; ++kt) {
        const int s = kt % kS;
        const int k0 = kt * kGemmK;
        mbar_wait(empty(s), ((kt / kS) & 1) ^ 1);
        mbar_expect_tx(full(s), C::kStageBytes);
        if constexpr (kProduct == kProductG || kProduct == kProductLse) {
          tma_load_2d(sA(s), &tm_a, full(s), k0, m0);            // h rows
          tma_load_2d(sB(s), &tm_b, full(s), k0, args.v0 + n0);  // E rows of the chunk
        } else if constexpr (kProduct == kProductDE) {
#pragma unroll
          for (int p = 0; p < 2; ++p)  // G[t, v]: tokens are K, vocabulary rows M
            tma_load_2d(sA(s) + p * kPanelBytes, &tm_a, full(s), m0 + 64 * p, k0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)  // h[t, d]
            tma_load_2d(sB(s) + p * kPanelBytes, &tm_b, full(s), n0 + 64 * p, k0);
        } else {
          tma_load_2d(sA(s), &tm_a, full(s), k0, m0);  // G rows
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)  // E[v, d] of the chunk
            tma_load_2d(sB(s) + p * kPanelBytes, &tm_b, full(s), n0 + 64 * p, args.v0 + k0);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 output rows each ----
  setmaxnreg_inc<232>();
  const int cw = wg - 1;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < args.k_tiles; ++kt) {
    const int s = kt % kS;
    mbar_wait(full(s), (kt / kS) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmK / 16; ++kk) {
      const uint64_t da = C::kTA ? desc_mnmajor(sA(s) + cw * kPanelBytes, kk, kPanelBytes)
                                 : desc_kmajor<64, kGemmM>(sA(s), cw * 64, kk);
      const uint64_t db = C::kTB ? desc_mnmajor(sB(s), kk, kPanelBytes)
                                 : desc_kmajor<64, BN>(sB(s), 0, kk);
      wgmma_ss<BN, C::kTA, C::kTB>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's products are done: free its stage
    if (kt > 0) mbar_arrive(empty((kt - 1) % kS));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: accumulator register 4j + 2h + e is row 16w + g + 8h, column
  // 8j + 2t + e of this warpgroup's 64 x BN tile (hopper.cuh)
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = m0 + cw * 64 + w * 16 + g + 8 * hr;
    if constexpr (kProduct == kProductLse) {
      // the tile's max and sum of exp2 relative to it over the row's columns
      // < V (exp2 domain), reduced over the quad that holds the row; the
      // target's logit from the tile that holds its column. The shuffles
      // run on every lane: rows past T only skip the stores.
      const int lim = args.nv - n0 - 2 * t;  // this thread's column 8j + e is < V iff 8j + e < lim
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e < lim) mx = fmaxf(mx, acc[4 * j + 2 * hr + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m2 = mx * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e < lim) sum += fast_exp2(fmaf(acc[4 * j + 2 * hr + e], kLog2e, -m2));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (row >= args.T) continue;
      if (t == 0) args.part[(long long)(n0 / BN) * args.T + row] = make_float2(m2, sum);
      const int tc = args.target[row] - n0 - 2 * t;  // the target as this thread's 8j + e
      if (tc >= 0 && tc < BN && tc < lim) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + e == tc) args.tgt[row] = acc[4 * j + 2 * hr + e];
      }
    } else if constexpr (kProduct == kProductG) {
      // g = (p - onehot) * coef in bf16; columns past the chunk give 0
      if (row >= args.T) continue;
      const float lse2 = fmaxf(args.lse[row], kLseFloor) * kLog2e;
      const float cf = args.coef[row];
      const int tcol = args.target[row] - args.v0;  // the target's column in this chunk
      __nv_bfloat16* grow = args.g + (long long)row * args.ldg + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * t + e;
          const float p = col < args.nv ? exp2f(acc[4 * j + 2 * hr + e] * kLog2e - lse2) : 0.f;
          gv[e] = (p - (col == tcol ? 1.f : 0.f)) * cf;
        }
        *reinterpret_cast<uint32_t*>(grow + 8 * j) = pack_bf16(gv[0], gv[1]);
      }
    } else if constexpr (kProduct == kProductDE) {
      if (row >= args.nv) continue;  // rows of the chunk's vocabulary
      __nv_bfloat16* orow = args.out + (long long)(args.v0 + row) * args.D + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    } else {
      if (row >= args.T) continue;
      const long long off = (long long)row * args.D + n0 + 2 * t;
      // the running sum of the earlier chunks, every load issued before the
      // first store (a load after each store waited out its latency: 8.4
      // against 1.7 ms over cruller_base's 7 chunks, H100)
      float2 prev[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        prev[j] = args.first ? make_float2(0.f, 0.f)
                             : *reinterpret_cast<const float2*>(args.acc + off + 8 * j);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float x = prev[j].x + acc[4 * j + 2 * hr], y = prev[j].y + acc[4 * j + 2 * hr + 1];
        if (args.last)
          *reinterpret_cast<uint32_t*>(args.out + off + 8 * j) = pack_bf16(x, y);
        else
          *reinterpret_cast<float2*>(args.acc + off + 8 * j) = make_float2(x, y);
      }
    }
  }
}

// lse per row from the forward's (m, l) partials, merged in vocabulary-tile
// order (a repeat gives the same bits); tgt 0 where the target matches no
// column (the product writes the others).
constexpr int kMergeThreads = 128;

__global__ void __launch_bounds__(kMergeThreads) ce_lse_merge_kernel(
    const float2* __restrict__ part, const int* __restrict__ target, float* __restrict__ lse,
    float* __restrict__ tgt, int T, int V, int n_tiles) {
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= T) return;
  float m = -INFINITY, l = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_tiles; ++i) {
    const float2 p = part[(long long)i * T + row];
    const float m_new = fmaxf(m, p.x);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    l = l * exp2f(m - m_use) + p.y * exp2f(p.x - m_use);
    m = m_new;
  }
  lse[row] = l > 0.f ? (m + log2f(l)) * kLn2 : kDeadLse;
  const int tg = target[row];
  if (tg < 0 || tg >= V) tgt[row] = 0.f;
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

template <int kProduct, int BN>
cudaError_t set_gemm_smem() {
  return cudaFuncSetAttribute(ce_gemm_kernel<kProduct, BN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              GemmCfg<kProduct, BN>::kSmem);
}

template <int kProduct, int BN>
void launch_gemm(const CUtensorMap& a, const CUtensorMap& b, const CeGemmArgs& args, dim3 grid,
                 cudaStream_t stream) {
  ce_gemm_kernel<kProduct, BN>
      <<<grid, 384, GemmCfg<kProduct, BN>::kSmem, stream>>>(a, b, args);
}

// F over the whole vocabulary (the tensor map spans it; TMA zero-fills past
// V), then the merge. part: (ceil(V / 256), T) float2.
template <int D>
int launch_fwd_bf16(const void* h, const void* e, const int* target, float* lse, float* tgt,
                    void* part, int T, int V, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!part) return invalid;
  cudaError_t err = set_gemm_smem<kProductLse, kVocabTile>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap h_k, e_k;
  if (!make_map_2d(&h_k, h, T, D, D, kGemmM) || !make_map_2d(&e_k, e, V, D, D, kVocabTile))
    return invalid;
  CeGemmArgs args{};
  args.target = target;
  args.part = static_cast<float2*>(part);
  args.tgt = tgt;
  args.T = T;
  args.D = D;
  args.v0 = 0;
  args.nv = V;
  args.k_tiles = D / kGemmK;
  args.m_tiles = (T + kGemmM - 1) / kGemmM;
  args.n_tiles = (V + kVocabTile - 1) / kVocabTile;
  launch_gemm<kProductLse, kVocabTile>(h_k, e_k, args, dim3(args.m_tiles * args.n_tiles), stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_lse_merge_kernel<<<(T + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, stream>>>(
      args.part, target, lse, tgt, T, V, args.n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// K1, K2, K3 for each chunk [v0, v0 + Vc) of the vocabulary, in order.
template <int D>
int launch_bwd_bf16(const void* h, const void* e, const int* target, const float* lse,
                    const float* coef, void* dh, void* de, void* ws, void* dh_acc, int T, int V,
                    int Vc, cudaStream_t stream) {
  constexpr int BN = ce_bwd_bn(D);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (!ws || Vc <= 0 || Vc % kVocabTile || (Vc < V && !dh_acc)) return invalid;
  cudaError_t err = set_gemm_smem<kProductG, kVocabTile>();
  if (err == cudaSuccess) err = set_gemm_smem<kProductDE, BN>();
  if (err == cudaSuccess) err = set_gemm_smem<kProductDH, BN>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap h_k, e_k, h_mn, e_mn;  // K-major boxes for K1, MN-major for K2 / K3
  if (!make_map_2d(&h_k, h, T, D, D, kGemmM) || !make_map_2d(&e_k, e, V, D, D, kVocabTile) ||
      !make_map_2d(&h_mn, h, T, D, D, 64) || !make_map_2d(&e_mn, e, V, D, D, 64))
    return invalid;
  CeGemmArgs args{};
  args.target = target;
  args.lse = lse;
  args.coef = coef;
  args.g = static_cast<__nv_bfloat16*>(ws);
  args.acc = static_cast<float*>(dh_acc);
  args.T = T;
  args.D = D;
  args.ldg = Vc;
  const int m_tiles = (T + kGemmM - 1) / kGemmM;
  for (int v0 = 0; v0 < V; v0 += Vc) {
    const int nv = V - v0 < Vc ? V - v0 : Vc;
    // the chunk's columns of the workspace: zeros past nv and past T
    CUtensorMap g_k, g_mn;
    if (!make_map_2d(&g_k, ws, T, nv, Vc, kGemmM) || !make_map_2d(&g_mn, ws, T, nv, Vc, 64))
      return invalid;
    args.v0 = v0;
    args.nv = nv;
    args.first = v0 == 0;
    args.last = v0 + Vc >= V;
    args.out = nullptr;
    args.k_tiles = D / kGemmK;
    args.m_tiles = m_tiles;
    args.n_tiles = (nv + kVocabTile - 1) / kVocabTile;
    launch_gemm<kProductG, kVocabTile>(h_k, e_k, args, dim3(args.m_tiles * args.n_tiles), stream);
    args.out = static_cast<__nv_bfloat16*>(de);
    args.k_tiles = (T + kGemmK - 1) / kGemmK;
    args.m_tiles = (nv + kGemmM - 1) / kGemmM;
    args.n_tiles = D / BN;
    launch_gemm<kProductDE, BN>(g_mn, h_mn, args, dim3(args.m_tiles * args.n_tiles), stream);
    args.out = static_cast<__nv_bfloat16*>(dh);
    args.k_tiles = (nv + kGemmK - 1) / kGemmK;
    args.m_tiles = m_tiles;
    launch_gemm<kProductDH, BN>(g_k, e_mn, args, dim3(args.m_tiles * args.n_tiles), stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and e share it). h is a contiguous
// (T, D) matrix, e a contiguous (V, D) table, target (T,) int32 with -1 for
// ignored tokens; lse and tgt are (T,) fp32 outputs. bf16 takes D in
// {64, 768, 1024, 2048}, h and e 16-byte aligned, and the caller's scratch part,
// ceil(V / 256) x T float2; fp32 any D <= 1024 that is a multiple of 4 (part
// unused). Returns the CUDA error code (0 = success).
extern "C" int pixparse_fused_ce_fwd(int dtype, const void* h, const void* e, const void* target,
                                     void* lse, void* tgt, void* part, int T, int V, int D,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(target);
  float* lp = static_cast<float*>(lse);
  float* gp = static_cast<float*>(tgt);
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_fwd_bf16<64>(h, e, tp, lp, gp, part, T, V, s);
      case 768: return launch_fwd_bf16<768>(h, e, tp, lp, gp, part, T, V, s);
      case 1024: return launch_fwd_bf16<1024>(h, e, tp, lp, gp, part, T, V, s);
      case 2048: return launch_fwd_bf16<2048>(h, e, tp, lp, gp, part, T, V, s);
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
// bf16 also takes the caller's scratch: ws, a (T, Vc) bf16 workspace (Vc a
// multiple of 256: the vocabulary chunk), and dh_acc, a (T, D) fp32 buffer
// (may be NULL when Vc >= V); h, e and ws 16-byte aligned. fp32 ignores them.
extern "C" int pixparse_fused_ce_bwd(int dtype, const void* h, const void* e, const void* target,
                                     const void* lse, const void* coef, void* dh, void* de,
                                     void* ws, void* dh_acc, int T, int V, int D, int Vc,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(target);
  const float* lp = static_cast<const float*>(lse);
  const float* cp = static_cast<const float*>(coef);
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_bwd_bf16<64>(h, e, tp, lp, cp, dh, de, ws, dh_acc, T, V, Vc, s);
      case 768: return launch_bwd_bf16<768>(h, e, tp, lp, cp, dh, de, ws, dh_acc, T, V, Vc, s);
      case 1024: return launch_bwd_bf16<1024>(h, e, tp, lp, cp, dh, de, ws, dh_acc, T, V, Vc, s);
      case 2048: return launch_bwd_bf16<2048>(h, e, tp, lp, cp, dh, de, ws, dh_acc, T, V, Vc, s);
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
