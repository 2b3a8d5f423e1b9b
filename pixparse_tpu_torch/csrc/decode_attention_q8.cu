// Single-token decode attention over int8 (B, Lk, H*D) KV caches for Hopper
// (sm_90a), bound through a plain C entry point (ctypes; see
// pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/decode_attention.py::_decode_attn_q8_kernel
// with its exact semantics, per (sample, head):
//   q_i8, qs = quantize(q)                       (absmax / 127, half to even)
//   s   = (int32(q_i8 . k_i8[j]) * qs) * (k_scale[j] * Dh^-0.5)
//   p   = masked softmax of s (fully masked rows give p = 0)
//   pv_i8, ps = quantize(p * v_scale)            over the head's whole row
//   o   = int32(sum_j pv_i8[j] * v_i8[j]) * ps
// Both integer products are exact int32 sums.
//
// What bounds it on an H100: a step reads each valid key's int8 K and V row
// (2 bytes per cache element) and two fp32 scales per head, and does ~4
// integer operations per element: it is bound by those bytes at 3.35 TB/s
// (cruller_base's cross cache at B = 16: 26.3 MB, 7.9 us; donut_base's at
// B = 8: 83.6 MB, 25.0 us). Streaming at that rate needs tens of KB in
// flight on every SM at once.
//
// What the design does about it: two kernels, chosen by shape
// (ops/decode_attention.py::decode_q8_by_heads). Where B * H blocks fill
// the card and rows are short, a block per (sample, head), with no
// exchange between blocks (the per-head kernel below; on an H100 0.0263 ms
// against the split kernel's 0.0292 at cruller_base's cross cache, B 16,
// 1024 keys). Elsewhere the split kernel, the layout of the bf16 kernel
// (decode_attention.cu) with the cross-split exchanges the int8 semantics
// need (0.0550 ms against the per-head kernel's 0.0692 at donut_base's,
// B 8, 4864 keys):
// - a block owns one (sample, key split) across all H heads, so a key tile
//   is whole contiguous H*D-byte rows. One thread keeps the tiles in flight
//   by 1-D bulk copies (cp.async.bulk) through one 4-stage mbarrier ring of
//   <= 16 KB tiles of kt = 4 * (256 / (H*D / 16)) keys. The splits (plan:
//   ops/decode_attention.py::decode_plan_q8) give about two blocks per SM;
//   when B * n_split would exceed one resident wave, a block walks samples
//   blockIdx.y, blockIdx.y + gridDim.y, ... (every split of a sample is on
//   the card at once, in the same order, so the waits below cannot hang);
// - q, then each head's scales for the split (H bulk rows of the (B, H, Lk)
//   scale arrays; plain loads where those rows are not 16-byte aligned, e.g.
//   Lk * 4 not a multiple of 16), then the split's mask bytes are requested
//   before any key tile: behind the tiles' megabytes they arrived
//   microseconds late. Keys at or past the split's last valid key are never
//   read;
// - scores: q is quantized once per sample in registers; each thread owns 16
//   bytes of a row (four words against its head's q words by __dp4a), the
//   D/16 owners of a head sum by shuffles, and the split keeps its H x
//   split_keys fp32 scores in shared memory. K streams first and alone (the
//   meetings below wait for it), its tiles marked evict-first in L2;
// - the int8 semantics need the head's softmax over all keys and then the
//   absmax of p * v_scale over all keys before any split can quantize. So
//   the launch is cooperative (cudaLaunchCooperativeKernel refuses a grid that
//   cannot be resident at once) and the splits of a sample meet twice. Each
//   publishes its values into slots that hold a NaN pattern no split writes,
//   and reads the others' by polling those slots, so one round trip brings
//   them (a counter, then a load, took three): each head's (max, sum-exp),
//   merged by every block in one fixed butterfly order (identical bits);
//   then each head's absmax of the exact p * v_scale, whose max over the
//   splits gives ps. Waits trap after ~2^22 polls instead of holding the
//   card. While the splits meet, V streams: the ring's first V tiles, the
//   rest into L2 (cp.async.bulk.prefetch.L2), whence the V pass copies them;
// - p v: pv_i8 is quantized per key into shared memory; each thread owns 16
//   columns and a group of 4 keys per tile: the 4 rows' bytes are transposed
//   (__byte_perm) so one __dp4a adds 4 keys' products for a column. Tiles past
//   the last key with a non-zero pv_i8 are not copied to shared memory. Each
//   split writes an int32 partial; the sample's last split (a counter) adds
//   them and writes o = sum * ps. Integer sums are exact, so a repeat gives
//   the same bits.
// Every launch leaves the counters at 0 and the slots empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kTileBytes = 16384;
constexpr int kMaxRowBytes = 4096;                // H*D: one thread owns 16 bytes of a row
constexpr int kMaxHeads = kMaxRowBytes / 32;      // D >= 32
constexpr int kMaxSplits = 256;                   // a lane holds 8 splits' statistics
constexpr int kSmemBytes = 110 * 1024;            // every launch: two blocks per SM
constexpr int kRingOffset = 1024;                 // after the barriers and ps[kMaxHeads]
constexpr int kRegionOffset = kRingOffset + kStages * kTileBytes;
constexpr int kRegionBytes = kSmemBytes - kRegionOffset;  // scores, scales, pv_i8, mask
constexpr float kNegInf = -1e30f;
constexpr long long kMaxPolls = 1LL << 22;  // ~seconds of L2 round trips

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Symmetric int8 quantization with the scale of a row whose absmax is `am`.
__device__ __forceinline__ float q8_scale(float am) { return (am > 0.f ? am : 127.f) / 127.f; }
__device__ __forceinline__ int q8(float x, float scale) {
  return static_cast<int>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Block-wide max of an int; `red` holds kWarps ints. Every thread gets it.
__device__ __forceinline__ int block_max_int(int x, int* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, s));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = max(r, red[w]);
  __syncthreads();  // red is free again
  return r;
}

// atomicAdd at device scope with release and acquire semantics.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// A split's statistics meet in device memory: each value is published
// once, over a slot that holds kEmpty (a NaN no split writes), and read
// when it is no longer kEmpty, so a reader's poll brings the value itself.
constexpr uint32_t kEmpty = 0xffffffffu;

__device__ __forceinline__ void publish(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_relaxed(const float* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The published value at p. The grid is co-resident (cooperative launch),
// so a wait that lasts seconds is a fault: trap.
__device__ __forceinline__ float await_stat(const float* p, uint32_t v) {
  for (long long polls = 0; v == kEmpty; ++polls) {
    if (polls == kMaxPolls) __trap();
    v = ld_relaxed(p);
  }
  return __uint_as_float(v);
}

// dst[i] = the published value at addr(i), i < n: each thread's loads
// issued together, the missing ones polled again.
template <typename Addr>
__device__ __forceinline__ void gather_stats(float* dst, int n, Addr addr) {
  for (int i0 = 0; i0 < n; i0 += 4 * kThreads) {
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + threadIdx.x + u * kThreads;
      v[u] = i < n ? ld_relaxed(addr(i)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + threadIdx.x + u * kThreads;
      if (i < n) dst[i] = await_stat(addr(i), v[u]);
    }
  }
}

// A tile read once: its lines may leave L2 first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// bulk_load with an L2 eviction policy.
__device__ __forceinline__ void bulk_load_hint(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// `bytes` (a multiple of 16) of device memory into L2, nothing else.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// bulk copies (async proxy) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct Q8Args {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const uint8_t* mask;
  void* o;
  int* part;      // (B, n_split, H*D) int32 partial sums of pv_i8 . v_i8
  float* stat;    // (B, n_split, 3, H): max, sum of exp, absmax of p * v_scale;
                  // kEmpty before and after a launch
  int* counters;  // (B,): splits done; 0 before and after a launch
  int B, H, Lk, kt, split_keys, n_split, scale_bulk;
  long long q_bs, k_bs, v_bs, s_bs, s_hs, m_bs;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) decode_attn_q8_kernel(const Q8Args a) {
  constexpr int kG = D / 16;  // owners of one head's row, 16 bytes each
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, H = a.H, HD = H * D, NS = HD / 16, R = kThreads / NS;
  const int kt = a.kt, S = a.split_keys, n_split = a.n_split;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  auto full = [&](int s) { return base + 8 * s; };
  const uint32_t scale_bar = base + 8 * kStages;
  int* red = reinterpret_cast<int*>(smem + 64);  // [kWarps] block reductions, [kWarps] ticket
  float* ps_sm = reinterpret_cast<float*>(smem + 128);
  unsigned char* ring = smem + kRingOffset;
  float* s_sm = reinterpret_cast<float*>(smem + kRegionOffset);  // [H][S] scores, then p * vs
  float* ks_sm = s_sm + H * S;                                      // [H][S]
  float* vs_sm = ks_sm + H * S;                                     // [H][S]
  int8_t* pv_sm = reinterpret_cast<int8_t*>(vs_sm + H * S);         // [H][S]
  uint8_t* mask_sm = reinterpret_cast<uint8_t*>(pv_sm + H * S);     // [S]

  // owner (r, c): the 16 bytes at column 16c of the rows r, r + R, ... of a
  // K tile, and of the 4-key group 4r.. of a V tile (kt = 4R)
  const int r = tid / NS, c = tid % NS, h_own = c / kG;
  const bool owner = r < R;
  const int lo = split * S;
  const int n_seg = min(S, a.Lk - lo);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    mbar_init(scale_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  int g_tile = 0;   // ring tiles of earlier samples (stage and phase of the next)
  int n_waits = 0;  // scale loads of earlier samples (the scale barrier's phase)
  const uint64_t stream_policy = evict_first_policy();
  // the statistics of all splits fit where the key scales were
  const bool stage = 2 * n_split <= S;
  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    // q, the scales and the mask are requested before any key tile, so the
    // tiles' traffic does not hold them back. This head's q slice:
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = owner ? to_float(static_cast<const T*>(a.q)[b * a.q_bs + 16 * c + i]) : 0.f;
    // every head's scales of the split's keys, before the mask is known
    // (scales are not keys): H bulk rows each, or plain loads
    const int n4s = (n_seg + 3) / 4 * 4;
    if (a.scale_bulk) {
      if (tid == 0) {
        fence_proxy_async();  // the scales' rows held statistics
        mbar_expect_tx(scale_bar, 2 * H * n4s * 4);
        for (int h = 0; h < H; ++h) {
          const long long off = b * a.s_bs + h * a.s_hs + lo;
          bulk_load(smem_addr(ks_sm + h * S), a.ks + off, n4s * 4, scale_bar);
          bulk_load(smem_addr(vs_sm + h * S), a.vs + off, n4s * 4, scale_bar);
        }
      }
    } else {
      for (int i = tid; i < H * n_seg; i += kThreads) {
        const int h = i / n_seg, j = i % n_seg;
        const long long off = b * a.s_bs + h * a.s_hs + lo + j;
        ks_sm[h * S + j] = __ldg(a.ks + off);
        vs_sm[h * S + j] = __ldg(a.vs + off);
      }
    }
    // the split's mask: every load issued before any is used; the last
    // valid key bounds what is read
    const uint8_t* mrow = a.mask + b * a.m_bs + lo;
    int last = -1;
    for (int j0 = 0; j0 < n_seg; j0 += 4 * kThreads) {
      uint8_t mv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + tid + i * kThreads;
        mv[i] = j < n_seg ? mrow[j] : 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + tid + i * kThreads;
        if (j < n_seg) {
          mask_sm[j] = mv[i];
          if (mv[i]) last = j;
        }
      }
    }
    const int n_keys = block_max_int(last, red) + 1;  // keys [lo, lo + n_keys) are read
    const int nK = (n_keys + kt - 1) / kt;

    auto issue = [&](int i) {  // one thread: K tiles 0..nK-1, then V tiles 0..
      const bool is_v = i >= nK;
      const int t = is_v ? i - nK : i, st = (g_tile + i) % kStages;
      const uint32_t bytes = min(kt, n_keys - t * kt) * HD;
      const int8_t* src = (is_v ? a.v + b * a.v_bs : a.k + b * a.k_bs) + (long long)(lo + t * kt) * HD;
      mbar_expect_tx(full(st), bytes);
      bulk_load_hint(base + kRingOffset + st * kTileBytes, src, bytes, full(st), stream_policy);
    };
    if (tid == 0 && n_keys > 0) {
      fence_proxy_async();  // the ring held this block's partial sums
      for (int i = 0; i < kStages && i < nK; ++i) issue(i);
    }

    // q -> int8 words (the kG owners of a head share its absmax; idle
    // threads form whole idle groups)
    int qw[4] = {0, 0, 0, 0};
    float qs = 1.f;
    {
      float am = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) am = fmaxf(am, fabsf(x[i]));
#pragma unroll
      for (int s = kG / 2; s > 0; s >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, s));
      qs = q8_scale(am);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed |= (static_cast<uint32_t>(q8(x[4 * w + e], qs)) & 0xffu) << (8 * e);
        qw[w] = static_cast<int>(packed);
      }
    }
    if (a.scale_bulk) mbar_wait(scale_bar, n_waits & 1);
    n_waits += a.scale_bulk;
    __syncthreads();  // plain-loaded scales

    // scores of the split's keys, tile by tile; masked keys get -inf
    for (int t = 0; t < nK; ++t) {
      const int st = (g_tile + t) % kStages;
      mbar_wait(full(st), ((g_tile + t) / kStages) & 1);
      const unsigned char* tile = ring + st * kTileBytes;
      const int rows = min(kt, n_keys - t * kt);
      int dot[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = r + u * R;
        dot[u] = 0;
        if (owner && j < rows) {
          const int4 w = *reinterpret_cast<const int4*>(tile + j * HD + 16 * c);
          dot[u] = __dp4a(qw[0], w.x, dot[u]);
          dot[u] = __dp4a(qw[1], w.y, dot[u]);
          dot[u] = __dp4a(qw[2], w.z, dot[u]);
          dot[u] = __dp4a(qw[3], w.w, dot[u]);
        }
      }
#pragma unroll
      for (int sh = kG / 2; sh > 0; sh >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], sh);
      if (owner && c % kG == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = r + u * R, jl = t * kt + j;
          if (j < rows)
            s_sm[h_own * S + jl] =
                mask_sm[jl] ? (static_cast<float>(dot[u]) * qs) * (ks_sm[h_own * S + jl] * a.scale)
                            : kNegInf;
        }
      }
      __syncthreads();  // stage st is free, the tile's scores are written
      if (tid == 0 && t + kStages < nK) issue(t + kStages);
    }
    // K first, then V: the ring's first V tiles, and the rest of V into L2,
    // stream during the meetings; the V pass after them reads L2
    const int v0 = min(kStages, nK);
    if (tid == 0) {
      for (int t = 0; t < v0; ++t) issue(nK + t);
      for (int t = v0; t < nK; ++t)
        prefetch_l2(a.v + b * a.v_bs + (long long)(lo + t * kt) * HD, min(kt, n_keys - t * kt) * HD);
    }

    // each head's (max, sum of exp) over the split, a warp per head
    float* stat_b = a.stat + (long long)b * n_split * 3 * H;
    for (int h = warp; h < H; h += kWarps) {
      const float* sh = s_sm + h * S;
      float m = kNegInf;
      for (int j = lane; j < n_keys; j += 32) m = fmaxf(m, sh[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < n_keys; j += 32) l += expf(sh[j] - m);
      l = warp_sum(l);
      if (lane == 0) {
        publish(stat_b + (split * 3 + 0) * H + h, m);
        publish(stat_b + (split * 3 + 1) * H + h, l);
      }
    }

    // the head's softmax over all splits (every block merges the same pairs
    // in the same order), p * v_scale in place of the scores, its absmax;
    // the splits' pairs come to shared memory in one pass where they fit
    float* st_sm = ks_sm;  // [split][2][H]
    __syncthreads();  // the key scales are read
    if (stage) {
      gather_stats(st_sm, n_split * 2 * H,
                   [&](int i) { return stat_b + (i / (2 * H)) * 3 * H + i % (2 * H); });
      __syncthreads();
    }
    for (int h = warp; h < H; h += kWarps) {
      constexpr int kPer = kMaxSplits / 32;
      float ms[kPer], ls[kPer];
      float m = kNegInf;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int sp = lane + 32 * i;
        ms[i] = kNegInf;
        ls[i] = 0.f;
        if (sp < n_split) {
          const float* pm = stat_b + (sp * 3 + 0) * H + h;
          ms[i] = stage ? st_sm[(sp * 2 + 0) * H + h] : await_stat(pm, ld_relaxed(pm));
          ls[i] = stage ? st_sm[(sp * 2 + 1) * H + h] : await_stat(pm + H, ld_relaxed(pm + H));
        }
        m = fmaxf(m, ms[i]);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) l += ls[i] * expf(ms[i] - m);
      l = warp_sum(l);
      const bool dead = m <= kNegInf * 0.5f;
      const float l_div = (l == 0.f) ? 1.f : l;
      float* sh = s_sm + h * S;
      const float* vsh = vs_sm + h * S;
      float am = 0.f;
      for (int j = lane; j < n_keys; j += 32) {
        const float p = dead ? 0.f : expf(sh[j] - m) / l_div;
        const float pv = p * vsh[j];
        sh[j] = pv;
        am = fmaxf(am, fabsf(pv));
      }
      am = warp_max(am);
      if (lane == 0) publish(stat_b + (split * 3 + 2) * H + h, am);
    }
    __syncthreads();

    // ps from the exact max over the splits; pv_i8 (0 up to the last tile's
    // end); the last key with a non-zero pv_i8
    const int n_pad = nK * kt;
    if (stage) {
      gather_stats(st_sm, n_split * H, [&](int i) { return stat_b + (i / H) * 3 * H + 2 * H + i % H; });
      __syncthreads();
    }
    last = -1;
    for (int h = warp; h < H; h += kWarps) {
      float am = 0.f;
      for (int sp = lane; sp < n_split; sp += 32) {
        const float* pa = stat_b + (sp * 3 + 2) * H + h;
        am = fmaxf(am, stage ? st_sm[sp * H + h] : await_stat(pa, ld_relaxed(pa)));
      }
      const float ps = q8_scale(warp_max(am));
      if (lane == 0) ps_sm[h] = ps;
      const float* sh = s_sm + h * S;
      for (int j = lane; j < n_pad; j += 32) {
        const int x = j < n_keys ? q8(sh[j], ps) : 0;
        pv_sm[h * S + j] = static_cast<int8_t>(x);
        if (x != 0) last = j;
      }
    }
    const int n_v = block_max_int(last, red) + 1;
    const int nV = (n_v + kt - 1) / kt;

    // o partial = sum_j pv_i8[j] v_i8[j], 4 keys per __dp4a
    int acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0;
    for (int t = 0; t < nV; ++t) {
      const int i = nK + t, st = (g_tile + i) % kStages;
      mbar_wait(full(st), ((g_tile + i) / kStages) & 1);
      const unsigned char* tile = ring + st * kTileBytes;
      if (owner) {
        const int pw = *reinterpret_cast<const int*>(pv_sm + h_own * S + t * kt + 4 * r);
        if (pw != 0) {
          int4 w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[u] = *reinterpret_cast<const int4*>(tile + (4 * r + u) * HD + 16 * c);
          const int x[4][4] = {{w[0].x, w[0].y, w[0].z, w[0].w}, {w[1].x, w[1].y, w[1].z, w[1].w},
                               {w[2].x, w[2].y, w[2].z, w[2].w}, {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // word q: columns 4q..4q+3 of the 16
            // byte e of col[e'] = key e's value in column e'
            const uint32_t lo01 = __byte_perm(x[0][q], x[1][q], 0x5140);
            const uint32_t hi01 = __byte_perm(x[0][q], x[1][q], 0x7362);
            const uint32_t lo23 = __byte_perm(x[2][q], x[3][q], 0x5140);
            const uint32_t hi23 = __byte_perm(x[2][q], x[3][q], 0x7362);
            acc[4 * q + 0] = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x5410)), pw, acc[4 * q + 0]);
            acc[4 * q + 1] = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x7632)), pw, acc[4 * q + 1]);
            acc[4 * q + 2] = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x5410)), pw, acc[4 * q + 2]);
            acc[4 * q + 3] = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x7632)), pw, acc[4 * q + 3]);
          }
        }
      }
      __syncthreads();  // stage st is free
      if (tid == 0 && i + kStages < nK + nV) issue(i + kStages);
    }
    // V tiles issued before pv_i8 was known and not needed: wait them out
    // (the ring is written below)
    const int issued = nK + max(v0, nV);
    for (int i = nK + nV; i < issued; ++i)
      mbar_wait(full((g_tile + i) % kStages), ((g_tile + i) / kStages) & 1);
    g_tile += issued;

    // this split's int32 partial: the R key groups summed through the ring
    int* sred = reinterpret_cast<int*>(ring);
    if (owner) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<int4*>(sred + r * HD + 16 * c + 4 * q) =
            make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();
    int* part_b = a.part + (long long)b * n_split * HD;
    for (int col = tid; col < HD; col += kThreads) {
      int sum = 0;
      for (int rr = 0; rr < R; ++rr) sum += sred[rr * HD + col];
      part_b[split * HD + col] = sum;
    }
    __syncthreads();
    if (tid == 0) red[kWarps] = atomic_add_acq_rel(a.counters + b, 1);
    __syncthreads();
    if (red[kWarps] == n_split - 1) {
      // the sample's last split: o = (sum of the partials) * ps
      T* ob = static_cast<T*>(a.o) + (long long)b * HD;
      for (int col = 4 * tid; col < HD; col += 4 * kThreads) {
        int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll 8
        for (int sp = 0; sp < n_split; ++sp) {
          const int4 x = __ldcg(reinterpret_cast<const int4*>(part_b + sp * HD + col));
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        const float ps = ps_sm[col / D];
        store(ob + col, static_cast<float>(sum.x) * ps);
        store(ob + col + 1, static_cast<float>(sum.y) * ps);
        store(ob + col + 2, static_cast<float>(sum.z) * ps);
        store(ob + col + 3, static_cast<float>(sum.w) * ps);
      }
      // every split has read every statistic: ready for the next launch
      for (int i = tid; i < n_split * 3 * H; i += kThreads)
        reinterpret_cast<uint32_t*>(stat_b)[i] = kEmpty;
      if (tid == 0) a.counters[b] = 0;
    }
    __syncthreads();  // shared memory is reused by the next sample
  }
}

// The per-head kernel (the first port's): one block of 8 warps per (sample,
// head) keeps the head's whole score row in shared memory (Lk fp32 + Lk
// int8), so it needs no meeting. Where B * H blocks fill the card and rows
// are short it is faster than the split kernel, whose two meetings cost more
// than they save there (ops/decode_attention.py::decode_q8_by_heads):
// - q is quantized by one warp; each thread then takes keys j = tid,
//   tid + 256, ...: a masked key is not read, a valid one is one 16-byte
//   vector load per 16 bytes of its head row, dotted with __dp4a;
// - block reductions give the row max, the sum, the max of p * v_scale and
//   the last key with a non-zero pv_i8; p * v_scale is quantized in shared
//   memory;
// - p v: each thread owns a 16-byte column chunk of the head row and a
//   stripe of keys up to that last key, accumulates 16 int32 sums, and the
//   stripes are summed through shared memory.

// Block-wide max / sum; `red` holds kWarps floats. Every thread gets the result.
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attn_q8_head_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const uint8_t* __restrict__ mask, T* __restrict__ o, int H, int Lk, long long q_bs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs, long long s_bs, long long s_hs,
    long long m_bs, float scale) {
  constexpr int kChunks = D / 16;                 // 16-byte chunks of a head row
  constexpr int kStripes = kThreads / kChunks;    // key stripes in p v
  extern __shared__ __align__(16) unsigned char smem[];
  int* red_i = reinterpret_cast<int*>(smem);     // kStripes x D int32 partial sums
  float* s_row = reinterpret_cast<float*>(red_i + kStripes * D);  // Lk scores, then p * vs
  int8_t* pv_row = reinterpret_cast<int8_t*>(s_row + Lk);
  __shared__ float red[kWarps];
  __shared__ __align__(16) int8_t q_i8[D];
  __shared__ float q_scale;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* ks = k_scale + b * s_bs + h * s_hs;
  const float* vs = v_scale + b * s_bs + h * s_hs;
  const uint8_t* mrow = mask + b * m_bs;

  // q of this head -> int8 (one warp)
  if (tid < 32) {
    constexpr int kPer = D / 32;
    float x[kPer];
    float am = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      x[i] = to_float(q[(long long)b * q_bs + h * D + tid * kPer + i]);
      am = fmaxf(am, fabsf(x[i]));
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, s));
    const float qs = q8_scale(am);
#pragma unroll
    for (int i = 0; i < kPer; ++i) q_i8[tid * kPer + i] = static_cast<int8_t>(q8(x[i], qs));
    if (tid == 0) q_scale = qs;
  }
  __syncthreads();
  int qw[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) qw[i] = reinterpret_cast<const int*>(q_i8)[i];
  const float qs = q_scale;

  // scores; masked keys are not read. kKeys keys per pass, their loads
  // issued together (8 vector loads in flight per thread).
  constexpr int kKeys = kChunks >= 8 ? 1 : 8 / kChunks;
  const int8_t* kb = k + b * k_bs + h * D;
  float m = kNegInf;
  for (int j0 = tid; j0 < Lk; j0 += kKeys * kThreads) {
    int4 w[kKeys][kChunks];
    bool live[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int j = j0 + u * kThreads;
      live[u] = j < Lk && mrow[j];
      if (live[u]) {
        const int4* kr = reinterpret_cast<const int4*>(kb + j * k_rs);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) w[u][c] = kr[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= Lk) break;
      float x = kNegInf;
      if (live[u]) {
        int dot = 0;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          dot = __dp4a(qw[4 * c + 0], w[u][c].x, dot);
          dot = __dp4a(qw[4 * c + 1], w[u][c].y, dot);
          dot = __dp4a(qw[4 * c + 2], w[u][c].z, dot);
          dot = __dp4a(qw[4 * c + 3], w[u][c].w, dot);
        }
        x = (static_cast<float>(dot) * qs) * (ks[j] * scale);
      }
      s_row[j] = x;
      m = fmaxf(m, x);
    }
  }
  m = block_max(m, red);
  const bool dead = m <= kNegInf * 0.5f;

  float l = 0.f;
  for (int j = tid; j < Lk; j += kThreads) {
    const float e = expf(s_row[j] - m);
    s_row[j] = e;
    l += e;
  }
  l = block_sum(l, red);
  const float l_div = (l == 0.f) ? 1.f : l;

  // p * v_scale, its row absmax, then int8 over the row
  float am = 0.f;
  for (int j = tid; j < Lk; j += kThreads) {
    const float p = dead ? 0.f : s_row[j] / l_div;
    const float pv = p * vs[j];
    s_row[j] = pv;
    am = fmaxf(am, fabsf(pv));
  }
  const float ps = q8_scale(block_max(am, red));
  int last = -1;  // the last key whose pv_i8 is not 0
  for (int j = tid; j < Lk; j += kThreads) {
    const int x = q8(s_row[j], ps);
    pv_row[j] = static_cast<int8_t>(x);
    if (x != 0) last = j;
  }
  const int n_keys = static_cast<int>(block_max(static_cast<float>(last), red)) + 1;

  // o = sum_j pv_i8[j] v_i8[j]: thread = (stripe, 16-byte chunk)
  const int chunk = tid % kChunks, stripe = tid / kChunks;
  int acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  const int8_t* vb = v + b * v_bs + h * D + chunk * 16;
  constexpr int kRows = 8;  // rows per pass, their loads issued together
  for (int j0 = stripe; j0 < n_keys; j0 += kRows * kStripes) {
    int4 w[kRows];
    int p[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = j0 + u * kStripes;
      p[u] = j < n_keys ? pv_row[j] : 0;
      if (p[u] != 0) w[u] = *reinterpret_cast<const int4*>(vb + j * v_rs);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (p[u] == 0) continue;
      const int words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * i + e] += p[u] * static_cast<int>(static_cast<int8_t>(words[i] >> (8 * e)));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) red_i[stripe * D + chunk * 16 + i] = acc[i];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    int sum = 0;
    for (int r = 0; r < kStripes; ++r) sum += red_i[r * D + d];
    store(o + ((long long)b * H + h) * D + d, static_cast<float>(sum) * ps);
  }
}

template <typename T, int D>
int launch_heads(const Q8Args& a, cudaStream_t stream) {
  constexpr int kStripes = kThreads / (D / 16);
  const size_t smem = (size_t)kStripes * D * sizeof(int) + (size_t)a.Lk * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_q8_head_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attn_q8_head_kernel<T, D><<<dim3(a.H, a.B), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.k, a.v, a.ks, a.vs, a.mask, static_cast<T*>(a.o), a.H, a.Lk,
      a.q_bs, a.k_bs, (long long)a.H * D, a.v_bs, (long long)a.H * D, a.s_bs, a.s_hs, a.m_bs,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
cudaError_t prepare() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(decode_attn_q8_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_attn_q8_kernel<T, D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

template <typename T, int D>
int launch(const Q8Args& a, int slots, int by_heads, cudaStream_t stream) {
  const int HD = a.H * D;
  if (by_heads) return HD > kMaxRowBytes ? static_cast<int>(cudaErrorInvalidValue)
                                         : launch_heads<T, D>(a, stream);
  if (HD > kMaxRowBytes || a.H > kMaxHeads || a.kt != 4 * (kThreads / (HD / 16)) ||
      a.split_keys % a.kt || (long long)a.n_split * a.split_keys < a.Lk ||
      (long long)(a.n_split - 1) * a.split_keys >= a.Lk || a.n_split > kMaxSplits ||
      (13LL * a.H + 1) * a.split_keys > kRegionBytes || slots <= 0 || slots > a.B)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<Q8Args*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decode_attn_q8_kernel<T, D>), dim3(a.n_split, slots),
      dim3(kThreads), args, kSmemBytes, stream));
}

template <typename T, int D>
int blocks_per_sm() {
  if (prepare<T, D>() != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_attn_q8_kernel<T, D>, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16. q is (B, 1, H*D) with batch
// stride q_bs; k/v are int8 (B, Lk, H*D) with contiguous H*D-byte rows and
// batch strides k_bs / v_bs (16-byte aligned); k_scale/v_scale are fp32
// (B, >=H, Lk) with batch/head strides s_bs / s_hs and contiguous rows (both
// share them); scale_bulk = 1 when those rows may be bulk-copied (both bases
// 16-byte aligned, s_bs, s_hs and Lk multiples of 4); mask is (B, Lk) uint8
// (bool) with batch stride m_bs; o is a contiguous (B, 1, H*D) tensor of q's
// dtype. by_heads = 1 launches the per-head kernel (a block per (sample,
// head); part, stat, counters and the plan are not read). Else the plan
// (ops/decode_attention.py::decode_plan_q8): tiles of kt keys, n_split splits
// of split_keys keys cover Lk, `slots` samples at once (n_split * slots
// blocks, co-resident). part holds B * n_split * H*D int32
// and stat B * n_split * 3 * H floats that hold 0xffffffff; counters B ints
// that are 0 (the launch leaves both so: launches that share them must not
// overlap). Strides in elements. Returns the CUDA error code of the launch.
extern "C" int pixparse_decode_attn_q8_fwd(int dtype, const void* q, const void* k, const void* v,
                                           const void* k_scale, const void* v_scale,
                                           const void* mask, void* o, void* part, void* stat,
                                           void* counters, int B, int H, int Lk, int D,
                                           long long q_bs, long long k_bs, long long v_bs,
                                           long long s_bs, long long s_hs, long long m_bs,
                                           int scale_bulk, int kt, int split_keys, int n_split,
                                           int slots, int by_heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lk <= 0 || (!by_heads && (kt <= 0 || split_keys <= 0 || n_split <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Q8Args a;
  a.q = q;
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = o;
  a.part = static_cast<int*>(part);
  a.stat = static_cast<float*>(stat);
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.H = H;
  a.Lk = Lk;
  a.kt = kt;
  a.split_keys = split_keys;
  a.n_split = n_split;
  a.scale_bulk = scale_bulk;
  a.q_bs = q_bs;
  a.k_bs = k_bs;
  a.v_bs = v_bs;
  a.s_bs = s_bs;
  a.s_hs = s_hs;
  a.m_bs = m_bs;
  a.scale = scale;
  if (dtype == 1) {
    switch (D) {
      case 32: return launch<__nv_bfloat16, 32>(a, slots, by_heads, s);
      case 64: return launch<__nv_bfloat16, 64>(a, slots, by_heads, s);
      case 128: return launch<__nv_bfloat16, 128>(a, slots, by_heads, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32>(a, slots, by_heads, s);
      case 64: return launch<float, 64>(a, slots, by_heads, s);
      case 128: return launch<float, 128>(a, slots, by_heads, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel for (dtype, D) that one SM holds at once (its
// registers and fixed shared memory); 0 on error.
extern "C" int pixparse_decode_attn_q8_blocks_per_sm(int dtype, int D) {
  if (dtype == 1) {
    switch (D) {
      case 32: return blocks_per_sm<__nv_bfloat16, 32>();
      case 64: return blocks_per_sm<__nv_bfloat16, 64>();
      case 128: return blocks_per_sm<__nv_bfloat16, 128>();
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return blocks_per_sm<float, 32>();
      case 64: return blocks_per_sm<float, 64>();
      case 128: return blocks_per_sm<float, 128>();
    }
  }
  return 0;
}
