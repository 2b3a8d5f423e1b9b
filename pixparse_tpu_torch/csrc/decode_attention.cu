// Single-token decode attention over flat (B, Lk, H*D) KV caches for Hopper
// (sm_90a), bound through a plain C entry point (ctypes; see
// pixparse_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel
//   pixparse_tpu/ops/decode_attention.py::_decode_attn_kernel
// : one query per sample attends over its key/value cache for all heads,
// with a per-key validity mask (> 0 = attend); fully masked rows give zeros.
//
// What bounds it on an H100: a decode step does ~4 FLOP per cache element
// (2 for q.k, 2 for p.v) against 2 bytes read for it, so it is bound by the
// bytes of K and V it streams from device memory (3.35 TB/s): 157 MB for a
// donut_base cross cache at B=8 (47 us), 50.3 MB for cruller_base's at B=16.
// Streaming at that rate needs tens of KB in flight on every SM at once.
//
// What the design does about it:
// - a block owns one (sample, key split) across all H heads, so a key tile
//   is whole contiguous H*D rows of the cache. One thread keeps the tiles of
//   K and V in flight by 1-D bulk copies (TMA, no tensor map) through a
//   3-stage mbarrier ring of ~16 KB per operand and stage; at two blocks per
//   SM that is up to ~190 KB in flight per SM. The splits (plan in
//   ops/decode_attention.py::decode_plan) give about two blocks per SM;
//   the key tile holds ~16 KB (8 keys at H*D = 1024);
// - the mask gates no load: a block reads its split's mask bytes into
//   shared memory first (every load issued before any is used), and keys
//   at or past the split's last valid key are never read, so the self cache
//   is read only up to the tokens written. Masked keys before it come with
//   their tile and are dropped as -inf;
// - scores and p.v run in fp32 from shared memory, three steps a tile: each
//   thread owns 8 (bf16) columns of one head and a share of the tile's
//   keys, with its slice of q in registers; the D/8 owners of a head sum
//   their parts of a key's dot by shuffles; one thread per (key, head)
//   takes the head's tile max and its one exp2; the owners then scale and
//   add p.v (and sum p) for their columns;
// - each split writes (acc, max, sum) partials; the sample's last split to
//   finish (a counter per sample) merges them in split order, so a repeat
//   gives the same bits, and the merge overlaps other samples' streaming
//   instead of waiting for a second launch.
// Unlike the TPU kernel, p is not rounded to the cache dtype before p.v
// (it is kept in fp32); the difference is within the bf16 tolerance. fp32
// caches take the same kernel (parity, not speed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace pixparse;
using namespace pixparse::hopper;

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMaxWidthBytes = 4096;  // H*D*elt: one thread owns at most 16 bytes of a row
constexpr int kMaxSplitKeys = 8192;   // a split's mask bytes in shared memory
constexpr int kMaskUnroll = 4;
constexpr int kBatch = 4;  // keys whose dots a thread reduces together

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
  __device__ __forceinline__ static float to_t(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf16_lo(w[i]);
      out[2 * i + 1] = bf16_hi(w[i]);
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 to_t(float x) { return __float2bfloat16(x); }
};

// atomicAdd at device scope with release and acquire semantics: one round
// trip, where fences on either side would take three.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  void* o;
  float* work;    // (B, n_split, H*D) acc, then (B, n_split, 2, H) max and sum
  int* counters;  // (B,): splits done per sample; 0 before and after a launch
  int H, Lk, kt, split_keys, n_split;
  long long q_bs, k_bs, v_bs, m_bs;
  float scale_log2;
};

// Dynamic shared memory, in bytes from a 128-aligned base: the mbarriers,
// the ring of K and V tiles (after the loop: the p.v key groups' sums of
// acc and of p, at most kThreads x (16 + 1) values in fp32, then the
// merge's scratch), the tile's scores and probabilities (kt x H each), the
// running max per head (two buffers, by tile parity) and alpha, the
// split's mask.
struct Smem {
  int tile, stages, sc, sp, stat, mask, total;
  __host__ __device__ Smem(int kt, int HD, int H, int split_keys, int elt) {
    tile = kt * HD * elt;
    stages = 128;
    const int ring = kStages * 2 * tile, sums = kThreads * (16 / elt + 1) * 4;
    sc = stages + (ring > sums ? ring : sums);
    sp = sc + kt * H * 4;
    stat = sp + kt * H * 4;
    mask = stat + 3 * H * 4;
    total = (mask + split_keys + 15) / 16 * 16;
  }
};

// o[b] from the n = n_split partials of sample b (one block; `buf` is
// shared memory for 2 x n x H + H floats): each partial's max and sum per
// head staged in shared memory, the heads' max and rescaled sums in
// partial order, then 4 columns a thread. The loads of a thread's first
// kPrefetch partials are issued before the stats are read, so up to
// kPrefetch partials cost one round trip to L2; the rest go 16 at a time.
constexpr int kPrefetch = 16;

template <typename T, int D>
__device__ __forceinline__ void merge_splits(const DecodeArgs& a, int b, float* buf) {
  const int H = a.H, HD = H * D, n = a.n_split, tid = threadIdx.x;
  const float* acc = a.work + (long long)b * n * HD;
  const float* stat = a.work + ((long long)gridDim.y * HD + (long long)b * 2 * H) * n;
  auto part4 = [&](int sp, int d) {
    return __ldcg(reinterpret_cast<const float4*>(acc + (long long)sp * HD + d));
  };
  float4 pre[kPrefetch];
  if (tid * 4 < HD) {
#pragma unroll
    for (int sp = 0; sp < kPrefetch; ++sp)
      if (sp < n) pre[sp] = part4(sp, tid * 4);
  }
  float* sc = buf;          // [n][H]: max, then its scale
  float* sls = sc + n * H;  // [n][H]: sum
  float* lsum = sls + n * H;
#pragma unroll 4
  for (int i = tid; i < n * H; i += kThreads) {
    const int sp = i / H, h = i % H;
    sc[i] = __ldcg(stat + sp * 2 * H + h);
    sls[i] = __ldcg(stat + sp * 2 * H + H + h);
  }
  __syncthreads();
  for (int h = tid; h < H; h += kThreads) {
    float m = -INFINITY;
#pragma unroll 8
    for (int sp = 0; sp < n; ++sp) m = fmaxf(m, sc[sp * H + h]);
    const float m_use = (m == -INFINITY) ? 0.f : m;
    float l = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n; ++sp) {
      const float c = exp2f(sc[sp * H + h] - m_use);
      sc[sp * H + h] = c;
      l = fmaf(sls[sp * H + h], c, l);
    }
    lsum[h] = l;
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.o) + (long long)b * HD;
  for (int d = tid * 4; d < HD; d += kThreads * 4) {
    const int h = d / D;
    const bool first = d == tid * 4;  // this thread's prefetched columns
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& x, int sp) {
      const float c = sc[sp * H + h];
      sum.x = fmaf(x.x, c, sum.x);
      sum.y = fmaf(x.y, c, sum.y);
      sum.z = fmaf(x.z, c, sum.z);
      sum.w = fmaf(x.w, c, sum.w);
    };
    int sp = 0;
    if (first) {
#pragma unroll
      for (; sp < kPrefetch; ++sp)
        if (sp < n) add(pre[sp], sp);
      sp = kPrefetch;
    }
#pragma unroll 16
    for (; sp < n; ++sp) add(part4(sp, d), sp);
    const float inv = lsum[h] > 0.f ? 1.f / lsum[h] : 0.f;
    ob[d] = Vec16<T>::to_t(sum.x * inv);
    ob[d + 1] = Vec16<T>::to_t(sum.y * inv);
    ob[d + 2] = Vec16<T>::to_t(sum.z * inv);
    ob[d + 3] = Vec16<T>::to_t(sum.w * inv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) decode_attn_split_kernel(const DecodeArgs a) {
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kLanes = D / kVec;  // lanes that share one (key, head) dot
  const int split = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = a.H, HD = H * D, kt = a.kt;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(kt, HD, H, a.split_keys, sizeof(T));
  const uint32_t base = smem_addr(smem);
  auto full = [&](int s) { return base + 8 * s; };
  auto tile_k = [&](int s) { return L.stages + s * 2 * L.tile; };
  float* ssc = reinterpret_cast<float*>(smem + L.sc);
  float* sp = reinterpret_cast<float*>(smem + L.sp);
  float* sm = reinterpret_cast<float*>(smem + L.stat);  // [2][H]: by tile parity
  float* salpha = sm + 2 * H;
  uint8_t* smask = smem + L.mask;
  __shared__ int s_last[kThreads / 32];

  const int lo = split * a.split_keys;
  const int n_seg = min(a.split_keys, a.Lk - lo);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + (long long)lo * HD;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + (long long)lo * HD;

  // the split's mask: every load issued before any is used; the last valid
  // key bounds what is read
  const uint8_t* mrow = a.mask + b * a.m_bs + lo;
  int last = -1;
  for (int j0 = 0; j0 < n_seg; j0 += kThreads * kMaskUnroll) {
    uint8_t mv[kMaskUnroll];
#pragma unroll
    for (int i = 0; i < kMaskUnroll; ++i) {
      const int j = j0 + tid + i * kThreads;
      mv[i] = j < n_seg ? mrow[j] : 0;
    }
#pragma unroll
    for (int i = 0; i < kMaskUnroll; ++i) {
      const int j = j0 + tid + i * kThreads;
      if (j < n_seg) {
        smask[j] = mv[i];
        if (mv[i]) last = j;
      }
    }
  }
  // Each thread owns kVec columns c0.. of head hc and takes keys r, r + R,
  // ... of every tile, for the scores and for p.v; its q slice sits in
  // registers, pre-scaled into the exp2 domain. Each owner also sums its
  // keys' p (the head's first columns keep it).
  const int NS = HD / kVec, R = kThreads / NS;
  const int r = tid / NS, c0 = (tid % NS) * kVec, hc = c0 / D;
  const bool owner = r < R;
  float qf[kVec], acc[kVec], psum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) qf[i] = acc[i] = 0.f;
  if (owner) {
    Vec16<T>::load(static_cast<const T*>(a.q) + b * a.q_bs + c0, qf);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qf[i] *= a.scale_log2;
  }
  for (int h = tid; h < H; h += kThreads) sm[h] = -INFINITY;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    fence_barrier_init();
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, s));
  if (tid % 32 == 0) s_last[tid / 32] = last;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) last = max(last, s_last[w]);
  const int n_keys = last + 1;  // keys [lo, lo + n_keys) are read
  const int n_tiles = (n_keys + kt - 1) / kt;

  auto issue = [&](int t) {  // one thread: tile t of K and V into stage t % kStages
    const int s = t % kStages;
    const uint32_t bytes = min(kt, n_keys - t * kt) * HD * (int)sizeof(T);
    const long long off = (long long)t * kt * HD;
    mbar_expect_tx(full(s), 2 * bytes);
    bulk_load(base + tile_k(s), kb + off, bytes, full(s));
    bulk_load(base + tile_k(s) + L.tile, vb + off, bytes, full(s));
  };
  if (tid == 0)
    for (int t = 0; t < kStages && t < n_tiles; ++t) issue(t);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int rows = min(kt, n_keys - t * kt), j0 = t * kt;
    const T* tk = reinterpret_cast<const T*>(smem + tile_k(s));
    const T* tv = reinterpret_cast<const T*>(smem + tile_k(s) + L.tile);
    mbar_wait(full(s), (t / kStages) & 1);

    // scores: the kLanes owners of a head's columns sum their parts of a
    // key's dot, kBatch keys at a time (loads, products and shuffles of
    // the batch overlap); the trip count is block-uniform, so the shuffles
    // stay converged
    const int n_iter = (rows + R - 1) / R;
    for (int jj0 = 0; jj0 < n_iter; jj0 += kBatch) {
      float dot[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = r + (jj0 + u) * R;
        dot[u] = 0.f;
        if (owner && j < rows) {
          float kf[kVec];
          Vec16<T>::load(tk + j * HD + c0, kf);
#pragma unroll
          for (int i = 0; i < kVec; ++i) dot[u] = fmaf(qf[i], kf[i], dot[u]);
        }
      }
#pragma unroll
      for (int sh = kLanes / 2; sh > 0; sh >>= 1)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], sh);
      if (c0 % D == 0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = r + (jj0 + u) * R;
          if (owner && j < rows) ssc[j * H + hc] = smask[j0 + j] ? dot[u] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one thread per (key, head) pair (rows * H <= kThreads):
    // its head's tile max, then its one exp2; the key-0 threads move the
    // head's running max and give the old state's scale
    if (tid < rows * H) {
      const int h = tid % H;
      float mt = -INFINITY;
#pragma unroll 8
      for (int j = 0; j < rows; ++j) mt = fmaxf(mt, ssc[j * H + h]);
      const float m_old = sm[(t & 1) * H + h], m_new = fmaxf(m_old, mt);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      sp[tid] = exp2f(ssc[tid] - m_use);
      if (tid < H) {
        sm[((t + 1) & 1) * H + h] = m_new;
        salpha[h] = exp2f(m_old - m_use);
      }
    }
    __syncthreads();

    if (owner) {
      const float alpha = salpha[hc];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] *= alpha;
      psum *= alpha;
#pragma unroll 4
      for (int j = r; j < rows; j += R) {
        const float p = sp[j * H + hc];
        psum += p;
        float vf[kVec];
        Vec16<T>::load(tv + j * HD + c0, vf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
    }
    __syncthreads();  // stage s and the scores are free again
    if (tid == 0 && t + kStages < n_tiles) issue(t + kStages);
  }

  // this split's partial: the R key groups summed in order (the ring's
  // memory is free now)
  float* sred = reinterpret_cast<float*>(smem + L.stages);
  float* spsum = sred + R * HD;
  if (owner) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) sred[r * HD + c0 + i] = acc[i];
    if (c0 % D == 0) spsum[r * H + hc] = psum;
  }
  __syncthreads();
  const long long part = (long long)b * a.n_split + split;
  float* out = a.work + part * HD;
  float* stat = a.work + (long long)gridDim.y * a.n_split * HD + part * 2 * H;
  for (int d = tid; d < HD; d += kThreads) {
    float sum = 0.f;
    for (int rr = 0; rr < R; ++rr) sum += sred[rr * HD + d];
    out[d] = sum;
  }
  for (int h = tid; h < H; h += kThreads) {
    float sum = 0.f;
    for (int rr = 0; rr < R; ++rr) sum += spsum[rr * H + h];
    stat[h] = sm[(n_tiles & 1) * H + h];
    stat[H + h] = sum;
  }

  // the sample's last split to finish merges all its partials, in split
  // order whichever block that is, while other samples still stream
  __shared__ int s_ticket;
  __syncthreads();
  // release: the block's partial (ordered before by the barrier) before the
  // count; acquire: the other splits' partials before the merge reads them
  if (tid == 0) s_ticket = atomic_add_acq_rel(a.counters + b, 1);
  __syncthreads();
  if (s_ticket != a.n_split - 1) return;
  merge_splits<T, D>(a, b, reinterpret_cast<float*>(smem + L.stages));
  if (tid == 0) a.counters[b] = 0;  // ready for the next launch
}

// The split kernel's shared-memory attributes, set once per device and
// raised only when a launch needs more (a call costs host time on every
// decode step otherwise). Two blocks share an SM only if it keeps the most
// shared memory.
template <typename T, int D>
cudaError_t prepare(int smem) {
  constexpr int kDevices = 64;
  static int set_to[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && set_to[dev] >= smem)) return err;
  err = cudaFuncSetAttribute(decode_attn_split_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_attn_split_kernel<T, D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kDevices) set_to[dev] = smem;
  return err;
}

template <typename T, int D>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int HD = a.H * D;
  const Smem L(a.kt, HD, a.H, a.split_keys, sizeof(T));
  if (HD * (int)sizeof(T) > kMaxWidthBytes || a.split_keys > kMaxSplitKeys ||
      a.kt * a.H > kThreads || (long long)a.n_split * a.split_keys < a.Lk ||
      (2 * a.n_split + 1) * a.H * 4 > L.sc - L.stages)  // the merge fits the ring
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare<T, D>(L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_split_kernel<T, D><<<dim3(a.n_split, B), kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is (B, 1, H*D) with batch stride
// q_bs; k/v are (B, Lk, H*D) with contiguous rows (row stride H*D) and
// batch strides k_bs / v_bs; mask is (B, Lk) uint8 (bool) with batch
// stride m_bs; o is a contiguous (B, 1, H*D) tensor of the q dtype. The
// plan: tiles of kt keys, splits of split_keys keys (n_split of them
// cover Lk). work holds B * n_split * (H*D + 2H) floats, 16-byte aligned;
// counters B ints that are 0 (the launch leaves them 0: launches that
// share them must not overlap). q, k, v 16-byte aligned, strides in
// elements. Returns the CUDA error code of the launch (0 = success).
extern "C" int pixparse_decode_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                                        const void* mask, void* o, void* work, void* counters,
                                        int B, int H, int Lk, int D, long long q_bs,
                                        long long k_bs, long long v_bs, long long m_bs, int kt,
                                        int split_keys, int n_split, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lk < 0 || kt <= 0 || split_keys <= 0 || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = o;
  a.work = static_cast<float*>(work);
  a.counters = static_cast<int*>(counters);
  a.H = H;
  a.Lk = Lk;
  a.kt = kt;
  a.split_keys = split_keys;
  a.n_split = n_split;
  a.q_bs = q_bs;
  a.k_bs = k_bs;
  a.v_bs = v_bs;
  a.m_bs = m_bs;
  a.scale_log2 = scale * kLog2e;
  if (dtype == 1) {
    switch (D) {
      case 32: return launch<__nv_bfloat16, 32>(a, B, s);
      case 64: return launch<__nv_bfloat16, 64>(a, B, s);
      case 128: return launch<__nv_bfloat16, 128>(a, B, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32>(a, B, s);
      case 64: return launch<float, 64>(a, B, s);
      case 128: return launch<float, 128>(a, B, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
