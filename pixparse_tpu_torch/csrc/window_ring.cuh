// What the Swin window-attention forward (window_attention.cu, kernel #14)
// and backward (window_attention_bwd.cu, kernel #15) share on Hopper: the
// plan's runs of work, the shared-memory ring and the warps that feed it,
// fragments of swizzled tiles, and the score step (s = q k^T, scale, bias,
// mask, softmax) that both recompute per window.
//
// Work (plan in ops/window_attention.py::window_plan). An item is one
// (window position w, image b) pair of one head h, window b * period + w.
// A head's n = period * n_images items are taken w-major (item i = w *
// n_images + b) and cut into `runs` runs of n / runs items (sizes differ by
// at most one); block x = r * H + h owns run r of head h. The grid is one
// wave of persistent blocks, and all heads' run r cover the same window
// positions at the same time, so each mask row comes from device memory
// about once and the heads of a window share its rows' cache lines.
//
// Ring. One producer thread issues every copy:
// - bias[h] (an N x N fp32 table, rows `ldb` apart) by one bulk copy at the
//   start of the run, kept for the whole run;
// - with a mask, mask[w] by one bulk copy into one of `slots` mask slots
//   as soon as a slot is free (the consumers release a slot once no item of
//   theirs needs it); bias[h] is added into each slot once it lands, so the
//   scores read one table, bias + mask. Adding bias and mask first differs
//   from the TPU kernel's order (s + bias, then + mask) by at most one fp32
//   rounding of a logit, and not at all for Swin's 0 / -1e9 masks. The
//   forward adds in a combiner warp of its own: with two images a window
//   position, adds by the producer's warp held back the tile loads (0.55
//   against 0.45 ms at donut stage 0, B = 2; equal at B = 8). The backward,
//   at 249 registers a thread, has no room for another warp: its producer
//   warp adds between its copies;
// - the window's q/k/v(/do) tiles (npad rows of D bf16, rows past ww zero-
//   filled by the tensor map's bound) by TMA into one of `stages` stages.
// Every copy completes on an mbarrier; consumers wait on the barrier of
// what they read (a mask slot's `ready` barrier: the sum is written) and
// arrive on its `empty` barrier when done. No block-wide barrier follows a
// load, and no copy waits behind the combiner.
//
// Tiles are stored as TMA writes them with the swizzle whose span is one
// row (2 * D bytes: 32, 64 or 128 B): the 16-byte chunk c of row r lies at
// chunk c ^ ((r * 2D / 128) mod (2D / 16)) of its 128-byte line, so the
// eight rows an ldmatrix reads at one column hit eight different banks.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace pixparse {
namespace window {

using namespace pixparse::hopper;

constexpr int kMaxTokens = 144;  // window 12

// ---------------------------------------------------------------------------
// the plan
// ---------------------------------------------------------------------------

struct Run {
  int h, r, begin, end;  // items [begin, end) of head h
};

__device__ __forceinline__ Run block_run(int H, int runs, int n_items) {
  Run run;
  run.h = blockIdx.x % H;
  run.r = blockIdx.x / H;
  run.begin = static_cast<int>(static_cast<long long>(run.r) * n_items / runs);
  run.end = static_cast<int>(static_cast<long long>(run.r + 1) * n_items / runs);
  return run;
}

// ---------------------------------------------------------------------------
// swizzled bf16 tiles and their mma.sync fragments
// ---------------------------------------------------------------------------

template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64, "head dim");
  static constexpr int kRowBytes = 2 * D;  // = the swizzle span
  static constexpr uint32_t kSwz = kRowBytes / 16 - 1;
  // shared address of (row r, column c), c a multiple of 8; `tile` is
  // 1024-byte aligned
  __device__ __forceinline__ static uint32_t at(uint32_t tile, int r, int c) {
    const uint32_t off = static_cast<uint32_t>(r * kRowBytes + c * 2);
    return tile + (off ^ (((off >> 7) & kSwz) << 4));
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The inverse of ldmatrix.x4: register i of every lane (row g, columns
// 2t..2t+1 of matrix i, as an A fragment packs them) to shared memory; lane
// l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// A fragment of the 16 x 16 block at (row0, col0) (as mma_tiles.cuh's
// load_a_frag, on a swizzled tile).
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], uint32_t tile, int row0, int col0,
                                       int lane) {
  ldsm_x4(a, Tile<D>::at(tile, row0 + (lane & 7) + ((lane >> 3) & 1) * 8, col0 + (lane >> 4) * 8));
}

// B fragments of two neighbouring n-tiles from a tile stored [n][k] (as
// load_b_frag_nk): the product contracts over the tile's columns.
template <int D>
__device__ __forceinline__ void b_frag_nk(uint32_t (&b)[4], uint32_t tile, int n0, int k0,
                                          int lane) {
  ldsm_x4(b, Tile<D>::at(tile, n0 + (lane & 7) + (lane >> 4) * 8, k0 + ((lane >> 3) & 1) * 8));
}

// B fragments of two neighbouring n-tiles from a tile stored [k][n] (as
// load_b_frag_kn): the product contracts over the tile's rows.
template <int D>
__device__ __forceinline__ void b_frag_kn(uint32_t (&b)[4], uint32_t tile, int k0, int n0,
                                          int lane) {
  ldsm_x4_t(b, Tile<D>::at(tile, k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8));
}

// ---------------------------------------------------------------------------
// the ring's shared-memory layout (computed on the host, passed by value)
// ---------------------------------------------------------------------------

struct RingLayout {
  int stages;       // tile stages
  int slots;        // mask slots (0: no mask, or tables read from device memory)
  int bias_smem;    // 1: bias[h] in shared memory for the run
  int box_bytes;    // one tile as TMA writes it: npad rows of D bf16
  int tile_bytes;   // its place in a stage (1024-byte aligned)
  int table_bytes;  // one bias or mask table: nn fp32
  int bias_off, slot_off, stage_off, extra_off, bar_off;  // from the 1024-aligned base
  int smem;         // dynamic shared memory to ask for (with the alignment slack)
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// `tiles` tiles a stage; `extra` bytes of the kernel's own (the backward's
// p and ds tiles).
inline RingLayout ring_layout(int tiles, int npad, int D, int nn, int stages, int slots,
                              bool bias_smem, int extra) {
  RingLayout L;
  L.stages = stages;
  L.slots = slots;
  L.bias_smem = bias_smem ? 1 : 0;
  L.box_bytes = npad * D * 2;
  L.tile_bytes = round_up(L.box_bytes, 1024);
  L.table_bytes = nn * 4;
  int off = 0;
  L.stage_off = off;
  off += stages * tiles * L.tile_bytes;
  L.bias_off = off;
  off += bias_smem ? L.table_bytes : 0;
  L.slot_off = off;
  off += slots * L.table_bytes;
  L.extra_off = round_up(off, 16);
  off = L.extra_off + extra;
  L.bar_off = round_up(off, 8);
  off = L.bar_off + 8 * (2 * stages + 3 * slots + 1);
  L.smem = off + 1024;
  return L;
}

// The deepest ring that fits in `max_smem`. With tables in shared memory
// (tables_smem), bias[h] and: without a mask up to `max_stages` stages;
// with one, by preference up to `max_stages` stages with two mask slots
// (one read while the next loads), then two stages with one slot, then one
// stage. Without (tables read from device memory) only the stages count.
// Returns false if not even one stage fits.
inline bool choose_ring(RingLayout* out, int tiles, int npad, int D, int nn, bool has_mask,
                        bool tables_smem, int extra, int max_stages, int max_smem) {
  struct Try {
    int stages, slots;
  };
  Try tries[12];
  int n = 0;
  if (tables_smem && has_mask) {
    for (int s = max_stages; s >= 2; --s) tries[n++] = {s, 2};
    tries[n++] = {2, 1};
    tries[n++] = {1, 2};
    tries[n++] = {1, 1};
  } else {
    for (int s = max_stages; s >= 1; --s) tries[n++] = {s, 0};
  }
  const bool bias_smem = tables_smem;
  for (int i = 0; i < n; ++i) {
    const RingLayout L =
        ring_layout(tiles, npad, D, nn, tries[i].stages, tries[i].slots, bias_smem, extra);
    if (L.smem <= max_smem) {
      *out = L;
      return true;
    }
  }
  return false;
}

struct RingBars {
  uint32_t bars;
  int stages, slots;
  __device__ __forceinline__ uint32_t tile_full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t tile_empty(int s) const { return bars + 8 * (stages + s); }
  __device__ __forceinline__ uint32_t slot_full(int s) const {
    return bars + 8 * (2 * stages + s);
  }
  __device__ __forceinline__ uint32_t slot_empty(int s) const {
    return bars + 8 * (2 * stages + slots + s);
  }
  __device__ __forceinline__ uint32_t bias_full() const {
    return bars + 8 * (2 * stages + 2 * slots);
  }
  __device__ __forceinline__ uint32_t slot_ready(int s) const {
    return bars + 8 * (2 * stages + 2 * slots + 1 + s);
  }
};

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA) accesses of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Thread 0 sets up the barriers; then the whole block syncs once.
// `unit_threads`: the consumer threads that read one item (its stage);
// `all_consumers`: every consumer thread (a mask slot's readers).
__device__ __forceinline__ void init_ring(const RingBars& rb, int unit_threads,
                                          int all_consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < rb.stages; ++s) {
      mbar_init(rb.tile_full(s), 1);
      mbar_init(rb.tile_empty(s), unit_threads);
    }
    for (int s = 0; s < rb.slots; ++s) {
      mbar_init(rb.slot_full(s), 1);
      mbar_init(rb.slot_empty(s), all_consumers);
      mbar_init(rb.slot_ready(s), 32);  // the producer warp
    }
    mbar_init(rb.bias_full(), 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// Mask slot j % slots += bias[h] (bh: its shared-memory copy), once
// position j's mask has landed; 16 bytes a lane at a time, by the whole
// warp.
__device__ __forceinline__ void add_bias(const RingLayout& L, const RingBars& rb,
                                         unsigned char* gbase, const float4* bh, int j,
                                         int lane) {
  const int s = j % L.slots;
  mbar_wait(rb.slot_full(s), (j / L.slots) & 1);
  float4* slot = reinterpret_cast<float4*>(gbase + L.slot_off + s * L.table_bytes);
#pragma unroll 4
  for (int e = lane; e < L.table_bytes / 16; e += 32) {
    const float4 m = slot[e], bb = bh[e];
    slot[e] = make_float4(bb.x + m.x, bb.y + m.y, bb.z + m.z, bb.w + m.w);
  }
  fence_proxy_async();  // the slot is refilled by TMA later
  mbar_arrive(rb.slot_ready(s));
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// `count` arrivals at once.
__device__ __forceinline__ void mbar_arrive_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// The producer: bias[h] when there is no mask, then an event loop that
// never waits on one resource while another is ready: the next item's
// kTiles tiles as soon as their stage is free, the next window position's
// mask as soon as its slot is free, and (kCombine) bias[h] added into the
// next landed mask slot. Without kCombine one thread runs it and a combiner
// warp does the adds; with it the whole warp runs it, lane 0 deciding and
// issuing the copies, every lane adding.
template <int D, int kTiles, bool kCombine>
__device__ __forceinline__ void produce(const RingLayout& L, const RingBars& rb, uint32_t base,
                                        unsigned char* gbase,
                                        const CUtensorMap* const (&maps)[kTiles], const Run& run,
                                        int n_images, int period, const float* bias,
                                        const float* mask, int nn, int lane) {
  const bool leader = !kCombine || lane == 0;
  const int w_first = run.begin / n_images;
  const int n_positions = L.slots ? (run.end - 1) / n_images - w_first + 1 : 0;
  const int len = run.end - run.begin;
  if (leader && L.bias_smem) {
    mbar_expect_tx(rb.bias_full(), L.table_bytes);
    bulk_load(base + L.bias_off, bias + static_cast<long long>(run.h) * nn, L.table_bytes,
              rb.bias_full());
  }
  const float4* bh = reinterpret_cast<const float4*>(gbase + L.bias_off);
  int n = 0, jm = 0, jc = 0;  // next item to load, mask to load, slot to add bias into
  while (n < len || jm < n_positions || (kCombine && jc < n_positions)) {
    bool moved = false;
    if (leader && n < len && mbar_test(rb.tile_empty(n % L.stages), ((n / L.stages) & 1) ^ 1)) {
      const int i = run.begin + n, w = i / n_images, b = i - w * n_images;
      const int st = n % L.stages;
      mbar_expect_tx(rb.tile_full(st), kTiles * L.box_bytes);
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
        tma_load_3d(base + L.stage_off + (st * kTiles + t) * L.tile_bytes, maps[t],
                    rb.tile_full(st), run.h * D, 0, b * period + w);
      ++n;
      moved = true;
    }
    if (leader && jm < n_positions &&
        mbar_test(rb.slot_empty(jm % L.slots), ((jm / L.slots) & 1) ^ 1)) {
      const int s = jm % L.slots;
      mbar_expect_tx(rb.slot_full(s), L.table_bytes);
      bulk_load(base + L.slot_off + s * L.table_bytes,
                mask + static_cast<long long>(w_first + jm) * nn, L.table_bytes,
                rb.slot_full(s));
      ++jm;
      moved = true;
    }
    if constexpr (kCombine) {
      bool ready = leader && jc < jm && mbar_test(rb.slot_full(jc % L.slots), (jc / L.slots) & 1);
      n = __shfl_sync(0xffffffffu, n, 0);
      jm = __shfl_sync(0xffffffffu, jm, 0);
      ready = __shfl_sync(0xffffffffu, ready, 0);
      moved = __shfl_sync(0xffffffffu, moved, 0) || ready;
      if (ready) {
        if (jc == 0) mbar_wait(rb.bias_full(), 0);
        add_bias(L, rb, gbase, bh, jc++, lane);
      }
    }
    if (!moved) __nanosleep(64);
  }
}

// The combiner warp (with mask slots, beside a one-thread producer): adds
// bias[h] into each window position's slot of the run in turn.
__device__ __forceinline__ void combine(const RingLayout& L, const RingBars& rb,
                                        unsigned char* gbase, const Run& run, int n_images,
                                        int lane) {
  const int w_first = run.begin / n_images;
  const int n_positions = (run.end - 1) / n_images - w_first + 1;
  const float4* bh = reinterpret_cast<const float4*>(gbase + L.bias_off);
  mbar_wait(rb.bias_full(), 0);
  for (int j = 0; j < n_positions; ++j) add_bias(L, rb, gbase, bh, j, lane);
}

// A consumer thread's release of mask slots after the score step of its
// item n, where units take a run's items in turns of `step` (1 or 2): once
// its next item (n + step) lies at another window position, or there is
// none, it is done with this item's position and arrives on the slot's
// `empty` barrier. A thread arrives only for a position whose mask it
// waited for, so no arrival can fall into the slot's previous phase (the
// producer refills a slot only after that phase completes). A position
// that only one unit reads (one image per window position, or the run's
// first or last item) takes that unit's threads' arrivals `step` times, so
// every phase counts all the consumer threads the barrier expects.
__device__ __forceinline__ void release_masks(const RingBars& rb, const RingLayout& L,
                                              const Run& run, int n_images, int n, int step) {
  if (!L.slots) return;
  const int i = run.begin + n, w = i / n_images, next = i + step;
  if (next < run.end && next / n_images == w) return;
  const int items = min(run.end, (w + 1) * n_images) - max(run.begin, w * n_images);
  const int readers = min(step, items);  // units that read position w
  mbar_arrive_count(rb.slot_empty((w - run.begin / n_images) % L.slots), step / readers);
}

// ---------------------------------------------------------------------------
// the score step
// ---------------------------------------------------------------------------

// acc = A B^T for A's 16 rows from row0 and all 16 * kRowTiles rows of B
// (q k^T, do v^T: both tiles [row][D], swizzled), over D.
template <int D, int kRowTiles>
__device__ __forceinline__ void rows_x_rows(float (&acc)[2 * kRowTiles][4], uint32_t sA,
                                            uint32_t sB, int row0, int lane) {
  constexpr int kKSteps = D / 16;
  uint32_t a[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) a_frag<D>(a[kk], sA, row0, kk * 16, lane);
#pragma unroll
  for (int j = 0; j < 2 * kRowTiles; j += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc[j + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t b[4];
      b_frag_nk<D>(b, sB, j * 8, kk * 16, lane);
      mma_bf16_16816(acc[j], a[kk], b[0], b[1]);
      mma_bf16_16816(acc[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// In place: s -> exp(x - max_row x), x = s * scale + table (+ mask with
// kMask: a compile-time choice, so no branch keeps the compiler from
// issuing every load of the row early), tables N x N fp32 with rows ldb
// apart (ldb even); keys past N -inf, rows past N take no table. inv[i] =
// 1 / (the row's sum) for rows r_lo (i = 0) and r_lo + 8. exp by
// ex2.approx (~2 ulp, as exp2f).
template <int kRowTiles, bool kMask>
__device__ __forceinline__ void softmax_rows(float (&s)[2 * kRowTiles][4], const float* table,
                                             const float* mask, int N, int ldb, float scale,
                                             int r_lo, int t, float (&inv)[2]) {
  constexpr int kKeyTiles = 2 * kRowTiles;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r_lo + 8 * hr;
      float x0 = -INFINITY, x1 = -INFINITY;
      if (col < N) {
        x0 = s[j][2 * hr] * scale;
        x1 = s[j][2 * hr + 1] * scale;
        if (row < N) {  // rows past the window are never stored
          const float2 bb = *reinterpret_cast<const float2*>(table + row * ldb + col);
          x0 += bb.x;
          x1 += bb.y;
          if constexpr (kMask) {
            const float2 mm = *reinterpret_cast<const float2*>(mask + row * ldb + col);
            x0 += mm.x;
            x1 += mm.y;
          }
        }
        if (col + 1 >= N) x1 = -INFINITY;
      }
      s[j][2 * hr] = x0;
      s[j][2 * hr + 1] = x1;
      mx[hr] = fmaxf(mx[hr], fmaxf(x0, x1));
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] *= kLog2e;
  }
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fast_exp2(fmaf(s[j][e], kLog2e, -mx[e >> 1]));  // exp(x - max)
      l[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
}

// ---------------------------------------------------------------------------
// host: the tensor map of one of q/k/v/do
// ---------------------------------------------------------------------------

// A 3-D map (channel, token, window) over a (nB, N, C) bf16 tensor whose
// channels are contiguous, with row and window strides in elements (q, k
// and v may be column slices of the fused qkv projection); boxes of one
// head's D channels x npad tokens of one window, swizzled by one row.
// Tokens past N read as zeros. Returns false if the encoding is refused.
template <int D>
inline bool make_window_map(CUtensorMap* map, const void* base, int C, int N, int nB, int npad,
                            long long row_stride, long long batch_stride) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return false;
  // a size-1 dimension's stride is never stepped; give it a legal one
  if (N <= 1) row_stride = C;
  if (nB <= 1) batch_stride = row_stride * N;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(nB)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(npad), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = D == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's opt-in shared memory per block, asked once per
// device.
inline int max_smem_optin() {
  static int bytes[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (!bytes[device] && cudaDeviceGetAttribute(&bytes[device],
                                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                               device) != cudaSuccess)
    return 0;
  return bytes[device];
}

// ---------------------------------------------------------------------------
// host: what both kernels' entry points share
// ---------------------------------------------------------------------------

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The bias and mask tables' layout (ops/window_attention.py::table_layout,
// which the entry points check against): N rows of ldb (N rounded up to
// even) fp32, one table every nn floats (a multiple of 4: 16-byte aligned
// bulk copies).
inline int table_ldb(int N) { return N + (N & 1); }
inline int table_nn(int N) { return (N * table_ldb(N) + 3) / 4 * 4; }

// Dynamic shared memory above 48 KB must be allowed per kernel first; asked
// once per kernel, device and size, so the host path of a launch stays short.
template <auto kKernel>
int allow_smem(int smem) {
  static int allowed[64] = {};
  int device = 0;
  if (smem <= 48 * 1024) return 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return kInvalid;
  if (allowed[device] >= smem) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed[device] = smem;
  return 0;
}

// What a launch at (N, D) uses: the ring (only its smem for the fp32
// kernels), the threads, and how many blocks fit on one SM.
struct Config {
  RingLayout L;
  int threads, blocks_per_sm;
};

// cfg->blocks_per_sm of kKernel at cfg's threads and shared memory.
template <auto kKernel>
int occupancy(Config* cfg) {
  const int err = allow_smem<kKernel>(cfg->L.smem);
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &cfg->blocks_per_sm, kKernel, cfg->threads, cfg->L.smem));
}

// The *_config entry points' out[0..5]: blocks per SM, dynamic shared
// memory in bytes, ring stages, mask slots, 1 if bias[h] sits in shared
// memory, threads per block.
inline void config_out(const Config& cfg, int* out) {
  out[0] = cfg.blocks_per_sm;
  out[1] = cfg.L.smem;
  out[2] = cfg.L.stages;
  out[3] = cfg.L.slots;
  out[4] = cfg.L.bias_smem;
  out[5] = cfg.threads;
}

// Calls F<D, kRowTiles>::run(args...) for the bf16 instantiation that takes
// (N, D).
template <template <int, int> class F, typename... Args>
int by_shape(int N, int D, Args&&... args) {
#define PIXPARSE_ROWS(D_)                      \
  switch ((N + 15) / 16) {                     \
    case 1: return F<D_, 1>::run(args...);     \
    case 2: return F<D_, 2>::run(args...);     \
    case 3: return F<D_, 3>::run(args...);     \
    case 4: return F<D_, 4>::run(args...);     \
    case 5: return F<D_, 5>::run(args...);     \
    case 6: return F<D_, 6>::run(args...);     \
    case 7: return F<D_, 7>::run(args...);     \
    case 8: return F<D_, 8>::run(args...);     \
    case 9: return F<D_, 9>::run(args...);     \
    default: return kInvalid;                  \
  }
  switch (D) {
    case 16: PIXPARSE_ROWS(16)
    case 32: PIXPARSE_ROWS(32)
    case 64: PIXPARSE_ROWS(64)
    default: return kInvalid;
  }
#undef PIXPARSE_ROWS
}

// Calls F<D>::run(args...) for the fp32 instantiation of head dim D.
template <template <int> class F, typename... Args>
int by_head_dim(int D, Args&&... args) {
  switch (D) {
    case 16: return F<16>::run(args...);
    case 32: return F<32>::run(args...);
    case 64: return F<64>::run(args...);
    default: return kInvalid;
  }
}

}  // namespace window
}  // namespace pixparse
