// One multi-tensor AdamW update over every parameter of a model, for Hopper
// (sm_90a), bound through a plain C entry point (ctypes; see
// pixparse_tpu_torch/ops/_build.py).
//
// Replaces no TPU kernel: the JAX package leaves its optax chain to XLA,
// which fuses it into a few passes over the parameter tree. The port's plain
// chain (framework/optimization.py::Optimizer.update and the non-finite
// skip of framework/train_state.py) runs ~15 foreach calls, each a new list
// of fp32 tensors, and per-leaf launches around them. This file does the same
// arithmetic in two launches:
//
//   1. sumsq_kernel: each block sums g^2 over one chunk of one leaf into a
//      fp32 partial; the last block to finish (a ticket counter, left at 0)
//      adds the partials in a fixed order, so the norm repeats bit for bit. It
//      then writes grad_norm = sqrt(sum), ok = isfinite(grad_norm) &
//      isfinite(loss), nonfinite = !ok, optax's clip factor (1 unless the
//      clip is by norm), b1c = 1 - b1^(count+1), b2c likewise, and adds ok
//      to the update count.
//   2. update_kernel: each block takes one chunk again and, only if ok,
//        g' = g * clip
//        m' = b1 m + (1 - b1) g'            v' = b2 v + (1 - b2) g'^2
//        u  = (m' / b1c) / (sqrt(v' / b2c) + eps)   [+ wd * p on decayed leaves]
//        p += (u * layer_scale) * -lr;  m <- m', v <- v'
//      in fp32 registers, in optax's order and with no contraction into
//      fused multiply-adds (the chain's separate operations). The moments are
//      stored in fp32 or bf16 (rounded to nearest from the fp32 value the
//      update used). A skipped step writes nothing.
//
// What bounds it on an H100: bytes. Per parameter the update reads p, g, m
// and v and writes p, m and v: 28 bytes with fp32 moments (20 with bf16),
// plus the 4 bytes of g the norm reads, against a few tens of fp32
// operations, far below the ~295 FLOP/byte ridge. What the design does about
// it: every element is read once per pass and written once, 16-byte vectors
// where the chunk's pointers allow, and no temporary reaches device memory.
//
// Leaves: a device table, built once, of each leaf's p, m and v addresses,
// decay flag and layer scale, and one of chunks (leaf, offset, length <=
// kChunk). The gradients' addresses change every step (autograd allocates
// them), so they travel by value in the launch's parameters (a
// __grid_constant__ array of kMaxLeaves pointers): nothing is staged on the
// host and nothing is read back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;      // elements; ops/optimizer.py FUSED_ADAMW_CHUNK
constexpr int kMaxLeaves = 2048;   // ops/optimizer.py FUSED_ADAMW_MAX_LEAVES

// the scalars the first launch hands the second, in a small fp32 buffer
enum { kNorm = 0, kClip = 1, kB1c = 2, kB2c = 3, kOk = 4, kScalars = 8 };

struct Leaf {       // 32 bytes: ops/optimizer.py _LEAF_DTYPE
  float* p;
  void* m;
  void* v;
  float scale;      // layer-decay scale, 1 without layer decay
  int decay;        // 1: add wd * p
};

struct Chunk {      // 16 bytes: ops/optimizer.py _CHUNK_DTYPE
  long long off;    // first element within the leaf
  int leaf;
  int len;          // elements, 1..kChunk
};

struct Grads {
  const float* g[kMaxLeaves];
};

// The sum of x over the block, in a fixed order, valid in thread 0.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // a previous call's readers are done
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  return s;
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const __grid_constant__ Grads grads, const Chunk* __restrict__ chunks,
             float* __restrict__ partials, int* __restrict__ ticket, int n_chunks,
             const float* __restrict__ loss, int* __restrict__ count, float* __restrict__ scal,
             int* __restrict__ nonfinite, float b1, float b2, int clip_on, float max_norm,
             int skip_nonfinite) {
  const Chunk c = chunks[blockIdx.x];
  const float* g = grads.g[c.leaf] + c.off;
  float acc = 0.f;
  int done = 0;
  if (aligned(g, 16)) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int n4 = c.len >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 x = __ldcs(g4 + i);
      acc = fmaf(x.x, x.x, acc);
      acc = fmaf(x.y, x.y, acc);
      acc = fmaf(x.z, x.z, acc);
      acc = fmaf(x.w, x.w, acc);
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < c.len; i += kThreads) {
    const float x = __ldcs(g + i);
    acc = fmaf(x, x, acc);
  }
  const float part = block_sum(acc);

  __shared__ int s_ticket;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();  // the partial before the ticket
    s_ticket = atomicAdd(ticket, 1);
  }
  __syncthreads();
  if (s_ticket != n_chunks - 1) return;

  // the last block: every other partial is visible (their fences came
  // before their tickets); read them past L1, in chunk order per thread
  __threadfence();
  float s = 0.f;
  for (int i = threadIdx.x; i < n_chunks; i += kThreads) s += __ldcg(partials + i);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    const float norm = sqrtf(s);
    const bool ok = !skip_nonfinite || (isfinite(norm) && isfinite(*loss));
    // optax clip_by_global_norm, as optimization.py::_clip_by_global_norm
    const float clip = (clip_on && !(norm < max_norm)) ? max_norm / norm : 1.f;
    const int n = *count;
    const float t = static_cast<float>(n + 1);
    scal[kNorm] = norm;
    scal[kClip] = clip;
    scal[kB1c] = 1.f - powf(b1, t);
    scal[kB2c] = 1.f - powf(b2, t);
    scal[kOk] = ok ? 1.f : 0.f;
    *nonfinite = ok ? 0 : 1;
    if (ok) *count = n + 1;
    *ticket = 0;  // ready for the next launch
  }
}

template <typename M>
struct Moments;

template <>
struct Moments<float> {
  static constexpr int kVecBytes = 16;
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Moments<__nv_bfloat16> {
  static constexpr int kVecBytes = 8;
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

struct Hyper {
  float clip, b1, b2, omb1, omb2, b1c, b2c, eps, wd, scale, neg_lr;
  bool decay;
};

// One element of the chain, operation for operation (round-to-nearest
// intrinsics: the compiler may not contract them into FMAs).
__device__ __forceinline__ void adamw(const Hyper& h, float& p, float g, float& m, float& v) {
  g = __fmul_rn(g, h.clip);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, h.b1c), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.b2c)), h.eps));
  if (h.decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  u = __fmul_rn(__fmul_rn(u, h.scale), h.neg_lr);
  p = __fadd_rn(p, u);
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
update_kernel(const __grid_constant__ Grads grads, const Chunk* __restrict__ chunks,
              const Leaf* __restrict__ leaves, const float* __restrict__ scal,
              const float* __restrict__ lr, float b1, float b2, float omb1, float omb2,
              float eps, float wd) {
  if (scal[kOk] == 0.f) return;  // a skipped step leaves every leaf as it was
  using Mo = Moments<M>;
  const Chunk c = chunks[blockIdx.x];
  const Leaf leaf = leaves[c.leaf];
  Hyper h;
  h.clip = scal[kClip];
  h.b1 = b1;
  h.b2 = b2;
  h.omb1 = omb1;
  h.omb2 = omb2;
  h.b1c = scal[kB1c];
  h.b2c = scal[kB2c];
  h.eps = eps;
  h.wd = wd;
  h.scale = leaf.scale;
  h.neg_lr = -*lr;
  h.decay = leaf.decay != 0;
  float* p = leaf.p + c.off;
  M* m = static_cast<M*>(leaf.m) + c.off;
  M* v = static_cast<M*>(leaf.v) + c.off;
  const float* g = grads.g[c.leaf] + c.off;
  int done = 0;
  if (aligned(p, 16) && aligned(g, 16) && aligned(m, Mo::kVecBytes) &&
      aligned(v, Mo::kVecBytes)) {
    const int n4 = c.len >> 2;
#pragma unroll 2
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 pp = *reinterpret_cast<const float4*>(p + 4 * i);
      const float4 gg = __ldcs(reinterpret_cast<const float4*>(g) + i);
      float4 mm = Mo::load4(m + 4 * i);
      float4 vv = Mo::load4(v + 4 * i);
      adamw(h, pp.x, gg.x, mm.x, vv.x);
      adamw(h, pp.y, gg.y, mm.y, vv.y);
      adamw(h, pp.z, gg.z, mm.z, vv.z);
      adamw(h, pp.w, gg.w, mm.w, vv.w);
      *reinterpret_cast<float4*>(p + 4 * i) = pp;
      Mo::store4(m + 4 * i, mm);
      Mo::store4(v + 4 * i, vv);
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < c.len; i += kThreads) {
    float pp = p[i], mm = Mo::load(m + i), vv = Mo::load(v + i);
    adamw(h, pp, __ldcs(g + i), mm, vv);
    p[i] = pp;
    Mo::store(m + i, mm);
    Mo::store(v + i, vv);
  }
}

}  // namespace

// moment_dtype: 0 = float32, 1 = bfloat16. grads: a HOST array of n_leaves
// device pointers (fp32, contiguous, each the size of its leaf), copied into
// the launches' parameters. leaves (n_leaves Leaf) and chunks (n_chunks
// Chunk) are device tables; partials n_chunks floats; ticket one int that is
// 0 (each launch leaves it 0: launches that share it must not overlap).
// loss and lr: fp32 scalars on the device; count: the int32 update count,
// read and advanced on the device; scal: kScalars floats, scal[0] the
// gradient norm on return; nonfinite: one int32. Returns the CUDA error code
// of the launches (0 = success).
extern "C" int pixparse_fused_adamw(int moment_dtype, const void* grads, int n_leaves,
                                    const void* leaves, const void* chunks, int n_chunks,
                                    void* partials, void* ticket, const void* loss,
                                    const void* lr, void* count, void* scal, void* nonfinite,
                                    float b1, float b2, float omb1, float omb2, float eps,
                                    float wd, int clip_on, float max_norm, int skip_nonfinite,
                                    void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_chunks <= 0 ||
      (moment_dtype != 0 && moment_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Grads g = {};
  const void* const* src = static_cast<const void* const*>(grads);
  for (int i = 0; i < n_leaves; ++i) g.g[i] = static_cast<const float*>(src[i]);
  const Chunk* ch = static_cast<const Chunk*>(chunks);
  float* sc = static_cast<float*>(scal);
  sumsq_kernel<<<n_chunks, kThreads, 0, s>>>(
      g, ch, static_cast<float*>(partials), static_cast<int*>(ticket), n_chunks,
      static_cast<const float*>(loss), static_cast<int*>(count), sc,
      static_cast<int*>(nonfinite), b1, b2, clip_on, max_norm, skip_nonfinite);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Leaf* lv = static_cast<const Leaf*>(leaves);
  const float* lr_f = static_cast<const float*>(lr);
  if (moment_dtype == 0)
    update_kernel<float><<<n_chunks, kThreads, 0, s>>>(g, ch, lv, sc, lr_f, b1, b2, omb1, omb2,
                                                      eps, wd);
  else
    update_kernel<__nv_bfloat16><<<n_chunks, kThreads, 0, s>>>(g, ch, lv, sc, lr_f, b1, b2,
                                                              omb1, omb2, eps, wd);
  return static_cast<int>(cudaGetLastError());
}
