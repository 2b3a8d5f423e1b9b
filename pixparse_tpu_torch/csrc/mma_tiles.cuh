// Tensor-core and shared-memory tile helpers shared by the port's Hopper
// kernels (flash attention forward and backward, fused cross entropy, window
// attention forward and backward).
//
// All products go through mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// Fragment layout, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..)
//   B (16 x 8, "col"):      b0 = (k = 2t..2t+1, n = g), b1 = (k = 2t + 8.., n = g)
//   C/D (16 x 8):           c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
// so two neighbouring accumulator tiles, rounded to bf16, are one A fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pixparse {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t u16(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to bf16 and packed (low half = x).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return bf16x2_bits(__floats2bfloat162_rn(x, y));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and register i of every lane holds its share of
// matrix i (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (register i holds column g,
// rows 2t..2t+1 of matrix i).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of the 16 x 16 block at (row0, col0) of a row-major bf16 tile
// with row stride `lds` elements.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int lds,
                                            int row0, int col0, int lane) {
  const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = col0 + (lane >> 4) * 8;
  ldmatrix_x4(a, tile + r * lds + c);
}

// A fragment of the 16 x 16 block at (m0, k0) of the TRANSPOSE of a
// row-major bf16 tile with row stride `lds`: A[m][k] = tile[k0 + k][m0 + m]
// (the product contracts over the tile's rows).
__device__ __forceinline__ void load_a_frag_trans(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                                  int lds, int m0, int k0, int lane) {
  const int mi = lane >> 3;  // matrix i of a0..a3: (m, k) blocks (0,0) (8,0) (0,8) (8,8)
  const int k = k0 + (lane & 7) + (mi >> 1) * 8;
  const int m = m0 + (mi & 1) * 8;
  ldmatrix_x4_trans(a, tile + k * lds + m);
}

// B fragments of two neighbouring n-tiles from a tile stored [n][k] (the
// product contracts over the tile's columns): b[0], b[1] belong to rows
// n0..n0+7 and b[2], b[3] to rows n0+8..n0+15, both over columns k0..k0+15.
__device__ __forceinline__ void load_b_frag_nk(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                               int lds, int n0, int k0, int lane) {
  const int n = n0 + (lane & 7) + (lane >> 4) * 8;
  const int k = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, tile + n * lds + k);
}

// B fragments of two neighbouring n-tiles from a tile stored [k][n] (the
// product contracts over the tile's rows): b[0], b[1] belong to columns
// n0..n0+7 and b[2], b[3] to columns n0+8..n0+15, both over rows k0..k0+15.
__device__ __forceinline__ void load_b_frag_kn(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                               int lds, int k0, int n0, int lane) {
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int n = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, tile + k * lds + n);
}

// Rows [row0, row0 + kRows) of a (nrows, D) bf16 matrix with row stride
// `rstride` -> shared memory with padded row stride D + 8; rows >= nrows are
// zero-filled. 16-byte vector loads.
template <int D, int kRows>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* smem, const __nv_bfloat16* src,
                                               long long rstride, int row0, int nrows) {
  constexpr int kVecPerRow = D / 8;
  constexpr int kLds = D + 8;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += blockDim.x) {
    const int r = i / kVecPerRow, c = i % kVecPerRow;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * rstride + c * 8);
    *reinterpret_cast<uint4*>(smem + r * kLds + c * 8) = val;
  }
}

// 16 bytes global -> shared without passing through registers; `valid` false
// writes zeros instead (src-size 0) and reads nothing.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [0, n) of a (n, D) bf16 matrix with row stride `rstride` -> shared
// memory with padded row stride D + 8, by cp.async (no register round trip;
// the caller commits and waits); rows [n, n_pad) are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* smem, const __nv_bfloat16* src,
                                                long long rstride, int n, int n_pad) {
  constexpr int kVecPerRow = D / 8;
  constexpr int kLds = D + 8;
  for (int i = threadIdx.x; i < n_pad * kVecPerRow; i += blockDim.x) {
    const int r = i / kVecPerRow, c = i % kVecPerRow;
    const bool in = r < n;
    cp_async_16(smem + r * kLds + c * 8, src + (in ? (long long)r * rstride : 0) + c * 8, in);
  }
}

}  // namespace pixparse
