// Tile products shared by the two attentions (flash_attention.cu,
// attention.cu): bf16 mma.sync m16n8k16 (fp32 accumulate) with its ldmatrix
// operand loads, and the fp32 SIMT tile products of their fp32 paths.
//
// Fragment layout of one warp (g = lane / 4, t4 = lane % 4): the A operand
// (16 x 16) holds rows {g, g + 8} x columns 2 t4 + {0, 1, 8, 9}; the B operand
// (16 x 8) columns g x rows 2 t4 + {0, 1, 8, 9}; the accumulator (16 x 8)
// rows {g, g + 8} x columns 2 t4 + {0, 1}, so an accumulator pair of n-tiles
// repacked to bf16 is the A operand of the next product (P in P V).
#pragma once

#include "common.cuh"

namespace rfv_mma {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand (16 x 16) from a row-major tile m[row][k] of pitch LD:
// rows r0 + {g, g + 8}, columns k0 + 2 * t4 + {0, 1, 8, 9}.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m, int r0, int k0, int g,
                                       int t4) {
  const bf16* p = m + (r0 + g) * LD + k0 + 2 * t4;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LD);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LD + 8);
}

// Two B operands (16 x 8 each) with B[k][n] = m[n0 + n][k0 + k], for the
// k-steps at k0 (b[0], b[1]) and k0 + 16 (b[2], b[3]): the tile holds the
// product's n index in its rows (K in Q K^T, a weight [out][in]). One
// ldmatrix.x4: lanes 8 i .. 8 i + 7 address the rows of the 8 x 8 block at
// columns k0 + 8 i.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* m, int n0, int k0,
                                            int lane) {
  const uint32_t s = static_cast<uint32_t>(
      __cvta_generic_to_shared(m + (n0 + (lane & 7)) * LD + k0 + 8 * (lane >> 3)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

// Two B operands (16 x 8 each) with B[k][n] = m[k0 + k][n0 + n], for the
// n-tiles at n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]): the tile holds the
// product's k index in its rows (V in P V), read transposed. One
// ldmatrix.x4.trans: blocks (rows k0, k0 + 8) x (columns n0, n0 + 8).
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* m, int k0, int n0,
                                            int lane) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(
      m + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + n0 + 8 * (lane >> 4)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

// ---- fp32 counterparts on the CUDA cores (exact fp32 products, no TF32) ----
//
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of a 64-row tile product, tiles in shared memory as float.

// acc[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d], d < K
template <int K, int PA, int PB>
__device__ __forceinline__ void gemm_nt(const float* a, const float* b, float (&acc)[4][4],
                                        int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < K; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * PA + d];
      bv[i] = b[(tx + 16 * i) * PB + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_m a[ty + 16 i][m] * b[m][tx + 16 j], m < 64, j < NJ
template <int NJ, int PA, int PB>
__device__ __forceinline__ void gemm_nn(const float* a, const float* b, float (&acc)[4][NJ],
                                        int ty, int tx) {
#pragma unroll 8
  for (int m = 0; m < 64; ++m) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * PA + m];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[m * PB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_m a[m][ty + 16 i] * b[m][tx + 16 j], m < 64, j < NJ
template <int NJ, int PA, int PB>
__device__ __forceinline__ void gemm_tn(const float* a, const float* b, float (&acc)[4][NJ],
                                        int ty, int tx) {
#pragma unroll 8
  for (int m = 0; m < 64; ++m) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[m * PA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[m * PB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace rfv_mma
