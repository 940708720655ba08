// Tile products shared by the two attentions (flash_attention.cu,
// attention.cu, flash_attention_f32.cu): bf16 mma.sync m16n8k16 (fp32
// accumulate) with its ldmatrix operand loads, fp32-accurate products on the
// tensor cores by the 3xTF32 split (mma.sync m16n8k8), and the fp32 SIMT
// tile products of the attention block's fp32 path.
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

// ---- fp32-accurate products on the tensor cores: 3xTF32 --------------------
//
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties
// away from zero: cvt.rna); a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, each a
// TF32 mma.sync with an fp32 accumulator, the a_lo b_lo term (2^-22 of the
// product) dropped. hi keeps 11 significant bits, hi + lo 22.
//
// m16n8k8 fragments (g = lane / 4, t = lane % 4): A (16 x 8) a0..a3 at
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) b0, b1 at
// (k = t, n = g), (t + 4, g); C (16 x 8) c0..c3 at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). An fp32 tile in shared memory read by
// ldmatrix (which moves 32-bit words) gives A and B fragments directly: a
// thread gets word t of row g of each 8 x 4-word matrix.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
  float f[N];
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = __uint_as_float(x[i]);
  split_tf32(f, hi, lo);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32: big += a_hi b_hi, small += a_lo b_hi + a_hi b_lo. Two
// accumulators, summed by the caller: the tensor cores round each sum toward
// zero, relative to the accumulator, so the small terms keep their own, and
// each accumulator takes one chain of products (more in flight).
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1, uint32_t blo0,
                                           uint32_t blo1) {
  mma_tf32(small, alo, bhi0, bhi1);
  mma_tf32(small, ahi, blo0, blo1);
  mma_tf32(big, ahi, bhi0, bhi1);
}

// Four 8 x 4-word matrices by ldmatrix.x4; lane l gives the address of row
// l % 8 of matrix l / 8, and receives word (lane % 4) of row (lane / 4) of
// matrix i in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

}  // namespace rfv_mma
