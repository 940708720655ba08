// The pieces the fp32 flash kernels up to D = 128 share (forward in
// flash_attention_f32.cu, dkv and dq in flash_attention_f32_bwd.cu): tiles
// in shared memory, their split into TF32 hi and lo, fragment addresses and
// the two kinds of tile product, in 3xTF32 on mma.sync (mma.cuh). The design
// is described in flash_attention_f32.cu.
#pragma once

#include "flash_attention.cuh"
#include "mma.cuh"

namespace rfv_flash_tc {

using namespace rfv_mma;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NC = 4;            // n-tiles of a second product summed in fresh accumulators
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can have

// Shared-memory row pitch of a tile of DP columns: DP + 4 = 4 mod 8 words,
// so that the 8 rows x 16 bytes of an ldmatrix fall on 8 distinct bank
// groups, and a warp's scalar reads of rows 2t, 2t + 1 at column g on 32
// distinct banks.
template <int DP>
__host__ __device__ constexpr int pitch() { return DP + 4; }

// rows x DP floats (row r at src + r * stride) into shared rows of pitch
// pitch<DP>() by cp.async; 16-byte pieces at or past D (a multiple of 8) are
// zero-filled.
template <int DP>
__device__ __forceinline__ void tile(float* dst, const float* src, long long stride, int rows,
                                     int D) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = 4 * (i - r * CH);
    const bool in = c < D;
    cp_async16(dst + r * pitch<DP>() + c, src + r * stride + (in ? c : 0), in ? 16 : 0);
  }
}

// n contiguous floats (a multiple of 4) by cp.async.
__device__ __forceinline__ void row(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i, 16);
}

// Per-lane offsets into a tile of pitch P: the ldmatrix.x4 address of an A
// fragment (rows 0-15, columns 0-7: matrices rows 0-7 / 8-15 x columns 0-3
// / 4-7), of the B fragments of two n-tiles (rows 0-7 and 8-15 hold n,
// columns 0-3 and 4-7 k), and of a second product's B (row 2t, column g).
__device__ __forceinline__ int a_lane(int lane, int P) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * P + 4 * (lane >> 4);
}
__device__ __forceinline__ int b_lane(int lane, int P) {
  return ((lane & 7) + 8 * (lane >> 4)) * P + 4 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int t_lane(int lane, int P) { return 2 * (lane & 3) * P + (lane >> 2); }

// A streamed tile split once where it landed: hi over each value in place,
// lo into the same place of `lo` (rows x DP, pitch pitch<DP>()).
template <int DP>
__device__ __forceinline__ void split_tile(float* t, float* lo, int rows) {
  constexpr int CH = DP / 4, P = pitch<DP>();
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = 4 * (i - r * CH);
    float4* p = reinterpret_cast<float4*>(t + r * P + c);
    const float4 x4 = *p;
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    uint32_t hi[4], lw[4];
    split_tf32(x, hi, lw);
    *p = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                     __uint_as_float(hi[3]));
    *reinterpret_cast<float4*>(lo + r * P + c) =
        make_float4(__uint_as_float(lw[0]), __uint_as_float(lw[1]), __uint_as_float(lw[2]),
                    __uint_as_float(lw[3]));
  }
}

// First product: acc[j] = A B_j^T summed over the DP columns (acc zero on
// entry). A: the warp's 16 rows of an fp32 tile at this lane's a_lane offset,
// split in registers; B_j: rows 8 j .. 8 j + 7 of a split tile, hi at bh and
// lo at bl (this lane's b_lane offset). The two small products and the large
// one go to separate accumulators, added at the end.
template <int DP, int NT>
__device__ __forceinline__ void nt(float (&acc)[NT][4], const float* a, const float* bh,
                                   const float* bl) {
  constexpr int P = pitch<DP>();
  float small[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t af[4], ahi[4], alo[4];
    ldsm_x4(af, a + 8 * kk);
    split_tf32(af, ahi, alo);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bhi[4], blo[4];
      ldsm_x4(bhi, bh + 8 * j * P + 8 * kk);
      ldsm_x4(blo, bl + 8 * j * P + 8 * kk);
      mma_3xtf32(acc[j], small[j], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
      mma_3xtf32(acc[j + 1], small[j + 1], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// Second product: acc[n] += X Y[:, 8 n .. 8 n + 7]. X: the 16 x 8 NK
// accumulator x of a first product (its columns are the sum index), split in
// registers; Y: rows 0 .. 8 NK - 1 of a split tile, hi at yh and lo at yl
// (this lane's t_lane offset), summed in the permuted order (A's column t is
// row 2t of Y, t + 4 is 2t + 1: x's c0..c3 are a0, a2, a1, a3). NC n-tiles at
// a time are summed over the whole tile in fresh accumulators and then added
// to acc in fp32: the tensor cores round their sums toward zero, and a long
// run of products into one accumulator (1024 keys: 384 of them) would pile
// that bias up.
template <int DP, int NK, int NO>
__device__ __forceinline__ void nn(float (&acc)[NO][4], const float (&x)[NK][4], const float* yh,
                                   const float* yl) {
  constexpr int P = pitch<DP>();
#pragma unroll
  for (int c = 0; c < NO; c += NC) {
    float big[NC][4], small[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float a[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
      uint32_t ahi[4], alo[4];
      split_tf32(a, ahi, alo);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (c + n < NO) {
          const int o = 8 * (c + n) + 8 * j * P;
          mma_3xtf32(big[n], small[n], ahi, alo, __float_as_uint(yh[o]),
                     __float_as_uint(yh[o + P]), __float_as_uint(yl[o]),
                     __float_as_uint(yl[o + P]));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (c + n < NO)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c + n][e] += big[n][e] + small[n][e];
  }
}

// Rows g and g + 8 of the warp's 16 (row pointers r0, r1) of an accumulator
// of DP / 8 n-tiles, times mul0 / mul1; columns at or past D not stored.
template <int DP>
__device__ __forceinline__ void store(const float (&acc)[DP / 8][4], float* r0, float* r1,
                                      int lane, float mul0, float mul1, int D) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    if (8 * n < D) {
      *reinterpret_cast<float2*>(r0 + 8 * n + 2 * t) =
          make_float2(acc[n][0] * mul0, acc[n][1] * mul0);
      *reinterpret_cast<float2*>(r1 + 8 * n + 2 * t) =
          make_float2(acc[n][2] * mul1, acc[n][3] * mul1);
    }
  }
}

}  // namespace rfv_flash_tc

// The instances: every multiple of 8 up to 128.
#define RFV_F32_WIDTHS(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) X(104) X(112) X(120) X(128)
