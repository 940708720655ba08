// Pieces shared by the bf16 flash-attention kernels on wgmma + TMA:
// flash_attention.cu (head widths up to 256) and flash_attention_streamed.cu
// (wider heads, D streamed in 64-column boxes). Layouts, the online softmax
// and the exchange of accumulators between warpgroups are described where
// flash_attention.cu uses them.
#pragma once

#include "mma.cuh"
#include "wgmma.cuh"

namespace rfv_flash_tc {

using namespace rfv_wgmma;
using rfv_mma::pack_bf16;

constexpr int THREADS = 384;  // producer + two consumer warpgroups
constexpr int ROW = 128;      // bytes of one swizzled box row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

constexpr int WIDE = 64;  // rows of a box tile and keys of a logit tile above DP = 128

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// K-major operand: k-step kk (16 columns) of rows r0 .. r0 + 63 (A) or of all
// rows (B) of a tile of `rows` rows at shared address `tile`.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r0, int kk) {
  return desc_sw128(tile + (kk >> 2) * rows * ROW + r0 * ROW + (kk & 3) * 32);
}

// MN-major B operand: k-step kk (rows 16 kk .. 16 kk + 15) of such a tile,
// N running over its columns (the next box `rows` x 128 bytes on).
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return desc_sw128_mn(tile + kk * 16 * ROW, rows * ROW);
}

// Rows g (half 0) and g + 8 (half 1) of a warp's 16 rows of an m64nDP
// accumulator, times mul0 / mul1, rounded to bf16 and stored 16 bytes at a
// time at dst0 / dst1; columns at or past D are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], float mul0, float mul1,
                                           bf16* dst0, bf16* dst1, int D, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* dst = half ? dst1 : dst0;
    const float mul = half ? mul1 : mul0;
#pragma unroll
    for (int a = 0; a < DP / 32; ++a) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * a + j;
        v[j] = pack_bf16(acc[4 * i + 2 * half] * mul, acc[4 * i + 2 * half + 1] * mul);
      }
      const uint4 out = quad_transpose(v, lane);
      const int col = 8 * (4 * a + (lane & 3));
      if (col < D) *reinterpret_cast<uint4*>(dst + col) = out;
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// --------------------------------------------------------------- forward ----

// The online softmax of one warpgroup's 64 x N logit tiles, on the
// accumulator registers: a thread holds rows g (s[4i], s[4i + 1]) and g + 8
// (s[4i + 2], s[4i + 3]); row maxima are reduced across the quad. Each tile
// updates the running maximum and (per-thread partial) sum, writes the
// unnormalised probabilities as bf16 A fragments and leaves the factor by
// which the output accumulated so far is to be rescaled. Maxima and sums
// are taken over four interleaved partials, so that no chain of dependent
// instructions runs the length of a row.
struct OnlineSoftmax {
  float sl2;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, alpha0 = 1.f, alpha1 = 1.f;
  __device__ __forceinline__ explicit OnlineSoftmax(float scale) : sl2(scale * kLog2e) {}

  template <int N>
  __device__ __forceinline__ void tile(const float (&s)[N / 2], uint32_t (&p)[N / 16][4]) {
    float a0[4], a1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
      a1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int i = 4; i < N / 8; ++i) {
      a0[i & 3] = fmaxf(a0[i & 3], fmaxf(s[4 * i], s[4 * i + 1]));
      a1[i & 3] = fmaxf(a1[i & 3], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    float mx0 = fmaxf(fmaxf(m0, fmaxf(a0[0], a0[1])), fmaxf(a0[2], a0[3]));
    float mx1 = fmaxf(fmaxf(m1, fmaxf(a1[0], a1[1])), fmaxf(a1[2], a1[3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    alpha0 = fast_exp2((m0 - mx0) * sl2);
    alpha1 = fast_exp2((m1 - mx1) * sl2);
    m0 = mx0;
    m1 = mx1;
    const float sub0 = mx0 * sl2, sub1 = mx1 * sl2;
    float r0[4] = {0.f, 0.f, 0.f, 0.f}, r1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const float p0 = fast_exp2(fmaf(s[4 * i], sl2, -sub0));
      const float p1 = fast_exp2(fmaf(s[4 * i + 1], sl2, -sub0));
      const float p2 = fast_exp2(fmaf(s[4 * i + 2], sl2, -sub1));
      const float p3 = fast_exp2(fmaf(s[4 * i + 3], sl2, -sub1));
      r0[i & 3] += p0 + p1;
      r1[i & 3] += p2 + p3;
      p[i >> 1][(i & 1) * 2] = pack_bf16(p0, p1);
      p[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + ((r0[0] + r0[1]) + (r0[2] + r0[3]));
    l1 = l1 * alpha1 + ((r1[0] + r1[1]) + (r1[2] + r1[3]));
  }

  template <int DP>
  __device__ __forceinline__ void rescale(float (&o)[DP / 2]) const {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
  }
};

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

constexpr int P_READY = 1, P_FREE = 2, DS_READY = 3, DS_FREE = 4;

// A 64 x 64 fp32 accumulator of a warpgroup, handed over in shared memory in
// its register layout: float4 j of thread i at j * 128 + i, so that a warp's
// 16-byte accesses are consecutive.
__device__ __forceinline__ void put_acc(float* buf, const float (&v)[WIDE / 2], int tid) {
  float4* b = reinterpret_cast<float4*>(buf);
#pragma unroll
  for (int j = 0; j < WIDE / 8; ++j)
    b[j * 128 + tid] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}
__device__ __forceinline__ void get_acc(const float* buf, float (&v)[WIDE / 2], int tid) {
  const float4* b = reinterpret_cast<const float4*>(buf);
#pragma unroll
  for (int j = 0; j < WIDE / 8; ++j) {
    const float4 x = b[j * 128 + tid];
    v[4 * j] = x.x;
    v[4 * j + 1] = x.y;
    v[4 * j + 2] = x.z;
    v[4 * j + 3] = x.w;
  }
}

// Tensor map of a [B, T, H, D] bf16 tensor with element strides (sb, st, sh,
// 1), viewed as (D, H, T, B): boxes of 64 columns x `rows` tokens of one head,
// 128-byte swizzled, columns past D read as zeros.
inline int tensor_map(CUtensorMap* map, const void* base, int B, int T, int H, int D, long long sb,
               long long st, long long sh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dim,
                            stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Persistent grid: one block per SM, or one per tile where there are fewer.
inline int grid_for(int tiles) { return tiles < sm_count() ? tiles : sm_count(); }

}  // namespace rfv_flash_tc
