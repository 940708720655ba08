// UNet mid-block self-attention (GroupNorm -> qkv -> softmax(QK^T/sqrt(d))V
// -> proj -> +x) over NHWC, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rectified_flow_vision_tpu/ops/pallas_kernels.py
// attention_block (body _attention_kernel), which runs the whole block for
// one image per grid step out of VMEM (a 32x32 mid block, 1024 tokens, fits
// there; a block's 227 KB of shared memory does not hold one image's qkv).
//
// Bound on the H100: operations. At the flagship shape (256 images, N = 256
// tokens, C = 256, 4 heads of d = 64) the block does 51.5 GFLOP (0.052 ms at
// 989 TFLOP/s) over ~67 MB that must be read and written once.
//
// Four launches over the flattened rows M = B*N:
//   1. GroupNorm: gn_silu's one-pass cluster kernel without the SiLU
//      (gn_silu.cuh; exact two-pass statistics over the image held in shared
//      memory), writing the normalised x rounded to the working dtype (into
//      `att`, which is free until step 3);
//   2. qkv = xn W_qkv^T + b on conv3x3.cu's wgmma + TMA kernel as a one-tap
//      conv over the image (block tile 128 pixels x up to 256 of the 3C
//      outputs, persistent, warp-specialised), rounded: qkv [B, N, 3C], a
//      [B, N, 3, heads, d] view, the layout DiT hands the flash kernel;
//   3. the core, a flash-style key loop: one block per (64 queries, head,
//      image), four warps of 16 query rows on mma.sync m16n8k16; q, k and v
//      are read in place as strided views of qkv, 64-key tiles
//      double-buffered with cp.async; logits, the running maximum and sum
//      in fp32, the unnormalised probabilities rounded to bf16 as the A
//      operand of P V, the output divided by the fp32 sum once. Nothing of
//      size N^2 is stored anywhere, so any N works: the ragged last key tile
//      is masked to -inf, the ragged last query tile is computed and not
//      stored, and head widths below the tile's (32, 64 or 128) are
//      zero-padded in shared memory. The mma.sync helpers are the flash
//      kernel's (mma.cuh);
//   4. proj on the same wgmma kernel, its epilogue adding the bias,
//      rounding, adding the residual x in fp32 and rounding.
// The rounding points are those of P.spatial_attention, except that the core
// rounds unnormalised probabilities (as the flash kernel does).
//
// float32: the same steps with the products on fp32 FMAs (64 x 64 GEMM
// tiles, 4 x 4 outputs a thread; the core with mma.cuh's SIMT tile
// products), exact fp32 products for the fp32 model path and checks.
#include "conv3x3.cuh"
#include "gn_silu.cuh"
#include "mma.cuh"

namespace {

using namespace rfv_mma;

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------ the fp32 GEMMs ----
//
// out[M, O] = a[M, K] w[O, K]^T + bias, rounded; RESID: out = resid + that.
// (bf16 runs its projections on conv3x3.cu's wgmma kernel as one-tap convs.)

struct LinearF32 {
  const float* a;
  const float* w;
  const float* bias;
  const float* resid;
  float* out;
  int M, K, O;
};

// Eight consecutive values of row r of a [rows, K] matrix from column k,
// zero past its ends.
__device__ __forceinline__ void load_row8(const float* __restrict__ p, int rows, int K, int r,
                                          int k, float (&v)[8]) {
  const float* src = p + (size_t)r * K + k;
  if (r < rows && k + 8 <= K && (K & 3) == 0) {
    float lo[4], hi[4];
    load16(src, lo);
    load16(src + 4, hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = lo[e];
      v[4 + e] = hi[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = r < rows && k + e < K ? src[e] : 0.f;
  }
}

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <bool RESID>
__global__ void __launch_bounds__(256) attn_linear_f32_kernel(const LinearF32 p) {
  __shared__ __align__(16) float As[FBK][FBM + 4];
  __shared__ __align__(16) float Bs[FBK][FBN + 4];
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x;
  const int lrow = tid >> 2, lk = (tid & 3) * 4;  // loader: 64 rows x 4 groups of 4
  const int tx = tid & 15, ty = tid >> 4;         // compute: 4 x 4 outputs
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += FBK) {
    // each thread loads 8 values and keeps the 4 of its group
    float va[8], vb[8];
    const int k8 = k0 + (lk & ~7);
    load_row8(p.a, p.M, p.K, m0 + lrow, k8, va);
    load_row8(p.w, p.O, p.K, n0 + lrow, k8, vb);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[lk + e][lrow] = va[(lk & 7) + e];
      Bs[lk + e][lrow] = vb[(lk & 7) + e];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx * 4 + j;
      if (m < p.M && o < p.O) {
        const size_t idx = (size_t)m * p.O + o;
        const float v = acc[i][j] + p.bias[o];
        p.out[idx] = RESID ? p.resid[idx] + v : v;
      }
    }
  }
}

// -------------------------------------------------------------- the core ----
//
// qkv: [B, N, 3C] (q | k | v, head h at columns h*d ..), att: [B, N, C].
// Tiles of 64 rows (queries or keys) x DP columns, d <= DP zero-padded.

constexpr int QT = 64;

// Rows r0 .. r0 + 63 of one head's q, k or v (column offset col0 of qkv) into
// a tile of pitch LDS: rows past N and columns past d are zero. VEC: 16-byte
// cp.async copies (d and C multiples of 8); else synchronous scalar copies.
template <typename T, int DP, int LDS, bool VEC>
__device__ __forceinline__ void load_head_tile(T* s, const T* __restrict__ base, int r0, int N,
                                               int C3, int col0, int d) {
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
    const int chunks = d / EPC;
    for (int c = threadIdx.x; c < QT * chunks; c += blockDim.x) {
      const int r = c / chunks, cc = c - r * chunks;
      const bool ok = r0 + r < N;
      const T* src = ok ? base + (size_t)(r0 + r) * C3 + col0 + cc * EPC : base;
      cp_async16(s + r * LDS + cc * EPC, src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < QT * DP; i += blockDim.x) {
      const int r = i / DP, k = i - r * DP;
      s[r * LDS + k] = (r0 + r < N && k < d) ? base[(size_t)(r0 + r) * C3 + col0 + k]
                                             : from_f32<T>(0.f);
    }
  }
}

// Zero the columns d .. DP - 1 of `rows` rows (the VEC copies never write them).
template <typename T, int DP, int LDS>
__device__ __forceinline__ void zero_pad(T* s, int rows, int d) {
  for (int i = threadIdx.x; i < rows * (DP - d); i += blockDim.x) {
    const int r = i / (DP - d);
    s[r * LDS + d + (i - r * (DP - d))] = from_f32<T>(0.f);
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(128)
    attn_core_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ att, int N, int C,
                          int d, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + QT * LD;  // [stage][k, v][QT * LD]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int C3 = 3 * C;
  const bf16* base = qkv + (size_t)b * N * C3;
  const int nkt = (N + QT - 1) / QT;

  if (VEC && d < DP) zero_pad<bf16, DP, LD>(Qs, 5 * QT, d);  // Q and both stages of K, V
  load_head_tile<bf16, DP, LD, VEC>(Qs, base, qt * QT, N, C3, h * d, d);
  load_head_tile<bf16, DP, LD, VEC>(KV, base, 0, N, C3, C + h * d, d);
  load_head_tile<bf16, DP, LD, VEC>(KV + QT * LD, base, 0, N, C3, 2 * C + h * d, d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) load_a<LD>(qa[ks], Qs, warp * 16, ks * 16, g, t4);

  float oacc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int kt = 0; kt < nkt; ++kt) {
    // tile kt has arrived and the stage of tile kt - 1 is free: the next
    // tile's copy runs under this tile's arithmetic (VEC)
    if (kt > 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (kt + 1 < nkt) {
      bf16* nxt = KV + ((kt + 1) & 1) * 2 * QT * LD;
      load_head_tile<bf16, DP, LD, VEC>(nxt, base, (kt + 1) * QT, N, C3, C + h * d, d);
      load_head_tile<bf16, DP, LD, VEC>(nxt + QT * LD, base, (kt + 1) * QT, N, C3,
                                        2 * C + h * d, d);
      cp_async_commit();
    }
    const bf16* Ks = KV + (kt & 1) * 2 * QT * LD;
    const bf16* Vs = Ks + QT * LD;

    float s[QT / 8][4];
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int kp = 0; kp < DP / 32; ++kp) {
        uint32_t bf[4];
        load_b_rows<LD>(bf, Ks, nt * 8, kp * 32, lane);
        mma_bf16(s[nt], qa[2 * kp], bf[0], bf[1]);
        mma_bf16(s[nt], qa[2 * kp + 1], bf[2], bf[3]);
      }
    const int valid = N - kt * QT;  // keys of this tile that exist
    if (valid < QT) {
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        if (col >= valid) s[nt][0] = s[nt][2] = -INFINITY;
        if (col + 1 >= valid) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }

    // online softmax; rows g (s[.][0..1]) and g + 8 (s[.][2..3])
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha0 = exp2f((mrow[0] - mx[0]) * sl2);
    const float alpha1 = exp2f((mrow[1] - mx[1]) * sl2);
    mrow[0] = mx[0];
    mrow[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[QT / 16][4];
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt) {
      const float p0 = exp2f((s[nt][0] - mx[0]) * sl2);
      const float p1 = exp2f((s[nt][1] - mx[0]) * sl2);
      const float p2 = exp2f((s[nt][2] - mx[1]) * sl2);
      const float p3 = exp2f((s[nt][3] - mx[1]) * sl2);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    lrow[0] = lrow[0] * alpha0 + rs0;
    lrow[1] = lrow[1] * alpha1 + rs1;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      oacc[dt][0] *= alpha0;
      oacc[dt][1] *= alpha0;
      oacc[dt][2] *= alpha1;
      oacc[dt][3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bf[4];
        load_b_cols<LD>(bf, Vs, kk * 16, dp * 16, lane);
        mma_bf16(oacc[2 * dp], pa[kk], bf[0], bf[1]);
        mma_bf16(oacc[2 * dp + 1], pa[kk], bf[2], bf[3]);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
  }
  const float inv[2] = {1.f / lrow[0], 1.f / lrow[1]};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qt * QT + warp * 16 + g + 8 * half;
    if (row >= N) continue;
    bf16* orow = att + ((size_t)b * N + row) * C + h * d;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      const float v0 = oacc[dt][2 * half] * inv[half], v1 = oacc[dt][2 * half + 1] * inv[half];
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(v0, v1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(v0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

constexpr int SP = QT + 1;  // pitch of the 64 x 64 logit tile

template <int DP>
__global__ void __launch_bounds__(256)
    attn_core_f32_kernel(const float* __restrict__ qkv, float* __restrict__ att, int N, int C,
                         int d, float scale) {
  constexpr int P = DP + 1, NJ = DP / 16;
  extern __shared__ __align__(16) float smemf[];
  float* Qs = smemf;
  float* Ks = Qs + QT * P;
  float* Vs = Ks + QT * P;
  float* Ss = Vs + QT * P;
  float* Ms = Ss + QT * SP;  // running maximum, running sum, rescale factor
  float* Lsum = Ms + QT;
  float* Al = Lsum + QT;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int C3 = 3 * C;
  const float* base = qkv + (size_t)b * N * C3;

  load_head_tile<float, DP, P, false>(Qs, base, qt * QT, N, C3, h * d, d);
  if (tid < QT) {
    Ms[tid] = -INFINITY;
    Lsum[tid] = 0.f;
  }
  float oacc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) oacc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += QT) {
    __syncthreads();
    load_head_tile<float, DP, P, false>(Ks, base, k0, N, C3, C + h * d, d);
    load_head_tile<float, DP, P, false>(Vs, base, k0, N, C3, 2 * C + h * d, d);
    __syncthreads();
    float s[4][4] = {};
    gemm_nt<DP, P, P>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * SP + tx + 16 * j] =
            k0 + tx + 16 * j < N ? s[i][j] * scale : -INFINITY;  // ragged last key tile
    __syncthreads();
    {  // four neighbouring lanes share a row, 16 columns each
      const int r = tid >> 2, part = tid & 3;
      float* srow = Ss + r * SP + part * 16;
      const float m_old = Ms[r];
      float mx = m_old;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - mx);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - mx);
        Al[r] = alpha;
        Ms[r] = mx;
        Lsum[r] = Lsum[r] * alpha + sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = Al[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) oacc[i][j] *= alpha;
    }
    gemm_nn<NJ, SP, P>(Ss, Vs, oacc, ty, tx);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = qt * QT + r;
    if (row >= N) continue;
    const float inv = 1.f / Lsum[r];
    float* orow = att + ((size_t)b * N + row) * C + h * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < d) orow[tx + 16 * j] = oacc[i][j] * inv;
  }
}

template <int DP>
constexpr int core_smem_bf16() { return 5 * QT * (DP + 8) * 2; }
template <int DP>
constexpr int core_smem_f32() { return (3 * QT * (DP + 1) + QT * SP + 3 * QT) * 4; }

template <int DP>
int launch_core(const void* qkv, void* att, int B, int N, int C, int heads, int d, bool bf,
                cudaStream_t st) {
  const dim3 grid((N + QT - 1) / QT, heads, B);
  const float scale = 1.f / sqrtf((float)d);
  cudaError_t e;
  if (bf) {
    constexpr int smem = core_smem_bf16<DP>();
    const bool vec = d % 8 == 0 && C % 8 == 0;
    auto kern = vec ? attn_core_bf16_kernel<DP, true> : attn_core_bf16_kernel<DP, false>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, 128, smem, st>>>(static_cast<const bf16*>(qkv), static_cast<bf16*>(att), N, C,
                                   d, scale);
  } else {
    constexpr int smem = core_smem_f32<DP>();
    e = cudaFuncSetAttribute(attn_core_f32_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attn_core_f32_kernel<DP><<<grid, 256, smem, st>>>(static_cast<const float*>(qkv),
                                                      static_cast<float*>(att), N, C, d, scale);
  }
  return (int)cudaGetLastError();
}

template <bool RESID>
int linear_f32(const void* a, const void* w, const void* bias, const void* resid, void* out,
               int M, int K, int O, cudaStream_t st) {
  const LinearF32 p{static_cast<const float*>(a), static_cast<const float*>(w),
                    static_cast<const float*>(bias), static_cast<const float*>(resid),
                    static_cast<float*>(out), M, K, O};
  attn_linear_f32_kernel<RESID><<<dim3((M + FBM - 1) / FBM, (O + FBN - 1) / FBN), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, H, W, C]; wqkv: [3Ci, C]; wproj: [C, Ci] (torch Linear
// layouts), all contiguous in `dtype`; gscale, gbias: [C], bqkv: [3Ci],
// bproj: [C] float32; qkv: [B, H*W, 3Ci] and att: [B, H*W, max(C, Ci)]
// workspaces in `dtype` (att first holds the normalised x). Ci, the width of
// the heads, is C, or under tensor parallelism the rank's heads' share of
// it; without `residual` the block returns proj(attention) alone (a rank's
// partial sum). bf16: the tiling of the two projections (ops/conv3x3.py
// tile_config for C -> 3Ci and Ci -> C: bn, stages and box rows hb of each;
// the box columns wb they share). Requires gn_silu's contract for C and G,
// Ci % heads == 0, Ci / heads <= 128, and for bf16 C % 8 == 0 and Ci % 8 ==
// 0. Any H * W >= 1.
extern "C" int rfv_attention_block(const void* x, const void* gscale, const void* gbias,
                                   const void* wqkv, const void* bqkv, const void* wproj,
                                   const void* bproj, void* qkv, void* att, void* out,
                                   int B, int H, int W, int C, int Ci, int heads, int G,
                                   float eps, int residual, int qkv_bn, int qkv_stages,
                                   int qkv_hb, int proj_bn, int proj_stages, int proj_hb, int wb,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = H * W, M = B * N, d = Ci / heads;
  const bool bf = dtype == RFV_DTYPE_BF16;
  if (d > 128 || Ci % heads || (bf && (C % 8 || Ci % 8))) return (int)cudaErrorInvalidValue;
  // 1: the GroupNorm and the normalised x, rounded, into att
  int e = rfv_gn::forward_dtype<false, false>(x, gscale, gbias, nullptr, att, B, N, C, G, eps,
                                              rfv_gn::Dropout{}, dtype, st);
  if (e) return e;
  // 2: qkv = T(xn W_qkv^T + b)
  e = bf ? rfv_conv::launch_bf16(att, wqkv, bqkv, nullptr, qkv, B, H, W, C, 3 * Ci, 1, qkv_bn,
                                 qkv_stages, wb, qkv_hb, st)
         : linear_f32<false>(att, wqkv, bqkv, nullptr, qkv, M, C, 3 * Ci, st);
  if (e) return e;
  // 3: the core, qkv -> att
  if (d <= 32)
    e = launch_core<32>(qkv, att, B, N, Ci, heads, d, bf, st);
  else if (d <= 64)
    e = launch_core<64>(qkv, att, B, N, Ci, heads, d, bf, st);
  else
    e = launch_core<128>(qkv, att, B, N, Ci, heads, d, bf, st);
  if (e) return e;
  // 4: out = T(x + T(att W_proj^T + b)), or T(att W_proj^T + b)
  const void* resid = residual ? x : nullptr;
  if (bf)
    return rfv_conv::launch_bf16(att, wproj, bproj, resid, out, B, H, W, Ci, C, 1, proj_bn,
                                 proj_stages, wb, proj_hb, st);
  return residual ? linear_f32<true>(att, wproj, bproj, x, out, M, Ci, C, st)
                  : linear_f32<false>(att, wproj, bproj, nullptr, out, M, Ci, C, st);
}
