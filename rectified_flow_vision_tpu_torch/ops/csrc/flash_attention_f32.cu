// Flash attention in float32: forward, dkv and dq, SIMT with exact fp32 FMAs
// (no TF32), for the fp32 model path and the checks of the bf16 kernels
// (flash_attention.cu, which holds the C entry points and the delta pass).
//
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of every 64-wide product (the tile products gemm_nt / gemm_nn /
// gemm_tn of mma.cuh). Tiles of 64 rows sit in shared memory with an odd
// pitch (DP + 1, 65), so the column reads of a warp fall on distinct banks
// and its row reads are broadcasts. The head width D (a multiple of 8, at
// most 128) is zero-padded to DP, the next multiple of 16, on its way into
// shared memory; columns past D are computed as zeros and not stored.
//
// Wider heads (D > 128, a multiple of 8: the fp32 path, and bf16 inputs
// above D = 256 on fp32 copies; bf16 up to 256 has wgmma kernels of its own
// in flash_attention.cu) take the *_wide kernels: D in chunks of 64
// columns. The logits (and dP) are summed over every chunk, one pair of
// 64 x 64 tiles in shared memory at a time, and each block computes one
// 64-column chunk of its output (grid x: row tile x output chunk), so a
// block recomputes the logits for the chunk it writes. Shared memory and
// registers stay those of D = 64 at any D.
#include "flash_attention.cuh"
#include "mma.cuh"

namespace {

using namespace rfv_mma;

constexpr int TILE = 64;      // query rows and key rows per tile
constexpr int SP = TILE + 1;  // pitch of a 64 x 64 logit tile

// 64 rows of D floats at pitch `pitch` into shared rows of pitch DP + 1,
// columns D .. DP - 1 zero.
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* s, const float* gsrc, long long pitch, int D) {
  constexpr int CH = DP / 4;
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x) {
    const int r = c / CH, cc = c - r * CH;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cc * 4 < D) val = *reinterpret_cast<const float4*>(gsrc + (size_t)r * pitch + cc * 4);
    float* d = s + r * (DP + 1) + cc * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int DP>
constexpr int fwd_f32_smem() { return (3 * TILE * (DP + 1) + TILE * SP + 3 * TILE) * 4; }
template <int DP>
constexpr int dkv_f32_smem() { return (4 * TILE * (DP + 1) + 2 * TILE * SP + 2 * TILE) * 4; }
template <int DP>
constexpr int dq_f32_smem() { return (4 * TILE * (DP + 1) + TILE * SP + 2 * TILE) * 4; }

template <int DP>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int T, int H, int D, long long sb, long long st,
                         long long sh, float scale) {
  constexpr int P = DP + 1, NJ = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * P;
  float* Vs = Ks + TILE * P;
  float* Ss = Vs + TILE * P;
  float* Ms = Ss + TILE * SP;  // running maximum, running sum, rescale factor
  float* Lsum = Ms + TILE;
  float* Al = Lsum + TILE;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;

  load_tile_f32<DP>(Qs, q + base + (size_t)qt * TILE * st, st, D);
  if (tid < TILE) {
    Ms[tid] = -INFINITY;
    Lsum[tid] = 0.f;
  }
  float oacc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) oacc[i][j] = 0.f;

  for (int kt = 0; kt < T / TILE; ++kt) {
    __syncthreads();
    load_tile_f32<DP>(Ks, k + base + (size_t)kt * TILE * st, st, D);
    load_tile_f32<DP>(Vs, v + base + (size_t)kt * TILE * st, st, D);
    __syncthreads();
    float s[4][4] = {};
    gemm_nt<DP, P, P>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[(ty + 16 * i) * SP + tx + 16 * j] = s[i][j] * scale;
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
    const int r = ty + 16 * i;
    const float inv = 1.f / Lsum[r];
    float* orow = o + (((size_t)b * T + qt * TILE + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < D) orow[tx + 16 * j] = oacc[i][j] * inv;
  }
  if (tid < TILE)
    lse[((size_t)b * H + h) * T + qt * TILE + tid] = Ms[tid] + logf(Lsum[tid]);
}

template <int DP>
__global__ void __launch_bounds__(256)
    flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_out,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int T, int H, int D,
                         long long sb, long long st, long long sh, long long gb, long long gt,
                         long long gh, float scale) {
  constexpr int P = DP + 1, NJ = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * P;
  float* Qs = Vs + TILE * P;
  float* Gs = Qs + TILE * P;  // d_out
  float* Ps = Gs + TILE * P;
  float* dSs = Ps + TILE * SP;
  float* Ls = dSs + TILE * SP;
  float* Ds = Ls + TILE;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const size_t obase = (size_t)b * T * H * D + (size_t)h * D;
  const long long opitch = (long long)H * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* delta_bh = delta + ((size_t)b * H + h) * T;

  load_tile_f32<DP>(Ks, k + base + (size_t)kt * TILE * st, st, D);
  load_tile_f32<DP>(Vs, v + base + (size_t)kt * TILE * st, st, D);
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int qt = 0; qt < T / TILE; ++qt) {
    __syncthreads();
    load_tile_f32<DP>(Qs, q + base + (size_t)qt * TILE * st, st, D);
    load_tile_f32<DP>(Gs, d_out + obase + (size_t)qt * TILE * opitch, opitch, D);
    if (tid < TILE) {
      Ls[tid] = lse_bh[qt * TILE + tid];
      Ds[tid] = delta_bh[qt * TILE + tid];
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm_nt<DP, P, P>(Qs, Ks, s, ty, tx);   // rows: queries, columns: keys
    gemm_nt<DP, P, P>(Gs, Vs, dp, ty, tx);  // dP[m, n] = dO[m] . V[n]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
      const float l = Ls[m], dl = Ds[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] * scale - l);
        Ps[m * SP + tx + 16 * j] = p;
        dSs[m * SP + tx + 16 * j] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    gemm_tn<NJ, SP, P>(Ps, Gs, dva, ty, tx);   // dV[n, d] += P[m, n] dO[m, d]
    gemm_tn<NJ, SP, P>(dSs, Qs, dka, ty, tx);  // dK[n, d] += dS[m, n] Q[m, d]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)b * gb + (size_t)h * gh + (size_t)(kt * TILE + ty + 16 * i) * gt;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (tx + 16 * j < D) {
        dk[row + tx + 16 * j] = dka[i][j] * scale;
        dv[row + tx + 16 * j] = dva[i][j];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(256)
    flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_out,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int T, int H, int D, long long sb, long long st,
                        long long sh, long long gb, long long gt, long long gh, float scale) {
  constexpr int P = DP + 1, NJ = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * P;  // d_out
  float* Ks = Gs + TILE * P;
  float* Vs = Ks + TILE * P;
  float* dSs = Vs + TILE * P;
  float* Ls = dSs + TILE * SP;
  float* Ds = Ls + TILE;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const size_t obase = (size_t)b * T * H * D + (size_t)h * D;
  const long long opitch = (long long)H * D;

  load_tile_f32<DP>(Qs, q + base + (size_t)qt * TILE * st, st, D);
  load_tile_f32<DP>(Gs, d_out + obase + (size_t)qt * TILE * opitch, opitch, D);
  if (tid < TILE) {
    Ls[tid] = lse[((size_t)b * H + h) * T + qt * TILE + tid];
    Ds[tid] = delta[((size_t)b * H + h) * T + qt * TILE + tid];
  }
  float dqa[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqa[i][j] = 0.f;

  for (int kt = 0; kt < T / TILE; ++kt) {
    __syncthreads();
    load_tile_f32<DP>(Ks, k + base + (size_t)kt * TILE * st, st, D);
    load_tile_f32<DP>(Vs, v + base + (size_t)kt * TILE * st, st, D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm_nt<DP, P, P>(Qs, Ks, s, ty, tx);
    gemm_nt<DP, P, P>(Gs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
      const float l = Ls[m], dl = Ds[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[m * SP + tx + 16 * j] = expf(s[i][j] * scale - l) * (dp[i][j] - dl);
    }
    __syncthreads();
    gemm_nn<NJ, SP, P>(dSs, Ks, dqa, ty, tx);  // dQ[m, d] += dS[m, n] K[n, d]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)b * gb + (size_t)h * gh + (size_t)(qt * TILE + ty + 16 * i) * gt;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < D) dq[row + tx + 16 * j] = dqa[i][j] * scale;
  }
}

// ---- any head width: D in chunks of WC columns ---------------------------

constexpr int WC = 64, WP = WC + 1, WNJ = WC / 16;
constexpr int fwd_wide_smem() { return (3 * TILE * WP + TILE * SP + 3 * TILE) * 4; }
constexpr int dkv_wide_smem() { return (6 * TILE * WP + 2 * TILE) * 4; }
constexpr int dq_wide_smem() { return (5 * TILE * WP + 2 * TILE) * 4; }

// Chunk c (columns c WC .. c WC + 63, zero past D) of 64 rows.
__device__ __forceinline__ void load_chunk(float* s, const float* rows, long long pitch, int D,
                                           int c) {
  load_tile_f32<WC>(s, rows + c * WC, pitch, min(WC, D - c * WC));
}

__global__ void __launch_bounds__(256)
    flash_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o,
                              float* __restrict__ lse, int T, int H, int D, long long sb,
                              long long st, long long sh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * WP;
  float* Vs = Ks + TILE * WP;
  float* Ss = Vs + TILE * WP;
  float* Ms = Ss + TILE * SP;
  float* Lsum = Ms + TILE;
  float* Al = Lsum + TILE;
  const int nc = (D + WC - 1) / WC;
  const int qt = blockIdx.x / nc, oc = blockIdx.x % nc, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const float* qrows = q + base + (size_t)qt * TILE * st;
  if (tid < TILE) {
    Ms[tid] = -INFINITY;
    Lsum[tid] = 0.f;
  }
  float oacc[4][WNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < WNJ; ++j) oacc[i][j] = 0.f;

  for (int kt = 0; kt < T / TILE; ++kt) {
    const float* krows = k + base + (size_t)kt * TILE * st;
    float s[4][4] = {};
    for (int c = 0; c < nc; ++c) {
      __syncthreads();
      load_chunk(Qs, qrows, st, D, c);
      load_chunk(Ks, krows, st, D, c);
      if (c == nc - 1) load_chunk(Vs, v + base + (size_t)kt * TILE * st, st, D, oc);
      __syncthreads();
      gemm_nt<WC, WP, WP>(Qs, Ks, s, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[(ty + 16 * i) * SP + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();
    {  // the online softmax of the D <= 128 kernel
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
      for (int j = 0; j < WNJ; ++j) oacc[i][j] *= alpha;
    }
    gemm_nn<WNJ, SP, WP>(Ss, Vs, oacc, ty, tx);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float inv = 1.f / Lsum[r];
    float* orow = o + (((size_t)b * T + qt * TILE + r) * H + h) * D + oc * WC;
#pragma unroll
    for (int j = 0; j < WNJ; ++j)
      if (oc * WC + tx + 16 * j < D) orow[tx + 16 * j] = oacc[i][j] * inv;
  }
  if (tid < TILE && oc == 0)
    lse[((size_t)b * H + h) * T + qt * TILE + tid] = Ms[tid] + logf(Lsum[tid]);
}

// S and dP summed over the chunks, the output's chunk oc last, so that Q and
// dO (dkv) or K (dq) of that chunk are still in shared memory for the second
// products.
__global__ void __launch_bounds__(256)
    flash_dkv_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ d_out,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, int T, int H,
                              int D, long long sb, long long st, long long sh, long long gb,
                              long long gt, long long gh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * WP;
  float* Qs = Vs + TILE * WP;
  float* Gs = Qs + TILE * WP;
  float* Ps = Gs + TILE * WP;
  float* dSs = Ps + TILE * WP;
  float* Ls = dSs + TILE * WP;
  float* Ds = Ls + TILE;
  const int nc = (D + WC - 1) / WC;
  const int kt = blockIdx.x / nc, oc = blockIdx.x % nc, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const long long opitch = (long long)H * D;
  const float* krows = k + base + (size_t)kt * TILE * st;
  const float* vrows = v + base + (size_t)kt * TILE * st;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* delta_bh = delta + ((size_t)b * H + h) * T;
  float dka[4][WNJ], dva[4][WNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < WNJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int qt = 0; qt < T / TILE; ++qt) {
    const float* qrows = q + base + (size_t)qt * TILE * st;
    const float* grows =
        d_out + (size_t)b * T * opitch + (size_t)h * D + (size_t)qt * TILE * opitch;
    float s[4][4] = {}, dp[4][4] = {};
    for (int i = 1; i <= nc; ++i) {
      const int c = (oc + i) % nc;
      __syncthreads();
      load_chunk(Qs, qrows, st, D, c);
      load_chunk(Ks, krows, st, D, c);
      load_chunk(Gs, grows, opitch, D, c);
      load_chunk(Vs, vrows, st, D, c);
      if (i == 1 && tid < TILE) {
        Ls[tid] = lse_bh[qt * TILE + tid];
        Ds[tid] = delta_bh[qt * TILE + tid];
      }
      __syncthreads();
      gemm_nt<WC, WP, WP>(Qs, Ks, s, ty, tx);
      gemm_nt<WC, WP, WP>(Gs, Vs, dp, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
      const float l = Ls[m], dl = Ds[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] * scale - l);
        Ps[m * WP + tx + 16 * j] = p;
        dSs[m * WP + tx + 16 * j] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    gemm_tn<WNJ, WP, WP>(Ps, Gs, dva, ty, tx);   // dV[n, d] += P[m, n] dO[m, d]
    gemm_tn<WNJ, WP, WP>(dSs, Qs, dka, ty, tx);  // dK[n, d] += dS[m, n] Q[m, d]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)b * gb + (size_t)h * gh + (size_t)(kt * TILE + ty + 16 * i) * gt +
                       oc * WC;
#pragma unroll
    for (int j = 0; j < WNJ; ++j) {
      if (oc * WC + tx + 16 * j < D) {
        dk[row + tx + 16 * j] = dka[i][j] * scale;
        dv[row + tx + 16 * j] = dva[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(256)
    flash_dq_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ d_out,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, int T, int H, int D, long long sb,
                             long long st, long long sh, long long gb, long long gt, long long gh,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * WP;
  float* Ks = Gs + TILE * WP;
  float* Vs = Ks + TILE * WP;
  float* dSs = Vs + TILE * WP;
  float* Ls = dSs + TILE * WP;
  float* Ds = Ls + TILE;
  const int nc = (D + WC - 1) / WC;
  const int qt = blockIdx.x / nc, oc = blockIdx.x % nc, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const long long opitch = (long long)H * D;
  const float* qrows = q + base + (size_t)qt * TILE * st;
  const float* grows = d_out + (size_t)b * T * opitch + (size_t)h * D + (size_t)qt * TILE * opitch;
  if (tid < TILE) {
    Ls[tid] = lse[((size_t)b * H + h) * T + qt * TILE + tid];
    Ds[tid] = delta[((size_t)b * H + h) * T + qt * TILE + tid];
  }
  float dqa[4][WNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < WNJ; ++j) dqa[i][j] = 0.f;

  for (int kt = 0; kt < T / TILE; ++kt) {
    const float* krows = k + base + (size_t)kt * TILE * st;
    const float* vrows = v + base + (size_t)kt * TILE * st;
    float s[4][4] = {}, dp[4][4] = {};
    for (int i = 1; i <= nc; ++i) {
      const int c = (oc + i) % nc;
      __syncthreads();
      load_chunk(Qs, qrows, st, D, c);
      load_chunk(Gs, grows, opitch, D, c);
      load_chunk(Ks, krows, st, D, c);
      load_chunk(Vs, vrows, st, D, c);
      __syncthreads();
      gemm_nt<WC, WP, WP>(Qs, Ks, s, ty, tx);
      gemm_nt<WC, WP, WP>(Gs, Vs, dp, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
      const float l = Ls[m], dl = Ds[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[m * WP + tx + 16 * j] = expf(s[i][j] * scale - l) * (dp[i][j] - dl);
    }
    __syncthreads();
    gemm_nn<WNJ, WP, WP>(dSs, Ks, dqa, ty, tx);  // dQ[m, d] += dS[m, n] K[n, d], chunk oc
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)b * gb + (size_t)h * gh + (size_t)(qt * TILE + ty + 16 * i) * gt +
                       oc * WC;
#pragma unroll
    for (int j = 0; j < WNJ; ++j)
      if (oc * WC + tx + 16 * j < D) dq[row + tx + 16 * j] = dqa[i][j] * scale;
  }
}

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B, int T,
               int H, int D, long long sb, long long st, long long sh, float scale,
               cudaStream_t stream) {
  constexpr int smem = fwd_f32_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_f32_kernel<DP><<<dim3(T / TILE, H, B), 256, smem, stream>>>(q, k, v, o, lse, T, H, D,
                                                                         sb, st, sh, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const float* q, const float* k, const float* v, const float* d_out,
               const float* lse, const float* delta, float* dq, float* dk, float* dv, int B, int T,
               int H, int D, long long sb, long long st, long long sh, long long gb, long long gt,
               long long gh, float scale, cudaStream_t stream) {
  constexpr int smem_dkv = dkv_f32_smem<DP>(), smem_dq = dq_f32_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_f32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_dq_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T / TILE, H, B);
  flash_dkv_f32_kernel<DP><<<grid, 256, smem_dkv, stream>>>(q, k, v, d_out, lse, delta, dk, dv, T,
                                                            H, D, sb, st, sh, gb, gt, gh, scale);
  flash_dq_f32_kernel<DP><<<grid, 256, smem_dq, stream>>>(q, k, v, d_out, lse, delta, dq, T, H, D,
                                                          sb, st, sh, gb, gt, gh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

int rfv_flash::fwd_f32_wide(const float* q, const float* k, const float* v, float* o, float* lse,
                            int B, int T, int H, int D, long long sb, long long st, long long sh,
                            float scale, cudaStream_t stream) {
  constexpr int smem = fwd_wide_smem();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = (D + WC - 1) / WC;
  flash_fwd_f32_wide_kernel<<<dim3(T / TILE * nc, H, B), 256, smem, stream>>>(
      q, k, v, o, lse, T, H, D, sb, st, sh, scale);
  return (int)cudaGetLastError();
}

int rfv_flash::bwd_f32_wide(const float* q, const float* k, const float* v, const float* d_out,
                            const float* lse, const float* delta, float* dq, float* dk, float* dv,
                            int B, int T, int H, int D, long long sb, long long st, long long sh,
                            long long gb, long long gt, long long gh, float scale,
                            cudaStream_t stream) {
  constexpr int smem_dkv = dkv_wide_smem(), smem_dq = dq_wide_smem();
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_f32_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_dq_f32_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  const int nc = (D + WC - 1) / WC;
  const dim3 grid(T / TILE * nc, H, B);
  flash_dkv_f32_wide_kernel<<<grid, 256, smem_dkv, stream>>>(q, k, v, d_out, lse, delta, dk, dv,
                                                             T, H, D, sb, st, sh, gb, gt, gh,
                                                             scale);
  flash_dq_f32_wide_kernel<<<grid, 256, smem_dq, stream>>>(q, k, v, d_out, lse, delta, dq, T, H, D,
                                                           sb, st, sh, gb, gt, gh, scale);
  return (int)cudaGetLastError();
}

#define RFV_F32_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

int rfv_flash::fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse,
                       int B, int T, int H, int D, int dp, long long sb, long long st,
                       long long sh, float scale, cudaStream_t stream) {
  if (D > dp) return (int)cudaErrorInvalidValue;
  switch (dp) {
#define RFV_CASE(W) \
  case W:           \
    return launch_fwd<W>(q, k, v, o, lse, B, T, H, D, sb, st, sh, scale, stream);
    RFV_F32_WIDTHS(RFV_CASE)
#undef RFV_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int rfv_flash::bwd_f32(const float* q, const float* k, const float* v, const float* d_out,
                       const float* lse, const float* delta, float* dq, float* dk, float* dv,
                       int B, int T, int H, int D, int dp, long long sb, long long st,
                       long long sh, long long gb, long long gt, long long gh, float scale,
                       cudaStream_t stream) {
  if (D > dp) return (int)cudaErrorInvalidValue;
  switch (dp) {
#define RFV_CASE(W)                                                                             \
  case W:                                                                                       \
    return launch_bwd<W>(q, k, v, d_out, lse, delta, dq, dk, dv, B, T, H, D, sb, st, sh, gb, gt, \
                         gh, scale, stream);
    RFV_F32_WIDTHS(RFV_CASE)
#undef RFV_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
