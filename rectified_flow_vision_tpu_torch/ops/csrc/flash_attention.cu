// Flash attention, forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU library kernel that the JAX package's DiT calls for
// long sequences (rectified_flow_vision_tpu/models/dit.py _attention ->
// jax.experimental.pallas.ops.tpu.flash_attention: a forward kernel and the
// dq and dkv backward kernels, blocked by _flash_block_sizes): non-causal
// multi-head attention over q, k, v [B, T, H, D] with scale 1/sqrt(D) and an
// fp32 softmax. Nothing of size T^2 ever reaches device memory.
//
// Bound on the H100: operations. A forward call does 4*B*H*T^2*D flops over
// 4*B*T*H*D elements, T flops per element moved (1024 at the DiT-S/2 latent
// shape, above the card's ~295 bf16 flops per byte ridge); the backward does
// 2.5 times the forward's flops.
//
// Layout. q, k and v share one set of element strides (batch, token, head;
// the last axis is contiguous), so the three views of one [B, T, 3, H, D]
// projection are read in place. o and d_out are contiguous [B, T, H, D];
// lse and delta are fp32 [B, H, T]; dq, dk and dv share a second set of
// strides (the backward writes them into one [B, T, 3, H, D] buffer).
//
// Forward: one block per (batch, head, 64 query rows), a loop over 64-key
// tiles; logits, the running maximum and the running sum in fp32; the output
// accumulator is rescaled as the maximum moves and divided by the sum at the
// end, with one rounding. It also writes the per-row log-sum-exp.
//
// Backward: delta = rowsum(d_out * o), then two kernels that recompute the
// probabilities from q, k and the saved log-sum-exp: dkv (one block per key
// tile, loop over query tiles) and dq (one block per query tile, loop over key
// tiles). No atomics: each output element is summed by one thread in a fixed
// order, so two runs give the same bits.
//
// bfloat16: tensor cores through mma.sync m16n8k16 (fp32 accumulate), four
// warps of 16 rows each; the logits' accumulator registers are repacked in
// place as the A operand of the next product, and every B operand comes from
// shared memory through ldmatrix.x4 (transposed where the tile holds the
// product's k index in its rows); the forward copies the next key tile with
// cp.async under the current tile's arithmetic. Probabilities are rounded to
// bf16 (unnormalised) before P V, as the operand of a bf16 product must be.
// The mma.sync, ldmatrix and repacking helpers live in mma.cuh, shared with
// the UNet attention block (attention.cu).
// float32: SIMT, 256 threads with 4 x 4 outputs each, exact fp32 FMAs (no
// TF32), for the fp32 model path and checks. wgmma, TMA and warp
// specialisation are not used yet; they are the way to the card's peak rate.
#include "mma.cuh"

namespace {

constexpr int TILE = 64;  // query rows and key rows per tile, both kernels
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ bf16 ----

using namespace rfv_mma;

// 64 x D bf16 tile from global rows of pitch `pitch` into shared rows of
// pitch D + 8, 16 bytes per cp.async.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* gsrc, long long pitch) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x) {
    const int r = c / CH, cc = c - r * CH;
    cp_async16(s + r * (D + 8) + cc * 8, gsrc + (size_t)r * pitch + cc * 8, 16);
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int T, int H, long long sb, long long st,
                          long long sh, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Qs[TILE * LD];
  __shared__ __align__(16) bf16 KVs[2][2][TILE * LD];  // [stage][k, v]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * sb + (size_t)h * sh;

  load_tile_async<D>(Qs, q + base + (size_t)qt * TILE * st, st);
  cp_async_commit();
  load_tile_async<D>(KVs[0][0], k + base, st);
  load_tile_async<D>(KVs[0][1], v + base, st);
  cp_async_commit();
  cp_async_wait<1>();  // q has arrived; the first key tile may still be in flight
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a<LD>(qa[ks], Qs, warp * 16, ks * 16, g, t4);

  float oacc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int kt = 0; kt < T / TILE; ++kt) {
    // tile kt has arrived, and the stage that held tile kt - 1 is free: the
    // next tile's copy runs under this tile's arithmetic
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < T / TILE) {
      load_tile_async<D>(KVs[(kt + 1) & 1][0], k + base + (size_t)(kt + 1) * TILE * st, st);
      load_tile_async<D>(KVs[(kt + 1) & 1][1], v + base + (size_t)(kt + 1) * TILE * st, st);
      cp_async_commit();
    }
    const bf16* Ks = KVs[kt & 1][0];
    const bf16* Vs = KVs[kt & 1][1];

    float s[TILE / 8][4];
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t bf[4];
        load_b_rows<LD>(bf, Ks, nt * 8, kp * 32, lane);
        mma_bf16(s[nt], qa[2 * kp], bf[0], bf[1]);
        mma_bf16(s[nt], qa[2 * kp + 1], bf[2], bf[3]);
      }

    // online softmax on the raw logits; rows g (s[.][0..1]) and g + 8 (s[.][2..3])
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
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
    uint32_t pa[TILE / 16][4];
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
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
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= alpha0;
      oacc[dt][1] *= alpha0;
      oacc[dt][2] *= alpha1;
      oacc[dt][3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
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
  const int row0 = qt * TILE + warp * 16 + g;
  const float inv0 = 1.f / lrow[0], inv1 = 1.f / lrow[1];
  bf16* o0 = o + (((size_t)b * T + row0) * H + h) * D + 2 * t4;
  bf16* o1 = o0 + (size_t)8 * H * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o0 + dt * 8) = pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + dt * 8) = pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
  if (t4 == 0) {
    float* l = lse + ((size_t)b * H + h) * T + row0;
    l[0] = mrow[0] * scale + logf(lrow[0]);
    l[8] = mrow[1] * scale + logf(lrow[1]);
  }
}

// dk, dv of one 64-key tile. Everything is computed transposed, keys in the
// rows, so that each warp owns 16 keys' accumulators.
template <int D>
__global__ void __launch_bounds__(128)
    flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ d_out,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
                          long long sb, long long st, long long sh, long long gb, long long gt,
                          long long gh, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Ks[TILE * LD];
  __shared__ __align__(16) bf16 Vs[TILE * LD];
  __shared__ __align__(16) bf16 Qs[TILE * LD];
  __shared__ __align__(16) bf16 Gs[TILE * LD];  // d_out
  __shared__ float Ls[TILE], Ds[TILE];
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const size_t obase = (size_t)b * T * H * D + (size_t)h * D;  // o / d_out, contiguous
  const long long opitch = (long long)H * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* delta_bh = delta + ((size_t)b * H + h) * T;

  load_tile_async<D>(Ks, k + base + (size_t)kt * TILE * st, st);
  load_tile_async<D>(Vs, v + base + (size_t)kt * TILE * st, st);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a<LD>(ka[ks], Ks, warp * 16, ks * 16, g, t4);
    load_a<LD>(va[ks], Vs, warp * 16, ks * 16, g, t4);
  }
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int qt = 0; qt < T / TILE; ++qt) {
    __syncthreads();
    load_tile_async<D>(Qs, q + base + (size_t)qt * TILE * st, st);
    load_tile_async<D>(Gs, d_out + obase + (size_t)qt * TILE * opitch, opitch);
    cp_async_commit();
    if (threadIdx.x < TILE) {
      Ls[threadIdx.x] = lse_bh[qt * TILE + threadIdx.x] * kLog2e;
      Ds[threadIdx.x] = delta_bh[qt * TILE + threadIdx.x];
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 queries at a time
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[4];
          load_b_rows<LD>(bf, Qs, kk * 16 + j * 8, kp * 32, lane);
          mma_bf16(sT[j], ka[2 * kp], bf[0], bf[1]);  // S^T[n, m] = sum_d K[n, d] Q[m, d]
          mma_bf16(sT[j], ka[2 * kp + 1], bf[2], bf[3]);
          load_b_rows<LD>(bf, Gs, kk * 16 + j * 8, kp * 32, lane);
          mma_bf16(dpT[j], va[2 * kp], bf[0], bf[1]);  // dP^T[n, m] = sum_d V[n, d] dO[m, d]
          mma_bf16(dpT[j], va[2 * kp + 1], bf[2], bf[3]);
        }
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m0 = kk * 16 + j * 8 + 2 * t4;  // this thread's two query columns
        const float l0 = Ls[m0], l1 = Ls[m0 + 1], d0 = Ds[m0], d1 = Ds[m0 + 1];
        const float p0 = exp2f(sT[j][0] * sl2 - l0), p1 = exp2f(sT[j][1] * sl2 - l1);
        const float p2 = exp2f(sT[j][2] * sl2 - l0), p3 = exp2f(sT[j][3] * sl2 - l1);
        pa[j * 2] = pack_bf16(p0, p1);
        pa[j * 2 + 1] = pack_bf16(p2, p3);
        dsa[j * 2] = pack_bf16(p0 * (dpT[j][0] - d0), p1 * (dpT[j][1] - d1));
        dsa[j * 2 + 1] = pack_bf16(p2 * (dpT[j][2] - d0), p3 * (dpT[j][3] - d1));
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        load_b_cols<LD>(bf, Gs, kk * 16, dp * 16, lane);
        mma_bf16(dva[2 * dp], pa, bf[0], bf[1]);  // dV[n, d] += P^T[n, m] dO[m, d]
        mma_bf16(dva[2 * dp + 1], pa, bf[2], bf[3]);
        load_b_cols<LD>(bf, Qs, kk * 16, dp * 16, lane);
        mma_bf16(dka[2 * dp], dsa, bf[0], bf[1]);  // dK[n, d] += dS^T[n, m] Q[m, d]
        mma_bf16(dka[2 * dp + 1], dsa, bf[2], bf[3]);
      }
    }
  }

  const int row0 = kt * TILE + warp * 16 + g;
  const size_t gbase = (size_t)b * gb + (size_t)h * gh + (size_t)row0 * gt + 2 * t4;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(dk + gbase + dt * 8) =
        pack_bf16(dka[dt][0] * scale, dka[dt][1] * scale);
    *reinterpret_cast<uint32_t*>(dk + gbase + 8 * gt + dt * 8) =
        pack_bf16(dka[dt][2] * scale, dka[dt][3] * scale);
    *reinterpret_cast<uint32_t*>(dv + gbase + dt * 8) = pack_bf16(dva[dt][0], dva[dt][1]);
    *reinterpret_cast<uint32_t*>(dv + gbase + 8 * gt + dt * 8) =
        pack_bf16(dva[dt][2], dva[dt][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ d_out,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int T, int H, long long sb, long long st,
                         long long sh, long long gb, long long gt, long long gh, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Qs[TILE * LD];
  __shared__ __align__(16) bf16 Gs[TILE * LD];  // d_out
  __shared__ __align__(16) bf16 Ks[TILE * LD];
  __shared__ __align__(16) bf16 Vs[TILE * LD];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const size_t obase = (size_t)b * T * H * D + (size_t)h * D;
  const long long opitch = (long long)H * D;

  load_tile_async<D>(Qs, q + base + (size_t)qt * TILE * st, st);
  load_tile_async<D>(Gs, d_out + obase + (size_t)qt * TILE * opitch, opitch);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4], ga[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a<LD>(qa[ks], Qs, warp * 16, ks * 16, g, t4);
    load_a<LD>(ga[ks], Gs, warp * 16, ks * 16, g, t4);
  }
  const int row0 = qt * TILE + warp * 16 + g;
  const size_t stat = ((size_t)b * H + h) * T + row0;
  const float l0 = lse[stat] * kLog2e, l1 = lse[stat + 8] * kLog2e;
  const float d0 = delta[stat], d1 = delta[stat + 8];
  float dqa[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int kt = 0; kt < T / TILE; ++kt) {
    __syncthreads();
    load_tile_async<D>(Ks, k + base + (size_t)kt * TILE * st, st);
    load_tile_async<D>(Vs, v + base + (size_t)kt * TILE * st, st);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[4];
          load_b_rows<LD>(bf, Ks, kk * 16 + j * 8, kp * 32, lane);
          mma_bf16(s[j], qa[2 * kp], bf[0], bf[1]);  // S[m, n] = sum_d Q[m, d] K[n, d]
          mma_bf16(s[j], qa[2 * kp + 1], bf[2], bf[3]);
          load_b_rows<LD>(bf, Vs, kk * 16 + j * 8, kp * 32, lane);
          mma_bf16(dp[j], ga[2 * kp], bf[0], bf[1]);  // dP[m, n] = sum_d dO[m, d] V[n, d]
          mma_bf16(dp[j], ga[2 * kp + 1], bf[2], bf[3]);
        }
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p0 = exp2f(s[j][0] * sl2 - l0), p1 = exp2f(s[j][1] * sl2 - l0);
        const float p2 = exp2f(s[j][2] * sl2 - l1), p3 = exp2f(s[j][3] * sl2 - l1);
        dsa[j * 2] = pack_bf16(p0 * (dp[j][0] - d0), p1 * (dp[j][1] - d0));
        dsa[j * 2 + 1] = pack_bf16(p2 * (dp[j][2] - d1), p3 * (dp[j][3] - d1));
      }
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bf[4];
        load_b_cols<LD>(bf, Ks, kk * 16, dp2 * 16, lane);
        mma_bf16(dqa[2 * dp2], dsa, bf[0], bf[1]);  // dQ[m, d] += dS[m, n] K[n, d]
        mma_bf16(dqa[2 * dp2 + 1], dsa, bf[2], bf[3]);
      }
    }
  }

  const size_t gbase = (size_t)b * gb + (size_t)h * gh + (size_t)row0 * gt + 2 * t4;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(dq + gbase + dt * 8) =
        pack_bf16(dqa[dt][0] * scale, dqa[dt][1] * scale);
    *reinterpret_cast<uint32_t*>(dq + gbase + 8 * gt + dt * 8) =
        pack_bf16(dqa[dt][2] * scale, dqa[dt][3] * scale);
  }
}

// ------------------------------------------------------------------ fp32 ----
//
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of every 64-wide product (the tile products gemm_nt / gemm_nn /
// gemm_tn of mma.cuh). Tiles sit in shared memory with an odd pitch (D + 1,
// 65), so the column reads of a warp fall on distinct banks and its row
// reads are broadcasts.

constexpr int SP = TILE + 1;  // pitch of a 64 x 64 logit tile

template <int D>
__device__ __forceinline__ void load_tile_f32(float* s, const float* gsrc, long long pitch) {
  constexpr int CH = D / 4;
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x) {
    const int r = c / CH, cc = c - r * CH;
    const float4 val = *reinterpret_cast<const float4*>(gsrc + (size_t)r * pitch + cc * 4);
    float* d = s + r * (D + 1) + cc * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D>
constexpr int fwd_f32_smem() { return (3 * TILE * (D + 1) + TILE * SP + 3 * TILE) * 4; }
template <int D>
constexpr int dkv_f32_smem() { return (4 * TILE * (D + 1) + 2 * TILE * SP + 2 * TILE) * 4; }
template <int D>
constexpr int dq_f32_smem() { return (4 * TILE * (D + 1) + TILE * SP + 2 * TILE) * 4; }

template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int T, int H, long long sb, long long st,
                         long long sh, float scale) {
  constexpr int P = D + 1, NJ = D / 16;
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

  load_tile_f32<D>(Qs, q + base + (size_t)qt * TILE * st, st);
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
    load_tile_f32<D>(Ks, k + base + (size_t)kt * TILE * st, st);
    load_tile_f32<D>(Vs, v + base + (size_t)kt * TILE * st, st);
    __syncthreads();
    float s[4][4] = {};
    gemm_nt<D, P, P>(Qs, Ks, s, ty, tx);
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
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = oacc[i][j] * inv;
  }
  if (tid < TILE)
    lse[((size_t)b * H + h) * T + qt * TILE + tid] = Ms[tid] + logf(Lsum[tid]);
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_out,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int T, int H,
                         long long sb, long long st, long long sh, long long gb, long long gt,
                         long long gh, float scale) {
  constexpr int P = D + 1, NJ = D / 16;
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

  load_tile_f32<D>(Ks, k + base + (size_t)kt * TILE * st, st);
  load_tile_f32<D>(Vs, v + base + (size_t)kt * TILE * st, st);
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int qt = 0; qt < T / TILE; ++qt) {
    __syncthreads();
    load_tile_f32<D>(Qs, q + base + (size_t)qt * TILE * st, st);
    load_tile_f32<D>(Gs, d_out + obase + (size_t)qt * TILE * opitch, opitch);
    if (tid < TILE) {
      Ls[tid] = lse_bh[qt * TILE + tid];
      Ds[tid] = delta_bh[qt * TILE + tid];
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm_nt<D, P, P>(Qs, Ks, s, ty, tx);   // rows: queries, columns: keys
    gemm_nt<D, P, P>(Gs, Vs, dp, ty, tx);  // dP[m, n] = dO[m] . V[n]
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
      dk[row + tx + 16 * j] = dka[i][j] * scale;
      dv[row + tx + 16 * j] = dva[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_out,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int T, int H, long long sb, long long st,
                        long long sh, long long gb, long long gt, long long gh, float scale) {
  constexpr int P = D + 1, NJ = D / 16;
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

  load_tile_f32<D>(Qs, q + base + (size_t)qt * TILE * st, st);
  load_tile_f32<D>(Gs, d_out + obase + (size_t)qt * TILE * opitch, opitch);
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
    load_tile_f32<D>(Ks, k + base + (size_t)kt * TILE * st, st);
    load_tile_f32<D>(Vs, v + base + (size_t)kt * TILE * st, st);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm_nt<D, P, P>(Qs, Ks, s, ty, tx);
    gemm_nt<D, P, P>(Gs, Vs, dp, ty, tx);
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
    for (int j = 0; j < NJ; ++j) dq[row + tx + 16 * j] = dqa[i][j] * scale;
  }
}

// delta[b, h, t] = sum_d d_out[b, t, h, d] * o[b, t, h, d]; one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_out,
                       float* __restrict__ delta, long long rows, int Tn, int H, int D) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * D;
  const T* grow = d_out + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(to_f32(orow[d]), to_f32(grow[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long bt = row / H;
    const int h = (int)(row - bt * H);
    const long long b = bt / Tn;
    const int t = (int)(bt - b * Tn);
    delta[(b * H + h) * Tn + t] = sum;
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int T,
               int H, long long sb, long long st, long long sh, float scale, int dtype,
               cudaStream_t stream) {
  const dim3 grid(T / TILE, H, B);
  if (dtype == RFV_DTYPE_BF16) {
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, T, H, sb, st, sh, scale);
  } else {
    constexpr int smem = fwd_f32_smem<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32_kernel<D><<<grid, 256, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, T, H, sb, st, sh, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_out,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int T, int H,
               long long sb, long long st, long long sh, long long gb, long long gt,
               long long gh, float scale, int dtype, cudaStream_t stream) {
  const long long rows = (long long)B * T * H;
  const unsigned dgrid = (unsigned)((rows + 7) / 8);
  const dim3 grid(T / TILE, H, B);
  if (dtype == RFV_DTYPE_BF16) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *gob = static_cast<const bf16*>(d_out);
    flash_delta_kernel<bf16><<<dgrid, 256, 0, stream>>>(static_cast<const bf16*>(o), gob, delta,
                                                        rows, T, H, D);
    flash_dkv_bf16_kernel<D><<<grid, 128, 0, stream>>>(
        qb, kb, vb, gob, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, sb,
        st, sh, gb, gt, gh, scale);
    flash_dq_bf16_kernel<D><<<grid, 128, 0, stream>>>(qb, kb, vb, gob, lse, delta,
                                                      static_cast<bf16*>(dq), T, H, sb, st, sh,
                                                      gb, gt, gh, scale);
  } else {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *gof = static_cast<const float*>(d_out);
    constexpr int smem_dkv = dkv_f32_smem<D>(), smem_dq = dq_f32_smem<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_dq_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (err != cudaSuccess) return (int)err;
    flash_delta_kernel<float><<<dgrid, 256, 0, stream>>>(static_cast<const float*>(o), gof,
                                                         delta, rows, T, H, D);
    flash_dkv_f32_kernel<D><<<grid, 256, smem_dkv, stream>>>(
        qf, kf, vf, gof, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), T, H, sb,
        st, sh, gb, gt, gh, scale);
    flash_dq_f32_kernel<D><<<grid, 256, smem_dq, stream>>>(qf, kf, vf, gof, lse, delta,
                                                           static_cast<float*>(dq), T, H, sb, st,
                                                           sh, gb, gt, gh, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, T, H, D] in `dtype` with element strides (sb, st, sh) and a
// contiguous last axis; o: [B, T, H, D] contiguous; lse: [B, H, T] float32.
// Requires T % 64 == 0, D in {32, 64}, B, H <= 65535, 16-byte aligned rows.
extern "C" int rfv_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int T, int H, int D, long long sb,
                                       long long st, long long sh, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64) return launch_fwd<64>(q, k, v, o, l, B, T, H, sb, st, sh, scale, dtype, s);
  if (D == 32) return launch_fwd<32>(q, k, v, o, l, B, T, H, sb, st, sh, scale, dtype, s);
  return (int)cudaErrorInvalidValue;
}

// As above, plus d_out: [B, T, H, D] contiguous, delta: [B, H, T] float32
// scratch, and dq, dk, dv: [B, T, H, D] in `dtype` with element strides
// (gb, gt, gh) and a contiguous last axis. Three launches: delta, dkv, dq.
extern "C" int rfv_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* d_out, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int T,
                                       int H, int D, long long sb, long long st, long long sh,
                                       long long gb, long long gt, long long gh, float scale,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D == 64)
    return launch_bwd<64>(q, k, v, o, d_out, l, dl, dq, dk, dv, B, T, H, sb, st, sh, gb, gt, gh,
                          scale, dtype, s);
  if (D == 32)
    return launch_bwd<32>(q, k, v, o, d_out, l, dl, dq, dk, dv, B, T, H, sb, st, sh, gb, gt, gh,
                          scale, dtype, s);
  return (int)cudaErrorInvalidValue;
}
