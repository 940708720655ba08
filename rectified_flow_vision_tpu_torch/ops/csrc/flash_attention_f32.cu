// Flash attention in float32: forward, dkv and dq, for the fp32 model path
// and the checks of the bf16 kernels (flash_attention.cu, which holds the C
// entry points and the delta pass). In fp32 they replace the Pallas TPU
// library kernel that the JAX package's DiT calls
// (rectified_flow_vision_tpu/models/dit.py _attention; flash_attention.cu).
//
// Up to D = 128 (D a multiple of 8, compiled at every multiple of 8): the
// forward here, dkv and dq in flash_attention_f32_bwd.cu, helpers in
// flash_f32_tc.cuh. Every product is fp32-accurate on the tensor cores by
// the 3xTF32 split of mma.cuh (mma.sync m16n8k8, fp32 accumulators). A call
// does 4 B H T^2 D flops forward and 2.5 times that backward; each product is
// three TF32 products, so the bound is 3 x flops / 495 TFLOP/s (against
// flops / 67 TFLOP/s on the CUDA cores). The design:
//  - A block has 8 warps. A warp owns 16 rows of the operand that stays
//    (queries in the forward and dq, keys in dkv) as the M side of its
//    products; the block loops over the other rows in tiles.
//  - Every operand sits in shared memory as fp32 rows of pitch DP + 4 (4 mod
//    8 words): the 8 rows x 16 bytes of an ldmatrix fall on 8 distinct bank
//    groups, and a warp's scalar reads of rows 2t, 2t + 1 at column g on 32
//    distinct banks. Tiles arrive by cp.async, the next in flight while this
//    one is used (two stages); columns at or past D are zero-filled and add
//    nothing.
//  - First products (S = Q K^T, dP = dO V^T and their transposes) read both
//    operands by ldmatrix. Second products (P V, dS K, P^T dO, dS^T Q) take A
//    from the first product's accumulator as it lies in the registers: the
//    sum index is permuted within each 8-step (A's column t is the key 2t,
//    t + 4 is 2t + 1), so c0..c3 are a0, a2, a1, a3 and B reads rows 2t and
//    2t + 1 of its tile. No shuffle and no round trip through shared memory.
//  - Every B operand comes from a streamed tile, which is split into hi and
//    lo once, when it has landed (hi in place, lo in a buffer of the same
//    layout: two cvt.rna and a subtraction a value, one barrier), so that
//    the 8 warps that read it load both halves and split nothing. A operands
//    (the warp's own rows, and the first product's accumulator) are split in
//    registers, once for all the n-tiles they meet. Splitting every fragment
//    in registers instead was slower on an H100 (the split's ALU work, done
//    by each of the 8 warps; PERF.md).
//  - The tensor cores round their sums toward zero, relative to the
//    accumulator, so a long run of products into one accumulator piles up a
//    bias (3 x T / 8 products into O, dQ, dK, dV: 384 at T = 1024, up to 9
//    times the plain fp32 version's error against float64). Each product
//    keeps the two small terms and the large one in separate accumulators,
//    and a second product is summed over one tile in fresh accumulators of
//    four n-tiles, added to the output in fp32.
//  - One block of 8 warps an SM: the registers are not capped (no spill).
//  - Forward: 128 queries a block; keys in tiles of 64 (32 from DP = 112,
//    where two stages of 64 and their lo halves do not fit). The online
//    softmax runs on the accumulator registers: row maxima by two quad
//    shuffles; each lane keeps its part of the row sum, summed across the
//    quad once at the end.
//  - Backward: dkv (64 keys a block, K and V resident, Q, dO, lse and delta
//    streamed in tiles of 64 queries, 32 from DP = 104; warps 0-3 compute
//    S^T and P^T and sum dV += P^T dO, warps 4-7 compute dP^T, read P^T from
//    shared memory, form dS^T and sum dK += dS^T Q, so a warp holds one
//    output) and dq (128 queries a block, Q and dO resident, K and V streamed
//    in tiles of 64 keys, 32 from DP = 88, 16 at 128; S, dP, dQ += dS K).
//    Both compute S and dP: seven products of a tile pair where the bound
//    counts five. Each output element is summed by one thread in a fixed
//    order: two runs give the same bits.
//
// Wider heads (D > 128, a multiple of 8: the fp32 path; bf16 has wgmma
// kernels of its own at every width, flash_attention.cu and
// flash_attention_streamed.cu) take the *_wide kernels below: a block owns
// every output column of its 64 rows (up to D = 256; above it the fewest
// chunks of at most 256 columns), so each logit is computed once for each
// output block, with register-tiled SIMT products (exact fp32 FMAs) and
// cp.async double buffering.
#include "flash_attention.cuh"
#include "flash_f32_tc.cuh"

namespace {

namespace tc = rfv_flash_tc;

// ---- D <= 128: the 3xTF32 forward ------------------------------------------

constexpr int FWD_ROWS = 16 * tc::WARPS;  // queries a block

// Q, two stages of K and V tiles of `keys` rows, and the lo halves of one
template <int DP>
__host__ __device__ constexpr int fwd_smem_at(int keys) {
  return (FWD_ROWS + 6 * keys) * tc::pitch<DP>() * 4;
}
template <int DP>
__host__ __device__ constexpr int fwd_keys() { return fwd_smem_at<DP>(64) <= tc::SMEM_MAX ? 64 : 32; }
template <int DP>
constexpr int fwd_tc_smem() { return fwd_smem_at<DP>(fwd_keys<DP>()); }

template <int DP>
__global__ void __launch_bounds__(tc::THREADS, 1)
    flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int T, int H, int D, long long sb, long long st,
                          long long sh, float scale) {
  constexpr int P = tc::pitch<DP>(), KS = DP / 8, FK = fwd_keys<DP>(), NT = FK / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // 128 queries
  float* ring = qs + FWD_ROWS * P;     // 2 stages: K, V tiles of FK keys
  float* lo = ring + 4 * FK * P;       // lo halves of this tile's K, V
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * sb + (size_t)h * sh;

  tc::tile<DP>(qs, q + base + (size_t)qt * FWD_ROWS * st, st, FWD_ROWS, D);
  auto issue = [&](int kt, int stage) {
    float* ks = ring + stage * 2 * FK * P;
    const size_t r = base + (size_t)kt * FK * st;
    tc::tile<DP>(ks, k + r, st, FK, D);
    tc::tile<DP>(ks + FK * P, v + r, st, FK, D);
  };

  float oacc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const float* qa = qs + warp * 16 * P + tc::a_lane(lane, P);
  const int bo = tc::b_lane(lane, P), to = tc::t_lane(lane, P);
  const int nk = T / FK;
  issue(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < nk) issue(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    float* ks = ring + (kt & 1) * 2 * FK * P;
    tc::split_tile<DP>(ks, lo, 2 * FK);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    tc::nt<DP, NT>(s, qa, ks + bo, lo + bo);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];
    tc::nn<DP, NT, KS>(oacc, s, ks + FK * P + to, lo + FK * P + to);  // O += P V
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = qt * FWD_ROWS + warp * 16 + (lane >> 2);
  float* orow = o + (((size_t)b * T + row) * H + h) * D;
  tc::store<DP>(oacc, orow, orow + (size_t)8 * H * D, lane, 1.f / l[0], 1.f / l[1], D);
  if ((lane & 3) == 0) {
    float* lrow = lse + ((size_t)b * H + h) * T + row;
    lrow[0] = m[0] + logf(l[0]);
    lrow[8] = m[1] + logf(l[1]);
  }
}

// ---- above D = 128: every output column of a block's rows -----------------
//
// A block owns 64 rows (queries in the forward and dq, keys in dkv) and one
// chunk of CW output columns: all of them up to D = 256 (the forward up to
// 384), else the fewest chunks of at most 256 (384) (chunk_width). The logits (and dP) are
// summed over D in panels of 32 columns, so a block computes each logit once
// for its chunk. Every operand moves into shared memory by cp.async, one
// panel ahead of the products, in two slots a kind (panels of the first
// products; rows of the second products' B operand). Products are
// register-tiled: a thread holds 4 x 8 (forward logits, 128 keys a tile) or
// 8 x 4 (backward logits) outputs and 4 or 8 rows x CW / 16 columns of the
// output chunk, fed by 16-byte loads from rows of pitch 36 (= 4 mod 32,
// so the eight threads of a quarter-warp that read eight rows hit eight
// bank groups) and by broadcasts.

constexpr int TILE = 64;       // rows of a block
constexpr int PAN = 32;        // columns of D a first-product panel holds
constexpr int PP = PAN + 4;    // its row pitch
constexpr int FK = 128;        // keys of a forward tile
constexpr int YR = 16;         // rows of a second-product panel
constexpr int XP = TILE + 4;   // pitch of a backward 64 x 64 logit tile

template <int CW>
constexpr int fwd_wide_smem() {
  return (2 * (TILE + FK) * PP + TILE * (FK + 4) + 2 * PAN * (CW + 4)) * 4;
}
template <int CW>
constexpr int bwd_wide_smem() {
  return (2 * 4 * TILE * PP + 2 * TILE * XP + 2 * 2 * YR * (CW + 4) + 2 * TILE) * 4;
}

// rows x width floats from rows of a global tensor (row r at src + r * stride,
// columns col0 ..) into shared rows of pitch `pitch`, by cp.async, 16 bytes a
// copy; columns at or past D are zero-filled (D is a multiple of 4).
__device__ __forceinline__ void panel(float* dst, int pitch, const float* src, long long stride,
                                      int rows, int width, int col0, int D) {
  const int per = width / 4;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = col0 + 4 * (i - r * per);
    const bool in = c < D;
    cp_async16(dst + r * pitch + (c - col0), src + r * stride + (in ? c : 0), in ? 16 : 0);
  }
}

// acc[i][j] += sum_d a[r_i][d] b[n_j][d] over a panel of PAN columns (rows of
// pitch PP): r_i = r0 + rs i (R rows), n_j = tx + 16 j (N columns); VEC
// columns of d a load (VEC = 4: one float4 of each row).
template <int R, int N, int VEC>
__device__ __forceinline__ void panel_nt(const float* a, const float* b, float (&acc)[R][N],
                                         int r0, int rs, int tx) {
#pragma unroll 2
  for (int d = 0; d < PAN; d += VEC) {
    float av[R][VEC], bv[N][VEC];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if constexpr (VEC == 4) {
        const float4 x = *reinterpret_cast<const float4*>(a + (r0 + rs * i) * PP + d);
        av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(a + (r0 + rs * i) * PP + d);
        av[i][0] = x.x; av[i][1] = x.y;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (VEC == 4) {
        const float4 x = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * PP + d);
        bv[j][0] = x.x; bv[j][1] = x.y; bv[j][2] = x.z; bv[j][3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(b + (tx + 16 * j) * PP + d);
        bv[j][0] = x.x; bv[j][1] = x.y;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
  }
}

// acc[i][4 j + e] += sum_m x[r_i][m0 + m] y[m][4 tx + 64 j + e] over the YR
// rows m of a panel y (pitch CW + 4), x of pitch xp: r_i = r0 + rs i.
template <int R, int CW>
__device__ __forceinline__ void panel_nn(const float* x, int xp, int m0, const float* y,
                                         float (&acc)[R][CW / 16], int r0, int rs, int tx) {
#pragma unroll 2
  for (int m = 0; m < YR; m += 4) {
    float xv[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(x + (r0 + rs * i) * xp + m0 + m);
      xv[i][0] = v.x; xv[i][1] = v.y; xv[i][2] = v.z; xv[i][3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < CW / 64; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(y + (m + e) * (CW + 4) + 4 * tx + 64 * j);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][4 * j] = fmaf(xv[i][e], v.x, acc[i][4 * j]);
          acc[i][4 * j + 1] = fmaf(xv[i][e], v.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(xv[i][e], v.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(xv[i][e], v.w, acc[i][4 * j + 3]);
        }
      }
    }
  }
}

// Rows r_i = r0 + rs i of a chunk accumulator, times mul, stored at row
// pointer dst(r_i) + 4 tx + 64 j, columns at or past dlim not stored.
template <int R, int CW, typename RowPtr>
__device__ __forceinline__ void store_chunk(const float (&acc)[R][CW / 16], RowPtr dst, int r0,
                                            int rs, int tx, float mul, int dlim) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float* row = dst(r0 + rs * i);
#pragma unroll
    for (int j = 0; j < CW / 64; ++j) {
      const int col = 4 * tx + 64 * j;
      if (col < dlim)
        *reinterpret_cast<float4*>(row + col) =
            make_float4(acc[i][4 * j] * mul, acc[i][4 * j + 1] * mul, acc[i][4 * j + 2] * mul,
                        acc[i][4 * j + 3] * mul);
    }
  }
}

// Forward: 64 query rows a block, 128 keys a tile, one chunk of O. Thread
// (ty, tx) of 16 x 16 holds S of rows ty + 16 i (4) and keys tx + 16 j (8),
// and O of the same rows at columns 4 tx + 64 j + {0..3} of the chunk. The
// online softmax runs on the registers (row maxima and sums across the 16
// lanes of a row), P goes to shared memory for P V.
template <int CW>
__global__ void __launch_bounds__(256, 1)
    flash_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o,
                              float* __restrict__ lse, int T, int H, int D, int nc, long long sb,
                              long long st, long long sh, float scale) {
  constexpr int PS = FK + 4, VP = CW + 4, NJ = CW / 16;
  extern __shared__ __align__(16) float smem[];
  float* sbuf = smem;                        // 2 slots: Q panel (64 rows), K panel (128 rows)
  float* ps = sbuf + 2 * (TILE + FK) * PP;   // P, 64 x 128
  float* vbuf = ps + TILE * PS;              // 2 slots: 32 rows of V's chunk
  const int qt = blockIdx.x / nc, oc = blockIdx.x % nc, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const float* qrows = q + base + (size_t)qt * TILE * st;
  const int np = (D + PAN - 1) / PAN, nk = T / FK, c0 = oc * CW;

  auto issue_s = [&](int kt, int p, int slot) {
    float* dst = sbuf + slot * (TILE + FK) * PP;
    panel(dst, PP, qrows, st, TILE, PAN, p * PAN, D);
    panel(dst + TILE * PP, PP, k + base + (size_t)kt * FK * st, st, FK, PAN, p * PAN, D);
  };
  auto issue_v = [&](int kt, int vp, int slot) {
    panel(vbuf + slot * PAN * VP, VP, v + base + (size_t)(kt * FK + vp * PAN) * st, st, PAN, CW,
          c0, D);
  };

  float oacc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) oacc[i][j] = 0.f;
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
  }

  int ss = 0, vs = 0;
  issue_s(0, 0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int p = 0; p < np; ++p) {
      if (p + 1 < np)
        issue_s(kt, p + 1, ss ^ 1);
      else
        issue_v(kt, 0, vs);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* sl = sbuf + ss * (TILE + FK) * PP;
      panel_nt<4, 8, 4>(sl, sl + TILE * PP, s, ty, 16, tx);
      __syncthreads();
      ss ^= 1;
    }
    // online softmax of rows ty + 16 i over these 128 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = mrow[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] *= scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pv = expf(s[i][j] - mx);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(mrow[i] - mx);
      mrow[i] = mx;
      lrow[i] = lrow[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) oacc[i][j] *= alpha;
    }
    for (int vp = 0; vp < FK / PAN; ++vp) {
      if (vp + 1 < FK / PAN)
        issue_v(kt, vp + 1, vs ^ 1);
      else if (kt + 1 < nk)
        issue_s(kt + 1, 0, ss);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* vl = vbuf + vs * PAN * VP;
#pragma unroll
      for (int half = 0; half < PAN / YR; ++half)
        panel_nn<4, CW>(ps, PS, vp * PAN + half * YR, vl + half * YR * VP, oacc, ty, 16, tx);
      __syncthreads();
      vs ^= 1;
    }
  }
  cp_async_wait<0>();

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / lrow[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = o + (((size_t)b * T + qt * TILE + ty + 16 * i) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < CW / 64; ++j) {
      const int col = 4 * tx + 64 * j;
      if (c0 + col < D)
        *reinterpret_cast<float4*>(row + col) =
            make_float4(oacc[i][4 * j] * inv[i], oacc[i][4 * j + 1] * inv[i],
                        oacc[i][4 * j + 2] * inv[i], oacc[i][4 * j + 3] * inv[i]);
    }
  }
  if (oc == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lse[((size_t)b * H + h) * T + qt * TILE + ty + 16 * i] = mrow[i] + logf(lrow[i]);
  }
}

// Backward, dkv (DKV) or dq: 64 fixed rows a block (keys; queries), one chunk
// of the output, a loop over the other rows in tiles of 64 (queries; keys).
// Threads split in two groups of 128 (g = 0, 1), (ty, tx) of 8 x 16 within a
// group. The first products: group 0 X = A0 B0^T, group 1 X = A1 B1^T over D
// (dkv: S^T = K Q^T and dP^T = V dO^T; dq: S = Q K^T and dP = dO V^T), a
// thread holding rows ty + 8 i (8) and columns tx + 16 j (4). Group 0 writes
// P (P^T) to shared memory, group 1 reads it and writes dS (dS^T). The second
// products: dkv, group 0 dV += P^T dO and group 1 dK += dS^T Q, each 64 rows
// x CW (rows ty + 8 i, 8 x CW / 16 a thread); dq, dQ += dS K, group g rows
// 32 g + ty + 8 i (4 x CW / 16). Each output element is summed by one thread
// in a fixed order: two runs give the same bits.
template <int CW, bool DKV>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ d_out,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ out0, float* __restrict__ out1, int T, int H,
                              int D, int nc, long long sb, long long st, long long sh,
                              long long gb, long long gt, long long gh, float scale) {
  constexpr int R2 = DKV ? 8 : 4, NJ = CW / 16, YP = CW + 4;
  extern __shared__ __align__(16) float smem[];
  float* sbuf = smem;                 // 2 slots: A0, B0, A1, B1 panels of 64 rows
  float* pt = sbuf + 2 * 4 * TILE * PP;  // P (dq) or P^T (dkv), 64 x 64
  float* dst_ = pt + TILE * XP;       // dS or dS^T
  float* ybuf = dst_ + TILE * XP;     // 2 slots: 16 rows of the chunk, two operands (dkv)
  float* stats = ybuf + 2 * 2 * YR * YP;  // dkv: lse, delta of the query tile
  const int ft = blockIdx.x / nc, oc = blockIdx.x % nc, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, g = tid >> 7, ty = (tid & 127) >> 4, tx = tid & 15;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const long long op = (long long)H * D;  // d_out: contiguous
  const size_t obase = (size_t)b * T * op + (size_t)h * D;
  const int np = (D + PAN - 1) / PAN, n = T / TILE, c0 = oc * CW;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* delta_bh = delta + ((size_t)b * H + h) * T;
  // fixed rows: dkv K (A0) and V (A1); dq Q (A0) and dO (A1)
  const float* a0 = (DKV ? k : q) + base + (size_t)ft * TILE * st;
  const float* a1 = DKV ? v + base + (size_t)ft * TILE * st : d_out + obase + (size_t)ft * TILE * op;
  const long long a1s = DKV ? st : op;

  auto issue_s = [&](int ot, int p, int slot) {  // ot: the other rows' tile
    float* dst = sbuf + slot * 4 * TILE * PP;
    const float* b0 = (DKV ? q : k) + base + (size_t)ot * TILE * st;
    const float* b1 = DKV ? d_out + obase + (size_t)ot * TILE * op : v + base + (size_t)ot * TILE * st;
    panel(dst, PP, a0, st, TILE, PAN, p * PAN, D);
    panel(dst + TILE * PP, PP, b0, st, TILE, PAN, p * PAN, D);
    panel(dst + 2 * TILE * PP, PP, a1, a1s, TILE, PAN, p * PAN, D);
    panel(dst + 3 * TILE * PP, PP, b1, DKV ? op : st, TILE, PAN, p * PAN, D);
  };
  auto issue_y = [&](int ot, int yp, int slot) {  // rows ot * 64 + yp * 16 ..
    float* dst = ybuf + slot * 2 * YR * YP;
    const size_t r = (size_t)ot * TILE + yp * YR;
    if (DKV) {  // dO (for dV) and Q (for dK)
      panel(dst, YP, d_out + obase + r * op, op, YR, CW, c0, D);
      panel(dst + YR * YP, YP, q + base + r * st, st, YR, CW, c0, D);
    } else {  // K
      panel(dst, YP, k + base + r * st, st, YR, CW, c0, D);
    }
  };

  float acc[R2][NJ];
#pragma unroll
  for (int i = 0; i < R2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  // dq: lse (group 0) or delta (group 1) of this thread's 8 query rows
  float rowstat[8];
  if (!DKV) {
#pragma unroll
    for (int i = 0; i < 8; ++i) rowstat[i] = (g == 0 ? lse_bh : delta_bh)[ft * TILE + ty + 8 * i];
  }

  int ss = 0, ys = 0;
  issue_s(0, 0, 0);
  cp_async_commit();
  for (int ot = 0; ot < n; ++ot) {
    if (DKV && tid < 2 * TILE)
      stats[tid] = (tid < TILE ? lse_bh : delta_bh)[ot * TILE + (tid & (TILE - 1))];
    float x[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
    for (int p = 0; p < np; ++p) {
      if (p + 1 < np)
        issue_s(ot, p + 1, ss ^ 1);
      else
        issue_y(ot, 0, ys);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* sl = sbuf + ss * 4 * TILE * PP + g * 2 * TILE * PP;
      panel_nt<8, 4, DKV ? 2 : 4>(sl, sl + TILE * PP, x, ty, 8, tx);
      __syncthreads();
      ss ^= 1;
    }
    // P (P^T) from group 0's logits, then dS (dS^T) from group 1's dP (dP^T)
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float l = DKV ? stats[tx + 16 * j] : rowstat[i];
          pt[(ty + 8 * i) * XP + tx + 16 * j] = expf(x[i][j] * scale - l);
        }
    }
    __syncthreads();
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dl = DKV ? stats[TILE + tx + 16 * j] : rowstat[i];
          const int at = (ty + 8 * i) * XP + tx + 16 * j;
          dst_[at] = pt[at] * (x[i][j] - dl);
        }
    }
    for (int yp = 0; yp < TILE / YR; ++yp) {
      if (yp + 1 < TILE / YR)
        issue_y(ot, yp + 1, ys ^ 1);
      else if (ot + 1 < n)
        issue_s(ot + 1, 0, ss);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* yl = ybuf + ys * 2 * YR * YP;
      if (DKV)  // group 0: dV += P^T dO; group 1: dK += dS^T Q
        panel_nn<R2, CW>(g == 0 ? pt : dst_, XP, yp * YR, yl + g * YR * YP, acc, ty, 8, tx);
      else  // dQ += dS K, group g's 32 rows
        panel_nn<R2, CW>(dst_, XP, yp * YR, yl, acc, 32 * g + ty, 8, tx);
      __syncthreads();
      ys ^= 1;
    }
  }
  cp_async_wait<0>();

  const size_t obase2 = (size_t)b * gb + (size_t)h * gh + (size_t)ft * TILE * gt + c0;
  if (DKV) {  // out0 = dk, out1 = dv
    float* dstp = (g == 0 ? out1 : out0) + obase2;
    store_chunk<R2, CW>(acc, [&](int r) { return dstp + (size_t)r * gt; }, ty, 8, tx,
                        g == 0 ? 1.f : scale, D - c0);
  } else {  // out0 = dq
    float* dstp = out0 + obase2;
    store_chunk<R2, CW>(acc, [&](int r) { return dstp + (size_t)r * gt; }, 32 * g + ty, 8, tx,
                        scale, D - c0);
  }
}

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B, int T,
               int H, int D, long long sb, long long st, long long sh, float scale,
               cudaStream_t stream) {
  constexpr int smem = fwd_tc_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tf32_kernel<DP><<<dim3(T / FWD_ROWS, H, B), tc::THREADS, smem, stream>>>(
      q, k, v, o, lse, T, H, D, sb, st, sh, scale);
  return (int)cudaGetLastError();
}

// Output chunks of a head width D > 128, at most `widest` columns each: nc =
// ceil(D / widest), each of CW = 64 ceil(D / 64 / nc) columns. O and dQ take
// up to 384 columns a block (4 rows x 24 columns a thread), dK and dV up to
// 256 (8 rows x 16 columns a thread).
constexpr int WIDEST = 384, DKV_WIDEST = 256;
inline int chunk_count(int D, int widest) { return (D + widest - 1) / widest; }
inline int chunk_width(int D, int widest) {
  const int nb = (D + 63) / 64, nc = chunk_count(D, widest);
  return 64 * ((nb + nc - 1) / nc);
}

template <int CW>
int launch_fwd_wide(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                    int T, int H, int D, long long sb, long long st, long long sh, float scale,
                    cudaStream_t stream) {
  constexpr int smem = fwd_wide_smem<CW>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_wide_kernel<CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = chunk_count(D, WIDEST);
  flash_fwd_f32_wide_kernel<CW><<<dim3(T / TILE * nc, H, B), 256, smem, stream>>>(
      q, k, v, o, lse, T, H, D, nc, sb, st, sh, scale);
  return (int)cudaGetLastError();
}

template <int CW, bool DKV>
int launch_bwd_wide(const float* q, const float* k, const float* v, const float* d_out,
                    const float* lse, const float* delta, float* out0, float* out1, int B, int T,
                    int H, int D, long long sb, long long st, long long sh, long long gb,
                    long long gt, long long gh, float scale, cudaStream_t stream) {
  constexpr int smem = bwd_wide_smem<CW>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_wide_kernel<CW, DKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = chunk_count(D, DKV ? DKV_WIDEST : WIDEST);
  flash_bwd_f32_wide_kernel<CW, DKV><<<dim3(T / TILE * nc, H, B), 256, smem, stream>>>(
      q, k, v, d_out, lse, delta, out0, out1, T, H, D, nc, sb, st, sh, gb, gt, gh, scale);
  return (int)cudaGetLastError();
}

// The *_wide kernel of chunk width CW for D (a runtime switch over the
// compiled widths).
#define RFV_WIDE_CASES(CALL) \
  case 192:                 \
    return CALL(192);       \
  case 256:                 \
    return CALL(256);       \
  case 320:                 \
    return CALL(320);       \
  default:                  \
    return CALL(384);

}  // namespace

int rfv_flash::fwd_f32_wide(const float* q, const float* k, const float* v, float* o, float* lse,
                            int B, int T, int H, int D, long long sb, long long st, long long sh,
                            float scale, cudaStream_t stream) {
  if (D <= 128 || D % 8) return (int)cudaErrorInvalidValue;
#define RFV_FWD(W) launch_fwd_wide<W>(q, k, v, o, lse, B, T, H, D, sb, st, sh, scale, stream)
  switch (chunk_width(D, WIDEST)) { RFV_WIDE_CASES(RFV_FWD) }
#undef RFV_FWD
}

int rfv_flash::bwd_f32_wide(const float* q, const float* k, const float* v, const float* d_out,
                            const float* lse, const float* delta, float* dq, float* dk, float* dv,
                            int B, int T, int H, int D, long long sb, long long st, long long sh,
                            long long gb, long long gt, long long gh, float scale,
                            cudaStream_t stream) {
  if (D <= 128 || D % 8) return (int)cudaErrorInvalidValue;
  const int e = chunk_width(D, DKV_WIDEST) == 192
                    ? launch_bwd_wide<192, true>(q, k, v, d_out, lse, delta, dk, dv, B, T, H, D,
                                                 sb, st, sh, gb, gt, gh, scale, stream)
                    : launch_bwd_wide<256, true>(q, k, v, d_out, lse, delta, dk, dv, B, T, H, D,
                                                 sb, st, sh, gb, gt, gh, scale, stream);
  if (e) return e;
#define RFV_DQ(W)                                                                               \
  launch_bwd_wide<W, false>(q, k, v, d_out, lse, delta, dq, nullptr, B, T, H, D, sb, st, sh, gb, \
                            gt, gh, scale, stream)
  switch (chunk_width(D, WIDEST)) { RFV_WIDE_CASES(RFV_DQ) }
#undef RFV_DQ
}

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
