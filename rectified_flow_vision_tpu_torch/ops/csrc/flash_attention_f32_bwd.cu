// Flash attention in float32 up to D = 128, backward: dkv and dq in 3xTF32
// on the tensor cores (flash_f32_tc.cuh; the design is described in
// flash_attention_f32.cu). delta = rowsum(dO * O) is written before, by
// flash_attention.cu's delta pass.
#include "flash_attention.cuh"
#include "flash_f32_tc.cuh"

namespace {

namespace tc = rfv_flash_tc;

constexpr int DKV_KEYS = 64;             // keys a dkv block: 16 a warp in each half
constexpr int DQ_ROWS = 16 * tc::WARPS;  // queries a dq block

// dkv: K, V; two stages of Q and dO tiles of `rows` queries with their lse
// and delta; the lo halves of one stage's Q and dO; the P^T exchange
template <int DP>
__host__ __device__ constexpr int dkv_stage(int rows) {
  return 2 * rows * tc::pitch<DP>() + 2 * rows;
}
template <int DP>
__host__ __device__ constexpr int dkv_smem_at(int rows) {
  return (2 * DKV_KEYS * tc::pitch<DP>() + 2 * dkv_stage<DP>(rows) + 2 * rows * tc::pitch<DP>() +
          DKV_KEYS * rows) * 4;
}
// dq: Q, dO; two stages of K and V tiles of `rows` keys; the lo halves of one
template <int DP>
__host__ __device__ constexpr int dq_smem_at(int rows) {
  return (2 * DQ_ROWS + 6 * rows) * tc::pitch<DP>() * 4;
}
// the streamed tiles: the most rows (64, 32, 16) that fit
template <int DP>
__host__ __device__ constexpr int dkv_queries() {
  return dkv_smem_at<DP>(64) <= tc::SMEM_MAX ? 64 : 32;
}
template <int DP>
__host__ __device__ constexpr int dq_keys() {
  return dq_smem_at<DP>(64) <= tc::SMEM_MAX ? 64 : dq_smem_at<DP>(32) <= tc::SMEM_MAX ? 32 : 16;
}

// dkv: 64 keys a block, K and V resident; Q, dO, lse and delta of BQ
// queries a tile streamed. Warp w < 4 (keys 16 w ..): S^T = K Q^T, P^T =
// exp(S^T scale - lse), P^T to shared memory, dV += P^T dO. Warp w + 4 (the
// same keys): dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
template <int DP>
__global__ void __launch_bounds__(tc::THREADS, 1)
    flash_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ d_out,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int T, int H, int D,
                          long long sb, long long st, long long sh, long long gb, long long gt,
                          long long gh, float scale) {
  constexpr int P = tc::pitch<DP>(), KS = DP / 8, BQ = dkv_queries<DP>(), NQ = BQ / 8;
  constexpr int STAGE = dkv_stage<DP>(BQ);
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // 64 keys
  float* vs = ks + DKV_KEYS * P;
  float* ring = vs + DKV_KEYS * P;   // 2 stages: Q, dO (BQ rows each), lse, delta
  float* lo = ring + 2 * STAGE;      // lo halves of this tile's Q, dO
  float* xbuf = lo + 2 * BQ * P;     // P^T of each key warp, in fragment order
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int half = warp >> 2, kw = warp & 3;  // half 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const long long op = (long long)H * D;  // d_out: contiguous [B, T, H, D]
  const size_t obase = (size_t)b * T * op + (size_t)h * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* delta_bh = delta + ((size_t)b * H + h) * T;

  tc::tile<DP>(ks, k + base + (size_t)kt * DKV_KEYS * st, st, DKV_KEYS, D);
  tc::tile<DP>(vs, v + base + (size_t)kt * DKV_KEYS * st, st, DKV_KEYS, D);
  auto issue = [&](int qt, int stage) {
    float* qst = ring + stage * STAGE;
    tc::tile<DP>(qst, q + base + (size_t)qt * BQ * st, st, BQ, D);
    tc::tile<DP>(qst + BQ * P, d_out + obase + (size_t)qt * BQ * op, op, BQ, D);
    tc::row(qst + 2 * BQ * P, lse_bh + qt * BQ, BQ);
    tc::row(qst + 2 * BQ * P + BQ, delta_bh + qt * BQ, BQ);
  };

  float acc[KS][4];  // dV (half 0) or dK (half 1) of the warp's 16 keys
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* xa = (half ? vs : ks) + kw * 16 * P + tc::a_lane(lane, P);
  float4* xw = reinterpret_cast<float4*>(xbuf) + kw * NQ * 32 + lane;
  const int bo = tc::b_lane(lane, P), to = tc::t_lane(lane, P);
  const int n = T / BQ;
  issue(0, 0);
  cp_async_commit();
  for (int qt = 0; qt < n; ++qt) {
    cp_async_wait<0>();
    __syncthreads();
    if (qt + 1 < n) issue(qt + 1, (qt + 1) & 1);
    cp_async_commit();
    float* qst = ring + (qt & 1) * STAGE;
    const float* gst = qst + BQ * P;
    const float* ls = gst + BQ * P;
    const float* ds = ls + BQ;
    tc::split_tile<DP>(qst, lo, 2 * BQ);  // Q and dO
    __syncthreads();
    const int lo_off = (int)(lo - qst);
    float x[NQ][4];  // S^T or dP^T: rows keys, columns queries
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    const float* bh = (half ? gst : qst) + bo;
    tc::nt<DP, NQ>(x, xa, bh, bh + lo_off);
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = expf(x[j][e] * scale - ((e & 1) ? lq.y : lq.x));
        xw[32 * j] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      }
    }
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t);
        const float4 p = xw[32 * j];
        x[j][0] = p.x * (x[j][0] - dl.x);
        x[j][1] = p.y * (x[j][1] - dl.y);
        x[j][2] = p.z * (x[j][2] - dl.x);
        x[j][3] = p.w * (x[j][3] - dl.y);
      }
    }
    const float* yh = (half ? qst : gst) + to;
    tc::nn<DP, NQ, KS>(acc, x, yh, yh + lo_off);  // dV += P^T dO; dK += dS^T Q
  }

  const size_t r0 = (size_t)b * gb + (size_t)h * gh +
                    (size_t)(kt * DKV_KEYS + kw * 16 + (lane >> 2)) * gt;
  float* out = (half ? dk : dv) + r0;
  const float mul = half ? scale : 1.f;
  tc::store<DP>(acc, out, out + 8 * gt, lane, mul, mul, D);
}

// dq: 128 queries a block, Q and dO resident; K and V of BK keys a tile
// streamed. Per warp (16 queries) and tile: S = Q K^T and dP = dO V^T,
// dS = exp(S scale - lse) (dP - delta), dQ += dS K.
template <int DP>
__global__ void __launch_bounds__(tc::THREADS, 1)
    flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_out,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int T, int H, int D, long long sb, long long st,
                         long long sh, long long gb, long long gt, long long gh, float scale) {
  constexpr int P = tc::pitch<DP>(), KS = DP / 8, BK = dq_keys<DP>(), NK = BK / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // 128 queries
  float* gs = qs + DQ_ROWS * P;    // their d_out rows
  float* ring = gs + DQ_ROWS * P;  // 2 stages: K, V (BK rows each)
  float* lo = ring + 4 * BK * P;   // lo halves of this tile's K, V
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const long long op = (long long)H * D;
  const int row = qt * DQ_ROWS + warp * 16 + (lane >> 2);

  tc::tile<DP>(qs, q + base + (size_t)qt * DQ_ROWS * st, st, DQ_ROWS, D);
  tc::tile<DP>(gs, d_out + (size_t)b * T * op + (size_t)h * D + (size_t)qt * DQ_ROWS * op, op,
               DQ_ROWS, D);
  auto issue = [&](int kt, int stage) {
    float* kst = ring + stage * 2 * BK * P;
    const size_t r = base + (size_t)kt * BK * st;
    tc::tile<DP>(kst, k + r, st, BK, D);
    tc::tile<DP>(kst + BK * P, v + r, st, BK, D);
  };
  // lse and delta of rows g and g + 8
  const float* lse_r = lse + ((size_t)b * H + h) * T + row;
  const float* delta_r = delta + ((size_t)b * H + h) * T + row;
  const float lr[2] = {lse_r[0], lse_r[8]}, dr[2] = {delta_r[0], delta_r[8]};

  float dqa[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const float* qa = qs + warp * 16 * P + tc::a_lane(lane, P);
  const float* ga = gs + warp * 16 * P + tc::a_lane(lane, P);
  const int bo = tc::b_lane(lane, P), to = tc::t_lane(lane, P);
  const int n = T / BK;
  issue(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n) issue(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    float* kst = ring + (kt & 1) * 2 * BK * P;
    tc::split_tile<DP>(kst, lo, 2 * BK);  // K and V
    __syncthreads();
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    tc::nt<DP, NK>(s, qa, kst + bo, lo + bo);
    tc::nt<DP, NK>(dp, ga, kst + BK * P + bo, lo + BK * P + bo);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = expf(s[j][e] * scale - lr[e >> 1]) * (dp[j][e] - dr[e >> 1]);
    tc::nn<DP, NK, KS>(dqa, s, kst + to, lo + to);  // dQ += dS K
  }

  float* out = dq + (size_t)b * gb + (size_t)h * gh + (size_t)row * gt;
  tc::store<DP>(dqa, out, out + 8 * gt, lane, scale, scale, D);
}

template <int DP>
int launch_bwd(const float* q, const float* k, const float* v, const float* d_out,
               const float* lse, const float* delta, float* dq, float* dk, float* dv, int B, int T,
               int H, int D, long long sb, long long st, long long sh, long long gb, long long gt,
               long long gh, float scale, cudaStream_t stream) {
  constexpr int smem_dkv = dkv_smem_at<DP>(dkv_queries<DP>());
  constexpr int smem_dq = dq_smem_at<DP>(dq_keys<DP>());
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_dq_tf32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_tf32_kernel<DP><<<dim3(T / DKV_KEYS, H, B), tc::THREADS, smem_dkv, stream>>>(
      q, k, v, d_out, lse, delta, dk, dv, T, H, D, sb, st, sh, gb, gt, gh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_tf32_kernel<DP><<<dim3(T / DQ_ROWS, H, B), tc::THREADS, smem_dq, stream>>>(
      q, k, v, d_out, lse, delta, dq, T, H, D, sb, st, sh, gb, gt, gh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

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
