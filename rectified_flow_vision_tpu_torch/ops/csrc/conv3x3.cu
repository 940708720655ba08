// 3x3 / stride 1 / pad 1 NHWC convolution + fp32 bias, hand-written for
// Hopper (sm_90a), as an implicit GEMM.
//
// Replaces the Pallas TPU kernel rectified_flow_vision_tpu/ops/conv_pallas.py
// conv3x3 (default tiling _conv3x3_taps, and its variants _conv3x3_padded,
// _conv3x3_packed, _conv3x3_image), which stages padded row strips in VMEM
// and runs one K = 9*Cin MXU contraction per strip.
//
// GEMM view: M = N*H*W output pixels, N = Cout, K = 9*Cin ordered
// (dy, dx, ci), so the weight is w[Cout][3][3][Cin] (OIHW permuted to OHWI).
// Zero halos come from masking: a 16-byte cp.async whose source pixel is
// outside the image copies 0 bytes and fills zeros, so x is never padded.
//
// Bound on the H100: operations. At the flagship shapes one call does
// 2*M*9*Cin*Cout flops over ~(M*Cin + M*Cout)*2 bytes, 300-2300 flops per
// byte, above the card's ~295 bf16 flops per byte ridge.
//
// bfloat16: block tile 128 x 64 x 32, four warps of 64 x 32, tensor cores
// through WMMA (mma.sync, 16x16x16 bf16, fp32 accumulate), a three-stage
// cp.async ring. A K-step of 32 lies inside one tap because Cin % 64 == 0.
// The epilogue stages the fp32 tile in shared memory, adds the fp32 bias,
// rounds once to bf16 and stores 16 bytes per thread. wgmma and TMA are
// not used yet; they are the way to the card's peak rate.
//
// float32: a SIMT kernel (64 x 64 tile, 4 x 4 outputs per thread, fp32
// FMA), exact fp32 products, for the fp32 model path and checks.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16 ----

constexpr int BM = 128, BN = 64, BK = 32, LDS = BK + 8, STAGES = 3;
constexpr int A_STAGE = BM * LDS;  // bf16 elements
constexpr int B_STAGE = BN * LDS;
constexpr int LDC = BN + 4;  // fp32 epilogue tile
constexpr int SMEM_PIPE = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int SMEM_EPI = BM * LDC * 4;
constexpr int SMEM_BYTES = SMEM_PIPE > SMEM_EPI ? SMEM_PIPE : SMEM_EPI;
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory");

__global__ void __launch_bounds__(128)
    conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, bf16* __restrict__ y, int Nimg, int H,
                        int W, int Cin, int Cout) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;

  const int M = Nimg * H * W;
  const int K = 9 * Cin;
  const int KT = K / BK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 64 x 32

  // A loads: 128 rows x 4 chunks of 16 bytes; thread -> rows tid/4 + 32*i.
  const int kq = tid & 3;
  int a_img[4], a_h[4], a_w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    if (m < M) {
      a_img[i] = m / (H * W);
      const int r = m - a_img[i] * H * W;
      a_h[i] = r / W;
      a_w[i] = r - a_h[i] * W;
    } else {
      a_img[i] = -1;
      a_h[i] = a_w[i] = 0;
    }
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / Cin, ci0 = k0 - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 2) + 32 * i;
      const int ih = a_h[i] + dy, iw = a_w[i] + dx;
      const bool ok = a_img[i] >= 0 && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const bf16* src =
          ok ? x + (((size_t)a_img[i] * H + ih) * W + iw) * Cin + ci0 + kq * 8 : x;
      cp_async16(as + row * LDS + kq * 8, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 32 * i;
      const bf16* src = w + (size_t)(n0 + row) * K + k0 + kq * 8;
      cp_async16(bs + row * LDS + kq * 8, src, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  // 128 rows x 8 chunks of 8 outputs; thread -> chunks tid + 128*i.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = tid + 128 * i;
    const int row = c >> 3, col = (c & 7) * 8;
    const int m = m0 + row;
    if (m < M) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[row * LDC + col + e] + bias[n0 + col + e];
      store16(y + (size_t)m * Cout + n0 + col, v);
    }
  }
}

// ---------------------------------------------------------------- fp32 ----

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y, int Nimg, int H,
                       int W, int Cin, int Cout) {
  __shared__ __align__(16) float As[FBK][FBM + 4];
  __shared__ __align__(16) float Bs[FBK][FBN + 4];
  const int M = Nimg * H * W;
  const int K = 9 * Cin;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x;
  const int lrow = tid >> 2, lk = (tid & 3) * 4;  // loader: 64 rows x 4 float4
  const int tx = tid & 15, ty = tid >> 4;         // compute: 4 x 4 outputs

  const int m = m0 + lrow;
  int img = -1, oh = 0, ow = 0;
  if (m < M) {
    img = m / (H * W);
    const int r = m - img * H * W;
    oh = r / W;
    ow = r - oh * W;
  }

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    const int tap = k0 / Cin, ci0 = k0 - tap * Cin;
    const int ih = oh + tap / 3 - 1, iw = ow + tap % 3 - 1;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (img >= 0 && ih >= 0 && ih < H && iw >= 0 && iw < W)
      a = *reinterpret_cast<const float4*>(x + (((size_t)img * H + ih) * W + iw) * Cin + ci0 +
                                           lk);
    const float4 b =
        *reinterpret_cast<const float4*>(w + (size_t)(n0 + lrow) * K + k0 + lk);
    As[lk + 0][lrow] = a.x;
    As[lk + 1][lrow] = a.y;
    As[lk + 2][lrow] = a.z;
    As[lk + 3][lrow] = a.w;
    Bs[lk + 0][lrow] = b.x;
    Bs[lk + 1][lrow] = b.y;
    Bs[lk + 2][lrow] = b.z;
    Bs[lk + 3][lrow] = b.w;
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
    const int mo = m0 + ty * 4 + i;
    if (mo < M) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][j] + bias[n0 + tx * 4 + j];
      store16(y + (size_t)mo * Cout + n0 + tx * 4, v);
    }
  }
}

}  // namespace

// x: [N, H, W, Cin], w: [Cout, 3, 3, Cin], y: [N, H, W, Cout], all contiguous
// in `dtype`; bias: [Cout] float32. Requires Cin % 64 == 0, Cout % 64 == 0.
extern "C" int rfv_conv3x3(const void* x, const void* w, const void* bias, void* y, int N, int H,
                           int W, int Cin, int Cout, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * H * W;
  if (dtype == RFV_DTYPE_BF16) {
    dim3 grid((M + BM - 1) / BM, Cout / BN);
    conv3x3_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const float*>(bias), static_cast<bf16*>(y), N, H, W, Cin, Cout);
  } else {
    dim3 grid((M + FBM - 1) / FBM, Cout / FBN);
    conv3x3_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), N, H, W, Cin, Cout);
  }
  return (int)cudaGetLastError();
}
