// 3x3 / stride 1 / pad 1 NHWC convolution + fp32 bias, hand-written for
// Hopper (sm_90a), as an implicit GEMM.
//
// Replaces the Pallas TPU kernel rectified_flow_vision_tpu/ops/conv_pallas.py
// conv3x3 (default tiling _conv3x3_taps, and its variants _conv3x3_padded,
// _conv3x3_packed, _conv3x3_image), which stages padded row strips in VMEM
// and runs one K = 9*Cin MXU contraction per strip.
//
// GEMM view: M = N*H*W output pixels, N = Cout, K = 9*Cin ordered
// (dy, dx, ci), so the weight is w[Cout][3][3][Cin] (OIHW permuted to OHWI),
// a K-major [Cout, 9*Cin] matrix.
//
// Bound on the H100: operations. The flagship's 30 calls per forward do 3.09
// TFLOP (3.1 ms at 989 TFLOP/s); the 64-channel convs at 64x64 sit near the
// ~295 flop/byte ridge, the rest well above it. What limits a tile in
// practice is the L2 -> SM traffic: each k-step brings BM x 128 bytes of A
// and BN x 128 bytes of B for 2 x BM x BN x 64 flops, and each input pixel
// comes in once per tap.
//
// bfloat16: warp-specialised, persistent, wgmma + TMA.
//  - Block tile BM pixels x BN output channels, BN = Cout up to 256 (else
//    the largest of 256, 192, 128 dividing Cout; the wrapper picks it), so
//    each tap's A tile is brought in once, not Cout / BN times. BM = 256
//    where BN <= 128 (each consumer runs two m64 sub-tiles, so a k-step's
//    weights serve twice the rows), else 128.
//  - A, the implicit im2col, by TMA in tiled mode over x as a 4D tensor
//    [N, H, W, Cin]: the BM pixels of a tile are a box of Hb image rows x Wb
//    columns (Wb = the power of two >= W, at most 128; Hb = BM / Wb) in one
//    image, and the tap (dy, dx) is the same box moved by (dy, dx). The
//    box's pixels outside the image (the halo, and columns or rows past a W
//    or H that Wb, Hb do not divide) are filled with zeros by the TMA unit,
//    so x is never padded and no thread computes an address. Chosen over
//    cp.async gathers (128 threads, 1024 16-byte copies a stage, a proxy
//    fence) and over TMA's im2col mode (a descriptor per tap offset): one
//    thread issues a stage, the hardware swizzles it as wgmma reads it.
//    Pixels past W or H are computed and not stored (none on the main path).
//  - B, the weights, by TMA over [Cout, 9*Cin], box 64 x BN.
//  - Both land 128-byte swizzled in a ring of 4-8 stages of BK = 64 (one
//    tap, 64 input channels), BM x 128 + BN x 128 bytes each, signalled by
//    mbarriers (full: TMA bytes; empty: the 8 consumer warps). Cin need only
//    be a multiple of 16 (a tensor-parallel rank's slice of 64 channels): a
//    tap's last k-step then reads channels past Cin as zeros from TMA, and
//    its weight box's columns past the tap (the next tap's, or past 9 * Cin)
//    multiply those zeros. Cout below BN (a multiple of 8) leaves the
//    weight box's rows past Cout zero-filled and those columns unstored.
//  - Warpgroup 0 is the producer (one thread issues the TMA loads, 40
//    registers); warpgroups 1 and 2 each own BM / 2 rows of the tile and run
//    wgmma.m64nBNk16 (fp32 accumulators in registers, at most 128 a thread,
//    232 registers after setmaxnreg), one group in flight while the next
//    stage is waited for.
//  - Persistent grid of one block per SM walking the tiles (output-channel
//    tile fastest), so the producer loads the next tile while the consumers
//    run the epilogue: fp32 + bias, one rounding to bf16, a transpose of
//    each 8-column chunk across the four lanes of a quad by shuffles, and
//    16-byte stores.
//
// The same body, as a one-tap conv (K = Cin, the box's channels past Cin and
// the weight box's rows past Cout zero-filled by TMA, columns past Cout not
// stored, an optional residual added in the epilogue), runs the attention
// block's qkv and proj projections (attention.cu, through conv3x3.cuh).
//
// float32: a SIMT kernel (64 x 64 tile, 4 x 4 outputs per thread, fp32
// FMA), exact fp32 products, for the fp32 model path and checks; TF32 would
// change the numbers. A k-chunk of 16 lies in one tap (Cin % 16 == 0);
// output channels past Cout read zero weights and are not stored.
#include <cuda.h>

#include "conv3x3.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ----

constexpr int BK = 64;
constexpr int A_SUB_BYTES = 64 * BK * 2;  // 8 KB: one m64 sub-tile of A
constexpr int THREADS = 384;              // producer + two consumer warpgroups

// m64 sub-tiles per consumer warpgroup: 2 (a 256-pixel tile) where BN <= 128,
// so that the B bytes of a k-step serve twice the rows; 1 (128 pixels) above,
// where 2 x BN / 2 accumulators a thread would not fit its registers.
template <int BN>
__host__ __device__ constexpr int sub_tiles() { return BN <= 128 ? 2 : 1; }

struct ConvShape {
  int H, W, Cin, Cout;
  int wb_log2, hb;                    // box: Hb rows x (1 << wb_log2) columns
  int tiles_w, tiles_h, tiles_n, tiles;
  int stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Output tile t -> (image, first row, first column, first output channel).
struct Tile {
  int img, h0, w0, n0;
};

__device__ __forceinline__ Tile decode_tile(int t, const ConvShape& s, int bn) {
  Tile r;
  r.n0 = (t % s.tiles_n) * bn;
  t /= s.tiles_n;
  r.w0 = (t % s.tiles_w) << s.wb_log2;
  t /= s.tiles_w;
  r.h0 = (t % s.tiles_h) * s.hb;
  r.img = t / s.tiles_h;
  return r;
}

__device__ __forceinline__ uint32_t sel4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         int i) {
  return i == 0 ? a0 : i == 1 ? a1 : i == 2 ? a2 : a3;
}

// The implicit GEMM of a TAPS-tap conv (9: the 3x3 conv; 1: a dense layer
// over the pixels, the attention block's projections) with `Cout` output
// channels in tiles of BN (columns past Cout, a multiple of 8, are computed
// and not stored). RESID: y = T(resid + T(acc + bias)), else T(acc + bias).
template <int BN, int TAPS, bool RESID>
__device__ __forceinline__ void wgmma_conv_body(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                                                const float* __restrict__ bias,
                                                const bf16* __restrict__ resid,
                                                bf16* __restrict__ y, const ConvShape& s) {
  constexpr int MI = sub_tiles<BN>();
  constexpr int A_STAGE_BYTES = 2 * MI * A_SUB_BYTES;  // 128 MI pixels x 64 channels
  constexpr int B_STAGE_BYTES = BN * BK * 2;
  constexpr int STAGE_BYTES = A_STAGE_BYTES + B_STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that grid
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + s.stages * STAGE_BYTES);
  uint64_t* empty = full + s.stages;

  const int kc = (s.Cin + BK - 1) / BK;  // k-steps per tap; TMA zero-fills past Cin
  const int KT = TAPS * kc;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
        const Tile tl = decode_tile(t, s, BN);
        for (int kt = 0; kt < KT; ++kt) {
          const int tap = TAPS == 9 ? kt / kc : 4;  // tap 4 is (dy, dx) = (0, 0)
          const int ci0 = (kt - (TAPS == 9 ? tap : 0) * kc) * BK;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          uint8_t* st = smem + stage * STAGE_BYTES;
          tma_load_4d(st, &tm_x, &full[stage], ci0, tl.w0 + dx, tl.h0 + dy, tl.img);
          // the weights' K index of (tap, ci0); where Cin % 64 != 0 the box
          // runs into the next tap's columns, which meet the zero-filled
          // channels past Cin in A
          tma_load_2d(st + A_STAGE_BYTES, &tm_w, &full[stage],
                      (TAPS == 9 ? tap * s.Cin : 0) + ci0, tl.n0);
          if (++stage == s.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows 64 MI c .. 64 MI (c + 1) - 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, q = lane & 3;
    const int wb = 1 << s.wb_log2;
    float acc[MI][BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
      const Tile tl = decode_tile(tile, s, BN);
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[stage], phase);
        uint8_t* st = smem + stage * STAGE_BYTES;
        const uint64_t da = rfv_wgmma::desc_sw128(smem_u32(st + c * MI * A_SUB_BYTES));
        const uint64_t db = rfv_wgmma::desc_sw128(smem_u32(st + A_STAGE_BYTES));
        rfv_wgmma::fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)  // +32 bytes per k16 = +2 in the address field
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)  // the next 64 rows: +8 KB = +512
            rfv_wgmma::Wgmma<BN>::mma(acc[mi], da + 512 * mi + 2 * k, db + 2 * k,
                                      (kt | k) != 0);
        rfv_wgmma::commit();
        rfv_wgmma::wait<1>();  // the previous k-step's products are done
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == s.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      rfv_wgmma::wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: rows r (d[4i], d[4i+1]) and r + 8 (d[4i+2], d[4i+3]) of
      // each sub-tile
#pragma unroll
      for (int sub = 0; sub < 2 * MI; ++sub) {
        const int mi = sub >> 1, half = sub & 1;
        const int p = (c * MI + mi) * 64 + warp * 16 + (lane >> 2) + 8 * half;  // tile pixel
        const int h = tl.h0 + (p >> s.wb_log2), w = tl.w0 + (p & (wb - 1));
        const bool ok = h < s.H && w < s.W;
        bf16* yrow = y + (((size_t)tl.img * s.H + h) * s.W + w) * s.Cout + tl.n0;
#pragma unroll
        for (int a = 0; a < BN / 32; ++a) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * a + j, col = 8 * i + 2 * q;
            const float2 bb = tl.n0 + col < s.Cout
                                  ? *reinterpret_cast<const float2*>(bias + tl.n0 + col)
                                  : make_float2(0.f, 0.f);
            __nv_bfloat162 pr = __floats2bfloat162_rn(acc[mi][4 * i + 2 * half] + bb.x,
                                                      acc[mi][4 * i + 2 * half + 1] + bb.y);
            v[j] = *reinterpret_cast<uint32_t*>(&pr);
          }
          // lane q collects chunk 4a + q (8 columns) from the four lanes of its quad
          uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t send = sel4(v[0], v[1], v[2], v[3], (q - r) & 3);
            const int src = (q + r) & 3;
            const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
            for (int j = 0; j < 4; ++j) o[j] = j == src ? got : o[j];
          }
          const int col = 8 * (4 * a + q);
          if (ok && tl.n0 + col < s.Cout) {
            uint4 out = make_uint4(o[0], o[1], o[2], o[3]);
            if constexpr (RESID) {
              float f[8], r[8];
              load16(reinterpret_cast<const bf16*>(&out), f);
              load16(resid + (yrow - y) + col, r);
#pragma unroll
              for (int e = 0; e < 8; ++e) f[e] = r[e] + f[e];
              store16(reinterpret_cast<bf16*>(&out), f);
            }
            *reinterpret_cast<uint4*>(yrow + col) = out;
          }
        }
      }
    }
  }
}

// Entry kernels with names of their own, so that a profiler trace tells the
// convs from the attention block's projections.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                         const bf16* __restrict__ resid, bf16* __restrict__ y, const ConvShape s) {
  wgmma_conv_body<BN, 9, false>(tm_x, tm_w, bias, resid, y, s);
}

template <int BN, bool RESID>
__global__ void __launch_bounds__(THREADS, 1)
    attn_linear_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w,
                             const float* __restrict__ bias, const bf16* __restrict__ resid,
                             bf16* __restrict__ y, const ConvShape s) {
  wgmma_conv_body<BN, 1, RESID>(tm_x, tm_w, bias, resid, y, s);
}

// Dynamic shared memory of the bf16 kernel: the ring, 1024 bytes to align it,
// and two mbarriers a stage.
int ring_smem(int bn, int stages) {
  const int a_bytes = 2 * (bn <= 128 ? 2 : 1) * A_SUB_BYTES;
  return stages * (a_bytes + bn * BK * 2) + 1024 + 2 * stages * 8;
}

typedef decltype(&cuTensorMapEncodeTiled) EncodeTiled;

// cuTensorMapEncodeTiled is a driver-API call; the library links only the
// runtime, so it is reached through the runtime's driver entry point.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int BN>
int launch_wgmma(const void* x, const void* w, const void* bias, const void* resid, void* y,
                 int N, int H, int W, int Cin, int Cout, int taps, int stages, int wb, int hb,
                 cudaStream_t st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  int wb_log2 = 0;
  while ((1 << wb_log2) < wb) ++wb_log2;
  if ((1 << wb_log2) != wb || wb * hb != 128 * sub_tiles<BN>() || Cin % 8 || Cout % 8 ||
      (taps == 9 && Cin % 16) || (taps != 9 && taps != 1) || (taps == 9 && resid))
    return (int)cudaErrorInvalidValue;

  CUtensorMap tm_x, tm_w;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t xstride[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)wb, (cuuint32_t)hb, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {(cuuint64_t)taps * Cin, (cuuint64_t)Cout};
  const cuuint64_t wstride[1] = {(cuuint64_t)taps * Cin * 2};
  const cuuint32_t wbox[2] = {BK, BN};
  r = encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  ConvShape s;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.wb_log2 = wb_log2;
  s.hb = hb;
  s.tiles_w = (W + wb - 1) / wb;
  s.tiles_h = (H + hb - 1) / hb;
  s.tiles_n = (Cout + BN - 1) / BN;
  s.tiles = N * s.tiles_h * s.tiles_w * s.tiles_n;
  s.stages = stages;
  const int smem = ring_smem(BN, stages);
  void (*kern)(const CUtensorMap, const CUtensorMap, const float*, const bf16*, bf16*,
               const ConvShape) = taps == 9 ? conv3x3_wgmma_kernel<BN>
                                  : resid  ? attn_linear_wgmma_kernel<BN, true>
                                           : attn_linear_wgmma_kernel<BN, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = s.tiles < sm_count() ? s.tiles : sm_count();
  kern<<<grid, THREADS, smem, st>>>(tm_x, tm_w, static_cast<const float*>(bias),
                                    static_cast<const bf16*>(resid), static_cast<bf16*>(y), s);
  return (int)cudaGetLastError();
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
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + lrow < Cout) b = *reinterpret_cast<const float4*>(w + (size_t)(n0 + lrow) * K + k0 + lk);
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
    if (mo < M && n0 + tx * 4 < Cout) {  // Cout % 16 == 0: a thread's 4 columns all in or out
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][j] + bias[n0 + tx * 4 + j];
      store16(y + (size_t)mo * Cout + n0 + tx * 4, v);
    }
  }
}

}  // namespace

// Dynamic shared memory of the bf16 kernel for output-channel tile `bn` and
// `stages` ring stages (the wrapper's tile choice, ops/conv3x3.py, mirrors it).
extern "C" int rfv_conv3x3_smem(int bn, int stages) { return ring_smem(bn, stages); }

int rfv_conv::launch_bf16(const void* x, const void* w, const void* bias, const void* resid,
                          void* y, int N, int H, int W, int Cin, int Cout, int taps, int bn,
                          int stages, int wb, int hb, cudaStream_t st) {
  switch (bn) {
    case 64:
      return launch_wgmma<64>(x, w, bias, resid, y, N, H, W, Cin, Cout, taps, stages, wb, hb, st);
    case 128:
      return launch_wgmma<128>(x, w, bias, resid, y, N, H, W, Cin, Cout, taps, stages, wb, hb, st);
    case 192:
      return launch_wgmma<192>(x, w, bias, resid, y, N, H, W, Cin, Cout, taps, stages, wb, hb, st);
    case 256:
      return launch_wgmma<256>(x, w, bias, resid, y, N, H, W, Cin, Cout, taps, stages, wb, hb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x: [N, H, W, Cin], w: [Cout, 3, 3, Cin], y: [N, H, W, Cout], all contiguous
// in `dtype`; bias: [Cout] float32. Requires Cin % 16 == 0, Cout % 16 == 0.
// bf16 only: bn (64, 128, 192 or 256), the ring's `stages`, and the A box of
// hb rows x wb columns (wb a power of two, wb * hb = 128 or 256 as bn asks):
// ops/conv3x3.py tile_config.
extern "C" int rfv_conv3x3(const void* x, const void* w, const void* bias, void* y, int N, int H,
                           int W, int Cin, int Cout, int bn, int stages, int wb, int hb, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RFV_DTYPE_BF16)
    return rfv_conv::launch_bf16(x, w, bias, nullptr, y, N, H, W, Cin, Cout, 9, bn, stages, wb,
                                 hb, st);
  const int M = N * H * W;
  dim3 grid((M + FBM - 1) / FBM, (Cout + FBN - 1) / FBN);
  conv3x3_f32_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), N, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
