// UNet mid-block self-attention (GroupNorm -> qkv -> softmax(QK^T/sqrt(d))V
// -> proj -> +x) over NHWC, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rectified_flow_vision_tpu/ops/pallas_kernels.py
// attention_block (body _attention_kernel), which runs the whole block for
// one image per grid step out of VMEM.
//
// Three launches, because one image's qkv at C = 256 (256 x 768, 384 KB in
// bf16) does not fit the 227 KB of shared memory a block can have:
//   1. attn_linear<NORM>: per (image, 64 qkv columns) block: GroupNorm
//      statistics of the image (fp32, shifted sums), the normalised x rounded
//      to the working dtype, the qkv product and bias -> qkv [B, N, 3C].
//   2. attn_core: per (image, head, 32 query rows) block: K, V of the head
//      (N x d) and Q rows in shared memory, logits in fp32, fp32 softmax,
//      probabilities rounded to the working dtype as the plain version does,
//      then P V -> att [B, N, C].
//   3. attn_linear<PROJ>: att @ Wproj^T + bias, rounded, plus the residual x.
//
// Bound on the H100: at the flagship shape (256 images, N = 256 tokens,
// C = 256, 4 heads of d = 64) the block does ~51 GFLOP over ~100 MB of
// qkv/att/x traffic, so operations bound it on paper. Every product here is
// computed with fp32 FMAs on the CUDA cores (exact products of bf16 inputs,
// fp32 sums), not on the tensor cores: simple and right first. This block is
// 1 of 60 kernel calls per UNet forward.
#include "common.cuh"

namespace {

constexpr int LIN_COLS = 64;    // output columns per block
constexpr int LIN_K = 32;       // K chunk
constexpr int LIN_ROWS = 256;   // max tokens per image (rows per block)
constexpr int CORE_QT = 32;     // query rows per block

// One image's rows [N, K] times W^T (W: [O, K], torch Linear layout) for 64
// output columns. NORM: a = GroupNorm(x) rounded to T, out = T(acc + bias).
// Otherwise: out = T(resid + T(acc + bias)).
template <typename T, bool NORM>
__global__ void __launch_bounds__(256)
    attn_linear_kernel(const T* __restrict__ a, const float* __restrict__ gscale,
                       const float* __restrict__ gbias, int G, float eps,
                       const T* __restrict__ w, const float* __restrict__ bias,
                       const T* __restrict__ resid, T* __restrict__ out, int N, int K, int O) {
  __shared__ __align__(16) float As[LIN_K][LIN_ROWS + 4];
  __shared__ __align__(16) float Bs[LIN_K][LIN_COLS + 4];
  __shared__ float mean_s[32], rstd_s[32], red[8];
  const int b = blockIdx.y, o0 = blockIdx.x * LIN_COLS;
  const int tid = threadIdx.x;
  const T* ab = a + (size_t)b * N * K;

  if (NORM) {
    const int cg = K / G;
    for (int g = 0; g < G; ++g) {
      const float shift = to_f32(ab[g * cg]);
      float s1 = 0.f, s2 = 0.f;
      for (int i = tid; i < N * cg; i += blockDim.x) {
        const float d = to_f32(ab[(size_t)(i / cg) * K + g * cg + i % cg]) - shift;
        s1 += d;
        s2 += d * d;
      }
      s1 = block_sum(s1, red);
      s2 = block_sum(s2, red);
      if (tid == 0) {
        const float n = (float)N * (float)cg;
        const float m = s1 / n;
        mean_s[g] = shift + m;
        rstd_s[g] = rsqrtf(fmaxf(s2 / n - m * m, 0.f) + eps);
      }
    }
    __syncthreads();
  }

  const int tx = tid & 15, ty = tid >> 4;  // 4 columns tx*4.., rows ty + 16*r
  float acc[16][4] = {};
  for (int k0 = 0; k0 < K; k0 += LIN_K) {
    for (int i = tid; i < N * LIN_K; i += blockDim.x) {
      const int n = i / LIN_K, k = i % LIN_K, c = k0 + k;
      float v = 0.f;  // zero past the ragged end of K
      if (c < K) {
        v = to_f32(ab[(size_t)n * K + c]);
        if (NORM) {
          const int g = c / (K / G);
          v = round_to<T>((v - mean_s[g]) * rstd_s[g] * gscale[c] + gbias[c]);
        }
      }
      As[k][n] = v;
    }
    for (int i = tid; i < LIN_COLS * LIN_K; i += blockDim.x) {
      const int o = i / LIN_K, k = i % LIN_K;
      Bs[k][o] = (o0 + o < O && k0 + k < K) ? to_f32(w[(size_t)(o0 + o) * K + k0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < LIN_K; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float av = As[k][ty + 16 * r];
        acc[r][0] = fmaf(av, bv.x, acc[r][0]);
        acc[r][1] = fmaf(av, bv.y, acc[r][1]);
        acc[r][2] = fmaf(av, bv.z, acc[r][2]);
        acc[r][3] = fmaf(av, bv.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int n = ty + 16 * r;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o >= O) continue;
      const size_t idx = ((size_t)b * N + n) * O + o;
      float v = acc[r][j] + bias[o];
      if (!NORM) v = to_f32(resid[idx]) + round_to<T>(v);
      out[idx] = from_f32<T>(v);
    }
  }
}

// Softmax attention of CORE_QT query rows of one (image, head).
// qkv: [B, N, 3C] (q | k | v, head h at columns h*d..), att: [B, N, C].
template <typename T>
__global__ void __launch_bounds__(256)
    attn_core_kernel(const T* __restrict__ qkv, T* __restrict__ att, int N, int C, int d,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = N + 2;
  float* Qs = reinterpret_cast<float*>(smem);  // [QT][d]
  float* Ss = Qs + CORE_QT * d;                // [QT][N]
  T* Kt = reinterpret_cast<T*>(Ss + CORE_QT * N);  // [d][N + 2], transposed
  T* Vs = Kt + (size_t)d * ldk;                    // [N][d]

  const int q0 = blockIdx.x * CORE_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int C3 = 3 * C;
  const T* base = qkv + (size_t)b * N * C3;

  for (int i = tid; i < CORE_QT * d; i += blockDim.x) {
    const int r = i / d, k = i % d;
    Qs[i] = q0 + r < N ? to_f32(base[(size_t)(q0 + r) * C3 + h * d + k]) : 0.f;
  }
  for (int i = tid; i < N * d; i += blockDim.x) {
    const int j = i / d, k = i % d;
    Kt[k * ldk + j] = base[(size_t)j * C3 + C + h * d + k];
    Vs[i] = base[(size_t)j * C3 + 2 * C + h * d + k];
  }
  __syncthreads();

  // logits: thread j owns key j for all CORE_QT query rows
  for (int j = tid; j < N; j += blockDim.x) {
    float acc[CORE_QT] = {};
    for (int k = 0; k < d; ++k) {
      const float kv = to_f32(Kt[k * ldk + j]);
#pragma unroll
      for (int r = 0; r < CORE_QT; ++r) acc[r] = fmaf(Qs[r * d + k], kv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < CORE_QT; ++r) Ss[r * N + j] = acc[r] * scale;
  }
  __syncthreads();

  // fp32 softmax, one warp per row; probabilities rounded to T
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < CORE_QT; r += nwarps) {
    float* row = Ss + r * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < N; j += 32) row[j] = round_to<T>(row[j] / sum);
  }
  __syncthreads();

  // out = P V; thread -> (row, channel) pairs
  for (int i = tid; i < CORE_QT * d; i += blockDim.x) {
    const int r = i / d, k = i % d;
    if (q0 + r >= N) continue;  // ragged last tile of query rows
    const float* p = Ss + r * N;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(p[j], to_f32(Vs[j * d + k]), acc);
    att[((size_t)b * N + q0 + r) * C + h * d + k] = from_f32<T>(acc);
  }
}

template <typename T>
size_t core_smem(int N, int d) {
  return (size_t)CORE_QT * d * 4 + (size_t)CORE_QT * N * 4 + (size_t)d * (N + 2) * sizeof(T) +
         (size_t)N * d * sizeof(T);
}

template <typename T>
int launch(const void* x, const void* gscale, const void* gbias, const void* wqkv,
           const void* bqkv, const void* wproj, const void* bproj, void* qkv, void* att,
           void* out, int B, int N, int C, int heads, int G, float eps, cudaStream_t st) {
  const int d = C / heads;
  attn_linear_kernel<T, true><<<dim3((3 * C + LIN_COLS - 1) / LIN_COLS, B), 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(gscale),
      static_cast<const float*>(gbias), G, eps, static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), nullptr, static_cast<T*>(qkv), N, C, 3 * C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = core_smem<T>(N, d);
  e = cudaFuncSetAttribute(attn_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_core_kernel<T><<<dim3((N + CORE_QT - 1) / CORE_QT, heads, B), 256, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<T*>(att), N, C, d, 1.f / sqrtf((float)d));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  attn_linear_kernel<T, false><<<dim3((C + LIN_COLS - 1) / LIN_COLS, B), 256, 0, st>>>(
      static_cast<const T*>(att), nullptr, nullptr, G, eps, static_cast<const T*>(wproj),
      static_cast<const float*>(bproj), static_cast<const T*>(x), static_cast<T*>(out), N, C,
      C);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of attn_core for N tokens and head width d.
extern "C" int rfv_attention_core_smem(int N, int d, int dtype) {
  return (int)(dtype == RFV_DTYPE_BF16 ? core_smem<bf16>(N, d) : core_smem<float>(N, d));
}

// x, out: [B, N, C]; wqkv: [3C, C]; wproj: [C, C] (torch Linear layouts),
// all contiguous in `dtype`; gscale, gbias: [C], bqkv: [3C], bproj: [C]
// float32; qkv: [B, N, 3C] and att: [B, N, C] workspaces in `dtype`.
// Requires N <= 256, C % G == 0, G <= 32, C % heads == 0, and
// rfv_attention_core_smem(N, C / heads, dtype) <= 227 KB.
extern "C" int rfv_attention_block(const void* x, const void* gscale, const void* gbias,
                                   const void* wqkv, const void* bqkv, const void* wproj,
                                   const void* bproj, void* qkv, void* att, void* out, int B,
                                   int N, int C, int heads, int G, float eps, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RFV_DTYPE_BF16)
    return launch<bf16>(x, gscale, gbias, wqkv, bqkv, wproj, bproj, qkv, att, out, B, N, C,
                        heads, G, eps, st);
  return launch<float>(x, gscale, gbias, wqkv, bqkv, wproj, bproj, qkv, att, out, B, N, C,
                       heads, G, eps, st);
}
