// GroupNorm + SiLU over an NHWC tensor, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rectified_flow_vision_tpu/ops/pallas_kernels.py
// gn_silu (body _gn_silu_kernel, statistics _group_stats), which holds one
// image's (H*W, C) slab in VMEM per sequential grid step.
//
// Bound on the H100: bytes. The op reads x once and writes y once (2 bytes
// per element in bf16); its arithmetic is a few operations per element, far
// below the ~295 operations per byte where the tensor cores would bound it.
//
// Design: two launches instead of the TPU's one block per image, because
// one block per image would leave most of the 132 SMs idle at batch 256.
//   1. gn_stats: each block sums a slice of 128 pixels of one image (all
//      channels, coalesced loads of up to 16 bytes) into per-(image, slice, group)
//      fp32 partials (sum, sum of squares), shifted by one sample of the
//      group so that the variance does not cancel. The partials are summed
//      in a fixed order: results are deterministic.
//   2. gn_apply: each block reads its image's partials, forms mean and
//      1/sqrt(var + eps) per group, and normalises, applies the affine and
//      SiLU in fp32 and writes in x's dtype. x is read a second time; at the
//      flagship shapes an image slab (<= 2 MB) is often still in the 50 MB L2.
#include "common.cuh"

namespace {

constexpr int kPixPerSlice = 128;
constexpr int kApplyThreads = 256;
constexpr int kApplyVecPerThread = 8;

template <typename T, int V>
__global__ void __launch_bounds__(256)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int HW, int C, int G) {
  __shared__ float sh1[256], sh2[256];
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int cv = C / V, cg = C / G;
  const int j = threadIdx.x % cv, prow = threadIdx.x / cv, nrow = blockDim.x / cv;
  const int g = (j * V) / cg;
  const T* xb = x + (size_t)b * HW * C;
  const float shift = to_f32(xb[g * cg]);
  const int p0 = s * kPixPerSlice, p1 = min(HW, p0 + kPixPerSlice);
  float s1 = 0.f, s2 = 0.f;
  for (int p = p0 + prow; p < p1; p += nrow) {
    float v[V];
    loadv<V>(xb + (size_t)p * C + j * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = v[e] - shift;
      s1 += d;
      s2 += d * d;
    }
  }
  sh1[threadIdx.x] = s1;
  sh2[threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < cv) {  // column sums; rows >= 1 are only read here
    float a = sh1[threadIdx.x], q = sh2[threadIdx.x];
    for (int r = 1; r < nrow; ++r) {
      a += sh1[threadIdx.x + r * cv];
      q += sh2[threadIdx.x + r * cv];
    }
    sh1[threadIdx.x] = a;
    sh2[threadIdx.x] = q;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int cpg = cg / V;  // vector columns per group
    float a = 0.f, q = 0.f;
    for (int k = 0; k < cpg; ++k) {
      a += sh1[threadIdx.x * cpg + k];
      q += sh2[threadIdx.x * cpg + k];
    }
    part[((size_t)b * S + s) * G + threadIdx.x] = make_float2(a, q);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float2* __restrict__ part,
                    T* __restrict__ y, int HW, int C, int G, int S, float eps) {
  __shared__ float mean_s[32], rstd_s[32];
  const int b = blockIdx.y;
  const int cg = C / G, cv = C / V;
  const T* xb = x + (size_t)b * HW * C;
  T* yb = y + (size_t)b * HW * C;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    const float2* pb = part + (size_t)b * S * G + g;
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float2 p = pb[(size_t)s * G];
      s1 += p.x;
      s2 += p.y;
    }
    const float n = (float)HW * (float)cg;
    const float m = s1 / n;
    const float var = fmaxf(s2 / n - m * m, 0.f);
    mean_s[g] = to_f32(xb[g * cg]) + m;
    rstd_s[g] = rsqrtf(var + eps);
  }
  __syncthreads();
  const size_t nvec = (size_t)HW * cv;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c0 = (int)(i % cv) * V;
    const int g = c0 / cg;
    const float m = mean_s[g], r = rstd_s[g];
    float v[V];
    loadv<V>(xb + i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float z = (v[e] - m) * r * scale[c0 + e] + bias[c0 + e];
      v[e] = z / (1.f + expf(-z));
    }
    storev<V>(yb + i * V, v);
  }
}

template <typename T, int V>
int launch(const void* x, const void* scale, const void* bias, void* part, void* y, int B,
           int HW, int C, int G, float eps, cudaStream_t st) {
  const int cv = C / V;
  const int threads = cv * max(1, 256 / cv);
  const int S = (HW + kPixPerSlice - 1) / kPixPerSlice;
  gn_stats_kernel<T, V><<<dim3(S, B), threads, 0, st>>>(static_cast<const T*>(x),
                                                     static_cast<float2*>(part), HW, C, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per_block = kApplyThreads * kApplyVecPerThread;
  const int gx = max(1, (HW * cv + per_block - 1) / per_block);
  gn_apply_kernel<T, V><<<dim3(gx, B), kApplyThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float2*>(part), static_cast<T*>(y),
      HW, C, G, S, eps);
  return (int)cudaGetLastError();
}

// The widest vector (16 bytes at most) that divides a group's channels, so
// that a vector never straddles two groups.
template <typename T, int V>
int launch_widest(const void* x, const void* scale, const void* bias, void* part, void* y,
                  int B, int HW, int C, int G, float eps, cudaStream_t st) {
  if constexpr (V == 1) {
    return launch<T, 1>(x, scale, bias, part, y, B, HW, C, G, eps, st);
  } else {
    if ((C / G) % V == 0) return launch<T, V>(x, scale, bias, part, y, B, HW, C, G, eps, st);
    return launch_widest<T, V / 2>(x, scale, bias, part, y, B, HW, C, G, eps, st);
  }
}

}  // namespace

// Number of float2 partials the wrapper allocates as workspace.
extern "C" int rfv_gn_silu_workspace(int B, int HW, int G) {
  return B * ((HW + kPixPerSlice - 1) / kPixPerSlice) * G;
}

// x, y: [B, HW, C] contiguous, dtype per `dtype`; scale, bias: [C] float32;
// part: workspace of rfv_gn_silu_workspace float2. Requires C % G == 0,
// G <= 32 and C / V <= 256, where V is the widest vector of at most 16 bytes
// whose element count divides C / G.
extern "C" int rfv_gn_silu(const void* x, const void* scale, const void* bias, void* part,
                           void* y, int B, int HW, int C, int G, float eps, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RFV_DTYPE_BF16)
    return launch_widest<bf16, 8>(x, scale, bias, part, y, B, HW, C, G, eps, st);
  return launch_widest<float, 4>(x, scale, bias, part, y, B, HW, C, G, eps, st);
}
