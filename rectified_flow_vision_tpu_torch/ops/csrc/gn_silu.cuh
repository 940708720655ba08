// GroupNorm statistics and the normalise / affine / SiLU pass over an NHWC
// tensor, shared by gn_silu.cu, gn_silu_dropout.cu and attention.cu (design
// notes in gn_silu.cu). The apply pass optionally ends in dropout: kept
// values are scaled by 1/keep in fp32 and dropped ones are zero, before the
// one rounding to the output type; the bits come from dropout_bits
// (common.cuh). Without SILU it is the plain GroupNorm (the attention
// block's normalised input).
#pragma once

#include "common.cuh"

namespace rfv_gn {

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

// Dropout of the apply pass: `seed` points at one int32 on the device, so the
// caller never has to bring a seed drawn there to the host.
struct Dropout {
  const int* seed;
  uint32_t thresh;  // keep where bits < thresh
  float inv_keep;
};

template <typename T, int V, bool DROP, bool SILU>
__device__ __forceinline__ void gn_apply_body(const T* __restrict__ x,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias,
                                              const float2* __restrict__ part,
                                              T* __restrict__ y, int HW, int C, int G, int S,
                                              float eps, Dropout drop) {
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
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)*drop.seed;
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
      v[e] = SILU ? z / (1.f + expf(-z)) : z;
    }
    if constexpr (DROP) {
      uint32_t bits[V];
      dropout_bits<V>(seed, (uint32_t)b, (uint32_t)(i * V), bits);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = bits[e] < drop.thresh ? v[e] * drop.inv_keep : 0.f;
    }
    storev<V>(yb + i * V, v);
  }
}

// Entry kernels with names of their own, so that a profiler trace tells
// gn_silu's apply pass from gn_silu_dropout's and the attention block's.
template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float2* __restrict__ part,
                    T* __restrict__ y, int HW, int C, int G, int S, float eps) {
  gn_apply_body<T, V, false, true>(x, scale, bias, part, y, HW, C, G, S, eps, Dropout{});
}

template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads)
    gn_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, const float2* __restrict__ part,
                   T* __restrict__ y, int HW, int C, int G, int S, float eps) {
  gn_apply_body<T, V, false, false>(x, scale, bias, part, y, HW, C, G, S, eps, Dropout{});
}

template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads)
    gn_apply_dropout_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ bias, const float2* __restrict__ part,
                            T* __restrict__ y, int HW, int C, int G, int S, float eps,
                            Dropout drop) {
  gn_apply_body<T, V, true, true>(x, scale, bias, part, y, HW, C, G, S, eps, drop);
}

template <typename T, int V, bool DROP, bool SILU>
int launch(const void* x, const void* scale, const void* bias, void* part, void* y, int B,
           int HW, int C, int G, float eps, Dropout drop, cudaStream_t st) {
  const int cv = C / V;
  const int threads = cv * max(1, 256 / cv);
  const int S = (HW + kPixPerSlice - 1) / kPixPerSlice;
  gn_stats_kernel<T, V><<<dim3(S, B), threads, 0, st>>>(static_cast<const T*>(x),
                                                     static_cast<float2*>(part), HW, C, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per_block = kApplyThreads * kApplyVecPerThread;
  const int gx = max(1, (HW * cv + per_block - 1) / per_block);
  const dim3 grid(gx, B);
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float2* pt = static_cast<const float2*>(part);
  T* yt = static_cast<T*>(y);
  if constexpr (DROP)
    gn_apply_dropout_kernel<T, V><<<grid, kApplyThreads, 0, st>>>(xt, sc, bi, pt, yt, HW, C, G,
                                                                 S, eps, drop);
  else if constexpr (SILU)
    gn_apply_kernel<T, V><<<grid, kApplyThreads, 0, st>>>(xt, sc, bi, pt, yt, HW, C, G, S, eps);
  else
    gn_norm_kernel<T, V><<<grid, kApplyThreads, 0, st>>>(xt, sc, bi, pt, yt, HW, C, G, S, eps);
  return (int)cudaGetLastError();
}

// The widest vector (16 bytes at most) that divides a group's channels, so
// that a vector never straddles two groups.
template <typename T, int V, bool DROP, bool SILU>
int launch_widest(const void* x, const void* scale, const void* bias, void* part, void* y,
                  int B, int HW, int C, int G, float eps, Dropout drop, cudaStream_t st) {
  if constexpr (V == 1) {
    return launch<T, 1, DROP, SILU>(x, scale, bias, part, y, B, HW, C, G, eps, drop, st);
  } else {
    if ((C / G) % V == 0)
      return launch<T, V, DROP, SILU>(x, scale, bias, part, y, B, HW, C, G, eps, drop, st);
    return launch_widest<T, V / 2, DROP, SILU>(x, scale, bias, part, y, B, HW, C, G, eps, drop,
                                               st);
  }
}

template <bool DROP, bool SILU = true>
int launch_dtype(const void* x, const void* scale, const void* bias, void* part, void* y, int B,
                 int HW, int C, int G, float eps, Dropout drop, int dtype, cudaStream_t st) {
  if (dtype == RFV_DTYPE_BF16)
    return launch_widest<bf16, 8, DROP, SILU>(x, scale, bias, part, y, B, HW, C, G, eps, drop,
                                              st);
  return launch_widest<float, 4, DROP, SILU>(x, scale, bias, part, y, B, HW, C, G, eps, drop,
                                             st);
}

}  // namespace rfv_gn
