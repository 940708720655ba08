// The DiT block's passes between its GEMMs, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas TPU kernel: on the TPU, XLA fuses the JAX package's
// layer_norm, modulate, the dense bias add, GELU and the gated residual
// (rectified_flow_vision_tpu/models/dit.py block_apply, ops/primitives.py)
// into the neighbouring ops. The port ran them eagerly, one PyTorch pass
// each (cast, mean, subtract, square, mean, multiply, cast back, ...); in a
// latent serving call those passes took most of the device's time. Three
// kernels take their place in every forward (ops/fused.py differentiates the
// eager composition in the backward):
//
//   ln_modulate     out = (LN(x) * (1 + scale) + shift), per token row
//   bias_act        out = act(y + b), the dense epilogue (act: none, GELU-tanh)
//   gated_residual  out = tokens + gate * (y + b), proj / mlp2 and the residual
//
// Bound on the H100: bytes. Each kernel reads its inputs once and writes its
// output once, 16 bytes a thread at a time; shift, scale, gate ([B, C], a
// strided view of the adaLN projection, row stride `mod_stride` elements) and
// the fp32 bias are a few KB that stay in L1 / L2. ln_modulate keeps a token's
// row in registers, so its fp32 statistics cost no second read: the mean,
// then the variance as the mean of (x - mean)^2, each summed by shuffles
// within the row's threads. A row gets 8, 16 or 32 lanes of a warp or 4
// warps, the fewest that hold it in at most 8 vectors a thread (so at most
// 1024 vectors, 8192 bf16 or 4096 fp32 channels, above DiT-XL/2's 1152):
// DiT-S/2's 384 bf16 channels take half a warp, 3 vectors a lane, so that a
// warp keeps two rows' loads in flight. The pointwise kernels start 4 vectors'
// loads a thread before they use any, and find a vector's channel and batch
// by multiplying (FastDiv), not by a 64-bit division.
//
// Rounding: the eager composition's points, so that the pointwise epilogues
// are bit-equal to it and ln_modulate differs only by the order of its fp32
// sums: LN rounded to T, then 1 + scale, the product and the sum each rounded
// to T; the bias added in fp32 to the GEMM's T output and rounded to T before
// the activation or the gate. Products and sums are __fmul_rn / __fadd_rn so
// that no FMA contraction drops a rounding in fp32.
#include "common.cuh"

namespace {

constexpr int kPointThreads = 256;  // pointwise kernels: threads a block
constexpr int kPointUnroll = 4;     // vectors a thread, all loaded before any is used

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund & Montgomery,
// "Division by invariant integers using multiplication", PLDI 1994), the
// constants made on the host.
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, (uint32_t)m, s};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

// The fp32 bias of V channels starting at c0 (a multiple of V).
template <int V>
__device__ __forceinline__ void load_bias(const float* b, uint32_t c0, float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    float4 a = *reinterpret_cast<const float4*>(b + c0 + 4 * q);
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

// GELU, tanh approximation, in PyTorch's arithmetic (GeluCUDAKernelImpl).
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5f;
  constexpr float kKappa = 0.044715f;
  const float cube = x * x * x;
  const float inner = kBeta * (x + kKappa * cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

// ---- ln_modulate ----------------------------------------------------------

constexpr int kLnThreads = 128;  // threads a block: four warps, one row's at most

// Sum over the GT threads that share a row (GT lanes of a warp, aligned, or
// GT / 32 whole warps); each of them gets it. A fixed tree, so the result
// does not depend on the launch.
template <int GT>
__device__ __forceinline__ float row_sum(float v, float* red) {
  constexpr int kLanes = GT < 32 ? GT : 32;
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (GT <= 32) {
    return v;
  } else {
    constexpr int W = GT / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // red may still be read by the previous sum
    if (lane == 0) red[warp] = v;
    __syncthreads();
    const int first = (warp / W) * W;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += red[first + w];
    return s;
  }
}

// x, out: [rows, C] contiguous; rows of batch b = row / tokens read
// shift / scale at b * mod_stride. GT threads a row, NV vectors of V
// elements a thread.
template <typename T, int NV, int GT>
__global__ void __launch_bounds__(kLnThreads)
    ln_modulate_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                       const T* __restrict__ scale, T* __restrict__ out, long long rows, int C,
                       long long tokens, long long mod_stride, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RPB = kLnThreads / GT;
  __shared__ float red[kLnThreads / 32];
  const int gl = threadIdx.x % GT;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / GT;
  const bool live = row < rows;  // no early return: row_sum may hold __syncthreads
  const int nvec = C / V;
  const T* xr = x + (live ? row : 0) * (long long)C;

  float v[NV][V];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int idx = gl + k * GT;
    if (live && idx < nvec) {
      load16(xr + (size_t)idx * V, v[k]);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[k][e];
    }
  }
  const float inv_c = 1.f / (float)C;
  const float mean = row_sum<GT>(s, red) * inv_c;
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (live && gl + k * GT < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = v[k][e] - mean;
        d += c * c;
      }
    }
  }
  const float var = row_sum<GT>(d, red) * inv_c;
  if (!live) return;
  const float rstd = rsqrtf(var + eps);
  const long long b = row / tokens;
  const T* sh = shift + b * mod_stride;
  const T* sc = scale + b * mod_stride;
  T* outr = out + row * (long long)C;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int idx = gl + k * GT;
    if (idx < nvec) {
      float fs[V], fc[V];
      load16(sh + (size_t)idx * V, fs);
      load16(sc + (size_t)idx * V, fc);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ln = round_to<T>(__fmul_rn(v[k][e] - mean, rstd));
        const float prod = round_to<T>(__fmul_rn(ln, round_to<T>(__fadd_rn(1.f, fc[e]))));
        v[k][e] = __fadd_rn(prod, fs[e]);
      }
      store16(outr + (size_t)idx * V, v[k]);
    }
  }
}

constexpr int kLnMaxNV = 8;  // vectors a thread: at most 8 x 16 bytes of a row in registers

// The instance of NV vectors a thread, nv <= NV; none below NVMIN, which the
// choice of GT never asks for.
template <typename T, int GT, int NV, int NVMIN>
int launch_ln(int nv, const void* x, const void* shift, const void* scale, void* out,
              long long rows, int C, long long tokens, long long mod_stride, float eps,
              cudaStream_t st) {
  if constexpr (NV > NVMIN) {
    if (nv < NV)
      return launch_ln<T, GT, NV - 1, NVMIN>(nv, x, shift, scale, out, rows, C, tokens,
                                             mod_stride, eps, st);
  }
  constexpr int RPB = kLnThreads / GT;
  const long long blocks = (rows + RPB - 1) / RPB;
  ln_modulate_kernel<T, NV, GT><<<(unsigned)blocks, kLnThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift), static_cast<const T*>(scale),
      static_cast<T*>(out), rows, C, tokens, mod_stride, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int ln_modulate(const void* x, const void* shift, const void* scale, void* out, long long rows,
                int C, long long tokens, long long mod_stride, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = C / V;
#define RFV_LN_CASE(GT, LO, HI)                                                              \
  if (nvec <= (GT) * (HI))                                                                   \
    return launch_ln<T, GT, HI, LO>((nvec + (GT) - 1) / (GT), x, shift, scale, out, rows, C, \
                                    tokens, mod_stride, eps, st);
  RFV_LN_CASE(8, 1, 4)
  RFV_LN_CASE(16, 3, 4)
  RFV_LN_CASE(32, 3, kLnMaxNV)
  RFV_LN_CASE(128, 3, kLnMaxNV)
#undef RFV_LN_CASE
  return (int)cudaErrorInvalidValue;
}

// ---- bias_act and gated_residual -------------------------------------------

// y, out: [nvec / cvec, cvec] vectors of V, contiguous; b: [C] fp32.
// ACT 0: none, 1: GELU-tanh.
template <typename T, int ACT>
__global__ void __launch_bounds__(kPointThreads)
    bias_act_kernel(const T* __restrict__ y, const float* __restrict__ b, T* __restrict__ out,
                    uint32_t nvec, FastDiv cvec) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t base = blockIdx.x * (kPointThreads * kPointUnroll) + threadIdx.x;
  float v[kPointUnroll][V];
#pragma unroll
  for (int u = 0; u < kPointUnroll; ++u) {
    const uint32_t i = base + u * kPointThreads;
    if (i < nvec) load16(y + (size_t)i * V, v[u]);
  }
#pragma unroll
  for (int u = 0; u < kPointUnroll; ++u) {
    const uint32_t i = base + u * kPointThreads;
    if (i < nvec) {
      float bb[V];
      load_bias<V>(b, (i - divide(i, cvec) * cvec.d) * V, bb);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float h = __fadd_rn(v[u][e], bb[e]);
        v[u][e] = ACT ? gelu_tanh(round_to<T>(h)) : h;
      }
      store16(out + (size_t)i * V, v[u]);
    }
  }
}

// tokens, y, out: [nvec / cvec, cvec] vectors of V, contiguous; row r is of
// batch r / tokens_per, whose gate row is at gate + batch * gate_stride;
// b: [C] fp32.
template <typename T>
__global__ void __launch_bounds__(kPointThreads)
    gated_residual_kernel(const T* __restrict__ tokens, const T* __restrict__ y,
                          const float* __restrict__ b, const T* __restrict__ gate,
                          T* __restrict__ out, uint32_t nvec, FastDiv cvec, FastDiv tokens_per,
                          long long gate_stride) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t base = blockIdx.x * (kPointThreads * kPointUnroll) + threadIdx.x;
  float tv[kPointUnroll][V], yv[kPointUnroll][V];
#pragma unroll
  for (int u = 0; u < kPointUnroll; ++u) {
    const uint32_t i = base + u * kPointThreads;
    if (i < nvec) {
      load16(tokens + (size_t)i * V, tv[u]);
      load16(y + (size_t)i * V, yv[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kPointUnroll; ++u) {
    const uint32_t i = base + u * kPointThreads;
    if (i < nvec) {
      const uint32_t row = divide(i, cvec);
      const uint32_t c0 = (i - row * cvec.d) * V;
      float bb[V], g[V];
      load_bias<V>(b, c0, bb);
      load16(gate + (long long)divide(row, tokens_per) * gate_stride + c0, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float h = round_to<T>(__fadd_rn(yv[u][e], bb[e]));
        tv[u][e] = __fadd_rn(tv[u][e], round_to<T>(__fmul_rn(g[e], h)));
      }
      store16(out + (size_t)i * V, tv[u]);
    }
  }
}

unsigned point_blocks(uint32_t nvec) {
  constexpr uint32_t per = kPointThreads * kPointUnroll;
  return (nvec + per - 1) / per;
}

template <typename T>
int bias_act(const void* y, const float* b, void* out, long long n, int C, int act,
             cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t nvec = (uint32_t)(n / V);
  const FastDiv cvec = fast_div((uint32_t)(C / V));
  if (act)
    bias_act_kernel<T, 1><<<point_blocks(nvec), kPointThreads, 0, st>>>(
        static_cast<const T*>(y), b, static_cast<T*>(out), nvec, cvec);
  else
    bias_act_kernel<T, 0><<<point_blocks(nvec), kPointThreads, 0, st>>>(
        static_cast<const T*>(y), b, static_cast<T*>(out), nvec, cvec);
  return (int)cudaGetLastError();
}

template <typename T>
int gated_residual(const void* tokens, const void* y, const float* b, const void* gate, void* out,
                   long long n, int C, long long tokens_per, long long gate_stride,
                   cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t nvec = (uint32_t)(n / V);
  gated_residual_kernel<T><<<point_blocks(nvec), kPointThreads, 0, st>>>(
      static_cast<const T*>(tokens), static_cast<const T*>(y), b, static_cast<const T*>(gate),
      static_cast<T*>(out), nvec, fast_div((uint32_t)(C / V)), fast_div((uint32_t)tokens_per),
      gate_stride);
  return (int)cudaGetLastError();
}

constexpr long long kMaxVectors = 1ll << 31;  // FastDiv's range

}  // namespace

// x, out: [rows, C] contiguous (rows = B * tokens); shift, scale: row b at
// b * mod_stride elements, unit stride along C. C a multiple of 8, pointers
// and mod_stride 16-byte aligned; C at most 8192 vectors of 16 bytes.
extern "C" int rfv_ln_modulate(const void* x, const void* shift, const void* scale, void* out,
                               long long rows, int C, long long tokens, long long mod_stride,
                               float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RFV_DTYPE_BF16)
    return ln_modulate<bf16>(x, shift, scale, out, rows, C, tokens, mod_stride, eps, st);
  return ln_modulate<float>(x, shift, scale, out, rows, C, tokens, mod_stride, eps, st);
}

// y, out: n elements, rows of C contiguous; b: [C] fp32; act 0 none, 1
// GELU-tanh. Fewer than 2^31 vectors of 16 bytes.
extern "C" int rfv_bias_act(const void* y, const void* b, void* out, long long n, int C, int act,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  if (n / (dtype == RFV_DTYPE_BF16 ? 8 : 4) >= kMaxVectors) return (int)cudaErrorInvalidValue;
  if (dtype == RFV_DTYPE_BF16) return bias_act<bf16>(y, bf, out, n, C, act, st);
  return bias_act<float>(y, bf, out, n, C, act, st);
}

// tokens, y, out: n elements, rows of C contiguous, `tokens_per` rows a batch;
// b: [C] fp32; gate: row b at b * gate_stride elements. Fewer than 2^31
// vectors of 16 bytes.
extern "C" int rfv_gated_residual(const void* tokens, const void* y, const void* b,
                                  const void* gate, void* out, long long n, int C,
                                  long long tokens_per, long long gate_stride, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  if (n / (dtype == RFV_DTYPE_BF16 ? 8 : 4) >= kMaxVectors) return (int)cudaErrorInvalidValue;
  if (dtype == RFV_DTYPE_BF16)
    return gated_residual<bf16>(tokens, y, bf, gate, out, n, C, tokens_per, gate_stride, st);
  return gated_residual<float>(tokens, y, bf, gate, out, n, C, tokens_per, gate_stride, st);
}
