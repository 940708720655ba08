// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes a plain C entry point that launches on the
// stream it is given and returns cudaGetLastError(), so the Python
// wrapper (ops/build.py, loaded with ctypes) can raise on a refused launch.
// Element types: dtype code 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define RFV_DTYPE_F32 0
#define RFV_DTYPE_BF16 1

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Round a float through T (the rounding the plain PyTorch version applies
// when it stores an intermediate in the working dtype).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// V consecutive values as floats: one 16-byte access when V elements fill
// 16 bytes, else V scalar accesses (no alignment beyond the element's).
template <int V, typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    load16(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_f32(p[e]);
  }
}

template <int V, typename T>
__device__ __forceinline__ void storev(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    store16(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = from_f32<T>(v[e]);
  }
}

// Asynchronous 16-byte global->shared copy; src_bytes = 0 writes zeros
// (used for the conv's zero halo instead of a padded copy of x).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sum of v over the block; every thread gets the result. `red` holds at
// least blockDim.x / 32 floats. Deterministic: a fixed tree per launch shape.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  return s;
}
