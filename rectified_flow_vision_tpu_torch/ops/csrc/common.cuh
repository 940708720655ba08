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

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
// SC 2011), written out: ten rounds of two 32x32->64 multiplies, the key
// bumped by the Weyl constants between rounds. A pure function of (counter,
// key), so any thread can produce any element's bits.
constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kPhiloxW0;
    k.y += kPhiloxW1;
  }
  return c;
}

// The dropout bits of V consecutive elements of one image, starting at
// element idx0 (a multiple of V) of its flat (H*W*C) index. Contract, shared
// with the plain PyTorch version (ops/gn_silu_dropout.py): key = (seed,
// kDropoutKey1), counter = (image, element / 4, 0, 0), lane = element % 4.
// The bits depend on nothing else: not on the block size, the vector width or
// the element type.
constexpr uint32_t kDropoutKey1 = 0x52465644u;

template <int V>
__device__ __forceinline__ void dropout_bits(uint32_t seed, uint32_t image, uint32_t idx0,
                                             uint32_t (&bits)[V]) {
  const uint2 key = make_uint2(seed, kDropoutKey1);
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const uint4 r = philox4x32_10(make_uint4(image, idx0 / 4 + q, 0u, 0u), key);
      bits[4 * q] = r.x;
      bits[4 * q + 1] = r.y;
      bits[4 * q + 2] = r.z;
      bits[4 * q + 3] = r.w;
    }
  } else {  // V is 1 or 2: the V elements share one counter
    const uint4 r = philox4x32_10(make_uint4(image, idx0 / 4, 0u, 0u), key);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const uint32_t lane = (idx0 + e) & 3u;
      bits[e] = lane == 0 ? r.x : lane == 1 ? r.y : lane == 2 ? r.z : r.w;
    }
  }
}
