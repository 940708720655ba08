// Standalone inverted dropout, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rectified_flow_vision_tpu/ops/pallas_kernels.py
// dropout, which views any tensor as [rows, 1024], draws each block's bits
// from the TPU core's own generator and keeps an element where its bits are
// below keep * 2^32, scaled by 1 / keep.
//
// Bound on the H100: bytes (x read once, the result written once; about
// fifteen integer operations per element for the bits). One elementwise pass
// over a flat grid, so the first axis may be of any length.
//
// The TPU's bits cannot be replayed, so parity with the JAX package is by
// contract (same seed same mask, keep fraction 1 - rate, kept values x / keep).
// The bits are those of every dropout in the port (common.cuh): Philox4x32-10
// of (seed, index along the first axis, element index within it), so the mask
// equals the plain PyTorch version's (ops/dropout.py) bit for bit, and the
// backward is this kernel applied to the gradient with the same seed.
#include "common.cuh"

namespace {

template <typename T, int V>
__global__ void __launch_bounds__(256)
    dropout_kernel(const T* __restrict__ x, const int* __restrict__ seed_ptr, T* __restrict__ out,
                   size_t total_vec, size_t image_vec, uint32_t thresh, float inv_keep) {
  const uint32_t seed = (uint32_t)*seed_ptr;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total_vec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t image = i / image_vec;
    const size_t within = i - image * image_vec;
    float val[V];
    loadv<V>(x + i * V, val);
    uint32_t bits[V];
    dropout_bits<V>(seed, (uint32_t)image, (uint32_t)(within * V), bits);
#pragma unroll
    for (int e = 0; e < V; ++e) val[e] = bits[e] < thresh ? val[e] * inv_keep : 0.f;
    storev<V>(out + i * V, val);
  }
}

// The widest vector (16 bytes at most) that divides one image's element
// count, so that a vector never straddles two images.
template <typename T, int V>
int launch_widest(const void* x, const void* seed, void* out, long long B, long long n,
                  uint32_t thresh, float inv_keep, cudaStream_t st) {
  if constexpr (V > 1) {
    if (n % V) return launch_widest<T, V / 2>(x, seed, out, B, n, thresh, inv_keep, st);
  }
  const size_t image_vec = (size_t)(n / V);
  const size_t total_vec = image_vec * (size_t)B;
  const size_t per_block = 256 * 4;
  size_t blocks = (total_vec + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffull) blocks = 0x7fffffffull;
  dropout_kernel<T, V><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(seed), static_cast<T*>(out), total_vec,
      image_vec, thresh, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, n] contiguous, dtype per `dtype`; B < 2^32 and n < 2^32.
// out = x * inv_keep where the element's bits < thresh, else 0; seed points
// at one int32 on the device.
extern "C" int rfv_dropout(const void* x, const void* seed, void* out, long long B, long long n,
                           unsigned thresh, float inv_keep, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RFV_DTYPE_BF16)
    return launch_widest<bf16, 8>(x, seed, out, B, n, thresh, inv_keep, st);
  return launch_widest<float, 4>(x, seed, out, B, n, thresh, inv_keep, st);
}
