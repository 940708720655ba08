// GroupNorm + SiLU + dropout in one pass, and the mask regenerated for the
// backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels rectified_flow_vision_tpu/ops/pallas_kernels.py
// gn_silu_dropout (body _gn_silu_dropout_kernel) and dropout_mask_apply (body
// _dropout_mask_kernel), which draw their bits from the TPU core's own
// generator, seeded per image.
//
// Bound on the H100: bytes, for both. gn_silu_dropout reads x and writes y
// like gn_silu (gn_silu.cu: the same one-pass cluster kernel, with the mask
// folded in before the one rounding); its backward is gn_silu.cu's
// rfv_gn_silu_backward with a seed, which regenerates the mask from the
// cotangent's element index. dropout_mask_apply reads g and writes
// g * mask / keep: the backward no longer needs it, it stays for any caller
// that holds a cotangent apart from x. A mask tensor is never written or
// read: the bits are Philox4x32-10 of (seed, image, element) (common.cuh),
// the element's index taken in the unsharded activation under tensor
// parallelism (rfv_gn::Dropout),
// about fifteen integer operations per element, which every pass recomputes.
//
// The TPU's bits cannot be replayed, so parity with the JAX package is by
// contract: the same seed and shape give the same mask in the forward, in
// the backward and in the plain PyTorch version (ops/gn_silu_dropout.py), the
// keep fraction is 1 - rate, and kept values are gn_silu / keep.
#include "gn_silu.cuh"

namespace {

template <typename T, int V>
__global__ void __launch_bounds__(256)
    dropout_mask_apply_kernel(const T* __restrict__ g, const int* __restrict__ seed_ptr,
                              T* __restrict__ out, size_t nvec, uint32_t thresh,
                              float inv_keep) {
  const uint32_t b = blockIdx.y;
  const uint32_t seed = (uint32_t)*seed_ptr;
  const T* gb = g + (size_t)b * nvec * V;
  T* ob = out + (size_t)b * nvec * V;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    float v[V];
    loadv<V>(gb + i * V, v);
    uint32_t bits[V];
    dropout_bits<V>(seed, b, (uint32_t)(i * V), bits);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = bits[e] < thresh ? v[e] * inv_keep : 0.f;
    storev<V>(ob + i * V, v);
  }
}

// The widest vector (16 bytes at most) that divides one image's element
// count, so that a vector never straddles two images.
template <typename T, int V>
int mask_launch_widest(const void* g, const void* seed, void* out, int B, long long n,
                       uint32_t thresh, float inv_keep, cudaStream_t st) {
  if constexpr (V > 1) {
    if (n % V) return mask_launch_widest<T, V / 2>(g, seed, out, B, n, thresh, inv_keep, st);
  }
  const size_t nvec = (size_t)(n / V);
  const size_t per_block = 256 * 8;
  const unsigned gx = (unsigned)((nvec + per_block - 1) / per_block);
  dropout_mask_apply_kernel<T, V><<<dim3(gx > 0 ? gx : 1, B), 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<const int*>(seed), static_cast<T*>(out), nvec,
      thresh, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// As rfv_gn_silu, then dropout: seed points at one int32 on the device,
// an element is kept where its bits < thresh and scaled by inv_keep. c_off,
// c_total: the channels' place in an unsharded activation of c_total
// channels (rfv_gn::Dropout; 0, 0 for none). Requires HW * c_total < 2^32 as
// well.
extern "C" int rfv_gn_silu_dropout(const void* x, const void* scale, const void* bias,
                                   const void* seed, void* stats, void* y, int B, int HW, int C,
                                   int G, float eps, unsigned thresh, float inv_keep, int c_off,
                                   int c_total, int dtype, void* stream) {
  const rfv_gn::Dropout drop{static_cast<const int*>(seed), thresh, inv_keep, (uint32_t)c_off,
                             (uint32_t)c_total};
  return rfv_gn::forward_dtype<true, true>(x, scale, bias, stats, y, B, HW, C, G, eps, drop,
                                           dtype, static_cast<cudaStream_t>(stream));
}

// g, out: [B, n] contiguous, dtype per `dtype`; n < 2^32 elements an image,
// B <= 65535. out = g * inv_keep where the element's bits < thresh, else 0.
extern "C" int rfv_dropout_mask_apply(const void* g, const void* seed, void* out, int B,
                                      long long n, unsigned thresh, float inv_keep, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RFV_DTYPE_BF16)
    return mask_launch_widest<bf16, 8>(g, seed, out, B, n, thresh, inv_keep, st);
  return mask_launch_widest<float, 4>(g, seed, out, B, n, thresh, inv_keep, st);
}
