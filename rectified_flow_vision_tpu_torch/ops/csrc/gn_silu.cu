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
//
// The kernels live in gn_silu.cuh, which gn_silu_dropout.cu shares.
#include "gn_silu.cuh"

// Number of float2 partials the wrapper allocates as workspace.
extern "C" int rfv_gn_silu_workspace(int B, int HW, int G) {
  return B * ((HW + rfv_gn::kPixPerSlice - 1) / rfv_gn::kPixPerSlice) * G;
}

// x, y: [B, HW, C] contiguous, dtype per `dtype`; scale, bias: [C] float32;
// part: workspace of rfv_gn_silu_workspace float2. Requires C % G == 0,
// G <= 32 and C / V <= 256, where V is the widest vector of at most 16 bytes
// whose element count divides C / G.
extern "C" int rfv_gn_silu(const void* x, const void* scale, const void* bias, void* part,
                           void* y, int B, int HW, int C, int G, float eps, int dtype,
                           void* stream) {
  return rfv_gn::launch_dtype<false>(x, scale, bias, part, y, B, HW, C, G, eps,
                                     rfv_gn::Dropout{}, dtype,
                                     static_cast<cudaStream_t>(stream));
}
