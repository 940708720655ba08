// GroupNorm + SiLU over an NHWC tensor, forward and backward, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rectified_flow_vision_tpu/ops/pallas_kernels.py
// gn_silu (body _gn_silu_kernel, statistics _group_stats), which holds one
// image's (H*W, C) slab in VMEM per sequential grid step, and the fused XLA
// VJP that the JAX package's custom_vjp takes for its backward
// (rectified_flow_vision_tpu/ops/fused.py _gn_silu_bwd).
//
// Bound on the H100: bytes. The forward reads x once and writes y once; the
// backward reads x and the cotangent g once and writes dx once. Their
// arithmetic is a few operations per element (an exponential, a dozen FMAs),
// far below the ~295 operations per byte where the tensor cores would bound
// them.
//
// Design (gn_silu.cuh): the TPU's VMEM slab becomes the shared memory of a
// thread-block cluster. One cluster of N <= 8 blocks per image; each block
// bulk-copies its contiguous run of pixels into shared memory once (at most
// 64 KB where N <= 8 allows it, so that three blocks share an SM and one
// block's loads overlap another's stores; 1.5 MB slabs take 192 KB a block),
// and the per-group sums cross the cluster through distributed shared memory.
// The run arrives in up to 16 pieces, each on its own mbarrier, and the
// first pass starts on the first piece. A block takes 256 threads for each
// 64 KB of its run, so that a large run does not leave its SM with too few
// warps to hide the latency of the arithmetic. With the run resident each
// block's statistics are exact two-pass (its mean, then the sum of squares
// about it), at no cost in device memory traffic, and the image's follow
// from every run's by Chan et al.'s pairwise update in one exchange across
// the cluster (on the H100 a second exchange cost ~2.5 us of a 64 KB
// block's ~20). The output is written over the run in place and leaves with
// one bulk store, so a block that ends hands its SM to the next while its
// writes drain. A backward run that does not fit (2 x a slab above ~1.8 MB)
// stays in device memory, read on every pass by 8 blocks an image.
//
// A forward slab above a cluster's ~1.8 MB (the ConvVAE decode's 2-8 MB a
// bf16 image at batch 64, FLUX's decode up to 128 MB at batch 1) takes the
// streamed plan instead: eight blocks an image would leave most of the 132
// SMs idle at a small batch and read x three times. The image is spread
// over as many blocks as fill the card (its runs resident in shared memory
// where the card holds them all, else read twice from device memory), the
// per-run sums cross blocks through device memory, and the image's last
// block to arrive merges them in run order and releases the others: x is
// read once (twice where the runs do not fit) and y written once.
//
// The sigmoid of bf16 data is one tanh.approx, of fp32 data an exponential
// and a reciprocal: with the memory traffic at its least, the
// special-function unit is what the arithmetic waits on.
//
// The forward writes each (image, group)'s mean and 1/sigma, which the
// backward reads:
//   z = gamma xhat + beta, xhat = (x - mean) / sigma
//   dz = g sigmoid(z) (1 + z (1 - sigmoid(z)))
//   dbeta_c = sum_{b,p} dz, dgamma_c = sum_{b,p} dz xhat
//   a = mean_group(dz gamma), c = mean_group(dz gamma xhat)
//   dx = (dz gamma - a - xhat c) / sigma
// The first pass over the image computes dz (the dropout mask applied
// there, once) and keeps it, rounded to the data type, over g in shared
// memory (in dx where the run is not resident); the second computes dx from
// x and the kept dz, with no sigmoid. Each image's channel sums cross its
// cluster as the statistics do; the parameter gradients are the per-image
// sums added in image order by a small second kernel: no atomics, the same
// bits on every run.
#include "gn_silu.cuh"

// x, y: [B, HW, C] contiguous, dtype per `dtype`; scale, bias: [C] float32;
// stats: [B, G] float2 (mean, 1/sigma), written for the backward. *need: the
// workspace the call takes, 0 where an image's slab is resident in one
// cluster; the streamed plan launches only where work (16-byte aligned)
// holds work_bytes >= *need, so a caller without one calls again with it.
// Requires C % G == 0, G <= 32 and C / V <= 256, where V is the widest vector
// of at most 16 bytes whose element count divides C / G.
extern "C" int rfv_gn_silu(const void* x, const void* scale, const void* bias, void* stats,
                           void* y, void* work, long long work_bytes, long long* need, int B,
                           int HW, int C, int G, float eps, int dtype, void* stream) {
  return rfv_gn::gn_silu_dtype(x, scale, bias, stats, y, work, work_bytes, need, B, HW, C, G,
                               eps, dtype, static_cast<cudaStream_t>(stream));
}

// The backward of rfv_gn_silu, or of rfv_gn_silu_dropout when seed is not
// null (the mask regenerated from it: g' = g * inv_keep where the element's
// bits < thresh, else 0). x, g, dx: [B, HW, C] contiguous in `dtype`; scale,
// bias: [C] float32; stats: the forward's [B, G] float2; part: [B, C] float2
// workspace; dscale, dbias: [C] float32. c_off, c_total: the channels'
// place in an unsharded activation (rfv_gn::Dropout; 0, 0 for none).
// Contract as rfv_gn_silu.
extern "C" int rfv_gn_silu_backward(const void* x, const void* g, const void* scale,
                                    const void* bias, const void* stats, const void* seed,
                                    void* part, void* dx, void* dscale, void* dbias, int B,
                                    int HW, int C, int G, unsigned thresh, float inv_keep,
                                    int c_off, int c_total, int dtype, void* stream) {
  if (C % G || G > rfv_gn::kMaxGroups || B < 1 || B > 65535 || HW < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float2* s2 = static_cast<const float2*>(stats);
  float2* pt = static_cast<float2*>(part);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  const rfv_gn::Dropout drop{static_cast<const int*>(seed), thresh, inv_keep, (uint32_t)c_off,
                             (uint32_t)c_total};
  if (dtype == RFV_DTYPE_BF16) {
    const rfv_gn::BwdArgs<bf16> a{static_cast<const bf16*>(x), static_cast<const bf16*>(g), sc,
                                  bi, s2, pt, static_cast<bf16*>(dx), HW, C, G, 0, drop};
    return seed ? rfv_gn::backward<bf16, 8, true>(a, ds, db, B, st)
                : rfv_gn::backward<bf16, 8, false>(a, ds, db, B, st);
  }
  const rfv_gn::BwdArgs<float> a{static_cast<const float*>(x), static_cast<const float*>(g), sc,
                                 bi, s2, pt, static_cast<float*>(dx), HW, C, G, 0, drop};
  return seed ? rfv_gn::backward<float, 4, true>(a, ds, db, B, st)
              : rfv_gn::backward<float, 4, false>(a, ds, db, B, st);
}
