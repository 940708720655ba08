// The fp32 flash-attention kernels (flash_attention_f32.cu, the backward up
// to D = 128 in flash_attention_f32_bwd.cu) and the streamed bf16 kernels
// (flash_attention_streamed.cu), launched by the C entry points of
// flash_attention.cu.
#pragma once

#include "common.cuh"

namespace rfv_flash {

// Layouts as in flash_attention.cu. dp: the width the kernels are compiled
// for, a multiple of 8 from 8 to 128 (3xTF32 tensor-core kernels); columns
// past D are read as zeros and not stored. Return a cudaError_t code.
int fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse, int B, int T,
            int H, int D, int dp, long long sb, long long st, long long sh, float scale,
            cudaStream_t stream);

// dkv and dq (flash_attention_f32_bwd.cu); delta must be written before
// (flash_attention.cu).
int bwd_f32(const float* q, const float* k, const float* v, const float* d_out, const float* lse,
            const float* delta, float* dq, float* dk, float* dv, int B, int T, int H, int D,
            int dp, long long sb, long long st, long long sh, long long gb, long long gt,
            long long gh, float scale, cudaStream_t stream);

// Any D > 128 (a multiple of 8), fp32: the *_wide kernels of
// flash_attention_f32.cu, with the layouts above. A block owns every output
// column of its rows up to D = 256 (O and dQ up to 384), and the fewest
// chunks above it.
int fwd_f32_wide(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                 int T, int H, int D, long long sb, long long st, long long sh, float scale,
                 cudaStream_t stream);

int bwd_f32_wide(const float* q, const float* k, const float* v, const float* d_out,
                 const float* lse, const float* delta, float* dq, float* dk, float* dv, int B,
                 int T, int H, int D, long long sb, long long st, long long sh, long long gb,
                 long long gt, long long gh, float scale, cudaStream_t stream);

// Any D > 256 (a multiple of 8), bf16: the wgmma + TMA kernels of
// flash_attention_streamed.cu, D streamed in 64-column boxes, the outputs in
// chunks of 192 or 256 columns. q, k, v are read in place (16-byte aligned
// rows); the layouts are those above. The backward launches dkv and dq;
// delta must be written before.
int fwd_bf16_streamed(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int T, int H, int D, long long sb, long long st, long long sh, float scale,
                      cudaStream_t stream);

int bwd_bf16_streamed(const void* q, const void* k, const void* v, const void* d_out,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                      int T, int H, int D, long long sb, long long st, long long sh, long long gb,
                      long long gt, long long gh, float scale, cudaStream_t stream);

}  // namespace rfv_flash
