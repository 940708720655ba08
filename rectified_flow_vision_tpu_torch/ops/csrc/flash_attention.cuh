// The fp32 flash-attention kernels (flash_attention_f32.cu), launched by the
// C entry points of flash_attention.cu for the fp32 model path and checks.
#pragma once

#include "common.cuh"

namespace rfv_flash {

// Layouts as in flash_attention.cu. dp: D padded to a multiple of 16 (16 to
// 128), the width the kernels are compiled for; columns past D are read as
// zeros and not stored. Return a cudaError_t code.
int fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse, int B, int T,
            int H, int D, int dp, long long sb, long long st, long long sh, float scale,
            cudaStream_t stream);

// dkv and dq; delta must be written before (flash_attention.cu).
int bwd_f32(const float* q, const float* k, const float* v, const float* d_out, const float* lse,
            const float* delta, float* dq, float* dk, float* dv, int B, int T, int H, int D,
            int dp, long long sb, long long st, long long sh, long long gb, long long gt,
            long long gh, float scale, cudaStream_t stream);

// Any D > 128 (a multiple of 8), fp32, in 64-column chunks: the *_wide
// kernels of flash_attention_f32.cu, with the layouts above (fp32 heads
// above 128, and bf16 heads above 256 on fp32 copies).
int fwd_f32_wide(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                 int T, int H, int D, long long sb, long long st, long long sh, float scale,
                 cudaStream_t stream);

int bwd_f32_wide(const float* q, const float* k, const float* v, const float* d_out,
                 const float* lse, const float* delta, float* dq, float* dk, float* dv, int B,
                 int T, int H, int D, long long sb, long long st, long long sh, long long gb,
                 long long gt, long long gh, float scale, cudaStream_t stream);

}  // namespace rfv_flash
