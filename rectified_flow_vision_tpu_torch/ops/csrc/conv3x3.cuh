// The bf16 implicit-GEMM kernel of conv3x3.cu (wgmma + TMA), which the
// attention block's projections share as a one-tap "conv" over the pixels.
#pragma once

#include "common.cuh"

namespace rfv_conv {

// y[N, H, W, Cout] = T(conv(x, w) + bias), or T(resid + T(conv(x, w) + bias))
// when resid (same shape as y) is given; bf16, NHWC, contiguous. taps 9: w is
// [Cout, 3, 3, Cin], stride 1, pad 1, Cin % 16 == 0; taps 1: w is
// [Cout, Cin], Cin and Cout multiples of 8. bn, stages, wb, hb: the tiling
// of ops/conv3x3.py tile_config. Returns a cudaError_t code.
int launch_bf16(const void* x, const void* w, const void* bias, const void* resid, void* y, int N,
                int H, int W, int Cin, int Cout, int taps, int bn, int stages, int wb, int hb,
                cudaStream_t st);

}  // namespace rfv_conv
