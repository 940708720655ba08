// QK-RMSNorm + rotary embedding of a joint attention, hand-written for
// Hopper (sm_90a).
//
// Replaces no Pallas TPU kernel: the JAX package has no text-conditioned
// transformer. FLUX's blocks (models/flux.py) normalise every head of q and
// k by its RMS in fp32, scale it by a learned [D] vector, rotate adjacent
// pairs by the token's angles and attend over text tokens followed by image
// tokens. Eager, that is a dozen passes over q and k and a cat of q, k and v
// a block; this kernel reads one stream's qkv projection once and writes q,
// k and v into the stream's rows of the joint [B, T, 3, H, D] buffer that
// flash attention reads in place (ops/qk_norm_rope.py):
//
//   q, k:  n = x * rsqrt(mean(x^2) + eps) * scale  (fp32)
//          (n[2j], n[2j+1]) -> (c n[2j] - s n[2j+1], s n[2j] + c n[2j+1])
//   v:     copied
//
// with (c, s) = (cos, sin) of row `off + t` of the joint tables [T, D / 2].
//
// Bound on the H100: bytes. One block a token, one thread per 16-byte
// vector of q (and the same vector of k and of v): a head's D / V vectors
// sit on that many adjacent lanes of one warp (a power of two up to 32), so
// its sum of squares is a butterfly of shuffles among them, and the angles a
// thread needs (V / 2 pairs) and the scales are a few cached bytes. Every
// product and sum is __fmul_rn / __fadd_rn / __fsub_rn (no FMA contraction),
// so that the kernel rounds where the plain version does: only the order of
// the sum of squares and rsqrtf differ.
#include "common.cuh"

namespace {

// V consecutive fp32 values of a table or a scale vector, 16-byte aligned
// where V is 4 or 8 (two or one float4), 8-byte aligned where V is 2.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else {
    static_assert(V == 2, "a thread holds 2, 4 or 8 fp32 values");
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  }
}

// qkv: [rows, 3C] (rows = B * tokens_in), the stream's projection; out:
// [B, tokens_out, 3C]; row r = b * tokens_in + t goes to out row
// b * tokens_out + off + t and reads table row off + t. LH lanes a head.
template <typename T, int LH>
__global__ void __launch_bounds__(1024)
    qk_norm_rope_kernel(const T* __restrict__ qkv, const float* __restrict__ q_scale,
                        const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, T* __restrict__ out, int tokens_in,
                        long long tokens_out, int off, int C, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int P = V / 2;  // pairs a thread
  constexpr int D = LH * V;
  const int i = threadIdx.x;
  const bool live = i < C / V;  // whole heads are dead: no shuffle mixes the two
  const long long row = blockIdx.x;
  const long long b = row / tokens_in;
  const int t = (int)(row - b * tokens_in);
  const T* src = qkv + row * 3ll * C;
  T* dst = out + (b * tokens_out + off + t) * 3ll * C;
  const int d0 = (i % LH) * V;

  float c[P], s[P];
  if (live) {
    load_f32<P>(cos_t + (long long)(off + t) * (D / 2) + d0 / 2, c);
    load_f32<P>(sin_t + (long long)(off + t) * (D / 2) + d0 / 2, s);
  }
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float x[V];
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = 0.f;
    if (live) load16(src + (long long)which * C + (long long)i * V, x);
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) ss = __fadd_rn(ss, __fmul_rn(x[e], x[e]));
#pragma unroll
    for (int o = LH / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), eps));
    if (live) {
      float sc[V], y[V];
      load_f32<V>((which ? k_scale : q_scale) + d0, sc);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float a = __fmul_rn(__fmul_rn(x[2 * p], rr), sc[2 * p]);
        const float bb = __fmul_rn(__fmul_rn(x[2 * p + 1], rr), sc[2 * p + 1]);
        y[2 * p] = __fsub_rn(__fmul_rn(c[p], a), __fmul_rn(s[p], bb));
        y[2 * p + 1] = __fadd_rn(__fmul_rn(s[p], a), __fmul_rn(c[p], bb));
      }
      store16(dst + (long long)which * C + (long long)i * V, y);
    }
  }
  if (live) {
    const long long at = 2ll * C + (long long)i * V;
    *reinterpret_cast<uint4*>(dst + at) = *reinterpret_cast<const uint4*>(src + at);
  }
}

template <typename T, int LH>
int launch(const void* qkv, const float* qs, const float* ks, const float* cs, const float* sn,
           void* out, long long rows, int tokens_in, long long tokens_out, int off, int C,
           float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int threads = (C / V + 31) / 32 * 32;
  qk_norm_rope_kernel<T, LH><<<(unsigned)rows, threads, 0, st>>>(
      static_cast<const T*>(qkv), qs, ks, cs, sn, static_cast<T*>(out), tokens_in, tokens_out,
      off, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int qk_norm_rope(const void* qkv, const float* qs, const float* ks, const float* cs,
                 const float* sn, void* out, long long rows, int tokens_in, long long tokens_out,
                 int off, int C, int D, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (D % V || C % D || C / V > 1024 || rows <= 0 || rows >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  switch (D / V) {
#define RFV_QKR_CASE(LH) \
  case LH:               \
    return launch<T, LH>(qkv, qs, ks, cs, sn, out, rows, tokens_in, tokens_out, off, C, eps, st);
    RFV_QKR_CASE(1)
    RFV_QKR_CASE(2)
    RFV_QKR_CASE(4)
    RFV_QKR_CASE(8)
    RFV_QKR_CASE(16)
    RFV_QKR_CASE(32)
#undef RFV_QKR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: [rows, 3C] contiguous, rows = B * tokens_in; q_scale, k_scale: [D]
// fp32; cos, sin: [tokens_out, D / 2] fp32; out: [B, tokens_out, 3C], rows
// off .. off + tokens_in of each batch written. C = H * D; D / (16 bytes)
// a power of two up to 32; C at most 1024 vectors of 16 bytes; every
// pointer 16-byte aligned.
extern "C" int rfv_qk_norm_rope(const void* qkv, const void* q_scale, const void* k_scale,
                                const void* cos_t, const void* sin_t, void* out, long long rows,
                                int tokens_in, long long tokens_out, int off, int C, int D,
                                float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qs = static_cast<const float*>(q_scale);
  const float* ks = static_cast<const float*>(k_scale);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  if (dtype == RFV_DTYPE_BF16)
    return qk_norm_rope<bf16>(qkv, qs, ks, cs, sn, out, rows, tokens_in, tokens_out, off, C, D,
                              eps, st);
  return qk_norm_rope<float>(qkv, qs, ks, cs, sn, out, rows, tokens_in, tokens_out, off, C, D,
                             eps, st);
}
