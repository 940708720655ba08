// GroupNorm (+ affine, + SiLU, + dropout) over an NHWC tensor, forward and
// backward, shared by gn_silu.cu, gn_silu_dropout.cu and attention.cu
// (design notes in gn_silu.cu).
//
// One thread-block cluster of N blocks (N = 1, 2, 4 or 8) per image. Block
// k of the cluster owns pixels [k P, (k + 1) P) of its image, a contiguous
// run of the NHWC slab. Where the run fits ("resident"), the block copies it
// into shared memory once with bulk copies (the TMA unit's 1D form) and
// every later pass reads it there; the forward's output (the backward's dx)
// is written over it in place and leaves with one bulk store. Otherwise the
// block reads its run from device memory on every pass. Per-group sums go
// from each block's shared memory to every block of the cluster through
// distributed shared memory, combined in rank order: each block forms the
// same statistics, and results do not depend on the schedule. gn_silu's
// forward takes the streamed plan (gn_silu_streamed_kernel) where a slab
// is not resident in one cluster.
//
// The forward's apply pass optionally ends in dropout: kept values are scaled
// by 1/keep in fp32 and dropped ones are zero, before the one rounding to the
// output type; the bits come from dropout_bits (common.cuh). Without SILU it
// is the plain GroupNorm (the attention block's normalised input).
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace rfv_gn {

namespace coop = cooperative_groups;

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxGroups = 32;
constexpr int kShareTarget = 65536;  // bytes a block aims at: three blocks an SM
constexpr int kSmemLimit = 232448 - 8192;  // dynamic bytes a block may take (static: < 8 KB)
constexpr int kFwdThreads = 768, kBwdThreads = 512;  // the most threads of a block
constexpr int kMaxChunks = 16;       // a resident run arrives in up to 16 pieces
constexpr int kChunkBytes = 16384;
constexpr int kUnroll = 4;           // loads a thread keeps in flight from device memory
constexpr int kMerge = 8;            // partial sums a lane keeps in flight in the merge

// Dropout: `seed` points at one int32 on the device, so the caller never has
// to bring a seed drawn there to the host.
//
// Under tensor parallelism a rank holds channels [c_off, c_off + C) of an
// activation of c_total channels; an element's bits are then those of its
// place in the whole activation, pixel * c_total + c_off + channel, so the
// ranks together drop what one card would. c_total 0 means C, no offset.
struct Dropout {
  const int* seed;
  uint32_t thresh;  // keep where bits < thresh
  float inv_keep;
  uint32_t c_off;
  uint32_t c_total;
};

// The flat index that keys the dropout bits of a pixel's channel c (see
// Dropout), mod 2^32 as the bits take it; a thread's rows step it by
// nrow * drop_width, one add a vector.
__device__ __forceinline__ uint32_t drop_width(const Dropout& d, int C) {
  return d.c_total ? d.c_total : (uint32_t)C;
}

__device__ __forceinline__ uint32_t drop_index(const Dropout& d, int pixel, int c, int C) {
  return (uint32_t)pixel * drop_width(d, C) + d.c_off + (uint32_t)c;
}

// ---- Hopper primitives: cluster barrier, bulk copies, mbarrier ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// One thread: init `bar` (one arrival) and announce `bytes` to arrive on it.
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global into
// this block's shared memory, completing on `bar`; one thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// The reverse of bulk_load, after every thread's fence_to_async and a
// __syncthreads; one thread. Returns once shared memory has been read: the
// writes to device memory drain while the next block of this SM loads.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  for (uint32_t o = 0; o < bytes; o += kChunkBytes) {
    const uint32_t n = bytes - o < kChunkBytes ? bytes - o : kChunkBytes;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     static_cast<char*>(dst) + o),
                 "r"(smem_addr(static_cast<const char*>(src) + o)), "r"(n)
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's generic writes to shared memory visible to bulk copies.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The resident run's arrival: rows [k rows, (k + 1) rows) of each source
// (x; and g, `gap` bytes further on) land on bars[k], so that the first pass
// starts on the first rows while the rest are in flight. One thread issues
// every copy; a thread waits for a piece before it first reads a row of it.
struct Arrival {
  int rows;  // rows a piece
  __device__ Arrival(int np, int row_bytes) {
    const int n = min(kMaxChunks, max(1, (np * row_bytes + kChunkBytes - 1) / kChunkBytes));
    rows = max(1, (np + n - 1) / n);
  }
  __device__ void issue(uint64_t* bars, unsigned char* dst, const void* x, const void* g,
                        uint32_t gap, int np, int row_bytes) const {
    for (int k = 0; k * rows < np; ++k) {
      const int r0 = k * rows, n = min(np, r0 + rows) - r0;
      const uint32_t bytes = (uint32_t)n * row_bytes, at = (uint32_t)r0 * row_bytes;
      mbar_init_expect(&bars[k], g ? 2 * bytes : bytes);
      bulk_load(dst + at, static_cast<const char*>(x) + at, bytes, &bars[k]);
      if (g) bulk_load(dst + gap + at, static_cast<const char*>(g) + at, bytes, &bars[k]);
    }
  }
  __device__ __forceinline__ void wait(uint64_t* bars, int p, int& waited) const {
    const int k = p / rows;
    if (k > waited) {
      mbar_wait0(&bars[k]);
      waited = k;
    }
  }
};

// sigmoid(z): for bf16 data one tanh.approx (relative error about 2^-11,
// below the 2^-8 of the output's rounding and of the inputs), for fp32 data
// an exponential and a reciprocal.
template <typename T>
__device__ __forceinline__ float sigmoid(float z) {
  if constexpr (sizeof(T) == 2) {
    float t;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.5f * z));
    return fmaf(0.5f, t, 0.5f);
  } else {
    return __fdividef(1.f, 1.f + __expf(-z));
  }
}

// ---- the layout of a block's work ----

// Thread t owns the V-channel column vector j = t % (C / V) (one group:
// V divides C / G) of rows r = t / (C / V), r + nrow, ... of its block's
// run, pixels [run P, (run + 1) P) of the image.
struct Tile {
  int C, cg, cv, nrow, j, r, grp, p0, np;
  bool active;
  __device__ Tile(int HW, int C_, int G, int P, int V, int run) {
    C = C_;
    cg = C / G;
    cv = C / V;
    nrow = blockDim.x / cv;
    j = threadIdx.x % cv;
    r = threadIdx.x / cv;
    active = r < nrow;
    grp = j * V / cg;
    p0 = min(HW, run * P);
    np = min(HW, p0 + P) - p0;
  }
};

// Per-group sums of each active thread's `v` over the block, into out[G].
// Fixed order: column sums over the rows, then the group's columns.
__device__ __forceinline__ void block_group_sums(float v, const Tile& t, int G, int V, float* red,
                                                 float* out) {
  red[threadIdx.x] = t.active ? v : 0.f;
  __syncthreads();
  if (threadIdx.x < t.cv) {  // rows >= 1 are only read here, row 0 only by its owner
    float a = 0.f;
#pragma unroll 4
    for (int r = 0; r < t.nrow; ++r) a += red[r * t.cv + threadIdx.x];
    red[threadIdx.x] = a;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int cpg = t.cg / V;
    float a = 0.f;
    for (int k = 0; k < cpg; ++k) a += red[threadIdx.x * cpg + k];
    out[threadIdx.x] = a;
  }
}

// p0[i] and p1[i] of every block of the cluster, by rank (zero past the
// cluster's size): all the loads from distributed shared memory in flight
// at once.
__device__ __forceinline__ void cluster_gather(float* p0, float* p1, int i,
                                               float (&u)[kMaxCluster], float (&w)[kMaxCluster]) {
  coop::cluster_group cluster = coop::this_cluster();
  const unsigned n = cluster.num_blocks();
#pragma unroll
  for (unsigned k = 0; k < kMaxCluster; ++k) {
    u[k] = k < n ? cluster.map_shared_rank(p0, k)[i] : 0.f;
    w[k] = k < n ? cluster.map_shared_rank(p1, k)[i] : 0.f;
  }
}

// ---- forward ----

template <typename T>
struct FwdArgs {
  const T* x;
  const float* scale;
  const float* bias;
  float2* stats;  // [B, G] (mean, 1/sigma), or null
  T* y;
  int HW, C, G, P;
  float eps;
  Dropout drop;
};

template <typename T, int V, bool SILU, bool DROP, bool RES>
__device__ __forceinline__ void fwd_body(const FwdArgs<T>& a) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ float red[kFwdThreads];
  __shared__ float part[2][kMaxGroups], mean_s[kMaxGroups], rstd_s[kMaxGroups];
  __shared__ uint64_t bars[kMaxChunks];
  const int b = blockIdx.y;
  const Tile t(a.HW, a.C, a.G, a.P, V, blockIdx.x);
  const size_t off = ((size_t)b * a.HW + t.p0) * a.C;
  const T* src = a.x + off;
  T* dst = a.y + off;
  const int row_bytes = a.C * (int)sizeof(T);
  const uint32_t bytes = (uint32_t)((size_t)t.np * row_bytes);
  const Arrival arr(t.np, row_bytes);
  int waited = -1;
  if constexpr (RES) {
    if (threadIdx.x == 0) arr.issue(bars, dyn, src, nullptr, 0, t.np, row_bytes);
    __syncthreads();
    src = reinterpret_cast<const T*>(dyn);
    dst = reinterpret_cast<T*>(dyn);
  }
  const float n = (float)a.HW * (float)t.cg;

  // 1: this run's group sums, and its own means
  float s = 0.f;
  if (t.active)
    for (int p = t.r; p < t.np; p += t.nrow) {
      if constexpr (RES) arr.wait(bars, p, waited);
      float v[V];
      loadv<V>(src + (size_t)p * a.C + t.j * V, v);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[e];
    }
  block_group_sums(s, t, a.G, V, red, part[0]);
  __syncthreads();
  if (threadIdx.x < a.G)
    mean_s[threadIdx.x] = t.np > 0 ? part[0][threadIdx.x] / ((float)t.np * (float)t.cg) : 0.f;
  __syncthreads();
  const float ml = mean_s[t.grp];

  // 2: the run's sum of squares about its own mean (exact: the run is
  // resident), then the image's mean and variance from every run's (sum,
  // sum of squares) by Chan et al.'s pairwise update, in rank order: one
  // exchange across the cluster
  s = 0.f;
  if (t.active)
    for (int p = t.r; p < t.np; p += t.nrow) {
      float v[V];
      loadv<V>(src + (size_t)p * a.C + t.j * V, v);
#pragma unroll
      for (int e = 0; e < V; ++e) s += (v[e] - ml) * (v[e] - ml);
    }
  block_group_sums(s, t, a.G, V, red, part[1]);
  cluster_sync();
  if (threadIdx.x < a.G) {
    float sum[kMaxCluster], m2[kMaxCluster];
    cluster_gather(part[0], part[1], threadIdx.x, sum, m2);
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) total += sum[k];
    const float mean = total / n;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      const int p0 = min(a.HW, k * a.P), nk = (min(a.HW, p0 + a.P) - p0) * t.cg;
      if (k < (int)gridDim.x && nk > 0) {
        const float d = sum[k] / (float)nk - mean;
        q += m2[k] + (float)nk * d * d;
      }
    }
    const float rs = rsqrtf(q / n + a.eps);
    mean_s[threadIdx.x] = mean;
    rstd_s[threadIdx.x] = rs;
    if (a.stats != nullptr && blockIdx.x == 0)
      a.stats[(size_t)b * a.G + threadIdx.x] = make_float2(mean, rs);
  }
  cluster_arrive();  // this block is done reading the others' shared memory
  __syncthreads();
  const float m = mean_s[t.grp];

  // 3: normalise, affine, SiLU, dropout; one rounding
  if (t.active) {
    const float rs = rstd_s[t.grp];
    float sc[V], bi[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sc[e] = a.scale[t.j * V + e] * rs;
      bi[e] = a.bias[t.j * V + e];
    }
    uint32_t seed = 0;
    if constexpr (DROP) seed = (uint32_t)*a.drop.seed;
    uint32_t di = drop_index(a.drop, t.p0 + t.r, t.j * V, a.C);
    const uint32_t dstep = (uint32_t)t.nrow * drop_width(a.drop, a.C);
    for (int p = t.r; p < t.np; p += t.nrow, di += dstep) {
      const size_t i = (size_t)p * a.C + t.j * V;
      float v[V];
      loadv<V>(src + i, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float z = (v[e] - m) * sc[e] + bi[e];
        v[e] = SILU ? z * sigmoid<T>(z) : z;
      }
      if constexpr (DROP) {
        uint32_t bits[V];
        dropout_bits<V>(seed, (uint32_t)b, di, bits);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = bits[e] < a.drop.thresh ? v[e] * a.drop.inv_keep : 0.f;
      }
      storev<V>(dst + i, v);
    }
  }
  if constexpr (RES) {
    fence_to_async();
    __syncthreads();
    if (threadIdx.x == 0 && bytes) bulk_store(a.y + off, dyn, bytes);
  }
  cluster_wait();  // the others are done reading this block's shared memory
}

// Entry kernels with names of their own, so that a profiler trace tells
// gn_silu from gn_silu_dropout and from the attention block's GroupNorm.
template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kFwdThreads) gn_silu_fwd_kernel(const FwdArgs<T> a) {
  fwd_body<T, V, true, false, RES>(a);
}

template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kFwdThreads) gn_silu_dropout_fwd_kernel(const FwdArgs<T> a) {
  fwd_body<T, V, true, true, RES>(a);
}

template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kFwdThreads) gn_norm_fwd_kernel(const FwdArgs<T> a) {
  fwd_body<T, V, false, false, RES>(a);
}

// ---- forward across the grid: the streamed plan ----
//
// A slab too large for one cluster (above ~1.8 MB) is spread over S blocks
// of the whole grid, S chosen by the host so that every image's blocks can
// be resident on the card at once. A block takes a ticket as it starts and
// owns run (ticket % S) of image (ticket / S): tickets go out in the order
// blocks start, so a block that waits for its image waits only for blocks
// that have started or that can start (at most one image is incomplete, and
// it holds fewer than S of the card's slots). Each block publishes its run's
// per-group (sum, sum of squares about the run's mean) to device memory and
// counts itself in; the image's last block merges the S partials in run
// order by Chan et al.'s update (the same bits whichever block is last),
// writes the image's (mean, 1/sigma) to the saved statistics and raises its
// flag; the others wait on the flag and read them there. Resident runs (RES: up to ~220 KB, bulk-copied into shared
// memory as in the cluster plan) take exact two-pass statistics and are read
// from device memory once; runs that do not fit are read twice (their sums
// about the image's first value of each group, then the output, walked
// backwards so that the rows read last, still in L2, are read first).
struct Stream {
  unsigned* ctr;  // [1 + 2B], zeroed: the ticket; each image's arrivals; its flag
  float2* part;   // [B, S, G]: each run's (sum, sum of squares about its mean)
  int S, B;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Sum over the warp, the same tree for every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kFwdThreads)
    gn_silu_streamed_kernel(const FwdArgs<T> a, const Stream s) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ float red[kFwdThreads];
  __shared__ float part[2][kMaxGroups], mean_s[kMaxGroups], rstd_s[kMaxGroups];
  __shared__ uint64_t bars[kMaxChunks];
  __shared__ int ticket, last;
  if (threadIdx.x == 0) ticket = (int)atomicAdd(s.ctr, 1u);
  __syncthreads();
  const int b = ticket / s.S, k = ticket % s.S;
  const Tile t(a.HW, a.C, a.G, a.P, V, k);
  const size_t img = (size_t)b * a.HW * a.C;
  const size_t off = img + (size_t)t.p0 * a.C;
  const T* src = a.x + off;
  T* dst = a.y + off;
  const int row_bytes = a.C * (int)sizeof(T);
  const Arrival arr(t.np, row_bytes);
  int waited = -1;
  if constexpr (RES) {
    if (threadIdx.x == 0) arr.issue(bars, dyn, src, nullptr, 0, t.np, row_bytes);
    __syncthreads();
    src = reinterpret_cast<const T*>(dyn);
    dst = reinterpret_cast<T*>(dyn);
  }
  const float shift = RES ? 0.f : to_f32(a.x[img + (size_t)t.grp * t.cg]);
  const float nk = (float)t.np * (float)t.cg;

  // 1: the run's sums (RES: then its sum of squares about its own mean);
  // from device memory kUnroll rows a thread in flight at once
  float s1 = 0.f, s2 = 0.f;
  if (t.active) {
    int p = t.r;
    if constexpr (!RES)
      for (; p + (kUnroll - 1) * t.nrow < t.np; p += kUnroll * t.nrow) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          loadv<V>(src + (size_t)(p + u * t.nrow) * a.C + t.j * V, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float d = v[u][e] - shift;
            s1 += d;
            s2 += d * d;
          }
      }
    for (; p < t.np; p += t.nrow) {
      if constexpr (RES) arr.wait(bars, p, waited);
      float v[V];
      loadv<V>(src + (size_t)p * a.C + t.j * V, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[e] - shift;
        s1 += d;
        if constexpr (!RES) s2 += d * d;
      }
    }
  }
  block_group_sums(s1, t, a.G, V, red, part[0]);
  __syncthreads();
  if constexpr (RES) {
    if (threadIdx.x < a.G) mean_s[threadIdx.x] = part[0][threadIdx.x] / nk;
    __syncthreads();
    const float ml = mean_s[t.grp];
    if (t.active)
      for (int p = t.r; p < t.np; p += t.nrow) {
        float v[V];
        loadv<V>(src + (size_t)p * a.C + t.j * V, v);
#pragma unroll
        for (int e = 0; e < V; ++e) s2 += (v[e] - ml) * (v[e] - ml);
      }
  }
  block_group_sums(s2, t, a.G, V, red, part[1]);
  __syncthreads();

  // 2: publish the run's partials and count in; the image's last block
  // merges them, the others wait for its flag
  if (threadIdx.x < a.G) {
    const float u = part[0][threadIdx.x];
    const float m2 = RES ? part[1][threadIdx.x] : fmaxf(part[1][threadIdx.x] - u * u / nk, 0.f);
    s.part[((size_t)b * s.S + k) * a.G + threadIdx.x] = make_float2(u, m2);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&s.ctr[1 + b], 1u) == (unsigned)(s.S - 1);
  }
  __syncthreads();
  unsigned* flag = &s.ctr[1 + s.B + b];
  if (last) {
    __threadfence();
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    const float n = (float)a.HW * (float)t.cg;
    for (int g = threadIdx.x >> 5; g < a.G; g += nw) {
      // lane l takes runs l, l + 32, ...: kMerge loads in flight at once
      const float2* pg = s.part + (size_t)b * s.S * a.G + g;
      float u = 0.f;
      for (int q0 = lane; q0 < s.S; q0 += 32 * kMerge) {
        float w[kMerge];
#pragma unroll
        for (int i = 0; i < kMerge; ++i) {
          const int q = q0 + 32 * i;
          w[i] = q < s.S ? __ldcg(pg + (size_t)q * a.G).x : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kMerge; ++i) u += w[i];
      }
      const float mean = warp_sum(u) / n;
      float m2 = 0.f;
      for (int q0 = lane; q0 < s.S; q0 += 32 * kMerge) {
        float2 w[kMerge];
#pragma unroll
        for (int i = 0; i < kMerge; ++i) {
          const int q = q0 + 32 * i;
          w[i] = q < s.S ? __ldcg(pg + (size_t)q * a.G) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kMerge; ++i) {
          const int q = q0 + 32 * i;
          if (q < s.S) {
            const float nq = (float)(min(a.HW, (q + 1) * a.P) - q * a.P) * (float)t.cg;
            const float d = w[i].x / nq - mean;
            m2 += w[i].y + nq * d * d;
          }
        }
      }
      m2 = warp_sum(m2);
      if (lane == 0) {
        const float sh = RES ? 0.f : to_f32(a.x[img + (size_t)g * t.cg]);
        const float2 st = make_float2(sh + mean, rsqrtf(m2 / n + a.eps));
        a.stats[(size_t)b * a.G + g] = st;
        mean_s[g] = st.x;
        rstd_s[g] = st.y;
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(flag, 1u);
  } else {
    if (threadIdx.x == 0) {  // one poller a block, so that the flag's line stays quiet
      while (ld_acquire(flag) == 0u) __nanosleep(256);
      for (int g = 0; g < a.G; ++g) {
        const float2 st = __ldcg(&a.stats[(size_t)b * a.G + g]);
        mean_s[g] = st.x;
        rstd_s[g] = st.y;
      }
    }
    __syncthreads();
  }

  // 3: normalise, affine, SiLU; one rounding
  if (t.active && t.r < t.np) {
    const float m = mean_s[t.grp], rs = rstd_s[t.grp];
    float sc[V], bi[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sc[e] = a.scale[t.j * V + e] * rs;
      bi[e] = a.bias[t.j * V + e];
    }
    // RES: in place in shared memory; else from device memory backwards,
    // kUnroll rows a thread in flight at once
    const int first = RES ? t.r : t.r + (t.np - 1 - t.r) / t.nrow * t.nrow;
    const int step = RES ? t.nrow : -t.nrow;
    const int rows = (t.np - 1 - t.r) / t.nrow + 1;
    int k0 = 0;
    if constexpr (!RES)
      for (; k0 + kUnroll <= rows; k0 += kUnroll) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          loadv<V>(src + (size_t)(first + (k0 + u) * step) * a.C + t.j * V, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float z = (v[u][e] - m) * sc[e] + bi[e];
            v[u][e] = z * sigmoid<T>(z);
          }
          storev<V>(dst + (size_t)(first + (k0 + u) * step) * a.C + t.j * V, v[u]);
        }
      }
    for (int k = k0; k < rows; ++k) {
      const size_t i = (size_t)(first + k * step) * a.C + t.j * V;
      float v[V];
      loadv<V>(src + i, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float z = (v[e] - m) * sc[e] + bi[e];
        v[e] = z * sigmoid<T>(z);
      }
      storev<V>(dst + i, v);
    }
  }
  if constexpr (RES) {
    fence_to_async();
    __syncthreads();
    if (threadIdx.x == 0) bulk_store(a.y + off, dyn, (uint32_t)((size_t)t.np * row_bytes));
  }
}

// ---- backward ----

template <typename T>
struct BwdArgs {
  const T* x;
  const T* g;
  const float* scale;
  const float* bias;
  const float2* stats;  // the forward's [B, G] (mean, 1/sigma)
  float2* part;         // [B, C] (sum dz, sum dz * xhat) of each image
  T* dx;
  int HW, C, G, P;
  Dropout drop;  // seed null: no dropout
};

// z = gamma xhat + beta, s = sigmoid(z), dz = g' s (1 + z (1 - s)), with
// g' the cotangent (times mask / keep for the dropout variant).
template <typename T, int V, bool DROP>
__device__ __forceinline__ void bwd_dz(const float (&x)[V], float (&g)[V], const float (&ga)[V],
                                       const float (&be)[V], float m, float rs, uint32_t seed,
                                       uint32_t image, uint32_t idx0, const Dropout& drop,
                                       float (&xh)[V]) {
  if constexpr (DROP) {
    uint32_t bits[V];
    dropout_bits<V>(seed, image, idx0, bits);
#pragma unroll
    for (int e = 0; e < V; ++e) g[e] = bits[e] < drop.thresh ? g[e] * drop.inv_keep : 0.f;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    xh[e] = (x[e] - m) * rs;
    const float z = ga[e] * xh[e] + be[e];
    const float sg = sigmoid<T>(z);
    g[e] = g[e] * sg * (1.f + z * (1.f - sg));
  }
}

template <typename T, int V, bool DROP, bool RES>
__global__ void __launch_bounds__(kBwdThreads) gn_silu_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ float ac[2][kMaxGroups];
  __shared__ uint64_t bars[kMaxChunks];
  const int b = blockIdx.y;
  const Tile t(a.HW, a.C, a.G, a.P, V, blockIdx.x);
  const size_t off = ((size_t)b * a.HW + t.p0) * a.C;
  const int row_bytes = a.C * (int)sizeof(T);
  const uint32_t bytes = (uint32_t)((size_t)t.np * row_bytes);
  const uint32_t run = (uint32_t)((size_t)a.P * row_bytes);  // a full run's bytes
  const Arrival arr(t.np, 2 * row_bytes);
  int waited = -1;
  const T* xs = a.x + off;
  const T* gs = a.g + off;
  T* dst = a.dx + off;
  T* dzs = dst;  // dz between the passes, rounded to T: over g if resident, else in dx
  float* red = reinterpret_cast<float*>(dyn + (RES ? 2 * (size_t)run : 0));  // 2 x nrow x C
  float* blk = red + 2 * t.nrow * a.C;                                        // 2 x C
  if constexpr (RES) {
    if (threadIdx.x == 0) arr.issue(bars, dyn, xs, gs, run, t.np, row_bytes);
    __syncthreads();
    xs = reinterpret_cast<const T*>(dyn);
    gs = reinterpret_cast<const T*>(dyn + run);
    dst = reinterpret_cast<T*>(dyn);
    dzs = reinterpret_cast<T*>(dyn + run);
  }
  const float2 st = a.stats[(size_t)b * a.G + t.grp];
  const float m = st.x, rs = st.y;
  float ga[V], be[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    ga[e] = a.scale[t.j * V + e];
    be[e] = a.bias[t.j * V + e];
  }
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)*a.drop.seed;

  // 1: dz, kept for pass 3, and its per-channel sums (and of dz * xhat) over
  // this block's run; the dropout mask is applied here once
  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  uint32_t di = drop_index(a.drop, t.p0 + t.r, t.j * V, a.C);
  const uint32_t dstep = (uint32_t)t.nrow * drop_width(a.drop, a.C);
  if (t.active)
    for (int p = t.r; p < t.np; p += t.nrow, di += dstep) {
      if constexpr (RES) arr.wait(bars, p, waited);
      const size_t i = (size_t)p * a.C + t.j * V;
      float x[V], g[V], xh[V];
      loadv<V>(xs + i, x);
      loadv<V>(gs + i, g);
      bwd_dz<T, V, DROP>(x, g, ga, be, m, rs, seed, (uint32_t)b, di, a.drop, xh);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1[e] += g[e];
        s2[e] += g[e] * xh[e];
      }
      storev<V>(dzs + i, g);
    }
  if (t.active) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[t.r * a.C + t.j * V + e] = s1[e];
      red[(t.nrow + t.r) * a.C + t.j * V + e] = s2[e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    float u = 0.f, w = 0.f;
#pragma unroll 4
    for (int r = 0; r < t.nrow; ++r) {
      u += red[r * a.C + c];
      w += red[(t.nrow + r) * a.C + c];
    }
    blk[c] = u;
    blk[a.C + c] = w;
  }
  cluster_sync();

  // 2: the image's sums over the cluster; the parameter gradients' per-image
  // partials; a = mean_group(dz gamma), c = mean_group(dz gamma xhat)
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    float us[kMaxCluster], ws[kMaxCluster], u = 0.f, w = 0.f;
    cluster_gather(blk, blk + a.C, c, us, ws);
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      u += us[k];
      w += ws[k];
    }
    if (blockIdx.x == 0) a.part[(size_t)b * a.C + c] = make_float2(u, w);
    red[c] = u * a.scale[c];
    red[a.C + c] = w * a.scale[c];
  }
  cluster_arrive();
  __syncthreads();
  if (threadIdx.x < a.G) {
    const float n = (float)a.HW * (float)t.cg;
    float u = 0.f, w = 0.f;
    for (int k = 0; k < t.cg; ++k) {
      u += red[threadIdx.x * t.cg + k];
      w += red[a.C + threadIdx.x * t.cg + k];
    }
    ac[0][threadIdx.x] = u / n;
    ac[1][threadIdx.x] = w / n;
  }
  __syncthreads();

  // 3: dx = r (dz gamma - a - xhat c), from x and the kept dz
  if (t.active) {
    const float av = ac[0][t.grp], cv = ac[1][t.grp];
    for (int p = t.r; p < t.np; p += t.nrow) {
      const size_t i = (size_t)p * a.C + t.j * V;
      float x[V], d[V];
      loadv<V>(xs + i, x);
      loadv<V>(dzs + i, d);
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = rs * (d[e] * ga[e] - av - (x[e] - m) * rs * cv);
      storev<V>(dst + i, x);
    }
  }
  if constexpr (RES) {
    fence_to_async();
    __syncthreads();
    if (threadIdx.x == 0 && bytes) bulk_store(a.dx + off, dyn, bytes);
  }
  cluster_wait();
}

// dbias[c] = sum_b part[b, c].x, dscale[c] = sum_b part[b, c].y, in order.
// (static: the header is compiled into several objects)
static __global__ void __launch_bounds__(256)
    gn_silu_bwd_params_kernel(const float2* __restrict__ part, float* __restrict__ dscale,
                              float* __restrict__ dbias, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float u = 0.f, w = 0.f;
  for (int b = 0; b < B; ++b) {
    const float2 p = part[(size_t)b * C + c];
    u += p.x;
    w += p.y;
  }
  dbias[c] = u;
  dscale[c] = w;
}

// ---- host ----

// Blocks per image (the cluster size), threads and shared memory of each:
// the fewest blocks whose runs take at most kShareTarget bytes, or at most
// kSmemLimit at the cluster's largest size; else the runs stay in device
// memory (dynamic = extra only) and an image takes the largest cluster. A
// block takes 256 threads for each 64 KB of its run (up to max_threads), so
// that an SM holds about as many threads whatever the run's size.
struct Plan {
  int N, P, threads;
  bool res;
  size_t smem;
};

// extra(threads): the dynamic bytes a block needs besides its run.
template <typename Extra>
Plan plan(int HW, int C, size_t es, int copies, bool can_res, int max_threads, Extra extra) {
  for (int N = 1; can_res && N <= kMaxCluster; N *= 2) {
    const int P = (HW + N - 1) / N;
    const size_t run = (size_t)P * C * es * copies;
    const int threads = (int)std::min<size_t>(max_threads, 256 * ((run + 65535) / 65536));
    const size_t bytes = run + extra(threads);
    if (run <= kShareTarget || (N == kMaxCluster && bytes <= kSmemLimit))
      return Plan{N, P, threads, true, bytes};
  }
  const int N = HW < kMaxCluster ? 1 : kMaxCluster;
  return Plan{N, (HW + N - 1) / N, 512, false, extra(512)};
}

template <auto Kernel, typename Args>
int launch_cluster(const Args& args, int B, const Plan& p, cudaStream_t st) {
  if (p.smem + 8192 > 48 * 1024) {  // with the static shared memory
    const cudaError_t e =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N, B);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, Kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// gn_silu_dropout and the attention block's GroupNorm (gn_silu takes
// gn_silu_v): the cluster plan, resident or not.
template <typename T, int V, bool SILU, bool DROP>
int forward_v(const FwdArgs<T>& a, int B, cudaStream_t st) {
  static_assert(DROP || !SILU, "gn_silu's forward is gn_silu_v");
  const bool can_res = V * sizeof(T) == 16 && aligned16(a.x) && aligned16(a.y);
  const Plan p = plan(a.HW, a.C, sizeof(T), 1, can_res, kFwdThreads, [](int) { return 0; });
  FwdArgs<T> args = a;
  args.P = p.P;
  if (p.res) {
    if constexpr (DROP)
      return launch_cluster<gn_silu_dropout_fwd_kernel<T, V, true>>(args, B, p, st);
    else
      return launch_cluster<gn_norm_fwd_kernel<T, V, true>>(args, B, p, st);
  }
  if constexpr (DROP)
    return launch_cluster<gn_silu_dropout_fwd_kernel<T, V, false>>(args, B, p, st);
  else
    return launch_cluster<gn_norm_fwd_kernel<T, V, false>>(args, B, p, st);
}

// The streamed plan (gn_silu_streamed_kernel): runs of P pixels, S an image,
// every image's S blocks resident on the card at once. Resident runs where
// they fit: about total / (4 x the SMs), 16 to 64 KB, so that the card holds
// several blocks an SM; doubled (fewer blocks) until S fits the card's
// resident blocks. Else runs read from device memory, 512 threads a block,
// S the card's resident blocks (runs of at least 16 KB).
struct StreamPlan {
  int S, P, threads;
  bool res;
  size_t smem;
};

// Blocks of Kernel an SM holds at (threads, smem); 0 if none or on error.
template <auto Kernel>
int blocks_per_sm(int threads, size_t smem) {
  if (smem + 8192 > 48 * 1024 &&
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess)
    return 0;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, threads, smem) == cudaSuccess
             ? n
             : 0;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <typename T, int V>
int stream_plan_uncached(int B, int HW, int C, bool can_res, StreamPlan& sp) {
  const size_t sms = (size_t)sm_count(), row = (size_t)C * sizeof(T);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  if (can_res) {
    const size_t total = (size_t)B * HW * row;
    for (size_t run = std::min<size_t>(kShareTarget, std::max<size_t>(16384, total / (4 * sms)));;
         run *= 2) {
      const int P0 = (int)std::min<size_t>(HW, std::max<size_t>(1, run / row));
      const int S = (HW + P0 - 1) / P0, P = (HW + S - 1) / S;
      const size_t bytes = (size_t)P * row;
      if (bytes > (size_t)kSmemLimit) break;
      const int threads = (int)std::min<size_t>(kFwdThreads, 256 * ((bytes + 65535) / 65536));
      const size_t fit = sms * blocks_per_sm<gn_silu_streamed_kernel<T, V, true>>(threads, bytes);
      if ((size_t)S <= fit) {
        sp = StreamPlan{S, P, threads, true, bytes};
        return 0;
      }
      if (P == HW) break;
    }
  }
  const size_t fit = sms * blocks_per_sm<gn_silu_streamed_kernel<T, V, false>>(512, 0);
  if (fit == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t runs = std::max<size_t>(1, (size_t)HW * row / 16384);
  const int S0 = (int)std::min<size_t>({fit, runs, (size_t)HW});
  const int P = (HW + S0 - 1) / S0;
  sp = StreamPlan{(HW + P - 1) / P, P, 512, false, 0};
  return 0;
}

// stream_plan_uncached, remembered by its arguments and the device (the
// occupancy queries cost more host time than a small slab's kernel).
template <typename T, int V>
int stream_plan(int B, int HW, int C, bool can_res, StreamPlan& sp) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int, int, bool>, StreamPlan> plans;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidDevice;
  const auto key = std::make_tuple(dev, B, HW, C, can_res);
  {
    std::lock_guard<std::mutex> guard(lock);
    const auto hit = plans.find(key);
    if (hit != plans.end()) {
      sp = hit->second;
      return 0;
    }
  }
  const int e = stream_plan_uncached<T, V>(B, HW, C, can_res, sp);
  if (e == 0) {
    std::lock_guard<std::mutex> guard(lock);
    plans.emplace(key, sp);
  }
  return e;
}

// The streamed plan's workspace: the zeroed counters, then part.
inline size_t stream_counters(int B) { return ((size_t)(1 + 2 * B) * 4 + 15) / 16 * 16; }
inline size_t stream_workspace(int B, int G, int S) {
  return stream_counters(B) + (size_t)B * S * G * 8;
}

// gn_silu's forward: the cluster plan where an image's slab is resident in
// one cluster (*need = 0), else the streamed plan, whose workspace takes
// *need bytes: launched where `work` holds them, else nothing is launched.
template <typename T, int V>
int gn_silu_v(const FwdArgs<T>& a, int B, void* work, long long work_bytes, long long* need,
              cudaStream_t st) {
  const bool can_res = V * sizeof(T) == 16 && aligned16(a.x) && aligned16(a.y);
  const Plan p = plan(a.HW, a.C, sizeof(T), 1, can_res, kFwdThreads, [](int) { return 0; });
  FwdArgs<T> args = a;
  if (p.res) {
    *need = 0;
    args.P = p.P;
    return launch_cluster<gn_silu_fwd_kernel<T, V, true>>(args, B, p, st);
  }
  StreamPlan sp;
  const int e = stream_plan<T, V>(B, a.HW, a.C, can_res, sp);
  if (e) return e;
  const size_t bytes = stream_workspace(B, a.G, sp.S);
  *need = (long long)bytes;
  if (work == nullptr || work_bytes < (long long)bytes) return 0;
  if (!aligned16(work) || a.stats == nullptr) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(work);
  const size_t ctr = stream_counters(B);
  const Stream s{reinterpret_cast<unsigned*>(w), reinterpret_cast<float2*>(w + ctr), sp.S, B};
  args.P = sp.P;
  cudaError_t r = cudaMemsetAsync(w, 0, ctr, st);
  if (r != cudaSuccess) return (int)r;
  const dim3 grid((unsigned)((size_t)B * sp.S));
  if (sp.res) {
    if (sp.smem + 8192 > 48 * 1024) {
      r = cudaFuncSetAttribute(gn_silu_streamed_kernel<T, V, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sp.smem);
      if (r != cudaSuccess) return (int)r;
    }
    gn_silu_streamed_kernel<T, V, true><<<grid, sp.threads, sp.smem, st>>>(args, s);
  } else {
    gn_silu_streamed_kernel<T, V, false><<<grid, sp.threads, 0, st>>>(args, s);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V, bool DROP>
int backward_v(const BwdArgs<T>& a, float* dscale, float* dbias, int B, cudaStream_t st) {
  const bool can_res =
      V * sizeof(T) == 16 && aligned16(a.x) && aligned16(a.g) && aligned16(a.dx);
  // the per-row and per-block channel sums: 2 x nrow x C + 2 x C floats
  const int C = a.C;
  const Plan p = plan(a.HW, C, sizeof(T), 2, can_res, kBwdThreads, [C](int threads) {
    return (2 * (size_t)(threads / (C / V)) * C + 2 * (size_t)C) * 4;
  });
  BwdArgs<T> args = a;
  args.P = p.P;
  const int e = p.res ? launch_cluster<gn_silu_bwd_kernel<T, V, DROP, true>>(args, B, p, st)
                      : launch_cluster<gn_silu_bwd_kernel<T, V, DROP, false>>(args, B, p, st);
  if (e) return e;
  gn_silu_bwd_params_kernel<<<(a.C + 255) / 256, 256, 0, st>>>(a.part, dscale, dbias, B, a.C);
  return (int)cudaGetLastError();
}

// The widest vector (16 bytes at most) whose element count divides a
// group's channels, so that a vector never straddles two groups.
template <typename T, int V, bool SILU, bool DROP>
int forward(const FwdArgs<T>& a, int B, cudaStream_t st) {
  if constexpr (V > 1) {
    if ((a.C / a.G) % V) return forward<T, V / 2, SILU, DROP>(a, B, st);
  }
  return forward_v<T, V, SILU, DROP>(a, B, st);
}

template <typename T, int V>
int gn_silu_forward(const FwdArgs<T>& a, int B, void* work, long long work_bytes, long long* need,
                    cudaStream_t st) {
  if constexpr (V > 1) {
    if ((a.C / a.G) % V) return gn_silu_forward<T, V / 2>(a, B, work, work_bytes, need, st);
  }
  return gn_silu_v<T, V>(a, B, work, work_bytes, need, st);
}

template <typename T, int V, bool DROP>
int backward(const BwdArgs<T>& a, float* dscale, float* dbias, int B, cudaStream_t st) {
  if constexpr (V > 1) {
    if ((a.C / a.G) % V) return backward<T, V / 2, DROP>(a, dscale, dbias, B, st);
  }
  return backward_v<T, V, DROP>(a, dscale, dbias, B, st);
}

// x, y: [B, HW, C] contiguous in `dtype`; scale, bias: [C] float32; stats:
// [B, G] float2 or null. Requires C % G == 0, G <= 32 and C / V <= 256.
template <bool SILU, bool DROP>
int forward_dtype(const void* x, const void* scale, const void* bias, void* stats, void* y, int B,
                  int HW, int C, int G, float eps, Dropout drop, int dtype, cudaStream_t st) {
  if (C % G || G > kMaxGroups || B < 1 || B > 65535 || HW < 1) return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float2* s2 = static_cast<float2*>(stats);
  if (dtype == RFV_DTYPE_BF16) {
    const FwdArgs<bf16> a{static_cast<const bf16*>(x), sc, bi, s2, static_cast<bf16*>(y),
                          HW, C, G, 0, eps, drop};
    return forward<bf16, 8, SILU, DROP>(a, B, st);
  }
  const FwdArgs<float> a{static_cast<const float*>(x), sc, bi, s2, static_cast<float*>(y),
                         HW, C, G, 0, eps, drop};
  return forward<float, 4, SILU, DROP>(a, B, st);
}

// gn_silu's forward (gn_silu_v) in `dtype`.
inline int gn_silu_dtype(const void* x, const void* scale, const void* bias, void* stats, void* y,
                         void* work, long long work_bytes, long long* need, int B, int HW, int C,
                         int G, float eps, int dtype, cudaStream_t st) {
  if (C % G || G > kMaxGroups || B < 1 || B > 65535 || HW < 1) return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float2* s2 = static_cast<float2*>(stats);
  if (dtype == RFV_DTYPE_BF16) {
    const FwdArgs<bf16> a{static_cast<const bf16*>(x), sc, bi, s2, static_cast<bf16*>(y),
                          HW, C, G, 0, eps, Dropout{}};
    return gn_silu_forward<bf16, 8>(a, B, work, work_bytes, need, st);
  }
  const FwdArgs<float> a{static_cast<const float*>(x), sc, bi, s2, static_cast<float*>(y),
                         HW, C, G, 0, eps, Dropout{}};
  return gn_silu_forward<float, 4>(a, B, work, work_bytes, need, st);
}

}  // namespace rfv_gn
