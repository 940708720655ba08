// Flash attention in bf16 for head widths above 256: forward, dkv and dq on
// wgmma + TMA, D streamed through shared memory in 64-column boxes.
//
// Replaces, with flash_attention.cu, the Pallas TPU library kernel that the
// JAX package's DiT calls (rectified_flow_vision_tpu/models/dit.py
// _attention -> jax.experimental.pallas.ops.tpu.flash_attention), for the
// head widths that kernel takes and flash_attention.cu's instances do not.
// Bound on the H100: operations (4 B H T^2 D flops forward, 2.5 times that
// backward, over 4 or 8 B T H D elements moved).
//
// Two limits set the design. A wgmma's N stops at 256, and an m64nD fp32
// accumulator takes D / 2 of a consumer thread's 240 registers, so no
// warpgroup holds an output row of more than 256 columns. The K dimension
// of a product has no such cap. So:
//  - the logits S = Q K^T (and dP = dO V^T, and their transposes) are summed
//    over D one 64-column box at a time (four k-steps a box): the boxes of
//    the operand that changes along the inner loop (K in the forward and dq,
//    Q and dO in dkv) stream through a ring of 8 KB stages, each freed as
//    soon as its product is done (wgmma.wait_group 1);
//  - every output (O; dK and dV; dQ) is cut into column chunks of CW = 192
//    or 256 columns: O, dK and dV into nc = ceil(DP / 256) chunks of CW = 64
//    ceil(DP / 64 / nc), one a block; dQ into ceil(DP / 512) pairs of chunks,
//    one pair a block (a chunk a consumer warpgroup). The second products
//    (P V, P^T dO, dS^T Q, dS K) read their B operand's columns from a
//    second ring, one chunk (or pair) a stage (boxes wholly past D are not
//    loaded: they feed only output columns that are not stored). A block
//    computes S (and dP) once for its columns: at D = 264 to 512 the forward
//    and dkv compute them twice in all, dq once;
//  - the operand that stays for a block's whole inner loop (Q of 128 rows in
//    the forward; K and V of dkv; Q and dO of dq) is resident in shared
//    memory while it fits beside the rings (RES), and is otherwise streamed
//    box by box with the other operand (its boxes re-read from L2 on every
//    inner step), so that no head width is too wide. The host takes the
//    first layout that fits 227 KB (smem_plan).
// The consumer warpgroups keep the roles of flash_attention.cu's kernels at
// DP = 192 and 256: in the forward each owns 64 of a block's 128 query
// rows; dkv (64 keys) splits by output, warpgroup 1 S^T, P^T and dV,
// warpgroup 2 dP^T, dS^T and dK, P^T crossing in fp32; dq (64 queries)
// splits S, P / dP, dS and the pair's two dQ chunks, P crossing in fp32 and
// dS in bf16. P and dS are rounded to bf16 before the
// products that take them, as in the plain versions. No product is issued
// on a runtime branch: the warpgroups run the same instructions on other
// addresses, or (dq) each its own whole loop.
#include "flash_attention.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace rfv_wgmma;
using namespace rfv_flash_tc;

constexpr int BOX = WIDE * ROW;  // bytes of a 64-row x 64-column box
constexpr int QROWS = 128;       // query rows of a forward block
constexpr int QBOX = QROWS * ROW;
constexpr int STAT = 2 * WIDE;   // floats of a dkv chunk stage's lse and delta
constexpr int SMEM_MAX = 232448;

// One work tile of a persistent block: row tile (fastest), output chunk,
// head, batch.
struct Work {
  int r, oc, h, b;
  __device__ __forceinline__ Work(int t, int nr, int nc, int H)
      : r(t % nr), oc((t / nr) % nc), h((t / nr / nc) % H), b(t / nr / nc / H) {}
};

// The n boxes of a tile: columns 64 (c0 + i), rows t0 .. t0 + rows - 1 of head
// h of batch b, box i at dst + i * bytes.
__device__ __forceinline__ void load_boxes(uint8_t* dst, int bytes, const CUtensorMap* map,
                                           uint64_t* bar, int n, int c0, int h, int t0, int b) {
  for (int i = 0; i < n; ++i) tma_load_4d(dst + i * bytes, map, bar, 64 * (c0 + i), h, t0, b);
}

// Boxes of chunk oc that lie inside DP = 64 nb columns.
__host__ __device__ __forceinline__ int chunk_boxes(int cw, int nb, int oc) {
  const int n = nb - oc * (cw / 64);
  return n < cw / 64 ? n : cw / 64;
}

// S (or dP, S^T, dP^T) of 64 rows x 64 columns, summed over the nb boxes of D
// that arrive in the ring: box kb's A operand at a_res + kb * a_step (RES) or
// at the stage + a_off, its B operand at the stage + b_off; rows r0 .. of A,
// a tile of a_rows rows. Each stage is freed (one arrival per warp) once its
// product is done; the last when all are.
template <bool RES>
__device__ __forceinline__ void logits(float (&x)[WIDE / 2], uint8_t* ring, int stage_bytes,
                                       uint64_t* full, uint64_t* empty, int& stage,
                                       uint32_t& phase, int stages, int nb, uint32_t a_res,
                                       int a_step, int a_off, int a_rows, int r0, int b_off,
                                       int lane) {
  int prev = 0;
  for (int kb = 0; kb < nb; ++kb) {
    const uint32_t st = smem_u32(ring + stage * stage_bytes);
    const uint32_t a = RES ? a_res + kb * a_step : st + a_off;
    mbar_wait(&full[stage], phase);
    fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<WIDE>::mma(x, kmajor(a, a_rows, r0, kk), kmajor(st + b_off, WIDE, 0, kk),
                       (kb | kk) > 0);
    commit();
    wait<1>();
    if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    advance(stage, phase, stages);
  }
  wait<0>();
  fence_regs(x);
  if (lane == 0) mbar_arrive(&empty[prev]);
}

// ---------------------------------------------------------------- forward ----

// The forward's shared memory: [Q: nb boxes of 128 rows (RES)] [box ring:
// K box (+ Q box)] [chunk ring: V, CW / 64 boxes] [barriers].
__host__ __device__ constexpr int fwd_smem(bool res, int cw, int nb, int ks, int vs) {
  return 1024 + (res ? nb * QBOX : 0) + ks * (res ? BOX : BOX + QBOX) + vs * (cw / 64) * BOX +
         (2 + 2 * ks + 2 * vs) * 8;
}

template <int CW, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_streamed_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                              float* __restrict__ lse, int T, int H, int D, int nb, int nc,
                              int tiles, int ks_n, int vs_n, float scale) {
  constexpr int VB = CW / 64 * BOX;
  const int KSB = RES ? BOX : BOX + QBOX;  // a box stage: K box, then (streamed) Q box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* kring = qs + (RES ? nb * QBOX : 0);
  uint8_t* vring = kring + ks_n * KSB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vring + vs_n * VB);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + ks_n;
  uint64_t* v_full = k_empty + ks_n;
  uint64_t* v_empty = v_full + vs_n;
  const int nq = T / QROWS, nk = T / WIDE;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    for (int i = 0; i < ks_n; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], 8);
    }
    for (int i = 0; i < vs_n; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0, it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const Work w(t, nq, nc, H);
        if constexpr (RES) {
          mbar_wait(q_empty, (it & 1) ^ 1);
          mbar_expect_tx(q_full, nb * QBOX);
          load_boxes(qs, QBOX, &tm_q, q_full, nb, 0, w.h, w.r * QROWS, w.b);
        }
        const int cb = w.oc * (CW / 64), ncb = chunk_boxes(CW, nb, w.oc);
        for (int kt = 0; kt < nk; ++kt) {
          for (int kb = 0; kb < nb; ++kb) {
            uint8_t* st = kring + ks * KSB;
            mbar_wait(&k_empty[ks], kph ^ 1);
            mbar_expect_tx(&k_full[ks], KSB);
            tma_load_4d(st, &tm_k, &k_full[ks], 64 * kb, w.h, kt * WIDE, w.b);
            if constexpr (!RES)
              tma_load_4d(st + BOX, &tm_q, &k_full[ks], 64 * kb, w.h, w.r * QROWS, w.b);
            advance(ks, kph, ks_n);
          }
          mbar_wait(&v_empty[vs], vph ^ 1);
          mbar_expect_tx(&v_full[vs], ncb * BOX);
          load_boxes(vring + vs * VB, BOX, &tm_v, &v_full[vs], ncb, cb, w.h, kt * WIDE, w.b);
          advance(vs, vph, vs_n);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows 64 c .. 64 c + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t qa = smem_u32(qs);
    int ks = 0, vs = 0;
    uint32_t kph = 0, vph = 0, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const Work w(t, nq, nc, H);
      if constexpr (RES) mbar_wait(q_full, it & 1);
      OnlineSoftmax sm(scale);
      float oacc[CW / 2];
      zero(oacc);
      for (int kt = 0; kt < nk; ++kt) {
        float s[WIDE / 2];  // S = Q K^T of this warpgroup's rows and 64 keys
        logits<RES>(s, kring, KSB, k_full, k_empty, ks, kph, ks_n, nb, qa, QBOX, BOX, QROWS,
                    64 * c, 0, lane);
        uint32_t pa[WIDE / 16][4];
        sm.tile<WIDE>(s, pa);
        mbar_wait(&v_full[vs], vph);
        sm.rescale<CW>(oacc);
        fence_regs(oacc);
        fence();
        const uint32_t va = smem_u32(vring + vs * VB);
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)  // O[:, chunk] += P V[:, chunk]
          WgmmaRS<CW, 1>::mma(oacc, pa[kk], mnmajor(va, WIDE, kk), 1);
        commit();
        wait<0>();
        fence_regs(oacc);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(&v_empty[vs]);
        advance(vs, vph, vs_n);
      }
      if (RES && lane == 0) mbar_arrive(q_empty);

      float l0 = sm.l0, l1 = sm.l1;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const int row0 = w.r * QROWS + 64 * c + 16 * warp + (lane >> 2);
      bf16* o0 = o + (((size_t)w.b * T + row0) * H + w.h) * D + w.oc * CW;
      store_rows<CW>(oacc, 1.f / l0, 1.f / l1, o0, o0 + (size_t)8 * H * D, D - w.oc * CW, lane);
      if (w.oc == 0 && (lane & 3) == 0) {
        float* l = lse + ((size_t)w.b * H + w.h) * T + row0;
        l[0] = sm.m0 * scale + logf(l0);
        l[8] = sm.m1 * scale + logf(l1);
      }
    }
  }
}

// -------------------------------------------------------------------- dkv ----

// [K, V: nb boxes each (RES)] [box ring: Q, dO (+ K, V) boxes] [chunk ring:
// Q and dO chunks, CW / 64 boxes each] [lse, delta per chunk stage] [P^T,
// fp32 64 x 64] [barriers].
__host__ __device__ constexpr int dkv_smem(bool res, int cw, int nb, int rs, int cs) {
  return 1024 + (res ? 2 * nb * BOX : 0) + rs * (res ? 2 : 4) * BOX + cs * 2 * (cw / 64) * BOX +
         cs * STAT * 4 + WIDE * WIDE * 4 + (2 + 2 * rs + 2 * cs) * 8;
}

// dK and dV of 64 keys, chunk oc of their columns; everything transposed
// (keys in the rows). Warpgroup 1: S^T = K Q^T, P^T = exp(S^T - lse), hands
// P^T to warpgroup 2, dV += P^T dO; warpgroup 2: dP^T = V dO^T, dS^T = P^T
// (dP^T - delta), dK += dS^T Q. Persistent over (batch, head, chunk, 64 keys).
template <int CW, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_streamed_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, int D,
                              long long gb, long long gt, long long gh, int nb, int nc, int tiles,
                              int rs_n, int cs_n, float scale) {
  constexpr int CB = CW / 64 * BOX;  // one operand's chunk tile
  const int RSB = (RES ? 2 : 4) * BOX;  // a box stage: Q, dO (+ K, V)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + (RES ? nb * BOX : 0);
  uint8_t* ring = vs + (RES ? nb * BOX : 0);
  uint8_t* cring = ring + rs_n * RSB;  // stage s: Q chunk at cring + 2 CB s, dO chunk after it
  float* stats = reinterpret_cast<float*>(cring + cs_n * 2 * CB);
  float* pex = stats + cs_n * STAT;  // P^T, fp32
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(pex + WIDE * WIDE);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + rs_n;
  uint64_t* cfull = empty + rs_n;
  uint64_t* cempty = cfull + cs_n;
  const int n = T / WIDE;  // key tiles of a head, and query tiles
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    for (int i = 0; i < rs_n; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    for (int i = 0; i < cs_n; ++i) {
      mbar_init(&cfull[i], 1);
      mbar_init(&cempty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int rs = 0, cs = 0;
      uint32_t rph = 0, cph = 0, it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const Work w(t, n, nc, H);
        if constexpr (RES) {
          mbar_wait(kv_empty, (it & 1) ^ 1);
          mbar_expect_tx(kv_full, 2 * nb * BOX);
          load_boxes(ks, BOX, &tm_k, kv_full, nb, 0, w.h, w.r * WIDE, w.b);
          load_boxes(vs, BOX, &tm_v, kv_full, nb, 0, w.h, w.r * WIDE, w.b);
        }
        const int cb = w.oc * (CW / 64), ncb = chunk_boxes(CW, nb, w.oc);
        const float* lse_bh = lse + ((size_t)w.b * H + w.h) * T;
        const float* delta_bh = delta + ((size_t)w.b * H + w.h) * T;
        for (int qt = 0; qt < n; ++qt) {
          for (int kb = 0; kb < nb; ++kb) {
            uint8_t* st = ring + rs * RSB;
            uint64_t* bar = &full[rs];
            mbar_wait(&empty[rs], rph ^ 1);
            mbar_expect_tx(bar, RSB);
            tma_load_4d(st, &tm_q, bar, 64 * kb, w.h, qt * WIDE, w.b);
            tma_load_4d(st + BOX, &tm_g, bar, 64 * kb, w.h, qt * WIDE, w.b);
            if constexpr (!RES) {
              tma_load_4d(st + 2 * BOX, &tm_k, bar, 64 * kb, w.h, w.r * WIDE, w.b);
              tma_load_4d(st + 3 * BOX, &tm_v, bar, 64 * kb, w.h, w.r * WIDE, w.b);
            }
            advance(rs, rph, rs_n);
          }
          uint8_t* ct = cring + cs * 2 * CB;
          float* sst = stats + cs * STAT;
          uint64_t* bar = &cfull[cs];
          mbar_wait(&cempty[cs], cph ^ 1);
          mbar_expect_tx(bar, 2 * ncb * BOX + STAT * 4);
          load_boxes(ct, BOX, &tm_q, bar, ncb, cb, w.h, qt * WIDE, w.b);
          load_boxes(ct + CB, BOX, &tm_g, bar, ncb, cb, w.h, qt * WIDE, w.b);
          bulk_load(sst, lse_bh + qt * WIDE, WIDE * 4, bar);
          bulk_load(sst + WIDE, delta_bh + qt * WIDE, WIDE * 4, bar);
          advance(cs, cph, cs_n);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 (c = 0) dV, warpgroup 2 (c = 1) dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
    const uint32_t a_res = smem_u32(c == 0 ? ks : vs);  // K for S^T, V for dP^T
    const float sl2 = scale * kLog2e;
    int rs = 0, cs = 0;
    uint32_t rph = 0, cph = 0, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const Work w(t, n, nc, H);
      const bool final_tile = t + (int)gridDim.x >= tiles;
      float acc[CW / 2];  // dV (c = 0) or dK (c = 1) of this warp's 16 keys, chunk oc
      zero(acc);
      if constexpr (RES) mbar_wait(kv_full, it & 1);
      for (int qt = 0; qt < n; ++qt) {
        const bool first = it == 0 && qt == 0, last = final_tile && qt == n - 1;
        // c = 0: S^T = K Q^T (Q box first in a stage); c = 1: dP^T = V dO^T
        float x[WIDE / 2];
        logits<RES>(x, ring, RSB, full, empty, rs, rph, rs_n, nb, a_res, BOX, (2 + c) * BOX,
                    WIDE, 0, c * BOX, lane);
        mbar_wait(&cfull[cs], cph);
        const float* ls = stats + cs * STAT;
        const float* ds = ls + WIDE;

        // this thread's query columns 8i + 2 (lane % 4) + {0, 1}; fa: P^T
        // (c = 0) or dS^T (c = 1) as bf16 A fragments
        uint32_t fa[WIDE / 16][4];
        float p[WIDE / 2];
        if (c == 0) {
#pragma unroll
          for (int i = 0; i < WIDE / 8; ++i) {
            const float2 l = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * (lane & 3));
            const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
            p[4 * i] = fast_exp2(fmaf(x[4 * i], sl2, -l0));
            p[4 * i + 1] = fast_exp2(fmaf(x[4 * i + 1], sl2, -l1));
            p[4 * i + 2] = fast_exp2(fmaf(x[4 * i + 2], sl2, -l0));
            p[4 * i + 3] = fast_exp2(fmaf(x[4 * i + 3], sl2, -l1));
            fa[i >> 1][(i & 1) * 2] = pack_bf16(p[4 * i], p[4 * i + 1]);
            fa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p[4 * i + 2], p[4 * i + 3]);
          }
          if (!first) bar_sync(P_FREE, 256);
          put_acc(pex, p, tid);
          bar_arrive(P_READY, 256);
        } else {
          bar_sync(P_READY, 256);
          get_acc(pex, p, tid);
          if (!last) bar_arrive(P_FREE, 256);
#pragma unroll
          for (int i = 0; i < WIDE / 8; ++i) {
            const float2 d = *reinterpret_cast<const float2*>(ds + 8 * i + 2 * (lane & 3));
            fa[i >> 1][(i & 1) * 2] =
                pack_bf16(p[4 * i] * (x[4 * i] - d.x), p[4 * i + 1] * (x[4 * i + 1] - d.y));
            fa[i >> 1][(i & 1) * 2 + 1] =
                pack_bf16(p[4 * i + 2] * (x[4 * i + 2] - d.x), p[4 * i + 3] * (x[4 * i + 3] - d.y));
          }
        }
        // c = 0: dV[:, chunk] += P^T dO[:, chunk]; c = 1: dK[:, chunk] += dS^T Q[:, chunk]
        const uint32_t second_b = smem_u32(cring + cs * 2 * CB + (c == 0 ? CB : 0));
        fence_regs(acc);
        fence();
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)
          WgmmaRS<CW, 1>::mma(acc, fa[kk], mnmajor(second_b, WIDE, kk), 1);
        commit();
        wait<0>();
        fence_regs(acc);
        fence_regs(fa);
        if (lane == 0) mbar_arrive(&cempty[cs]);
        advance(cs, cph, cs_n);
      }
      if (RES && lane == 0) mbar_arrive(kv_empty);

      const int row0 = w.r * WIDE + 16 * warp + (lane >> 2);
      const size_t base = (size_t)w.b * gb + (size_t)w.h * gh + (size_t)row0 * gt + w.oc * CW;
      bf16* dst = (c == 0 ? dv : dk) + base;
      const float mul = c == 0 ? 1.f : scale;
      store_rows<CW>(acc, mul, mul, dst, dst + 8 * gt, D - w.oc * CW, lane);
    }
  }
}

// --------------------------------------------------------------------- dq ----

// [Q, dO: nb boxes each (RES)] [box ring: K, V (+ Q, dO) boxes] [chunk ring:
// K's pair of chunks, 2 CW / 64 boxes] [dS, one bf16 box] [P, fp32 64 x 64]
// [barriers].
__host__ __device__ constexpr int dq_smem(bool res, int cw, int nb, int rs, int cs) {
  return 1024 + (res ? 2 * nb * BOX : 0) + rs * (res ? 2 : 4) * BOX + cs * 2 * (cw / 64) * BOX +
         BOX + WIDE * WIDE * 4 + (2 + 2 * rs + 2 * cs) * 8;
}

// dQ of 64 queries, pair oc of its column chunks (columns 2 CW oc ..).
// Warpgroup 1 computes S = Q K^T and P = exp(S - lse) and hands P to
// warpgroup 2 in fp32; warpgroup 2 computes dP = dO V^T and dS = P (dP -
// delta), rounds dS to bf16 and writes it in the swizzled layout of a TMA
// box, from which warpgroup 1 loads it. Both then accumulate a chunk of
// the pair: dQ += dS K, warpgroup 1 the first CW columns, warpgroup 2 the
// next CW. Persistent over (batch, head, pair, 64 queries).
template <int CW, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_streamed_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_g,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, int T, int H, int D, long long gb,
                             long long gt, long long gh, int nb, int nc, int tiles, int rs_n,
                             int cs_n, float scale) {
  constexpr int CB = 2 * CW / 64 * BOX;  // K's pair of chunks
  const int RSB = (RES ? 2 : 4) * BOX;  // a box stage: K, V (+ Q, dO)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* gs = qs + (RES ? nb * BOX : 0);
  uint8_t* ring = gs + (RES ? nb * BOX : 0);
  uint8_t* cring = ring + rs_n * RSB;
  uint8_t* dsb = cring + cs_n * CB;  // dS, bf16, one swizzled 64 x 64 box
  float* pex = reinterpret_cast<float*>(dsb + BOX);  // P, fp32
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(pex + WIDE * WIDE);
  uint64_t* qg_empty = qg_full + 1;
  uint64_t* full = qg_empty + 1;
  uint64_t* empty = full + rs_n;
  uint64_t* cfull = empty + rs_n;
  uint64_t* cempty = cfull + cs_n;
  const int n = T / WIDE;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    mbar_init(qg_empty, 8);
    for (int i = 0; i < rs_n; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    for (int i = 0; i < cs_n; ++i) {
      mbar_init(&cfull[i], 1);
      mbar_init(&cempty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int rs = 0, cs = 0;
      uint32_t rph = 0, cph = 0, it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const Work w(t, n, nc, H);
        if constexpr (RES) {
          mbar_wait(qg_empty, (it & 1) ^ 1);
          mbar_expect_tx(qg_full, 2 * nb * BOX);
          load_boxes(qs, BOX, &tm_q, qg_full, nb, 0, w.h, w.r * WIDE, w.b);
          load_boxes(gs, BOX, &tm_g, qg_full, nb, 0, w.h, w.r * WIDE, w.b);
        }
        const int cb = w.oc * (2 * CW / 64), ncb = chunk_boxes(2 * CW, nb, w.oc);
        for (int kt = 0; kt < n; ++kt) {
          for (int kb = 0; kb < nb; ++kb) {
            uint8_t* st = ring + rs * RSB;
            uint64_t* bar = &full[rs];
            mbar_wait(&empty[rs], rph ^ 1);
            mbar_expect_tx(bar, RSB);
            tma_load_4d(st, &tm_k, bar, 64 * kb, w.h, kt * WIDE, w.b);
            tma_load_4d(st + BOX, &tm_v, bar, 64 * kb, w.h, kt * WIDE, w.b);
            if constexpr (!RES) {
              tma_load_4d(st + 2 * BOX, &tm_q, bar, 64 * kb, w.h, w.r * WIDE, w.b);
              tma_load_4d(st + 3 * BOX, &tm_g, bar, 64 * kb, w.h, w.r * WIDE, w.b);
            }
            advance(rs, rph, rs_n);
          }
          mbar_wait(&cempty[cs], cph ^ 1);
          mbar_expect_tx(&cfull[cs], ncb * BOX);
          load_boxes(cring + cs * CB, BOX, &tm_k, &cfull[cs], ncb, cb, w.h, kt * WIDE, w.b);
          advance(cs, cph, cs_n);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const float sl2 = scale * kLog2e;
  int rs = 0, cs = 0;
  uint32_t rph = 0, cph = 0, it = 0;
  if (c == 0) {
    // ---- warpgroup 1: S, P; dQ's first chunk of the pair ----
    const uint32_t qa = smem_u32(qs), da = smem_u32(dsb);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const Work w(t, n, nc, H);
      const bool final_tile = t + (int)gridDim.x >= tiles;
      const int row0 = w.r * WIDE + 16 * warp + (lane >> 2);
      const size_t stat = ((size_t)w.b * H + w.h) * T + row0;
      const float l0 = lse[stat] * kLog2e, l1 = lse[stat + 8] * kLog2e;
      float dqa[CW / 2];
      zero(dqa);
      if constexpr (RES) mbar_wait(qg_full, it & 1);
      for (int kt = 0; kt < n; ++kt) {
        const bool first = it == 0 && kt == 0, last = final_tile && kt == n - 1;
        float s[WIDE / 2];  // S = Q K^T (K box first in a stage)
        logits<RES>(s, ring, RSB, full, empty, rs, rph, rs_n, nb, qa, BOX, 2 * BOX, WIDE, 0, 0,
                    lane);
#pragma unroll
        for (int i = 0; i < WIDE / 8; ++i) {  // P, in place
          s[4 * i] = fast_exp2(fmaf(s[4 * i], sl2, -l0));
          s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], sl2, -l0));
          s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], sl2, -l1));
          s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], sl2, -l1));
        }
        if (!first) bar_sync(P_FREE, 256);
        put_acc(pex, s, tid);
        bar_arrive(P_READY, 256);

        uint32_t dsa[WIDE / 16][4];
        bar_sync(DS_READY, 256);
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk) load_a_sw128(dsa[kk], da, WIDE, 16 * warp, kk, lane);
        if (!last) bar_arrive(DS_FREE, 256);
        mbar_wait(&cfull[cs], cph);
        const uint32_t ka = smem_u32(cring + cs * CB);
        fence_regs(dqa);
        fence();
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)  // dQ[:, chunk 2 oc] += dS K[:, chunk 2 oc]
          WgmmaRS<CW, 1>::mma(dqa, dsa[kk], mnmajor(ka, WIDE, kk), 1);
        commit();
        wait<0>();
        fence_regs(dqa);
        fence_regs(dsa);
        if (lane == 0) mbar_arrive(&cempty[cs]);
        advance(cs, cph, cs_n);
      }
      if (RES && lane == 0) mbar_arrive(qg_empty);
      const size_t base =
          (size_t)w.b * gb + (size_t)w.h * gh + (size_t)row0 * gt + w.oc * 2 * CW;
      store_rows<CW>(dqa, scale, scale, dq + base, dq + base + 8 * gt, D - w.oc * 2 * CW, lane);
    }
  } else {
    // ---- warpgroup 2: dP, dS; dQ's second chunk of the pair ----
    const uint32_t ga = smem_u32(gs);
    uint8_t* dsw = dsb + (16 * warp + (lane >> 2)) * ROW;  // this thread's row g of dS
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const Work w(t, n, nc, H);
      const bool final_tile = t + (int)gridDim.x >= tiles;
      const int row0 = w.r * WIDE + 16 * warp + (lane >> 2);
      const size_t stat = ((size_t)w.b * H + w.h) * T + row0;
      const float d0 = delta[stat], d1 = delta[stat + 8];
      float dqa[CW / 2];
      zero(dqa);
      if constexpr (RES) mbar_wait(qg_full, it & 1);
      for (int kt = 0; kt < n; ++kt) {
        const bool first = it == 0 && kt == 0, last = final_tile && kt == n - 1;
        float dp[WIDE / 2];  // dP = dO V^T (V box second in a stage)
        logits<RES>(dp, ring, RSB, full, empty, rs, rph, rs_n, nb, ga, BOX, 3 * BOX, WIDE, 0,
                    BOX, lane);

        float p[WIDE / 2];
        bar_sync(P_READY, 256);
        get_acc(pex, p, tid);
        if (!last) bar_arrive(P_FREE, 256);
        uint32_t dsa[WIDE / 16][4];
#pragma unroll
        for (int i = 0; i < WIDE / 8; ++i) {
          dsa[i >> 1][(i & 1) * 2] =
              pack_bf16(p[4 * i] * (dp[4 * i] - d0), p[4 * i + 1] * (dp[4 * i + 1] - d0));
          dsa[i >> 1][(i & 1) * 2 + 1] =
              pack_bf16(p[4 * i + 2] * (dp[4 * i + 2] - d1), p[4 * i + 3] * (dp[4 * i + 3] - d1));
        }
        // dS into the swizzled box: 16-byte chunk j of row r at chunk j ^ (r % 8)
        if (!first) bar_sync(DS_FREE, 256);
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = (lane >> 2) + 8 * (j & 1);  // row within this warp's 16
            const int chunk = (2 * kk + (j >> 1)) ^ (r & 7);
            *reinterpret_cast<uint32_t*>(dsw + 8 * (j & 1) * ROW + chunk * 16 + 4 * (lane & 3)) =
                dsa[kk][j];
          }
        bar_arrive(DS_READY, 256);
        mbar_wait(&cfull[cs], cph);
        const uint32_t ka = smem_u32(cring + cs * CB);
        fence_regs(dqa);
        fence();
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)  // dQ[:, chunk 2 oc + 1] += dS K[:, chunk 2 oc + 1]
          WgmmaRS<CW, 1>::mma(dqa, dsa[kk], mnmajor(ka + CW / 64 * BOX, WIDE, kk), 1);
        commit();
        wait<0>();
        fence_regs(dqa);
        fence_regs(dsa);
        if (lane == 0) mbar_arrive(&cempty[cs]);
        advance(cs, cph, cs_n);
      }
      if (RES && lane == 0) mbar_arrive(qg_empty);
      const size_t base =
          (size_t)w.b * gb + (size_t)w.h * gh + (size_t)row0 * gt + (w.oc * 2 + 1) * CW;
      store_rows<CW>(dqa, scale, scale, dq + base, dq + base + 8 * gt, D - (w.oc * 2 + 1) * CW,
                     lane);
    }
  }
}

// ------------------------------------------------------------------- host ----

// A kernel's layout: resident operand or not, stages of its two rings.
struct Plan {
  bool res;
  int rs, cs, smem;
};

// The first layout that fits a block's shared memory: resident first, then
// the most box-ring stages (the box loop waits on them every 64 columns),
// then the most chunk stages; smem(res, rs, cs) gives its bytes.
template <typename F>
Plan smem_plan(F smem, int rs_max, int cs_max) {
  for (int res = 1; res >= 0; --res)
    for (int rs = rs_max; rs >= 2; --rs)
      for (int cs = cs_max; cs >= 1; --cs)
        if (smem(res != 0, rs, cs) <= SMEM_MAX) return Plan{res != 0, rs, cs, smem(res != 0, rs, cs)};
  return Plan{false, 0, 0, 0};
}

// Output chunks of a head width of nb boxes, `pair` chunks a block: nc =
// ceil(nb / 4 / pair) blocks of pair chunks, each chunk CW = 64 ceil(nb /
// pair / nc) columns (192 or 256 for nb > 4).
inline int chunk_count(int nb, int pair) { return (nb + 4 * pair - 1) / (4 * pair); }
inline int chunk_width(int nb, int pair) {
  const int per = pair * chunk_count(nb, pair);
  return 64 * ((nb + per - 1) / per);
}

template <int CW, bool RES>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
               float* lse, int B, int T, int H, int D, int nb, const Plan& p, float scale,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_streamed_kernel<CW, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = chunk_count(nb, 1), tiles = B * H * nc * (T / QROWS);
  flash_fwd_streamed_kernel<CW, RES><<<grid_for(tiles), THREADS, p.smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, T, H, D, nb, nc, tiles, p.rs, p.cs, scale);
  return (int)cudaGetLastError();
}

template <int CW, bool RES>
int launch_dkv(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tg, const float* lse, const float* delta, void* dk, void* dv,
               int B, int T, int H, int D, long long gb, long long gt, long long gh, int nb,
               const Plan& p, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_streamed_kernel<CW, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = chunk_count(nb, 1), tiles = B * H * nc * (T / WIDE);
  flash_dkv_streamed_kernel<CW, RES><<<grid_for(tiles), THREADS, p.smem, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, D, gb,
      gt, gh, nb, nc, tiles, p.rs, p.cs, scale);
  return (int)cudaGetLastError();
}

template <int CW, bool RES>
int launch_dq(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
              const CUtensorMap& tg, const float* lse, const float* delta, void* dq, int B,
              int T, int H, int D, long long gb, long long gt, long long gh, int nb,
              const Plan& p, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_dq_streamed_kernel<CW, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = chunk_count(nb, 2), tiles = B * H * nc * (T / WIDE);
  flash_dq_streamed_kernel<CW, RES><<<grid_for(tiles), THREADS, p.smem, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dq), T, H, D, gb, gt, gh, nb, nc, tiles,
      p.rs, p.cs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

int rfv_flash::fwd_bf16_streamed(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int B, int T, int H, int D, long long sb,
                                 long long st, long long sh, float scale, cudaStream_t stream) {
  const int nb = (D + 63) / 64, cw = chunk_width(nb, 1);
  if (nb <= 4) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int e;
  if ((e = tensor_map(&tq, q, B, T, H, D, sb, st, sh, QROWS)) ||
      (e = tensor_map(&tk, k, B, T, H, D, sb, st, sh, WIDE)) ||
      (e = tensor_map(&tv, v, B, T, H, D, sb, st, sh, WIDE)))
    return e;
  const Plan p = smem_plan([&](bool res, int ks, int vs) { return fwd_smem(res, cw, nb, ks, vs); },
                           4, 2);
  if (p.rs == 0) return (int)cudaErrorInvalidValue;
  if (cw == 192)
    return p.res ? launch_fwd<192, true>(tq, tk, tv, o, lse, B, T, H, D, nb, p, scale, stream)
                 : launch_fwd<192, false>(tq, tk, tv, o, lse, B, T, H, D, nb, p, scale, stream);
  return p.res ? launch_fwd<256, true>(tq, tk, tv, o, lse, B, T, H, D, nb, p, scale, stream)
               : launch_fwd<256, false>(tq, tk, tv, o, lse, B, T, H, D, nb, p, scale, stream);
}

int rfv_flash::bwd_bf16_streamed(const void* q, const void* k, const void* v, const void* d_out,
                                 const float* lse, const float* delta, void* dq, void* dk,
                                 void* dv, int B, int T, int H, int D, long long sb, long long st,
                                 long long sh, long long gb, long long gt, long long gh,
                                 float scale, cudaStream_t stream) {
  const int nb = (D + 63) / 64, cw = chunk_width(nb, 1), cwq = chunk_width(nb, 2);
  if (nb <= 4) return (int)cudaErrorInvalidValue;
  const long long ot = (long long)H * D, ob = (long long)T * ot;  // d_out: contiguous
  CUtensorMap tq, tg, tk, tv;
  int e;
  if ((e = tensor_map(&tq, q, B, T, H, D, sb, st, sh, WIDE)) ||
      (e = tensor_map(&tg, d_out, B, T, H, D, ob, ot, D, WIDE)) ||
      (e = tensor_map(&tk, k, B, T, H, D, sb, st, sh, WIDE)) ||
      (e = tensor_map(&tv, v, B, T, H, D, sb, st, sh, WIDE)))
    return e;
  const Plan pkv = smem_plan(
      [&](bool res, int rs, int cs) { return dkv_smem(res, cw, nb, rs, cs); }, 3, 2);
  const Plan pq = smem_plan(
      [&](bool res, int rs, int cs) { return dq_smem(res, cwq, nb, rs, cs); }, 3, 2);
  if (pkv.rs == 0 || pq.rs == 0) return (int)cudaErrorInvalidValue;
  if (cw == 192)
    e = pkv.res ? launch_dkv<192, true>(tq, tk, tv, tg, lse, delta, dk, dv, B, T, H, D, gb, gt, gh,
                                        nb, pkv, scale, stream)
                : launch_dkv<192, false>(tq, tk, tv, tg, lse, delta, dk, dv, B, T, H, D, gb, gt,
                                         gh, nb, pkv, scale, stream);
  else
    e = pkv.res ? launch_dkv<256, true>(tq, tk, tv, tg, lse, delta, dk, dv, B, T, H, D, gb, gt, gh,
                                        nb, pkv, scale, stream)
                : launch_dkv<256, false>(tq, tk, tv, tg, lse, delta, dk, dv, B, T, H, D, gb, gt,
                                         gh, nb, pkv, scale, stream);
  if (e) return e;
  if (cwq == 192)
    return pq.res ? launch_dq<192, true>(tq, tk, tv, tg, lse, delta, dq, B, T, H, D, gb, gt, gh,
                                         nb, pq, scale, stream)
                  : launch_dq<192, false>(tq, tk, tv, tg, lse, delta, dq, B, T, H, D, gb, gt, gh,
                                          nb, pq, scale, stream);
  return pq.res ? launch_dq<256, true>(tq, tk, tv, tg, lse, delta, dq, B, T, H, D, gb, gt, gh, nb,
                                       pq, scale, stream)
                : launch_dq<256, false>(tq, tk, tv, tg, lse, delta, dq, B, T, H, D, gb, gt, gh, nb,
                                        pq, scale, stream);
}
