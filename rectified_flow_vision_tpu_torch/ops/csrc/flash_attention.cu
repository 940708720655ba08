// Flash attention, forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU library kernel that the JAX package's DiT calls for
// long sequences (rectified_flow_vision_tpu/models/dit.py _attention ->
// jax.experimental.pallas.ops.tpu.flash_attention: a forward kernel and the
// dq and dkv backward kernels, blocked by _flash_block_sizes): non-causal
// multi-head attention over q, k, v [B, T, H, D] with scale 1/sqrt(D) and an
// fp32 softmax. Nothing of size T^2 ever reaches device memory.
//
// Bound on the H100: operations. A forward call does 4*B*H*T^2*D flops over
// 4*B*T*H*D elements, T flops per element moved (1024 at the DiT-S/2 latent
// shape, above the card's ~295 bf16 flops per byte ridge); the backward's
// five products do 2.5 times the forward's flops. The split dkv / dq design
// recomputes S and dP in both kernels (seven products), so it can reach at
// most 5/7 of the backward's bound.
//
// Layout. q, k and v share one set of element strides (batch, token, head;
// the last axis is contiguous), so the three views of one [B, T, 3, H, D]
// projection are read in place. o and d_out are contiguous [B, T, H, D];
// lse and delta are fp32 [B, H, T]; dq, dk and dv share a second set of
// strides (the backward writes them into one [B, T, 3, H, D] buffer). The
// head width D is a multiple of 8 here: bf16 from 8 to 256, fp32 from 8 to
// 128; other widths reach these kernels zero-padded by the wrapper
// (ops/flash_attention.py). Wider heads take kernels of their own, launched
// from the entry points below: bf16 above 256 the streamed kernels of
// flash_attention_streamed.cu, fp32 above 128 the *_wide kernels of
// flash_attention_f32.cu.
//
// bfloat16: persistent, warp-specialised, wgmma + TMA (the design of
// conv3x3.cu).
//  - Every q, k, v, d_out tile arrives by TMA over the tensor viewed as 4D
//    (D, H, T, B), 128-byte swizzled, as boxes of 64 columns: D is padded to
//    DP = 64, 128, 192 or 256 (one to four boxes) in shared memory, and the
//    box's columns past D are zero-filled by the TMA unit, so they add
//    nothing to any product; the scale stays 1/sqrt(D) of the true D, and
//    output columns past D are not stored. No thread computes an address.
//  - 384 threads: warpgroup 0 is the producer (one thread issues the loads
//    into rings of stages signalled on mbarriers, 24 registers after
//    setmaxnreg); warpgroups 1 and 2 are consumers (240 registers), each
//    owning 64 rows of a tile. One block per SM walks the tiles of
//    (batch, head, 128 rows), the row tile fastest, so that the blocks in
//    flight share their K and V (or Q and dO) in L2, and the producer loads
//    the next tile while the consumers finish this one.
//  - First products (S = Q K^T, dP = dO V^T and their transposes) take the
//    operand that stays for the whole tile (Q; dO; K and V of dkv at
//    DP = 64, where their registers fit beside dK and dV) as A fragments
//    loaded once from shared memory by ldmatrix, so that only B streams
//    from shared memory; both K-major. Second products (P V, dS K, P^T dO,
//    dS^T Q) take A from registers, the first product's fp32 accumulator
//    rounded to bf16 in place, and B from shared memory MN-major (the
//    transposed form of wgmma).
//  - Forward: K and V in tiles of 128 keys through a 3-4-stage ring, on
//    barriers of their own so that Q K^T starts before V lands and K is
//    freed before P V is done. Software pipeline: one issue batch holds
//    Q K^T of key tile j and P V of tile j - 1, and the online softmax of
//    tile j (fp32 on the accumulator registers, ex2.approx, row maxima
//    reduced across each quad) runs while P V is on the tensor cores. The
//    two warpgroups take turns to issue (named barriers), so that one's
//    softmax runs under the other's products. The output is divided by the row sum once, rounded once and
//    stored with 16-byte stores; the per-row log-sum-exp goes to lse.
//    Probabilities are rounded to bf16 (unnormalised) before P V, as the
//    operand of a bf16 product must be.
//  - Backward: delta = rowsum(dO * O) (a pass of coalesced 16-byte loads),
//    then dkv (tiles of 128 keys; Q and dO tiles of 64 queries with their
//    lse and delta streamed through the ring; dK and dV accumulate in
//    registers) and dq (tiles of 128 queries; K and V tiles of 64 keys
//    streamed; its warpgroups take turns as the forward's). No atomics:
//    each output element is summed by one thread in a fixed order, so two
//    runs give the same bits.
//  - Above DP = 128 (D in 136 .. 256) the registers set the layout: an
//    m64nDP accumulator takes DP / 2 of a consumer's 240 (128 at DP = 256).
//    Forward: keys come in tiles of 64 (S: 32 registers), so that O, S and
//    the two P fragments (16 each) fit beside Q's A fragments at DP = 192
//    (48 registers: 208 in all); at DP = 256 Q stays in shared memory and
//    S = Q K^T takes both operands from there (SS: O, S and P in 192). The
//    warpgroups issue as they come (taking turns cost 20% here). Q (48 / 64
//    KB) and a ring of K and V tiles of 64 keys, 3 stages at DP = 192, 2 at
//    256: 197,744 / 197,712 bytes of shared memory. dkv (flash_dkv_wide_kernel)
//    takes 64 keys a block and splits the work by output: warpgroup 1
//    computes S^T and P^T and accumulates dV, warpgroup 2 computes dP^T,
//    reads P^T in fp32 from a 16 KB exchange buffer (named barriers), forms
//    dS^T and accumulates dK, so each holds one accumulator; K + V, a ring of
//    Q + dO tiles of 64 queries with their lse and delta (3 / 2 stages) and
//    the exchange: 215,616 / 215,088 bytes. dq (flash_dq_wide_kernel) takes
//    64 queries a block: warpgroup 1 holds Q in registers and computes S and
//    P, warpgroup 2 holds dO, computes dP and dS from P, rounds dS to bf16
//    and writes it in the swizzled layout of a TMA tile; both accumulate
//    their columns of dQ += dS K (128 and DP - 128); 222,272 / 222,256
//    bytes. ptxas (nvcc 12.9, sm_90a): 168 registers at the launch bound of
//    384 threads (setmaxnreg then gives the consumers 240), no spills, no
//    serialised wgmma. P and dS are rounded to bf16 before the products
//    that take them, as at DP <= 128 and in the plain versions.
// float32 (flash_attention_f32.cu): up to D = 128 3xTF32 products on the
// tensor cores (mma.sync m16n8k8, fp32-accurate), above it SIMT kernels.
#include "flash_attention.cuh"
#include "mma.cuh"
#include "wgmma.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace rfv_wgmma;
using namespace rfv_flash_tc;
using rfv_mma::pack_bf16;

// Query rows and keys of a block and of a ring tile, per kernel, at DP <= 128.
// Above it the forward streams keys in tiles of 64 (fwd_keys), and dkv and dq
// are the *_wide kernels: blocks of 64 keys or queries, ring tiles of 64.
constexpr int FWD_Q = 128, FWD_K = 128;
constexpr int DKV_K = 128, DKV_Q = 64;
constexpr int DQ_Q = 128, DQ_K = 64;

// Keys of a forward ring tile: 128, or 64 above DP = 128, where Q stays in
// shared memory and S (64 x 64, 32 registers) must fit beside the m64nDP
// output accumulator (DP / 2 registers).
template <int DP>
__host__ __device__ constexpr int fwd_keys() { return DP > 128 ? WIDE : FWD_K; }

// A rows x DP bf16 tile: DP / 64 boxes of rows x 64 columns, each rows x 128
// bytes, one after the other.
template <int DP>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * DP * 2; }

// The DP / 64 boxes of the rows x DP tile of head h at tokens t0.. of batch b.
template <int DP>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int rows, int b, int t0, int h) {
#pragma unroll
  for (int r = 0; r < DP / 64; ++r) tma_load_4d(dst + r * rows * ROW, map, bar, 64 * r, h, t0, b);
}

template <int DP>
__host__ __device__ constexpr int fwd_smem(int stages) {
  return 1024 + tile_bytes<DP>(FWD_Q) + stages * 2 * tile_bytes<DP>(fwd_keys<DP>()) +
         (2 + 4 * stages) * 8;
}

// S = Q K^T of one warpgroup's 64 query rows and a key tile at shared address
// ka: A from the Q fragments in registers (QREG), else from the Q tile in
// shared memory (rows 64 c ..), B from the key tile.
template <int DP, int FK, bool QREG>
__device__ __forceinline__ void qk_product(float (&s)[FK / 2],
                                           const uint32_t (&qf)[QREG ? DP / 16 : 1][4],
                                           uint32_t qa, int c, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if constexpr (QREG)
      WgmmaRS<FK, 0>::mma(s, qf[kk], kmajor(ka, FK, 0, kk), kk > 0);
    else
      Wgmma<FK>::mma(s, kmajor(qa, FWD_Q, 64 * c, kk), kmajor(ka, FK, 0, kk), kk > 0);
  }
}

// Persistent: block i takes the output tiles i, i + gridDim.x, ... of
// (batch, head, 128 query rows), query tile fastest, so that the blocks in
// flight share K and V in L2. K and V of a stage are freed apart (K when S
// is done, V when P V is), so that the producer runs a key tile ahead even
// on the two stages of DP = 256. Up to DP = 192 the consumers hold Q in
// registers and the producer loads the next tile's Q as soon as they have
// it; at DP = 256, Q is read from shared memory by every S product, and
// freed when the tile's last one is done.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                           float* __restrict__ lse, int T, int H, int D, int tiles, int stages,
                           float scale) {
  constexpr int FK = fwd_keys<DP>();
  constexpr bool QREG = DP <= 192;  // Q as A fragments (DP / 4 registers)
  constexpr int QB = tile_bytes<DP>(FWD_Q), KB = tile_bytes<DP>(FK);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ring = qs + QB;  // stage s: K at ring + 2 KB s, V right after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + stages * 2 * KB);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + stages;
  uint64_t* k_empty = v_full + stages;
  uint64_t* v_empty = k_empty + stages;
  const int nq = T / FWD_Q, nk = T / FK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int i = 0; i < stages; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], 8);
      mbar_init(&v_empty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int qt = t % nq, h = (t / nq) % H, b = t / nq / H;
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_expect_tx(q_full, QB);
        load_tile<DP>(qs, &tm_q, q_full, FWD_Q, b, qt * FWD_Q, h);
        for (int kt = 0; kt < nk; ++kt) {
          uint8_t* st = ring + stage * 2 * KB;
          mbar_wait(&k_empty[stage], phase ^ 1);
          mbar_expect_tx(&k_full[stage], KB);
          load_tile<DP>(st, &tm_k, &k_full[stage], FK, b, kt * FK, h);
          mbar_wait(&v_empty[stage], phase ^ 1);
          mbar_expect_tx(&v_full[stage], KB);
          load_tile<DP>(st + KB, &tm_v, &v_full[stage], FK, b, kt * FK, h);
          advance(stage, phase, stages);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows 64 c .. 64 c + 63 of a tile ----
    // Software pipeline: a turn issues S = Q K^T of key tile kt and O += P V
    // of key tile kt - 1 (rescaled first by the factor tile kt - 1's softmax
    // found), then the softmax of tile kt runs while P V is still on the
    // tensor cores (and the other warpgroup's products after it). Key tile 0
    // (no P V yet) and the last P V are peeled off, so that no product is
    // issued on a branch.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t qa = smem_u32(qs);
    // Up to DP = 128 the warpgroups take turns; above it they issue as they
    // come, which measured 20% faster at DP = 192 and 256 (PERF.md §6).
    const TurnTaking<DP <= 128> turns(c);
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int qt = t % nq, h = (t / nq) % H, b = t / nq / H;
      const bool final_tile = t + (int)gridDim.x >= tiles;
      uint32_t qf[QREG ? DP / 16 : 1][4];  // this warp's 16 rows of Q, A fragments
      mbar_wait(q_full, it & 1);
      if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          load_a_sw128(qf[kk], qa, FWD_Q, 64 * c + 16 * warp, kk, lane);
        if (lane == 0) mbar_arrive(q_empty);
      }

      OnlineSoftmax sm(scale);
      float oacc[DP / 2];
      zero(oacc);
      uint32_t pa[FK / 16][4];  // P of the previous key tile, bf16 A fragments
      {
        float s[FK / 2];
        mbar_wait(&k_full[stage], phase);
        turns.take();
        fence();
        qk_product<DP, FK, QREG>(s, qf, qa, c, smem_u32(ring + stage * 2 * KB));
        commit();
        turns.pass(final_tile && nk == 1);
        wait<0>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(&k_empty[stage]);
        sm.tile<FK>(s, pa);
      }
      int pstage = stage;
      uint32_t pphase = phase;
      advance(stage, phase, stages);
      for (int kt = 1; kt < nk; ++kt) {
        const uint32_t ka = smem_u32(ring + stage * 2 * KB);
        const uint32_t pva = smem_u32(ring + pstage * 2 * KB) + KB;  // V of key tile kt - 1
        float s[FK / 2];
        uint32_t pn[FK / 16][4];
        mbar_wait(&k_full[stage], phase);
        mbar_wait(&v_full[pstage], pphase);
        turns.take();
        sm.rescale<DP>(oacc);
        fence_regs(oacc);
        fence();
        qk_product<DP, FK, QREG>(s, qf, qa, c, ka);
        commit();
#pragma unroll
        for (int kk = 0; kk < FK / 16; ++kk)
          WgmmaRS<DP, 1>::mma(oacc, pa[kk], mnmajor(pva, FK, kk), 1);
        commit();
        turns.pass(final_tile && kt == nk - 1);
        wait<1>();  // S is done; P V may still run
        fence_regs(s);
        if (lane == 0) mbar_arrive(&k_empty[stage]);
        sm.tile<FK>(s, pn);
        wait<0>();  // P V of key tile kt - 1: its V is free
        fence_regs(oacc);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(&v_empty[pstage]);
#pragma unroll
        for (int i = 0; i < FK / 16; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pa[i][j] = pn[i][j];
        pstage = stage;
        pphase = phase;
        advance(stage, phase, stages);
      }
      if constexpr (!QREG) {
        if (lane == 0) mbar_arrive(q_empty);  // the tile's S products are done
      }

      // the last key tile's P V
      mbar_wait(&v_full[pstage], pphase);
      sm.rescale<DP>(oacc);
      fence_regs(oacc);
      fence();
      const uint32_t pva = smem_u32(ring + pstage * 2 * KB) + KB;
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        WgmmaRS<DP, 1>::mma(oacc, pa[kk], mnmajor(pva, FK, kk), 1);
      commit();
      wait<0>();
      fence_regs(oacc);
      if (lane == 0) mbar_arrive(&v_empty[pstage]);

      float l0 = sm.l0, l1 = sm.l1;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const int row0 = qt * FWD_Q + 64 * c + 16 * warp + (lane >> 2);
      bf16* o0 = o + (((size_t)b * T + row0) * H + h) * D;
      store_rows<DP>(oacc, 1.f / l0, 1.f / l1, o0, o0 + (size_t)8 * H * D, D, lane);
      if ((lane & 3) == 0) {
        float* l = lse + ((size_t)b * H + h) * T + row0;
        l[0] = sm.m0 * scale + logf(l0);
        l[8] = sm.m1 * scale + logf(l1);
      }
    }
  }
}

// ------------------------------------------------------------- backward ----

// The barriers of a backward kernel: `once` full and empty for the tiles a
// block holds for its whole output tile (K and V in dkv, Q and dO in dq),
// then full[stages] and empty[stages] for the ring. Every empty barrier
// takes one arrival per consumer warp.
__device__ __forceinline__ void init_bwd_barriers(uint64_t* once, int stages) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    mbar_init(once + 1, 8);
    for (int i = 0; i < stages; ++i) {
      mbar_init(once + 2 + i, 1);
      mbar_init(once + 2 + stages + i, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// dkv's producer thread, persistent over the (batch, head, KR keys) tiles:
// K and V of a tile once (into ks, vs = ks + their bytes), then Q and dO of
// every QR-query tile, with their lse and delta, through the ring.
template <int DP, int KR, int QR>
__device__ __forceinline__ void dkv_produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v, const CUtensorMap* tm_g,
                                            const float* lse, const float* delta, uint8_t* ks,
                                            uint8_t* ring, float* stats, uint64_t* once, int T,
                                            int H, int tiles, int stages) {
  constexpr int KB = tile_bytes<DP>(KR), QB = tile_bytes<DP>(QR);
  uint64_t* full = once + 2;
  uint64_t* empty = full + stages;
  const int nkt = T / KR, nq = T / QR;
  int stage = 0;
  uint32_t phase = 0, it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int kt = t % nkt, h = (t / nkt) % H, b = t / nkt / H;
    mbar_wait(once + 1, (it & 1) ^ 1);
    mbar_expect_tx(once, 2 * KB);
    load_tile<DP>(ks, tm_k, once, KR, b, kt * KR, h);
    load_tile<DP>(ks + KB, tm_v, once, KR, b, kt * KR, h);
    const float* lse_bh = lse + ((size_t)b * H + h) * T;
    const float* delta_bh = delta + ((size_t)b * H + h) * T;
    for (int qt = 0; qt < nq; ++qt) {
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* st = ring + stage * 2 * QB;
      float* sst = stats + stage * 2 * QR;
      mbar_expect_tx(&full[stage], 2 * QB + 2 * QR * 4);
      load_tile<DP>(st, tm_q, &full[stage], QR, b, qt * QR, h);
      load_tile<DP>(st + QB, tm_g, &full[stage], QR, b, qt * QR, h);
      bulk_load(sst, lse_bh + qt * QR, QR * 4, &full[stage]);
      bulk_load(sst + QR, delta_bh + qt * QR, QR * 4, &full[stage]);
      advance(stage, phase, stages);
    }
  }
}

// dq's producer thread, persistent over the (batch, head, QR queries)
// tiles: Q and dO of a tile once (into qs, gs = qs + their bytes), then K
// and V of every KR-key tile through the ring.
template <int DP, int QR, int KR>
__device__ __forceinline__ void dq_produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, const CUtensorMap* tm_g,
                                           uint8_t* qs, uint8_t* ring, uint64_t* once, int T,
                                           int H, int tiles, int stages) {
  constexpr int QB = tile_bytes<DP>(QR), KB = tile_bytes<DP>(KR);
  uint64_t* full = once + 2;
  uint64_t* empty = full + stages;
  const int nq = T / QR, nk = T / KR;
  int stage = 0;
  uint32_t phase = 0, it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int qt = t % nq, h = (t / nq) % H, b = t / nq / H;
    mbar_wait(once + 1, (it & 1) ^ 1);
    mbar_expect_tx(once, 2 * QB);
    load_tile<DP>(qs, tm_q, once, QR, b, qt * QR, h);
    load_tile<DP>(qs + QB, tm_g, once, QR, b, qt * QR, h);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* st = ring + stage * 2 * KB;
      mbar_expect_tx(&full[stage], 2 * KB);
      load_tile<DP>(st, tm_k, &full[stage], KR, b, kt * KR, h);
      load_tile<DP>(st + KB, tm_v, &full[stage], KR, b, kt * KR, h);
      advance(stage, phase, stages);
    }
  }
}

// ------------------------------------------------------------------- dkv ----

template <int DP>
__host__ __device__ constexpr int dkv_smem(int stages) {
  return 1024 + 2 * tile_bytes<DP>(DKV_K) + stages * (2 * tile_bytes<DP>(DKV_Q) + 2 * DKV_Q * 4) +
         (2 + 2 * stages) * 8;
}

// dK and dV of 128 keys; everything is computed transposed, keys in the rows,
// so that each consumer warpgroup owns 64 keys' accumulators. Persistent over
// the (batch, head, 128 keys) tiles, as the forward. The two warpgroups issue
// as they come: taking turns made this kernel slower (PERF.md).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_g,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, int D,
                           long long gb, long long gt, long long gh, int tiles, int stages,
                           float scale) {
  constexpr int KB = tile_bytes<DP>(DKV_K), QB = tile_bytes<DP>(DKV_Q);
  constexpr int STAT = 2 * DKV_Q;  // floats of a stage's lse and delta
  // K and V as A fragments where they fit the registers beside dK and dV
  // (then the next tile's K and V load under this tile's work)
  constexpr bool AREG = DP == 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + KB;
  uint8_t* ring = vs + KB;  // stage s: Q at ring + 2 QB s, dO right after it
  float* stats = reinterpret_cast<float*>(ring + stages * 2 * QB);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + stages * STAT);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + stages;
  const int nkt = T / DKV_K, nq = T / DKV_Q;
  const int wg = threadIdx.x / 128;
  init_bwd_barriers(kv_full, stages);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      dkv_produce<DP, DKV_K, DKV_Q>(&tm_q, &tm_k, &tm_v, &tm_g, lse, delta, ks, ring, stats,
                                    kv_full, T, H, tiles, stages);
  } else {
    // ---- consumers: warpgroup c owns keys 64 c .. 64 c + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t ka = smem_u32(ks), va = smem_u32(vs);
    const float sl2 = scale * kLog2e;
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int kt = t % nkt, h = (t / nkt) % H, b = t / nkt / H;
      float dka[DP / 2], dva[DP / 2];
      zero(dka);
      zero(dva);
      uint32_t kf[AREG ? DP / 16 : 1][4], vf[AREG ? DP / 16 : 1][4];
      mbar_wait(kv_full, it & 1);
      if constexpr (AREG) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          load_a_sw128(kf[kk], ka, DKV_K, 64 * c + 16 * warp, kk, lane);
          load_a_sw128(vf[kk], va, DKV_K, 64 * c + 16 * warp, kk, lane);
        }
        if (lane == 0) mbar_arrive(kv_empty);
      }
      for (int qt = 0; qt < nq; ++qt) {
        const uint32_t qa = smem_u32(ring + stage * 2 * QB), ga = qa + QB;
        const float* ls = stats + stage * STAT;
        const float* ds = ls + DKV_Q;
        float sT[DKV_Q / 2], dpT[DKV_Q / 2];
        mbar_wait(&full[stage], phase);
        fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {  // S^T[n, m] = sum_d K[n, d] Q[m, d]
          if constexpr (AREG)
            WgmmaRS<DKV_Q, 0>::mma(sT, kf[kk], kmajor(qa, DKV_Q, 0, kk), kk > 0);
          else
            Wgmma<DKV_Q>::mma(sT, kmajor(ka, DKV_K, 64 * c, kk), kmajor(qa, DKV_Q, 0, kk), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {  // dP^T[n, m] = sum_d V[n, d] dO[m, d]
          if constexpr (AREG)
            WgmmaRS<DKV_Q, 0>::mma(dpT, vf[kk], kmajor(ga, DKV_Q, 0, kk), kk > 0);
          else
            Wgmma<DKV_Q>::mma(dpT, kmajor(va, DKV_K, 64 * c, kk), kmajor(ga, DKV_Q, 0, kk),
                              kk > 0);
        }
        commit();
        wait<0>();
        fence_regs(sT);
        fence_regs(dpT);

        // this thread's query columns 8i + 2 (lane % 4) + {0, 1}
        uint32_t pa[DKV_Q / 16][4], dsa[DKV_Q / 16][4];
#pragma unroll
        for (int i = 0; i < DKV_Q / 8; ++i) {
          const int m = 8 * i + 2 * (lane & 3);
          const float2 l = *reinterpret_cast<const float2*>(ls + m);
          const float2 d = *reinterpret_cast<const float2*>(ds + m);
          const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
          const float p0 = fast_exp2(fmaf(sT[4 * i], sl2, -l0));
          const float p1 = fast_exp2(fmaf(sT[4 * i + 1], sl2, -l1));
          const float p2 = fast_exp2(fmaf(sT[4 * i + 2], sl2, -l0));
          const float p3 = fast_exp2(fmaf(sT[4 * i + 3], sl2, -l1));
          pa[i >> 1][(i & 1) * 2] = pack_bf16(p0, p1);
          pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
          dsa[i >> 1][(i & 1) * 2] =
              pack_bf16(p0 * (dpT[4 * i] - d.x), p1 * (dpT[4 * i + 1] - d.y));
          dsa[i >> 1][(i & 1) * 2 + 1] =
              pack_bf16(p2 * (dpT[4 * i + 2] - d.x), p3 * (dpT[4 * i + 3] - d.y));
        }
        fence_regs(dva);
        fence_regs(dka);
        fence();
#pragma unroll
        for (int kk = 0; kk < DKV_Q / 16; ++kk) {
          WgmmaRS<DP, 1>::mma(dva, pa[kk], mnmajor(ga, DKV_Q, kk), 1);   // dV += P^T dO
          WgmmaRS<DP, 1>::mma(dka, dsa[kk], mnmajor(qa, DKV_Q, kk), 1);  // dK += dS^T Q
        }
        commit();
        wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pa);
        fence_regs(dsa);
        if (lane == 0) mbar_arrive(&empty[stage]);
        advance(stage, phase, stages);
      }
      if (!AREG && lane == 0) mbar_arrive(kv_empty);  // the last product that read K, V is done

      const int row0 = kt * DKV_K + 64 * c + 16 * warp + (lane >> 2);
      const size_t base = (size_t)b * gb + (size_t)h * gh + (size_t)row0 * gt;
      store_rows<DP>(dka, scale, scale, dk + base, dk + base + 8 * gt, D, lane);
      store_rows<DP>(dva, 1.f, 1.f, dv + base, dv + base + 8 * gt, D, lane);
    }
  }
}

// -------------------------------------------------------------------- dq ----

template <int DP>
__host__ __device__ constexpr int dq_smem(int stages) {
  return 1024 + 2 * tile_bytes<DP>(DQ_Q) + stages * 2 * tile_bytes<DP>(DQ_K) + (2 + 2 * stages) * 8;
}

// dQ of 128 queries; persistent over the (batch, head, 128 queries) tiles.
// Its warpgroups take turns to issue their products, as the forward's.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int T, int H, int D, long long gb, long long gt,
                          long long gh, int tiles, int stages, float scale) {
  constexpr int QB = tile_bytes<DP>(DQ_Q), KB = tile_bytes<DP>(DQ_K);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* gs = qs + QB;
  uint8_t* ring = gs + QB;  // stage s: K at ring + 2 KB s, V right after it
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(ring + stages * 2 * KB);
  uint64_t* qg_empty = qg_full + 1;
  uint64_t* full = qg_empty + 1;
  uint64_t* empty = full + stages;
  const int nq = T / DQ_Q, nk = T / DQ_K;
  const int wg = threadIdx.x / 128;
  init_bwd_barriers(qg_full, stages);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      dq_produce<DP, DQ_Q, DQ_K>(&tm_q, &tm_k, &tm_v, &tm_g, qs, ring, qg_full, T, H, tiles,
                                 stages);
  } else {
    // ---- consumers: warpgroup c owns query rows 64 c .. 64 c + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const uint32_t qa = smem_u32(qs), ga = smem_u32(gs);
    const float sl2 = scale * kLog2e;
    const TurnTaking<> turns(c);
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int qt = t % nq, h = (t / nq) % H, b = t / nq / H;
      const bool final_tile = t + (int)gridDim.x >= tiles;
      const int row0 = qt * DQ_Q + 64 * c + 16 * warp + (lane >> 2);
      const size_t stat = ((size_t)b * H + h) * T + row0;
      const float l0 = lse[stat] * kLog2e, l1 = lse[stat + 8] * kLog2e;
      const float d0 = delta[stat], d1 = delta[stat + 8];
      float dqa[DP / 2];
      zero(dqa);
      uint32_t qf[DP / 16][4], gf[DP / 16][4];  // this warp's rows of Q and dO, A fragments
      mbar_wait(qg_full, it & 1);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        load_a_sw128(qf[kk], qa, DQ_Q, 64 * c + 16 * warp, kk, lane);
        load_a_sw128(gf[kk], ga, DQ_Q, 64 * c + 16 * warp, kk, lane);
      }
      if (lane == 0) mbar_arrive(qg_empty);
      for (int kt = 0; kt < nk; ++kt) {
        const uint32_t ka = smem_u32(ring + stage * 2 * KB), va = ka + KB;
        float s[DQ_K / 2], dp[DQ_K / 2];
        mbar_wait(&full[stage], phase);
        turns.take();
        fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)  // S[m, n] = sum_d Q[m, d] K[n, d]
          WgmmaRS<DQ_K, 0>::mma(s, qf[kk], kmajor(ka, DQ_K, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)  // dP[m, n] = sum_d dO[m, d] V[n, d]
          WgmmaRS<DQ_K, 0>::mma(dp, gf[kk], kmajor(va, DQ_K, 0, kk), kk > 0);
        commit();
        turns.pass(false);
        wait<0>();
        fence_regs(s);
        fence_regs(dp);

        uint32_t dsa[DQ_K / 16][4];
#pragma unroll
        for (int i = 0; i < DQ_K / 8; ++i) {
          const float p0 = fast_exp2(fmaf(s[4 * i], sl2, -l0));
          const float p1 = fast_exp2(fmaf(s[4 * i + 1], sl2, -l0));
          const float p2 = fast_exp2(fmaf(s[4 * i + 2], sl2, -l1));
          const float p3 = fast_exp2(fmaf(s[4 * i + 3], sl2, -l1));
          dsa[i >> 1][(i & 1) * 2] = pack_bf16(p0 * (dp[4 * i] - d0), p1 * (dp[4 * i + 1] - d0));
          dsa[i >> 1][(i & 1) * 2 + 1] =
              pack_bf16(p2 * (dp[4 * i + 2] - d1), p3 * (dp[4 * i + 3] - d1));
        }
        turns.take();
        fence_regs(dqa);
        fence();
#pragma unroll
        for (int kk = 0; kk < DQ_K / 16; ++kk)  // dQ += dS K
          WgmmaRS<DP, 1>::mma(dqa, dsa[kk], mnmajor(ka, DQ_K, kk), 1);
        commit();
        turns.pass(final_tile && kt == nk - 1);
        wait<0>();
        fence_regs(dqa);
        fence_regs(dsa);
        if (lane == 0) mbar_arrive(&empty[stage]);
        advance(stage, phase, stages);
      }

      const size_t base = (size_t)b * gb + (size_t)h * gh + (size_t)row0 * gt;
      store_rows<DP>(dqa, scale, scale, dq + base, dq + base + 8 * gt, D, lane);
    }
  }
}

// --------------------------------------------------- dkv and dq above 128 ----

// Above DP = 128 one warpgroup cannot hold the m64nDP accumulators that dkv
// and dq keep at DP <= 128 beside their logit tiles (dK and dV alone would
// take DP registers a thread). The *_wide kernels take blocks of 64 keys
// (dkv) or 64 queries (dq) and give their two consumer warpgroups one half
// of the work each, exchanging what the other needs through shared memory
// on named barriers (one warpgroup arrives, the other syncs: 256 threads).
// Every exchange is matched: the first wait of a kernel and its last
// release are skipped.

template <int DP>
__host__ __device__ constexpr int dkv_wide_smem(int stages) {
  return 1024 + 2 * tile_bytes<DP>(WIDE) + stages * (2 * tile_bytes<DP>(WIDE) + 2 * WIDE * 4) +
         WIDE * WIDE * 4 + (2 + 2 * stages) * 8;
}

// dK and dV of 64 keys, transposed as at DP <= 128 (keys in the rows), the
// warpgroups split by output: warpgroup 1 computes S^T = K Q^T, P^T =
// exp(S^T - lse), hands P^T to warpgroup 2 in fp32 and accumulates dV +=
// P^T dO; warpgroup 2 computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) and
// accumulates dK += dS^T Q. Each runs two of the four products and holds
// one m64nDP accumulator; the first products read K or V from shared memory
// (SS). Both run the same instructions on other operands, so that no
// product is issued on a branch. Persistent over (batch, head, 64 keys).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, int D,
                          long long gb, long long gt, long long gh, int tiles, int stages,
                          float scale) {
  constexpr int TB = tile_bytes<DP>(WIDE);
  constexpr int STAT = 2 * WIDE;  // floats of a stage's lse and delta
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + TB;
  uint8_t* ring = vs + TB;  // stage s: Q at ring + 2 TB s, dO right after it
  float* stats = reinterpret_cast<float*>(ring + stages * 2 * TB);
  float* pex = stats + stages * STAT;  // P^T, fp32
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(pex + WIDE * WIDE);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + stages;
  const int n = T / WIDE;  // key tiles of a head, and query tiles
  const int wg = threadIdx.x / 128;
  init_bwd_barriers(kv_full, stages);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      dkv_produce<DP, WIDE, WIDE>(&tm_q, &tm_k, &tm_v, &tm_g, lse, delta, ks, ring, stats,
                                  kv_full, T, H, tiles, stages);
  } else {
    // ---- consumers: warpgroup 1 (c = 0) dV, warpgroup 2 (c = 1) dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
    const uint32_t first_a = smem_u32(c == 0 ? ks : vs);  // K for S^T, V for dP^T
    const float sl2 = scale * kLog2e;
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int kt = t % n, h = (t / n) % H, b = t / n / H;
      const bool final_tile = t + (int)gridDim.x >= tiles;
      float acc[DP / 2];  // dV (c = 0) or dK (c = 1) of this warp's 16 keys
      zero(acc);
      mbar_wait(kv_full, it & 1);
      for (int qt = 0; qt < n; ++qt) {
        const uint32_t qa = smem_u32(ring + stage * 2 * TB), ga = qa + TB;
        const float* ls = stats + stage * STAT;
        const float* ds = ls + WIDE;
        const bool first = it == 0 && qt == 0, last = final_tile && qt == n - 1;
        // c = 0: S^T[n, m] = sum_d K[n, d] Q[m, d]; c = 1: dP^T[n, m] = sum_d V[n, d] dO[m, d]
        const uint32_t first_b = c == 0 ? qa : ga;
        float x[WIDE / 2];
        mbar_wait(&full[stage], phase);
        fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          Wgmma<WIDE>::mma(x, kmajor(first_a, WIDE, 0, kk), kmajor(first_b, WIDE, 0, kk), kk > 0);
        commit();
        wait<0>();
        fence_regs(x);

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
        // c = 0: dV += P^T dO; c = 1: dK += dS^T Q
        const uint32_t second_b = c == 0 ? ga : qa;
        fence_regs(acc);
        fence();
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)
          WgmmaRS<DP, 1>::mma(acc, fa[kk], mnmajor(second_b, WIDE, kk), 1);
        commit();
        wait<0>();
        fence_regs(acc);
        fence_regs(fa);
        if (lane == 0) mbar_arrive(&empty[stage]);
        advance(stage, phase, stages);
      }
      if (lane == 0) mbar_arrive(kv_empty);

      const int row0 = kt * WIDE + 16 * warp + (lane >> 2);
      const size_t base = (size_t)b * gb + (size_t)h * gh + (size_t)row0 * gt;
      bf16* dst = (c == 0 ? dv : dk) + base;
      const float mul = c == 0 ? 1.f : scale;
      store_rows<DP>(acc, mul, mul, dst, dst + 8 * gt, D, lane);
    }
  }
}

template <int DP>
__host__ __device__ constexpr int dq_wide_smem(int stages) {
  return 1024 + 2 * tile_bytes<DP>(WIDE) + stages * 2 * tile_bytes<DP>(WIDE) + WIDE * ROW +
         WIDE * WIDE * 4 + (2 + 2 * stages) * 8;
}

// dQ of 64 queries. Warpgroup 1 holds Q as A fragments, computes S = Q K^T and
// P = exp(S - lse) and hands P to warpgroup 2 in fp32; warpgroup 2 holds dO,
// computes dP = dO V^T and dS = P (dP - delta), rounds dS to bf16 and writes
// it to shared memory in the swizzled layout of a TMA tile, from which
// warpgroup 1 loads it by ldmatrix. Both then accumulate their columns of
// dQ += dS K: warpgroup 1 the first 128, warpgroup 2 the other DP - 128 (64
// or 128). The roles differ in their products, so each runs its own loop.
// Persistent over (batch, head, 64 queries).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int T, int H, int D, long long gb, long long gt,
                         long long gh, int tiles, int stages, float scale) {
  constexpr int TB = tile_bytes<DP>(WIDE);
  constexpr int N1 = DP - 128;  // dQ columns of warpgroup 2
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* gs = qs + TB;
  uint8_t* ring = gs + TB;  // stage s: K at ring + 2 TB s, V right after it
  uint8_t* dsb = ring + stages * 2 * TB;  // dS, bf16, one swizzled 64 x 64 box
  float* pex = reinterpret_cast<float*>(dsb + WIDE * ROW);  // P, fp32
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(pex + WIDE * WIDE);
  uint64_t* qg_empty = qg_full + 1;
  uint64_t* full = qg_empty + 1;
  uint64_t* empty = full + stages;
  const int n = T / WIDE;
  const int wg = threadIdx.x / 128;
  init_bwd_barriers(qg_full, stages);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      dq_produce<DP, WIDE, WIDE>(&tm_q, &tm_k, &tm_v, &tm_g, qs, ring, qg_full, T, H, tiles,
                                 stages);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const float sl2 = scale * kLog2e;
  int stage = 0;
  uint32_t phase = 0, it = 0;
  if (c == 0) {
    // ---- warpgroup 1: S, P; dQ columns 0 .. 127 ----
    const uint32_t qa = smem_u32(qs), da = smem_u32(dsb);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int qt = t % n, h = (t / n) % H, b = t / n / H;
      const bool final_tile = t + (int)gridDim.x >= tiles;
      const int row0 = qt * WIDE + 16 * warp + (lane >> 2);
      const size_t stat = ((size_t)b * H + h) * T + row0;
      const float l0 = lse[stat] * kLog2e, l1 = lse[stat + 8] * kLog2e;
      float dqa[64];
      zero(dqa);
      uint32_t qf[DP / 16][4];  // this warp's 16 rows of Q, A fragments
      mbar_wait(qg_full, it & 1);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) load_a_sw128(qf[kk], qa, WIDE, 16 * warp, kk, lane);
      if (lane == 0) mbar_arrive(qg_empty);
      for (int kt = 0; kt < n; ++kt) {
        const uint32_t ka = smem_u32(ring + stage * 2 * TB);
        const bool first = it == 0 && kt == 0, last = final_tile && kt == n - 1;
        float s[WIDE / 2];
        mbar_wait(&full[stage], phase);
        fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)  // S[m, n] = sum_d Q[m, d] K[n, d]
          WgmmaRS<WIDE, 0>::mma(s, qf[kk], kmajor(ka, WIDE, 0, kk), kk > 0);
        commit();
        wait<0>();
        fence_regs(s);
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
        fence_regs(dqa);
        fence();
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)  // dQ[:, :128] += dS K[:, :128]
          WgmmaRS<128, 1>::mma(dqa, dsa[kk], mnmajor(ka, WIDE, kk), 1);
        commit();
        wait<0>();
        fence_regs(dqa);
        fence_regs(dsa);
        if (lane == 0) mbar_arrive(&empty[stage]);
        advance(stage, phase, stages);
      }
      const size_t base = (size_t)b * gb + (size_t)h * gh + (size_t)row0 * gt;
      store_rows<128>(dqa, scale, scale, dq + base, dq + base + 8 * gt, D, lane);
    }
  } else {
    // ---- warpgroup 2: dP, dS; dQ columns 128 .. DP - 1 ----
    const uint32_t ga = smem_u32(gs);
    uint8_t* dsw = dsb + (16 * warp + (lane >> 2)) * ROW;  // this thread's row g of dS
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int qt = t % n, h = (t / n) % H, b = t / n / H;
      const bool final_tile = t + (int)gridDim.x >= tiles;
      const int row0 = qt * WIDE + 16 * warp + (lane >> 2);
      const size_t stat = ((size_t)b * H + h) * T + row0;
      const float d0 = delta[stat], d1 = delta[stat + 8];
      float dqa[N1 / 2];
      zero(dqa);
      uint32_t gf[DP / 16][4];  // this warp's 16 rows of dO, A fragments
      mbar_wait(qg_full, it & 1);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) load_a_sw128(gf[kk], ga, WIDE, 16 * warp, kk, lane);
      if (lane == 0) mbar_arrive(qg_empty);
      for (int kt = 0; kt < n; ++kt) {
        const uint32_t ka = smem_u32(ring + stage * 2 * TB), va = ka + TB;
        const bool first = it == 0 && kt == 0, last = final_tile && kt == n - 1;
        float dp[WIDE / 2];
        mbar_wait(&full[stage], phase);
        fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)  // dP[m, n] = sum_d dO[m, d] V[n, d]
          WgmmaRS<WIDE, 0>::mma(dp, gf[kk], kmajor(va, WIDE, 0, kk), kk > 0);
        commit();
        wait<0>();
        fence_regs(dp);

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
        fence_regs(dqa);
        fence();
#pragma unroll
        for (int kk = 0; kk < WIDE / 16; ++kk)  // dQ[:, 128:] += dS K[:, 128:]
          WgmmaRS<N1, 1>::mma(dqa, dsa[kk], mnmajor(ka + 2 * WIDE * ROW, WIDE, kk), 1);
        commit();
        wait<0>();
        fence_regs(dqa);
        fence_regs(dsa);
        if (lane == 0) mbar_arrive(&empty[stage]);
        advance(stage, phase, stages);
      }
      const size_t base = (size_t)b * gb + (size_t)h * gh + (size_t)row0 * gt + 128;
      store_rows<N1>(dqa, scale, scale, dq + base, dq + base + 8 * gt, D - 128, lane);
    }
  }
}

// ----------------------------------------------------------------- delta ----

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) { load16(p, v); }
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  float a[4], b[4];
  load16(p, a);
  load16(p + 4, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = a[e];
    v[4 + e] = b[e];
  }
}

// delta[b, h, t] = sum_d d_out[b, t, h, d] * o[b, t, h, d] over the contiguous
// rows (b, t, h) of D elements: `lanes` neighbouring threads per row (a power
// of two with 8 lanes >= D, at most a warp's 32), 8 elements a thread at a
// time, reduced by shuffles.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_out,
                       float* __restrict__ delta, long long rows, int Tn, int H, int D,
                       int lanes) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / lanes;
  const int part = (int)(idx % lanes);
  float sum = 0.f;
  if (row < rows) {
    for (int c = 8 * part; c < D; c += 8 * lanes) {
      float a[8], g[8];
      load8(o + row * D + c, a);
      load8(d_out + row * D + c, g);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = fmaf(a[e], g[e], sum);
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && row < rows) {
    const long long bt = row / H;
    const int h = (int)(row - bt * H);
    const long long b = bt / Tn;
    const int t = (int)(bt - b * Tn);
    delta[(b * H + h) * Tn + t] = sum;
  }
}

template <typename T>
int launch_delta(const void* o, const void* d_out, float* delta, int B, int Tn, int H, int D,
                 cudaStream_t stream) {
  const long long rows = (long long)B * Tn * H;
  int lanes = 1;
  while (8 * lanes < D && lanes < 32) lanes <<= 1;
  const long long threads = rows * lanes;
  flash_delta_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_out), delta, rows, Tn, H, D, lanes);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ host ----

template <int DP>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int T,
             int H, int D, long long sb, long long st, long long sh, float scale,
             cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e;
  if ((e = tensor_map(&tq, q, B, T, H, D, sb, st, sh, FWD_Q)) ||
      (e = tensor_map(&tk, k, B, T, H, D, sb, st, sh, fwd_keys<DP>())) ||
      (e = tensor_map(&tv, v, B, T, H, D, sb, st, sh, fwd_keys<DP>())))
    return e;
  // two tiles held by the pipeline, the rest ahead; DP = 256 fits two stages
  constexpr int stages = DP == 64 ? 4 : DP == 256 ? 2 : 3;
  constexpr int smem = fwd_smem<DP>(stages);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * H * (T / FWD_Q);
  flash_fwd_wgmma_kernel<DP><<<grid_for(tiles), THREADS, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, T, H, D,
                                                   tiles, stages, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int bwd_bf16(const void* q, const void* k, const void* v, const void* d_out, const float* lse,
             const float* delta, void* dq, void* dk, void* dv, int B, int T, int H, int D,
             long long sb, long long st, long long sh, long long gb, long long gt, long long gh,
             float scale, cudaStream_t stream) {
  const long long ot = (long long)H * D, ob = (long long)T * ot;  // d_out: contiguous
  CUtensorMap q1, g1, k1, v1, q2, g2, k2, v2;
  int e;
  if ((e = tensor_map(&q1, q, B, T, H, D, sb, st, sh, DKV_Q)) ||
      (e = tensor_map(&g1, d_out, B, T, H, D, ob, ot, D, DKV_Q)) ||
      (e = tensor_map(&k1, k, B, T, H, D, sb, st, sh, DKV_K)) ||
      (e = tensor_map(&v1, v, B, T, H, D, sb, st, sh, DKV_K)) ||
      (e = tensor_map(&q2, q, B, T, H, D, sb, st, sh, DQ_Q)) ||
      (e = tensor_map(&g2, d_out, B, T, H, D, ob, ot, D, DQ_Q)) ||
      (e = tensor_map(&k2, k, B, T, H, D, sb, st, sh, DQ_K)) ||
      (e = tensor_map(&v2, v, B, T, H, D, sb, st, sh, DQ_K)))
    return e;
  constexpr int dkv_stages = DP == 64 ? 4 : 3, dq_stages = DP == 64 ? 4 : 3;
  constexpr int smem_dkv = dkv_smem<DP>(dkv_stages), smem_dq = dq_smem<DP>(dq_stages);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_dq_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  const int dkv_tiles = B * H * (T / DKV_K), dq_tiles = B * H * (T / DQ_Q);
  flash_dkv_wgmma_kernel<DP><<<grid_for(dkv_tiles), THREADS, smem_dkv, stream>>>(
      q1, k1, v1, g1, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, D, gb,
      gt, gh, dkv_tiles, dkv_stages, scale);
  flash_dq_wgmma_kernel<DP><<<grid_for(dq_tiles), THREADS, smem_dq, stream>>>(
      q2, k2, v2, g2, lse, delta, static_cast<bf16*>(dq), T, H, D, gb, gt, gh, dq_tiles,
      dq_stages, scale);
  return (int)cudaGetLastError();
}

// Above DP = 128: the *_wide kernels, every tile 64 rows, so both kernels
// share their tensor maps.
template <int DP>
int bwd_bf16_wide(const void* q, const void* k, const void* v, const void* d_out,
                  const float* lse, const float* delta, void* dq, void* dk, void* dv, int B, int T,
                  int H, int D, long long sb, long long st, long long sh, long long gb,
                  long long gt, long long gh, float scale, cudaStream_t stream) {
  const long long ot = (long long)H * D, ob = (long long)T * ot;  // d_out: contiguous
  CUtensorMap tq, tg, tk, tv;
  int e;
  if ((e = tensor_map(&tq, q, B, T, H, D, sb, st, sh, WIDE)) ||
      (e = tensor_map(&tg, d_out, B, T, H, D, ob, ot, D, WIDE)) ||
      (e = tensor_map(&tk, k, B, T, H, D, sb, st, sh, WIDE)) ||
      (e = tensor_map(&tv, v, B, T, H, D, sb, st, sh, WIDE)))
    return e;
  constexpr int stages = DP == 256 ? 2 : 3;
  constexpr int smem_dkv = dkv_wide_smem<DP>(stages), smem_dq = dq_wide_smem<DP>(stages);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_wide_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_dq_wide_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  const int tiles = B * H * (T / WIDE);
  flash_dkv_wide_kernel<DP><<<grid_for(tiles), THREADS, smem_dkv, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, D, gb, gt,
      gh, tiles, stages, scale);
  flash_dq_wide_kernel<DP><<<grid_for(tiles), THREADS, smem_dq, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<bf16*>(dq), T, H, D, gb, gt, gh, tiles, stages,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, T, H, D] in `dtype` with element strides (sb, st, sh) and a
// contiguous last axis; o: [B, T, H, D] contiguous; lse: [B, H, T] float32.
// dp: the width the kernels are compiled for, as ops/flash_attention.py
// kernel_head_dim gives it (bf16: 64, 128, 192 or 256, and above 256 D
// rounded up to 64, the streamed kernels of flash_attention_streamed.cu;
// fp32: D itself up to 128, and above 128 D rounded up to 64, the *_wide
// kernels of flash_attention_f32.cu).
// Requires T % 128 == 0, D % 8 == 0, 8 <= D <= dp, B, H <= 65535, 16-byte
// aligned rows. scale is the caller's (1/sqrt of the head width before any
// zero columns were added).
extern "C" int rfv_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int T, int H, int D, int dp, long long sb,
                                       long long st, long long sh, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (T % 128 || D % 8 || D < 8 || D > dp) return (int)cudaErrorInvalidValue;
  if (dtype == RFV_DTYPE_F32) {
    if (dp > 128)
      return rfv_flash::fwd_f32_wide(static_cast<const float*>(q), static_cast<const float*>(k),
                                     static_cast<const float*>(v), static_cast<float*>(o), l, B,
                                     T, H, D, sb, st, sh, scale, s);
    return rfv_flash::fwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), static_cast<float*>(o), l, B, T, H, D,
                              dp, sb, st, sh, scale, s);
  }
  if (dp == 64) return fwd_bf16<64>(q, k, v, o, l, B, T, H, D, sb, st, sh, scale, s);
  if (dp == 128) return fwd_bf16<128>(q, k, v, o, l, B, T, H, D, sb, st, sh, scale, s);
  if (dp == 192) return fwd_bf16<192>(q, k, v, o, l, B, T, H, D, sb, st, sh, scale, s);
  if (dp == 256) return fwd_bf16<256>(q, k, v, o, l, B, T, H, D, sb, st, sh, scale, s);
  if (dp > 256 && dp % 64 == 0)
    return rfv_flash::fwd_bf16_streamed(q, k, v, o, l, B, T, H, D, sb, st, sh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As above, plus d_out: [B, T, H, D] contiguous, delta: [B, H, T] float32
// scratch, and dq, dk, dv: [B, T, H, D] in `dtype` with element strides
// (gb, gt, gh) and a contiguous last axis. Three launches: delta, dkv, dq.
extern "C" int rfv_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* d_out, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int T,
                                       int H, int D, int dp, long long sb, long long st,
                                       long long sh, long long gb, long long gt, long long gh,
                                       float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (T % 128 || D % 8 || D < 8 || D > dp) return (int)cudaErrorInvalidValue;
  if (dtype == RFV_DTYPE_F32) {
    const int e = launch_delta<float>(o, d_out, dl, B, T, H, D, s);
    if (e) return e;
    if (dp > 128)
      return rfv_flash::bwd_f32_wide(static_cast<const float*>(q), static_cast<const float*>(k),
                                     static_cast<const float*>(v),
                                     static_cast<const float*>(d_out), l, dl,
                                     static_cast<float*>(dq), static_cast<float*>(dk),
                                     static_cast<float*>(dv), B, T, H, D, sb, st, sh, gb, gt, gh,
                                     scale, s);
    return rfv_flash::bwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), static_cast<const float*>(d_out), l,
                              dl, static_cast<float*>(dq), static_cast<float*>(dk),
                              static_cast<float*>(dv), B, T, H, D, dp, sb, st, sh, gb, gt, gh,
                              scale, s);
  }
  if (dp % 64 || dp <= 0) return (int)cudaErrorInvalidValue;
  const int e = launch_delta<bf16>(o, d_out, dl, B, T, H, D, s);
  if (e) return e;
  if (dp > 256)
    return rfv_flash::bwd_bf16_streamed(q, k, v, d_out, l, dl, dq, dk, dv, B, T, H, D, sb, st, sh,
                                        gb, gt, gh, scale, s);
  if (dp == 64)
    return bwd_bf16<64>(q, k, v, d_out, l, dl, dq, dk, dv, B, T, H, D, sb, st, sh, gb, gt, gh,
                        scale, s);
  if (dp == 128)
    return bwd_bf16<128>(q, k, v, d_out, l, dl, dq, dk, dv, B, T, H, D, sb, st, sh, gb, gt, gh,
                         scale, s);
  if (dp == 192)
    return bwd_bf16_wide<192>(q, k, v, d_out, l, dl, dq, dk, dv, B, T, H, D, sb, st, sh, gb, gt,
                              gh, scale, s);
  return bwd_bf16_wide<256>(q, k, v, d_out, l, dl, dq, dk, dv, B, T, H, D, sb, st, sh, gb, gt, gh,
                            scale, s);
}
