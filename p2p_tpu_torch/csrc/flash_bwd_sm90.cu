// K4 in bf16 at head dims 40 and 64, on Hopper's own instructions: the
// dk/dv and dq passes of the flash attention backward on wgmma, TMA and
// mbarriers, two warpgroups a block.
//
// Replaces, in bf16, the JAX library's flash backward that `jax.grad` runs
// through `flash_attention_tpu` (p2p_tpu/models/nn.py:308,
// `_flash_block_sizes`): the Pallas kernels `_flash_attention_bwd_dkv`
// (flash_attention.py:941, its `pallas_call` at :1121) and
// `_flash_attention_bwd_dq` (:1287, `pallas_call` at :1456). On the path:
// the bf16 null-text inversion's gradient sites, once each per site per
// inner iteration: SD-1.4's (1, 8, 4096, 40); SD-2.1's (1, 5, 9216, 64)
// and (1, 10, 2304, 64) at 768-v, (1, 5, 4096, 64) at 512-base.
//
// The function is that of kernels/flash_bwd.py's plain passes: with
// s = q k^T, lse2 = (m + log l) log2(e) from K3's f32 residuals and
// di = sum_c o do,
//   p = exp2(s scale log2(e) - lse2), rounded to bf16 for dv += p^T do;
//   ds = (dp - di) p scale, dp = do v^T, rounded to bf16 for dk += ds^T q
//   and dq += ds k;
// the sums in f32, rounded to bf16 once when stored. These rounding points
// do not depend on the tile, so the tiles here round where the plain passes
// do. Each output element is summed by one warpgroup in a fixed order, in
// the wgmma accumulator across tiles (the bf16 products' bar, 1e-2, is far
// above the accumulation's rounding toward zero); no atomics, so two
// launches give the same bits.
//
// Bound on an H100 SXM: seven S^2 d products a head (dkv four, dq three) at
// 989 TFLOP/s, 0.2199 + 0.1649 ms at (1, 5, 9216, 64), 0.0434 + 0.0326 ms
// at (1, 8, 4096, 40); the bytes take a hundredth of that. The design, from
// flash_fwd_sm90.cu's:
//
// - Head dim DH, 40 or 64, a template parameter; the shared tiles are 64
//   columns wide either way. At d = 40 the 40-column rows land in the
//   64-column box with zeros in columns 40..63 (TMA's out-of-bounds fill),
//   so the fragment layout, the swizzle, the pipeline and the shared memory
//   are d = 64's. The products that contract over d (the scores and dp)
//   run (DH + 15) / 16 k16 steps, 3 at d = 40, since the fourth 16-column
//   chunk is all zeros; the d-wide accumulators (dK, dV, dQ) stay 64
//   columns, whose columns past DH come out zero and are not stored.
// - Loads by TMA: one 3-D tensor map each for q, k, v and do, (DH, S, B*H),
//   128-byte swizzle, box (64, rows, 1); a tile never reads the next head's
//   rows, and rows past S arrive as zeros. Each block's own 128 rows (k and
//   v in dkv, q and do in dq) land once; the other two stream through a
//   ring of STAGES stages, 64 queries a tile in dkv, 128 keys in dq.
// - A block is two warpgroups (256 threads), each owning 64 of the block's
//   128 rows; the first warp also lands the tiles.
// - dkv, one block per (128-key tile, head): s^T = k q^T and dp^T = v do^T,
//   keys as rows, so p^T and ds^T are the A operands of dv += p^T do and
//   dk += ds^T q. dq, one block per (128-query tile, head): s = q k^T,
//   dp = do v^T, dq += ds k.
// - Products, all forms of wgmma with f32 accumulators: the scores and dp
//   with A the warpgroup's own rows in registers (read once from the
//   swizzled tile by ldmatrix, whose fragments are wgmma's) and B the
//   streamed tile, K-major (m64n64k16 in dkv, m64n128k16 in dq; A from
//   shared memory measured 13 % slower in dkv, 5 % in dq); dv, dk and dq
//   with A from registers, the packed scores (the accumulator layout is the
//   A-register layout of the next product) and B the streamed tile as
//   stored, the MN-major operand (m64n64k16), as flash_fwd_sm90.cu's P V.
// - Overlap: each warpgroup issues tile j's two score products and then
//   tile j-1's last product (dk or dq) before it waits for the scores, so
//   the exponentials of tile j run under the tensor cores; in dkv,
//   dv += p^T do of tile j runs while ds^T is formed.
// - Registers: dK and dV (dkv, 64 a thread) or dQ (32) live across the
//   loop, with the scores and dp (32 each in dkv, 64 in dq), their bf16
//   forms and the held rows' A fragments (32 at d = 64, 24 at 40): ptxas
//   gives dkv 218 and dq 250 at d = 64, no spills. It allocates a kernel
//   the registers its launch bound leaves a thread, whatever setmaxnreg adds at run time: 168 beside a
//   producer warp (nine warps, three on one SM sub-partition) or a
//   producer warpgroup, where dkv spilled and ptxas serialized its wgmma.
//   With no producer warps the bound leaves 255.
// - Landing: the loader warp lands the held tiles and the first STAGES - 2
//   streamed ones before the loop, and at the start of iteration j the tile
//   j + STAGES - 2, into the stage of tile j - 2, which both warpgroups
//   released during iteration j - 1; so a tile lands two iterations before
//   it is read, and the loader waits only for a warpgroup an iteration
//   behind.
// - Statistics: in dkv the loader warp turns each query tile's m, l and di
//   into lse2 and di (+inf and 0 past sq, so p = 0 there) in shared memory
//   beside the tile, from loads issued a tile before; in dq each thread
//   loads its two rows' once. Keys past sk get p = 0 in dq's last tile; in
//   dkv they are never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_bf16.cuh"  // bf16, pack_bf16, exp2_ftz, smem_u32
#include "sm90.cuh"       // mbarriers, TMA, wgmma, the tensor-map encoder

using namespace p2p;

namespace {

constexpr int BOX = 64;                 // columns of a shared row: 128 bytes
constexpr int BM = 64;                  // rows a warpgroup owns
constexpr int NC = 2;                   // warpgroups
constexpr int ROWS = BM * NC;           // rows a block owns
constexpr int BT_DKV = 64;              // queries of a streamed tile in dkv
constexpr int BT_DQ = 128;              // keys of a streamed tile in dq
constexpr int STAGES = 4;               // streamed tiles in flight
constexpr int NT = 128 * NC;
constexpr int ROW_BYTES = BOX * 2;
constexpr int HELD_BYTES = ROWS * ROW_BYTES;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BT_DKV == 64, "dkv's loader warp turns two rows a lane into statistics");
static_assert(STAGES >= 3, "a stage is refilled two iterations after it is read");

// Two held tiles, STAGES pairs of streamed tiles of BT rows (+ dkv's lse2
// and di rows), and slack to align the first tile to 1024 bytes.
template <int BT>
constexpr size_t smem_bytes(bool stats) {
  return 1024 + 2 * HELD_BYTES + 2 * STAGES * BT * ROW_BYTES +
         (stats ? 2 * STAGES * BT * sizeof(float) : 0);
}

// d (64 x N, f32) = [d +] A (64 x 16, bf16 in registers) B (16 x N), B
// K-major in shared memory (N = 64 or 128).
template <int N>
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[N / 2], const uint32_t* a, uint64_t db,
                                            int accumulate) {
  if constexpr (N == 64)
    wgmma_rs_n64_kb(d, a, db, accumulate);
  else
    wgmma_rs_n128_kb(d, a, db, accumulate);
}

// log2 of the softmax denominator, (m + log l) log2(e); +inf past the edge.
__device__ __forceinline__ float lse2_of(float m, float l, bool ok) {
  return ok ? m * LOG2E + log2f(l) : INFINITY;
}

// Rows row0 + 16 w + g + 8 h of out (h = 0, 1) = bf16(acc), the thread's
// share of the first DH columns of a 64 x 64 accumulator, into rows of DH;
// rows at or past rows_total skipped.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[32],
                                           int row0, int rows_total) {
  const int tw = threadIdx.x & 127, w = tw >> 5, g = (tw & 31) >> 2, t = tw & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * w + g + 8 * h;
    if (r >= rows_total) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)r * DH);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      orow[4 * n + t] = pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  }
}

template <int N>
__device__ __forceinline__ void pack(uint32_t (&out)[N / 2], const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) out[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// Shared memory of a pass: the held tiles h0 and h1 (ROWS rows each), then
// STAGES streamed tiles of TILE_BYTES each of s0 and s1.
template <int TILE_BYTES>
struct Smem {
  uint32_t h0, h1, s0, s1;
  __device__ Smem(unsigned char* raw) {
    h0 = (smem_u32(raw) + 1023u) & ~1023u;  // the swizzle's alignment
    h1 = h0 + HELD_BYTES;
    s0 = h1 + HELD_BYTES;
    s1 = s0 + STAGES * TILE_BYTES;
  }
  __device__ uint32_t end() const { return s1 + STAGES * TILE_BYTES; }
};

// bars: the held tiles landed, then per stage full and empty.
__device__ __forceinline__ void init_bars(uint64_t* bars, uint32_t full_count) {
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), full_count);
      mbar_init(smem_u32(&bars[1 + STAGES + s]), 4 * NC);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------------------------- dk/dv

// The k16 steps of a product that contracts over the head dim DH.
template <int DH>
__host__ __device__ constexpr int d_steps() {
  static_assert(DH % 8 == 0 && DH <= BOX, "a head row fits one 64-column box");
  return (DH + 15) / 16;
}

// grid (key tiles of ROWS, bh), NT threads. Warpgroup c owns keys
// k0 + 64 c + [0, 64).
template <int DH>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ m, const float* __restrict__ l,
                          const float* __restrict__ di, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int sq, int sk, float scale) {
  constexpr int BT = BT_DKV, SN = BT / 2, TILE_BYTES = BT * ROW_BYTES, KS = d_steps<DH>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const Smem<TILE_BYTES> sm(smem_raw);  // h0 = K, h1 = V; s0 = Q, s1 = dO
  float* lse_s = reinterpret_cast<float*>(smem_raw + (sm.end() - smem_u32(smem_raw)));
  float* di_s = lse_s + STAGES * BT;
  const uint32_t bar_held = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  const int bh = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int nq = (sq + BT - 1) / BT;
  const size_t head = (size_t)bh * sq;
  // The warpgroup, through a shuffle so the compiler knows it is
  // warp-uniform.
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tw = threadIdx.x & 127, lane = tw & 31, t = lane & 3;
  const bool loader = threadIdx.x < 32;

  // Full: the loader warp's 32 arrivals (its statistics written; lane 0's
  // also expects the two tiles' bytes).
  init_bars(bars, 32);

  // The loader warp: the raw statistics of the next tile to land, two rows
  // a lane, loaded a tile ahead; and the landing of tile j, once its stage
  // is free: lse2 and di from those rows, then Q and dO by TMA.
  float pm[2], pl[2], pd[2];
  auto fetch = [&](int j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = j * BT + lane + 32 * h;
      const bool ok = r < sq;
      pm[h] = ok ? m[head + r] : 0.f;
      pl[h] = ok ? l[head + r] : 1.f;
      pd[h] = ok ? di[head + r] : 0.f;
    }
  };
  auto land = [&](int j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);  // tile j - STAGES released
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      const bool ok = j * BT + i < sq;
      lse_s[s * BT + i] = lse2_of(pm[h], pl[h], ok);
      di_s[s * BT + i] = ok ? pd[h] : 0.f;
    }
    if (lane == 0) {
      mbar_expect_tx(full(s), 2 * TILE_BYTES);
      tma_load(sm.s0 + s * TILE_BYTES, &tm_q, full(s), j * BT, bh);
      tma_load(sm.s1 + s * TILE_BYTES, &tm_do, full(s), j * BT, bh);
    } else {
      mbar_arrive(full(s));
    }
    if (j + 1 < nq) fetch(j + 1);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(bar_held, 2 * HELD_BYTES);
      tma_load(sm.h0, &tm_k, bar_held, k0, bh);
      tma_load(sm.h1, &tm_v, bar_held, k0, bh);
    }
    fetch(0);
    for (int j = 0; j < STAGES - 2 && j < nq; ++j) land(j);
  }

  // Q and dO of stage s as the K-major B of the scores and the MN-major B
  // of dK and dV.
  auto q_k = [&](int s) { return desc_sw128(sm.s0 + s * TILE_BYTES, LBO_K_MAJOR); };
  auto do_k = [&](int s) { return desc_sw128(sm.s1 + s * TILE_BYTES, LBO_K_MAJOR); };
  auto q_mn = [&](int s) { return desc_sw128(sm.s0 + s * TILE_BYTES, LBO_MN_MAJOR); };
  auto do_mn = [&](int s) { return desc_sw128(sm.s1 + s * TILE_BYTES, LBO_MN_MAJOR); };

  uint32_t ka[4 * KS], va[4 * KS];  // the warpgroup's K and V rows: A of the scores
  float acc_dk[32], acc_dv[32];
  float st[SN];          // S^T of the tile, then P^T
  float dpt[SN];         // dP^T of the tile, then dS^T
  uint32_t pp[SN / 2];   // P^T in bf16: the A fragments of dV += P^T dO
  uint32_t pds[SN / 2];  // dS^T in bf16: the A fragments of dK += dS^T Q
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  // S^T = K Q^T and dP^T = V dO^T of the tile in stage s, KS k16 steps
  // each (32 bytes along the swizzled rows of the B tile), K and V from
  // registers, one commit group each.
  auto issue_scores = [&](int s) {
    const uint64_t bq = q_k(s), bo = do_k(s);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_rs_kb<BT>(st, ka + 4 * ks, bq + 2 * ks, ks);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_rs_kb<BT>(dpt, va + 4 * ks, bo + 2 * ks, ks);
    wgmma_commit();
  };
  // acc += A B over the BT rows of the tile B (k16 steps of 16 rows, 2048
  // bytes), A from registers.
  auto issue_rs = [&](float (&acc)[32], const uint32_t (&a)[SN / 2], uint64_t b) {
#pragma unroll
    for (int ks = 0; ks < BT / 16; ++ks) wgmma_rs_n64(acc, a + 4 * ks, b + 128 * ks);
    wgmma_commit();
  };

  mbar_wait(bar_held, 0);
  load_a_sw128<KS>(ka, sm.h0 + c * BM * ROW_BYTES);
  load_a_sw128<KS>(va, sm.h1 + c * BM * ROW_BYTES);
  for (int j = 0; j < nq; ++j) {
    const int s = j % STAGES, sp = (j + STAGES - 1) % STAGES;
    if (loader && j + STAGES - 2 < nq) land(j + STAGES - 2);
    mbar_wait(full(s), (j / STAGES) & 1);
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(acc_dk);
    fence_regs(pds);
    wgmma_fence();
    issue_scores(s);
    if (j > 0) {
      issue_rs(acc_dk, pds, q_mn(sp));  // dK += dS^T Q of tile j - 1
      wgmma_wait<2>();                  // S^T of tile j (and dV of j - 1) done
      fence_regs(acc_dv);
      fence_regs(pp);
    } else {
      wgmma_wait<1>();
    }
    fence_regs(st);
    // P^T = 2^(S^T scale log2(e) - lse2) of the tile's queries (columns).
    const float* lse = lse_s + s * BT;
#pragma unroll
    for (int i = 0; i < SN; i += 2) {
      const float2 e = *reinterpret_cast<const float2*>(lse + 8 * (i >> 2) + 2 * t);
      st[i] = exp2_ftz(fmaf(st[i], scale * LOG2E, -e.x));
      st[i + 1] = exp2_ftz(fmaf(st[i + 1], scale * LOG2E, -e.y));
    }
    wgmma_wait<0>();  // dP^T of tile j and dK of tile j - 1 done
    fence_regs(dpt);
    fence_regs(acc_dk);
    fence_regs(pds);
    if (j > 0 && lane == 0) mbar_arrive(empty(sp));  // Q, dO of tile j - 1 read
    pack<SN>(pp, st);
    wgmma_fence();
    issue_rs(acc_dv, pp, do_mn(s));  // dV += P^T dO, under the dS^T arithmetic
    // dS^T = (dP^T - di) P^T scale, rounded to bf16 by the packing.
    const float* dis = di_s + s * BT;
#pragma unroll
    for (int i = 0; i < SN; i += 2) {
      const float2 e = *reinterpret_cast<const float2*>(dis + 8 * (i >> 2) + 2 * t);
      dpt[i] = (dpt[i] - e.x) * st[i] * scale;
      dpt[i + 1] = (dpt[i + 1] - e.y) * st[i + 1] * scale;
    }
    pack<SN>(pds, dpt);
  }
  const int sl = (nq - 1) % STAGES;
  fence_regs(acc_dk);
  fence_regs(pds);
  wgmma_fence();
  issue_rs(acc_dk, pds, q_mn(sl));
  wgmma_wait<0>();
  fence_regs(acc_dk);
  fence_regs(acc_dv);
  fence_regs(pp);
  fence_regs(pds);
  const size_t out = (size_t)bh * sk * DH;
  store_rows<DH>(dk + out, acc_dk, k0 + c * BM, sk);
  store_rows<DH>(dv + out, acc_dv, k0 + c * BM, sk);
}

// ---------------------------------------------------------------------- dq

// grid (query tiles of ROWS, bh), NT threads. Warpgroup c owns queries
// q0 + 64 c + [0, 64).
template <int DH>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ di, bf16* __restrict__ dq, int sq, int sk,
                         float scale) {
  constexpr int BT = BT_DQ, SN = BT / 2, TILE_BYTES = BT * ROW_BYTES, KS = d_steps<DH>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const Smem<TILE_BYTES> sm(smem_raw);  // h0 = Q, h1 = dO; s0 = K, s1 = V
  const uint32_t bar_held = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nk = (sk + BT - 1) / BT;
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool loader = threadIdx.x == 0;

  init_bars(bars, 1);

  // The loader thread lands key tile j once its stage is free.
  auto land = [&](int j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
    mbar_expect_tx(full(s), 2 * TILE_BYTES);
    tma_load(sm.s0 + s * TILE_BYTES, &tm_k, full(s), j * BT, bh);
    tma_load(sm.s1 + s * TILE_BYTES, &tm_v, full(s), j * BT, bh);
  };
  if (loader) {
    mbar_expect_tx(bar_held, 2 * HELD_BYTES);
    tma_load(sm.h0, &tm_q, bar_held, q0, bh);
    tma_load(sm.h1, &tm_do, bar_held, q0, bh);
    for (int j = 0; j < STAGES - 2 && j < nk; ++j) land(j);
  }

  auto k_k = [&](int s) { return desc_sw128(sm.s0 + s * TILE_BYTES, LBO_K_MAJOR); };
  auto v_k = [&](int s) { return desc_sw128(sm.s1 + s * TILE_BYTES, LBO_K_MAJOR); };
  auto k_mn = [&](int s) { return desc_sw128(sm.s0 + s * TILE_BYTES, LBO_MN_MAJOR); };

  // The statistics of the thread's rows g and g + 8.
  float lse2[2], dis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + c * BM + 16 * w + g + 8 * h;
    const bool ok = r < sq;
    const size_t i = (size_t)bh * sq + (ok ? r : 0);
    lse2[h] = lse2_of(m[i], l[i], ok);
    dis[h] = ok ? di[i] : 0.f;
  }

  uint32_t qa[4 * KS], doa[4 * KS];
  float acc_dq[32];
  float sc[SN];          // S of the tile, then P
  float dp[SN];          // dP of the tile, then dS
  uint32_t pds[SN / 2];  // dS in bf16: the A fragments of dQ += dS K
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dq[i] = 0.f;

  auto issue_scores = [&](int s) {
    const uint64_t bk = k_k(s), bv = v_k(s);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_rs_kb<BT>(sc, qa + 4 * ks, bk + 2 * ks, ks);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_rs_kb<BT>(dp, doa + 4 * ks, bv + 2 * ks, ks);
    wgmma_commit();
  };
  auto issue_dq = [&](int s) {
    const uint64_t b = k_mn(s);
#pragma unroll
    for (int ks = 0; ks < BT / 16; ++ks) wgmma_rs_n64(acc_dq, pds + 4 * ks, b + 128 * ks);
    wgmma_commit();
  };
  // P = 2^(S scale log2(e) - lse2) of tile j; with a true mask (the last
  // tile, when sk is not a multiple of BT) 0 for keys at or past sk.
  auto probs = [&](auto mask, int j) {
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      sc[i] = exp2_ftz(fmaf(sc[i], scale * LOG2E, -lse2[(i >> 1) & 1]));
      if constexpr (decltype(mask)::value)
        if (j * BT + 8 * (i >> 2) + 2 * t + (i & 1) >= sk) sc[i] = 0.f;
    }
  };
  const bool ragged = sk % BT != 0;

  mbar_wait(bar_held, 0);
  load_a_sw128<KS>(qa, sm.h0 + c * BM * ROW_BYTES);
  load_a_sw128<KS>(doa, sm.h1 + c * BM * ROW_BYTES);
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES, sp = (j + STAGES - 1) % STAGES;
    if (loader && j + STAGES - 2 < nk) land(j + STAGES - 2);
    mbar_wait(full(s), (j / STAGES) & 1);
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc_dq);
    fence_regs(pds);
    wgmma_fence();
    issue_scores(s);
    if (j > 0) {
      issue_dq(sp);  // dQ += dS K of tile j - 1
      wgmma_wait<2>();
    } else {
      wgmma_wait<1>();
    }
    fence_regs(sc);
    if (ragged && j == nk - 1)
      probs(std::true_type(), j);
    else
      probs(std::false_type(), j);
    wgmma_wait<0>();  // dP of tile j and dQ of tile j - 1 done
    fence_regs(dp);
    fence_regs(acc_dq);
    fence_regs(pds);
    if (j > 0 && lane == 0) mbar_arrive(empty(sp));  // K, V of tile j - 1 read
    // dS = (dP - di) P scale, rounded to bf16 by the packing.
#pragma unroll
    for (int i = 0; i < SN; ++i) dp[i] = (dp[i] - dis[(i >> 1) & 1]) * sc[i] * scale;
    pack<SN>(pds, dp);
  }
  fence_regs(acc_dq);
  fence_regs(pds);
  wgmma_fence();
  issue_dq((nk - 1) % STAGES);
  wgmma_wait<0>();
  fence_regs(acc_dq);
  fence_regs(pds);
  store_rows<DH>(dq + (size_t)bh * sq * DH, acc_dq, q0 + c * BM, sq);
}

// The four tensor maps of a pass at head dim d (40 or 64), q and do with
// boxes of q_box rows, k and v of k_box rows: 0 on success, else a
// cudaError_t.
int encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                const void* dout, int bh, int sq, int sk, int d, int q_box, int k_box) {
  if ((d != 40 && d != 64) || bh < 1 || bh > 65535 || sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const bool ok = encode_rows(fn, &maps[0], q, d, sq, bh, q_box) &&
                  encode_rows(fn, &maps[1], k, d, sk, bh, k_box) &&
                  encode_rows(fn, &maps[2], v, d, sk, bh, k_box) &&
                  encode_rows(fn, &maps[3], dout, d, sq, bh, q_box);
  return ok ? 0 : cudaErrorInvalidValue;
}

// Launch `kern`, one of a pass's instantiations, on `grid` with `smem`
// bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kern, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The signature of the f32 entry p2p_flash_attn_bwd_dkv (flash_attn_bwd.cu)
// on bf16: q, dout (bh, sq, d), k, v, dk, dv (bh, sk, d) contiguous bf16 on
// 16-byte boundaries, d = 40 or 64; m, l, di (bh, sq) f32. Returns a
// cudaError_t (0 on success).
extern "C" int p2p_flash_attn_bwd_dkv_bf16_sm90(const void* q, const void* k, const void* v,
                                                const void* dout, const float* m,
                                                const float* l, const float* di, void* dk,
                                                void* dv, int bh, int sq, int sk, int d,
                                                float scale, void* stream) {
  CUtensorMap maps[4];
  if (int bad = encode_maps(maps, q, k, v, dout, bh, sq, sk, d, BT_DKV, ROWS)) return bad;
  const dim3 grid((sk + ROWS - 1) / ROWS, bh);
  return launch(d == 40 ? flash_bwd_dkv_sm90_kernel<40> : flash_bwd_dkv_sm90_kernel<64>, grid,
                smem_bytes<BT_DKV>(true), stream, maps[0], maps[1], maps[2], maps[3], m, l, di,
                static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, scale);
}

// The signature of p2p_flash_attn_bwd_dq on bf16: dq (bh, sq, d) bf16, the
// rest as above.
extern "C" int p2p_flash_attn_bwd_dq_bf16_sm90(const void* q, const void* k, const void* v,
                                               const void* dout, const float* m,
                                               const float* l, const float* di, void* dq,
                                               int bh, int sq, int sk, int d, float scale,
                                               void* stream) {
  CUtensorMap maps[4];
  if (int bad = encode_maps(maps, q, k, v, dout, bh, sq, sk, d, ROWS, BT_DQ)) return bad;
  const dim3 grid((sq + ROWS - 1) / ROWS, bh);
  return launch(d == 40 ? flash_bwd_dq_sm90_kernel<40> : flash_bwd_dq_sm90_kernel<64>, grid,
                smem_bytes<BT_DQ>(false), stream, maps[0], maps[1], maps[2], maps[3], m, l, di,
                static_cast<bf16*>(dq), sq, sk, scale);
}

extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
