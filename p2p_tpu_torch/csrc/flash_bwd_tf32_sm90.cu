// K4 in f32 at head dim 64 on Hopper's own instructions: the dk/dv and dq
// passes of the flash attention backward in 3xTF32 on wgmma, with the tiles
// landed by TMA on mbarriers, two warpgroups a block.
//
// Replaces, in f32 at d = 64, the JAX library's flash backward that
// `jax.grad` runs through `flash_attention_tpu` (p2p_tpu/models/nn.py:308,
// `_flash_block_sizes`): the Pallas kernels `_flash_attention_bwd_dkv`
// (flash_attention.py:941, its `pallas_call` at :1121) and
// `_flash_attention_bwd_dq` (:1287, `pallas_call` at :1456). On the path:
// the f32 null-text inversion's gradient sites at SD-2.1, once each per site
// per inner iteration: (1, 5, 9216, 64) and (1, 10, 2304, 64) at 768-v,
// (1, 5, 4096, 64) at 512-base. f32 at d = 40 stays in flash_attn_bwd.cu.
//
// The function is flash_attn_bwd.cu's: with s = q k^T, lse2 = (m + log l)
// log2(e) from K3's residuals and di = sum_c o do,
//   p = 2^(s scale log2(e) - lse2),  dv = p^T do,
//   ds = p (do v^T - di),  dk = scale ds^T q,  dq = scale ds k,
// every product in 3xTF32: each f32 operand split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna) and a product taken as lo hi + hi lo + hi hi,
// three wgmma in that order a k8 step into one f32 accumulator. Each
// tile's dv, dk or dq is summed in an accumulator of its own, opened with
// scale-d = 0, and added to the running sum in f32: the tensor cores'
// accumulation rounds toward zero, and one accumulator over a whole
// 4096-long sum was 2.3e-5 off. No atomics: each output element is summed by
// one thread in a fixed order, so two launches give the same bits.
// kernels/tf32.py (flash_bwd_dkv_tiles, flash_bwd_dq_tiles) emulates this
// arithmetic tile by tile.
//
// Bound on an H100 SXM: seven S^2 d products a head (dkv four, dq three) in
// 3xTF32 at 495 / 3 TFLOP/s: 1.3178 + 0.9883 ms at (1, 5, 9216, 64); the
// bytes take a hundredth of that. The design:
//
// - Loads by TMA: one 3-D tensor map each for q, k, v and do, (64, S, B*H),
//   box (32, rows, 1), 128-byte swizzle. A 128-byte swizzle row holds 32
//   f32, so a 64-column row lands as two 32-column tiles, loaded at columns
//   0 and 32; rows past S arrive as zeros, and a box never reads the next
//   head's rows.
// - A block is two warpgroups (256 threads), each owning 64 of the block's
//   128 held rows (k and v in dkv, q and do in dq); thread 0 also lands the
//   tiles. The held tiles land once and are split once in place into their
//   hi and lo parts. The hi parts become each warpgroup's register A
//   fragments (64 registers), in dq the lo parts too (64 more); in dkv,
//   which has no registers left, the lo parts stay in shared memory. The
//   64 KB where the hi parts landed then hold a second set of split
//   streamed tiles. The other two stream in 32-row tiles (queries in dkv,
//   keys in dq) through a ring of STAGES landing stages.
// - wgmma has no transposed form for tf32, so every operand in shared memory
//   is K-major. The score products (dkv: s^T = k q^T, dp^T = v do^T;
//   dq: s = q k^T, dp = do v^T) contract over the head dim, along which both
//   the held and the streamed tiles land: m64n32k8, B the split streamed
//   tile, A the held rows from registers (the hi parts there cut the
//   products' shared-memory reads from 9 to 5 KB a k8 step, dq's lo parts
//   to 3 KB) and, in dkv, the lo parts from shared memory. The products that contract over the
//   streamed rows (dkv: dv += p^T do, dk += ds^T q; dq: dq += ds k) take A
//   from registers, the accumulator of p^T, ds^T or ds split into hi and lo: a
//   tf32 register A fragment and the accumulator share one per-warp layout, so
//   a k8 step of the accumulator is an A fragment with k permuted inside its
//   group of 8 (column 2t as k = t, 2t + 1 as k = t + 4). Their B is a copy of
//   the streamed tile that the threads write transposed (64 rows of the head
//   dim, 32 columns) and k-permuted to match, in hi and lo, in the 128-byte
//   swizzle that its descriptor names (m64n64k8).
// - The split overlaps the products: tile j + 1 is split (hi, lo and the
//   transposed hi and lo, bank-conflict free, into the set tile j does not
//   read) by all 256 threads while their products of tile j run, q or k
//   under the score products and do or v under the first product over the
//   streamed rows (dv, dq); one barrier a tile then hands over both sets
//   and the landing stage (split between two barriers instead, the tensor
//   cores waited for it). Shared memory: dkv 230400 bytes, dq 214016.
// - Statistics: in dkv warp 0 turns each query tile's m, l and di into lse2
//   and di (+inf and 0 past sq, so p = 0 there) in shared memory beside the
//   tile's set, from loads issued a tile before; in dq each thread loads
//   its two rows' once. Keys past sk get p = 0 in dq; in dkv they are never
//   stored.
// - Registers: dK and dV (64 a thread) or dQ (32) across the loop, the held
//   rows' fragments (64, dq 128), the scores and dp (32), their hi and lo A
//   fragments (64 in dkv, 32 in dq), one tile accumulator (32): dkv issues
//   its dV and then its dK product into it (both at once spilled). No
//   producer warps, so the launch bound leaves 255.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // split_tf32, split_tile, exp2_ftz, HI and LO
#include "sm90.cuh"      // mbarriers, TMA, wgmma, the tensor-map encoder

using namespace p2p;

namespace {

constexpr int D = 64;                         // head dim
constexpr int KS = D / 8;                     // k8 steps over the head dim
constexpr int HALF = 32;                      // f32 columns of a 128-byte swizzle row
constexpr int BM = 64;                        // held rows a warpgroup owns
constexpr int NC = 2;                         // warpgroups
constexpr int ROWS = BM * NC;                 // held rows a block owns
constexpr int BT = 32;                        // rows of a streamed tile
constexpr int STAGES = 2;                     // streamed tiles landing ahead of their split
constexpr int NT = 128 * NC;
constexpr int ROW_BYTES = HALF * 4;           // 128
constexpr int HELD_HALF = ROWS * ROW_BYTES;   // one 32-column half of a held tile
constexpr int HELD_BYTES = 2 * HELD_HALF;
constexpr int TILE_HALF = BT * ROW_BYTES;
constexpr int TILE_BYTES = 2 * TILE_HALF;     // a streamed tile, or its 64 x 32 transposed copy
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NT / 32 == D / 8 && BT == 32,
              "split_transpose: a warp for 8 head-dim columns, 4 tile columns a lane a step");

// A set of split streamed tiles: the hi and lo parts of tiles 0 and 1, and
// `ntr` transposed copies (hi and lo).
constexpr int set_bytes(int ntr) { return (4 + 2 * ntr) * TILE_BYTES; }
static_assert(set_bytes(2) <= 2 * HELD_BYTES, "set 1 lies where the held hi parts landed");

// Dynamic shared memory of a pass whose streamed tiles have `ntr`
// transposed copies, with slack to align the first tile to 1024 bytes.
constexpr size_t smem_bytes(int ntr) {
  return 1024 + 4 * HELD_BYTES + 2 * STAGES * TILE_BYTES + set_bytes(ntr);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory of a pass, from a 1024-aligned base: the lo parts of the
// held tiles 0 and 1; a region where the held tiles land and are split in
// place into their hi parts, which become register fragments, and which
// then holds set 1 of the split streamed tiles; STAGES stages of the
// streamed tiles 0 and 1 as landed; set 0. Held and streamed tiles are two
// 32-column halves each.
struct Smem {
  unsigned char* raw;
  uint32_t base;
  __device__ explicit Smem(unsigned char* r) : raw(r), base((smem_u32(r) + 1023u) & ~1023u) {}
  __device__ uint32_t held_lo(int i) const { return base + i * HELD_BYTES; }
  __device__ uint32_t held_hi(int i) const { return base + (2 + i) * HELD_BYTES; }
  __device__ uint32_t ring(int s, int i) const {
    return base + 4 * HELD_BYTES + (2 * s + i) * TILE_BYTES;
  }
  __device__ uint32_t set(int b) const {
    return b ? held_hi(0) : base + 4 * HELD_BYTES + 2 * STAGES * TILE_BYTES;
  }
  __device__ uint32_t hi(int b, int i) const { return set(b) + i * TILE_BYTES; }
  __device__ uint32_t lo(int b, int i) const { return set(b) + (2 + i) * TILE_BYTES; }
  __device__ uint32_t tr(int b, int i, int part) const {
    return set(b) + (4 + 2 * i + part) * TILE_BYTES;
  }
  // The generic pointer of shared address a.
  __device__ unsigned char* at(uint32_t a) const { return raw + (a - smem_u32(raw)); }
};

// bars: the held tiles landed, then each stage full.
__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Thread 0: the held rows [row0, row0 + ROWS) of maps a and b into held
// tiles 0 and 1, on bar.
__device__ __forceinline__ void land_held(const Smem& sm, uint32_t bar, const CUtensorMap* a,
                                          const CUtensorMap* b, int row0, int bh) {
  mbar_expect_tx(bar, 2 * HELD_BYTES);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tma_load_col(sm.held_hi(0) + h * HELD_HALF, a, bar, h * HALF, row0, bh);
    tma_load_col(sm.held_hi(1) + h * HELD_HALF, b, bar, h * HALF, row0, bh);
  }
}

// Thread 0: streamed tile j of maps a and b into stage j % STAGES, on bar.
__device__ __forceinline__ void land_tile(const Smem& sm, uint32_t bar, const CUtensorMap* a,
                                          const CUtensorMap* b, int j, int bh) {
  const int s = j % STAGES;
  mbar_expect_tx(bar, 2 * TILE_BYTES);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tma_load_col(sm.ring(s, 0) + h * TILE_HALF, a, bar, h * HALF, j * BT, bh);
    tma_load_col(sm.ring(s, 1) + h * TILE_HALF, b, bar, h * HALF, j * BT, bh);
  }
}

// The hi A fragments of warpgroup c's 64 rows of a held tile split in
// place at x, its KS k8 steps: a[4 ks + e] is row 16 w + g + 8 (e % 2),
// column 8 ks + t + 4 (e / 2).
__device__ __forceinline__ void load_a_held(uint32_t (&a)[4 * KS], const unsigned char* x,
                                            int c) {
  const int tw = threadIdx.x & 127, w = tw >> 5, g = (tw & 31) >> 2, t = tw & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = c * BM + 16 * w + g + 8 * (e & 1), cn = 8 * (ks & 3) + t + 4 * (e >> 1);
      a[4 * ks + e] = *reinterpret_cast<const uint32_t*>(
          x + (ks >> 2) * HELD_HALF + r * ROW_BYTES +
          ((((cn >> 2) ^ (r & 7)) << 4) | ((cn & 3) << 2)));
    }
}

// Once both held tiles have landed on bar: split them in place into their
// hi parts, the lo parts to the held lo tiles, by all threads, and load
// warpgroup c's hi A fragments of held tiles 0 and 1 into a0 and a1; the
// region of the hi parts is then free.
__device__ __forceinline__ void split_held(const Smem& sm, uint32_t bar, uint32_t (&a0)[4 * KS],
                                           uint32_t (&a1)[4 * KS], int c) {
  mbar_wait(bar, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    split_tile<2 * ROWS, HALF, HALF, NT>(reinterpret_cast<float*>(sm.at(sm.held_hi(i))),
                                         reinterpret_cast<float*>(sm.at(sm.held_lo(i))));
  fence_proxy_async();
  __syncthreads();
  load_a_held(a0, sm.at(sm.held_hi(0)), c);
  load_a_held(a1, sm.at(sm.held_hi(1)), c);
  __syncthreads();
}

// Split the landed BT x 64 tile x (two 32-column halves in the 128-byte
// swizzle: chunk ch of row r at r * 128 + (ch ^ r % 8) * 16) into its hi
// and lo parts at the same offsets from hi and lo, and write both into the
// 64 x BT tiles thi and tlo, transposed and k-permuted: row n, column
// 8j + kk of the copy holds x's row 8j + 2kk (kk < 4) or 8j + 2kk - 7
// (kk >= 4), column n; the B of a product whose A is an accumulator (column
// 2t as k = t, 2t + 1 as k = t + 4). Warp w takes the copy's rows
// 8w + lane % 8 at columns 4a + lane / 8: the 32 lanes hit 32 banks in x
// and in the copy.
__device__ __forceinline__ void split_transpose(const unsigned char* x, unsigned char* hi,
                                                unsigned char* lo, unsigned char* thi,
                                                unsigned char* tlo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = 8 * warp + (lane & 7);  // x's column, the copy's row
  const int half = n / HALF, cn = n % HALF;
#pragma unroll
  for (int a = 0; a < BT / 4; ++a) {
    const int col = 4 * a + (lane >> 3);
    const int kk = col & 7;
    const int r = (col & ~7) + (kk < 4 ? 2 * kk : 2 * kk - 7);
    const int src =
        half * TILE_HALF + r * ROW_BYTES + ((((cn >> 2) ^ (r & 7)) << 4) | ((cn & 3) << 2));
    const int dst = n * ROW_BYTES + (((a ^ (n & 7)) << 4) | ((col & 3) << 2));
    uint32_t h, l;
    split_tf32(*reinterpret_cast<const float*>(x + src), h, l);
    *reinterpret_cast<uint32_t*>(hi + src) = h;
    *reinterpret_cast<uint32_t*>(lo + src) = l;
    *reinterpret_cast<uint32_t*>(thi + dst) = h;
    *reinterpret_cast<uint32_t*>(tlo + dst) = l;
  }
}

// Split the landed tile x into its hi and lo parts at the same offsets from
// hi and lo, four values a thread at a time.
__device__ __forceinline__ void split_flat(const unsigned char* x, unsigned char* hi,
                                           unsigned char* lo) {
  for (int i = threadIdx.x; i < TILE_BYTES / 16; i += NT) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// acc (64 x BT) = A B^T over the head dim in 3xTF32: A warpgroup c's 64
// rows of a held tile, its hi parts as register fragments ahi and its lo
// parts as register fragments alo or, where alo is null, at a_lo in shared
// memory; B a split streamed tile (hi at b_hi, lo at b_lo). A k8 step is
// 32 bytes along a swizzle row, the second four in the second 32-column
// half.
__device__ __forceinline__ void issue_scores(float (&acc)[BT / 2], const uint32_t (&ahi)[4 * KS],
                                             const uint32_t* alo, uint32_t a_lo, uint32_t b_hi,
                                             uint32_t b_lo, int c) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t bo = (ks >> 2) * TILE_HALF + (ks & 3) * 32;
    const uint64_t bh = desc_sw128(b_hi + bo, LBO_K_MAJOR), bl = desc_sw128(b_lo + bo, LBO_K_MAJOR);
    if (alo != nullptr) {
      wgmma_rs_tf32_n32(acc, alo + 4 * ks, bh, ks);
    } else {
      const uint32_t ao = (ks >> 2) * HELD_HALF + c * BM * ROW_BYTES + (ks & 3) * 32;
      wgmma_ss_tf32_n32(acc, desc_sw128(a_lo + ao, LBO_K_MAJOR), bh, ks);
    }
    wgmma_rs_tf32_n32(acc, ahi + 4 * ks, bl, 1);
    wgmma_rs_tf32_n32(acc, ahi + 4 * ks, bh, 1);
  }
}

// The hi and lo A fragments of the BT / 8 k8 steps of x, the thread's share
// of a 64 x BT accumulator: elements 4j + 1 and 4j + 2 trade places, so
// (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) of step j are a0..a3.
__device__ __forceinline__ void a_frags(uint32_t (&hi)[BT / 2], uint32_t (&lo)[BT / 2], int i,
                                        float x) {
  const int e = (i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1);
  split_tf32(x, hi[e], lo[e]);
}

// out += C B over the BT streamed rows in 3xTF32, summed in tile (opened
// with scale-d = 0) and then added to out in f32: C the A fragments (hi,
// lo) of an accumulator, B a transposed copy (hi at b_hi, lo at b_lo), 32
// bytes a k8 step; `meanwhile` runs while the tensor cores take the
// product.
template <typename F>
__device__ __forceinline__ void product_cb(float (&out)[32], float (&tile)[32],
                                           uint32_t (&ch)[BT / 2], uint32_t (&cl)[BT / 2],
                                           uint32_t b_hi, uint32_t b_lo, F&& meanwhile) {
  fence_regs(tile);
  wgmma_fence();
#pragma unroll
  for (int kj = 0; kj < BT / 8; ++kj) {
    const uint64_t bh = desc_sw128(b_hi + kj * 32, LBO_K_MAJOR);
    const uint64_t bl = desc_sw128(b_lo + kj * 32, LBO_K_MAJOR);
    wgmma_rs_tf32_n64(tile, cl + 4 * kj, bh, kj);
    wgmma_rs_tf32_n64(tile, ch + 4 * kj, bl, 1);
    wgmma_rs_tf32_n64(tile, ch + 4 * kj, bh, 1);
  }
  wgmma_commit();
  meanwhile();
  wgmma_wait<0>();
  fence_regs(tile);
  fence_regs(ch);
  fence_regs(cl);
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] += tile[i];
}

// log2 of the softmax denominator, (m + log l) log2(e); +inf past the edge.
__device__ __forceinline__ float lse2_of(float m, float l, bool ok) {
  return ok ? m * LOG2E + log2f(l) : INFINITY;
}

// Rows row0 + 16 w + g + 8 h of out (h = 0, 1) = scale acc, the thread's
// share of a 64 x 64 accumulator; rows at or past rows_total skipped.
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float (&acc)[32],
                                           float scale, int row0, int rows_total) {
  const int tw = threadIdx.x & 127, w = tw >> 5, g = (tw & 31) >> 2, t = tw & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * w + g + 8 * h;
    if (r >= rows_total) continue;
    float* orow = out + (size_t)r * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
  }
}

// ------------------------------------------------------------------- dk/dv

// grid (key tiles of ROWS, bh), NT threads. Warpgroup c owns keys
// k0 + 64 c + [0, 64).
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ m, const float* __restrict__ l,
                               const float* __restrict__ di, float* __restrict__ dk,
                               float* __restrict__ dv, int sq, int sk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  __shared__ float lse_s[2][BT], di_s[2][BT];  // by set
  const Smem sm(smem_raw);  // held 0 = K, 1 = V; streamed 0 = Q, 1 = dO
  const uint32_t bar_held = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  const int bh = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int nq = (sq + BT - 1) / BT;
  const size_t head = (size_t)bh * sq;
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const float scale2 = scale * LOG2E;

  init_bars(bars);
  if (threadIdx.x == 0) {
    land_held(sm, bar_held, &tm_k, &tm_v, k0, bh);
    for (int j = 0; j < STAGES && j < nq; ++j)
      land_tile(sm, full(j % STAGES), &tm_q, &tm_do, j, bh);
  }
  // Warp 0: the raw statistics of query `lane` of the next tile to split,
  // loaded a tile ahead.
  float raw_m = 0.f, raw_l = 1.f, raw_di = 0.f;
  auto fetch = [&](int j) {
    const int r = j * BT + lane;
    const bool ok = r < sq;
    raw_m = ok ? m[head + r] : 0.f;
    raw_l = ok ? l[head + r] : 1.f;
    raw_di = ok ? di[head + r] : 0.f;
  };
  if (warp == 0) fetch(0);
  uint32_t ka[4 * KS], va[4 * KS];  // the warpgroup's K and V rows, hi: A of the scores
  split_held(sm, bar_held, ka, va, c);

  // Tile j, once landed, into set j % 2: streamed tile i (Q, dO) split
  // with its transposed copy; with Q, (warp 0) lse2 and di of its queries.
  auto split_next = [&](int j, int i) {
    const int b = j & 1, s = j % STAGES;
    if (i == 0) mbar_wait(full(s), (j / STAGES) & 1);
    split_transpose(sm.at(sm.ring(s, i)), sm.at(sm.hi(b, i)), sm.at(sm.lo(b, i)),
                    sm.at(sm.tr(b, i, HI)), sm.at(sm.tr(b, i, LO)));
    if (i == 0 && warp == 0) {
      const bool ok = j * BT + lane < sq;
      lse_s[b][lane] = lse2_of(raw_m, raw_l, ok);
      di_s[b][lane] = ok ? raw_di : 0.f;
      if (j + 1 < nq) fetch(j + 1);
    }
    fence_proxy_async();
  };
  split_next(0, 0);
  split_next(0, 1);

  float acc_dk[32], acc_dv[32];
  float st[BT / 2];                      // S^T of the tile, keys as rows
  float dpt[BT / 2];                     // dP^T of the tile
  uint32_t ph[BT / 2], pl[BT / 2];       // P^T split: the A fragments of dV += P^T dO
  uint32_t dh[BT / 2], dl[BT / 2];       // dS^T split: the A fragments of dK += dS^T Q
  float tile[32];                        // the tile's dV, then its dK
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int j = 0; j < nq; ++j) {
    const int b = j & 1;
    // Tile j is split, every product of tile j - 1 is done: set b ^ 1 and
    // tile j's stage are free.
    __syncthreads();
    if (threadIdx.x == 0 && j + STAGES < nq)
      land_tile(sm, full(j % STAGES), &tm_q, &tm_do, j + STAGES, bh);

    // S^T = K Q^T and dP^T = V dO^T, while Q of tile j + 1 is split.
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    issue_scores(st, ka, nullptr, sm.held_lo(0), sm.hi(b, 0), sm.lo(b, 0), c);
    issue_scores(dpt, va, nullptr, sm.held_lo(1), sm.hi(b, 1), sm.lo(b, 1), c);
    wgmma_commit();
    if (j + 1 < nq) split_next(j + 1, 0);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // P^T = 2^(S^T scale log2(e) - lse2) and dS^T = P^T (dP^T - di), the
    // tile's queries as columns, split into A fragments.
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int q = 8 * (i >> 2) + 2 * t + (i & 1);
      const float p = exp2_ftz(fmaf(st[i], scale2, -lse_s[b][q]));
      a_frags(ph, pl, i, p);
      a_frags(dh, dl, i, p * (dpt[i] - di_s[b][q]));
    }
    // One tile accumulator for both (registers): dV = P^T dO while dO of
    // tile j + 1 is split, then dK = dS^T Q.
    product_cb(acc_dv, tile, ph, pl, sm.tr(b, 1, HI), sm.tr(b, 1, LO), [&] {
      if (j + 1 < nq) split_next(j + 1, 1);
    });
    product_cb(acc_dk, tile, dh, dl, sm.tr(b, 0, HI), sm.tr(b, 0, LO), [] {});
  }
  const size_t out = (size_t)bh * sk * D;
  store_rows(dk + out, acc_dk, scale, k0 + c * BM, sk);
  store_rows(dv + out, acc_dv, 1.f, k0 + c * BM, sk);
}

// ---------------------------------------------------------------------- dq

// grid (query tiles of ROWS, bh), NT threads. Warpgroup c owns queries
// q0 + 64 c + [0, 64).
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ m, const float* __restrict__ l,
                              const float* __restrict__ di, float* __restrict__ dq, int sq,
                              int sk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  const Smem sm(smem_raw);  // held 0 = Q, 1 = dO; streamed 0 = K, 1 = V
  const uint32_t bar_held = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nk = (sk + BT - 1) / BT;
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = scale * LOG2E;

  init_bars(bars);
  if (threadIdx.x == 0) {
    land_held(sm, bar_held, &tm_q, &tm_do, q0, bh);
    for (int j = 0; j < STAGES && j < nk; ++j)
      land_tile(sm, full(j % STAGES), &tm_k, &tm_v, j, bh);
  }
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
  // The warpgroup's Q and dO rows, hi and lo: the A fragments of the scores.
  uint32_t qa[4 * KS], doa[4 * KS], qla[4 * KS], dola[4 * KS];
  split_held(sm, bar_held, qa, doa, c);
  load_a_held(qla, sm.at(sm.held_lo(0)), c);
  load_a_held(dola, sm.at(sm.held_lo(1)), c);

  // Tile j, once landed, into set j % 2: K (i = 0) split with its
  // transposed copy, V (i = 1) split.
  auto split_next = [&](int j, int i) {
    const int b = j & 1, s = j % STAGES;
    if (i == 0) {
      mbar_wait(full(s), (j / STAGES) & 1);
      split_transpose(sm.at(sm.ring(s, 0)), sm.at(sm.hi(b, 0)), sm.at(sm.lo(b, 0)),
                      sm.at(sm.tr(b, 0, HI)), sm.at(sm.tr(b, 0, LO)));
    } else {
      split_flat(sm.at(sm.ring(s, 1)), sm.at(sm.hi(b, 1)), sm.at(sm.lo(b, 1)));
    }
    fence_proxy_async();
  };
  split_next(0, 0);
  split_next(0, 1);

  float acc_dq[32];
  float sc[BT / 2];                  // S of the tile
  float dp[BT / 2];                  // dP of the tile
  uint32_t dh[BT / 2], dl[BT / 2];   // dS split: the A fragments of dQ += dS K
  float tile[32];                    // the tile's dQ
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dq[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int b = j & 1;
    // Tile j is split, every product of tile j - 1 is done: set b ^ 1 and
    // tile j's stage are free.
    __syncthreads();
    if (threadIdx.x == 0 && j + STAGES < nk)
      land_tile(sm, full(j % STAGES), &tm_k, &tm_v, j + STAGES, bh);

    // S = Q K^T and dP = dO V^T, while K of tile j + 1 is split.
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    issue_scores(sc, qa, qla, sm.held_lo(0), sm.hi(b, 0), sm.lo(b, 0), c);
    issue_scores(dp, doa, dola, sm.held_lo(1), sm.hi(b, 1), sm.lo(b, 1), c);
    wgmma_commit();
    if (j + 1 < nk) split_next(j + 1, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // P = 2^(S scale log2(e) - lse2), 0 for keys at or past sk, and
    // dS = P (dP - di), split into A fragments.
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int key = j * BT + 8 * (i >> 2) + 2 * t + (i & 1);
      const float p = key < sk ? exp2_ftz(fmaf(sc[i], scale2, -lse2[h])) : 0.f;
      a_frags(dh, dl, i, p * (dp[i] - dis[h]));
    }
    // dQ = dS K, while V of tile j + 1 is split.
    product_cb(acc_dq, tile, dh, dl, sm.tr(b, 0, HI), sm.tr(b, 0, LO), [&] {
      if (j + 1 < nk) split_next(j + 1, 1);
    });
  }
  store_rows(dq + (size_t)bh * sq * D, acc_dq, scale, q0 + c * BM, sq);
}

// The four tensor maps of a pass, q and do with boxes of q_box rows, k and
// v of k_box rows: 0 on success, else a cudaError_t.
int encode_maps(CUtensorMap (&maps)[4], const float* q, const float* k, const float* v,
                const float* dout, int bh, int sq, int sk, int d, int q_box, int k_box) {
  if (d != D || bh < 1 || bh > 65535 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const bool ok = encode_rows_f32(fn, &maps[0], q, d, sq, bh, q_box) &&
                  encode_rows_f32(fn, &maps[1], k, d, sk, bh, k_box) &&
                  encode_rows_f32(fn, &maps[2], v, d, sk, bh, k_box) &&
                  encode_rows_f32(fn, &maps[3], dout, d, sq, bh, q_box);
  return ok ? 0 : cudaErrorInvalidValue;
}

// Launch `kern` on `grid` with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kern, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The signature of p2p_flash_attn_bwd_dkv (flash_attn_bwd.cu): q, dout
// (bh, sq, d), k, v, dk, dv (bh, sk, d) contiguous f32 on 16-byte
// boundaries, d = 64; m, l, di (bh, sq) f32. Returns a cudaError_t (0 on
// success).
extern "C" int p2p_flash_attn_bwd_dkv_f32_sm90(const float* q, const float* k, const float* v,
                                               const float* dout, const float* m,
                                               const float* l, const float* di, float* dk,
                                               float* dv, int bh, int sq, int sk, int d,
                                               float scale, void* stream) {
  CUtensorMap maps[4];
  if (int bad = encode_maps(maps, q, k, v, dout, bh, sq, sk, d, BT, ROWS)) return bad;
  return launch(flash_bwd_dkv_tf32_sm90_kernel, dim3((sk + ROWS - 1) / ROWS, bh),
                smem_bytes(2), stream, maps[0], maps[1], maps[2], maps[3], m, l, di, dk, dv,
                sq, sk, scale);
}

// The signature of p2p_flash_attn_bwd_dq: dq (bh, sq, d) f32, the rest as
// above.
extern "C" int p2p_flash_attn_bwd_dq_f32_sm90(const float* q, const float* k, const float* v,
                                              const float* dout, const float* m,
                                              const float* l, const float* di, float* dq,
                                              int bh, int sq, int sk, int d, float scale,
                                              void* stream) {
  CUtensorMap maps[4];
  if (int bad = encode_maps(maps, q, k, v, dout, bh, sq, sk, d, ROWS, BT)) return bad;
  return launch(flash_bwd_dq_tf32_sm90_kernel, dim3((sq + ROWS - 1) / ROWS, bh),
                smem_bytes(1), stream, maps[0], maps[1], maps[2], maps[3], m, l, di, dq, sq,
                sk, scale);
}

extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
