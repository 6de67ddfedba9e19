// K1 and K3 in f32 at head dim 64 on Hopper's own instructions: the flash
// attention forward in 3xTF32 on tf32 wgmma, with the tiles landed by TMA on
// mbarriers, two warpgroups a block.
//
// Replaces, in f32 at d = 64, the JAX package's `flash_attention_tpu`
// (p2p_tpu/models/nn.py:330, K1) and `flash_attention_residuals`
// (p2p_tpu/models/nn.py:343, K3): the library Pallas TPU flash kernel
// (`flash_attention.py:758`, its `pallas_call`), with save_residuals for K3.
// On the paths: K1 at SD-2.1's self sites, (4, 5, 9216, 64) and (4, 10,
// 2304, 64) at 768-v, (4, 5, 4096, 64) at 512-base, and at batch 1 in the
// f32 inversions' forwards without gradient; K3 (m and l non-null) at the
// f32 inversions' gradient sites, (1, 5, 9216, 64), (1, 10, 2304, 64) and
// (1, 5, 4096, 64). f32 at d = 40, 80, 160 and 512 stays in flash_attn.cu.
//
// The function: o = softmax(q k^T scale) v in f32, non-causal, unmasked;
// with m and l, also each row's max m (natural units) and sum l = sum_j
// exp(s_j - m). The arithmetic is flash_attn.cu's f32 forward at 64-key
// steps (kernels/tf32.py:flash_d40 emulates it step by step): q scaled by
// scale log2(e) in f32; per tile of 64 keys the scores s in 3xTF32 (each
// f32 operand split into hi = tf32(x) and lo = tf32(x - hi) by cvt.rna, a
// product taken as lo hi + hi lo + hi hi, three wgmma in that order a k8
// step), keys past sk at -inf; the running max m2 = max(m2, max s) and
// p = 2^(s - m2) (ex2.approx.ftz), the running sum and output rescaled by
// 2^(m2_old - m2); the tile's p v in 3xTF32 in an accumulator of its own,
// opened with scale-d = 0, added to the output in f32 as o c + tile (the
// tensor cores' accumulation rounds toward zero: one accumulator over a
// 4096-long sum was 2.3e-5 off); the output divided by l once, m written as
// m2 ln 2. No atomics: each output element is summed by one thread in a
// fixed order, so two launches give the same bits.
//
// Bound on an H100 SXM: 4 S^2 d flops a head in 3xTF32 at 495 / 3 TFLOP/s,
// 2.6355 ms at (4, 5, 9216, 64); the bytes take a hundredth of that. The
// design, that of the f32 K4 passes (flash_bwd_tf32_sm90.cu) turned to
// the forward:
//
// - Two kernels a call. flash_split_kv_tf32_kernel first splits K and V
//   once into f32 scratch in global memory (the wrapper's `part`): K's hi
//   and lo parts as K is laid out, and V's transposed and k-permuted
//   (below), in hi and lo, its keys padded with zeros to a whole number of
//   64-key tiles. Every block of the forward then lands split tiles: the
//   first version, which split each tile in every block, took 1.3-1.5x as
//   long at the path shapes, split pass included (tools/k1_compare.py
//   against it, H100 80GB HBM3 at 700 W).
// - Loads by TMA: one 3-D tensor map each for q (64, S, B*H), the split K
//   (64, Sk, 2 B*H) and the split V^T (Sk padded, 64, 2 B*H), box (32, rows,
//   1), 128-byte swizzle (sm90.cuh:encode_rows_f32): a 128-byte swizzle row
//   holds 32 f32, so a 64-column row lands as two 32-column halves. Rows
//   past S arrive as zeros (keys past sk are masked, query rows past sq are
//   not stored), and a box never reads the next plane's rows. Q lands once;
//   each 64-key tile (K hi, K lo, V^T hi, V^T lo: 64 KB) streams through a
//   ring of three stages, thread 0 issuing every load.
// - A block is two warpgroups (256 threads), each owning 64 of the block's
//   128 query rows, with no producer warps (a ninth warp caps ptxas at 168
//   registers a thread; here the launch bound leaves 255).
// - Q, scaled and split once, lives in registers as the A fragments of the
//   scores: hi and lo, 64 registers a thread.
// - S = Q K^T: m64n64k8 over the head dim, 8 k8 steps of three products, B
//   the K tile's hi and lo parts (K-major as K lies).
// - O += P V: m64n64k8 over the tile's 64 keys. A is P from registers: a
//   tf32 register A fragment and the accumulator share one per-warp layout,
//   so a k8 step of the S accumulator is an A fragment with k permuted inside
//   its group of 8 (column 2t as k = t, 2t + 1 as k = t + 4), split into hi
//   and lo. tf32 wgmma has no transposed form, so B is the V tile
//   transposed (64 head-dim rows of 64 keys) and k-permuted to match, in hi
//   and lo, as the split pass wrote it.
// - Overlap: each warpgroup issues S of tile j, then P V of tile j - 1, and
//   runs the softmax of tile j while P V of tile j - 1 is still on the
//   tensor cores. One barrier a tile hands a stage back to the loads. Every
//   accumulator and A fragment is left untouched from the issue of the
//   wgmma that uses it to the wait that completes it, so ptxas does not
//   serialize the wgmma.
// - Shared memory: Q 32 KB and three 64 KB stages, 230400 bytes with the
//   alignment slack, one block an SM.
// - Grid (query tiles of 128 rows, B*H), 256 threads; the split pass (Sk
//   padded / 64, B*H), 256 threads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // split_tf32, exp2_ftz, HI and LO
#include "sm90.cuh"      // mbarriers, TMA, wgmma, the tensor-map encoder

using namespace p2p;

namespace {

constexpr int D = 64;                       // head dim
constexpr int KS = D / 8;                   // k8 steps of S = Q K^T
constexpr int HALF = 32;                    // f32 columns of a 128-byte swizzle row
constexpr int BM = 64;                      // query rows a warpgroup owns
constexpr int NC = 2;                       // warpgroups
constexpr int ROWS = BM * NC;               // query rows a block owns
constexpr int BN = 64;                      // keys a tile: one online-softmax step
constexpr int PS = BN / 8;                  // k8 steps of P V
constexpr int STAGES = 3;                   // split tiles in flight
constexpr int NT = 128 * NC;
constexpr int ROW_BYTES = HALF * 4;         // 128
constexpr int Q_HALF = ROWS * ROW_BYTES;    // 32 columns of the block's Q rows
constexpr int Q_BYTES = 2 * Q_HALF;
constexpr int PART_HALF = BN * ROW_BYTES;   // 32 columns of K's 64 keys, 32 keys of V^T's 64 rows
constexpr int PART_BYTES = 2 * PART_HALF;   // one part of a tile: K hi, K lo, V^T hi or V^T lo
constexpr int STAGE_BYTES = 4 * PART_BYTES;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(Q_HALF % 1024 == 0 && PART_HALF % 1024 == 0, "tiles start on swizzle atoms");

// Dynamic shared memory: Q and the stages, + alignment slack.
constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
static_assert(SMEM <= 232448 - 64, "shared memory of one block an SM");

// Keys of the split V^T's rows: sk padded to whole tiles.
__host__ __device__ constexpr int padded(int sk) { return (sk + BN - 1) / BN * BN; }

// The key whose values column n of a V^T tile's k8 step holds (n < 8): the
// B of P V, whose A is an accumulator, reads column 2t as k = t and 2t + 1
// as k = t + 4.
__device__ __forceinline__ constexpr int permuted(int n) { return n < 4 ? 2 * n : 2 * n - 7; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --------------------------------------------------------------- the split

// grid (padded(sk) / BN, bh), NT threads: key tile j of k and v (bh, sk, D)
// split into kx (bh, 2, sk, D): hi, then lo, as k lies; and vx (bh, 2, D,
// padded(sk)): hi, then lo, of v transposed, column 8 a + n of a row
// holding key 8 a + permuted(n), zeros past sk.
__global__ void __launch_bounds__(NT)
flash_split_kv_tf32_kernel(const float* __restrict__ k, const float* __restrict__ v,
                           float* __restrict__ kx, float* __restrict__ vx, int sk) {
  __shared__ float vt[D][BN + 1];  // the tile of v transposed: [column][key]
  const int bh = blockIdx.y, key0 = blockIdx.x * BN, skp = padded(sk);
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < BN * C4; i += NT) {
    const int r = i / C4, c = 4 * (i % C4), key = key0 + r;
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < sk) {
      const size_t at = ((size_t)bh * sk + key) * D + c;
      const float4 kk = *reinterpret_cast<const float4*>(k + at);
      vv = *reinterpret_cast<const float4*>(v + at);
      uint4 h, l;
      split_tf32(kk.x, h.x, l.x);
      split_tf32(kk.y, h.y, l.y);
      split_tf32(kk.z, h.z, l.z);
      split_tf32(kk.w, h.w, l.w);
      const size_t hi = ((size_t)2 * bh * sk + key) * D + c;
      *reinterpret_cast<uint4*>(kx + hi) = h;
      *reinterpret_cast<uint4*>(kx + hi + (size_t)sk * D) = l;
    }
    vt[c][r] = vv.x;
    vt[c + 1][r] = vv.y;
    vt[c + 2][r] = vv.z;
    vt[c + 3][r] = vv.w;
  }
  __syncthreads();
  constexpr int K4 = BN / 4;
  for (int i = threadIdx.x; i < D * K4; i += NT) {
    const int n = i / K4, col = 4 * (i % K4);
    const int key = (col & ~7) + permuted(col & 7);  // columns col + e hold keys key + 2 e
    uint4 h, l;
    split_tf32(vt[n][key], h.x, l.x);
    split_tf32(vt[n][key + 2], h.y, l.y);
    split_tf32(vt[n][key + 4], h.z, l.z);
    split_tf32(vt[n][key + 6], h.w, l.w);
    const size_t hi = ((size_t)2 * bh * D + n) * skp + key0 + col;
    *reinterpret_cast<uint4*>(vx + hi) = h;
    *reinterpret_cast<uint4*>(vx + hi + (size_t)D * skp) = l;
  }
}

// ------------------------------------------------------------- the forward

// Shared memory from a 1024-aligned base: Q as landed, then the stages, each
// K hi, K lo, V^T hi and V^T lo, every part two 32-column halves of 128-byte
// swizzle rows.
struct Smem {
  unsigned char* raw;
  uint32_t base;
  __device__ explicit Smem(unsigned char* r) : raw(r), base((smem_u32(r) + 1023u) & ~1023u) {}
  __device__ uint32_t q() const { return base; }
  // Part p (0 K hi, 1 K lo, 2 V^T hi, 3 V^T lo) of stage s.
  __device__ uint32_t part(int s, int p) const {
    return base + Q_BYTES + s * STAGE_BYTES + p * PART_BYTES;
  }
  // The generic pointer of shared address a.
  __device__ const unsigned char* at(uint32_t a) const { return raw + (a - smem_u32(raw)); }
};

// grid (query tiles of ROWS rows, bh), NT threads; scale2 = scale log2(e).
// Warpgroup c owns queries q0 + 64 c + [0, 64). Accumulator layout (thread
// tw of a warpgroup, w = tw / 32, g = lane / 4, t = lane % 4): element i of
// S (64 x 64 keys) or O (64 x 64 columns) is row 16 w + g + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 t + i % 2.
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                           float* __restrict__ m_out, float* __restrict__ l_out, int sq, int sk,
                           float scale2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];  // Q landed, then each stage full
  const Smem sm(smem_raw);
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nk = (sk + BN - 1) / BN;
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;

  // Thread 0: the split tile j into stage j % STAGES: the K parts from rows
  // j BN of planes 2 bh and 2 bh + 1 of tm_k, the V^T parts from columns
  // j BN of those of tm_v.
  auto land = [&](int j) {
    const int s = j % STAGES;
    mbar_expect_tx(full(s), STAGE_BYTES);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tma_load_col(sm.part(s, p) + h * PART_HALF, &tm_k, full(s), h * HALF, j * BN,
                     2 * bh + p);
        tma_load_col(sm.part(s, 2 + p) + h * PART_HALF, &tm_v, full(s), j * BN + h * HALF, 0,
                     2 * bh + p);
      }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_col(sm.q() + h * Q_HALF, &tm_q, bar_q, h * HALF, q0, bh);
    for (int j = 0; j < STAGES - 1 && j < nk; ++j) land(j);
  }
  __syncthreads();

  // The warpgroup's Q rows times scale2, split: the A fragments of the
  // scores, qh[4 ks + e] and ql[4 ks + e] row 16 w + g + 8 (e % 2), column
  // 8 ks + t + 4 (e / 2).
  uint32_t qh[4 * KS], ql[4 * KS];
  mbar_wait(bar_q, 0);
  {
    const unsigned char* x = sm.at(sm.q());
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = c * BM + 16 * w + g + 8 * (e & 1), cn = 8 * (ks & 3) + t + 4 * (e >> 1);
        const int off = (ks >> 2) * Q_HALF + r * ROW_BYTES +
                        ((((cn >> 2) ^ (r & 7)) << 4) | ((cn & 3) << 2));
        split_tf32(*reinterpret_cast<const float*>(x + off) * scale2, qh[4 * ks + e],
                   ql[4 * ks + e]);
      }
  }

  float sc[32];               // S of the current tile, then its p
  float tile[32];             // the previous tile's P V
  float acc[32];              // O, unnormalized
  uint32_t ph[32], pl[32];    // the previous tile's p split: the A fragments of P V
  // Rows g and g + 8: the running max (base 2), this thread's share of the
  // running sum, and the factor the previous tile's softmax gave the output.
  float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f}, cprev[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // S = Q K^T of the tile in stage s.
  auto issue_s = [&](int s) {
    const uint32_t kh = sm.part(s, 0), kl = sm.part(s, 1);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t bo = (ks >> 2) * PART_HALF + (ks & 3) * 32;
      const uint64_t dh = desc_sw128(kh + bo, LBO_K_MAJOR), dl = desc_sw128(kl + bo, LBO_K_MAJOR);
      wgmma_rs_tf32_n64(sc, ql + 4 * ks, dh, ks);
      wgmma_rs_tf32_n64(sc, qh + 4 * ks, dl, 1);
      wgmma_rs_tf32_n64(sc, qh + 4 * ks, dh, 1);
    }
    wgmma_commit();
  };
  // tile = P V of the tile in stage s, opened with scale-d = 0.
  auto issue_pv = [&](int s) {
    const uint32_t vh = sm.part(s, 2), vl = sm.part(s, 3);
#pragma unroll
    for (int kj = 0; kj < PS; ++kj) {
      const uint32_t bo = (kj >> 2) * PART_HALF + (kj & 3) * 32;
      const uint64_t dh = desc_sw128(vh + bo, LBO_K_MAJOR), dl = desc_sw128(vl + bo, LBO_K_MAJOR);
      wgmma_rs_tf32_n64(tile, pl + 4 * kj, dh, kj);
      wgmma_rs_tf32_n64(tile, ph + 4 * kj, dl, 1);
      wgmma_rs_tf32_n64(tile, ph + 4 * kj, dh, 1);
    }
    wgmma_commit();
  };
  // The online softmax of tile j's scores in sc: keys at or past sk score
  // -inf; m2 = max(m2, max s), cf = 2^(m2_old - m2) (0 on the first tile),
  // p = 2^(s - m2) in place, lsum = lsum cf + sum p. The mask is a select
  // on every tile: as a branch around the last tile's selects it made ptxas
  // crash (a segmentation fault).
  auto softmax = [&](int j, float (&cf)[2]) {
    const int past = sk - j * BN - 2 * t;  // element i's key is 8 (i / 4) + i % 2 of this
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 8 * (i >> 2) + (i & 1) < past ? sc[i] : -INFINITY;
    float mx[2] = {m2[0], m2[1]}, ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      cf[h] = exp2_ftz(m2[h] - mx[h]);
      m2[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2_ftz(sc[i] - m2[(i >> 1) & 1]);  // -inf gives 0
      ps[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lsum[h] = lsum[h] * cf[h] + ps[h];
  };
  // p split into the A fragments of P V: elements 4j + 1 and 4j + 2 trade
  // places, so (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) of k8 step
  // j are a0..a3.
  auto split_p = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      split_tf32(sc[i], ph[(i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1)],
                 pl[(i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1)]);
  };
  // O = O cprev + tile, once P V of the previous tile is done.
  auto add_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], cprev[(i >> 1) & 1], tile[i]);
  };

  // Tile 0: S alone.
  mbar_wait(full(0), 0);
  fence_regs(sc);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0, cprev);
  split_p();

  for (int j = 1; j < nk; ++j) {
    const int s = j % STAGES;
    // Every product of tile j - 2 is done: its stage takes tile j + 1.
    __syncthreads();
    if (threadIdx.x == 0 && j + 1 < nk) land(j + 1);
    mbar_wait(full(s), (j / STAGES) & 1);
    fence_regs(sc);
    fence_regs(tile);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    issue_s(s);
    issue_pv((j - 1) % STAGES);
    wgmma_wait<1>();  // S of tile j is done; P V of tile j - 1 runs on
    fence_regs(sc);
    float cf[2];
    softmax(j, cf);
    wgmma_wait<0>();
    fence_regs(tile);
    fence_regs(ph);
    fence_regs(pl);
    add_tile();
    split_p();
    cprev[0] = cf[0];
    cprev[1] = cf[1];
  }
  fence_regs(tile);
  fence_regs(ph);
  fence_regs(pl);
  wgmma_fence();
  issue_pv((nk - 1) % STAGES);
  wgmma_wait<0>();
  fence_regs(tile);
  add_tile();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  const size_t head = (size_t)bh * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + c * BM + 16 * w + g + 8 * h;
    if (r >= sq) continue;
    const float inv = 1.f / lsum[h];
    float* orow = o + (head + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
    if (m_out != nullptr && t == 0) {
      m_out[head + r] = m2[h] * LN2;
      l_out[head + r] = lsum[h];
    }
  }
}

}  // namespace

// f32 values of scratch the entry takes in `part` for bh heads of sk keys:
// the split K and V^T.
extern "C" long long p2p_flash_attn_fwd_f32_sm90_scratch(int bh, int sk) {
  return 2LL * bh * D * (sk + padded(sk));
}

// The signature of p2p_flash_attn_fwd (flash_attn.cu): q (bh, sq, d), k and v
// (bh, sk, d), o (bh, sq, d), contiguous f32 on 16-byte boundaries, d = 64;
// m and l (bh, sq) f32, both null (K1) or both non-null (K3); part f32
// scratch of p2p_flash_attn_fwd_f32_sm90_scratch(bh, sk) values on a
// 16-byte boundary; nsplit 1 (no key split at d = 64). Launches the split
// pass, then the forward. Returns a cudaError_t (0 on success).
extern "C" int p2p_flash_attn_fwd_f32_sm90(const float* q, const float* k, const float* v,
                                           float* o, float* m, float* l, float* part,
                                           int nsplit, int bh, int sq, int sk, int d,
                                           float scale, void* stream) {
  if (d != D || nsplit != 1 || bh < 1 || bh > 65535 || sq < 1 || sk < 1 ||
      part == nullptr || (m == nullptr) != (l == nullptr))
    return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  float* kx = part;
  float* vx = part + 2LL * bh * sk * D;
  CUtensorMap maps[3];
  if (!encode_rows_f32(fn, &maps[0], q, D, sq, bh, ROWS) ||
      !encode_rows_f32(fn, &maps[1], kx, D, sk, 2 * bh, BN) ||
      !encode_rows_f32(fn, &maps[2], vx, padded(sk), D, 2 * bh, D))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_split_kv_tf32_kernel<<<dim3(padded(sk) / BN, bh), NT, 0, st>>>(k, v, kx, vx, sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_tf32_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  flash_fwd_tf32_sm90_kernel<<<dim3((sq + ROWS - 1) / ROWS, bh), NT, SMEM, st>>>(
      maps[0], maps[1], maps[2], o, m, l, sq, sk, scale * LOG2E);
  return cudaGetLastError();
}

extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
