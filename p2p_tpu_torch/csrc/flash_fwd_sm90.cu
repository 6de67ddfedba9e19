// K1 and K3 in bf16 at head dims 40, 64 and 512, on Hopper's own
// instructions: wgmma, TMA and mbarriers. flash_fwd_sm90_kernel<DH> (DH = 40
// or 64) has a producer warpgroup and two consumer warpgroups;
// flash_d512_sm90_kernel (below the notes of the other) has two warpgroups
// and splits its keys among blocks.
//
// Replaces, in bf16, the JAX package's `flash_attention_tpu`
// (p2p_tpu/models/nn.py:330, K1) and `flash_attention_residuals`
// (p2p_tpu/models/nn.py:343, K3): the library Pallas TPU flash kernel
// (`flash_attention.py:758`, its `pallas_call`), with save_residuals for K3.
// On the paths at d = 40: K1 at SD-1.4's 64x64-pixel self sites of a bf16
// edit or replay, (4, 8, 4096, 40), and of a bf16 inversion's forwards
// without gradient, (1, 8, 4096, 40); K3 (m and l non-null) at the bf16
// inversion's gradient sites, (1, 8, 4096, 40). At d = 64: K1 at SD-2.1's
// self sites of a bf16 edit or replay, (4, 5, 9216, 64) and (4, 10, 2304,
// 64) at 768-v, (4, 5, 4096, 64) at 512-base, and in the bf16 inversions'
// forwards without gradient at batch 1; K3 at the bf16 inversions' gradient
// sites, (1, 5, 9216, 64), (1, 10, 2304, 64), (1, 5, 4096, 64). At d = 512:
// K1 at the VAE's mid attention in a bf16 inversion's encode, (1, 1, 4096,
// 512) at SD-1.4 and (1, 1, 9216, 512) at SD-2.1 768-v.
//
// The function: o = softmax(q k^T scale) v, bf16 in and out, non-causal,
// unmasked; with m and l, also each row's max m (natural units) and sum
// l = sum_j exp(s_j - m) of the unrounded exponentials (f32). The arithmetic
// is the JAX library kernel's in bf16 (kernels/bf16.py:flash emulates it
// step by step): the scores are exact bf16 products summed in f32 and scaled
// by scale * log2(e); each 128-key tile's unnormalized p = 2^(s - m2),
// against the running max m2 in base 2, is rounded to bf16 (to nearest even)
// before P V; the row sum takes p unrounded; the output stays f32 until it
// is divided by l and rounded once.
//
// Bound on an H100 SXM: 4 S^2 d flops a head at 989 TFLOP/s, 0.4397 ms at
// (4, 5, 9216, 64) (the bytes take 0.0225 ms) and 0.0869 ms at (4, 8, 4096,
// 40). The exponentials are a second floor: b h S^2 ex2 at 16 a clock an SM
// (the MUFU) on 132 SMs at 1.98 GHz, 0.41 ms at (4, 5, 9216, 64) and 0.128
// ms at (4, 8, 4096, 40), where it lies above the tensor cores' floor. Run
// one after the other the two take about SDPA's time, so the design
// overlaps them:
//
// - Loads by TMA. One 3-D tensor map each for Q, K and V, (DH, S, B*H),
//   box (64, rows, 1), 128-byte swizzle: a 64-wide bf16 row is 128 bytes, one
//   swizzle row, so the tiles land in the layout wgmma reads with no padding;
//   a tile never reads the next head's rows, and rows past S arrive
//   zero-filled. At DH = 40 the tiles, swizzle and descriptors stay d = 64's:
//   Q's 80-byte rows land in the 64-column box with columns 40..63
//   zero-filled by TMA, and K's and V's in narrow boxes of their 40 columns
//   at the start of each 128-byte swizzle row, TMA leaving the rest as it
//   was (sm90.cuh:encode_rows); the zero-filled boxes took 1.2x as long for
//   K and V, which stream, on an H100 80GB HBM3 at 700 W
//   (tools/k1_d40_variants.py times the variants). The K ring starts
//   zeroed, since Q K^T's last k16 step reads K's columns 40..47 against
//   Q's zeros. The maps are encoded on the host each call
//   (cuTensorMapEncodeTiled, fetched once from the driver through the
//   runtime's entry-point query, so the library needs no -lcuda) and passed
//   as __grid_constant__ parameters.
// - Warp specialisation. Warpgroups 0 and 1 are consumers, each owning 64 of
//   the block's 128 query rows; warpgroup 2 is the producer: it gives up
//   registers (setmaxnreg 24, the consumers take 240) and one thread lands Q
//   once and keeps a ring of two K and two V tiles of 128 keys in flight, of
//   three each at d = 40 (expect-tx on each tile's full barrier; the
//   consumers' warps release it on its empty barrier).
// - S = Q K^T by wgmma m64n128k16, (DH + 15) / 16 k-steps (4 at d = 64; 3 at
//   d = 40, the third reading columns 32..47, of which 40..47 are zeros),
//   both operands in shared memory through descriptors (K-major, 128-byte
//   swizzle).
// - O += P V by wgmma m64nDHk16 (m64n64k16, or m64n40k16 over V's first 40
//   columns): P is A from registers (the f32 accumulator layout of S is the
//   A-register layout of the next product, two columns to a register), V is
//   B from shared memory as stored, [key][64 columns], the MN-major
//   ("transposed") operand.
// - Overlap: each consumer issues tile j's Q K^T and then tile j-1's P V
//   before it waits for the scores, so the exponentials of tile j run while
//   the tensor cores work on P_{j-1} V_{j-1} and on the other consumer's
//   products. O is rescaled by 2^(m2 - m2') after that product is done and
//   the next Q K^T issued, and not at all when no row's max moved. A
//   ping-pong of the two consumers on named barriers measured within 1 % of
//   this and was left out; issuing Q K^T a tile ahead needs a second S
//   accumulator, and ptxas then spills at the 168 registers it allocates.
// - The softmax takes as few instructions an element as the arithmetic
//   allows: keys past sk are masked only in the last tile, the scale folds
//   into the exponent's fused multiply-add, and maxima and sums run in four
//   independent chains a row.
// - Grid (query tiles of 128 rows, B*H), 384 threads, one block an SM.
//
// flash_d512_sm90_kernel, the same function at d = 512. Bound on an H100
// SXM: 4 S^2 d flops a head at 989 TFLOP/s, 0.1759 ms at (1, 1, 9216, 512)
// (the bytes, 37.7 MB, take 0.011 ms). What binds it is the K and V stream: a
// 64-row query tile is all the registers allow (O is 64 x 512 f32, 128
// registers a thread over two warpgroups), so each block reads all of K and
// V for 64 queries, 256 KB a 128-key tile against 16.8 MFLOP, some 2.7 GB
// through L2 at (1, 1, 9216, 512); a variant that only streams the chunks,
// with no products, took nearly all of the kernel's time on an H100 80GB
// HBM3 at 700 W. The design:
//
// - One block an SM: 64 query rows, two warpgroups over the same rows, no
//   producer warps (a ninth warp caps ptxas at 168 registers, and O spills
//   there); thread 0 also lands the chunks.
// - Q (64 KB) lands once by TMA as eight 64-column boxes with the 128-byte
//   swizzle and stays. K and V stream through a ring of eight 16 KB stages,
//   each chunk landed two chunks before it is read: per 128-key tile, eight
//   K chunks (128 keys x 64 dims, one box) then eight V chunks (16 keys x
//   512 dims, eight boxes).
// - S split by keys: warpgroup c takes keys 64 c + [0, 64) of each tile,
//   wgmma m64n64k16 with Q and K from shared memory, 32 k16 steps.
// - The softmax across the halves: each warpgroup takes its rows' max over
//   its 64 keys and the two exchange them through shared memory, so both
//   rescale with the same max; each writes its p, rounded to bf16, as one
//   half of the 64 x 128 P tile in shared memory (K-major, swizzled).
// - O split by columns: warpgroup c holds columns 256 c + [0, 256) (m64n256k16,
//   P and V from shared memory, V MN-major across four 64-column boxes) and
//   accumulates across tiles in the wgmma accumulator (the bf16 bar of 1e-2
//   is far above its rounding toward zero).
// - Each warpgroup's share of the row sums is added in a fixed order at the
//   end. The chunk loops are unrolled so ptxas sees which wgmma each wait
//   completes: an accumulator touched while a wgmma writing it may be in
//   flight makes ptxas serialize every wgmma (C7515): 1.8x the time at
//   (1, 1, 9216, 512) unsplit on an H100 80GB HBM3 at 700 W.
// - Tried on an H100 80GB HBM3 at 700 W and left out: a cluster of two
//   blocks sharing each chunk by TMA multicast (slower at every shape
//   timed; with release.cluster arrivals several times slower), a producer
//   warp (168 registers, spills), nine stages, and landing a chunk further
//   ahead (both slower).
// - Grid (query tiles of 64 rows, B*H, key splits), 256 threads. One block
//   fills an SM, so where the query tiles leave SMs idle the keys are split
//   among blocks (the wrapper picks the split, kernels/flash.py:key_splits)
//   and flash_merge_kernel<bf16> (flash_merge.cuh) merges their partials.
//
// No atomics: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_bf16.cuh"  // pack_bf16, exp2_ftz, smem_u32
#include "flash_merge.cuh"  // flash_merge_kernel<bf16>, MergeParts, launch_flash_merge
#include "sm90.cuh"       // mbarriers, TMA, wgmma, the tensor-map encoder

using namespace p2p;

namespace {

namespace fwd {
constexpr int BOX = 64;                // columns of a tile row: one 128-byte swizzle row
constexpr int BM = 64;                 // query rows a consumer warpgroup
constexpr int NC = 2;                  // consumer warpgroups
constexpr int ROWS = BM * NC;          // query rows a block
constexpr int BN = 128;                // keys a tile
constexpr int SN = BN / 2;             // S accumulators a consumer thread
constexpr int NT = 128 * (NC + 1);     // consumer warpgroups, then the producer's
constexpr int ROW_BYTES = BOX * 2;
constexpr int TILE_BYTES = BN * ROW_BYTES;  // a K or V stage
constexpr int Q_BYTES = ROWS * ROW_BYTES;
// Registers a thread after setmaxnreg: the producer's go to the consumers.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert((PRODUCER_REGS + NC * CONSUMER_REGS) * 128 <= 65536, "register file");
constexpr float LOG2E = 1.4426950408889634f;

// The k16 steps of Q K^T at head dim DH: rounded up, so that at d = 40 the
// third step takes columns 32..39 (and the zeros after them).
template <int DH>
__host__ __device__ constexpr int qk_steps() {
  static_assert(DH % 8 == 0 && DH <= BOX, "a head row fits one 64-column box");
  return (DH + 15) / 16;
}
static_assert(qk_steps<40>() == 3 && qk_steps<64>() == 4, "k16 steps of Q K^T");

// K and V tiles in flight, each in a ring of this many stages: two at d =
// 64; three at d = 40, whose P V is the narrower m64n40k16 (the two
// together 4 % faster at (4, 8, 4096, 40) on an H100 80GB HBM3 at 700 W,
// either alone within 1 %: tools/k1_d40_variants.py).
template <int DH>
__host__ __device__ constexpr int stages() {
  return DH < BOX ? 3 : 2;
}
// Dynamic shared memory: Q, the K ring and the V ring, + alignment slack.
template <int DH>
constexpr size_t smem_bytes() {
  return 1024 + Q_BYTES + 2 * stages<DH>() * TILE_BYTES;
}
}  // namespace fwd

// ------------------------------------------------------------------ kernel

// grid (query tiles of ROWS rows, bh), NT threads; head dim DH (40 or 64),
// o (bh, sq, DH). Accumulator layouts (thread tw of a consumer warpgroup, w =
// tw / 32, g = lane / 4, t = lane % 4): element i of S (64 x 128) or O (64 x
// DH) is row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
template <int DH>
__global__ void __launch_bounds__(fwd::NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, int sq, int sk,
                      float scale2) {
  using namespace fwd;
  constexpr int KS = qk_steps<DH>();
  constexpr int STAGES = stages<DH>();
  constexpr int KV_BYTES = BN * DH * 2;  // a K or V tile as TMA lands it
  extern __shared__ unsigned char smem_raw[];
  // Q landed, then per stage: K full, V full, K empty, V empty.
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t k_s = q_s + Q_BYTES;
  const uint32_t v_s = k_s + STAGES * TILE_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto k_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto v_full = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto k_empty = [&](int s) { return smem_u32(&bars[1 + 2 * STAGES + s]); };
  auto v_empty = [&](int s) { return smem_u32(&bars[1 + 3 * STAGES + s]); };
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nk = (sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * NC);  // one arrival a consumer warp
      mbar_init(v_empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (DH < BOX) {
    // K lands in boxes of its DH columns, so TMA never writes the rest of
    // its rows, and Q K^T's last k16 step reads 8 of them against Q's
    // zero-filled columns: the K ring starts zeroed, so that no stale NaN
    // meets those zeros.
    for (int i = threadIdx.x; i < STAGES * TILE_BYTES / 16; i += NT)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(k_s + 16 * i), "r"(0)
                   : "memory");
    fence_proxy_async();  // the zeros before TMA and wgmma touch the ring
  }
  __syncthreads();

  // The role by warpgroup, through a shuffle so the compiler knows it is
  // warp-uniform (2-3 % faster than threadIdx.x / 128 alone on an H100 80GB
  // HBM3 at 700 W).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NC) {
    // Producer: one thread issues every load; the warpgroup's registers go
    // to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_load(q_s, &tm_q, bar_q, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        if (j >= STAGES) mbar_wait(k_empty(s), ph ^ 1);  // tile j - STAGES released
        mbar_expect_tx(k_full(s), KV_BYTES);
        tma_load(k_s + s * TILE_BYTES, &tm_k, k_full(s), j * BN, bh);
        if (j >= STAGES) mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), KV_BYTES);
        tma_load(v_s + s * TILE_BYTES, &tm_v, v_full(s), j * BN, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int c = wg;
    const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint64_t dq = desc_sw128(q_s + c * BM * ROW_BYTES, LBO_K_MAJOR);
    auto dk = [&](int s) { return desc_sw128(k_s + s * TILE_BYTES, LBO_K_MAJOR); };
    auto dv = [&](int s) { return desc_sw128(v_s + s * TILE_BYTES, LBO_MN_MAJOR); };

    float sc[SN];         // S of the current tile, then its p = 2^(s - m2)
    float acc[DH / 2];    // O, unnormalized: DH columns
    uint32_t pk[SN / 2];  // the previous tile's p in bf16: the A fragments of P V
    // Rows g and g + 8: the running max (base 2) and this thread's share of
    // the running sum.
    float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
    float cf[2];  // the last softmax's factor for the old sum and output
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    // S = Q K^T of the tile in stage s, KS k16 steps (32 bytes each along
    // the swizzled row).
    auto issue_qk = [&](int s) {
      const uint64_t db = dk(s);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_ss_n128(sc, dq + 2 * ks, db + 2 * ks, ks);
      wgmma_commit();
    };
    // O += P V of the tile in stage s, eight k16 steps of 16 keys (2048
    // bytes), over V's first DH columns.
    auto issue_pv = [&](int s) {
      const uint64_t db = dv(s);
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        if constexpr (DH == 40)
          wgmma_rs_n40(acc, pk + 4 * ks, db + 128 * ks);
        else
          wgmma_rs_n64(acc, pk + 4 * ks, db + 128 * ks);
      }
      wgmma_commit();
    };
    // The online softmax of tile j's scores: with a true mask (the last
    // tile, when sk is not a multiple of BN), keys at or past sk score -inf.
    // The rows' new max m2 = max(m2, max_j s_j * scale2) (the raw max scaled: rounding
    // is monotonic, so this is the max of the scaled scores), the factor cf
    // the old sum and output are rescaled by (0 on the first tile), p =
    // 2^(s * scale2 - m2) by one fused multiply-add over sc, and the sum.
    // Maxima and sums run in four independent chains a row.
    auto softmax = [&](auto mask, int j, float (&cf)[2]) {
      if constexpr (decltype(mask)::value) {
        const int key0 = j * BN;
#pragma unroll
        for (int i = 0; i < SN; ++i)
          if (key0 + 8 * (i >> 2) + 2 * t + (i & 1) >= sk) sc[i] = -INFINITY;
      }
      float mx[2][4], ps[2][4];  // [row][chain]
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int h = (i >> 1) & 1, a = ((i >> 2) & 1) | (i & 1) << 1;
        mx[h][a] = i < 8 ? sc[i] : fmaxf(mx[h][a], sc[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        m = fmaxf(m2[h], m * scale2);
        cf[h] = exp2_ftz(m2[h] - m);
        m2[h] = m;
      }
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int h = (i >> 1) & 1, a = ((i >> 2) & 1) | (i & 1) << 1;
        sc[i] = exp2_ftz(fmaf(sc[i], scale2, -m2[h]));  // -inf gives 0
        ps[h][a] = i < 8 ? sc[i] : ps[h][a] + sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lsum[h] = lsum[h] * cf[h] + ((ps[h][0] + ps[h][1]) + (ps[h][2] + ps[h][3]));
    };
    // O *= cf, the factor of the last softmax, unless no row's max moved
    // (cf = 1 throughout the warp: most tiles after the first few). Done
    // after the next Q K^T is issued, so that product starts sooner.
    auto rescale_o = [&]() {
      if (__all_sync(0xffffffffu, cf[0] == 1.f && cf[1] == 1.f)) return;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= cf[(i >> 1) & 1];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) pk[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    };
    using Mask = std::true_type;
    using NoMask = std::false_type;
    const bool ragged = sk % BN != 0;

    mbar_wait(bar_q, 0);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty(0));
    if (ragged && nk == 1)
      softmax(Mask(), 0, cf);
    else
      softmax(NoMask(), 0, cf);
    pack_p();
    for (int j = 1; j < nk; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      mbar_wait(k_full(s), (j / STAGES) & 1);
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pk);
      wgmma_fence();
      issue_qk(s);
      rescale_o();  // by the last softmax's factor, before P V adds to O
      wgmma_fence();
      mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);
      issue_pv(sp);
      wgmma_wait<1>();  // S of tile j is done; P V of tile j - 1 runs on
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(s));
      if (ragged && j == nk - 1)
        softmax(Mask(), j, cf);
      else
        softmax(NoMask(), j, cf);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pk);
      if (lane == 0) mbar_arrive(v_empty(sp));
      pack_p();
    }
    const int sl = (nk - 1) % STAGES;
    mbar_wait(v_full(sl), ((nk - 1) / STAGES) & 1);
    fence_regs(acc);
    fence_regs(pk);
    rescale_o();
    wgmma_fence();
    issue_pv(sl);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(v_empty(sl));

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
    }
    // The first DH columns of O, groups of 8 at a row stride of DH.
    const float inv[2] = {1.f / lsum[0], 1.f / lsum[1]};
    const size_t head = (size_t)bh * sq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + c * BM + 16 * w + g + 8 * h;
      if (r >= sq) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(o + (head + r) * DH);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        orow[4 * n + t] =
            pack_bf16(acc[4 * n + 2 * h] * inv[h], acc[4 * n + 2 * h + 1] * inv[h]);
      if (m_out != nullptr && t == 0) {
        m_out[head + r] = m2[h] * 0.6931471805599453f;  // log2 units to natural
        l_out[head + r] = lsum[h];
      }
    }
  }
}

// The tensor maps of q (bh, sq, D) and k, v (bh, sk, D), bf16, with boxes
// of q_box, k_box and v_box rows and 64 columns; at D = 40 q's last 24
// columns zero-filled, and k's and v's boxes narrow, of their 40 columns
// (sm90.cuh:encode_rows). 0 on success, else a cudaError_t.
template <int D>
int encode_qkv(CUtensorMap& tq, CUtensorMap& tk, CUtensorMap& tv, const void* q,
               const void* k, const void* v, int bh, int sq, int sk, int q_box, int k_box,
               int v_box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const bool ok = encode_rows(fn, &tq, q, D, sq, bh, q_box) &&
                  encode_rows(fn, &tk, k, D, sk, bh, k_box, D < 64) &&
                  encode_rows(fn, &tv, v, D, sk, bh, v_box, D < 64);
  return ok ? 0 : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- d = 512

namespace d512 {
constexpr int D = 512;
constexpr int BM = 64;                  // query rows a block, shared by both warpgroups
constexpr int BN = 128;                 // keys a tile
constexpr int NC = 2;                   // warpgroups
constexpr int NT = 128 * NC;
constexpr int KN = BN / NC;             // keys of S a warpgroup
constexpr int ON = D / NC;              // output columns a warpgroup
constexpr int BOX = 64;                 // columns of a box: one 128-byte swizzle row
constexpr int BOX_BYTES = BM * BOX * 2;  // a 64-row box (Q, P)
constexpr int NKC = D / BOX;            // K chunks a tile: 128 keys x 64 dims
constexpr int VK = 16;                  // keys of a V chunk (x 512 dims): one k16 step
constexpr int NVC = BN / VK;            // V chunks a tile
constexpr int CHUNKS = NKC + NVC;
constexpr int CHUNK_BYTES = BN * BOX * 2;
constexpr int V_BOX_BYTES = VK * BOX * 2;
static_assert((D / BOX) * V_BOX_BYTES == CHUNK_BYTES, "a V chunk fills a stage");
constexpr int Q_BYTES = BM * D * 2;
constexpr int P_BYTES = BM * BN * 2;
constexpr int STAGES = 8;               // chunks in the ring; one lands two chunks ahead
constexpr size_t SMEM = 1024 + Q_BYTES + P_BYTES + STAGES * CHUNK_BYTES;  // + alignment slack
static_assert(SMEM + 8 * (1 + 2 * STAGES) + 4 * NC * BM <= 232448, "shared memory");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
}  // namespace d512

// grid (query tiles of 64 rows, bh, key splits), 256 threads: two
// warpgroups over the same 64 query rows. The block's key range is tiles
// [t0, t1) of 128 keys (split z of nsplit), streamed as chunks: per tile,
// eight K chunks (128 keys x 64 dims, one box) and eight V chunks (16 keys x
// 512 dims, eight boxes of 64 columns), each 16 KB, through a ring of
// STAGES stages filled by thread 0. Warpgroup c computes S for keys 64 c +
// [0, 64) of each tile (m64n64k16, Q and K from shared memory, 32 k16
// steps) and O for columns 256 c + [0, 256) (m64n256k16, P and V from
// shared memory), accumulated across tiles in the wgmma accumulator. With
// one split, o is the bf16 output and m_out / l_out the optional residuals;
// with several, the split writes its slice of the f32 partials (part_o,
// m_out, l_out: the unnormalized output, the row max and the row sum),
// which flash_merge_kernel<bf16> combines. Accumulator layout as
// flash_fwd_sm90_kernel's: element i is row 16 w + g + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 t + i % 2.
__global__ void __launch_bounds__(d512::NT, 1)
flash_d512_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                       float* __restrict__ part_o, float* __restrict__ m_out,
                       float* __restrict__ l_out, int sq, int sk, float scale2) {
  using namespace d512;
  extern __shared__ unsigned char smem_raw[];
  // Q landed, then per stage: full, empty.
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  // Each warpgroup's row maxima of a tile, then its row sums at the end.
  __shared__ float red_s[NC][BM];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t p_s = q_s + Q_BYTES;
  const uint32_t ring = p_s + P_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int nsplit = gridDim.z, split = blockIdx.z;
  const int ktiles = (sk + BN - 1) / BN;
  const int t0 = split * ktiles / nsplit, t1 = (split + 1) * ktiles / nsplit;
  const int nchunks = (t1 - t0) * CHUNKS;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The warpgroup, through a shuffle so the compiler knows it is
  // warp-uniform.
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tw = threadIdx.x & 127, w = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool loader = threadIdx.x == 0;

  // Chunk i of the block's stream into its stage, once the chunk STAGES
  // before it is released. A V chunk wholly past sk reads the last chunk
  // that holds keys instead (its P is 0 there, and TMA never fills a
  // stage with anything but finite rows or zeros).
  auto land = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
    const int tile = t0 + i / CHUNKS, part = i % CHUNKS;
    const uint32_t dst = ring + s * CHUNK_BYTES;
    mbar_expect_tx(full(s), CHUNK_BYTES);
    if (part < NKC) {
      tma_load_col(dst, &tm_k, full(s), part * BOX, tile * BN, bh);
    } else {
      const int key = min(tile * BN + (part - NKC) * VK, (sk - 1) / VK * VK);
#pragma unroll
      for (int b = 0; b < D / BOX; ++b)
        tma_load_col(dst + b * V_BOX_BYTES, &tm_v, full(s), b * BOX, key, bh);
    }
  };
  if (loader) {
    mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
    for (int b = 0; b < D / BOX; ++b)
      tma_load_col(q_s + b * BOX_BYTES, &tm_q, bar_q, b * BOX, q0, bh);
    for (int i = 0; i < STAGES - 2 && i < nchunks; ++i) land(i);
  }

  float sc[32];    // S of the tile over the warpgroup's 64 keys, then p
  float acc[128];  // O over the warpgroup's 256 columns, unnormalized
  // Rows g and g + 8: the running max (base 2, both warpgroups') and this
  // thread's share of the warpgroup's running sum.
  float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fence_regs(acc);  // zeroed before any wgmma is in flight

  int i = 0;  // the chunk in the block's stream
  // Land the chunk two stages ahead, then wait for chunk i: its stage.
  auto next = [&]() {
    if (loader && i + STAGES - 2 < nchunks) land(i + STAGES - 2);
    __syncwarp();
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    return s;
  };
  auto release = [&](int chunk) {
    if (lane == 0) mbar_arrive(empty(chunk % STAGES));
  };
  const int r0 = 16 * w + g;  // the thread's rows r0 and r0 + 8
  const uint32_t p_c = p_s + c * BOX_BYTES;  // the warpgroup's half of P

  mbar_wait(bar_q, 0);
  for (int j = t0; j < t1; ++j) {
    // S = Q K^T over the warpgroup's keys, one K chunk (64 dims) at a time.
    // Both loops are unrolled, so that ptxas sees which wgmma each wait
    // completes; in a rolled loop it cannot, and serializes them all.
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc, ++i) {
      const int s = next();
      const uint64_t da = desc_sw128(q_s + kc * BOX_BYTES, LBO_K_MAJOR);
      const uint64_t db = desc_sw128(ring + s * CHUNK_BYTES + c * KN * BOX * 2, LBO_K_MAJOR);
      // Registers are fenced only where no wgmma writing them is in flight:
      // touching them earlier serializes every wgmma (ptxas C7515).
      if (kc == 0) fence_regs(sc);  // last written by the softmax
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BOX / 16; ++ks) wgmma_ss_n64(sc, da + 2 * ks, db + 2 * ks, kc + ks);
      wgmma_commit();
      if (kc < NKC - 1) {
        wgmma_wait<1>();  // the chunk before is read
      } else {
        wgmma_wait<0>();  // S done, and the tile before's P V with it
        fence_regs(sc);
        fence_regs(acc);
      }
      if (i > 0) release(i - 1);
      if (kc == NKC - 1) release(i);
    }

    // The online softmax over both warpgroups' keys: each takes its rows'
    // max over its 64 keys (keys at or past sk at -inf), the two exchange
    // them through shared memory, and both rescale by the same max.
    const int key0 = j * BN + c * KN;
    if (key0 + KN > sk) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (key0 + 8 * (e >> 2) + 2 * t + (e & 1) >= sk) sc[e] = -INFINITY;
    }
    float mx[2], cf[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = fmaxf(sc[2 * h], sc[2 * h + 1]), b = fmaxf(sc[4 + 2 * h], sc[5 + 2 * h]);
#pragma unroll
      for (int n = 2; n < 8; n += 2) {
        a = fmaxf(a, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
        b = fmaxf(b, fmaxf(sc[4 * n + 4 + 2 * h], sc[4 * n + 5 + 2 * h]));
      }
      a = fmaxf(a, b);
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
      mx[h] = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
    }
    if (t == 0) {
      red_s[c][r0] = mx[0];
      red_s[c][r0 + 8] = mx[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // The raw max scaled: rounding is monotonic, so this is the max of the
      // scaled scores.
      const float m = fmaxf(m2[h], fmaxf(mx[h], red_s[c ^ 1][r0 + 8 * h]) * scale2);
      cf[h] = exp2_ftz(m2[h] - m);  // 0 on the first tile
      m2[h] = m;
    }
    // p = 2^(s scale2 - m2) by one fused multiply-add, the sums of the
    // unrounded p in two chains a row, and p rounded to bf16 into the
    // warpgroup's half of P (K-major, 128-byte swizzle: 16-byte chunk n of
    // row r at r * 128 + (n ^ r % 8) * 16; conflict-free).
    float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * n + 2 * h;
        sc[e] = exp2_ftz(fmaf(sc[e], scale2, -m2[h]));  // -inf gives 0
        sc[e + 1] = exp2_ftz(fmaf(sc[e + 1], scale2, -m2[h]));
        ps[h][n & 1] += sc[e] + sc[e + 1];
        const uint32_t addr = p_c + (r0 + 8 * h) * 128 + ((n ^ g) << 4) + 4 * t;
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(pack_bf16(sc[e], sc[e + 1]))
                     : "memory");
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) lsum[h] = lsum[h] * cf[h] + (ps[h][0] + ps[h][1]);
    fence_proxy_async();  // P's stores before wgmma reads them
    __syncthreads();      // both halves of P written; the maxima read
    // O *= cf, unless no row's max moved (cf = 1 throughout the warp).
    if (!__all_sync(0xffffffffu, cf[0] == 1.f && cf[1] == 1.f)) {
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e] *= cf[(e >> 1) & 1];
    }

    // O += P V over the warpgroup's columns, one V chunk (16 keys) a k16 step.
#pragma unroll
    for (int vc = 0; vc < NVC; ++vc, ++i) {
      const int s = next();
      const uint64_t da =
          desc_sw128(p_s + (vc / 4) * BOX_BYTES, LBO_K_MAJOR) + 2 * (vc % 4);
      const uint64_t db = desc_sw128(ring + s * CHUNK_BYTES + c * (ON / BOX) * V_BOX_BYTES,
                                     V_BOX_BYTES >> 4);
      if (vc == 0) fence_regs(acc);  // rescaled
      wgmma_fence();
      wgmma_ss_n256_tb(acc, da, db);
      wgmma_commit();
      wgmma_wait<1>();
      if (vc > 0) release(i - 1);  // (the last K chunk went at the softmax)
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // The row sums: the thread's share over the quad, then the two
  // warpgroups' in order, so two launches give the same bits.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  if (t == 0) {
    red_s[c][r0] = lsum[0];
    red_s[c][r0 + 8] = lsum[1];
  }
  __syncthreads();
  const bool merged = nsplit > 1;
  const size_t rows0 = ((size_t)split * gridDim.y + bh) * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (q0 + r >= sq) continue;
    const float l = red_s[0][r] + red_s[1][r];
    const size_t off = (rows0 + q0 + r) * D + c * ON + 2 * t;
    if (merged) {
#pragma unroll
      for (int n = 0; n < ON / 8; ++n)
        *reinterpret_cast<float2*>(part_o + off + 8 * n) =
            make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    } else {
      const float inv = 1.f / l;
#pragma unroll
      for (int n = 0; n < ON / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + off + 8 * n) =
            pack_bf16(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
    }
    if (m_out != nullptr && c == 0 && t == 0) {
      m_out[rows0 + q0 + r] = m2[h] * LN2;  // log2 units to natural
      l_out[rows0 + q0 + r] = l;
    }
  }
}

int launch_d512(const void* q, const void* k, const void* v, bf16* o, float* m, float* l,
                float* part, int nsplit, int bh, int sq, int sk, float scale,
                cudaStream_t stream) {
  using namespace d512;
  const int ktiles = (sk + BN - 1) / BN;
  if (nsplit < 1 || nsplit > ktiles || nsplit > 65535 || (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (int bad = encode_qkv<D>(tq, tk, tv, q, k, v, bh, sq, sk, BM, BN, VK)) return bad;
  cudaError_t err = cudaFuncSetAttribute(
      flash_d512_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BM - 1) / BM, bh, nsplit);
  const size_t rows = (size_t)bh * sq;
  const MergeParts p(part, nsplit, rows);
  flash_d512_sm90_kernel<<<grid, NT, SMEM, stream>>>(
      tq, tk, tv, o, p.po, nsplit > 1 ? p.pm : m, nsplit > 1 ? p.pl : l, sq, sk,
      scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_flash_merge<bf16>(p, nsplit, rows, o, m, l, stream);
}

// flash_fwd_sm90_kernel at head dim DH (40 or 64).
template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, bf16* o, float* m, float* l,
               int bh, int sq, int sk, float scale, cudaStream_t stream) {
  using namespace fwd;
  CUtensorMap tq, tk, tv;
  if (int bad = encode_qkv<DH>(tq, tk, tv, q, k, v, bh, sq, sk, ROWS, BN, BN)) return bad;
  constexpr size_t SMEM = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + ROWS - 1) / ROWS, bh);
  flash_fwd_sm90_kernel<DH><<<grid, NT, SMEM, stream>>>(tq, tk, tv, o, m, l, sq, sk,
                                                        scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d), contiguous bf16 on
// 16-byte boundaries, d = 40, 64 or 512; m and l (bh, sq) f32, both null
// (K1) or both non-null (K3). At d = 40 and 64 nsplit must be 1 and part
// null; at d = 512 nsplit key splits (1 to the 128-key tiles), and with more
// than one, part is f32 scratch of nsplit * bh * sq * (d + 2) values. Returns
// a cudaError_t (0 on success).
extern "C" int p2p_flash_attn_fwd_bf16_sm90(const void* q, const void* k, const void* v,
                                            void* o, float* m, float* l, float* part,
                                            int nsplit, int bh, int sq, int sk, int d,
                                            float scale, void* stream) {
  if ((m == nullptr) != (l == nullptr) || bh < 1 || bh > 65535 || sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == d512::D)
    return launch_d512(q, k, v, static_cast<bf16*>(o), m, l, part, nsplit, bh, sq, sk, scale, s);
  if ((d != 40 && d != 64) || nsplit != 1 || part != nullptr) return cudaErrorInvalidValue;
  return (d == 40 ? launch_fwd<40> : launch_fwd<64>)(q, k, v, static_cast<bf16*>(o), m, l, bh,
                                                      sq, sk, scale, s);
}

extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
