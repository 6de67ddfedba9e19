// K1 and K3 in bf16 at head dim 64, on Hopper's own instructions: wgmma,
// TMA and mbarriers, with a producer warpgroup and two consumer warpgroups.
//
// Replaces, at d = 64 in bf16, the JAX package's `flash_attention_tpu`
// (p2p_tpu/models/nn.py:330, K1) and `flash_attention_residuals`
// (p2p_tpu/models/nn.py:343, K3): the library Pallas TPU flash kernel
// (`flash_attention.py:758`, its `pallas_call`), with save_residuals for K3.
// On the paths: K1 at SD-2.1's self sites of a bf16 edit or replay,
// (4, 5, 9216, 64) and (4, 10, 2304, 64) at 768-v, (4, 5, 4096, 64) at
// 512-base, and in the bf16 inversions' forwards without gradient at batch
// 1; K3 (m and l non-null) at the bf16 inversions' gradient sites,
// (1, 5, 9216, 64), (1, 10, 2304, 64), (1, 5, 4096, 64).
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
// (4, 5, 9216, 64) (the bytes take 0.0225 ms). The exponentials are a second
// floor: b h S^2 = 1.70e9 ex2 at 16 a clock an SM (the MUFU), 0.41 ms at a
// 1.98 GHz clock. Run one after the other the two take about SDPA's time, so
// the design overlaps them:
//
// - Loads by TMA. One 3-D tensor map each for Q, K and V, (d = 64, S, B*H),
//   box (64, rows, 1), 128-byte swizzle: a 64-wide bf16 row is 128 bytes, one
//   swizzle row, so the tiles land in the layout wgmma reads with no padding;
//   a tile never reads the next head's rows, and rows past S arrive
//   zero-filled. The maps are encoded on the host each call
//   (cuTensorMapEncodeTiled, fetched once from the driver through the
//   runtime's entry-point query, so the library needs no -lcuda) and passed as
//   __grid_constant__ parameters.
// - Warp specialisation. Warpgroups 0 and 1 are consumers, each owning 64 of
//   the block's 128 query rows; warpgroup 2 is the producer: it gives up
//   registers (setmaxnreg 24, the consumers take 240) and one thread lands Q
//   once and keeps a ring of two K and two V tiles of 128 keys in flight
//   (expect-tx on each tile's full barrier; the consumers' warps release it on
//   its empty barrier).
// - S = Q K^T by wgmma m64n128k16, four k-steps, both operands in shared
//   memory through descriptors (K-major, 128-byte swizzle).
// - O += P V by wgmma m64n64k16: P is A from registers (the f32 accumulator
//   layout of S is the A-register layout of the next product, two columns to
//   a register), V is B from shared memory as stored, [key][d], the MN-major
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
// No atomics: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_bf16.cuh"  // pack_bf16, exp2_ftz, smem_u32
#include "sm90.cuh"       // mbarriers, TMA, wgmma, the tensor-map encoder

using namespace p2p;

namespace {

constexpr int D = 64;                  // head dim: one 128-byte row
constexpr int BM = 64;                 // query rows a consumer warpgroup
constexpr int NC = 2;                  // consumer warpgroups
constexpr int ROWS = BM * NC;          // query rows a block
constexpr int BN = 128;                // keys a tile
constexpr int SN = BN / 2;             // S accumulators a consumer thread
constexpr int STAGES = 2;              // K and V tiles in flight
constexpr int NT = 128 * (NC + 1);     // consumer warpgroups, then the producer's
constexpr int ROW_BYTES = D * 2;
constexpr int TILE_BYTES = BN * ROW_BYTES;
constexpr int Q_BYTES = ROWS * ROW_BYTES;
constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * TILE_BYTES;  // + alignment slack
// Registers a thread after setmaxnreg: the producer's go to the consumers.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert((PRODUCER_REGS + NC * CONSUMER_REGS) * 128 <= 65536, "register file");
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------------ kernel

// grid (query tiles of ROWS rows, bh), NT threads. Accumulator layouts (thread
// tw of a consumer warpgroup, w = tw / 32, g = lane / 4, t = lane % 4):
// element i of S (64 x 128) or O (64 x 64) is row 16 w + g + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 t + i % 2.
__global__ void __launch_bounds__(NT, 1)
flash_d64_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, int sq, int sk,
                      float scale2) {
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
        mbar_expect_tx(k_full(s), TILE_BYTES);
        tma_load(k_s + s * TILE_BYTES, &tm_k, k_full(s), j * BN, bh);
        if (j >= STAGES) mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), TILE_BYTES);
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
    float acc[32];        // O, unnormalized
    uint32_t pk[SN / 2];  // the previous tile's p in bf16: the A fragments of P V
    // Rows g and g + 8: the running max (base 2) and this thread's share of
    // the running sum.
    float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
    float cf[2];  // the last softmax's factor for the old sum and output
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    // S = Q K^T of the tile in stage s, four k16 steps (32 bytes each along
    // the swizzled row).
    auto issue_qk = [&](int s) {
      const uint64_t db = dk(s);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_ss_n128(sc, dq + 2 * ks, db + 2 * ks, ks);
      wgmma_commit();
    };
    // O += P V of the tile in stage s, eight k16 steps of 16 keys (2048 bytes).
    auto issue_pv = [&](int s) {
      const uint64_t db = dv(s);
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) wgmma_rs_n64(acc, pk + 4 * ks, db + 128 * ks);
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
      for (int i = 0; i < 32; ++i) acc[i] *= cf[(i >> 1) & 1];
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
    const float inv[2] = {1.f / lsum[0], 1.f / lsum[1]};
    const size_t head = (size_t)bh * sq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + c * BM + 16 * w + g + 8 * h;
      if (r >= sq) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(o + (head + r) * D);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        orow[4 * n + t] =
            pack_bf16(acc[4 * n + 2 * h] * inv[h], acc[4 * n + 2 * h + 1] * inv[h]);
      if (m_out != nullptr && t == 0) {
        m_out[head + r] = m2[h] * 0.6931471805599453f;  // log2 units to natural
        l_out[head + r] = lsum[h];
      }
    }
  }
}

}  // namespace

// The signature of p2p_flash_attn_fwd_bf16 (flash_attn.cu), for d = 64 only:
// q (bh, sq, 64), k and v (bh, sk, 64), o (bh, sq, 64), contiguous bf16 on
// 16-byte boundaries; m and l (bh, sq) f32, both null (K1) or both non-null
// (K3); nsplit must be 1 and part null. Returns a cudaError_t (0 on success).
extern "C" int p2p_flash_attn_fwd_bf16_sm90(const void* q, const void* k, const void* v,
                                            void* o, float* m, float* l, float* part,
                                            int nsplit, int bh, int sq, int sk, int d,
                                            float scale, void* stream) {
  if (d != D || nsplit != 1 || part != nullptr || (m == nullptr) != (l == nullptr) ||
      bh < 1 || bh > 65535 || sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_rows(fn, &tq, q, D, sq, bh, ROWS) || !encode_rows(fn, &tk, k, D, sk, bh, BN) ||
      !encode_rows(fn, &tv, v, D, sk, bh, BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_d64_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + ROWS - 1) / ROWS, bh);
  flash_d64_sm90_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(o), m, l, sq, sk, scale * LOG2E);
  return cudaGetLastError();
}

extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
