// K2: fused edit attention — softmax plus the prompt-to-prompt edit, on the
// tensor cores in 3xTF32.
//
// Replaces the JAX package's `edit_attention` / `_edit_kernel`
// (p2p_tpu/kernels/fused_edit.py:78-218). For every row b of the CFG batch
// [uncond(B); base; edits(E)] and every head the TPU kernel computes
//
//   probs  = softmax(q_b k_b^T scale)                  key columns >= K masked
//   base   = softmax(q_B k_B^T scale)                  edit rows only
//   new    = base @ M                                  Replace / Refine
//   new    = new*ra + probs*(1 - ra)                   Refine
//   new    = new * eq                                  Reweight
//   edited = new*alpha + (1 - alpha)*probs             edit rows b >= B + 1
//   out    = (edited | probs) @ v_b
//
// Every edit operand scales a key column, so carried through `edited @ v`
// the edit folds into the values:
//
//   out_e = softmax(q_B k_B^T scale) @ V1_e + softmax(q_e k_e^T scale) @ V2_e
//   V1_e  = M_e diag(c1_e) v_e        c1 = ra*eq*alpha
//   V2_e  = diag(c2_e) v_e            c2 = (1 - ra)*eq*alpha + (1 - alpha)
//
// (ra = 1 but under Refine, eq = 1 but under Reweight, M = I without a
// transform). No K x K product is left per query row, and every row of the
// batch becomes one or two plain softmax-attention passes. Two kernels
// behind one entry point, launched in order on one stream:
//
// fold_kernel, f32 on the CUDA cores: one block per (8 columns, head, edit
// row) writes V1 and V2 into a workspace, and the blocks of head 0 and the
// first columns write each edit row's two flags, c1 == 0 and c2 == 0 on
// every key. With a transform that is 2*K^2*D flops per (edit row, head),
// 2.4 MFLOP at K = 77, D = 160: a few microseconds spread over D / 8 blocks.
//
// edit_attn_kernel: softmax attention on the tensor cores in 3xTF32
// (mma_tf32.cuh), K1's d = 40 layout (FlashAttention-2): a warp owns 16 query
// rows and every key of a step, the row max and sum reduce within a quad of
// lanes, and P never leaves registers (its C fragments are the A fragments of
// P V). A block of the grid (query tiles, heads, 2B) knows its row's kind:
// uncond rows and the base row run one pass over their own (q, k, v); an edit
// row runs the base pass (q_B, k_B, V1_e) unless c1 == 0 and its own pass
// (q_e, k_e, V2_e) unless c2 == 0, the second adding into the first's output,
// each divided by its own row sum. On the paths c1 == 0 or c2 == 0 at nearly
// every call (Replace inside its window: c2 == 0; outside: c1 == 0; a self
// site's alpha is 0 or 1), so a row is one pass; Refine needs both. The flags
// are read from device memory as a uniform branch: no host sync.
// - Keys stream through shared memory BS at a time (80 keys up to D = 40, so
//   a cross site's 77 keys at D = 40 are one step and need no rescale; 40 at
//   D = 64 and 80 and 32 at D = 160, where 80 keys' split P fragments and
//   accumulators spilled) with the online softmax of flash_d40_kernel. K and V
//   land by cp.async, the next step's while this one computes (loads through
//   registers left every block waiting on one global load after another);
//   the block then splits each step once into packed hi/lo pairs
//   (split_pair; K key-major, V transposed) from which every warp reads a
//   whole split B fragment in one conflict-free 16-byte load (row strides =
//   16 mod 32 words). Keys >= K score -inf and land as zero rows: nothing
//   past K is read from device memory, and the operands keep the JAX
//   package's padded row stride Kp.
// - Q is scaled by scale * log2(e) and split: up to D = 40 once per pass
//   into registers (40 a thread); beyond, where that would take up to 160
//   registers a thread, its rows land raw in shared memory with the first
//   step and are split as they are read, as flash_d512_kernel reads its Q.
//   The softmax is 2^x, one MUFU.EX2 a score.
// - At D = 160 two warps share 16 query rows: each takes half of the k-steps
//   of their scores (the halves are added through shared memory, so both
//   hold the same sum) and half of the output columns. One warp alone would
//   need 80 accumulators a thread besides the step's fresh ones, past 255
//   registers, and a 60-long chain of dependent mma per score tile.
// - Each step's P V is taken in a fresh accumulator, a few output n-tiles at
//   a time, and added in f32 (the tensor cores' accumulation rounds toward
//   zero).
// Bound: at the largest path geometry (cross, 4 x 8 x 4096 queries, D = 40,
// K = 77) 4*P*K*D flops per row pass against q and out, 2 x 21 MB: bytes
// bound it (0.013 ms at 3.35 TB/s; the operations take 0.010 ms in 3xTF32).
// The smaller sites have at most a few hundred blocks and end near launch
// latency. No atomics: two launches give the same bits.
//
// In bf16 (q, k, v and out bf16; a bf16 edit's K2, at the same geometries),
// a second entry runs the same fold and the same passes: fold_kernel reads
// bf16 v, folds in f32 and writes V1 and V2 as bf16 pairs, hi = bf16(x) and
// lo = bf16(x - hi) (rounded to bf16 alone, a fold with a fractional
// transform over 100 keys was 1.005e-2 of the largest magnitude from the JAX
// kernel, past the 1e-2 bar; as a pair, 5.0e-3);
// edit_attn_bf16_kernel runs each pass as one bf16 tensor-core pass
// (attn_bf16.cuh), whose q k^T takes the exact
// products of the bf16 q and k in f32 (the JAX kernel upcasts them to f32
// and multiplies there: the same values) and whose normalized P is rounded
// to bf16 before P V, as the JAX kernel rounds its probability rows (the
// row's max and sum come first: in the same step at a cross site, whose
// keys are one step, by a pass of q k^T before the P V pass at a self site).
// An edit row's pass takes P V_hi + P V_lo, two products with the same P.
// Where the JAX kernel rounds the edited P once, the fold rounds the base
// row's P and the row's own P; an edit row with two passes rounds the first
// pass's output once more before the second adds to it. Keys stream 80 a step up to D = 80 (a cross site's 77 keys are one
// step), 64 at D = 160, where one warp owns all 160 output columns (80 f32
// accumulators a thread; bf16 operands need no split parts).
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_bf16.cuh"
#include "mma_tf32.cuh"

using namespace p2p;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
// Warps a block of the main kernel: of 2, 4, 6 and 8, 8 ran fastest at
// every path geometry but the two 8^2 sites (one call a step each), where 4
// was 2-3 us faster (the block shapes tried are in PERF.md).
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr size_t SMEM_LIMIT = 232448;

// A row stride (floats) for split rows read by 16-byte loads: = 16 mod 32
// words, so the two rows a quarter-warp reads fall in different bank halves.
constexpr int ld16(int x) { return x % 32 == 16 ? x : x + 16; }

// The main kernel's geometry at head dim D. A warp owns 16 query rows and
// D / WC of their output columns: at D = 160 two warps share the rows, each
// taking half of the k-steps of their scores (added through shared memory)
// and half of their output columns, so that its accumulators fit in
// registers.
template <int D>
struct Tile {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int KS = D / 8;               // k-steps of S
  // n-tiles of S a step; k-steps of P V
  static constexpr int NTK = D <= 40 ? 10 : (D <= 80 ? 5 : 4);
  static constexpr int BS = NTK * 8;             // keys a step
  static constexpr bool QREG = D <= 40;          // Q's split fragments in registers
  static constexpr int WC = D > 80 ? 2 : 1;      // warps sharing 16 rows
  static constexpr int KSW = KS / WC;            // S's k-steps and O's n-tiles a warp
  // O's n-tiles a P V group: its fresh accumulators and independent mma.
  static constexpr int NG = KSW % 5 == 0 ? 5 : (KSW % 4 == 0 ? 4 : 2);
  static constexpr int LDR = D + 4;              // landed V rows (K rows: D)
  static constexpr int LDQ = D + 8;              // landed Q rows: A reads conflict-free
  static constexpr int LDX = ld16(2 * D);        // split K rows
  static constexpr int LDV = ld16(2 * BS);       // split V^T rows
  static constexpr int SX = WC == 2 ? 2 * NTK * 32 * 4 : 0;  // S halves a row group
  static constexpr int GROUPS = WARPS / WC;      // row groups a block
  static constexpr int ROWS = 16 * GROUPS;       // query rows a block
  static_assert(KS % WC == 0 && KSW % NG == 0 && (!QREG || WC == 1) && WARPS % WC == 0,
                "warp layout");
  // Landed K and V, split K and V^T, then (beyond D = 40) the landed Q rows
  // and the S halves.
  static constexpr size_t smem() {
    return sizeof(float) * ((size_t)BS * (D + LDR) + (size_t)BS * LDX + (size_t)D * LDV +
                            (QREG ? 0 : (size_t)GROUPS * (16 * LDQ + SX)));
  }
};

// Start copying keys [key0, key0 + BS) of K and V into the landing buffers
// Kr (row stride D) and Vr (LDR) by cp.async, as one group; rows at or past
// `keys` are zero-filled.
template <int D>
__device__ __forceinline__ void land_step(const float* __restrict__ kh,
                                          const float* __restrict__ vh, int key0,
                                          int keys, float* Kr, float* Vr) {
  using T = Tile<D>;
  constexpr int C4 = D / 4;
  // This loop and split_step's stay rolled: unrolled, they took D = 80 and
  // 160 from 220 to 246-255 registers and were 1-3 % slower on an H100.
#pragma unroll 1
  for (int i = threadIdx.x; i < T::BS * C4; i += NT) {
    const int n = i / C4, c = i % C4 * 4;
    const bool ok = key0 + n < keys;
    const size_t at = ok ? (size_t)(key0 + n) * D + c : 0;
    cp_async16(Kr + n * D + c, kh + at, ok ? 16 : 0);
    cp_async16(Vr + n * T::LDR + c, vh + at, ok ? 16 : 0);
  }
  cp_async_commit();
}

// Split the landed step once for every warp: K into Kx[n][4c] =
// split_pair(K[n][2c], K[n][2c + 1]), V transposed into Vx[d][4j] =
// split_pair(V[2j][d], V[2j + 1][d]); a thread takes one pair of each at a
// time. For V a warp takes 4 key pairs x 8 dims at a time (lane = 4 dim +
// pair), so neither its reads nor its 16-byte stores conflict.
template <int D>
__device__ __forceinline__ void split_step(const float* Kr, const float* Vr,
                                           float* Kx, float* Vx) {
  using T = Tile<D>;
  constexpr int P = D / 2;  // pairs a key
#pragma unroll 1
  for (int i = threadIdx.x; i < T::BS * P; i += NT) {
    const float2 x = *reinterpret_cast<const float2*>(Kr + 2 * i);  // row stride D = 2P
    *reinterpret_cast<uint4*>(Kx + i / P * T::LDX + 4 * (i % P)) = split_pair(x.x, x.y);
    const int lane = i & 31, w = i >> 5;
    const int j = (w % T::NTK) * 4 + (lane & 3);
    const int d = (w / T::NTK) * 8 + (lane >> 2);
    *reinterpret_cast<uint4*>(Vx + d * T::LDV + 4 * j) =
        split_pair(Vr[2 * j * T::LDR + d], Vr[(2 * j + 1) * T::LDR + d]);
  }
}

// One softmax-attention pass for this warp's query rows r0 + [0, 16) of one
// (row, head): o = softmax(q k^T scale) v on the warp's output columns,
// written to oh, or added to what oh holds (accumulate; the same thread
// wrote it). qh (pixels, D), kh and vh (keys, D); scale2 = scale * log2(e).
// Every thread of the block calls it.
template <int D>
__device__ __forceinline__ void attend(const float* __restrict__ qh,
                                       const float* __restrict__ kh,
                                       const float* __restrict__ vh,
                                       float* __restrict__ oh, int r0,
                                       int pixels, int keys, float scale2,
                                       bool accumulate, float* smem) {
  using T = Tile<D>;
  constexpr int KS = T::KS, NTK = T::NTK, NG = T::NG, KSW = T::KSW;
  float* Kr = smem;                    // the landed step, as copied
  float* Vr = Kr + T::BS * D;
  float* Kx = Vr + T::BS * T::LDR;     // the split step the warps read
  float* Vx = Kx + T::BS * T::LDX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp % T::WC, rg = warp / T::WC;  // column group, row group
  float* Qr = Vx + D * T::LDV + rg * 16 * T::LDQ;   // this row group's Q rows
  float4* Sx = reinterpret_cast<float4*>(Vx + D * T::LDV + T::GROUPS * 16 * T::LDQ) +
               rg * 2 * NTK * 32;                    // its two S halves

  if constexpr (!T::QREG) {
    // Q's rows land with the first step (raw; split as they are read, as
    // flash_d512_kernel reads its Q), once the previous pass has read them.
    __syncthreads();
    for (int i = cg * 32 + lane; i < 16 * (D / 4); i += 32 * T::WC) {
      const int row = i / (D / 4), c = i % (D / 4) * 4;
      const bool ok = r0 + row < pixels;
      cp_async16(Qr + row * T::LDQ + c, ok ? qh + (size_t)(r0 + row) * D + c : qh, ok ? 16 : 0);
    }
  }
  // The first step's copy is in flight while Q is read. The previous pass
  // left the landing buffers free (its last step copied nothing).
  land_step<D>(kh, vh, 0, keys, Kr, Vr);

  // Up to D = 40, Q * scale2 split into registers in the k order of
  // split_pair: k = t <-> dim 8 ks + 2t, k = t + 4 <-> dim 8 ks + 2t + 1.
  // Rows past pixels read as zero.
  FragA qa[T::QREG ? KS : 1];
  if constexpr (T::QREG) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float2 x = r < pixels
                             ? *reinterpret_cast<const float2*>(qh + (size_t)r * D + ks * 8 + 2 * t)
                             : make_float2(0.f, 0.f);
        qa[ks].set(h, x.x * scale2);
        qa[ks].set(2 + h, x.y * scale2);
      }
    }
  }

  // Rows g (e = 0, 1) and g + 8 (e = 2, 3): running max in log2 units and
  // this thread's share of the running sum (summed over the quad at the end).
  float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  float acc[KSW][4];
#pragma unroll
  for (int n = 0; n < KSW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int key0 = 0; key0 < keys; key0 += T::BS) {
    cp_async_wait<0>();
    __syncthreads();  // the step has landed; every warp is done with the last
    split_step<D>(Kr, Vr, Kx, Vx);
    __syncthreads();  // split tiles ready; the landing buffers are free
    if (key0 + T::BS < keys) land_step<D>(kh, vh, key0 + T::BS, keys, Kr, Vr);

    // s = (Q scale2) K^T over the step's keys.
    float s[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSW; ++kk) {
      const int ks = cg * KSW + kk;  // this warp's half at D = 160
      FragA a;
      if constexpr (T::QREG) {
        a = qa[kk];
      } else {
        // Rows g and g + 8, dims 8 ks + 2t and + 1: a0, a2 and a1, a3.
        const float2 x0 = *reinterpret_cast<const float2*>(Qr + g * T::LDQ + ks * 8 + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(Qr + (g + 8) * T::LDQ + ks * 8 + 2 * t);
        a.set(0, x0.x * scale2);
        a.set(2, x0.y * scale2);
        a.set(1, x1.x * scale2);
        a.set(3, x1.y * scale2);
      }
      FragB b[NTK];
#pragma unroll
      for (int n = 0; n < NTK; ++n)
        load_b_pair(b[n], Kx + (n * 8 + g) * T::LDX + ks * 16 + 4 * t);
      mma_3xtf32([&](int ta, int tb) {
#pragma unroll
        for (int n = 0; n < NTK; ++n) mma_tf32(s[n], a.x[ta], b[n].x[tb]);
      });
    }
    if constexpr (T::WC == 2) {
      // The two halves through shared memory: both warps add the same two
      // values, so both hold the same scores. The next step writes the
      // halves only after its barriers, when both have read them.
#pragma unroll
      for (int n = 0; n < NTK; ++n)
        Sx[(cg * NTK + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      asm volatile("bar.sync %0, 64;" ::"r"(1 + rg));
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
        const float4 o = Sx[((cg ^ 1) * NTK + n) * 32 + lane];
        s[n][0] += o.x;
        s[n][1] += o.y;
        s[n][2] += o.z;
        s[n][3] += o.w;
      }
    }
    if (key0 + T::BS > keys) {  // keys past K score -inf
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + n * 8 + 2 * t + (e & 1) >= keys) s[n][e] = -INFINITY;
    }

    // Online softmax in registers, base 2: p = 2^(s - m2).
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float ps[2] = {0.f, 0.f}, c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      c[h] = exp2_ftz(m2[h] - mx[h]);  // 0 on the first step
      m2[h] = mx[h];
    }
    // P's C fragments, split, are the A fragments of P V (a_from_c).
    FragA pa[NTK];
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_ftz(s[n][e] - m2[e >> 1]);  // -inf gives 0
        ps[e >> 1] += s[n][e];
      }
      a_from_c(pa[n], s[n]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lsum[h] = lsum[h] * c[h] + ps[h];

    // O = O c + P V on the warp's columns, NG n-tiles at a time, each
    // group's product over the step's keys in a fresh accumulator added in
    // f32.
    const float* Vw = Vx + cg * KSW * 8 * T::LDV;
#pragma unroll
    for (int n0 = 0; n0 < KSW; n0 += NG) {
      float tile[NG][4];
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NTK; ++kt) {
        FragB b[NG];
#pragma unroll
        for (int j = 0; j < NG; ++j)
          load_b_pair(b[j], Vw + ((n0 + j) * 8 + g) * T::LDV + 4 * (kt * 4 + t));
        mma_3xtf32([&](int ta, int tb) {
#pragma unroll
          for (int j = 0; j < NG; ++j) mma_tf32(tile[j], pa[kt].x[ta], b[j].x[tb]);
        });
      }
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + j][e] = fmaf(acc[n0 + j][e], c[e >> 1], tile[j][e]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= pixels) continue;
    const float inv = 1.f / lsum[h];
#pragma unroll
    for (int n = 0; n < KSW; ++n) {
      float2* p = reinterpret_cast<float2*>(oh + (size_t)r * D + (cg * KSW + n) * 8 + 2 * t);
      float2 y = make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
      if (accumulate) {
        const float2 x = *p;
        y.x += x.x;
        y.y += x.y;
      }
      *p = y;
    }
  }
}

struct EditArgs {
  const float* q;     // (2B, H, P, D)
  const float* k;     // (2B, H, K, D)
  const float* v;     // (2B, H, K, D)
  const float* v1;    // (E, H, K, D): M diag(c1) v_e
  const float* v2;    // (E, H, K, D): diag(c2) v_e
  const int* flags;   // (E, 2): c1 == 0, c2 == 0 on every key
  float* o;           // (2B, H, P, D)
  int heads, pixels, keys, b_half;
  float scale2;       // scale * log2(e)
};

// grid (query tiles of T::ROWS rows, heads, 2B), NT threads a block. At the
// path head dims registers allow one 8-warp block an SM anyway; without the
// bound's second argument ptxas held D = 16 and 64 to 128 registers, for
// two, and spilled.
template <int D>
__global__ void __launch_bounds__(NT, 1)
edit_attn_kernel(EditArgs a) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * WARPS + warp) / T::WC * 16;
  const size_t qs = (size_t)a.pixels * D, ks = (size_t)a.keys * D;
  const size_t row = (size_t)b * a.heads + h;
  float* oh = a.o + row * qs;
  // Uncond rows and the base row: one pass (q_b, k_b, v_b). An edit row: the
  // base pass (q_B, k_B, V1_e) unless c1 == 0, then its own (q_e, k_e, V2_e)
  // unless c2 == 0, added to the first. One call site keeps the code small.
  const bool edit = b > a.b_half;
  const int e = b - a.b_half - 1;
  const bool base = edit && a.flags[2 * e] == 0;
  const bool own = !edit || a.flags[2 * e + 1] == 0;
  const size_t brow = (size_t)a.b_half * a.heads + h;
  const size_t erow = (size_t)e * a.heads + h;
  const int npass = base + own;
  for (int p = 0; p < npass; ++p) {
    const bool bp = base && p == 0;
    const size_t qk = bp ? brow : row;
    const float* vh = !edit ? a.v + row * ks : (bp ? a.v1 : a.v2) + erow * ks;
    attend<D>(a.q + qk * qs, a.k + qk * ks, vh, oh, r0, a.pixels, a.keys, a.scale2,
              p > 0, smem);
  }
  if (npass == 0) {  // every key's weight is 0
    constexpr int W = D / T::WC;
    for (int i = threadIdx.x & 31; i < 16 * W; i += 32)
      if (r0 + i / W < a.pixels)
        oh[(size_t)(r0 + i / W) * D + warp % T::WC * W + i % W] = 0.f;
  }
}

// The values' type of the fold: f32, or bf16 read and written as four
// values at a time and folded in f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
// Four folded values: f32 as they are; bf16 as hi = bf16(x) at p and
// lo = bf16(x - hi) at the same offset from lo.
__device__ __forceinline__ void store4(float* p, float*, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, bf16* lo, float4 x) {
  const uint2 h = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  *reinterpret_cast<uint2*>(p) = h;
  *reinterpret_cast<uint2*>(lo) =
      make_uint2(pack_bf16(x.x - bf16_lo(h.x), x.y - bf16_hi(h.x)),
                 pack_bf16(x.z - bf16_lo(h.y), x.w - bf16_hi(h.y)));
}

template <class V>
struct FoldArgs {
  const V* v;               // (2B, H, K, D)
  const float* transform;   // (E, Kp, Kp) or null
  const float* refine_mix;  // (E, Kp) or null
  const float* equalizer;   // (E, Kp) or null
  const float* blend;       // (E, Kp)
  V* v1;                    // (E, H, K, D)
  V* v2;                    // (E, H, K, D)
  V* v1lo;                  // bf16: V1's and V2's low parts; f32: null
  V* v2lo;
  int* flags;               // (E, 2)
  int heads, keys, d, kp, b_half;
};

constexpr int FOLD_COLS = 8;
constexpr int FOLD_THREADS = 128;

__host__ __device__ constexpr int ceil4(int x) { return (x + 3) / 4 * 4; }

// grid (D / FOLD_COLS, heads, E): columns [d0, d0 + 8) of V1 and V2 for one
// (edit row, head). V1 = sum_n M[w][n] (c1[n] v[n]) in f32, n in order.
template <class V>
__global__ void __launch_bounds__(FOLD_THREADS) fold_kernel(FoldArgs<V> a) {
  extern __shared__ __align__(16) float fs[];
  const int k4 = ceil4(a.keys);
  float* cv = fs;                  // k4 x FOLD_COLS: c1[n] v[n][d0 + j], 0 past K
  float* c1 = cv + k4 * FOLD_COLS; // keys
  float* c2 = c1 + a.keys;         // keys
  const int d0 = blockIdx.x * FOLD_COLS, h = blockIdx.y, e = blockIdx.z;
  const size_t op = (size_t)e * a.kp;
  int z1 = 1, z2 = 1;
  for (int n = threadIdx.x; n < a.keys; n += FOLD_THREADS) {
    const float ra = a.refine_mix ? a.refine_mix[op + n] : 1.f;
    const float eq = a.equalizer ? a.equalizer[op + n] : 1.f;
    const float al = a.blend[op + n];
    const float x1 = ra * eq * al;
    const float x2 = (1.f - ra) * eq * al + (1.f - al);
    c1[n] = x1;
    c2[n] = x2;
    z1 &= x1 == 0.f;
    z2 &= x2 == 0.f;
  }
  z1 = __syncthreads_and(z1);  // also publishes c1 and c2 to the block
  z2 = __syncthreads_and(z2);
  if (threadIdx.x == 0 && blockIdx.x == 0 && h == 0) {
    a.flags[2 * e] = z1;
    a.flags[2 * e + 1] = z2;
  }
  const V* ve = a.v + ((size_t)(a.b_half + 1 + e) * a.heads + h) * a.keys * a.d + d0;
  const size_t wo = ((size_t)e * a.heads + h) * a.keys * a.d + d0;
  const bool product = a.transform != nullptr && !z1;  // uniform
  auto scaled = [](float c, float4 x) { return make_float4(c * x.x, c * x.y, c * x.z, c * x.w); };
  // Half a row (4 columns) a thread at a time.
  for (int i = threadIdx.x; i < 2 * k4; i += FOLD_THREADS) {
    const int n = i >> 1;
    const size_t at = (size_t)n * a.d + 4 * (i & 1);
    if (n >= a.keys) {  // rows past K: zero, for the float4 reads of M below
      if (product) *reinterpret_cast<float4*>(cv + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float4 x = load4(ve + at);
    if (!z2) store4(a.v2 + wo + at, a.v2lo + wo + at, scaled(c2[n], x));
    if (product)
      *reinterpret_cast<float4*>(cv + 4 * i) = scaled(c1[n], x);
    else if (!z1)
      store4(a.v1 + wo + at, a.v1lo + wo + at, scaled(c1[n], x));
  }
  if (!product) return;
  __syncthreads();
  // A thread a row w of V1: each M[w][n] read feeds its 8 columns; M's rows
  // are zero past K up to their padded stride kp >= k4.
  const float* m = a.transform + (size_t)e * a.kp * a.kp;
  for (int w = threadIdx.x; w < a.keys; w += FOLD_THREADS) {
    const float4* mw = reinterpret_cast<const float4*>(m + (size_t)w * a.kp);
    float acc[FOLD_COLS] = {};
#pragma unroll 4
    for (int n4 = 0; n4 < k4 / 4; ++n4) {
      const float4 m4 = mw[n4];
      const float mn[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4* row = reinterpret_cast<const float4*>(cv + (4 * n4 + u) * FOLD_COLS);
        const float4 x0 = row[0], x1 = row[1];
        acc[0] = fmaf(mn[u], x0.x, acc[0]);
        acc[1] = fmaf(mn[u], x0.y, acc[1]);
        acc[2] = fmaf(mn[u], x0.z, acc[2]);
        acc[3] = fmaf(mn[u], x0.w, acc[3]);
        acc[4] = fmaf(mn[u], x1.x, acc[4]);
        acc[5] = fmaf(mn[u], x1.y, acc[5]);
        acc[6] = fmaf(mn[u], x1.z, acc[6]);
        acc[7] = fmaf(mn[u], x1.w, acc[7]);
      }
    }
    const size_t at = wo + (size_t)w * a.d;
    store4(a.v1 + at, a.v1lo + at, make_float4(acc[0], acc[1], acc[2], acc[3]));
    store4(a.v1 + at + 4, a.v1lo + at + 4, make_float4(acc[4], acc[5], acc[6], acc[7]));
  }
}

// Each kernel may use the largest dynamic shared memory, and the main
// kernel prefers the largest carveout (blocks that fit by registers fit by
// shared memory only under it); set once per device, as it costs host time.
cudaError_t configure(const void* kern, bool carveout, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_LIMIT);
  if (err == cudaSuccess && carveout)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <class V>
int launch_fold(const FoldArgs<V>& f, int edits, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)ceil4(f.keys) * FOLD_COLS + 2 * (size_t)f.keys);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  static unsigned done = 0;
  cudaError_t err = configure(reinterpret_cast<const void*>(fold_kernel<V>), false, done);
  if (err != cudaSuccess) return err;
  fold_kernel<V><<<dim3(f.d / FOLD_COLS, f.heads, edits), FOLD_THREADS, smem, s>>>(f);
  return cudaGetLastError();
}

template <int D>
int launch_attn(const EditArgs& a, int two_b, cudaStream_t s) {
  using T = Tile<D>;
  static_assert(T::smem() <= SMEM_LIMIT, "shared memory");
  static unsigned done = 0;
  cudaError_t err = configure(reinterpret_cast<const void*>(edit_attn_kernel<D>), true, done);
  if (err != cudaSuccess) return err;
  dim3 grid((a.pixels + T::ROWS - 1) / T::ROWS, a.heads, two_b);
  edit_attn_kernel<D><<<grid, NT, T::smem(), s>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

struct EditArgsBf16 {
  const bf16* q;      // (2B, H, P, D)
  const bf16* k;      // (2B, H, K, D)
  const bf16* v;      // (2B, H, K, D)
  const bf16* v1;     // (E, H, K, D): M diag(c1) v_e, high parts
  const bf16* v2;     // (E, H, K, D): diag(c2) v_e, high parts
  const bf16* v1lo;   // their low parts
  const bf16* v2lo;
  const int* flags;   // (E, 2): c1 == 0, c2 == 0 on every key
  bf16* o;            // (2B, H, P, D)
  int heads, pixels, keys, b_half;
  float scale2;       // scale * log2(e)
};

// Keys a step of the bf16 passes at head dim D.
template <int D>
struct TileBf16 {
  static constexpr int BS = D <= 80 ? 80 : 64;
  using A = AttnBf16<D, BS, WARPS, true>;
};

// grid (query tiles of 128 rows, heads, 2B), NT threads: the rows' passes
// as edit_attn_kernel chooses them.
template <int D>
__global__ void __launch_bounds__(NT, 1)
edit_attn_bf16_kernel(EditArgsBf16 a) {
  using A = typename TileBf16<D>::A;
  extern __shared__ __align__(16) unsigned char smem_eb[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * A::ROWS;
  const size_t qs = (size_t)a.pixels * D, ks = (size_t)a.keys * D;
  const size_t row = (size_t)b * a.heads + h;
  bf16* oh = a.o + row * qs;
  const bool edit = b > a.b_half;
  const int e = b - a.b_half - 1;
  const bool base = edit && a.flags[2 * e] == 0;
  const bool own = !edit || a.flags[2 * e + 1] == 0;
  const size_t brow = (size_t)a.b_half * a.heads + h;
  const size_t erow = (size_t)e * a.heads + h;
  const int npass = base + own;
  for (int p = 0; p < npass; ++p) {
    const bool bp = base && p == 0;
    const size_t qk = bp ? brow : row;
    const bf16* vh = !edit ? a.v + row * ks : (bp ? a.v1 : a.v2) + erow * ks;
    const bf16* vl = !edit ? nullptr : (bp ? a.v1lo : a.v2lo) + erow * ks;
    attend_bf16<D, TileBf16<D>::BS, WARPS, true>(a.q + qk * qs, a.k + qk * ks, vh, vl, oh,
                                                 q0, a.pixels, a.keys, a.scale2, p > 0,
                                                 reinterpret_cast<bf16*>(smem_eb));
  }
  if (npass == 0) {  // every key's weight is 0
    for (int i = threadIdx.x; i < A::ROWS * D; i += NT)
      if (q0 + i / D < a.pixels) oh[(size_t)(q0 + i / D) * D + i % D] = __float2bfloat16(0.f);
  }
}

template <int D>
int launch_attn_bf16(const EditArgsBf16& a, int two_b, cudaStream_t s) {
  using A = typename TileBf16<D>::A;
  static_assert(A::SMEM <= SMEM_LIMIT, "shared memory");
  static unsigned done = 0;
  cudaError_t err =
      configure(reinterpret_cast<const void*>(edit_attn_bf16_kernel<D>), true, done);
  if (err != cudaSuccess) return err;
  dim3 grid((a.pixels + A::ROWS - 1) / A::ROWS, a.heads, two_b);
  edit_attn_bf16_kernel<D><<<grid, NT, A::SMEM, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (2B, H, P, D); k, v (2B, H, K, D); operands with row stride kp; out like
// q; v1, v2 (E, H, K, D) and flags (E, 2) int32 the fold's workspace, E =
// B - 1. All contiguous f32; transform / refine_mix / equalizer may be null.
// Launches the fold, then the main kernel. Returns a cudaError_t (0 on
// success).
extern "C" int p2p_fused_edit_fwd(const float* q, const float* k, const float* v,
                                  const float* transform, const float* refine_mix,
                                  const float* equalizer, const float* blend,
                                  float* o, float* v1, float* v2, int* flags,
                                  int two_b, int heads, int pixels, int keys,
                                  int d, int kp, float scale,
                                  void* stream) {
  const int b_half = two_b / 2;
  if (b_half < 2 || d % FOLD_COLS != 0 || keys < 1 || ceil4(keys) > kp || kp % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FoldArgs<float> f{v, transform, refine_mix, equalizer, blend, v1, v2, nullptr,
                          nullptr, flags, heads, keys, d, kp, b_half};
  int err = launch_fold(f, b_half - 1, s);
  if (err != cudaSuccess) return err;
  const EditArgs a{q, k, v, v1, v2, flags, o, heads, pixels, keys, b_half,
                   scale * LOG2E};
  switch (d) {
    case 16: return launch_attn<16>(a, two_b, s);
    case 32: return launch_attn<32>(a, two_b, s);
    case 40: return launch_attn<40>(a, two_b, s);
    case 64: return launch_attn<64>(a, two_b, s);
    case 80: return launch_attn<80>(a, two_b, s);
    case 160: return launch_attn<160>(a, two_b, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 entry: q, k, v and out bf16; v1, v2, v1lo and v2lo bf16 (E, H,
// K, D), the fold's V1 and V2 as hi/lo pairs; everything else as above.
extern "C" int p2p_fused_edit_fwd_bf16(const void* q, const void* k, const void* v,
                                       const float* transform, const float* refine_mix,
                                       const float* equalizer, const float* blend,
                                       void* o, void* v1, void* v2, void* v1lo,
                                       void* v2lo, int* flags,
                                       int two_b, int heads, int pixels, int keys,
                                       int d, int kp, float scale, void* stream) {
  const int b_half = two_b / 2;
  if (b_half < 2 || d % FOLD_COLS != 0 || keys < 1 || ceil4(keys) > kp || kp % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FoldArgs<bf16> f{static_cast<const bf16*>(v), transform, refine_mix, equalizer,
                         blend, static_cast<bf16*>(v1), static_cast<bf16*>(v2),
                         static_cast<bf16*>(v1lo), static_cast<bf16*>(v2lo), flags,
                         heads, keys, d, kp, b_half};
  int err = launch_fold(f, b_half - 1, s);
  if (err != cudaSuccess) return err;
  const EditArgsBf16 a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(v1),
                       static_cast<const bf16*>(v2), static_cast<const bf16*>(v1lo),
                       static_cast<const bf16*>(v2lo), flags, static_cast<bf16*>(o),
                       heads, pixels, keys, b_half, scale * LOG2E};
  switch (d) {
    case 16: return launch_attn_bf16<16>(a, two_b, s);
    case 32: return launch_attn_bf16<32>(a, two_b, s);
    case 40: return launch_attn_bf16<40>(a, two_b, s);
    case 64: return launch_attn_bf16<64>(a, two_b, s);
    case 80: return launch_attn_bf16<80>(a, two_b, s);
    case 160: return launch_attn_bf16<160>(a, two_b, s);
    default: return cudaErrorInvalidValue;
  }
}

// The message of a CUDA error code, for the Python wrapper.
extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
