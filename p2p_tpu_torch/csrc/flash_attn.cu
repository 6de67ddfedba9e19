// K1 and K3: flash attention forward, non-causal, unmasked, f32 in and out.
//
// K1 replaces the JAX package's `flash_attention_tpu` (p2p_tpu/models/nn.py:330),
// the library Pallas TPU kernel behind `nn.fused_attention`. On the main path
// it runs at the U-Net's 64x64-pixel self-attention sites, q/k/v
// (4, 8, 4096, 40), and at the VAE decoder's mid attention, (2, 1, 4096, 512);
// the null-text inversion also runs it at (1, 8, 4096, 40) and, in the VAE
// encode and decode, at (1, 1, 4096, 512).
// K3 replaces `flash_attention_residuals` (p2p_tpu/models/nn.py:343), the same
// Pallas kernel with `save_residuals=True`, which is also its forward rule
// under differentiation: the same kernel, asked with non-null `m` and `l`,
// also writes each row's final max m and sum l = sum_j exp(s_j - m), the
// residuals the backward (flash_attn_bwd.cu) recomputes probabilities from.
// On the null-text inversion path it runs at (1, 8, 4096, 40).
//
// Every kernel streams the keys and values tile by tile with an online
// softmax (running row max m and sum l, the output rescaled by exp(m_old -
// m_new) when the max moves) and divides by l once at the end, so the
// (S, S) scores never exist outside a tile. Three kernels behind one entry
// point:
//
// flash_d40_kernel (d = 40, K1 and K3 on the paths), on the tensor cores in
// 3xTF32 (mma_tf32.cuh): f32 accuracy at three TF32 products per product.
// Bound: 4*S^2*d flops per head against 4*S*d*4 bytes, some 1000 flops a
// byte, so operations bound it: 3 * 4*S^2*d at 495 TFLOP/s, 0.52 ms at
// (4, 8, 4096, 40). FlashAttention-2's layout: each warp owns 16 query rows
// and all the keys of a step, so the row max and sum reduce within a quad of
// lanes by shuffles, and P never leaves registers: the C fragments of
// S = Q K^T are the A fragments of O += P V. Q is read once, scaled by
// scale * log2(e) and split into its TF32 parts in registers (40 a thread).
// K and V land by cp.async, 128 keys at a time, while the previous tile
// computes; the block then splits each landed tile once into a packed hi/lo
// copy (K key-major, V transposed; split_pair) from which every warp reads a
// whole split B fragment in one conflict-free 16-byte load. The softmax is
// 2^x of pre-scaled scores (one MUFU.EX2 each); K3's m is converted back to
// natural units. Each 64-key step's P V is taken in a fresh accumulator and
// added in f32 (the tensor cores' accumulation rounds toward zero).
// Eight warps (128 query rows) a block, 247 registers a thread and 122 KB of
// shared memory: one block an SM. The split is work for the whole block, so
// eight warps share it; two 4-warp blocks an SM (64 query rows each) ran
// slower.
//
// flash_fwd_kernel (d = 80, 160; no path runs them), f32 on the CUDA
// cores: one block owns BQ query rows of one (batch, head) and streams K
// and V through one shared buffer, BK rows at a time; register tiles of
// rows x keys and rows x columns let each operand read from shared memory
// feed several FMAs. Bound by the CUDA cores' f32 rate (67 TFLOP/s).
//
// flash_d512_kernel (d = 512, f32), on the tensor cores in 3xTF32, bound by
// 3 * 4*S^2*d flops per head at 495 TFLOP/s. A 64-row query tile (132 KB)
// stays in shared memory; K and V pass through a ring of three 17 KB slots
// filled by cp.async two chunks ahead of the compute: per 64-key tile,
// eight K chunks of 64 keys x 64 dims (S = Q K^T accumulates over them) and
// eight V chunks of 8 keys x 512 dims (O += P V, one k-step each). Eight
// warps: for S each owns 32 rows x 16 keys; for O each owns all 64 rows x 64
// of the 512 columns (128 accumulators a thread). The softmax step writes P
// to shared memory already split into its TF32 parts, so the eight warps
// that read it do not split it again. Each chunk's product is taken in a
// fresh accumulator and added to the running S and O in f32: summed over
// all 4096 keys in one accumulator, the round-toward-zero bias reached 5e-6
// on outputs of magnitude 0.1. One block fills an SM, so when the query
// tiles leave SMs idle (too few for one round, as (1, 1, 4096, 512)'s 64,
// or a short last round, as (1, 1, 9216, 512)'s 144 blocks on 132 SMs) the
// keys are split among gridDim.z blocks: each writes its unnormalized
// partial output with its row max and sum, and flash_merge_kernel
// (flash_merge.cuh, shared with the bf16 kernel) combines them in a fixed
// order. The wrapper (p2p_tpu_torch/kernels/flash.py: key_splits) picks
// the split and allocates the partials.
//
// K1 and K3 in f32 at d = 64 (SD-2.1's self sites) are not here: they run
// in 3xTF32 on tf32 wgmma and TMA in flash_fwd_tf32_sm90.cu (library
// flash_fwd_tf32_sm90, entry p2p_flash_attn_fwd_f32_sm90). K1 and K3 in bf16
// are not here either: they run on wgmma and TMA in flash_fwd_sm90.cu, at
// d = 40 and 64 (flash_fwd_sm90_kernel<DH>) and at d = 512
// (flash_d512_sm90_kernel).
//
// No kernel here uses atomics: two launches give the same bits.
#include "attn_tile.cuh"
#include "flash_merge.cuh"  // flash_merge_kernel, MergeParts, launch_flash_merge
#include "mma_tf32.cuh"

using namespace p2p;

namespace {

template <int D, int BQ, int BK, int TRS, int TRO>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int sq,
                 int sk, float scale) {
  constexpr int LDQ = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int TPR = kThreads / BQ;  // threads per row in the softmax
  static_assert(kThreads % BQ == 0 && TPR <= 32, "softmax row layout");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * LDQ;
  float* Ss = KVs + BK * LDQ;
  float* m_s = Ss + BQ * LDS;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int q0 = blockIdx.x * BQ;

  load_rows<D>(Qs, LDQ, qb, q0, BQ, sq);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  OutTile<D, BQ, TRO> out;
  out.zero();
  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    const int valid = min(BK, sk - k0);
    load_rows<D>(KVs, LDQ, kb, k0, BK, sk);
    __syncthreads();
    score_tile<D, BQ, BK, TRS>(Qs, LDQ, KVs, LDQ, Ss, LDS, scale, valid);
    __syncthreads();
    // The V tile replaces the K tile while the rows take their softmax step.
    load_rows<D>(KVs, LDQ, vb, k0, BK, sk);
    float mx = -INFINITY;
    for (int j = sub; j < BK; j += TPR) mx = fmaxf(mx, Ss[r * LDS + j]);
    mx = row_max<TPR>(mx);
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = sub; j < BK; j += TPR) {
      const float p = expf(Ss[r * LDS + j] - m_new);  // -inf columns give 0
      Ss[r * LDS + j] = p;
      sum += p;
    }
    sum = row_sum<TPR>(sum);
    __syncwarp();
    if (sub == 0) {
      const float c = expf(m_old - m_new);
      m_s[r] = m_new;
      l_s[r] = l_s[r] * c + sum;
      c_s[r] = c;
    }
    __syncthreads();
    out.template accumulate<BK, true>(Ss, LDS, KVs, LDQ, c_s);
    __syncthreads();
  }
  out.store(o + bh * sq * D, q0, sq, l_s);
  if (m_out != nullptr) {
    for (int i = threadIdx.x; i < BQ && q0 + i < sq; i += kThreads) {
      m_out[bh * sq + q0 + i] = m_s[i];
      l_out[bh * sq + q0 + i] = l_s[i];
    }
  }
}

template <int D, int BQ, int BK, int TRS, int TRO>
int launch(const float* q, const float* k, const float* v, float* o, float* m,
           float* l, int bh, int sq, int sk, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((BQ + BK) * (D + 1) + BQ * (BK + 1) + 3 * BQ);
  auto kern = flash_fwd_kernel<D, BQ, BK, TRS, TRO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, m, l, sq, sk, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- d = 40

namespace d40 {
constexpr int D = 40;
constexpr int NW = 8;                 // warps a block, 16 query rows each
constexpr int NT = NW * 32;
constexpr int BQ = NW * 16;           // query rows per block
constexpr int BK = 128;               // keys per landed tile
constexpr int BS = 64;                // keys per online-softmax step
constexpr int KS = D / 8;             // k-steps of S = Q K^T; n-tiles of O
constexpr int NTK = BS / 8;           // n-tiles of S; k-steps of O += P V
constexpr int LDK = D;                // landed K tile: row stride
constexpr int LDV = D + 4;            // landed V tile: 44, column reads conflict-free
constexpr int LDKX = 2 * D;           // split K, key-major: 80 (ld % 32 == 16)
constexpr int LDVX = 2 * BK;          // split V^T, dim-major: 256, chunks swizzled
constexpr size_t SMEM =
    sizeof(float) * (BK * LDK + BK * LDV + BK * LDKX + D * LDVX);
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(BK % BS == 0 && BS % 8 == 0, "d = 40 warp layout");
static_assert(SMEM <= 232448, "d = 40 tile exceeds shared memory");

// 16-byte chunk j of split V^T row d: the chunks of odd rows are swapped
// in halves, so the two rows a quarter-warp reads fall in different banks.
__device__ __forceinline__ int vx_chunk(int d, int j) { return j ^ ((d & 1) << 2); }

// Split the landed K and V tiles once for every warp: K into Kx[key][ks *
// 16 + 4t] = split_pair(K[key][8 ks + 2t], K[key][8 ks + 2t + 1]), V
// transposed into Vx[d][4 vx_chunk(d, j)] = split_pair(V[2j][d],
// V[2j + 1][d]). A thread then reads each B fragment of S = Q K^T and of
// O += P V as one 16-byte load, with no bank conflicts.
__device__ __forceinline__ void split_kv(const float* Kr, const float* Vr,
                                         float* Kx, float* Vx) {
  constexpr int P = D / 2;  // pairs a key
  for (int i = threadIdx.x; i < BK * P; i += NT) {
    const int n = i / P, c = i % P;
    const float2 x = *reinterpret_cast<const float2*>(Kr + n * LDK + 2 * c);
    *reinterpret_cast<uint4*>(Kx + n * LDKX + 4 * c) = split_pair(x.x, x.y);
  }
  // A warp takes 4 key pairs x 8 dims at a time (lane = 4 dim + pair).
  for (int i = threadIdx.x; i < BK / 2 * D; i += NT) {
    const int lane = i & 31, u = i >> 5;
    const int j = (u % (BK / 8)) * 4 + (lane & 3);
    const int d = (u / (BK / 8)) * 8 + (lane >> 2);
    *reinterpret_cast<uint4*>(Vx + d * LDVX + 4 * vx_chunk(d, j)) =
        split_pair(Vr[2 * j * LDV + d], Vr[(2 * j + 1) * LDV + d]);
  }
}
}  // namespace d40

// grid (query tiles of BQ rows, bh), NT threads; scale2 = scale * log2(e).
// Warp w owns query rows q0 + 16 w + [0, 16) and, for each 64-key tile,
// all of its keys: the row max and sum reduce within a quad of lanes.
__global__ void __launch_bounds__(d40::NT, 1)  // one block an SM
flash_d40_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int sq,
                 int sk, float scale2) {
  using namespace d40;
  extern __shared__ float smem[];
  float* Kr = smem;                 // the landed tile, as copied
  float* Vr = Kr + BK * LDK;
  float* Kx = Vr + BK * LDV;        // the split tile the warps read
  float* Vx = Kx + BK * LDKX;

  const int bh = blockIdx.y;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16;

  // The first tile's copy is in flight while Q is read.
  cp_async_rows<D, D, LDK, BK, NT>(Kr, kb, 0, sk);
  cp_async_rows<D, D, LDV, BK, NT>(Vr, vb, 0, sk);
  cp_async_commit();

  // Q * scale2 as the A fragments of the 5 k-steps, split once and kept in
  // registers, in the k order of split_pair: k = t <-> dim 8 ks + 2t,
  // k = t + 4 <-> dim 8 ks + 2t + 1. Rows past sq read as zero.
  FragA qa[KS];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const float* qr = q + ((size_t)bh * sq + r) * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 x = r < sq ? *reinterpret_cast<const float2*>(qr + ks * 8 + 2 * t)
                              : make_float2(0.f, 0.f);
      qa[ks].set(h, x.x * scale2);
      qa[ks].set(2 + h, x.y * scale2);
    }
  }

  // Rows g (e = 0, 1) and g + 8 (e = 2, 3): running max in log2 units and
  // this thread's share of the running sum (summed over the quad at the end).
  float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nk = (sk + BK - 1) / BK;
  for (int it = 0; it < nk; ++it) {
    const int key0 = it * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    split_kv(Kr, Vr, Kx, Vx);
    __syncthreads();  // split tile ready; the landing buffers are free
    if (it + 1 < nk) {
      cp_async_rows<D, D, LDK, BK, NT>(Kr, kb, key0 + BK, sk);
      cp_async_rows<D, D, LDV, BK, NT>(Vr, vb, key0 + BK, sk);
    }
    cp_async_commit();

#pragma unroll
    for (int k1 = 0; k1 < BK; k1 += BS) {
      // s = (Q scale2) K^T over the step's BS keys, in a fresh accumulator.
      float s[NTK][4];
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        FragB b[NTK];
#pragma unroll
        for (int n = 0; n < NTK; ++n)
          load_b_pair(b[n], Kx + (k1 + n * 8 + g) * LDKX + ks * 16 + 4 * t);
        mma_3xtf32([&](int ta, int tb) {
#pragma unroll
          for (int n = 0; n < NTK; ++n) mma_tf32(s[n], qa[ks].x[ta], b[n].x[tb]);
        });
      }
      if (key0 + k1 + BS > sk) {  // keys past sk score -inf
#pragma unroll
        for (int n = 0; n < NTK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + k1 + n * 8 + 2 * t + (e & 1) >= sk) s[n][e] = -INFINITY;
      }

      // Online softmax in registers, base 2: p = exp2(s - m2).
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
        c[h] = exp2_ftz(m2[h] - mx[h]);  // 0 on the first tile
        m2[h] = mx[h];
      }
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_ftz(s[n][e] - m2[e >> 1]);  // -inf gives 0
          ps[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) lsum[h] = lsum[h] * c[h] + ps[h];

      // O = O c + P V: each n-tile of P's C fragments is the A fragment of
      // one k-step (a_from_c), split in registers; the step's product is
      // taken in a fresh accumulator and added in f32 (the tensor cores'
      // accumulation rounds toward zero).
      float tile[KS][4];
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[n][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NTK; ++kt) {
        FragA a;
        a_from_c(a, s[kt]);
        FragB b[KS];
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          const int d = n * 8 + g;
          load_b_pair(b[n], Vx + d * LDVX + 4 * vx_chunk(d, (k1 / 8 + kt) * 4 + t));
        }
        mma_3xtf32([&](int ta, int tb) {
#pragma unroll
          for (int n = 0; n < KS; ++n) mma_tf32(tile[n], a.x[ta], b[n].x[tb]);
        });
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], c[e >> 1], tile[n][e]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  float* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= sq) continue;
    const float inv = 1.f / lsum[h];
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(ob + (size_t)r * D + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    // K3's residuals in natural units: m = m2 / log2(e), l = sum exp(s - m).
    if (m_out != nullptr && t == 0) {
      m_out[(size_t)bh * sq + r] = m2[h] * LN2;
      l_out[(size_t)bh * sq + r] = lsum[h];
    }
  }
}

cudaError_t d40_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_d40_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d40::SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_d40_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int launch_d40(const float* q, const float* k, const float* v, float* o, float* m,
               float* l, int bh, int sq, int sk, float scale, cudaStream_t stream) {
  cudaError_t err = d40_attributes();
  if (err != cudaSuccess) return err;
  dim3 grid((sq + d40::BQ - 1) / d40::BQ, bh);
  flash_d40_kernel<<<grid, d40::NT, d40::SMEM, stream>>>(q, k, v, o, m, l, sq, sk,
                                                         scale * d40::LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- d = 512

namespace d512 {
constexpr int D = 512;
constexpr int BQ = 64, BK = 64;       // query rows per block, keys per tile
constexpr int NT = 256;               // eight warps
constexpr int WARPS = NT / 32;
constexpr int SWR = 2;                // S: warps along rows (x WARPS / SWR along keys)
constexpr int SMT = BQ / SWR / 16;    // S: m-tiles of 16 rows per warp
constexpr int SNT = BK / (WARPS / SWR) / 8;  // S: n-tiles of 8 keys per warp
constexpr int ONT = D / WARPS / 8;    // O: n-tiles of 8 columns per warp
constexpr int OMT = BQ / 16;          // O: m-tiles (every row)
constexpr int DC = 64;                // dims per K chunk
constexpr int VR = 8;                 // keys per V chunk
constexpr int NKC = D / DC, NVC = BK / VR, CHUNKS = NKC + NVC;
constexpr int STAGES = 3;
constexpr int LDQ = D + 4;            // A fragments: ld % 8 == 4
constexpr int LDK = DC + 4;           // B = K^T fragments: ld % 8 == 4
constexpr int LDV = D + 8;            // B = V fragments: ld % 16 == 8
constexpr int LDP = BK + 4;           // A = P fragments: ld % 8 == 4
constexpr int SLOT = BK * LDK > VR * LDV ? BK * LDK : VR * LDV;
constexpr size_t SMEM =
    sizeof(float) * (BQ * LDQ + STAGES * SLOT + 2 * BQ * LDP + 3 * BQ);
static_assert(SMEM <= 232448, "d = 512 tile exceeds shared memory");
static_assert(SMT >= 1 && SNT >= 1 && ONT % 2 == 0 && NT % BQ == 0, "warp layout");

// Chunk c of this block's key range into a ring slot: K chunk (c % CHUNKS) <
// NKC holds keys [key0, key0 + BK) x dims [part * DC, + DC); a V chunk holds
// keys [key0 + (part - NKC) * VR, + VR) x all D dims. Keys at or past kend
// are zero-filled.
__device__ __forceinline__ void load_chunk(float* slot, const float* kb,
                                           const float* vb, int c, int kbeg,
                                           int kend) {
  const int part = c % CHUNKS;
  const int key0 = kbeg + (c / CHUNKS) * BK;
  if (part < NKC)
    cp_async_rows<DC, D, LDK, BK, NT>(slot, kb + part * DC, key0, kend);
  else
    cp_async_rows<D, D, LDV, VR, NT>(slot, vb, key0 + (part - NKC) * VR, kend);
}
}  // namespace d512

// grid (query tiles, bh, key splits), 256 threads. With one split, out is o
// (normalized) and m_out/l_out the optional residuals; with several, out,
// m_out and l_out are this split's slices of the partials (bh * sq rows per
// split): the unnormalized output, the row max and the row sum.
__global__ void __launch_bounds__(d512::NT, 1)
flash_d512_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int sq,
                  int sk, float scale) {
  using namespace d512;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* ring = Qs + BQ * LDQ;
  float* Ps = ring + STAGES * SLOT;
  float* Pl = Ps + BQ * LDP;
  float* m_s = Pl + BQ * LDP;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int bh = blockIdx.y, nsplit = gridDim.z, split = blockIdx.z;
  const float* qb = q + (size_t)bh * sq * D;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;
  const int q0 = blockIdx.x * BQ;
  const int ktiles = (sk + BK - 1) / BK;
  const int kbeg = (split * ktiles / nsplit) * BK;
  const int kend = min(((split + 1) * ktiles / nsplit) * BK, sk);
  const int nchunks = (kend - kbeg + BK - 1) / BK * CHUNKS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // Q joins the first chunk's copy group.
  cp_async_rows<D, D, LDQ, BQ, NT>(Qs, qb, q0, sq);
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) load_chunk(ring + c * SLOT, kb, vb, c, kbeg, kend);
    cp_async_commit();
  }
  for (int r = threadIdx.x; r < BQ; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // S: warp owns rows sr0 + [0, 16 SMT) and keys sc0 + [0, 8 SNT).
  const int sr0 = warp / (WARPS / SWR) * SMT * 16;
  const int sc0 = warp % (WARPS / SWR) * SNT * 8;
  float sacc[SMT][SNT][4];
  // O: warp owns all BQ rows and columns oc0 + [0, 8 ONT).
  const int oc0 = warp * ONT * 8;
  float oacc[OMT][ONT][4];
#pragma unroll
  for (int i = 0; i < SMT; ++i)
#pragma unroll
    for (int j = 0; j < SNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < OMT; ++i)
#pragma unroll
    for (int j = 0; j < ONT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][j][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is in; slot (c - 1) % STAGES is free
    if (c + STAGES - 1 < nchunks)
      load_chunk(ring + ((c + STAGES - 1) % STAGES) * SLOT, kb, vb, c + STAGES - 1,
                 kbeg, kend);
    cp_async_commit();
    const float* slot = ring + (c % STAGES) * SLOT;
    const int part = c % CHUNKS;
    if (part < NKC) {
      // The chunk's product in its own accumulator, added to sacc in f32
      // (the tensor cores' accumulation rounds toward zero).
      float tacc[SMT][SNT][4];
#pragma unroll
      for (int i = 0; i < SMT; ++i)
#pragma unroll
        for (int j = 0; j < SNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[i][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DC / 8; ++ks) {
        FragA a[SMT];
        FragB b[SNT];
#pragma unroll
        for (int i = 0; i < SMT; ++i)
          load_a(a[i], Raw{Qs + (sr0 + i * 16) * LDQ + part * DC + ks * 8}, LDQ);
#pragma unroll
        for (int j = 0; j < SNT; ++j)
          load_bt(b[j], Raw{slot + (sc0 + j * 8) * LDK + ks * 8}, LDK);
        mma_3xtf32([&](int ta, int tb) {
#pragma unroll
          for (int i = 0; i < SMT; ++i)
#pragma unroll
            for (int j = 0; j < SNT; ++j) mma_tf32(tacc[i][j], a[i].x[ta], b[j].x[tb]);
        });
      }
#pragma unroll
      for (int i = 0; i < SMT; ++i)
#pragma unroll
        for (int j = 0; j < SNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[i][j][e] += tacc[i][j][e];
      if (part == NKC - 1) {
        // Scores to shared memory (scaled; keys past kend at -inf), then one
        // online-softmax step per row, NT / BQ threads a row.
        const int key0 = kbeg + (c / CHUNKS) * BK;
#pragma unroll
        for (int i = 0; i < SMT; ++i)
#pragma unroll
          for (int j = 0; j < SNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = sr0 + i * 16 + g + (e >> 1) * 8;
              const int col = sc0 + j * 8 + 2 * t + (e & 1);
              Ps[r * LDP + col] =
                  key0 + col < kend ? sacc[i][j][e] * scale : -INFINITY;
              sacc[i][j][e] = 0.f;
            }
        __syncthreads();
        constexpr int TPR = NT / BQ;  // threads per row
        const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
        float mx = -INFINITY;
#pragma unroll
        for (int j = sub; j < BK; j += TPR) mx = fmaxf(mx, Ps[r * LDP + j]);
        mx = row_max<TPR>(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int j = sub; j < BK; j += TPR) {
          const float p = expf(Ps[r * LDP + j] - m_new);
          uint32_t ph, pl;
          split_tf32(p, ph, pl);
          Ps[r * LDP + j] = __uint_as_float(ph);
          Pl[r * LDP + j] = __uint_as_float(pl);
          sum += p;
        }
        sum = row_sum<TPR>(sum);
        __syncwarp();
        if (sub == 0) {
          const float cr = expf(m_old - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * cr + sum;
          c_s[r] = cr;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < OMT; ++i) {
          const float c0 = c_s[i * 16 + g], c1 = c_s[i * 16 + g + 8];
#pragma unroll
          for (int j = 0; j < ONT; ++j) {
            oacc[i][j][0] *= c0;
            oacc[i][j][1] *= c0;
            oacc[i][j][2] *= c1;
            oacc[i][j][3] *= c1;
          }
        }
      }
    } else {
      // O += P[:, keys of this chunk] V_chunk: one k-step of 8 keys.
      const int kc = (part - NKC) * VR;
      FragA a[OMT];
#pragma unroll
      for (int i = 0; i < OMT; ++i) load_a(a[i], Split{Ps + i * 16 * LDP + kc, Pl + i * 16 * LDP + kc}, LDP);
#pragma unroll
      for (int j = 0; j < ONT; j += 2) {
        FragB b[2];
        load_b(b[0], Raw{slot + oc0 + j * 8}, LDV);
        load_b(b[1], Raw{slot + oc0 + j * 8 + 8}, LDV);
        float tile[OMT][2][4];
#pragma unroll
        for (int i = 0; i < OMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) tile[i][h][e] = 0.f;
        mma_3xtf32([&](int ta, int tb) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < OMT; ++i) mma_tf32(tile[i][h], a[i].x[ta], b[h].x[tb]);
        });
#pragma unroll
        for (int i = 0; i < OMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) oacc[i][j + h][e] += tile[i][h][e];
      }
    }
  }
  cp_async_wait<0>();

  const bool merged = nsplit > 1;
  float* ob = out + ((size_t)split * gridDim.y + bh) * sq * D;
#pragma unroll
  for (int i = 0; i < OMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + h * 8;
      if (q0 + r >= sq) continue;
      const float inv = merged ? 1.f : 1.f / l_s[r];
#pragma unroll
      for (int j = 0; j < ONT; ++j)
        *reinterpret_cast<float2*>(ob + (size_t)(q0 + r) * D + oc0 + j * 8 + 2 * t) =
            make_float2(oacc[i][j][2 * h] * inv, oacc[i][j][2 * h + 1] * inv);
    }
  if (m_out != nullptr) {
    const size_t base = ((size_t)split * gridDim.y + bh) * sq;
    for (int i = threadIdx.x; i < BQ && q0 + i < sq; i += NT) {
      m_out[base + q0 + i] = m_s[i];
      l_out[base + q0 + i] = l_s[i];
    }
  }
}

int launch_d512(const float* q, const float* k, const float* v, float* o,
                float* m, float* l, float* part, int nsplit, int bh, int sq,
                int sk, float scale, cudaStream_t stream) {
  const int ktiles = (sk + d512::BK - 1) / d512::BK;
  if (nsplit < 1 || nsplit > ktiles || (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)d512::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + d512::BQ - 1) / d512::BQ, bh, nsplit);
  const size_t rows = (size_t)bh * sq;
  const MergeParts p(part, nsplit, rows);
  flash_d512_kernel<<<grid, d512::NT, d512::SMEM, stream>>>(
      q, k, v, nsplit > 1 ? p.po : o, nsplit > 1 ? p.pm : m, nsplit > 1 ? p.pl : l, sq, sk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_flash_merge<float>(p, nsplit, rows, o, m, l, stream);
}

}  // namespace

// What p2p_flash_attn_fwd returns at d = 64 (not a cudaError_t): f32 at d =
// 64 runs in library flash_fwd_tf32_sm90 (flash_fwd_tf32_sm90.cu).
constexpr int kD64Elsewhere = 1064;

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), all contiguous f32.
// m and l: (bh, sq) f32, both null (K1) or both non-null (K3: the row max
// and row sum are written too). nsplit: key splits, 1 unless d = 512; with
// more, part is f32 scratch of nsplit * bh * sq * (d + 2) values. Returns a
// cudaError_t (0 on success).
extern "C" int p2p_flash_attn_fwd(const float* q, const float* k, const float* v,
                                  float* o, float* m, float* l, float* part,
                                  int nsplit, int bh, int sq, int sk, int d,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 512)
    return launch_d512(q, k, v, o, m, l, part, nsplit, bh, sq, sk, scale, s);
  if (nsplit != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 40:
      return launch_d40(q, k, v, o, m, l, bh, sq, sk, scale, s);
    case 64:
      return kD64Elsewhere;
    case 80:
      return launch<80, 64, 64, 16, 8>(q, k, v, o, m, l, bh, sq, sk, scale, s);
    case 160:
      return launch<160, 64, 32, 16, 4>(q, k, v, o, m, l, bh, sq, sk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The message of an error code of this library, for the Python wrappers.
extern "C" const char* p2p_cuda_error_string(int code) {
  if (code == kD64Elsewhere)
    return "f32 at d = 64 runs in library flash_fwd_tf32_sm90 (p2p_flash_attn_fwd_f32_sm90)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of the d = 40 kernel resident on one SM (its occupancy), and its
// warps a block through *warps; a negative cudaError_t on failure.
extern "C" int p2p_flash_attn_d40_occupancy(int* warps) {
  cudaError_t err = d40_attributes();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_d40_kernel,
                                                        d40::NT, d40::SMEM);
  if (err != cudaSuccess) return -(int)err;
  *warps = d40::NW;
  return blocks;
}
