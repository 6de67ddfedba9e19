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
// Two kernels behind one entry point:
//
// flash_fwd_kernel (d = 40, 64, 80, 160), f32 on the CUDA cores. One block
// owns BQ query rows of one (batch, head). It streams the keys and values
// through shared memory BK rows at a time with an online softmax (running
// row max m and sum l, the output rescaled by exp(m_old - m_new) when the
// max moves) and divides by l once at the end, so the (S, S) scores never
// exist outside a BQ x BK tile. A K tile and a V tile share one buffer.
// Bound: at d = 40 the work is 4*S^2*d flops against 4*S*d*4 bytes per head,
// some 1000 flops a byte, so it is bound by the f32 rate of the CUDA cores
// (about 67 TFLOP/s on an H100 SXM). Register tiles of rows x keys and rows x
// columns let each operand read from shared memory feed several FMAs.
//
// flash_d512_kernel (d = 512), on the tensor cores in 3xTF32 (mma_tf32.cuh):
// f32 accuracy at three TF32 products per product, bound by those products
// (3 * 4*S^2*d flops per head at 495 TFLOP/s). A 64-row query tile (132 KB)
// stays in shared memory; K and V pass through a ring of three 17 KB slots
// filled by cp.async two chunks ahead of the compute: per 64-key tile,
// eight K chunks of 64 keys x 64 dims (S = Q K^T accumulates over them) and
// eight V chunks of 8 keys x 512 dims (O += P V, one k-step each). Eight
// warps: for S each owns 32 rows x 16 keys; for O each owns all 64 rows x 64
// of the 512 columns (128 accumulators a thread). The softmax step writes P
// to shared memory already split into its TF32 parts, so the eight warps
// that read it do not split it again. The tensor cores' accumulation rounds
// toward zero; summed over all 4096 keys in one accumulator that bias
// reached 5e-6 on outputs of magnitude 0.1, so each chunk's product is
// taken in a fresh accumulator and added to the running S and O in f32
// (max|error| 3e-7 to 6e-7 against the plain f32 version at the path
// shapes, as the CUDA-core kernel had). One block fills an SM, and
// (1, 1, 4096, 512) has only 64 query tiles for 132 SMs, so the keys are
// split among gridDim.z blocks: each writes its unnormalized partial output
// with its row max and sum, and flash_merge_kernel combines them in a fixed
// order, o = sum_i exp(m_i - m) o_i / sum_i exp(m_i - m) l_i (K3's residual
// convention, as ring attention merges), so the result does not vary from
// run to run. The wrapper (p2p_tpu_torch/kernels/flash.py: key_splits)
// picks the split and allocates the partials.
#include "attn_tile.cuh"
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

// One block of D / 4 threads per row: o = sum_i w_i o_i / sum_i w_i l_i with
// w_i = exp(m_i - max_i m_i), the splits taken in order.
__global__ void __launch_bounds__(d512::D / 4)
flash_merge_kernel(const float* __restrict__ po, const float* __restrict__ pm,
                   const float* __restrict__ pl, float* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int rows, int nsplit) {
  constexpr int D = d512::D;
  const size_t row = blockIdx.x;
  const int c = threadIdx.x * 4;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s * (size_t)rows + row]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t i = s * (size_t)rows + row;
    const float w = expf(pm[i] - mx);
    l += w * pl[i];
    const float4 x = *reinterpret_cast<const float4*>(po + i * D + c);
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float inv = 1.f / l;
  *reinterpret_cast<float4*>(o + row * D + c) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  if (m_out != nullptr && threadIdx.x == 0) {
    m_out[row] = mx;
    l_out[row] = l;
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
  float* po = nsplit > 1 ? part : o;
  float* pm = nsplit > 1 ? part + nsplit * rows * d512::D : m;
  float* pl = nsplit > 1 ? pm + nsplit * rows : l;
  flash_d512_kernel<<<grid, d512::NT, d512::SMEM, stream>>>(q, k, v, po, pm, pl,
                                                            sq, sk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  flash_merge_kernel<<<(unsigned)rows, d512::D / 4, 0, stream>>>(
      po, pm, pl, o, m, l, (int)rows, nsplit);
  return cudaGetLastError();
}

}  // namespace

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
      return launch<40, 64, 64, 16, 16>(q, k, v, o, m, l, bh, sq, sk, scale, s);
    case 64:
      return launch<64, 64, 64, 16, 8>(q, k, v, o, m, l, bh, sq, sk, scale, s);
    case 80:
      return launch<80, 64, 64, 16, 8>(q, k, v, o, m, l, bh, sq, sk, scale, s);
    case 160:
      return launch<160, 64, 32, 16, 4>(q, k, v, o, m, l, bh, sq, sk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
