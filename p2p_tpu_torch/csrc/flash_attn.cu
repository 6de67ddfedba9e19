// K1: flash attention forward, non-causal, unmasked, f32 in and out.
//
// Replaces the JAX package's `flash_attention_tpu` (p2p_tpu/models/nn.py:330),
// the library Pallas TPU kernel behind `nn.fused_attention`. On the main path
// it runs at the U-Net's 64x64-pixel self-attention sites, q/k/v
// (4, 8, 4096, 40), and at the VAE decoder's mid attention, (2, 1, 4096, 512).
//
// One block owns BQ query rows of one (batch, head). It streams the keys and
// values through shared memory BK rows at a time with an online softmax
// (running row max m and sum l, the output rescaled by exp(m_old - m_new) when
// the max moves) and divides by l once at the end, so the (S, S) scores never
// exist outside a BQ x BK tile. A K tile and a V tile share one buffer.
//
// Bound: at d = 40 the work is 4*S^2*d flops against 4*S*d*4 bytes per head,
// some 1000 flops a byte, so it is bound by the f32 rate of the CUDA cores
// (about 67 TFLOP/s on an H100 SXM; TF32 tensor cores are not used, see
// attn_tile.cuh). The design keeps each operand read from shared memory
// feeding several FMAs (register tiles of rows x keys and rows x columns).
// d = 512 does not fit the usual tiles in 227 KB of shared memory: it takes
// BQ = BK = 32 (136 KB, with dynamic shared memory opted in) and spreads the
// 512-wide output rows over the block's threads, 128 accumulators each.
#include "attn_tile.cuh"

using namespace p2p;

namespace {

template <int D, int BQ, int BK, int TRS, int TRO>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
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
}

template <int D, int BQ, int BK, int TRS, int TRO>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int sq, int sk, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((BQ + BK) * (D + 1) + BQ * (BK + 1) + 3 * BQ);
  auto kern = flash_fwd_kernel<D, BQ, BK, TRS, TRO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, o, sq, sk, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), all contiguous f32.
// Returns a cudaError_t (0 on success).
extern "C" int p2p_flash_attn_fwd(const float* q, const float* k, const float* v,
                                  float* o, int bh, int sq, int sk, int d,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return launch<40, 64, 64, 16, 16>(q, k, v, o, bh, sq, sk, scale, s);
    case 64:
      return launch<64, 64, 64, 16, 8>(q, k, v, o, bh, sq, sk, scale, s);
    case 80:
      return launch<80, 64, 64, 16, 8>(q, k, v, o, bh, sq, sk, scale, s);
    case 160:
      return launch<160, 64, 32, 16, 4>(q, k, v, o, bh, sq, sk, scale, s);
    case 512:
      return launch<512, 32, 32, 16, 4>(q, k, v, o, bh, sq, sk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
