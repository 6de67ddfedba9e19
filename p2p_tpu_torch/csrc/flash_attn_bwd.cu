// K4: flash attention backward, non-causal, unmasked, f32 in and out.
//
// Replaces the JAX library's flash backward that `jax.grad` runs through
// `flash_attention_tpu` (p2p_tpu/models/nn.py:308-340): the Pallas kernels
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`
// (jax/experimental/pallas/ops/tpu/flash_attention.py, rule at :254-315).
// On the null-text inversion path they run at the U-Net's 64x64-pixel self
// sites, (1, 8, 4096, 40), once each per site per inner iteration.
//
// Inputs: q, do (bh, sq, d); k, v (bh, sk, d); the forward's residuals m and
// l (bh, sq) from K3; and di = sum_c o * do (bh, sq), computed by the wrapper
// in PyTorch as the JAX rule computes it outside its kernels. With
// s = scale * q k^T and lse = m + log l, p = exp(s - lse) is the forward's
// softmax, recomputed tile by tile, so the (S, S) matrices never exist in
// device memory:
//
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - di),
//   dk = scale * ds^T q,  dq = scale * ds k.
//
// Two kernels, as the JAX library has, and no atomics: every output element
// is summed by one thread in a fixed order, so the result is the same from
// run to run (the null-text Adam loop amplifies run-to-run noise).
//  - dkv: one block per (bh, key tile). The K and V tiles stay in shared
//    memory and dK, dV accumulate in registers while the block walks over
//    every query tile.
//  - dq: one block per (bh, query tile). The Q and dO tiles stay in shared
//    memory and dQ accumulates in registers while the block walks over every
//    key tile.
// Ragged edges: rows past sq or sk are loaded as zeros; a key past sk scores
// -inf (p = 0), and a query row past sq gets lse = +inf (p = 0) and di = 0,
// so no -inf - -inf is ever formed and nothing past the edge is stored.
//
// Bound: per head the dkv pass does four products of 2*S^2*d flops and the
// dq pass three, against some 8*S*d*4 bytes of inputs: far above the card's
// flops per byte, so the f32 rate of the CUDA cores bounds both (about
// 67 TFLOP/s on an H100 SXM; TF32 tensor cores are not used, see
// attn_tile.cuh). Each shared-memory operand feeds several FMAs through the
// register tiles of attn_tile.cuh.
#include "attn_tile.cuh"

using namespace p2p;

namespace {

// lse = m + log l and di of rows [row0, row0 + n) into shared memory; rows
// past rows_total get lse = +inf and di = 0.
template <int N>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* di_s,
                                               const float* __restrict__ m,
                                               const float* __restrict__ l,
                                               const float* __restrict__ di,
                                               int row0, int rows_total) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int gr = row0 + i;
    const bool ok = gr < rows_total;
    lse_s[i] = ok ? m[gr] + logf(l[gr]) : INFINITY;
    di_s[i] = ok ? di[gr] : 0.f;
  }
}

// out = scale * acc, rows past rows_total skipped.
template <int D, int R, int TRO>
__device__ __forceinline__ void scale_and_store(OutTile<D, R, TRO>& t,
                                                float scale, float* out,
                                                int row0, int rows_total) {
#pragma unroll
  for (int i = 0; i < OutTile<D, R, TRO>::RI; ++i)
#pragma unroll
    for (int c = 0; c < OutTile<D, R, TRO>::CI; ++c) t.acc[i][c] *= scale;
  t.store(out, row0, rows_total, nullptr);
}

template <int D, int BQ, int BK, int TRS, int TRO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, float scale) {
  constexpr int LDQ = D + 1;
  constexpr int LDS = BK + 1;  // S and dP tiles, (BQ, BK)
  constexpr int LDT = BQ + 1;  // P^T and dS^T tiles, (BK, BQ)
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LDQ;
  float* Qs = Vs + BK * LDQ;
  float* dOs = Qs + BQ * LDQ;
  float* Ss = dOs + BQ * LDQ;
  float* PTs = Ss + BQ * LDS;
  float* lse_s = PTs + BK * LDT;
  float* di_s = lse_s + BQ;

  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* dob = dout + bh * sq * D;
  const int k0 = blockIdx.x * BK;
  const int valid = min(BK, sk - k0);

  load_rows<D>(Ks, LDQ, k + bh * sk * D, k0, BK, sk);
  load_rows<D>(Vs, LDQ, v + bh * sk * D, k0, BK, sk);
  OutTile<D, BK, TRO> dK, dV;  // rows are this block's keys
  dK.zero();
  dV.zero();

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    load_rows<D>(Qs, LDQ, qb, q0, BQ, sq);
    load_rows<D>(dOs, LDQ, dob, q0, BQ, sq);
    load_row_stats<BQ>(lse_s, di_s, m + bh * sq, l + bh * sq, di + bh * sq, q0, sq);
    __syncthreads();
    score_tile<D, BQ, BK, TRS>(Qs, LDQ, Ks, LDQ, Ss, LDS, scale, valid);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK;
      const int j = i - r * BK;
      PTs[j * LDT + r] = expf(Ss[r * LDS + j] - lse_s[r]);
    }
    __syncthreads();
    // dV += P^T dO while dP = dO V^T overwrites the consumed scores. Keys
    // past sk read zero rows of V, so their dP is 0 and not -inf.
    dV.template accumulate<BQ, false>(PTs, LDT, dOs, LDQ, nullptr);
    score_tile<D, BQ, BK, TRS>(dOs, LDQ, Vs, LDQ, Ss, LDS, 1.f, BK);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK;
      const int j = i - r * BK;
      const float p = PTs[j * LDT + r];
      PTs[j * LDT + r] = p * (Ss[r * LDS + j] - di_s[r]);  // dS^T in place
    }
    __syncthreads();
    dK.template accumulate<BQ, false>(PTs, LDT, Qs, LDQ, nullptr);
    __syncthreads();
  }
  scale_and_store(dK, scale, dk + bh * sk * D, k0, sk);
  scale_and_store(dV, 1.f, dv + bh * sk * D, k0, sk);
}

template <int D, int BQ, int BK, int TRS, int TRO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int sq, int sk, float scale) {
  constexpr int LDQ = D + 1;
  constexpr int LDS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LDQ;
  float* Ks = dOs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ss = Vs + BK * LDQ;
  float* dPs = Ss + BQ * LDS;
  float* lse_s = dPs + BQ * LDS;
  float* di_s = lse_s + BQ;

  const size_t bh = blockIdx.y;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int q0 = blockIdx.x * BQ;

  load_rows<D>(Qs, LDQ, q + bh * sq * D, q0, BQ, sq);
  load_rows<D>(dOs, LDQ, dout + bh * sq * D, q0, BQ, sq);
  load_row_stats<BQ>(lse_s, di_s, m + bh * sq, l + bh * sq, di + bh * sq, q0, sq);
  OutTile<D, BQ, TRO> dQ;
  dQ.zero();

  for (int k0 = 0; k0 < sk; k0 += BK) {
    load_rows<D>(Ks, LDQ, kb, k0, BK, sk);
    load_rows<D>(Vs, LDQ, vb, k0, BK, sk);
    __syncthreads();
    score_tile<D, BQ, BK, TRS>(Qs, LDQ, Ks, LDQ, Ss, LDS, scale, min(BK, sk - k0));
    score_tile<D, BQ, BK, TRS>(dOs, LDQ, Vs, LDQ, dPs, LDS, 1.f, BK);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK;
      const int j = i - r * BK;
      const float p = expf(Ss[r * LDS + j] - lse_s[r]);
      Ss[r * LDS + j] = p * (dPs[r * LDS + j] - di_s[r]);  // dS in place
    }
    __syncthreads();
    dQ.template accumulate<BK, false>(Ss, LDS, Ks, LDQ, nullptr);
    __syncthreads();
  }
  scale_and_store(dQ, scale, dq + bh * sq * D, q0, sq);
}

template <int D, int BQ, int BK, int TRS, int TRO>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* m, const float* l, const float* di, float* dk,
               float* dv, int bh, int sq, int sk, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (BQ + BK) * (D + 1) + BQ * (BK + 1) +
                                       BK * (BQ + 1) + 2 * BQ);
  auto kern = flash_bwd_dkv_kernel<D, BQ, BK, TRS, TRO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + BK - 1) / BK, bh);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, dout, m, l, di, dk, dv, sq,
                                         sk, scale);
  return cudaGetLastError();
}

template <int D, int BQ, int BK, int TRS, int TRO>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* m, const float* l, const float* di, float* dq,
              int bh, int sq, int sk, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (BQ + BK) * (D + 1) +
                                       2 * BQ * (BK + 1) + 2 * BQ);
  auto kern = flash_bwd_dq_kernel<D, BQ, BK, TRS, TRO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, dout, m, l, di, dq, sq, sk,
                                         scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout: (bh, sq, d); k, v: (bh, sk, d); m, l, di: (bh, sq); dk, dv:
// (bh, sk, d). All contiguous f32. Returns a cudaError_t (0 on success).
extern "C" int p2p_flash_attn_bwd_dkv(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* m, const float* l,
                                      const float* di, float* dk, float* dv,
                                      int bh, int sq, int sk, int d,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return launch_dkv<40, 64, 64, 16, 16>(q, k, v, dout, m, l, di, dk, dv, bh,
                                            sq, sk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q, dout, dq: (bh, sq, d); k, v: (bh, sk, d); m, l, di: (bh, sq). All
// contiguous f32. Returns a cudaError_t (0 on success).
extern "C" int p2p_flash_attn_bwd_dq(const float* q, const float* k,
                                     const float* v, const float* dout,
                                     const float* m, const float* l,
                                     const float* di, float* dq, int bh,
                                     int sq, int sk, int d, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return launch_dq<40, 64, 64, 16, 16>(q, k, v, dout, m, l, di, dq, bh, sq,
                                           sk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
