// K4: flash attention backward, non-causal, unmasked, f32 in and out; in
// bf16 it runs on Hopper's wgmma and TMA in flash_bwd_sm90.cu.
//
// Replaces the JAX library's flash backward that `jax.grad` runs through
// `flash_attention_tpu` (p2p_tpu/models/nn.py:308-340): the Pallas kernels
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`
// (jax/experimental/pallas/ops/tpu/flash_attention.py, rule at :254-315).
// On the null-text inversion path they run once each per site per inner
// iteration at the U-Net's self sites of 2048 pixels or more: SD-1.4's
// 64x64-pixel sites, (1, 8, 4096, 40), and SD-2.1's at head dim 64, (1, 5,
// 9216, 64) and (1, 10, 2304, 64) at 768-v and (1, 5, 4096, 64) at 512-base.
// The head dim is a template parameter, instantiated at 40 and 64; each C
// entry dispatches on it.
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
// Every product runs on the tensor cores in 3xTF32 (mma_tf32.cuh), which
// keeps f32 accuracy at three TF32 products per product; the work, seven
// products of 2*S^2*d flops per head, bounds both kernels. Two kernels, as
// the JAX library has, and no atomics: every output element is accumulated
// by one thread in a fixed order, so two runs give bitwise-equal gradients
// (the null-text Adam step g / (|g| + 1e-8) amplifies run-to-run noise).
// 128 threads, four warps, each owning 16 rows of the block's output tile:
//  - dkv: one block per (bh, 64-key tile). It walks over the query tiles,
//    double-buffered by cp.async, and computes s^T = k q^T and dp^T = v do^T
//    with keys as rows, so the accumulator fragments of p^T and ds^T are the
//    A operands of dv += p^T do and dk += ds^T q with no trip through shared
//    memory (mma_tf32.cuh: a_from_c, load_b_perm).
//  - dq: one block per (bh, 64-query tile). It walks over the key tiles,
//    double-buffered, and the fragment of ds is the A operand of dq += ds k.
// Every tile in shared memory feeds B operands in all four warps, so the
// block splits it into its TF32 parts once, in place (split_tile), rather
// than each warp at every read: Q and dO per query tile and K and V once in
// dkv, K and V per key tile and Q and dO once in dq (ten tiles: 113 KB of
// shared memory at d = 40, two blocks an SM; 176 KB at d = 64, one).
// The tensor cores' accumulation rounds toward zero, which over a whole
// 4096-long sum biased the gradients by some 2e-5 of their largest value;
// each tile's product is therefore summed in its own accumulator and added
// to the running dk, dv or dq in f32 (2.5e-6). p = exp2(s * scale *
// log2(e) - lse * log2(e)) takes one MUFU.EX2 per element.
// Tiles are 64 x D in shared memory with row stride D + 4 (44, 68), which
// every fragment pattern reads without bank conflicts.
// Ragged edges: rows past sq or sk are loaded as zeros; a key past sk gets
// p = 0, and a query row past sq gets lse = +inf (p = 0) and di = 0, so no
// -inf - -inf is ever formed and nothing past the edge is stored.
#include <math.h>

#include "mma_tf32.cuh"

using namespace p2p;

namespace {

constexpr int NT = 128;           // four warps
constexpr int BR = 64;            // rows of a tile (keys or queries)
constexpr int NRT = BR / 8;       // n-tiles and k-steps over a 64-row tile
constexpr float LOG2E = 1.4426950408889634f;

// The f32 passes' geometry at head dim D.
template <int D>
struct F32 {
  static constexpr int LD = D + 4;      // ld % 8 == 4: conflict-free fragments
  static constexpr int TILE = BR * LD;
  static constexpr int NKS = D / 8;     // k-steps and n-tiles over the head dim
  // n-tiles of out += C B whose B fragments are in registers at once: all
  // five at d = 40, four of eight at d = 64 (registers).
  static constexpr int GCB = NKS % 4 == 0 ? 4 : NKS;
  static constexpr size_t DKV_SMEM = sizeof(float) * (10 * TILE + 7 * BR);
  static constexpr size_t DQ_SMEM = sizeof(float) * (10 * TILE + 3 * BR);
};

// acc[n] = A_w X^T: the warp's 16 rows of A against the 64 rows of X, over
// the head dim, both split; G n-tiles at a time (G B fragments live in
// registers).
template <int D, int G>
__device__ __forceinline__ void product_nt(float (&acc)[NRT][4], const Split& A,
                                           const Split& X) {
  constexpr int LD = F32<D>::LD, NKS = F32<D>::NKS;
#pragma unroll
  for (int n = 0; n < NRT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    FragA a;
    load_a(a, A.at(ks * 8), LD);
#pragma unroll
    for (int n0 = 0; n0 < NRT; n0 += G) {
      FragB b[G];
#pragma unroll
      for (int n = 0; n < G; ++n) load_bt(b[n], X.at((n0 + n) * 8 * LD + ks * 8), LD);
      mma_3xtf32([&](int ta, int tb) {
#pragma unroll
        for (int n = 0; n < G; ++n) mma_tf32(acc[n0 + n], a.x[ta], b[n].x[tb]);
      });
    }
  }
}

// out += C B for the warp's 16 x 64 accumulator fragments C (as A operands,
// k permuted) and the split 64 x D tile B. The tile's sum is taken in its own
// accumulator and added to out in f32: the tensor cores' accumulation
// rounds toward zero, and over a chain as long as the whole sequence that
// bias grows to some 2e-5 of the result. Each element of the tile sums
// the same terms in the same order whatever the grouping of n-tiles.
template <int D>
__device__ __forceinline__ void product_cb(float (&out)[F32<D>::NKS][4],
                                           const float (&c)[NRT][4], const Split& B) {
  constexpr int LD = F32<D>::LD, NKS = F32<D>::NKS, G = F32<D>::GCB;
  float tile[NKS][4];
#pragma unroll
  for (int n = 0; n < NKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[n][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NRT; ++kt) {
    FragA a;
    a_from_c(a, c[kt]);
#pragma unroll
    for (int n0 = 0; n0 < NKS; n0 += G) {
      FragB b[G];
#pragma unroll
      for (int n = 0; n < G; ++n)
        load_b_perm(b[n], B.at(kt * 8 * LD + (n0 + n) * 8), LD);
      mma_3xtf32([&](int ta, int tb) {
#pragma unroll
        for (int n = 0; n < G; ++n) mma_tf32(tile[n0 + n], a.x[ta], b[n].x[tb]);
      });
    }
  }
#pragma unroll
  for (int n = 0; n < NKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] += tile[n][e];
}

// Rows row0 + [0, 16) of out = scale * acc; rows at or past rows_total
// skipped.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[F32<D>::NKS][4],
                                           float scale, int row0, int rows_total) {
  constexpr int NKS = F32<D>::NKS;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= rows_total) continue;
#pragma unroll
    for (int n = 0; n < NKS; ++n)
      *reinterpret_cast<float2*>(out + (size_t)r * D + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// Raw m, l and di of query rows [row0, row0 + BR) into shared memory (zeros
// past rows_total), asynchronously.
__device__ __forceinline__ void cp_async_stats(float* m_s, float* l_s,
                                               float* di_s, const float* m,
                                               const float* l, const float* di,
                                               int row0, int rows_total) {
  for (int i = threadIdx.x; i < 3 * BR; i += NT) {
    const int w = i / BR, r = i % BR;
    const bool ok = row0 + r < rows_total;
    const float* src = w == 0 ? m : (w == 1 ? l : di);
    float* dst = w == 0 ? m_s : (w == 1 ? l_s : di_s);
    cp_async4(dst + r, ok ? src + row0 + r : src, ok);
  }
}

// log2 of the softmax denominator, (m + log l) * log2(e), so that
// p = exp2(s * scale * log2(e) - lse2); +inf for a row past the edge.
__device__ __forceinline__ float lse2_of(float m, float l, bool ok) {
  return ok ? m * LOG2E + log2f(l) : INFINITY;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, float scale) {
  constexpr int LD = F32<D>::LD, TILE = F32<D>::TILE, NKS = F32<D>::NKS;
  extern __shared__ float smem[];
  float* Ks = smem;                 // hi parts in place, lo parts beside
  float* Kl = Ks + TILE;
  float* Vs = Kl + TILE;
  float* Vl = Vs + TILE;
  float* Qs = Vl + TILE;            // two stages of Q, then two of dO
  float* dOs = Qs + 2 * TILE;
  float* Ql = dOs + 2 * TILE;       // lo parts of the current stage
  float* dOl = Ql + TILE;
  float* m_s = dOl + TILE;          // two stages each of m, l, di
  float* l_s = m_s + 2 * BR;
  float* di_s = l_s + 2 * BR;
  float* lse_s = di_s + 2 * BR;

  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* dob = dout + bh * sq * D;
  const float* mb = m + bh * sq;
  const float* lb = l + bh * sq;
  const float* dib = di + bh * sq;
  const int k0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int w0 = warp * 16;         // the warp's keys within the tile
  const float scale2 = scale * LOG2E;

  cp_async_rows<D, D, LD, BR, NT>(Ks, k + bh * sk * D, k0, sk);
  cp_async_rows<D, D, LD, BR, NT>(Vs, v + bh * sk * D, k0, sk);
  cp_async_rows<D, D, LD, BR, NT>(Qs, qb, 0, sq);
  cp_async_rows<D, D, LD, BR, NT>(dOs, dob, 0, sq);
  cp_async_stats(m_s, l_s, di_s, mb, lb, dib, 0, sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<BR, D, LD, NT>(Ks, Kl);
  split_tile<BR, D, LD, NT>(Vs, Vl);

  float dK[NKS][4], dV[NKS][4];
#pragma unroll
  for (int n = 0; n < NKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;

  const int nq = (sq + BR - 1) / BR;
  for (int it = 0; it < nq; ++it) {
    const int st = it & 1, q0 = it * BR;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile it is in; stage st ^ 1 and the lo parts are free
    }
    if (it + 1 < nq) {
      const int nx = st ^ 1, q1 = q0 + BR;
      cp_async_rows<D, D, LD, BR, NT>(Qs + nx * TILE, qb, q1, sq);
      cp_async_rows<D, D, LD, BR, NT>(dOs + nx * TILE, dob, q1, sq);
      cp_async_stats(m_s + nx * BR, l_s + nx * BR, di_s + nx * BR, mb, lb, dib,
                     q1, sq);
    }
    cp_async_commit();
    float* Qt = Qs + st * TILE;
    float* dOt = dOs + st * TILE;
    split_tile<BR, D, LD, NT>(Qt, Ql);
    split_tile<BR, D, LD, NT>(dOt, dOl);
    if (threadIdx.x < BR)
      lse_s[threadIdx.x] = lse2_of(m_s[st * BR + threadIdx.x],
                                   l_s[st * BR + threadIdx.x], q0 + threadIdx.x < sq);
    __syncthreads();
    const float* dit = di_s + st * BR;
    const Split Q{Qt, Ql}, dO{dOt, dOl};

    // p^T = exp(scale * k q^T - lse): keys are rows, queries columns.
    float p[NRT][4], dp[NRT][4];
    product_nt<D, 4>(p, Split{Ks, Kl}.at(w0 * LD), Q);
#pragma unroll
    for (int n = 0; n < NRT; ++n) {
      const int c = n * 8 + 2 * t;
      const float lse0 = lse_s[c], lse1 = lse_s[c + 1];
      p[n][0] = exp2f(p[n][0] * scale2 - lse0);
      p[n][1] = exp2f(p[n][1] * scale2 - lse1);
      p[n][2] = exp2f(p[n][2] * scale2 - lse0);
      p[n][3] = exp2f(p[n][3] * scale2 - lse1);
    }
    product_cb<D>(dV, p, dO);
    // ds^T = p^T * (v do^T - di).
    product_nt<D, 4>(dp, Split{Vs, Vl}.at(w0 * LD), dO);
#pragma unroll
    for (int n = 0; n < NRT; ++n) {
      const int c = n * 8 + 2 * t;
      const float di0 = dit[c], di1 = dit[c + 1];
      dp[n][0] = p[n][0] * (dp[n][0] - di0);
      dp[n][1] = p[n][1] * (dp[n][1] - di1);
      dp[n][2] = p[n][2] * (dp[n][2] - di0);
      dp[n][3] = p[n][3] * (dp[n][3] - di1);
    }
    product_cb<D>(dK, dp, Q);
  }
  store_rows<D>(dk + bh * sk * D, dK, scale, k0 + w0, sk);
  store_rows<D>(dv + bh * sk * D, dV, 1.f, k0 + w0, sk);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int sq, int sk, float scale) {
  constexpr int LD = F32<D>::LD, TILE = F32<D>::TILE, NKS = F32<D>::NKS;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;           // two stages of K, then two of V
  float* Vs = Ks + 2 * TILE;
  float* Ql = Vs + 2 * TILE;        // lo parts; K's and V's of the current stage
  float* dOl = Ql + TILE;
  float* Kl = dOl + TILE;
  float* Vl = Kl + TILE;
  float* m_s = Vl + TILE;
  float* l_s = m_s + BR;
  float* di_s = l_s + BR;

  const size_t bh = blockIdx.y;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;         // the warp's queries within the tile
  const float scale2 = scale * LOG2E;

  cp_async_rows<D, D, LD, BR, NT>(Qs, q + bh * sq * D, q0, sq);
  cp_async_rows<D, D, LD, BR, NT>(dOs, dout + bh * sq * D, q0, sq);
  cp_async_stats(m_s, l_s, di_s, m + bh * sq, l + bh * sq, di + bh * sq, q0, sq);
  cp_async_rows<D, D, LD, BR, NT>(Ks, kb, 0, sk);
  cp_async_rows<D, D, LD, BR, NT>(Vs, vb, 0, sk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<BR, D, LD, NT>(Qs, Ql);
  split_tile<BR, D, LD, NT>(dOs, dOl);
  // The statistics of the thread's two rows, w0 + g and w0 + g + 8.
  float lse2[2], dis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w0 + g + 8 * h;
    lse2[h] = lse2_of(m_s[r], l_s[r], q0 + r < sq);
    dis[h] = di_s[r];
  }

  float dQ[NKS][4];
#pragma unroll
  for (int n = 0; n < NKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[n][e] = 0.f;

  const int nk = (sk + BR - 1) / BR;
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1, key0 = it * BR;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile it is in; stage st ^ 1 is free
    }
    if (it + 1 < nk) {
      cp_async_rows<D, D, LD, BR, NT>(Ks + (st ^ 1) * TILE, kb, key0 + BR, sk);
      cp_async_rows<D, D, LD, BR, NT>(Vs + (st ^ 1) * TILE, vb, key0 + BR, sk);
    }
    cp_async_commit();
    split_tile<BR, D, LD, NT>(Ks + st * TILE, Kl);
    split_tile<BR, D, LD, NT>(Vs + st * TILE, Vl);
    __syncthreads();
    const Split K{Ks + st * TILE, Kl};

    // p = exp(scale * q k^T - lse), 0 for keys past sk.
    float p[NRT][4], dp[NRT][4];
    product_nt<D, 8>(p, Split{Qs + w0 * LD, Ql + w0 * LD}, K);
#pragma unroll
    for (int n = 0; n < NRT; ++n) {
      const int c = key0 + n * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = c + (e & 1) < sk ? exp2f(p[n][e] * scale2 - lse2[e >> 1]) : 0.f;
    }
    // ds = p * (do v^T - di).
    product_nt<D, 8>(dp, Split{dOs + w0 * LD, dOl + w0 * LD}, Split{Vs + st * TILE, Vl});
#pragma unroll
    for (int n = 0; n < NRT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - dis[e >> 1]);
    product_cb<D>(dQ, dp, K);
  }
  store_rows<D>(dq + bh * sq * D, dQ, scale, q0 + w0, sq);
}

int launch(const void* kern, size_t smem, dim3 grid, void** args,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kern, grid, dim3(NT), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch the dk/dv pass (dkv) or the dq pass on f32 operands at head dim D,
// over `tiles` row tiles of each of bh heads.
template <int D>
int launch_f32(bool dkv, int tiles, int bh, void** args, void* stream) {
  const void* kern = dkv ? reinterpret_cast<const void*>(flash_bwd_dkv_kernel<D>)
                         : reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>);
  return launch(kern, dkv ? F32<D>::DKV_SMEM : F32<D>::DQ_SMEM, dim3(tiles, bh), args,
                static_cast<cudaStream_t>(stream));
}

// The pass at head dim d, 40 or 64; cudaErrorInvalidValue for any other.
int dispatch(bool dkv, int d, int tiles, int bh, void** args, void* stream) {
  if (d == 40) return launch_f32<40>(dkv, tiles, bh, args, stream);
  if (d == 64) return launch_f32<64>(dkv, tiles, bh, args, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout: (bh, sq, d); k, v: (bh, sk, d); m, l, di: (bh, sq); dk, dv:
// (bh, sk, d). All contiguous f32; d = 40 or 64. Returns a cudaError_t (0
// on success).
extern "C" int p2p_flash_attn_bwd_dkv(const float* q, const float* k,
                                      const float* v, const float* dout,
                                      const float* m, const float* l,
                                      const float* di, float* dk, float* dv,
                                      int bh, int sq, int sk, int d,
                                      float scale, void* stream) {
  void* args[] = {&q, &k, &v, &dout, &m, &l, &di, &dk, &dv, &sq, &sk, &scale};
  return dispatch(true, d, (sk + BR - 1) / BR, bh, args, stream);
}

// q, dout, dq: (bh, sq, d); k, v: (bh, sk, d); m, l, di: (bh, sq). All
// contiguous f32; d = 40 or 64. Returns a cudaError_t (0 on success).
extern "C" int p2p_flash_attn_bwd_dq(const float* q, const float* k,
                                     const float* v, const float* dout,
                                     const float* m, const float* l,
                                     const float* di, float* dq, int bh,
                                     int sq, int sk, int d, float scale,
                                     void* stream) {
  void* args[] = {&q, &k, &v, &dout, &m, &l, &di, &dq, &sq, &sk, &scale};
  return dispatch(false, d, (sq + BR - 1) / BR, bh, args, stream);
}

// The message of a CUDA error code, for the Python wrappers.
extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
