// Shared tile routines of the port's attention kernel on the CUDA cores
// (flash_attn.cu at d = 80, 160). f32 throughout: the
// JAX reference runs these products at full f32 precision, which one TF32
// tensor-core pass (about three decimal digits) does not reach; the kernels
// that do use the tensor cores take three passes (mma_tf32.cuh).
//
// A block has kThreads threads and works on a tile of BQ query rows held in
// shared memory, against key/value tiles of BK rows streamed through shared
// memory. Every shared row has an odd stride (D + 1, BK + 1, ...), so threads
// that read the same column of different rows hit different banks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace p2p {

constexpr int kThreads = 128;

// Copy rows [row0, row0 + nrows) of a row-major (rows_total, D) matrix into
// shared memory with row stride ld; rows at or past rows_total read as zero.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int row0, int nrows, int rows_total) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < nrows * D4; i += kThreads) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    const int gr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows_total)
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)gr * D + c));
    float* p = dst + r * ld + c;
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
    p[3] = x.w;
  }
}

// S[r][j] = scale * <Q[r], K[j]> for a BQ x BK tile; columns j >= valid get
// -inf. Thread (tr, tc) of a TRS x (kThreads / TRS) grid owns rows
// tr + i*TRS and columns tc + k*TCS.
template <int D, int BQ, int BK, int TRS>
__device__ __forceinline__ void score_tile(const float* Qs, int ldq,
                                           const float* Ks, int ldk,
                                           float* Ss, int lds, float scale,
                                           int valid) {
  constexpr int TCS = kThreads / TRS;
  constexpr int RI = BQ / TRS;
  constexpr int KI = BK / TCS;
  static_assert(BQ % TRS == 0 && BK % TCS == 0, "score tile layout");
  const int tr = threadIdx.x / TCS;
  const int tc = threadIdx.x % TCS;
  float acc[RI][KI];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < KI; ++k) acc[i][k] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RI], kv[KI];
#pragma unroll
    for (int i = 0; i < RI; ++i) qv[i] = Qs[(tr + i * TRS) * ldq + d];
#pragma unroll
    for (int k = 0; k < KI; ++k) kv[k] = Ks[(tc + k * TCS) * ldk + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < KI; ++k) acc[i][k] = fmaf(qv[i], kv[k], acc[i][k]);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int k = 0; k < KI; ++k) {
      const int j = tc + k * TCS;
      Ss[(tr + i * TRS) * lds + j] = j < valid ? acc[i][k] * scale : -INFINITY;
    }
}

// Reduce over the TPR consecutive lanes that share a row.
template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// O[r][c] (+)= sum_j P[r][j] * V[j][c] over one BK tile, with the running
// output first scaled by corr[r] when RESCALE. Thread (tr, tc) of a
// TRO x (kThreads / TRO) grid owns rows tr + i*TRO and columns tc + k*TCO.
template <int D, int BQ, int TRO>
struct OutTile {
  static constexpr int TCO = kThreads / TRO;
  static constexpr int RI = BQ / TRO;
  static constexpr int CI = (D + TCO - 1) / TCO;
  static_assert(BQ % TRO == 0, "output tile layout");
  float acc[RI][CI];

  __device__ __forceinline__ int row(int i) const {
    return threadIdx.x / TCO + i * TRO;
  }
  __device__ __forceinline__ int col(int k) const {
    return threadIdx.x % TCO + k * TCO;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < CI; ++k) acc[i][k] = 0.f;
  }

  template <int BK, bool RESCALE>
  __device__ __forceinline__ void accumulate(const float* Ps, int ldp,
                                             const float* Vs, int ldv,
                                             const float* corr) {
    if (RESCALE) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float c = corr[row(i)];
#pragma unroll
        for (int k = 0; k < CI; ++k) acc[i][k] *= c;
      }
    }
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float pv[RI], vv[CI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[row(i) * ldp + j];
#pragma unroll
      for (int k = 0; k < CI; ++k) vv[k] = col(k) < D ? Vs[j * ldv + col(k)] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int k = 0; k < CI; ++k) acc[i][k] = fmaf(pv[i], vv[k], acc[i][k]);
    }
  }

  // out[(row0 + r) * D + c] = acc / denom[r] (denom == nullptr: no division),
  // rows at or past rows_total skipped.
  __device__ __forceinline__ void store(float* __restrict__ out, int row0,
                                        int rows_total, const float* denom) const {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = row(i);
      if (row0 + r >= rows_total) continue;
      const float l = denom ? denom[r] : 1.f;
#pragma unroll
      for (int k = 0; k < CI; ++k)
        if (col(k) < D) out[(size_t)(row0 + r) * D + col(k)] = acc[i][k] / l;
    }
  }
};

}  // namespace p2p
