// The merge of K1/K3's key splits at d = 512, shared by both d = 512
// kernels: flash_d512_kernel (f32, flash_attn.cu) and
// flash_d512_sm90_kernel (bf16, flash_fwd_sm90.cu) include it, so each
// library launches the same merge.
//
// One block at d = 512 fills an SM, so a grid of query tiles alone can
// leave SMs idle: too few tiles for one round, or a last round of few
// blocks. The keys are then split among nsplit blocks a query tile (the
// wrapper picks nsplit, p2p_tpu_torch/kernels/flash.py:key_splits). Each
// split writes f32 partials for its key range: the unnormalized output
// sum_j exp(s_j - m_i) v_j, the row max m_i (natural units) and the row sum
// l_i. flash_merge_kernel combines them in a fixed order,
// o = sum_i exp(m_i - m) o_i / sum_i exp(m_i - m) l_i with m = max_i m_i
// (K3's residual convention, as ring attention merges), so the result does
// not vary from run to run. Bound: the partials read once and the output
// written, nsplit * rows * (d + 2) * 4 + rows * d * sizeof(OutT) bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_bf16.cuh"  // bf16, pack_bf16

namespace p2p {

constexpr int MERGE_D = 512;  // the head dim of the split kernels

// Four values of an output row: f32 as they are, bf16 rounded once.
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// One block of D / 4 threads per row: o = sum_i w_i o_i / sum_i w_i l_i with
// w_i = exp(m_i - max_i m_i), the splits taken in order; o in its dtype
// OutT, and with m_out and l_out the merged residuals.
template <class OutT>
__global__ void __launch_bounds__(MERGE_D / 4)
flash_merge_kernel(const float* __restrict__ po, const float* __restrict__ pm,
                   const float* __restrict__ pl, OutT* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int rows, int nsplit) {
  constexpr int D = MERGE_D;
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
  store4(o + row * D + c, make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  if (m_out != nullptr && threadIdx.x == 0) {
    m_out[row] = mx;
    l_out[row] = l;
  }
}

// The partials' layout in `part` (nsplit * rows * (D + 2) f32): the
// outputs of split s at po + s * rows * D, then every split's row maxima,
// then their row sums; all null when part is.
struct MergeParts {
  float *po, *pm, *pl;
  MergeParts(float* part, int nsplit, size_t rows)
      : po(part),
        pm(part ? part + nsplit * rows * MERGE_D : nullptr),
        pl(part ? pm + nsplit * rows : nullptr) {}
};

// Launch the merge of nsplit splits' partials over `rows` rows into o (and
// m, l when non-null); a cudaError_t.
template <class OutT>
int launch_flash_merge(const MergeParts& p, int nsplit, size_t rows, OutT* o, float* m,
                       float* l, cudaStream_t stream) {
  flash_merge_kernel<OutT><<<(unsigned)rows, MERGE_D / 4, 0, stream>>>(
      p.po, p.pm, p.pl, o, m, l, (int)rows, nsplit);
  return cudaGetLastError();
}

}  // namespace p2p
