// K2: fused edit attention — softmax plus the prompt-to-prompt edit, f32.
//
// Replaces the JAX package's `edit_attention` / `_edit_kernel`
// (p2p_tpu/kernels/fused_edit.py:78-218). For every row b of the CFG batch
// [uncond(B); base; edits(E)] and every head it computes
//
//   probs  = softmax(q_b k_b^T scale)                  key columns >= K masked
//   base   = softmax(q_base k_base^T scale)            edit rows only
//   new    = base @ M                                  Replace / Refine (f32 FMA)
//   new    = new*ra + probs*(1 - ra)                   Refine
//   new    = new * eq                                  Reweight
//   edited = new*alpha + (1 - alpha)*probs             edit rows b >= B + 1
//   out    = (edited | probs) @ v_b
//
// so the (2B, heads, P, K) probability tensor never reaches device memory.
//
// Design against the TPU kernel:
// - Blocks run in parallel, so no row is computed for another to discard:
//   uncond rows and the base row are plain softmax attention and skip the
//   base recompute and the transform. An edit row whose alpha is 0 on every
//   key (outside the window) skips them too; one whose alpha is 1 everywhere
//   with no transform, mix or scale (a self site inside the injection
//   window) skips its own softmax and outputs softmax(q_base k_base^T) v_b.
// - Keys are not padded in device memory: the key tiles past K read as zero
//   and their scores as -inf, which exp() turns into exactly 0 (a row always
//   has a finite max, so -inf - -inf never occurs). The operands keep the
//   JAX package's padded row stride Kp; only their first K entries are read.
// - Whole probability rows live in shared memory (K <= 1024 on every site
//   the dispatch sends here: 77 for cross sites, at most the self-injection
//   pixel bound for self sites), K/V stream through in tiles of BK rows.
//   The K x K transform (cross sites, K = 77: 23 KB) sits beside them.
//
// Bound: at the cross sites the work is 2 softmaxes and 3 small products per
// row (~4*K*D + 2*K*K flops against 2*D*4 bytes of q/out), some 100 flops a
// byte, so the f32 CUDA-core rate bounds it; products run in full f32 (no
// TF32), as the JAX side runs them at Precision.HIGHEST.
#include "attn_tile.cuh"

using namespace p2p;

namespace {

constexpr int BK = 32;  // key rows per streamed tile

struct EditArgs {
  const float* q;          // (2B, H, P, D)
  const float* k;          // (2B, H, K, D)
  const float* v;          // (2B, H, K, D)
  const float* transform;  // (E, Kp, Kp) or null
  const float* refine_mix; // (E, Kp) or null
  const float* equalizer;  // (E, Kp) or null
  const float* blend;      // (E, Kp)
  float* o;                // (2B, H, P, D)
  int heads, pixels, keys, kp, b_half;
  float scale;
};

// dst[r][j] = softmax_j(q[r] . k[j] * scale) for the block's BQ query rows
// of one (batch, head); columns [K, Kt) come out as exactly 0.
template <int D, int BQ, int TRS>
__device__ void softmax_rows(const float* __restrict__ qh,
                             const float* __restrict__ kh, int q0, int pixels,
                             int keys, int kt, float scale, float* Qs,
                             float* KVs, float* dst, int lds) {
  constexpr int LDQ = D + 1;
  constexpr int TPR = kThreads / BQ;
  static_assert(kThreads % BQ == 0 && TPR <= 32, "softmax row layout");
  load_rows<D>(Qs, LDQ, qh, q0, BQ, pixels);
  for (int k0 = 0; k0 < kt; k0 += BK) {
    load_rows<D>(KVs, LDQ, kh, k0, BK, keys);
    __syncthreads();
    score_tile<D, BQ, BK, TRS>(Qs, LDQ, KVs, LDQ, dst + k0, lds, scale,
                               keys - k0);
    __syncthreads();
  }
  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  float* row = dst + r * lds;
  float mx = -INFINITY;
  for (int j = sub; j < kt; j += TPR) mx = fmaxf(mx, row[j]);
  mx = row_max<TPR>(mx);
  float sum = 0.f;
  for (int j = sub; j < kt; j += TPR) {
    const float p = expf(row[j] - mx);
    row[j] = p;
    sum += p;
  }
  sum = row_sum<TPR>(sum);
  for (int j = sub; j < kt; j += TPR) row[j] = row[j] / sum;
  __syncthreads();
}

template <int D, int BQ, int TRS, int TRO>
__global__ void __launch_bounds__(kThreads)
fused_edit_kernel(EditArgs a) {
  constexpr int LDQ = D + 1;
  const int kt = (a.keys + BK - 1) / BK * BK;
  const int lds = kt + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x LDQ
  float* KVs = Qs + BQ * LDQ;       // BK x LDQ
  float* Ps = KVs + BK * LDQ;       // BQ x lds: own probabilities, then edited
  float* Bs = Ps + BQ * lds;        // BQ x lds: base probabilities
  float* Ms = Bs + BQ * lds;        // K x K transform

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t qstride = (size_t)a.pixels * D;
  const size_t kstride = (size_t)a.keys * D;
  const float* qh = a.q + ((size_t)b * a.heads + h) * qstride;
  const float* kh = a.k + ((size_t)b * a.heads + h) * kstride;
  const float* vh = a.v + ((size_t)b * a.heads + h) * kstride;

  const bool edit_row = b >= a.b_half + 1;  // uniform over the block
  const int e = b - a.b_half - 1;
  bool need_own = true, need_base = false;
  if (edit_row) {
    const float* al = a.blend + (size_t)e * a.kp;
    int zero = 1, one = 1;
    for (int j = threadIdx.x; j < a.keys; j += kThreads) {
      zero &= al[j] == 0.f;
      one &= al[j] == 1.f;
    }
    zero = __syncthreads_and(zero);
    one = __syncthreads_and(one);
    need_base = !zero;
    need_own = !(one && a.transform == nullptr && a.refine_mix == nullptr &&
                 a.equalizer == nullptr);
  }

  if (need_own)
    softmax_rows<D, BQ, TRS>(qh, kh, q0, a.pixels, a.keys, kt, a.scale, Qs,
                             KVs, Ps, lds);

  if (need_base) {
    const size_t base = (size_t)a.b_half * a.heads + h;
    if (a.transform != nullptr) {
      const float* m = a.transform + (size_t)e * a.kp * a.kp;
      for (int i = threadIdx.x; i < a.keys * a.keys; i += kThreads) {
        const int w = i / a.keys;
        Ms[i] = m[(size_t)w * a.kp + (i - w * a.keys)];
      }
    }
    softmax_rows<D, BQ, TRS>(a.q + base * qstride, a.k + base * kstride, q0,
                             a.pixels, a.keys, kt, a.scale, Qs, KVs, Bs, lds);
    const float* ra = a.refine_mix ? a.refine_mix + (size_t)e * a.kp : nullptr;
    const float* eq = a.equalizer ? a.equalizer + (size_t)e * a.kp : nullptr;
    const float* al = a.blend + (size_t)e * a.kp;
    // Each (row, column) of the edited tile is written by the one thread
    // that reads Ps there, so the update is in place.
    for (int i = threadIdx.x; i < BQ * kt; i += kThreads) {
      const int r = i / kt;
      const int n = i - r * kt;
      float res = 0.f;
      if (n < a.keys) {
        const float* brow = Bs + r * lds;
        float t;
        if (a.transform != nullptr) {
          t = 0.f;
          for (int w = 0; w < a.keys; ++w) t = fmaf(brow[w], Ms[w * a.keys + n], t);
        } else {
          t = brow[n];
        }
        const float p = need_own ? Ps[r * lds + n] : 0.f;
        if (ra) t = t * ra[n] + p * (1.f - ra[n]);
        if (eq) t = t * eq[n];
        res = t * al[n] + (1.f - al[n]) * p;
      }
      Ps[r * lds + n] = res;
    }
    __syncthreads();
  }

  OutTile<D, BQ, TRO> out;
  out.zero();
  for (int k0 = 0; k0 < kt; k0 += BK) {
    load_rows<D>(KVs, LDQ, vh, k0, BK, a.keys);
    __syncthreads();
    out.template accumulate<BK, false>(Ps + k0, lds, KVs, LDQ, nullptr);
    __syncthreads();
  }
  out.store(a.o + ((size_t)b * a.heads + h) * qstride, q0, a.pixels, nullptr);
}

size_t smem_bytes(int d, int bq, int keys, bool transform) {
  const int kt = (keys + BK - 1) / BK * BK;
  size_t n = (size_t)(bq + BK) * (d + 1) + 2 * (size_t)bq * (kt + 1);
  if (transform) n += (size_t)keys * keys;
  return n * sizeof(float);
}

template <int D, int BQ, int TRS, int TRO>
int launch(const EditArgs& a, int two_b, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, BQ, a.keys, a.transform != nullptr);
  auto kern = fused_edit_kernel<D, BQ, TRS, TRO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.pixels + BQ - 1) / BQ, a.heads, two_b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Rows of 32 queries while two probability tiles fit; 16 for longer keys;
// keys too long for either are refused (cudaErrorInvalidValue).
constexpr size_t kSmemLimit = 227 * 1024;

template <int D, int TRO32, int TRO16>
int dispatch(const EditArgs& a, int two_b, cudaStream_t s) {
  if (smem_bytes(D, 32, a.keys, a.transform != nullptr) <= kSmemLimit)
    return launch<D, 32, 16, TRO32>(a, two_b, s);
  if (smem_bytes(D, 16, a.keys, a.transform != nullptr) <= kSmemLimit)
    return launch<D, 16, 16, TRO16>(a, two_b, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (2B, H, P, D); k, v (2B, H, K, D); operands with row stride kp; out like
// q. All contiguous f32; transform / refine_mix / equalizer may be null.
// Returns a cudaError_t (0 on success).
extern "C" int p2p_fused_edit_fwd(const float* q, const float* k,
                                  const float* v, const float* transform,
                                  const float* refine_mix,
                                  const float* equalizer, const float* blend,
                                  float* o, int two_b, int heads, int pixels,
                                  int keys, int d, int kp, float scale,
                                  void* stream) {
  EditArgs a{q, k, v, transform, refine_mix, equalizer, blend, o,
             heads, pixels, keys, kp, two_b / 2, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return dispatch<16, 16, 16>(a, two_b, s);
    case 32: return dispatch<32, 16, 16>(a, two_b, s);
    case 40: return dispatch<40, 16, 16>(a, two_b, s);
    case 64: return dispatch<64, 8, 8>(a, two_b, s);
    case 80: return dispatch<80, 8, 8>(a, two_b, s);
    case 160: return dispatch<160, 8, 8>(a, two_b, s);
    default: return cudaErrorInvalidValue;
  }
}
