// Softmax attention in bf16 on the tensor cores, for K2's bf16 kernel
// (fused_edit.cu; K1 and K3 in bf16 run on wgmma in flash_fwd_sm90.cu).
//
// One bf16 product a term: mma.sync.aligned.m16n8k16 (and m16n8k8 for a
// head dim's last 8 columns) with bf16 operands and an f32 accumulator. The
// product of two bf16 values is exact in f32, so q k^T comes out as the JAX
// package's bf16 dot with preferred_element_type=f32 computes it, up to the
// order of the sum. The normalized P is rounded to bf16 (cvt.rn.bf16x2.f32,
// to nearest even, as p.astype(v.dtype) rounds) before P V; the row max, the
// row sum and the output stay f32 until the output is rounded to bf16 once.
//
// Fragments, with g = lane / 4 and t = lane % 4 (each register holds two
// bf16, the lower column in the lower half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8, k x n): b0 (k = 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g)
//   C (16 x 8): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// so the C fragments of two neighbouring 8-key tiles of S = Q K^T are, once
// packed to bf16, the A fragment of one 16-key step of O += P V, and P never
// leaves registers (FlashAttention-2's layout). Every operand lands in
// shared memory by cp.async and is read by ldmatrix: Q's A fragments and
// K's B fragments (K stored [key][d] is B = K^T column by column) without
// transposing, V's B fragments with .trans (V stored [key][d]). A row of a
// tile is an odd number of 16-byte chunks (a head dim of 40 is five; others
// are padded by one), so the eight rows an ldmatrix reads fall in eight
// different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // exp2_ftz, cp_async16, cp_async_commit, cp_async_wait

namespace p2p {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four (x4) or two (x2) 8 x 8 matrices of 16-bit values: lanes 8i..8i+7
// give the row addresses of matrix i; a thread receives, of matrix i, the
// pair (row g, columns 2t, 2t + 1), or with .trans (rows 2t, 2t + 1,
// column g).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_k16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// m16n8k8: A (16 x 8) a0 (g, 2t..), a1 (g + 8, 2t..); B b0 (k = 2t.., n = g).
__device__ __forceinline__ void mma_bf16_k8(float* c, const uint32_t* a, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Two f32 values rounded to nearest even and packed, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// The geometry of one attention pass at head dim D: NW warps of 16 query
// rows each, keys streamed BS at a time through two stages; with LO, room
// for a second value tile, the low bf16 parts of values carried as a pair.
template <int D, int BS, int NW, bool LO = false>
struct AttnBf16 {
  static_assert(D % 8 == 0 && BS % 16 == 0, "bf16 attention geometry");
  static constexpr int NT = NW * 32;
  static constexpr int ROWS = NW * 16;        // query rows a block
  static constexpr int LD = (D / 8) % 2 ? D : D + 8;  // row stride: odd 16-byte chunks
  static constexpr int KS = D / 16;           // k16 steps of S = Q K^T
  static constexpr bool TAIL = D % 16 == 8;   // and one k8 step
  static constexpr int NS = BS / 8;           // n-tiles of S
  static constexpr int KP = BS / 16;          // k16 steps of O += P V
  static constexpr int NO = D / 8;            // n-tiles of O
  // Q's rows, then two stages of K, of V and (LO) of V's low parts.
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)LD * (ROWS + (LO ? 6 : 4) * BS);
};

// Rows [row0, row0 + ROWS) of a row-major (rows_total, D) bf16 matrix into
// shared memory with row stride LD, by cp.async in 16-byte chunks, by NT
// threads; rows at or past rows_total are zero-filled.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void land_rows_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int row0, int rows_total) {
  constexpr int C = D / 8;
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C, c = i % C * 8;
    const bool ok = row0 + r < rows_total;
    cp_async16(reinterpret_cast<float*>(dst + r * LD + c),
               reinterpret_cast<const float*>(ok ? src + (size_t)(row0 + r) * D + c : src),
               ok ? 16 : 0);
  }
}

// One softmax-attention pass over all `keys` keys for the block's query
// rows q0 + [0, ROWS), warp w owning rows q0 + 16 w + [0, 16):
// o = softmax(q k^T scale) v, rounded to bf16 into oh, or, with accumulate,
// added in f32 to what oh holds (the same thread wrote it) and rounded
// again. qh (pixels, D), kh and vh (keys, D), oh (pixels, D), all bf16;
// with LO, vlo null or the low parts of values carried as a bf16 pair,
// v = vh + vlo, each taken in its own product with the same P;
// scale2 = scale * log2(e). Every thread of the block calls it.
//
// The normalized P = p / l is rounded to bf16, as the JAX edit kernel
// rounds its whole probability rows, so the row's max and sum are taken
// first: in the same step when the keys are one step (a cross site) and by
// a pass of Q K^T over every step before the P V pass otherwise.
template <int D, int BS, int NW, bool LO = false>
__device__ __forceinline__ void attend_bf16(const bf16* __restrict__ qh,
                                            const bf16* __restrict__ kh,
                                            const bf16* __restrict__ vh,
                                            const bf16* __restrict__ vlo,
                                            bf16* __restrict__ oh, int q0, int pixels,
                                            int keys, float scale2, bool accumulate,
                                            bf16* smem) {
  using T = AttnBf16<D, BS, NW, LO>;
  constexpr int LD = T::LD;
  bf16* Qs = smem;
  bf16* Ks = Qs + T::ROWS * LD;   // stage s at Ks + s * BS * LD
  bf16* Vs = Ks + 2 * BS * LD;
  bf16* Vl = Vs + 2 * BS * LD;    // LO: V's low parts
  const bool lo = LO && vlo != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix
  const bf16* Qw = Qs + warp * 16 * LD;
  const int nsteps = (keys + BS - 1) / BS;

  // Every step of keys in turn: the next step lands while body(K, V, key0)
  // computes on this one. Q lands with the first step of the first walk.
  __syncthreads();  // a previous pass of this block is done with the buffers
  land_rows_bf16<D, LD, T::ROWS, T::NT>(Qs, qh, q0, pixels);
  auto walk = [&](auto&& body) {
    land_rows_bf16<D, LD, BS, T::NT>(Ks, kh, 0, keys);
    land_rows_bf16<D, LD, BS, T::NT>(Vs, vh, 0, keys);
    if (lo) land_rows_bf16<D, LD, BS, T::NT>(Vl, vlo, 0, keys);
    cp_async_commit();
    for (int st = 0; st < nsteps; ++st) {
      const int key0 = st * BS;
      if (st + 1 < nsteps) {
        const int nx = (st + 1) & 1;
        land_rows_bf16<D, LD, BS, T::NT>(Ks + nx * BS * LD, kh, key0 + BS, keys);
        land_rows_bf16<D, LD, BS, T::NT>(Vs + nx * BS * LD, vh, key0 + BS, keys);
        if (lo) land_rows_bf16<D, LD, BS, T::NT>(Vl + nx * BS * LD, vlo, key0 + BS, keys);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // this step (and Q) have landed for the whole block
      body(Ks + (st & 1) * BS * LD, Vs + (st & 1) * BS * LD, key0);
      __syncthreads();  // every warp is done with this stage before it lands again
    }
  };

  // s = Q K^T scale2 over a step's keys; keys past `keys` score -inf.
  auto scores = [&](const bf16* Kc, int key0, float (&s)[T::NS][4]) {
#pragma unroll
    for (int n = 0; n < T::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Qw + (lr + 8 * (lm & 1)) * LD + ks * 16 + 8 * (lm >> 1));
#pragma unroll
      for (int n = 0; n < T::NS; n += 2) {
        uint32_t b[4];  // (keys 8n, d lo), (8n, hi), (8n + 8, lo), (8n + 8, hi)
        ldsm_x4(b, Kc + (8 * (n + (lm >> 1)) + lr) * LD + ks * 16 + 8 * (lm & 1));
        mma_bf16_k16(s[n], a, b);
        mma_bf16_k16(s[n + 1], a, b + 2);
      }
    }
    if constexpr (T::TAIL) {
      uint32_t a[2];
      ldsm_x2(a, Qw + (lr + 8 * (lm & 1)) * LD + T::KS * 16);
#pragma unroll
      for (int n = 0; n < T::NS; n += 2) {
        uint32_t b[2];  // keys 8n, keys 8n + 8, the last 8 dims
        ldsm_x2(b, Kc + (8 * (n + (lm & 1)) + lr) * LD + T::KS * 16);
        mma_bf16_k8(s[n], a, b[0]);
        mma_bf16_k8(s[n + 1], a, b[1]);
      }
    }
    const bool ragged = key0 + BS > keys;
#pragma unroll
    for (int n = 0; n < T::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale2;
        if (ragged && key0 + n * 8 + 2 * t + (e & 1) >= keys) s[n][e] = -INFINITY;
      }
  };

  // Rows g (e = 0, 1) and g + 8 (e = 2, 3): running max in log2 units and
  // this thread's share of the running sum (summed over the quad).
  float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  // The online update of m2 and lsum by a step's scores; p = 2^(s - m2)
  // overwrites s, and c is the factor the step rescaled the old sum by.
  auto online = [&](float (&s)[T::NS][4], float (&c)[2]) {
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int n = 0; n < T::NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      c[h] = exp2_ftz(m2[h] - mx[h]);  // 0 on the first step
      m2[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < T::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_ftz(s[n][e] - m2[e >> 1]);  // -inf gives 0
        ps[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) lsum[h] = lsum[h] * c[h] + ps[h];
  };
  auto quad_sum = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
    }
  };

  float acc[T::NO][4];
#pragma unroll
  for (int n = 0; n < T::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // O += P V, P (bf16) from the C fragments of S: n-tiles 2j and 2j + 1 are
  // the A fragment of k-step j. With V's low parts, also O += P V_lo.
  auto pv = [&](const bf16* Vc, const float (&p)[T::NS][4]) {
    const bf16* Vlc = Vl + (Vc - Vs);
#pragma unroll
    for (int j = 0; j < T::KP; ++j) {
      const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                             pack_bf16(p[2 * j][2], p[2 * j][3]),
                             pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                             pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
      const int row = (16 * j + 8 * (lm & 1) + lr) * LD;
#pragma unroll
      for (int part = 0; part < (LO ? 2 : 1); ++part) {
        if (part == 1 && !lo) break;
        const bf16* Vj = (part ? Vlc : Vc) + row;
#pragma unroll
        for (int n = 0; n + 1 < T::NO; n += 2) {
          uint32_t b[4];  // (keys lo, d 8n), (keys hi, 8n), (lo, 8n + 8), (hi, 8n + 8)
          ldsm_x4_t(b, Vj + 8 * (n + (lm >> 1)));
          mma_bf16_k16(acc[n], a, b);
          mma_bf16_k16(acc[n + 1], a, b + 2);
        }
        if constexpr (T::NO % 2) {
          uint32_t b[2];
          ldsm_x2_t(b, Vj + 8 * (T::NO - 1));
          mma_bf16_k16(acc[T::NO - 1], a, b);
        }
      }
    }
  };

  if (nsteps > 1) {  // the rows' max and sum over every step first
    walk([&](const bf16* Kc, const bf16*, int key0) {
      float s[T::NS][4], c[2];
      scores(Kc, key0, s);
      online(s, c);
    });
    quad_sum();
  }
  walk([&](const bf16* Kc, const bf16* Vc, int key0) {
    float s[T::NS][4];
    scores(Kc, key0, s);
    if (nsteps == 1) {
      float c[2];
      online(s, c);
      quad_sum();
    } else {
#pragma unroll
      for (int n = 0; n < T::NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = exp2_ftz(s[n][e] - m2[e >> 1]);
    }
    const float r[2] = {1.f / lsum[0], 1.f / lsum[1]};
#pragma unroll
    for (int n = 0; n < T::NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= r[e >> 1];
    pv(Vc, s);
  });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    if (r >= pixels) continue;
#pragma unroll
    for (int n = 0; n < T::NO; ++n) {
      uint32_t* p = reinterpret_cast<uint32_t*>(oh + (size_t)r * D + n * 8 + 2 * t);
      float x0 = acc[n][2 * h], x1 = acc[n][2 * h + 1];
      if (accumulate) {
        const uint32_t old = *p;
        x0 += bf16_lo(old);
        x1 += bf16_hi(old);
      }
      *p = pack_bf16(x0, x1);
    }
  }
}

}  // namespace p2p
