// Tensor-core products at f32 accuracy ("3xTF32") for the port's Hopper
// kernels (flash_attn.cu at d = 40 and d = 512, flash_attn_bwd.cu,
// fused_edit.cu).
//
// A TF32 tensor-core product keeps 10 mantissa bits of each operand, about
// three decimal digits, too few for the f32 reference these kernels are held
// to. Each f32 operand x is therefore split into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (cvt.rna.tf32.f32), and a
// product is taken as lo*hi + hi*lo + hi*hi into the f32 accumulator; the
// lo*lo term is below f32 rounding and is dropped. That is three mma.sync
// instructions per product instead of one, on units that run TF32 at 495
// TFLOP/s against the CUDA cores' 67 TFLOP/s in f32. The plain emulation of
// this arithmetic is p2p_tpu_torch/kernels/tf32.py (tf32_round, mm_3xtf32).
//
// Fragments of mma.sync.m16n8k8 (TF32 in, f32 accumulator), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// The order of the k index inside one mma is free as long as A and B agree.
// So a C fragment can serve as the A fragment of the next product directly:
// take c0, c2 as a0, a1 (k = t) and c1, c3 as a2, a3 (k = t + 4), and read
// B's row 2t as k = t and row 2t + 1 as k = t + 4 (see load_b_perm). The
// same order (k = t <-> 2t, k = t + 4 <-> 2t + 1) lets a thread's two B
// values be neighbours in memory, so a tile stored by split_pair gives a
// whole split B fragment in one 16-byte load (load_b_pair).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace p2p {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to within f32 rounding, hi and lo each a TF32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

constexpr int HI = 0, LO = 1;

// An operand fragment of N values, split once: x[HI] and x[LO].
template <int N>
struct Frag {
  uint32_t x[2][N];
  __device__ __forceinline__ void set(int i, float v) {
    split_tf32(v, x[HI][i], x[LO][i]);
  }
};
using FragA = Frag<4>;
using FragB = Frag<2>;

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three products of 3xTF32 for a group of tiles: f(ta, tb) issues the
// group's mma instructions with A's part ta and B's part tb; the two small
// terms come first. Taking each term across the whole group keeps
// consecutive mma instructions independent of each other, so a warp issues
// them back to back instead of waiting on each result.
template <class F>
__device__ __forceinline__ void mma_3xtf32(F&& f) {
  f(LO, HI);
  f(HI, LO);
  f(HI, HI);
}

// Where fragments are read from: an f32 tile whose values are split as
// they are read (Raw), or a tile split beforehand by split_tile (Split: hi
// parts at hi, lo parts at the same offsets from lo).
struct Raw {
  const float* p;
  __device__ __forceinline__ Raw at(int off) const { return {p + off}; }
  template <int N>
  __device__ __forceinline__ void get(uint32_t (&x)[2][N], int i, int off) const {
    split_tf32(p[off], x[HI][i], x[LO][i]);
  }
};
struct Split {
  const float* hi;
  const float* lo;
  __device__ __forceinline__ Split at(int off) const { return {hi + off, lo + off}; }
  template <int N>
  __device__ __forceinline__ void get(uint32_t (&x)[2][N], int i, int off) const {
    x[HI][i] = __float_as_uint(hi[off]);
    x[LO][i] = __float_as_uint(lo[off]);
  }
};

// The A fragment of rows [0, 16) and columns [0, 8) of a row-major tile
// with row stride ld (ld % 8 == 4 reads it without bank conflicts).
template <class T>
__device__ __forceinline__ void load_a(FragA& f, const T& src, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  src.get(f.x, 0, g * ld + t);
  src.get(f.x, 1, (g + 8) * ld + t);
  src.get(f.x, 2, g * ld + t + 4);
  src.get(f.x, 3, (g + 8) * ld + t + 4);
}

// The B fragment of B = X^T for a row-major X (8 rows n, 8 columns k):
// b = (X[g][t], X[g][t + 4]) (ld % 8 == 4: no bank conflicts).
template <class T>
__device__ __forceinline__ void load_bt(FragB& f, const T& src, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  src.get(f.x, 0, g * ld + t);
  src.get(f.x, 1, g * ld + t + 4);
}

// The B fragment of a row-major B (8 rows k, 8 columns n):
// b = (B[t][g], B[t + 4][g]) (ld % 16 == 8: no bank conflicts).
template <class T>
__device__ __forceinline__ void load_b(FragB& f, const T& src, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  src.get(f.x, 0, t * ld + g);
  src.get(f.x, 1, (t + 4) * ld + g);
}

// load_b with the k order of an A fragment taken from a C fragment:
// b = (B[2t][g], B[2t + 1][g]) (ld % 8 == 4: no bank conflicts).
template <class T>
__device__ __forceinline__ void load_b_perm(FragB& f, const T& src, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  src.get(f.x, 0, 2 * t * ld + g);
  src.get(f.x, 1, (2 * t + 1) * ld + g);
}

// The A fragment made of a C fragment c (16 x 8), k permuted as above.
__device__ __forceinline__ void a_from_c(FragA& f, const float* c) {
  f.set(0, c[0]);
  f.set(1, c[2]);
  f.set(2, c[1]);
  f.set(3, c[3]);
}

// Two neighbouring operands split once, packed as {hi(x0), hi(x1), lo(x0),
// lo(x1)}: the B fragment b0 = x0, b1 = x1 in the k order above.
__device__ __forceinline__ uint4 split_pair(float x0, float x1) {
  uint4 r;
  split_tf32(x0, r.x, r.z);
  split_tf32(x1, r.y, r.w);
  return r;
}

// The B fragment packed by split_pair at p (16-byte aligned): one load.
__device__ __forceinline__ void load_b_pair(FragB& f, const float* p) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  f.x[HI][0] = x.x;
  f.x[HI][1] = x.y;
  f.x[LO][0] = x.z;
  f.x[LO][1] = x.w;
}

// Split rows x cols values of a shared tile (row stride ld) in place into
// their hi parts, writing the lo parts at the same offsets from lo, by NT
// threads, four values at a time; Split{t, lo} then reads both without
// converting.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void split_tile(float* t, float* lo) {
  static_assert(COLS % 4 == 0 && LD % 4 == 0, "split_tile works on float4");
  constexpr int C4 = COLS / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
    const int off = i / C4 * LD + i % C4 * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(t + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// 2^x in one MUFU.EX2 (results below 2^-126 flush to zero, far below f32
// rounding of a softmax row sum of at least 1; exp2f adds a denormal-range
// fix-up around it). 2^-inf = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Asynchronous 16-byte global-to-shared copy; src_bytes == 0 fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Asynchronous 4-byte copy; ok == false fills a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// Columns [0, W) of rows [row0, row0 + ROWS) of a row-major matrix with row
// stride SLD into shared memory with row stride LD, by NT threads; rows at
// or past rows_total are zero-filled. W, SLD and LD are multiples of 4 and
// src is 16-byte aligned.
template <int W, int SLD, int LD, int ROWS, int NT>
__device__ __forceinline__ void cp_async_rows(float* dst, const float* src,
                                              int row0, int rows_total) {
  constexpr int C4 = W / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool ok = row0 + r < rows_total;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)(row0 + r) * SLD + c : src,
               ok ? 16 : 0);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace p2p
