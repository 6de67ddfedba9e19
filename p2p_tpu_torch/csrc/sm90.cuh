// Hopper's own instructions, shared by the kernels written on them
// (flash_fwd_sm90.cu: K1/K3 in bf16 at d = 40, 64 and 512; flash_fwd_tf32_sm90.cu:
// K1/K3 in f32 at d = 64; flash_bwd_sm90.cu: K4's two passes in bf16 at d = 40
// and 64; flash_bwd_tf32_sm90.cu: K4's two passes in f32 at d = 64): mbarriers, TMA loads of bf16 rows into 64-wide boxes
// and of f32 rows into 32-wide ones through 3-D tensor maps with the
// 128-byte swizzle, wgmma descriptors, the wgmma forms those kernels issue
// and the loads of register A fragments, and the host-side encoders of the
// tensor maps.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace p2p {

// --------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the barrier's phase of this parity has completed. A phase that
// has not completed after 2^35 clocks (some 17 s) means a load was lost:
// trap, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// --------------------------------------------------------------------- TMA

// The map's box at (0, row, bh) into shared memory at dst, completing
// its bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// The map's box at (col, row, bh): tma_load with a column coordinate, for
// rows wider than one box.
__device__ __forceinline__ void tma_load_col(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// Order this thread's ordinary writes to shared memory before later reads
// and writes of the async proxy (wgmma operands, TMA), once a barrier has
// passed them on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ------------------------------------------------------------------- wgmma

// Descriptor of a tile in shared memory laid out as TMA's 128-byte swizzle
// writes it (rows of 128 bytes, 8-row atoms of 1024 bytes, 1024-aligned):
// start address, leading and stride byte offsets (16-byte units), layout 1
// (128-byte swizzle). K-major (the operand's rows along M or N, its 64
// columns the reduction): the stride offset steps 8 rows, the leading one is
// unused (a k16 step lies inside one swizzle row; 1 by convention), and a
// k16 step adds 32 bytes (2 units). MN-major (a tile as stored, [k][n], as B
// with N = 64 = one swizzle row): the stride offset steps 8 rows of k; the
// leading one steps 64 columns (one swizzle row of B to the next: unused at
// N = 64, where it is given the same 1024 bytes; the box bytes apart at
// N = 256); a k16 step adds 16 rows (2048 bytes, 128 units) of a box.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo16 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
constexpr uint32_t LBO_K_MAJOR = 1;
constexpr uint32_t LBO_MN_MAJOR = 1024 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of registers an in-flight wgmma owns
// across the points where the program hands them over.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define P2P_F8(a, i)                                                                  \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]),         \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// Accumulator layout of a 64 x N product (thread tw of the warpgroup,
// w = tw / 32, g = lane / 4, t = lane % 4): element i is row 16 w + g +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2. Packed two columns to a
// register, elements 8j .. 8j + 7 are the A-register fragment of the k16
// step j of a next product whose reduction runs over those N columns.

// d (64 x 128, f32) = [d +] A (64 x 16) B (16 x 128), A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), P2P_F8(d, 16), P2P_F8(d, 24), P2P_F8(d, 32), P2P_F8(d, 40), P2P_F8(d, 48), P2P_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = [d +] A (64 x 16) B (16 x 64), A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), P2P_F8(d, 16), P2P_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256), A K-major and B MN-major
// (as stored, [k][n]) in shared memory: B's 256 columns are four 64-column
// swizzle rows apart by the descriptor's leading byte offset.
__device__ __forceinline__ void wgmma_ss_n256_tb(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), P2P_F8(d, 16), P2P_F8(d, 24), P2P_F8(d, 32), P2P_F8(d, 40), P2P_F8(d, 48), P2P_F8(d, 56),
        P2P_F8(d, 64), P2P_F8(d, 72), P2P_F8(d, 80), P2P_F8(d, 88), P2P_F8(d, 96), P2P_F8(d, 104), P2P_F8(d, 112), P2P_F8(d, 120)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), P2P_F8(d, 16), P2P_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 40, f32) += A (64 x 16, bf16 in registers) B (16 x 40), B
// MN-major in shared memory: the first 40 columns of a 64-column swizzled
// tile, as wgmma_rs_n64 reads all 64.
__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) = [d +] A (64 x 16, bf16 in registers) B (16 x 64), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64_kb(float (&d)[32], const uint32_t* a, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), P2P_F8(d, 16), P2P_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) = [d +] A (64 x 16, bf16 in registers) B (16 x 128), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128_kb(float (&d)[64], const uint32_t* a,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), P2P_F8(d, 16), P2P_F8(d, 24), P2P_F8(d, 32), P2P_F8(d, 40), P2P_F8(d, 48), P2P_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The tf32 forms (flash_fwd_tf32_sm90.cu and flash_bwd_tf32_sm90.cu, K1/K3
// and K4 in f32). wgmma has no transposed form for tf32: both operands in
// shared memory are K-major. A k8 step is 32 bytes of a 128-byte swizzle
// row, as a bf16 k16 step is, so the descriptors above serve unchanged; a
// row of 64 f32 spans two swizzle rows, which lie in two separate 32-column
// tiles. The register A fragment of a k8 step (thread tw of the warpgroup,
// w = tw / 32, g = lane / 4, t = lane % 4): a0 (16 w + g, t), a1 (16 w + g
// + 8, t), a2 (16 w + g, t + 4), a3 (16 w + g + 8, t + 4); the accumulator
// layout is the one above.

// d (64 x 32, f32) = [d +] A (64 x 8) B (8 x 32), tf32, A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_tf32_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) = [d +] A (64 x 8, tf32 in registers) B (8 x 32), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_tf32_n32(float (&d)[16], const uint32_t* a, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = [d +] A (64 x 8, tf32 in registers) B (8 x 64), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32], const uint32_t* a,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : P2P_F8(d, 0), P2P_F8(d, 8), P2P_F8(d, 16), P2P_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef P2P_F8

// The A-register fragments of the first KS k16 steps (KS <= 4) of a
// warpgroup's 64 rows of 64 bf16 columns, from a tile in the 128-byte
// swizzle at `rows` (1024-aligned): the warp's 16 rows, by ldmatrix, whose
// fragment of a 16 x 16 slab is wgmma's. Chunk ch (16 bytes) of row r lies
// at r * 128 + (ch ^ r % 8) * 16.
template <int KS>
__device__ __forceinline__ void load_a_sw128(uint32_t (&a)[4 * KS], uint32_t rows) {
  static_assert(KS >= 1 && KS <= 4, "a 128-byte row holds four k16 steps");
  const int lane = threadIdx.x & 31, w = (threadIdx.x & 127) >> 5;
  const int r = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int ch = 2 * ks + (lane >> 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[4 * ks]), "=r"(a[4 * ks + 1]), "=r"(a[4 * ks + 2]), "=r"(a[4 * ks + 3])
                 : "r"(rows + r * 128 + ((ch ^ (r & 7)) << 4)));
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (so the library needs no -lcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a contiguous (bh, rows, d) bf16 tensor, d = 40, 64 or 512:
// dims (d, rows, bh), box (64, box_rows, 1), 128-byte swizzle (a box row of
// 64 bf16 is one swizzle row). Out-of-bounds elements read as zeros: rows
// past `rows`, and at d = 40 the box's columns 40..63, so a 40-wide row
// lands as a 64-wide one with zeros after it (its 80-byte stride is a
// multiple of 16, as TMA requires; the zeros count toward the box's bytes).
// With `narrow` (d < 64) the box is (d, box_rows, 1) instead: TMA lands each
// row in the first 2 d bytes of its 128-byte swizzle row, counts only those
// bytes, and leaves the rest of the swizzle row as it was (the layout stays
// the 64-column one): the d = 40 forward, whose K and V stream through such
// boxes, ran 1.2x as long with the zero-filled ones on an H100 80GB HBM3 at
// 700 W (tools/k1_d40_variants.py). Its Q, landed once a block, keeps the
// zero fill, as do the K4 passes' streamed tiles until the narrow landing is
// measured there (it needs their rings zeroed once). At d = 512 a row lands as
// eight boxes, loaded by tma_load_col at columns 0, 64, .... A box never
// reads the next head's rows.
inline bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d, int rows,
                        int bh, int box_rows, bool narrow = false) {
  constexpr int BOX_COLS = 64;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)2 * d, (cuuint64_t)rows * 2 * d};
  cuuint32_t box[3] = {(cuuint32_t)BOX_COLS, (cuuint32_t)box_rows, 1};
  if (narrow) box[0] = d;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a contiguous (bh, rows, d) f32 tensor, d a multiple of 32:
// dims (d, rows, bh), box (32, box_rows, 1), 128-byte swizzle (a box row of
// 32 f32 is one swizzle row; a row of d lands as d / 32 boxes, loaded by
// tma_load_col at columns 0, 32, ...). Rows past `rows` read as zeros; a
// box never reads the next head's rows.
inline bool encode_rows_f32(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d, int rows,
                            int bh, int box_rows) {
  constexpr int BOX_COLS_F32 = 32;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)4 * d, (cuuint64_t)rows * 4 * d};
  const cuuint32_t box[3] = {(cuuint32_t)BOX_COLS_F32, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace p2p
