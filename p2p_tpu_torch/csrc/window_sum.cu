// The bf16 sums of the norms' backward, in the order and at the roundings of
// the JAX package's compiled program.
//
// In the bf16 group norm and layer norm (p2p_tpu/models/nn.py:95-163) the
// mean, the inverse deviation and the shift are rounded to bf16 and
// broadcast over the pixels (and the channels of a group) or over the
// channels. The backward of each broadcast is a sum of bf16 cotangents,
// which XLA compiles with a bf16 accumulator: every add is done in f32 and
// rounded to bf16. Its CPU compiler also rewrites each such reduction into a
// tree (xla/service/tree_reduction_rewriter.cc, window 32): every reduced
// dimension longer than 32 is cut into windows of 32, padded with zeros
// half below and half above to a multiple of 32; each window is summed
// sequentially, in row-major order of its positions, from 0; the windows
// are then reduced again the same way until no reduced dimension is longer
// than 32, and what is left is summed sequentially. Dimensions of 32 or
// fewer are a window of their own. Summed in f32 and rounded once, as
// PyTorch's sum does, a bf16 null-text gradient stands about a tenth as far
// from the f32 one as JAX's stands from its own (PERF.md §6).
//
// One launch per stage of that tree, all stages from one call. A window's
// sum is a chain of dependent adds, so the kernels only make the loads
// cheap:
//  - window_sum_block_bf16_kernel (windows of more than SMALL_WINDOW
//    positions: a group norm's mean over 32 x 32 pixels x the channels of a
//    group, its inverse deviation and shift over 32 x 32 pixels): a block
//    per window. Its threads stage CHUNK positions at a time in shared
//    memory, in the window's row-major order, all loads in flight together,
//    and one thread runs the chain from there, 32 positions read ahead of
//    its adds, while the other warps stage the next chunk (2 x 8 KB).
//  - window_sum_bf16_kernel (small windows: a layer norm's 32 channels, the
//    later stages): a thread per window, reading its positions itself.
// The input is any strided view with its dimensions in the JAX package's
// order (the wrapper permutes the port's NCHW group to NHWC without a
// copy); the output is contiguous and holds bf16 values, the input of the
// next stage. No atomics: each output element is one thread's fixed
// sequence, so the result is bitwise the plain version's
// (kernels/reduce.py) and equal across runs.
//
// Each step is one bf16 add (`__hadd`, a single rounding of the exact sum)
// in place of XLA's f32 add and rounding to bf16: the two agree on every
// pair of bf16 values. Their f32 sum is exact when their exponents differ by
// 15 or less (it needs at most 24 bits), so both round the exact sum once;
// when they differ by more, the smaller is under 2^-15 of the larger, far
// inside half a bf16 ulp, and both give the larger unchanged.
//
// The work is one add a summed element; the chain of a window (up to
// 32 x 32 x 32 positions) bounds a launch more than its bytes or its adds
// do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 5;
constexpr int UNROLL = 8;
constexpr int THREADS = 128;        // window_sum_bf16_kernel
constexpr int BLOCK_THREADS = 256;  // window_sum_block_bf16_kernel
constexpr int CHUNK = 4096;         // positions staged in shared memory at a time
constexpr int CHAIN = 32;           // positions read ahead of the chain's adds
constexpr int SMALL_WINDOW = 64;    // at most this many positions: a thread a window

struct Geom {
  long long size[MAXD];    // input extents, in the JAX package's order
  long long stride[MAXD];  // input strides, in elements
  int w[MAXD];             // window extent (1 on a kept dimension)
  int lo[MAXD];            // zeros padded below
  int n[MAXD];             // output extents: windows per dimension
};

// The window of output element o: its first position in each dimension.
__device__ __forceinline__ void window_start(const Geom& g, long long o, int* start) {
#pragma unroll
  for (int d = MAXD - 1; d >= 0; --d) {
    const int od = static_cast<int>(o % g.n[d]);
    o /= g.n[d];
    start[d] = od * g.w[d] - g.lo[d];
  }
}

__global__ void __launch_bounds__(THREADS)
window_sum_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       __nv_bfloat16* __restrict__ y, Geom g,
                       long long total, long long wcount) {
  const long long o = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (o >= total) return;
  int start[MAXD];
  window_start(g, o, start);
  int t[MAXD] = {0, 0, 0, 0, 0};  // position in the window, row-major
  __nv_bfloat16 acc = __float2bfloat16_rn(0.f);
  for (long long p = 0; p < wcount; p += UNROLL) {
    __nv_bfloat16 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      v[u] = __float2bfloat16_rn(0.f);  // a padded position adds a zero, as XLA's does
      if (p + u < wcount) {
        bool inside = true;
        long long off = 0;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          const long long i = start[d] + t[d];
          inside = inside && i >= 0 && i < g.size[d];
          off += i * g.stride[d];
        }
        if (inside) v[u] = x[off];
#pragma unroll
        for (int d = MAXD - 1; d >= 0; --d) {
          if (++t[d] < g.w[d]) break;
          t[d] = 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u < wcount) acc = __hadd(acc, v[u]);
  }
  y[o] = acc;
}

// Stages positions [base, base + len) of the window at `start` into `buf`,
// in the window's row-major order, by the threads from `first` on (the
// callers).
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ x, const Geom& g,
                                      const int* start, int base, int len, int first,
                                      __nv_bfloat16* buf) {
  for (int i = static_cast<int>(threadIdx.x) - first; i < len;
       i += BLOCK_THREADS - first) {
    int p = base + i;
    bool inside = true;
    long long off = 0;
#pragma unroll
    for (int d = MAXD - 1; d >= 0; --d) {
      const long long idx = start[d] + p % g.w[d];
      p /= g.w[d];
      inside = inside && idx >= 0 && idx < g.size[d];
      off += idx * g.stride[d];
    }
    buf[i] = inside ? x[off] : __float2bfloat16_rn(0.f);  // padding adds a zero
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS)
window_sum_block_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ y, Geom g, int wcount) {
  __shared__ __align__(16) __nv_bfloat16 buf[2][CHUNK];
  int start[MAXD];
  window_start(g, blockIdx.x, start);
  // Warp 0's first lane runs the chain over one chunk while warps 1.. stage
  // the next.
  stage(x, g, start, 0, min(CHUNK, wcount), 0, buf[0]);
  __syncthreads();
  __nv_bfloat16 acc = __float2bfloat16_rn(0.f);
  for (int base = 0, c = 0; base < wcount; base += CHUNK, ++c) {
    const int len = min(CHUNK, wcount - base);
    if (threadIdx.x >= 32 && base + CHUNK < wcount)
      stage(x, g, start, base + CHUNK, min(CHUNK, wcount - base - CHUNK), 32,
            buf[(c + 1) & 1]);
    if (threadIdx.x == 0) {
      const __nv_bfloat16* b = buf[c & 1];
      int i = 0;
      for (; i + CHAIN <= len; i += CHAIN) {
        uint4 raw[CHAIN / 8];  // eight bf16 values each
#pragma unroll
        for (int u = 0; u < CHAIN / 8; ++u) raw[u] = reinterpret_cast<const uint4*>(b + i)[u];
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(raw);
#pragma unroll
        for (int u = 0; u < CHAIN; ++u) acc = __hadd(acc, v[u]);
      }
      for (; i < len; ++i) acc = __hadd(acc, b[i]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) y[blockIdx.x] = acc;
}

}  // namespace

// Every stage of one sum. x: the strided bf16 input (ndim <= 5 dimensions);
// plan: its extents and strides (ndim each), then for each of the nstages
// stages the window, low padding and output extents (ndim each); buf: the
// stages' contiguous bf16 outputs, one after another, the last the sum.
// Returns a cudaError_t (0 on success).
extern "C" int p2p_window_sum_bf16(const void* x, void* buf, int ndim, int nstages,
                                   const long long* plan, void* stream) {
  if (ndim < 1 || ndim > MAXD || nstages < 1) return cudaErrorInvalidValue;
  const int pad = MAXD - ndim;  // leading unit dimensions
  const auto st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(buf);
  Geom g;
  for (int d = 0; d < MAXD; ++d) {
    g.size[d] = d < pad ? 1 : plan[d - pad];
    g.stride[d] = d < pad ? 0 : plan[ndim + d - pad];
  }
  for (int k = 0; k < nstages; ++k) {
    const long long* sp = plan + 2 * ndim + 3 * ndim * k;
    long long total = 1, wcount = 1;
    for (int d = 0; d < MAXD; ++d) {
      g.w[d] = d < pad ? 1 : static_cast<int>(sp[d - pad]);
      g.lo[d] = d < pad ? 0 : static_cast<int>(sp[ndim + d - pad]);
      g.n[d] = d < pad ? 1 : static_cast<int>(sp[2 * ndim + d - pad]);
      total *= g.n[d];
      wcount *= g.w[d];
    }
    if (total == 0) return 0;
    if (wcount > SMALL_WINDOW) {
      window_sum_block_bf16_kernel<<<static_cast<unsigned>(total), BLOCK_THREADS, 0, st>>>(
          in, out, g, static_cast<int>(wcount));
    } else {
      const long long blocks = (total + THREADS - 1) / THREADS;
      window_sum_bf16_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
          in, out, g, total, wcount);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // The next stage reads this one's contiguous output.
    long long stride = 1;
    for (int d = MAXD - 1; d >= 0; --d) {
      g.size[d] = g.n[d];
      g.stride[d] = stride;
      stride *= g.n[d];
    }
    in = out;
    out += total;
  }
  return 0;
}

// The message of a CUDA error code, for the Python wrappers.
extern "C" const char* p2p_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
