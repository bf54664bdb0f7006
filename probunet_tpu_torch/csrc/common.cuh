// Shared pieces of the CRPS-terms kernels: a fixed-order block sum and the
// second pass that adds the per-(batch, tile) partials.
//
// The TPU kernels carry t1/t2 from one grid step to the next, because a TPU
// grid runs in order. Hopper runs blocks in no order, so each block writes
// its own partial sums and a second kernel (reduce_partials_block) adds
// them per batch element in a fixed order. No float atomics: results are
// bit-reproducible from run to run.
#pragma once

#include <cuda_runtime.h>

namespace probunet {
namespace {  // internal linkage: each .cu file gets its own copy

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block; the total is valid in thread 0 only. `red` holds
// one float per warp. Every thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  static_assert(kThreads % 32 == 0, "block size must be a multiple of 32");
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  }
  __syncthreads();  // red may be reused by the caller
  return total;
}

constexpr int kReduceThreads = 256;

// partial: (2, B, ntiles) f32 -> t1 (B,), t2 (B,), one block per (b, term)
// of a (B, 2) grid of kReduceThreads. The body of each source's reduce
// kernel, so that a profile files every reduce under its own kernel.
__device__ __forceinline__ void reduce_partials_block(const float* __restrict__ partial,
                                                      float* __restrict__ t1,
                                                      float* __restrict__ t2, int batch,
                                                      int ntiles) {
  __shared__ float red[kReduceThreads / 32];
  const int b = blockIdx.x;
  const int which = blockIdx.y;
  const float* row = partial + (static_cast<size_t>(which) * batch + b) * ntiles;
  float s = 0.f;
  for (int i = threadIdx.x; i < ntiles; i += kReduceThreads) s += row[i];
  s = block_sum<kReduceThreads>(s, red);
  if (threadIdx.x == 0) (which == 0 ? t1 : t2)[b] = s;
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ t1,
                       float* __restrict__ t2, int batch, int ntiles) {
  reduce_partials_block(partial, t1, t2, batch, ntiles);
}

inline void launch_reduce(const float* partial, float* t1, float* t2, int batch,
                          int ntiles, cudaStream_t stream) {
  reduce_partials_kernel<<<dim3(batch, 2), kReduceThreads, 0, stream>>>(
      partial, t1, t2, batch, ntiles);
}

// Column sums of a row-major (rows, cols) f32 matrix: out[c] = sum_r in[r, c],
// in a fixed order (row group g = r % 8 first, then the 8 groups in order).
// A warp reads 32 neighbouring columns of one row, so every load is
// coalesced. grid ceil(cols / 32), 256 threads.
constexpr int kColThreads = 256;
constexpr int kColGroups = kColThreads / 32;

__global__ void __launch_bounds__(kColThreads)
column_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int rows, int cols) {
  __shared__ float red[kColGroups][33];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int r = g; r < rows; r += kColGroups) s += in[static_cast<size_t>(r) * cols + col];
  }
  red[g][lane] = s;
  __syncthreads();
  if (g == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kColGroups; ++i) t += red[i][lane];
    out[col] = t;
  }
}

inline void launch_column_sum(const float* in, float* out, int rows, int cols,
                              cudaStream_t stream) {
  column_sum_kernel<<<(cols + 31) / 32, kColThreads, 0, stream>>>(in, out, rows, cols);
}

}  // namespace
}  // namespace probunet
