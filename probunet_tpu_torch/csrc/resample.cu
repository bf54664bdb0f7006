// Kernel G: the non-overlapping k x k window mean of a channels-last field,
// in XLA's order of additions.
//
// No TPU kernel: the JAX package's avg_pool (probunet_tpu/ops/resample.py:31)
// is a reshape-mean that XLA lowers to one reduction. On the CPU, XLA adds a
// window's k*k terms one by one in row-major order (row i, then column j),
// starting from zero, and multiplies the sum by f32(1 / k^2). G keeps one f32
// accumulator an output element and adds in that order, so its output is the
// JAX package's, and the plain version's, bit for bit:
//
//   out[n, a, b, c] = (((0 + x[n, a*k, b*k, c]) + x[n, a*k, b*k + 1, c]) + ...
//                      + x[n, a*k + k-1, b*k + k-1, c]) * inv_area
//
// x: (items, H, W, C) f32 and out: (items, H/k, W/k, C) f32, row-major.
//
// A block takes one output row a of one item, and a tile of tw output
// columns. Route "smem" (k*k*C*4 bytes an output column fit 48 KB): its
// 256 threads copy the tile's k input rows (k segments of tw*k*C contiguous
// floats) into shared memory with coalesced loads, then each of the tile's
// tw*C outputs is summed by one thread from shared memory. Route "global"
// (wider C): each thread sums its output straight from device memory.
//
// Bound: the bytes, x read once and out written once; at the main path's
// pooling (128, 128, 128, 3) f32, k = 16, 25.2 MB, 7.5 us at 3.35 TB/s.

#include <cuda_runtime.h>

#include <algorithm>

namespace probunet {
namespace {

constexpr int kThreads = 256;
constexpr int kSmemFloats = 12288;   // 48 KB

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
window_mean_kernel(const float* __restrict__ x, float* __restrict__ out, int h, int w, int c,
                   int k, int tw, int tiles, float inv_area) {
  extern __shared__ float tile[];
  const int ho = h / k;
  const int wo = w / k;
  const long long blk = blockIdx.x;
  const int t = static_cast<int>(blk % tiles);
  const long long row = blk / tiles;   // item * ho + a
  const int a = static_cast<int>(row % ho);
  const long long item = row / ho;
  const int b0 = t * tw;
  const int nb = min(tw, wo - b0);
  const long long row_stride = static_cast<long long>(w) * c;
  // the tile's first input element: row a*k of the item, column b0*k
  const float* base = x + (item * h + static_cast<long long>(a) * k) * row_stride +
                      static_cast<long long>(b0) * k * c;
  const float* src = base;
  long long stride = row_stride;
  if constexpr (kSmem) {
    const int seg = nb * k * c;   // contiguous floats of one input row
    for (int e = threadIdx.x; e < k * seg; e += kThreads) {
      const int i = e / seg;
      const int r = e - i * seg;
      tile[e] = base[i * row_stride + r];
    }
    __syncthreads();
    src = tile;
    stride = seg;
  }
  float* dst = out + (row * wo + b0) * c;
  for (int o = threadIdx.x; o < nb * c; o += kThreads) {
    const int bb = o / c;
    const int ch = o - bb * c;
    const float* p = src + static_cast<long long>(bb) * k * c + ch;
    float acc = 0.f;
    for (int i = 0; i < k; ++i) {
      const float* q = p + i * stride;
      for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, q[j * c]);
    }
    dst[o] = __fmul_rn(acc, inv_area);
  }
}

}  // namespace
}  // namespace probunet

extern "C" {

// x: (items, h, w, c) f32 row-major; out: (items, h/k, w/k, c) f32 row-major,
// written. inv_area: f32(1 / k^2). One launch; cudaErrorInvalidValue for a
// shape G does not take (k < 1, h or w not divisible by k, an empty or too
// large grid).
int window_mean_f32(const void* x, void* out, long long items, int h, int w, int c, int k,
                    float inv_area, void* stream) {
  if (items <= 0 || c <= 0 || k < 1 || h < k || w < k || h % k || w % k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wo = w / k;
  const long long per_column = static_cast<long long>(k) * k * c;
  const bool smem = per_column <= probunet::kSmemFloats;
  int tw = smem ? static_cast<int>(probunet::kSmemFloats / per_column) : wo;
  tw = std::max(1, std::min({tw, wo, std::max(1, probunet::kThreads / c)}));
  const int tiles = (wo + tw - 1) / tw;
  const long long blocks = items * (h / k) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem) {
    const size_t bytes = sizeof(float) * per_column * tw;
    probunet::window_mean_kernel<true><<<static_cast<unsigned>(blocks), probunet::kThreads,
                                         bytes, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), h, w, c, k, tw, tiles,
        inv_area);
  } else {
    probunet::window_mean_kernel<false><<<static_cast<unsigned>(blocks), probunet::kThreads,
                                          0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), h, w, c, k, tw, tiles,
        inv_area);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
