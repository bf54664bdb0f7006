// Ensemble CRPS terms, forward: for ens x (B, M, P) and target y (B, P),
//
//   t1(b) = sum_{j, p}   |x_bjp - y_bp|
//   t2(b) = sum_{j<k, p} |x_bjp - x_bkp|
//
// Replaces the TPU kernel probunet_tpu/ops/pallas/afcrps.py:_terms_fwd_impl
// (pallas_call of _fwd_kernel).
//
// Bound: HBM bytes. The kernel reads the ensemble once (B*M*P elements; at
// B=128, M=5, P=49152 that is 126 MB in f32) and does M(M+1)/2 abs-diffs
// per pixel, a handful of operations per byte, far below any ridge of the
// card. Design: one thread per pixel, 256 pixels per block, one block per
// (pixel tile, batch element). Each thread loads its pixel's M members
// once, coalesced across the warp for every member, into a column of a
// (M, 256) shared-memory slab (shared memory stands in for a register array
// indexed at run time), takes t1 on the way in and then every j<k pair
// from the slab. Block sums go to per-(batch, tile) partials; a second
// small kernel adds them in a fixed order (common.cuh).
//
// Numerics follow the TPU kernel: for bf16 input each difference is
// rounded to bf16 before abs, every sum is f32; f32 input stays f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace probunet {
namespace {

constexpr int kThreads = 256;  // pixels per block
constexpr int kMaxM = 32;

__device__ __forceinline__ float abs_diff(float a, float b) { return fabsf(a - b); }

__device__ __forceinline__ float abs_diff(__nv_bfloat16 a, __nv_bfloat16 b) {
  const float d = __bfloat162float(a) - __bfloat162float(b);
  return fabsf(__bfloat162float(__float2bfloat16_rn(d)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
afcrps_tile_kernel(const T* __restrict__ ens, const T* __restrict__ tgt,
                   float* __restrict__ partial, int batch, int m, int p, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);  // (m, kThreads), one column per thread
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = tile * kThreads + tid;

  float v1 = 0.f;
  float v2 = 0.f;
  if (pix < p) {  // ragged last tile: out-of-range pixels add nothing
    const T* x = ens + static_cast<size_t>(b) * m * p + pix;
    const T y = tgt[static_cast<size_t>(b) * p + pix];
    for (int j = 0; j < m; ++j) {
      const T xj = x[static_cast<size_t>(j) * p];
      slab[j * kThreads + tid] = xj;
      v1 += abs_diff(xj, y);
    }
    for (int k = 1; k < m; ++k) {
      const T xk = slab[k * kThreads + tid];
      for (int j = 0; j < k; ++j) v2 += abs_diff(slab[j * kThreads + tid], xk);
    }
  }
  const float s1 = block_sum<kThreads>(v1, red);
  const float s2 = block_sum<kThreads>(v2, red);
  if (tid == 0) {
    partial[static_cast<size_t>(b) * ntiles + tile] = s1;
    partial[(static_cast<size_t>(batch) + b) * ntiles + tile] = s2;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sign_f32(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

// Backward (replaces probunet_tpu/ops/pallas/afcrps.py:_terms_bwd_impl,
// pallas_call of _bwd_kernel): with upstream (g1, g2) per batch element,
//
//   dx_j = g1 * sign(x_j - y) + g2 * sum_{k != j} sign(x_j - x_k)
//   dy   = -g1 * sum_j sign(x_j - y)
//
// Signs are taken of the difference in f32 (the sign of a bf16 difference
// rounded to bf16 is the sign of the exact one). The sign counts are
// integers, so dx = g1 * s0 + g2 * count rounds at the same two places as
// the TPU kernel's f32 expression (no FMA contraction: __fmul_rn /
// __fadd_rn), and dx equals the plain version exactly.
//
// Bound: HBM bytes — read ens and tgt once, write dx and dy once (805 MB at
// B=128, M=15, P=49152 in f32: 0.24 ms at 3.35 TB/s). The pair loop is
// M(M-1) compares per pixel. Design as the forward: one thread per pixel,
// its M members in its own column of a (M, 256) shared-memory slab.
template <typename T>
__global__ void __launch_bounds__(kThreads)
afcrps_bwd_kernel(const T* __restrict__ ens, const T* __restrict__ tgt,
                  const float* __restrict__ g1, const float* __restrict__ g2,
                  T* __restrict__ dx, T* __restrict__ dy, int m, int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slab = reinterpret_cast<float*>(smem_raw);  // (m, kThreads)
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int pix = blockIdx.x * kThreads + tid;
  if (pix >= p) return;  // no block-wide sync below
  const T* x = ens + static_cast<size_t>(b) * m * p + pix;
  const float y = to_f32(tgt[static_cast<size_t>(b) * p + pix]);
  for (int j = 0; j < m; ++j) slab[j * kThreads + tid] = to_f32(x[static_cast<size_t>(j) * p]);
  const float gb1 = g1[b];
  const float gb2 = g2[b];
  float s0_sum = 0.f;
  T* d = dx + static_cast<size_t>(b) * m * p + pix;
  for (int j = 0; j < m; ++j) {
    const float xj = slab[j * kThreads + tid];
    const float s0 = sign_f32(xj - y);
    s0_sum += s0;
    float count = 0.f;
    for (int k = 0; k < m; ++k) count += sign_f32(xj - slab[k * kThreads + tid]);
    store(d + static_cast<size_t>(j) * p, __fadd_rn(__fmul_rn(gb1, s0), __fmul_rn(gb2, count)));
  }
  store(dy + static_cast<size_t>(b) * p + pix, __fmul_rn(-gb1, s0_sum));
}

template <typename T>
cudaError_t launch_bwd(const void* ens, const void* tgt, const void* g1, const void* g2,
                       void* dx, void* dy, int batch, int m, int p, cudaStream_t stream) {
  const int ntiles = (p + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(m) * kThreads * sizeof(float);
  afcrps_bwd_kernel<T><<<dim3(ntiles, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(ens), static_cast<const T*>(tgt), static_cast<const float*>(g1),
      static_cast<const float*>(g2), static_cast<T*>(dx), static_cast<T*>(dy), m, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* ens, const void* tgt, void* partial, void* t1, void* t2,
                   int batch, int m, int p, cudaStream_t stream) {
  const int ntiles = (p + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(m) * kThreads * sizeof(T);
  afcrps_tile_kernel<T><<<dim3(ntiles, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(ens), static_cast<const T*>(tgt),
      static_cast<float*>(partial), batch, m, p, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_reduce(static_cast<const float*>(partial), static_cast<float*>(t1),
                static_cast<float*>(t2), batch, ntiles, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

extern "C" {

int afcrps_tile_pixels() { return probunet::kThreads; }

int afcrps_max_members() { return probunet::kMaxM; }

// ens (B, M, P) and tgt (B, P), both f32 (is_bf16 = 0) or both bf16
// (is_bf16 = 1), contiguous; partial: (2, B, ceil(P / tile)) f32 scratch;
// t1, t2: (B,) f32. Returns cudaGetLastError() after the launches.
int afcrps_terms_fwd(const void* ens, const void* tgt, void* partial, void* t1, void* t2,
                     int batch, int m, int p, int is_bf16, void* stream) {
  if (m < 1 || m > probunet::kMaxM || batch < 1 || p < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? probunet::launch<__nv_bfloat16>(ens, tgt, partial, t1, t2, batch, m, p, s)
              : probunet::launch<float>(ens, tgt, partial, t1, t2, batch, m, p, s);
  return static_cast<int>(err);
}

// ens (B, M, P) and tgt (B, P) as for afcrps_terms_fwd; g1, g2: (B,) f32;
// dx (B, M, P) and dy (B, P) in the input type. Returns cudaGetLastError().
int afcrps_terms_bwd(const void* ens, const void* tgt, const void* g1, const void* g2,
                     void* dx, void* dy, int batch, int m, int p, int is_bf16, void* stream) {
  if (m < 1 || m > probunet::kMaxM || batch < 1 || p < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? probunet::launch_bwd<__nv_bfloat16>(ens, tgt, g1, g2, dx, dy, batch, m, p, s)
              : probunet::launch_bwd<float>(ens, tgt, g1, g2, dx, dy, batch, m, p, s);
  return static_cast<int>(err);
}

}  // extern "C"
