// Zero-storage inverted dropout: one launch serves forward (on x) and
// backward (on the cotangent), since the mask is recomputed from the seed.
//
// Replaces the TPU kernel probunet_tpu/ops/pallas/dropout.py:_apply
// (pallas_call of _kernel). Its mask is a murmur3-finalizer hash of the
// position inside a (rb, 128) block of the flattened tensor, two seed words
// and the block index (fused_gn.py:_dropout_uniform). This kernel computes
// the same hash at the same block coordinates, so its masks equal the TPU
// kernel's bit for bit:
//
//   e (flat index) -> row r = e / 128, salt = r / rb,
//   z = (r % rb) * 128 + e % 128 + seed_a * 2654435761 + seed_b + salt * 40503
//   z = fmix32(z);  u = (z >> 8) * 2^-24;  y = u >= p ? x * scale : 0
//
// with every sum and product in uint32 (wrapping), scale = f32(1 / (1 - p))
// and the product in f32, rounded once to the tensor's type.
//
// A data-parallel rank holds a slab of the global batch: the kernel then
// takes the slab's element offset into the global tensor and the global
// tensor's rb, and hashes the global coordinates e = offset + local index,
// so the slab's mask is the global mask's rows. Offset 0 and the tensor's
// own rb give the masks above. Under a spatial mesh a rank's block of each
// item's rows is not one contiguous range of the global tensor: with the
// block's per-item size n_local and the global per-item size n_item, local
// element (b, i) sits at e = offset + b * n_item + i, offset being the
// block's first element (b0 * n_item + h0 * W * C). Where the two sizes are
// equal that is offset + local index, and the launch takes the kernel
// without the mapping (kMapped = false), the code of the unsharded kernel.
//
// Bound: HBM bytes. It reads x once and writes y once (4 bytes per bf16
// element; at the flagship's (128, 128, 128, 32) bf16 activation 268 MB,
// 0.080 ms at 3.35 TB/s). No mask bytes are stored or read in either
// direction. Design: each thread owns 8 consecutive elements (one 16-byte
// load and store in bf16, two in f32); 8 divides 128, so the 8 share a row
// and its salt. The hash is ~12 integer operations per element, far under
// the integer rate the bytes allow. The seed words are read from device
// memory (the caller's (2,) int32 tensor), so the host never waits for them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace probunet {
namespace {

constexpr int kLane = 128;     // row width of the TPU kernel's blocks
constexpr int kThreads = 256;
constexpr int kVec = 8;        // elements per thread

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T, bool kMapped>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ seed,
               long long nvec, long long offset, int rb, long long n_local, long long n_item,
               float p, float scale) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= nvec) return;
  const uint32_t key = hash_key(seed);
  long long e0 = offset + v * kVec;  // global index of the first element
  if (kMapped) {  // 8 divides n_local: the 8 elements share their item
    const long long item = (v * kVec) / n_local;
    e0 = offset + item * n_item + (v * kVec - item * n_local);
  }
  const long long row = e0 / kLane;
  const long long salt = row / rb;
  const uint32_t pos = static_cast<uint32_t>((row - salt * rb) * kLane + e0 % kLane);
  float vals[kVec];
  load8(x + v * kVec, vals);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float u = hash_uniform(pos + static_cast<uint32_t>(i), key, static_cast<uint32_t>(salt));
    vals[i] = u >= p ? __fmul_rn(vals[i], scale) : 0.f;
  }
  store8(y + v * kVec, vals);
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* seed, long long n, long long offset,
                   int rb, long long n_local, long long n_item, float p, float scale,
                   cudaStream_t stream) {
  const long long nvec = n / kVec;
  const unsigned blocks = static_cast<unsigned>((nvec + kThreads - 1) / kThreads);
  if (n_local == n_item) {
    dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const int*>(seed), nvec,
        offset, rb, n_local, n_item, p, scale);
  } else {
    dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const int*>(seed), nvec,
        offset, rb, n_local, n_item, p, scale);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

extern "C" {

// x, y: n elements, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), contiguous,
// 16-byte aligned, n % 8 == 0; y may alias x. They are elements [offset,
// offset + n) of a global tensor (offset % 8 == 0; offset 0 and n the
// whole tensor outside data parallelism). seed: (2,) int32 on the device.
// rb: rows per block of the global tensor (a multiple of 8 dividing its
// numel / 128). n_local, n_item: the per-item element counts of x and of the
// global tensor (equal outside a spatial mesh; multiples of 8, n_local at
// most n_item), local element (b, i) being global element offset + b *
// n_item + i. p: the drop probability; scale: f32(1 / (1 - p)). Returns
// cudaGetLastError().
int dropout_apply(const void* x, void* y, const void* seed, long long n, long long offset,
                  int rb, long long n_local, long long n_item, float p, float scale,
                  int is_bf16, void* stream) {
  if (n <= 0 || n % 8 != 0 || offset < 0 || offset % 8 != 0 || rb <= 0 || rb % 8 != 0 ||
      n_local <= 0 || n_local % 8 != 0 || n % n_local != 0 || n_item < n_local ||
      n_item % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? probunet::launch<__nv_bfloat16>(x, y, seed, n, offset, rb, n_local, n_item, p,
                                                 scale, s)
              : probunet::launch<float>(x, y, seed, n, offset, rb, n_local, n_item, p, scale,
                                        s);
  return static_cast<int>(err);
}

}  // extern "C"
