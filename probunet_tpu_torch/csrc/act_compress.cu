// Kernels F and F′: the int8 copy of a convolution's input that its backward
// pass keeps in place of the input (the JAX package's
// PROBUNET_ACT_COMPRESS=int8).
//
// No TPU kernel: the JAX package leaves both steps to XLA's fusions
// (probunet_tpu/ops/act_compress.py:66-71, _quantize_channels, and :94, the
// dequantization in the custom_vjp's backward). What they compute, at its
// rounding points, for the NHWC view of a channels_last activation x, a
// row-major (rows, C) matrix of f32 or bf16:
//
//   absmax[c] = max over the rows of |x[r, c]|   (f32; exact in any order)
//   s[c]      = max(absmax[c], 1e-12) / 127      (IEEE f32 division)
//   q[r, c]   = rint(x[r, c] / s[c])             (IEEE division, ties to even; int8)
//   xh[r, c]  = f32(q[r, c]) * s[c]              (one f32 product, rounded to x's type)
//
// F is two launches, so that a sharded training step can take the MAX of
// absmax over its ranks in between (the JAX step is one program over the
// global batch, whose absmax XLA reduces across the devices):
//
// - act8_absmax_kernel: a block takes a tile of rows; a thread a fixed
//   group of 8 channels (16 bytes of bf16) and every (256 / groups)-th row
//   of the tile, keeping 8 running maxima in registers. The block combines
//   its threads' maxima through shared memory in a fixed order, and one
//   atomicMax a channel folds the block's maxima into absmax. They are
//   non-negative floats, whose bit patterns order as the integers do, so an
//   integer atomicMax of the bits is the float max: exact whatever order
//   the blocks run in, and a NaN (positive after fabsf, its bits above
//   infinity's) propagates as jnp.max propagates it. The entry zeroes
//   absmax first (cudaMemsetAsync).
// - act8_quantize_kernel: each block computes s of every channel into
//   shared memory (block 0 also writes s out), then each thread quantizes 8
//   consecutive elements (one row, 8 channels) with E's quantizer
//   (quant.cuh) and stores their 8 bytes at once.
//
// F′, act8_dequantize_kernel: 8 elements a thread, their 8 bytes of q in
// one load, s from shared memory, 16 bytes of bf16 out.
//
// Where C % 8 != 0 (the flagship's first convolution takes 6 channels) or a
// pointer is not aligned for the vector accesses, the same kernels run with
// one element a thread (kVec = 1).
//
// Bound: the bytes. F reads x twice and writes q (5 bytes an element in
// bf16, 9 in f32), F′ reads q and writes xh (3 in bf16, 5 in f32): at the
// flagship's 128x128x32 bf16 activation at bs=128 (67.1 M elements) 336 MB
// for F (0.100 ms at 3.35 TB/s) and 201 MB for F′ (0.060 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace probunet {
namespace {

constexpr int kThreads = 256;
constexpr int kAbsmaxBlocksPerSm = 4;   // act8_absmax_kernel's grid: row tiles per SM
constexpr int kBlocksPerSm = 16;        // the elementwise kernels' grid-stride loops
constexpr int kMaxChannels = 12288;     // s in 48 KB of shared memory

// kVec consecutive elements as f32
template <int kVec>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (kVec == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (kVec == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int kVec>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (kVec == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

template <int kVec>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (kVec == 8) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// max(a, b) that keeps a NaN of either side, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Per-channel max |x| over rows [blockIdx.x * rows_per_block, +rows_per_block),
// folded into absmax (zeroed before the launch) by integer atomicMax.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
act8_absmax_kernel(const T* __restrict__ x, float* __restrict__ absmax, long long rows,
                   int c, long long rows_per_block) {
  __shared__ float red[kThreads * kVec];
  const int groups = c / kVec;  // channel groups a row
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  const int t = threadIdx.x;
  for (int g0 = 0; g0 < groups; g0 += kThreads) {
    const int width = min(groups - g0, kThreads);  // groups in this pass
    const int lanes = kThreads / width;            // rows read side by side
    const int g = t % width, sub = t / width;
    float m[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) m[j] = 0.f;
    if (sub < lanes) {
      const T* col = x + static_cast<long long>(g0 + g) * kVec;
#pragma unroll 4
      for (long long r = r0 + sub; r < r1; r += lanes) {
        float v[kVec];
        load<kVec>(col + r * c, v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) m[j] = nan_max(m[j], fabsf(v[j]));
      }
    }
    // red[sub][g][j]: thread t = sub * width + g holds groups g's maxima
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[t * kVec + j] = m[j];
    __syncthreads();
    for (int i = t; i < width * kVec; i += kThreads) {
      float mm = red[i];
      for (int s = 1; s < lanes; ++s) mm = nan_max(mm, red[s * width * kVec + i]);
      atomicMax(reinterpret_cast<int*>(absmax) + g0 * kVec + i, __float_as_int(mm));
    }
    __syncthreads();  // red is rewritten by the next pass
  }
}

// s of every channel into shared memory (and, from block 0, into s_out)
__device__ __forceinline__ void load_scales(const float* __restrict__ absmax,
                                            float* __restrict__ s_out, float* s_sh, int c) {
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const float a = absmax[i];
    const float s = __fdiv_rn((a > 1e-12f || a != a) ? a : 1e-12f, 127.f);
    s_sh[i] = s;
    if (s_out != nullptr && blockIdx.x == 0) s_out[i] = s;
  }
  __syncthreads();
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
act8_quantize_kernel(const T* __restrict__ x, const float* __restrict__ absmax,
                     int8_t* __restrict__ q, float* __restrict__ s_out, long long n, int c) {
  extern __shared__ float s_sh[];
  load_scales(absmax, s_out, s_sh, c);
  const long long nvec = n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < nvec;
       v += stride) {
    const long long e = v * kVec;
    const int ch = static_cast<int>(e % c);  // kVec divides c: one row, channels ch..
    float xv[kVec];
    load<kVec>(x + e, xv);
    uint32_t b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) b[j] = quantize(xv[j], s_sh[ch + j]);
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(q + e) = make_uint2(
          b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24),
          b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24));
    } else {
      q[e] = static_cast<int8_t>(b[0]);
    }
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
act8_dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                       T* __restrict__ xh, long long n, int c) {
  extern __shared__ float s_sh[];
  for (int i = threadIdx.x; i < c; i += kThreads) s_sh[i] = s[i];
  __syncthreads();
  const long long nvec = n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < nvec;
       v += stride) {
    const long long e = v * kVec;
    const int ch = static_cast<int>(e % c);
    int8_t qv[kVec];
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(qv) = *reinterpret_cast<const uint2*>(q + e);
    } else {
      qv[0] = q[e];
    }
    float out[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = __fmul_rn(static_cast<float>(qv[j]), s_sh[ch + j]);
    store<kVec>(xh + e, out);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

unsigned grid_for(long long nvec) {
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const long long need = (nvec + kThreads - 1) / kThreads;
  return static_cast<unsigned>(need < most ? need : most);
}

template <typename T, int kVec>
cudaError_t absmax_rows(const void* x, void* out, long long rows, int c, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * c, stream);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(sm_count()) * kAbsmaxBlocksPerSm;
  const long long per_block = (rows + tiles - 1) / tiles;
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  act8_absmax_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out), rows, c, per_block);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t quantize_rows(const void* x, const void* amax, void* q, void* s, long long n,
                          int c, cudaStream_t stream) {
  act8_quantize_kernel<T, kVec><<<grid_for(n / kVec), kThreads, sizeof(float) * c, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(amax), static_cast<int8_t*>(q),
      static_cast<float*>(s), n, c);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t dequantize_rows(const void* q, const void* s, void* xh, long long n, int c,
                            cudaStream_t stream) {
  act8_dequantize_kernel<T, kVec><<<grid_for(n / kVec), kThreads, sizeof(float) * c, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<T*>(xh), n, c);
  return cudaGetLastError();
}

bool bad_shape(long long rows, int c, int vec) {
  return rows <= 0 || c <= 0 || c > kMaxChannels || (vec && c % 8 != 0);
}

}  // namespace
}  // namespace probunet

extern "C" {

// x: (rows, c) row-major, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). absmax:
// (c,) f32, written. vec = 1: c % 8 == 0 and x 16-byte aligned (8 elements
// a thread), else 0. Returns cudaGetLastError().
int act8_absmax(const void* x, void* absmax, long long rows, int c, int is_bf16, int vec,
                void* stream) {
  if (probunet::bad_shape(rows, c, vec)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = vec ? probunet::absmax_rows<__nv_bfloat16, 8>(x, absmax, rows, c, st)
              : probunet::absmax_rows<__nv_bfloat16, 1>(x, absmax, rows, c, st);
  } else {
    err = vec ? probunet::absmax_rows<float, 8>(x, absmax, rows, c, st)
              : probunet::absmax_rows<float, 1>(x, absmax, rows, c, st);
  }
  return static_cast<int>(err);
}

// x as for act8_absmax; absmax: (c,) f32 (the channels' max |x|, over every
// rank's rows in a sharded step). q: (rows, c) int8 and s: (c,) f32,
// written (q 8-byte aligned when vec = 1).
int act8_quantize(const void* x, const void* absmax, void* q, void* s, long long rows, int c,
                  int is_bf16, int vec, void* stream) {
  if (probunet::bad_shape(rows, c, vec)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = rows * c;
  cudaError_t err;
  if (is_bf16) {
    err = vec ? probunet::quantize_rows<__nv_bfloat16, 8>(x, absmax, q, s, n, c, st)
              : probunet::quantize_rows<__nv_bfloat16, 1>(x, absmax, q, s, n, c, st);
  } else {
    err = vec ? probunet::quantize_rows<float, 8>(x, absmax, q, s, n, c, st)
              : probunet::quantize_rows<float, 1>(x, absmax, q, s, n, c, st);
  }
  return static_cast<int>(err);
}

// q: (rows, c) int8, s: (c,) f32. xh: (rows, c) f32 or bf16, written
// (16-byte aligned and q 8-byte aligned when vec = 1).
int act8_dequantize(const void* q, const void* s, void* xh, long long rows, int c, int is_bf16,
                    int vec, void* stream) {
  if (probunet::bad_shape(rows, c, vec)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = rows * c;
  cudaError_t err;
  if (is_bf16) {
    err = vec ? probunet::dequantize_rows<__nv_bfloat16, 8>(q, s, xh, n, c, st)
              : probunet::dequantize_rows<__nv_bfloat16, 1>(q, s, xh, n, c, st);
  } else {
    err = vec ? probunet::dequantize_rows<float, 8>(q, s, xh, n, c, st)
              : probunet::dequantize_rows<float, 1>(q, s, xh, n, c, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
