// Fused Fcomb decode + ensemble CRPS terms, forward.
//
// Replaces the TPU kernel probunet_tpu/ops/pallas/fcomb_crps.py:_terms_fn
// fwd_impl (pallas_call of _fwd_kernel). For each batch element b and pixel
// p, decode M members from the layer-0 projections
//
//   h0 = relu(feat[b, :, p] + z[b, :, m])      (C,)
//   h1 = relu(W1^T h0 + b1)                     (C,)
//   x  = W2^T h1 + b2                           (K,)
//
// and reduce straight to t1(b) = sum |x - y| and t2(b) = sum_{j<k} |x_j - x_k|
// over members, pixels and the K output channels. The (B, M, P, K) ensemble
// and the (M, B, P, C) hiddens never reach device memory.
//
// Bound: at the roofline, HBM bytes. The kernel reads the features once
// (C f32 per pixel) plus the target; the decode is ~2*C*C + 2*C*K FLOPs per
// member-pixel (about 80 FLOPs per byte read at C=32, M=5), far below the
// bf16 tensor-core ridge of ~295. This first design runs the 32x32 product
// on the FP32 pipes, one pixel per thread, where 80 FLOPs per byte sits above
// their ridge (~20): it is bound by FP32 issue until the product moves to
// mma.sync/wgmma (later work). What it does about the bytes: the feature
// column is loaded once and reused by all M members; the member outputs
// stay on chip (a column of shared memory per thread); W1, b1, W2, b2 and
// this batch element's z live in shared memory and are read as broadcasts.
//
// Rounding points match _dot in the TPU module: with bf16 operands h0, h1,
// W1 and W2 are rounded to bf16, products accumulate in f32, x stays f32.
// Out-of-range pixels of the last tile add nothing (bounds check instead of
// the TPU's padding plus `valid` row). No K or M padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace probunet {
namespace {

constexpr int kThreads = 128;  // pixels per block, one per thread
constexpr int kC = 32;         // Fcomb hidden width the kernel is built for
constexpr int kMaxK = 4;
constexpr int kMaxM = 32;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) {
    return round_bf16(v);
  } else {
    return v;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
fcomb_crps_tile_kernel(const float* __restrict__ feat,  // (B, C, P)
                       const float* __restrict__ z,     // (B, C, M)
                       const float* __restrict__ w1,    // (C, C), h1 = W1^T h0
                       const float* __restrict__ b1,    // (C,)
                       const float* __restrict__ w2,    // (C, K)
                       const float* __restrict__ b2,    // (K,)
                       const float* __restrict__ y,     // (B, K, P)
                       float* __restrict__ partial,     // (2, B, ntiles)
                       int batch, int m, int k, int p, int ntiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;                 // kC * kC, operand-rounded
  float* s_b1 = s_w1 + kC * kC;       // kC
  float* s_w2 = s_b1 + kC;            // kC * kMaxK, operand-rounded
  float* s_b2 = s_w2 + kC * kMaxK;    // kMaxK
  float* s_z = s_b2 + kMaxK;          // kC * m, this batch element
  float* s_x = s_z + kC * m;          // (m * k, kThreads) member outputs
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = tile * kThreads + tid;

  for (int i = tid; i < kC * kC; i += kThreads) s_w1[i] = operand<kBf16>(w1[i]);
  for (int i = tid; i < kC * k; i += kThreads) s_w2[i] = operand<kBf16>(w2[i]);
  for (int i = tid; i < kC * m; i += kThreads) s_z[i] = z[static_cast<size_t>(b) * kC * m + i];
  if (tid < kC) s_b1[tid] = b1[tid];
  if (tid < k) s_b2[tid] = b2[tid];
  __syncthreads();

  float v1 = 0.f;
  float v2 = 0.f;
  if (pix < p) {
    float f[kC];
    const float* fp = feat + static_cast<size_t>(b) * kC * p + pix;
#pragma unroll
    for (int c = 0; c < kC; ++c) f[c] = fp[static_cast<size_t>(c) * p];
    float yk[kMaxK];
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      yk[kk] = kk < k ? y[(static_cast<size_t>(b) * k + kk) * p + pix] : 0.f;
    }

    for (int j = 0; j < m; ++j) {
      // h1 accumulators: acc[o] = sum_c W1[c, o] * h0[c]
      float acc[kC];
#pragma unroll
      for (int o = 0; o < kC; ++o) acc[o] = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float h0 = operand<kBf16>(fmaxf(f[c] + s_z[c * m + j], 0.f));
#pragma unroll
        for (int o = 0; o < kC; ++o) acc[o] = fmaf(s_w1[c * kC + o], h0, acc[o]);
      }
      float x[kMaxK];
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) x[kk] = 0.f;
#pragma unroll
      for (int o = 0; o < kC; ++o) {
        const float h1 = operand<kBf16>(fmaxf(acc[o] + s_b1[o], 0.f));
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          if (kk < k) x[kk] = fmaf(s_w2[o * k + kk], h1, x[kk]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) {
          const float xv = x[kk] + s_b2[kk];
          v1 += fabsf(xv - yk[kk]);
          // pairs (i, j) with i < j, against the members already decoded
          for (int i = 0; i < j; ++i) v2 += fabsf(s_x[(i * k + kk) * kThreads + tid] - xv);
          s_x[(j * k + kk) * kThreads + tid] = xv;
        }
      }
    }
  }
  const float s1 = block_sum<kThreads>(v1, red);
  const float s2 = block_sum<kThreads>(v2, red);
  if (tid == 0) {
    partial[static_cast<size_t>(b) * ntiles + tile] = s1;
    partial[(static_cast<size_t>(batch) + b) * ntiles + tile] = s2;
  }
}

size_t smem_bytes(int m, int k) {
  return sizeof(float) * (static_cast<size_t>(kC) * kC + kC + kC * kMaxK + kMaxK +
                          static_cast<size_t>(kC) * m +
                          static_cast<size_t>(m) * k * kThreads);
}

template <bool kBf16>
cudaError_t launch(const float* feat, const float* z, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* y, float* partial,
                   float* t1, float* t2, int batch, int m, int k, int p,
                   cudaStream_t stream) {
  const int ntiles = (p + kThreads - 1) / kThreads;
  const size_t smem = smem_bytes(m, k);
  cudaError_t err = cudaFuncSetAttribute(fcomb_crps_tile_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fcomb_crps_tile_kernel<kBf16><<<dim3(ntiles, batch), kThreads, smem, stream>>>(
      feat, z, w1, b1, w2, b2, y, partial, batch, m, k, p, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_reduce(partial, t1, t2, batch, ntiles, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

extern "C" {

int fcomb_crps_tile_pixels() { return probunet::kThreads; }

int fcomb_crps_channels() { return probunet::kC; }

int fcomb_crps_max_members() { return probunet::kMaxM; }

int fcomb_crps_max_classes() { return probunet::kMaxK; }

// feat (B, C, P), z (B, C, M), w1 (C, C), b1 (C,), w2 (C, K), b2 (K,),
// y (B, K, P): f32, contiguous, C = fcomb_crps_channels(). partial:
// (2, B, ceil(P / tile)) f32 scratch; t1, t2: (B,) f32. bf16_operands
// selects the bf16 rounding points. Returns cudaGetLastError().
int fcomb_crps_terms_fwd(const void* feat, const void* z, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* y, void* partial,
                         void* t1, void* t2, int batch, int m, int k, int p,
                         int bf16_operands, void* stream) {
  if (m < 1 || m > probunet::kMaxM || k < 1 || k > probunet::kMaxK || batch < 1 ||
      batch > 65535 || p < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o1 = static_cast<float*>(t1);
  float* o2 = static_cast<float*>(t2);
  const cudaError_t err =
      bf16_operands
          ? probunet::launch<true>(f(feat), f(z), f(w1), f(b1), f(w2), f(b2), f(y), part, o1,
                                   o2, batch, m, k, p, s)
          : probunet::launch<false>(f(feat), f(z), f(w1), f(b1), f(w2), f(b2), f(y), part, o1,
                                    o2, batch, m, k, p, s);
  return static_cast<int>(err);
}

}  // extern "C"
