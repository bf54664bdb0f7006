// Fused Fcomb decode + ensemble CRPS terms: forward (kernel A, below) and
// analytic backward (kernel A', after it).
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

// ---------------------------------------------------------------------------
// Backward (kernel A'): replaces probunet_tpu/ops/pallas/fcomb_crps.py
// bwd_impl (pallas_call of _bwd_kernel). Given upstream (g1, g2) per batch
// element, with x_j the decoded members (as the forward computes them),
//
//   dx_j  = g1 sign(x_j - y) + g2 sum_{i != j} sign(x_j - x_i)       (K,)
//   dh1   = W2 dx_j;          da1 = dh1 * (h1 > 0);   dh0 = W1 da1;
//   du    = dh0 * (h0 > 0);   dfeat += du;   dz[:, j] += sum_p du;
//   dW2  += h1 dx^T;  db2 += dx;  dW1 += h0 da1^T;  db1 += da1;
//   dy    = -g1 sum_j sign(x_j - y)
//
// with the TPU module's rounding points (_dot/_dot_t): the operands of every
// product (W1, W2, h0, h1, da1, dx) rounded to bf16 in bf16 mode, sums f32;
// the bias sums and the ReLU masks use the unrounded f32 values.
//
// h0/h1 are recomputed per member and pixel and never stored in device
// memory: a first pass decodes all M members into a shared-memory column
// per thread (the pair signs need every member), a second pass recomputes
// each member's hiddens and back-propagates.
//
// Bound: operations. Per member-pixel the algorithm needs ~3 C x C products
// (h1, dh0, dW1) plus this design's recompute of h1: 6*B*P*M*(2C^2 + CK)
// ~ 405 GFLOP at B=128, P=16384, M=15, C=32, K=3 by the TPU's cost
// estimate, 6.0 ms on the FP32 pipes at 67 TFLOP/s (0.41 ms on bf16 tensor
// cores). Bytes (read feat, y; write dfeat, dy) are ~0.4 GB, 0.13 ms. This
// first design runs on the FP32 pipes, one pixel per thread.
//
// Reductions across pixels: the block stages, per member, rounded h0, da1
// and h1 and dx for its 128 pixels in padded (C, 129) shared-memory rows
// (bank-conflict free), then its threads each own entries of the (C, C) dW1
// partial (8 each), of dW2, db1, db2 and this member's dz column, and sum
// over the tile in pixel order. Each block writes its partials; a second
// pass (column_sum_kernel) adds them over blocks in a fixed order. No float
// atomics, so the gradients are bit-reproducible from run to run.
// dfeat needs no cross-thread sum: a thread adds its members in order.
constexpr int kStride = kThreads + 1;  // padded staging row

__device__ __forceinline__ float sign_f32(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
fcomb_crps_bwd_tile_kernel(const float* __restrict__ feat,  // (B, C, P)
                           const float* __restrict__ z,     // (B, C, M)
                           const float* __restrict__ w1,    // (C, C)
                           const float* __restrict__ b1,    // (C,)
                           const float* __restrict__ w2,    // (C, K)
                           const float* __restrict__ b2,    // (K,)
                           const float* __restrict__ y,     // (B, K, P)
                           const float* __restrict__ g1,    // (B,)
                           const float* __restrict__ g2,    // (B,)
                           float* __restrict__ dfeat,       // (B, C, P)
                           float* __restrict__ dy,          // (B, K, P) or null
                           float* __restrict__ dz_part,     // (ntiles, B, C, M)
                           float* __restrict__ w_part,      // (B * ntiles, NW)
                           int batch, int m, int k, int p, int ntiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;                   // kC * kC, operand-rounded
  float* s_b1 = s_w1 + kC * kC;         // kC
  float* s_w2 = s_b1 + kC;              // kC * kMaxK, operand-rounded
  float* s_b2 = s_w2 + kC * kMaxK;      // kMaxK
  float* s_dx = s_b2 + kMaxK;           // kMaxK * kStride, dx (f32)
  float* s_a = s_dx + kMaxK * kStride;  // kC * kStride staging
  float* s_b = s_a + kC * kStride;      // kC * kStride staging
  float* s_h1 = s_b + kC * kStride;     // kC * kStride, rounded h1
  float* s_z = s_h1 + kC * kStride;     // kC * m, this batch element
  float* s_x = s_z + kC * m;            // (m * k, kThreads) member outputs

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = tile * kThreads + tid;
  const bool valid = pix < p;

  for (int i = tid; i < kC * kC; i += kThreads) s_w1[i] = operand<kBf16>(w1[i]);
  for (int i = tid; i < kC * k; i += kThreads) s_w2[i] = operand<kBf16>(w2[i]);
  for (int i = tid; i < kC * m; i += kThreads) s_z[i] = z[static_cast<size_t>(b) * kC * m + i];
  if (tid < kC) s_b1[tid] = b1[tid];
  if (tid < k) s_b2[tid] = b2[tid];
  __syncthreads();

  float f[kC];
  const float* fp = feat + static_cast<size_t>(b) * kC * p + pix;
#pragma unroll
  for (int c = 0; c < kC; ++c) f[c] = valid ? fp[static_cast<size_t>(c) * p] : 0.f;
  float yk[kMaxK];
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) {
    yk[kk] = (valid && kk < k) ? y[(static_cast<size_t>(b) * k + kk) * p + pix] : 0.f;
  }
  const float gb1 = g1[b];
  const float gb2 = g2[b];

  // pass 1: every member's outputs, as the forward decodes them
  float acc[kC];
  for (int j = 0; j < m; ++j) {
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
      if (kk < k) s_x[(j * k + kk) * kThreads + tid] = x[kk] + s_b2[kk];
    }
  }

  // pass 2: per member, recompute the hiddens and back-propagate
  float dfeat_acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) dfeat_acc[c] = 0.f;
  float s0_sum[kMaxK];
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) s0_sum[kk] = 0.f;
  float w1_acc[8];  // dW1[c, o0 + i], c = tid / 4, o0 = (tid % 4) * 8
#pragma unroll
  for (int i = 0; i < 8; ++i) w1_acc[i] = 0.f;
  float w2_acc = 0.f;   // dW2[tid / k, tid % k] for tid < C * k
  float bias_acc = 0.f; // db1[tid] for tid < C; db2[tid - 2C] for 2C <= tid < 2C + k
  const int wc = tid >> 2;
  const int wo = (tid & 3) * 8;

  for (int j = 0; j < m; ++j) {
    // dx of member j at this pixel
    float dx[kMaxK];
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      dx[kk] = 0.f;
      if (kk < k && valid) {
        const float xv = s_x[(j * k + kk) * kThreads + tid];
        const float s0 = sign_f32(xv - yk[kk]);
        s0_sum[kk] += s0;
        float count = 0.f;
        for (int i = 0; i < m; ++i) count += sign_f32(xv - s_x[(i * k + kk) * kThreads + tid]);
        dx[kk] = __fadd_rn(__fmul_rn(gb1, s0), __fmul_rn(gb2, count));
      }
      if (kk < k) s_dx[kk * kStride + tid] = dx[kk];
    }
    // recompute h1 (acc), then da1 in place
#pragma unroll
    for (int o = 0; o < kC; ++o) acc[o] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float h0 = fmaxf(f[c] + s_z[c * m + j], 0.f);
      s_a[c * kStride + tid] = operand<kBf16>(h0);
#pragma unroll
      for (int o = 0; o < kC; ++o) acc[o] = fmaf(s_w1[c * kC + o], operand<kBf16>(h0), acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kC; ++o) {
      const float h1 = fmaxf(acc[o] + s_b1[o], 0.f);
      s_h1[o * kStride + tid] = operand<kBf16>(h1);
      float dh1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) dh1 = fmaf(s_w2[o * k + kk], operand<kBf16>(dx[kk]), dh1);
      }
      acc[o] = h1 > 0.f ? dh1 : 0.f;  // da1
      s_b[o * kStride + tid] = operand<kBf16>(acc[o]);
    }
    // du = (W1 da1) * (h0 > 0)
    float du[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float dh0 = 0.f;
#pragma unroll
      for (int o = 0; o < kC; ++o) dh0 = fmaf(s_w1[c * kC + o], operand<kBf16>(acc[o]), dh0);
      du[c] = (f[c] + s_z[c * m + j] > 0.f) ? dh0 : 0.f;
      dfeat_acc[c] += du[c];
    }
    __syncthreads();
    // tile sums, phase 1: dW1 (rounded h0 x rounded da1), dW2, db2
    {
      float t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = 0.f;
      for (int q = 0; q < kThreads; ++q) {
        const float h0 = s_a[wc * kStride + q];
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = fmaf(h0, s_b[(wo + i) * kStride + q], t[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) w1_acc[i] += t[i];
      if (tid < kC * k) {
        const int c = tid / k;
        const int kk = tid - c * k;
        float s = 0.f;
        for (int q = 0; q < kThreads; ++q) {
          s = fmaf(s_h1[c * kStride + q], operand<kBf16>(s_dx[kk * kStride + q]), s);
        }
        w2_acc += s;
      }
    }
    __syncthreads();
    // phase 2: unrounded da1 and du, for db1 and this member's dz column
#pragma unroll
    for (int o = 0; o < kC; ++o) s_a[o * kStride + tid] = acc[o];
#pragma unroll
    for (int c = 0; c < kC; ++c) s_b[c * kStride + tid] = du[c];
    __syncthreads();
    if (tid < kC) {
      float s = 0.f;
      for (int q = 0; q < kThreads; ++q) s += s_a[tid * kStride + q];
      bias_acc += s;
    } else if (tid < 2 * kC) {
      const int c = tid - kC;
      float s = 0.f;
      for (int q = 0; q < kThreads; ++q) s += s_b[c * kStride + q];
      dz_part[((static_cast<size_t>(tile) * batch + b) * kC + c) * m + j] = s;
    } else if (tid < 2 * kC + k) {
      const int kk = tid - 2 * kC;
      float s = 0.f;
      for (int q = 0; q < kThreads; ++q) s += s_dx[kk * kStride + q];
      bias_acc += s;
    }
    __syncthreads();  // staging is rewritten by the next member
  }

  if (valid) {
    float* dp = dfeat + static_cast<size_t>(b) * kC * p + pix;
#pragma unroll
    for (int c = 0; c < kC; ++c) dp[static_cast<size_t>(c) * p] = dfeat_acc[c];
    if (dy != nullptr) {
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) dy[(static_cast<size_t>(b) * k + kk) * p + pix] = __fmul_rn(-gb1, s0_sum[kk]);
      }
    }
  }
  // this block's weight partials: [dW1 (C*C) | db1 (C) | dW2 (C*k) | db2 (k)]
  const int nw = kC * kC + kC + kC * k + k;
  float* wp = w_part + (static_cast<size_t>(b) * ntiles + tile) * nw;
#pragma unroll
  for (int i = 0; i < 8; ++i) wp[wc * kC + wo + i] = w1_acc[i];
  if (tid < kC) wp[kC * kC + tid] = bias_acc;
  if (tid < kC * k) wp[kC * kC + kC + tid] = w2_acc;
  if (tid >= 2 * kC && tid < 2 * kC + k) wp[kC * kC + kC + kC * k + tid - 2 * kC] = bias_acc;
}

size_t bwd_smem_bytes(int m, int k) {
  return sizeof(float) * (static_cast<size_t>(kC) * kC + kC + kC * kMaxK + kMaxK +
                          static_cast<size_t>(kMaxK) * kStride +
                          3 * static_cast<size_t>(kC) * kStride +
                          static_cast<size_t>(kC) * m +
                          static_cast<size_t>(m) * k * kThreads);
}

template <bool kBf16>
cudaError_t launch_bwd(const float* feat, const float* z, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* y, const float* g1,
                       const float* g2, float* dfeat, float* dy, float* dz_part,
                       float* w_part, float* dz, float* dw, int batch, int m, int k, int p,
                       cudaStream_t stream) {
  const int ntiles = (p + kThreads - 1) / kThreads;
  const size_t smem = bwd_smem_bytes(m, k);
  cudaError_t err = cudaFuncSetAttribute(fcomb_crps_bwd_tile_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fcomb_crps_bwd_tile_kernel<kBf16><<<dim3(ntiles, batch), kThreads, smem, stream>>>(
      feat, z, w1, b1, w2, b2, y, g1, g2, dfeat, dy, dz_part, w_part, batch, m, k, p, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_column_sum(dz_part, dz, ntiles, batch * kC * m, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_column_sum(w_part, dw, batch * ntiles, kC * kC + kC + kC * k + k, stream);
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

// The forward's operands plus g1, g2 (B,) f32. Outputs: dfeat (B, C, P);
// dy (B, K, P) or null (not computed); dz (B, C, M); dw: the weight
// gradients packed as [dW1 (C, C) | db1 (C) | dW2 (C, K) | db2 (K)].
// Scratch: dz_part (ceil(P / tile), B, C, M) and w_part (B * ceil(P / tile),
// C*C + C + C*K + K) f32. Returns cudaGetLastError().
int fcomb_crps_terms_bwd(const void* feat, const void* z, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* y, const void* g1,
                         const void* g2, void* dfeat, void* dy, void* dz_part, void* w_part,
                         void* dz, void* dw, int batch, int m, int k, int p,
                         int bf16_operands, void* stream) {
  if (m < 1 || m > probunet::kMaxM || k < 1 || k > probunet::kMaxK || batch < 1 ||
      batch > 65535 || p < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto c = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto w = [](void* ptr) { return static_cast<float*>(ptr); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16_operands
          ? probunet::launch_bwd<true>(c(feat), c(z), c(w1), c(b1), c(w2), c(b2), c(y), c(g1),
                                       c(g2), w(dfeat), w(dy), w(dz_part), w(w_part), w(dz),
                                       w(dw), batch, m, k, p, s)
          : probunet::launch_bwd<false>(c(feat), c(z), c(w1), c(b1), c(w2), c(b2), c(y),
                                        c(g1), c(g2), w(dfeat), w(dy), w(dz_part), w(w_part),
                                        w(dz), w(dw), batch, m, k, p, s);
  return static_cast<int>(err);
}

}  // extern "C"
