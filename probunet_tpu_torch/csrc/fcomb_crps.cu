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
// Bound: HBM bytes. The kernel reads the features once (C f32 per pixel)
// plus the target: 4*B*P*(C + K) bytes, 0.088 ms at B=128, P=16384 on an
// H100's 3.35 TB/s. The decode is 2*B*P*M*(C*C + C*K) FLOPs (7.0e10 at
// M=15), 0.071 ms on the bf16 tensor cores but 1.05 ms on the FP32 pipes.
//
// Two kernels, chosen per compute dtype before the launch
// (ops/kernels/fcomb_crps.py:FWD_KERNELS):
// - bf16 operands (both the serve and the training step):
//   fcomb_crps_fwd_mma_kernel, the 32x32 product on the tensor cores with
//   the decode functions of A′'s tensor-core kernel (below);
// - f32 operands: fcomb_crps_tile_kernel, on the FP32 pipes, one pixel per
//   thread. TF32 would move its rounding points, so it stays there. The
//   feature column is loaded once and reused by all M members; the member
//   outputs stay in a column of shared memory per thread; W1, b1, W2, b2
//   and this batch element's z live in shared memory, read as broadcasts.
//
// Rounding points match _dot in the TPU module: with bf16 operands h0, h1,
// W1 and W2 are rounded to bf16, products accumulate in f32, x stays f32.
// Out-of-range pixels of the last tile add nothing (bounds check instead of
// the TPU's padding plus `valid` row). No K or M padding. Each block writes
// its (t1, t2) partial and launch_reduce adds them in a fixed order: no
// float atomics, so t1 and t2 are bit-reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// -- the FP32 forward (f32 operands) -------------------------------------------
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
  float* s_w1 = smem;                 // kC * kC
  float* s_b1 = s_w1 + kC * kC;       // kC
  float* s_w2 = s_b1 + kC;            // kC * kMaxK
  float* s_b2 = s_w2 + kC * kMaxK;    // kMaxK
  float* s_z = s_b2 + kMaxK;          // kC * m, this batch element
  float* s_x = s_z + kC * m;          // (m * k, kThreads) member outputs
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = tile * kThreads + tid;

  for (int i = tid; i < kC * kC; i += kThreads) s_w1[i] = w1[i];
  for (int i = tid; i < kC * k; i += kThreads) s_w2[i] = w2[i];
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
        const float h0 = fmaxf(f[c] + s_z[c * m + j], 0.f);
#pragma unroll
        for (int o = 0; o < kC; ++o) acc[o] = fmaf(s_w1[c * kC + o], h0, acc[o]);
      }
      float x[kMaxK];
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) x[kk] = 0.f;
#pragma unroll
      for (int o = 0; o < kC; ++o) {
        const float h1 = fmaxf(acc[o] + s_b1[o], 0.f);
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

cudaError_t launch_fp32(const float* feat, const float* z, const float* w1, const float* b1,
                        const float* w2, const float* b2, const float* y, float* partial,
                        int batch, int m, int k, int p, cudaStream_t stream) {
  const int ntiles = (p + kThreads - 1) / kThreads;
  const size_t smem = smem_bytes(m, k);
  cudaError_t err = cudaFuncSetAttribute(fcomb_crps_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fcomb_crps_tile_kernel<<<dim3(ntiles, batch), kThreads, smem, stream>>>(
      feat, z, w1, b1, w2, b2, y, partial, batch, m, k, p, ntiles);
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
// the bias sums and the ReLU masks use the unrounded f32 values. h0/h1 are
// recomputed per member and pixel and never stored in device memory: a
// first pass decodes all M members (the pair signs need every member), a
// second pass recomputes each member's hiddens and back-propagates.
//
// Bound: operations. Per member-pixel the algorithm needs 3 C x C products
// (h1, dh0, dW1) and 3 C x K ones: 2*B*P*M*(3C^2 + 3CK) ~ 0.21 TFLOP at
// B=128, P=16384, M=15, C=32, K=3, 0.21 ms on the bf16 tensor cores at
// 989 TFLOP/s, 3.2 ms on the FP32 pipes at 67. Bytes (read feat, y; write
// dfeat, dy) are ~0.3 GB, 0.09 ms.
//
// Two kernels, chosen per compute dtype before the launch:
// - bf16 operands (the training step): fcomb_crps_bwd_mma_kernel, the three
//   C x C products on the tensor cores (below);
// - f32 operands: fcomb_crps_bwd_tile_kernel, on the FP32 pipes, one pixel
//   per thread. TF32 would move its rounding points, so it stays there.
//
// Both write per-block partials of the weight gradients and of dz, and a
// second pass (column_sum_kernel) adds them over blocks in a fixed order.
// No float atomics, so the gradients are bit-reproducible from run to run.

// -- the FP32 kernel (f32 operands) ------------------------------------------
//
// The block stages, per member, h0, da1, h1 and dx for its 128 pixels in
// padded (C, 129) shared-memory rows (bank-conflict free), then its threads
// each own entries of the (C, C) dW1 partial (8 each), of dW2, db1, db2 and
// this member's dz column, and sum over the tile in pixel order. dfeat
// needs no cross-thread sum: a thread adds its members in order.
constexpr int kStride = kThreads + 1;  // padded staging row

__device__ __forceinline__ float sign_f32(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

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

  for (int i = tid; i < kC * kC; i += kThreads) s_w1[i] = w1[i];
  for (int i = tid; i < kC * k; i += kThreads) s_w2[i] = w2[i];
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
      const float h0 = fmaxf(f[c] + s_z[c * m + j], 0.f);
#pragma unroll
      for (int o = 0; o < kC; ++o) acc[o] = fmaf(s_w1[c * kC + o], h0, acc[o]);
    }
    float x[kMaxK];
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) x[kk] = 0.f;
#pragma unroll
    for (int o = 0; o < kC; ++o) {
      const float h1 = fmaxf(acc[o] + s_b1[o], 0.f);
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
      s_a[c * kStride + tid] = h0;
#pragma unroll
      for (int o = 0; o < kC; ++o) acc[o] = fmaf(s_w1[c * kC + o], h0, acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kC; ++o) {
      const float h1 = fmaxf(acc[o] + s_b1[o], 0.f);
      s_h1[o * kStride + tid] = h1;
      float dh1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) dh1 = fmaf(s_w2[o * k + kk], dx[kk], dh1);
      }
      acc[o] = h1 > 0.f ? dh1 : 0.f;  // da1
      s_b[o * kStride + tid] = acc[o];
    }
    // du = (W1 da1) * (h0 > 0)
    float du[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float dh0 = 0.f;
#pragma unroll
      for (int o = 0; o < kC; ++o) dh0 = fmaf(s_w1[c * kC + o], acc[o], dh0);
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
          s = fmaf(s_h1[c * kStride + q], s_dx[kk * kStride + q], s);
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

cudaError_t launch_bwd_fp32(const float* feat, const float* z, const float* w1, const float* b1,
                            const float* w2, const float* b2, const float* y, const float* g1,
                            const float* g2, float* dfeat, float* dy, float* dz_part,
                            float* w_part, int batch, int m, int k, int p,
                            cudaStream_t stream) {
  const int ntiles = (p + kThreads - 1) / kThreads;
  const size_t smem = bwd_smem_bytes(m, k);
  cudaError_t err = cudaFuncSetAttribute(fcomb_crps_bwd_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fcomb_crps_bwd_tile_kernel<<<dim3(ntiles, batch), kThreads, smem, stream>>>(
      feat, z, w1, b1, w2, b2, y, g1, g2, dfeat, dy, dz_part, w_part, batch, m, k, p, ntiles);
  return cudaGetLastError();
}

// -- the tensor-core kernels (bf16 operands) ---------------------------------
//
// A′'s design first; A (after it) decodes with the same functions.
// What bounds the FP32 kernel on this card: ~4 C^2 FMAs per member-pixel on
// the FP32 pipes, each reading its W1 operand as a shared-memory broadcast,
// 255 registers with spills, and 128-pixel blocks whose weight partials
// (B * P/128 rows of 1155 floats) are as large as the inputs. This design:
//
// - Rows are pixel-members. A warp owns a tile of 16 pixels of one batch
//   element and walks its M members; the products are mma.sync m16n8k16
//   (bf16 operands, f32 accumulators): h1 = h0 W1 (recomputed in the second
//   pass), dh0 = da1 W1^T and dW1 += h0^T da1. mma.sync, not wgmma: at
//   N = K = 32 a product is eight m16n8k16 instructions, wgmma's 64-row
//   shared-memory tiles would add a shared-memory round trip per member for
//   no gain in rate, and mma.sync keeps every operand in registers.
// - W1 (the B operand of h0 W1) and W1^T (of da1 W1^T), rounded to bf16,
//   are packed once per block as B fragments, one word per lane.
// - h0 = relu(feat + z_j) is rounded straight into A fragments: a thread
//   holds the 16 features (2 pixels x 8 channels) its fragments need, for
//   the whole tile. The accumulators of h1 and dh0 have the same (pixel,
//   channel) ownership, so the bias, the ReLU masks, du and dfeat need no
//   data movement, and the da1 accumulator is repacked in registers into
//   the A fragment of da1 W1^T (the m16n8 accumulator -> m16n8k16 A trick).
// - dW1 contracts over pixels: its operands are the transposes of the h0
//   and da1 fragments, made in registers by movmatrix (an 8x8 b16
//   transpose across the warp) instead of a shared-memory stage.
// - The K <= 4 wide parts stay on the FP32 pipes: x = h1 W2 + b2 from the
//   accumulator fragments (each thread its 8 columns, then a fixed-order
//   quad sum), dh1 = W2 dx, dW2 and the pair signs; thread q of a quad
//   computes class q's signs and the quad exchanges dx by shuffles.
// - A block of 4 warps walks a fixed set of tiles of one batch element
//   (grid: as many blocks per element as fill the card once), so the
//   fragments are set up once per block and there are B * nbx weight
//   partials instead of B * P/128. Sums across lanes, warps and blocks run
//   in a fixed order; dz is summed per warp in shared memory.
//
// W1's fragments sit in shared memory (two 32-bit loads per mma), not in
// registers, and the kernel is held to 170 registers so an SM runs 3
// blocks. Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 3.80 ms
// at B=128, P=16384, M=15, K=3, 7.6x faster than the FP32 kernel with bf16
// operands and 17.8x its tensor-core bound: what remains is the issue of
// the FP32-pipe work around the products (~650 instructions per 16
// pixel-members against 32 mma) and the pair signs.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTileRows = 16;  // pixels per warp tile (the mma's M)
constexpr int kMmaMinBlocks = 3;  // blocks an SM must hold: at most 170 registers a thread

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b: A 16x16 (row), B 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8x8 b16 matrix held one register per lane
__device__ __forceinline__ uint32_t transpose8x8(uint32_t v) {
  uint32_t out;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(out) : "r"(v));
  return out;
}

// Fragment conventions (lane = 4 g + q). A thread's values of a 16-row tile
// are v[r][nt][e]: row g + 8 r, channel nt * 8 + 2 q + e (r, e in {0, 1},
// nt in 0..3); an m16n8 accumulator acc[nt][2 r + e] has the same
// ownership. The A fragment of k-step ks (channels 16 ks ..) is
// {v[0][2ks], v[1][2ks], v[0][2ks+1], v[1][2ks+1]}, each a packed pair.
__device__ __forceinline__ void a_frags(const float (&v)[2][4][2], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        a[ks][2 * h + r] = pack_bf16(v[r][2 * ks + h][0], v[r][2 * ks + h][1]);
      }
    }
  }
}

// acc[nt] = a B[nt] over the two k-steps (C = 32 = N); B's fragments in
// shared memory, register h of (nt, ks) at sb[((nt * 2 + ks) * 2 + h) * 32 + lane]
__device__ __forceinline__ void product32(const uint32_t (&a)[2][4], const uint32_t* sb,
                                          int lane, float (&acc)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t* f = sb + (nt * 2 + ks) * 64 + lane;
      mma_bf16(acc[nt], a[ks], f[0], f[32]);
    }
  }
}

// h0 = relu(f + z_j) per fragment element (unrounded; a_frags rounds it)
__device__ __forceinline__ void member_h0(const float (&f)[2][4][2], const float (&zj)[4][2],
                                          float (&h0)[2][4][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) h0[r][nt][e] = fmaxf(f[r][nt][e] + zj[nt][e], 0.f);
    }
  }
}

// The decode of one member on a 16-pixel tile, from the h1 accumulators:
// x[r][kk] = sum_o bf16(relu(acc + b1))[o] W2[o, kk] + b2[kk] for the
// thread's rows g and g + 8, the same in every lane of the quad (each lane
// sums its 8 columns in order, then the quad adds by xor shuffles, whose
// two operands commute bit for bit). s_w2 (C, K) holds W2 rounded to bf16.
template <int K>
__device__ __forceinline__ void decode_x(const float (&acc)[4][4], const float* s_b1,
                                         const float* s_w2, const float* s_b2, int q,
                                         float (&x)[2][K]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) x[r][kk] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = nt * 8 + 2 * q + e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float h1 = round_bf16(fmaxf(acc[nt][2 * r + e] + s_b1[o], 0.f));
#pragma unroll
        for (int kk = 0; kk < K; ++kk) x[r][kk] = fmaf(s_w2[o * K + kk], h1, x[r][kk]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      x[r][kk] += __shfl_xor_sync(0xffffffffu, x[r][kk], 1);
      x[r][kk] += __shfl_xor_sync(0xffffffffu, x[r][kk], 2);
      x[r][kk] += s_b2[kk];
    }
  }
}

// sum over the 8 lanes of one q (lanes q, q+4, ..., q+28), in a fixed order
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Sums of v[0..7] over the 8 lanes of one q (lane bits 2-4), scattered:
// lane 4 g + q returns the sum of v[g]. Three halving steps, each adding
// the partner's half to one's own in a fixed order.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int lane) {
  const bool hb = lane & 16, mb = lane & 8, lb = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hb ? v[i] : v[i + 4];
    w4[i] = (hb ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = mb ? w4[i] : w4[i + 2];
    w2[i] = (mb ? w4[i + 2] : w4[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = lb ? w2[0] : w2[1];
  return (lb ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
}

// W1 rounded to bf16 as B fragments in shared memory, 16 words a lane:
// s_wb of h0 W1 (B[c][o] = W1[c, o]) and, unless null, s_wt of da1 W1^T
// (B[o][c] = W1[c, o]); register h of k-step ks holds rows
// 16 ks + 8 h + 2 q + {0, 1} of column nt * 8 + g. Called by every thread
// of a kMmaThreads block; the caller synchronizes.
__device__ __forceinline__ void pack_w1(const float* __restrict__ w1, uint32_t* s_wb,
                                        uint32_t* s_wt) {
  for (int i = threadIdx.x; i < 16 * 32; i += kMmaThreads) {
    const int fl = i & 31;  // the lane that reads word i
    const int frag = i >> 5;
    const int k0 = (frag >> 1 & 1) * 16 + (frag & 1) * 8 + 2 * (fl & 3);  // ks, h, q
    const int n = (frag >> 2) * 8 + (fl >> 2);                            // nt, g
    s_wb[i] = pack_bf16(w1[k0 * kC + n], w1[(k0 + 1) * kC + n]);
    if (s_wt != nullptr) s_wt[i] = pack_bf16(w1[n * kC + k0], w1[n * kC + k0 + 1]);
  }
}

// A warp tile's inputs: the features of the thread's fragment elements
// (pixels px[r] = 16 tile + g + 8 r, channels nt * 8 + 2 q + e; 0 past the
// last pixel) and class q's target. fb, yb: this batch element's (C, P)
// features and (K, P) target.
template <int K>
__device__ __forceinline__ void load_tile(const float* __restrict__ fb,
                                          const float* __restrict__ yb, int p, int tile, int g,
                                          int q, float (&f)[2][4][2], float (&yq)[2], int (&px)[2],
                                          bool (&ok)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    px[r] = tile * kTileRows + g + 8 * r;
    ok[r] = px[r] < p;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        f[r][nt][e] = ok[r] ? fb[static_cast<size_t>(nt * 8 + 2 * q + e) * p + px[r]] : 0.f;
      }
    }
    yq[r] = (ok[r] && q < K) ? yb[static_cast<size_t>(q) * p + px[r]] : 0.f;
  }
}

// The first half of member j's decode on a tile: h0 = relu(f + z_j), its A
// fragments, and the h1 accumulators acc = h0 W1 (before b1). s_z holds
// this batch element's (C, M) z.
__device__ __forceinline__ void member_hidden(const float (&f)[2][4][2], const float* s_z, int m,
                                              int j, int q, const uint32_t* s_wb, int lane,
                                              float (&h0)[2][4][2], uint32_t (&a)[2][4],
                                              float (&acc)[4][4]) {
  float zj[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) zj[nt][e] = s_z[(nt * 8 + 2 * q + e) * m + j];
  }
  member_h0(f, zj, h0);
  a_frags(h0, a);
  product32(a, s_wb, lane, acc);
}

template <int K>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
fcomb_crps_bwd_mma_kernel(const float* __restrict__ feat,  // (B, C, P)
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
                          float* __restrict__ dz_part,     // (nbx, B, C, M)
                          float* __restrict__ w_part,      // (B * nbx, NW)
                          int batch, int m, int p, int nbx) {
  constexpr int kNW = kC * kC + kC + kC * K + K;
  extern __shared__ __align__(16) float smem[];
  float* s_b1 = smem;                              // kC
  float* s_w2 = s_b1 + kC;                         // kC * K, rounded
  float* s_b2 = s_w2 + kC * kMaxK;                 // K
  float* s_z = s_b2 + kMaxK;                       // kC * m
  float* s_x = s_z + kC * m;                       // per warp (m, 16, 4): decoded x
  float* s_dz = s_x + kMmaWarps * m * kTileRows * 4;  // per warp (kC, m): dz sums
  float* s_w = s_dz + kMmaWarps * kC * m;          // per warp kNW: weight partials
  // W1's B fragments (pack_w1): s_wb of h0 W1, s_wt of da1 W1^T
  uint32_t* s_wb = reinterpret_cast<uint32_t*>(s_w + kMmaWarps * kNW);
  uint32_t* s_wt = s_wb + 16 * 32;

  const int b = blockIdx.y;
  const int bx = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;

  for (int i = tid; i < kC * K; i += kMmaThreads) s_w2[i] = round_bf16(w2[i]);
  for (int i = tid; i < kC * m; i += kMmaThreads) s_z[i] = z[static_cast<size_t>(b) * kC * m + i];
  for (int i = tid; i < kMmaWarps * kC * m; i += kMmaThreads) s_dz[i] = 0.f;
  if (tid < kC) s_b1[tid] = b1[tid];
  if (tid < K) s_b2[tid] = b2[tid];
  pack_w1(w1, s_wb, s_wt);
  const float gb1 = g1[b];
  const float gb2 = g2[b];
  __syncthreads();

  float* wx = s_x + warp * m * kTileRows * 4;  // wx[(j * 16 + row) * 4 + class]
  float* wdz = s_dz + warp * kC * m;
  float dw1[2][4][4];  // dW1 accumulators: c-tile mt (16 rows), o-tile nt
  float db1[4][2];     // columns nt * 8 + 2 q + e
  float dw2[4][2][K];
  float db2 = 0.f;     // class q
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dw1[0][nt][i] = dw1[1][nt][i] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      db1[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) dw2[nt][e][kk] = 0.f;
    }
  }

  const float* fb = feat + static_cast<size_t>(b) * kC * p;
  const float* yb = y + static_cast<size_t>(b) * K * p;
  const int ntiles = (p + kTileRows - 1) / kTileRows;
  for (int tile = bx * kMmaWarps + warp; tile < ntiles; tile += nbx * kMmaWarps) {
    int px[2];
    bool ok[2];
    float f[2][4][2];
    float yq[2];
    load_tile<K>(fb, yb, p, tile, g, q, f, yq, px, ok);

    // pass 1: every member's x on the tile, into this warp's wx
    for (int j = 0; j < m; ++j) {
      float h0[2][4][2];
      uint32_t a[2][4];
      float acc[4][4];
      member_hidden(f, s_z, m, j, q, s_wb, lane, h0, a, acc);
      float x[2][K];
      decode_x<K>(acc, s_b1, s_w2, s_b2, q, x);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if (kk == q) {
#pragma unroll
          for (int r = 0; r < 2; ++r) wx[(j * kTileRows + g + 8 * r) * 4 + kk] = x[r][kk];
        }
      }
    }
    __syncwarp();

    // pass 2: per member, dx, the recomputed hiddens and the backward
    float dfa[2][4][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dfa[r][nt][0] = dfa[r][nt][1] = 0.f;
    }
    float s0sum[2] = {0.f, 0.f};
    for (int j = 0; j < m; ++j) {
      // class q's dx on rows g, g + 8; invalid pixels get 0 and add nothing
      float mine[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mine[r] = 0.f;
        if (q < K && ok[r]) {
          const float* col = wx + (g + 8 * r) * 4 + q;
          const float xv = col[j * kTileRows * 4];
          const float s0 = sign_f32(xv - yq[r]);
          s0sum[r] += s0;
          // sum_i sign(x_j - x_i), as #(x_i < x_j) - #(x_i > x_j)
          int count = 0;
          for (int i = 0; i < m; ++i) {
            const float xi = col[i * kTileRows * 4];
            count += static_cast<int>(xi < xv) - static_cast<int>(xi > xv);
          }
          mine[r] = __fadd_rn(__fmul_rn(gb1, s0), __fmul_rn(gb2, static_cast<float>(count)));
        }
      }
      db2 += mine[0];
      db2 += mine[1];
      float dxr[2][K];  // every class, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dxr[r][kk] = round_bf16(__shfl_sync(0xffffffffu, mine[r], (lane & ~3) | kk));
        }
      }
      // recompute h1 = h0 W1
      float h0[2][4][2];
      uint32_t a[2][4];
      float acc[4][4];
      member_hidden(f, s_z, m, j, q, s_wb, lane, h0, a, acc);
      // da1 = (W2 dx) * (h1 > 0); db1, dW2 on the FP32 pipes
      float da1[2][4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = nt * 8 + 2 * q + e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float h1 = fmaxf(acc[nt][2 * r + e] + s_b1[o], 0.f);
            const float h1r = round_bf16(h1);
            float dh1 = 0.f;
#pragma unroll
            for (int kk = 0; kk < K; ++kk) {
              dh1 = fmaf(s_w2[o * K + kk], dxr[r][kk], dh1);
              dw2[nt][e][kk] = fmaf(h1r, dxr[r][kk], dw2[nt][e][kk]);
            }
            const float d = h1 > 0.f ? dh1 : 0.f;
            da1[r][nt][e] = d;
            db1[nt][e] += d;
          }
        }
      }
      // dh0 = da1 W1^T on the tensor cores, from the repacked accumulators
      uint32_t da[2][4];
      a_frags(da1, da);
      float dh0[4][4];
      product32(da, s_wt, lane, dh0);
      // du = dh0 * (h0 > 0): dfeat, and this member's dz column
      float colsum[8];  // channel nt * 8 + 2 q + e at 2 nt + e, over rows g, g + 8
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float du = h0[r][nt][e] > 0.f ? dh0[nt][2 * r + e] : 0.f;
            dfa[r][nt][e] += du;
            s += du;
          }
          colsum[2 * nt + e] = s;
        }
      }
      // over the 8 lanes of each q, each lane ends with channel
      // (g / 2) * 8 + 2 q + g % 2
      const float dzs = reduce_scatter8(colsum, lane);
      wdz[((g >> 1) * 8 + 2 * q + (g & 1)) * m + j] += dzs;
      // dW1 += h0^T da1 over the tile's 16 rows: m = channel c, n = o,
      // k = row. A (c x row) and B (row x o) are the 8x8 transposes of the
      // h0 and da1 fragments' blocks, the block (rows 8 r.., cols 8 cb..) of
      // a fragment set x being x[cb / 2][2 (cb % 2) + r].
      uint32_t at[2][4], bt[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        at[mt][0] = transpose8x8(a[mt][0]);  // c 16 mt + 0..7, rows 0..7
        at[mt][1] = transpose8x8(a[mt][2]);  // c 16 mt + 8..15, rows 0..7
        at[mt][2] = transpose8x8(a[mt][1]);  // c 16 mt + 0..7, rows 8..15
        at[mt][3] = transpose8x8(a[mt][3]);  // c 16 mt + 8..15, rows 8..15
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bt[nt][0] = transpose8x8(da[nt / 2][2 * (nt % 2)]);      // rows 0..7
        bt[nt][1] = transpose8x8(da[nt / 2][2 * (nt % 2) + 1]);  // rows 8..15
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(dw1[mt][nt], at[mt], bt[nt][0], bt[nt][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!ok[r]) continue;
      float* dp = dfeat + static_cast<size_t>(b) * kC * p + px[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) dp[static_cast<size_t>(nt * 8 + 2 * q + e) * p] = dfa[r][nt][e];
      }
      if (dy != nullptr && q < K) {
        dy[(static_cast<size_t>(b) * K + q) * p + px[r]] = __fmul_rn(-gb1, s0sum[r]);
      }
    }
    __syncwarp();  // wx is rewritten by the next tile
  }

  // this warp's weight partials: [dW1 (C*C) | db1 (C) | dW2 (C*K) | db2 (K)]
  float* ws = s_w + warp * kNW;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = mt * 16 + g + 8 * (i / 2);
        ws[c * kC + nt * 8 + 2 * q + (i % 2)] = dw1[mt][nt][i];
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = nt * 8 + 2 * q + e;
      const float s = sum_over_g(db1[nt][e]);
      if (g == 0) ws[kC * kC + o] = s;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float t = sum_over_g(dw2[nt][e][kk]);
        if (g == 0) ws[kC * kC + kC + o * K + kk] = t;
      }
    }
  }
  db2 = sum_over_g(db2);
  if (g == 0 && q < K) ws[kC * kC + kC + kC * K + q] = db2;
  __syncthreads();
  // the block's partials: warps summed in order
  float* wp = w_part + (static_cast<size_t>(b) * nbx + bx) * kNW;
  for (int i = tid; i < kNW; i += kMmaThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) s += s_w[w * kNW + i];
    wp[i] = s;
  }
  float* zp = dz_part + (static_cast<size_t>(bx) * batch + b) * kC * m;
  for (int i = tid; i < kC * m; i += kMmaThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) s += s_dz[w * kC * m + i];
    zp[i] = s;
  }
}

size_t bwd_mma_smem_bytes(int m, int k) {
  const size_t nw = static_cast<size_t>(kC) * kC + kC + static_cast<size_t>(kC) * k + k;
  return sizeof(float) * (kC + kC * kMaxK + kMaxK + static_cast<size_t>(kC) * m +
                          static_cast<size_t>(kMmaWarps) * m * kTileRows * 4 +
                          static_cast<size_t>(kMmaWarps) * kC * m + kMmaWarps * nw +
                          2 * 16 * 32);
}

// -- A on the tensor cores ---------------------------------------------------
//
// What bounded the FP32 kernel with bf16 operands (5.93 ms at B=128,
// P=16384, M=15 on an H100 80GB HBM3 at 700 W, 68x its byte bound): the
// 32x32 product on the FP32 pipes, each FMA reading its W1 operand as a
// shared-memory broadcast, 32-wide feature and accumulator arrays a thread,
// the pair term through a shared-memory column per thread, and B * P/128
// partials. The decode here is A′'s first pass: the same 16-pixel warp
// tiles, the same functions (load_tile, member_hidden, decode_x), so A and
// A′ decode the members bit for bit alike. Then:
//
// - t1: lane q of a quad owns class q and adds |x - y| as each member is
//   decoded.
// - t2: the member's x (every class of both rows, the same in each lane of
//   the quad after decode_x) goes to the warp's slice of shared memory, one
//   float4 a row. The pairs sum_{i<j} |x_i - x_j| are shared out over the
//   quad's four lanes by i mod 4, each lane taking all K classes, so no
//   lane idles through the pair loop when K < 4 (with a class a lane, lane
//   q >= K would: a quarter of the warp at K = 3). A member's slice is
//   padded to 72 floats, so the quad's float4 reads of members i..i+3 fall
//   in distinct banks.
// - A block of 4 warps walks a fixed set of tiles of one batch element
//   (grid: as many blocks per element as fill the card once, from an
//   occupancy query) and writes one (t1, t2) partial: B * nbx partials,
//   which launch_reduce adds in a fixed order.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 1.09 ms at B=128,
// P=16384, M=15, K=3 (80 registers, no spills), 12.5x its byte bound:
// issue-bound, as A′ is, on the FP32-pipe work around its 8 mma.sync per
// 16 pixel-members (decode_x's bias, ReLU, rounding and h1 W2; the pairs).
constexpr int kPairStride = kTileRows * 4 + 8;  // floats of one member in a warp's x slice
constexpr int kFwdMinBlocks = 4;                // blocks an SM must hold: at most 128 registers

template <int K>
__global__ void __launch_bounds__(kMmaThreads, kFwdMinBlocks)
fcomb_crps_fwd_mma_kernel(const float* __restrict__ feat,  // (B, C, P)
                          const float* __restrict__ z,     // (B, C, M)
                          const float* __restrict__ w1,    // (C, C)
                          const float* __restrict__ b1,    // (C,)
                          const float* __restrict__ w2,    // (C, K)
                          const float* __restrict__ b2,    // (K,)
                          const float* __restrict__ y,     // (B, K, P)
                          float* __restrict__ partial,     // (2, B, nbx)
                          int batch, int m, int p, int nbx) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                                     // per warp (m, kPairStride)
  uint32_t* s_wb = reinterpret_cast<uint32_t*>(s_x + kMmaWarps * m * kPairStride);  // pack_w1
  float* s_b1 = reinterpret_cast<float*>(s_wb + 16 * 32);  // kC
  float* s_w2 = s_b1 + kC;                               // kC * K, rounded
  float* s_b2 = s_w2 + kC * kMaxK;                       // K
  float* s_z = s_b2 + kMaxK;                             // kC * m
  __shared__ float red[kMmaWarps];

  const int b = blockIdx.y;
  const int bx = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;

  for (int i = tid; i < kC * K; i += kMmaThreads) s_w2[i] = round_bf16(w2[i]);
  for (int i = tid; i < kC * m; i += kMmaThreads) s_z[i] = z[static_cast<size_t>(b) * kC * m + i];
  if (tid < kC) s_b1[tid] = b1[tid];
  if (tid < K) s_b2[tid] = b2[tid];
  pack_w1(w1, s_wb, nullptr);
  __syncthreads();

  float* wx = s_x + warp * m * kPairStride;  // wx[j * kPairStride + row * 4 + class]
  const float* fb = feat + static_cast<size_t>(b) * kC * p;
  const float* yb = y + static_cast<size_t>(b) * K * p;
  const int ntiles = (p + kTileRows - 1) / kTileRows;
  float v1 = 0.f;
  float v2 = 0.f;
  for (int tile = bx * kMmaWarps + warp; tile < ntiles; tile += nbx * kMmaWarps) {
    int px[2];
    bool ok[2];
    float f[2][4][2];
    float yq[2];
    load_tile<K>(fb, yb, p, tile, g, q, f, yq, px, ok);
    for (int j = 0; j < m; ++j) {
      float h0[2][4][2];
      uint32_t a[2][4];
      float acc[4][4];
      member_hidden(f, s_z, m, j, q, s_wb, lane, h0, a, acc);
      float x[2][K];
      decode_x<K>(acc, s_b1, s_w2, s_b2, q, x);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ok[r]) continue;  // a pixel past the last adds nothing
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          if (kk == q) v1 += fabsf(x[r][kk] - yq[r]);
        }
        const float* col = wx + (g + 8 * r) * 4;
        for (int i = q; i < j; i += 4) {
          const float4 w = *reinterpret_cast<const float4*>(col + i * kPairStride);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int kk = 0; kk < K; ++kk) v2 += fabsf(wv[kk] - x[r][kk]);
        }
      }
      // member j's x: lane q = 0 writes row g, lane q = 1 row g + 8
      if (q < 2) {
        float out[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < K; ++kk) out[kk] = q == 0 ? x[0][kk] : x[1][kk];
        *reinterpret_cast<float4*>(wx + j * kPairStride + (g + 8 * q) * 4) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
      __syncwarp();  // member j's x, before member j + 1 reads it
    }
  }
  const float s1 = block_sum<kMmaThreads>(v1, red);
  const float s2 = block_sum<kMmaThreads>(v2, red);
  if (tid == 0) {
    partial[static_cast<size_t>(b) * nbx + bx] = s1;
    partial[(static_cast<size_t>(batch) + b) * nbx + bx] = s2;
  }
}

size_t fwd_mma_smem_bytes(int m) {
  return sizeof(float) * (static_cast<size_t>(kMmaWarps) * m * kPairStride + 16 * 32 + kC +
                          kC * kMaxK + kMaxK + static_cast<size_t>(kC) * m);
}

// -- both directions --------------------------------------------------------------

constexpr int kFp32 = 0;         // f32 operands, FP32 pipes
constexpr int kTensorCore = 1;   // bf16 operands, mma.sync

bool args_valid(int which, int batch, int m, int k, int p) {
  return m >= 1 && m <= kMaxM && k >= 1 && k <= kMaxK && batch >= 1 && batch <= 65535 &&
         p >= 1 && (which == kFp32 || which == kTensorCore);
}

// Blocks per batch element of a tensor-core kernel: as many as fill the
// card's resident slots once (at least 1, at most one warp per tile).
template <typename Kernel>
cudaError_t fill_blocks(Kernel kernel, size_t smem, int batch, int p, int* nbx) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (p + kTileRows - 1) / kTileRows;
  const int most = (ntiles + kMmaWarps - 1) / kMmaWarps;
  const int fill = per_sm * sms / batch;
  *nbx = fill < 1 ? 1 : (fill > most ? most : fill);
  return cudaSuccess;
}

// Rows of partials per batch element that forward kernel `which` writes.
cudaError_t fwd_partials(int which, int batch, int m, int k, int p, int* rows) {
  if (which == kFp32) {
    *rows = (p + kThreads - 1) / kThreads;
    return cudaSuccess;
  }
  const size_t smem = fwd_mma_smem_bytes(m);
  switch (k) {
    case 1: return fill_blocks(fcomb_crps_fwd_mma_kernel<1>, smem, batch, p, rows);
    case 2: return fill_blocks(fcomb_crps_fwd_mma_kernel<2>, smem, batch, p, rows);
    case 3: return fill_blocks(fcomb_crps_fwd_mma_kernel<3>, smem, batch, p, rows);
    default: return fill_blocks(fcomb_crps_fwd_mma_kernel<4>, smem, batch, p, rows);
  }
}

// Rows of partials per batch element that backward kernel `which` writes.
cudaError_t bwd_partials(int which, int batch, int m, int k, int p, int* rows) {
  if (which == kFp32) {
    *rows = (p + kThreads - 1) / kThreads;
    return cudaSuccess;
  }
  const size_t smem = bwd_mma_smem_bytes(m, k);
  switch (k) {
    case 1: return fill_blocks(fcomb_crps_bwd_mma_kernel<1>, smem, batch, p, rows);
    case 2: return fill_blocks(fcomb_crps_bwd_mma_kernel<2>, smem, batch, p, rows);
    case 3: return fill_blocks(fcomb_crps_bwd_mma_kernel<3>, smem, batch, p, rows);
    default: return fill_blocks(fcomb_crps_bwd_mma_kernel<4>, smem, batch, p, rows);
  }
}

cudaError_t launch_fwd(int which, const float* feat, const float* z, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* y,
                       float* partial, float* t1, float* t2, int batch, int m, int k, int p,
                       cudaStream_t stream) {
  int rows = 0;
  cudaError_t err = fwd_partials(which, batch, m, k, p, &rows);
  if (err != cudaSuccess) return err;
  if (which == kFp32) {
    err = launch_fp32(feat, z, w1, b1, w2, b2, y, partial, batch, m, k, p, stream);
  } else {
    const size_t smem = fwd_mma_smem_bytes(m);
#define PROBUNET_MMA_CASE(K)                                                                  \
  case K:                                                                                     \
    fcomb_crps_fwd_mma_kernel<K><<<dim3(rows, batch), kMmaThreads, smem, stream>>>(           \
        feat, z, w1, b1, w2, b2, y, partial, batch, m, p, rows);                              \
    err = cudaGetLastError();                                                                 \
    break;
    switch (k) {
      PROBUNET_MMA_CASE(1)
      PROBUNET_MMA_CASE(2)
      PROBUNET_MMA_CASE(3)
      default: PROBUNET_MMA_CASE(4)
    }
#undef PROBUNET_MMA_CASE
  }
  if (err != cudaSuccess) return err;
  launch_reduce(partial, t1, t2, batch, rows, stream);
  return cudaGetLastError();
}

cudaError_t launch_bwd(int which, const float* feat, const float* z, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* y,
                       const float* g1, const float* g2, float* dfeat, float* dy,
                       float* dz_part, float* w_part, float* dz, float* dw, int batch, int m,
                       int k, int p, cudaStream_t stream) {
  int rows = 0;
  cudaError_t err = bwd_partials(which, batch, m, k, p, &rows);
  if (err != cudaSuccess) return err;
  if (which == kFp32) {
    err = launch_bwd_fp32(feat, z, w1, b1, w2, b2, y, g1, g2, dfeat, dy, dz_part, w_part, batch,
                          m, k, p, stream);
  } else {
    const size_t smem = bwd_mma_smem_bytes(m, k);
#define PROBUNET_MMA_CASE(K)                                                                  \
  case K:                                                                                     \
    fcomb_crps_bwd_mma_kernel<K><<<dim3(rows, batch), kMmaThreads, smem, stream>>>(           \
        feat, z, w1, b1, w2, b2, y, g1, g2, dfeat, dy, dz_part, w_part, batch, m, p, rows);   \
    err = cudaGetLastError();                                                                 \
    break;
    switch (k) {
      PROBUNET_MMA_CASE(1)
      PROBUNET_MMA_CASE(2)
      PROBUNET_MMA_CASE(3)
      default: PROBUNET_MMA_CASE(4)
    }
#undef PROBUNET_MMA_CASE
  }
  if (err != cudaSuccess) return err;
  launch_column_sum(dz_part, dz, rows, batch * kC * m, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_column_sum(w_part, dw, batch * rows, kC * kC + kC + kC * k + k, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

extern "C" {

int fcomb_crps_channels() { return probunet::kC; }

int fcomb_crps_max_members() { return probunet::kMaxM; }

int fcomb_crps_max_classes() { return probunet::kMaxK; }

// Rows of partials per batch element of fcomb_crps_terms_fwd (forward = 1)
// or fcomb_crps_terms_bwd (forward = 0) with kernel `which` (0: f32
// operands on the FP32 pipes; 1: bf16 operands on the tensor cores),
// written to *rows (an int). Returns a cudaError_t.
int fcomb_crps_partials(int forward, int which, int batch, int m, int k, int p, void* rows) {
  if (!probunet::args_valid(which, batch, m, k, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* out = static_cast<int*>(rows);
  return static_cast<int>(forward ? probunet::fwd_partials(which, batch, m, k, p, out)
                                  : probunet::bwd_partials(which, batch, m, k, p, out));
}

// feat (B, C, P), z (B, C, M), w1 (C, C), b1 (C,), w2 (C, K), b2 (K,),
// y (B, K, P): f32, contiguous, C = fcomb_crps_channels(). partial:
// (2, B, R) f32 scratch, R from fcomb_crps_partials; t1, t2: (B,) f32.
// `which` as there: kernel 1 rounds the products' operands to bf16,
// kernel 0 keeps them f32. Returns cudaGetLastError().
int fcomb_crps_terms_fwd(const void* feat, const void* z, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* y, void* partial,
                         void* t1, void* t2, int batch, int m, int k, int p, int which,
                         void* stream) {
  if (!probunet::args_valid(which, batch, m, k, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto c = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto w = [](void* ptr) { return static_cast<float*>(ptr); };
  return static_cast<int>(probunet::launch_fwd(
      which, c(feat), c(z), c(w1), c(b1), c(w2), c(b2), c(y), w(partial), w(t1), w(t2), batch,
      m, k, p, static_cast<cudaStream_t>(stream)));
}

// The forward's operands plus g1, g2 (B,) f32. Outputs: dfeat (B, C, P);
// dy (B, K, P) or null (not computed); dz (B, C, M); dw: the weight
// gradients packed as [dW1 (C, C) | db1 (C) | dW2 (C, K) | db2 (K)].
// Scratch: dz_part (R, B, C, M) and w_part (B * R, C*C + C + C*K + K) f32,
// R from fcomb_crps_partials. `which` as for the forward. Returns
// cudaGetLastError().
int fcomb_crps_terms_bwd(const void* feat, const void* z, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* y, const void* g1,
                         const void* g2, void* dfeat, void* dy, void* dz_part, void* w_part,
                         void* dz, void* dw, int batch, int m, int k, int p, int which,
                         void* stream) {
  if (!probunet::args_valid(which, batch, m, k, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto c = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto w = [](void* ptr) { return static_cast<float*>(ptr); };
  return static_cast<int>(probunet::launch_bwd(
      which, c(feat), c(z), c(w1), c(b1), c(w2), c(b2), c(y), c(g1), c(g2), w(dfeat), w(dy),
      w(dz_part), w(w_part), w(dz), w(dw), batch, m, k, p, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
