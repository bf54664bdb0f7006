// The U-Net's GroupNorm chain, forward (C) and analytic backward (C′):
//
//   y = dropout(silu((gn(x) * gamma + beta) * (scale + 1) + shift))
//
// Replaces the TPU kernels probunet_tpu/ops/pallas/fused_gn.py:_fwd_impl
// (pallas_call of _fwd_kernel) and :_bwd_impl (pallas_call of _bwd_kernel).
// x is NHWC (B, HW, C), bf16 or f32; gamma, beta (C,) and scale, shift
// (B, C) f32; G groups of C/G channels; n = HW * C/G.
//
// Forward, as the TPU kernel computes it: s1 = sum x and s2 = sum (x*x), the
// product rounded to x's type, summed in f32 per (batch, group); mean = s1/n,
// rstd = 1/sqrt(s2/n - mean^2 + eps) with no clamp; per (batch, channel)
// p = rstd*gamma, a = p*(scale+1), b = (beta - mean*p)*(scale+1) + shift;
// z = x*a + b in f32, SiLU, dropout, one rounding to x's type. Backward
// (fused_gn.py:153-208): dz = g * silu'(z), masked; per channel the sums
// Sdz = sum dz and Sdzx = sum dz*x give dshift = Sdz, dscale = Sdzx*p +
// Sdz*q (q = beta - mean*p), dbeta = sum_b Sdz*(scale+1), dgamma = sum_b
// (Sdzx - mean*Sdz)*rstd*(scale+1), and dx = dz*c1 + x*c2 + c3 with c1, c2,
// c3 from the group means of those sums times gamma. Every product and sum
// of that arithmetic is one rounded f32 operation (__fmul_rn / __fadd_rn,
// no FMA contraction), in the order of ops/kernels/fused_gn.py's plain
// version.
//
// The dropout mask is the JAX kernel's: _dropout_uniform over the lane-packed
// (HW/k, k*C) block of batch element b hashes r*(k*C) + col with salt b, and
// r*(k*C) + col is the NHWC index e = (h*W + w)*C + c inside the element, so
// this kernel hashes (e, seed, b) (hash.cuh) and needs no pack factor.
//
// Bound: device-memory bytes. C reads x and writes y (at the flagship's
// (128, 128, 128, 32) bf16 activation 268 MB, 0.080 ms at 3.35 TB/s); C′
// reads x and g and writes dx; the arithmetic is ~10 (C) and ~30 (C′) f32
// operations and one exp per element, far under the FP32 rate those bytes
// allow, though C′'s ~40 instructions an element (z, an IEEE exp and
// division, the hash) take about as long to issue as a pass's bytes.
//
// The TPU kernel holds one batch element's whole (HW, C) slab in VMEM (grid
// (B,)). That slab is 1 MB at 128x128x32 bf16 and 3 MB at the decoder's
// C=96 concat, up to 13x the 227 KB of shared memory a block has.
//
// C splits the statistics: (1) a stats pass over (pixel tile, channel
// chunk, batch) blocks writes per-channel f32 partials of s1 and s2; (2) a
// finalize block per batch element adds them in a fixed order (tiles, then
// the group's channels) into mean/rstd and the per-channel a, b; (3) an
// apply pass writes y. It reads x three times (the TPU kernel twice).
//
// C′ keeps the slab on chip instead where that pays, on a thread-block
// cluster: the plan made per shape in the wrapper
// (ops/kernels/fused_gn.py:bwd_plan) gives each (batch element, channel
// part of whole groups) of a bf16 chain one cluster of up to 8 blocks,
// whose shared memory holds the part's x and dz while the blocks exchange
// their sums through distributed shared memory. x and g are read once, dx
// written once, and dz computed once (see gn_bwd_cluster_kernel). The
// other shapes (f32 x, C not a multiple of 8, more rows than 8 blocks'
// shared memory takes, or parts narrower than 64 bytes, as at 128x128)
// run the two-pass route: (1) a coefficient pass recomputes a, b from the
// saved mean/rstd; (2) a reduce pass recomputes z, silu' and the mask and
// writes per-channel partials of Sdz and Sdzx;
// (3) a finalize block per batch element gives dshift, dscale, the
// per-batch dgamma/dbeta terms and c1, c2, c3; (4) dgamma and dbeta are
// summed over the batch in order; (5) a dx pass recomputes dz and writes
// dx.
//
// Every thread owns VEC = 8 consecutive channels of a pixel (one 16-byte
// load in bf16, two in f32; VEC = 1 when C % 8 != 0, two-pass only), so the
// loads are coalesced along channels. In the reduce passes a block's
// threads keep fixed columns (cw vector columns, rpi rows at a time) and sum
// their rows in registers, then over rows in shared memory in a fixed order.
// No float atomics anywhere (an integer arrival count at most): results are
// bit-reproducible from run to run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace probunet {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;  // pixel rows a reduce-pass thread sums

// -- vector loads and stores: VEC consecutive elements, widened to f32 -----

__device__ __forceinline__ void loadv(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void loadv(const float* p, float (&v)[1]) { v[0] = *p; }

__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

__device__ __forceinline__ void storev(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void storev(float* p, const float (&v)[1]) { *p = v[0]; }

__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

// x*x rounded to x's type, as the TPU kernel's jnp.sum(x * x, dtype=f32)
__device__ __forceinline__ float square(float v, const float*) { return __fmul_rn(v, v); }

__device__ __forceinline__ float square(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, v)));
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// a, b of z = x*a + b for one (batch, channel)
__device__ __forceinline__ void chain_coef(float mean, float rstd, float gam, float bet,
                                           float sc, float sh, float* a, float* b) {
  const float p = __fmul_rn(rstd, gam);
  const float sc1 = __fadd_rn(sc, 1.f);
  *a = __fmul_rn(p, sc1);
  *b = __fadd_rn(__fmul_rn(__fsub_rn(bet, __fmul_rn(mean, p)), sc1), sh);
}

// What the forward outputs at one element, before the cast: the chain of
// z = x*a + b, with dropout at NHWC index e of batch element `salt`.
__device__ __forceinline__ float chain_out(float x, float a, float b, int silu, int drop,
                                           uint32_t e, uint32_t key, uint32_t salt, float p,
                                           float drop_scale) {
  const float z = __fadd_rn(__fmul_rn(x, a), b);
  float out = silu ? __fmul_rn(z, sigmoid(z)) : z;
  if (drop) out = hash_uniform(e, key, salt) >= p ? __fmul_rn(out, drop_scale) : 0.f;
  return out;
}

// dz = g * silu'(z), masked and scaled like the forward
__device__ __forceinline__ float chain_dz(float x, float g, float a, float b, int silu, int drop,
                                          uint32_t e, uint32_t key, uint32_t salt, float p,
                                          float drop_scale) {
  float dz = g;
  if (silu) {
    const float z = __fadd_rn(__fmul_rn(x, a), b);
    const float sig = sigmoid(z);
    const float dact = __fmul_rn(sig, __fadd_rn(1.f, __fmul_rn(z, __fsub_rn(1.f, sig))));
    dz = __fmul_rn(g, dact);
  }
  if (drop) dz = hash_uniform(e, key, salt) >= p ? __fmul_rn(dz, drop_scale) : 0.f;
  return dz;
}

// -- the tiling of the reduce passes ----------------------------------------

struct Tiling {
  int vec, cols, rpi, tile_px, ntiles, nchunks;
};

__host__ __device__ inline int vec_width(int c) { return c % 8 == 0 ? 8 : 1; }

// cols vector columns per pixel; a block covers up to kThreads of them (a
// chunk) and rpi = kThreads / min(cols, kThreads) pixel rows at a time, over
// a tile of tile_px = kRowsPerThread * rpi pixels.
inline Tiling tiling(int hw, int c) {
  Tiling t;
  t.vec = vec_width(c);
  t.cols = c / t.vec;
  const int cw = t.cols < kThreads ? t.cols : kThreads;
  t.rpi = kThreads / cw;
  t.tile_px = kRowsPerThread * t.rpi;
  t.ntiles = (hw + t.tile_px - 1) / t.tile_px;
  t.nchunks = (t.cols + kThreads - 1) / kThreads;
  return t;
}

// Per-block sums of two per-thread VEC vectors over the rows of each
// column, in row order, written to partial[0 or 1][b][tile][channel].
template <int VEC>
__device__ __forceinline__ void write_partials(const float (&s)[VEC], const float (&q)[VEC],
                                               float (*red)[kThreads * VEC], float* partial,
                                               int batch, int b, int tile, int ntiles, int c,
                                               int colbase, int cw, int rpi) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[0][t * VEC + i] = s[i];
    red[1][t * VEC + i] = q[i];
  }
  __syncthreads();
  for (int j = t; j < cw * VEC; j += kThreads) {
    const int cc = j / VEC;
    const int i = j % VEC;
    float a = 0.f, z = 0.f;
    for (int r = 0; r < rpi; ++r) {
      a += red[0][(r * cw + cc) * VEC + i];
      z += red[1][(r * cw + cc) * VEC + i];
    }
    const int ch = (colbase + cc) * VEC + i;
    partial[(static_cast<size_t>(b) * ntiles + tile) * c + ch] = a;
    partial[((static_cast<size_t>(batch) + b) * ntiles + tile) * c + ch] = z;
  }
}

// -- C: forward -------------------------------------------------------------

// grid (ntiles, nchunks, B): per-channel partial s1, s2 of one pixel tile
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_fwd_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int batch, int hw,
                    int c, int tile_px, int ntiles) {
  __shared__ float red[2][kThreads * VEC];
  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const int cols = c / VEC;
  const int colbase = blockIdx.y * kThreads;
  const int cw = min(kThreads, cols - colbase);
  const int rpi = kThreads / cw;
  const int col = colbase + threadIdx.x % cw;
  const int r0 = threadIdx.x / cw;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (r0 < rpi) {
    const T* xb = x + static_cast<size_t>(b) * hw * c + static_cast<size_t>(col) * VEC;
    const int px1 = min(hw, (tile + 1) * tile_px);
    for (int px = tile * tile_px + r0; px < px1; px += rpi) {
      float v[VEC];
      loadv(xb + static_cast<size_t>(px) * c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[i] += v[i];
        s2[i] += square(v[i], x);
      }
    }
  }
  write_partials<VEC>(s1, s2, red, partial, batch, b, tile, ntiles, c, colbase, cw, rpi);
}

// grid (B): mean, rstd (B, G) and the per-channel a, b (coef[0], coef[1],
// each (B, C)). Shared memory: 2C + 2G floats.
__global__ void __launch_bounds__(kThreads)
gn_fwd_finalize_kernel(const float* __restrict__ partial, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ scale,
                       const float* __restrict__ shift, float* __restrict__ mean,
                       float* __restrict__ rstd, float* __restrict__ coef, int batch,
                       int ntiles, int c, int groups, float n, float eps) {
  extern __shared__ float sm[];
  float* s1 = sm;
  float* s2 = sm + c;
  float* gm = sm + 2 * c;
  float* gr = gm + groups;
  const int b = blockIdx.x;
  const int cg = c / groups;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = 0.f, q = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
      a += partial[(static_cast<size_t>(b) * ntiles + tile) * c + ch];
      q += partial[((static_cast<size_t>(batch) + b) * ntiles + tile) * c + ch];
    }
    s1[ch] = a;
    s2[ch] = q;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < cg; ++i) {
      a += s1[g * cg + i];
      q += s2[g * cg + i];
    }
    const float m = __fdiv_rn(a, n);
    const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(m, m));
    const float r = 1.f / sqrtf(__fadd_rn(var, eps));
    mean[b * groups + g] = m;
    rstd[b * groups + g] = r;
    gm[g] = m;
    gr[g] = r;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const int i = b * c + ch;
    chain_coef(gm[ch / cg], gr[ch / cg], gamma[ch], beta[ch], scale[i], shift[i], &coef[i],
               &coef[static_cast<size_t>(batch) * c + i]);
  }
}

// grid (ceil(HW * C / VEC / kThreads), B): y from x and the coefficients
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                    const int* __restrict__ seed, T* __restrict__ y, int batch, int hw, int c,
                    int silu, int drop, float p, float drop_scale) {
  const int b = blockIdx.y;
  const long long vi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vi * VEC >= static_cast<long long>(hw) * c) return;
  const long long e0 = vi * VEC;
  const int c0 = static_cast<int>(e0 % c);
  const size_t off = static_cast<size_t>(b) * hw * c + e0;
  const uint32_t key = hash_key(seed);
  float v[VEC], a[VEC], bb[VEC];
  loadv(x + off, v);
  loadv(coef + static_cast<size_t>(b) * c + c0, a);
  loadv(coef + (static_cast<size_t>(batch) + b) * c + c0, bb);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    v[i] = chain_out(v[i], a[i], bb[i], silu, drop, static_cast<uint32_t>(e0 + i), key,
                     static_cast<uint32_t>(b), p, drop_scale);
  }
  storev(y + off, v);
}

// -- C′: backward -----------------------------------------------------------

// grid (ceil(C / kThreads), B): coef[0], coef[1] = a, b from mean/rstd
__global__ void __launch_bounds__(kThreads)
gn_bwd_coef_kernel(const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ scale, const float* __restrict__ shift,
                   float* __restrict__ coef, int batch, int c, int groups) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (ch >= c) return;
  const int g = b * groups + ch / (c / groups);
  const int i = b * c + ch;
  chain_coef(mean[g], rstd[g], gamma[ch], beta[ch], scale[i], shift[i], &coef[i],
             &coef[static_cast<size_t>(batch) * c + i]);
}

// grid (ntiles, nchunks, B): per-channel partial Sdz, Sdzx of one tile
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ coef, const int* __restrict__ seed,
                     float* __restrict__ partial, int batch, int hw, int c, int tile_px,
                     int ntiles, int silu, int drop, float p, float drop_scale) {
  __shared__ float red[2][kThreads * VEC];
  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const int cols = c / VEC;
  const int colbase = blockIdx.y * kThreads;
  const int cw = min(kThreads, cols - colbase);
  const int rpi = kThreads / cw;
  const int col = colbase + threadIdx.x % cw;
  const int r0 = threadIdx.x / cw;
  float sdz[VEC], sdzx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sdz[i] = sdzx[i] = 0.f;
  if (r0 < rpi) {
    const uint32_t key = hash_key(seed);
    float a[VEC], bb[VEC];
    loadv(coef + static_cast<size_t>(b) * c + col * VEC, a);
    loadv(coef + (static_cast<size_t>(batch) + b) * c + col * VEC, bb);
    const size_t base = static_cast<size_t>(b) * hw * c + static_cast<size_t>(col) * VEC;
    const int px1 = min(hw, (tile + 1) * tile_px);
    for (int px = tile * tile_px + r0; px < px1; px += rpi) {
      const size_t e0 = static_cast<size_t>(px) * c + static_cast<size_t>(col) * VEC;
      float xv[VEC], gv[VEC];
      loadv(x + base + static_cast<size_t>(px) * c, xv);
      loadv(g + base + static_cast<size_t>(px) * c, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float dz = chain_dz(xv[i], gv[i], a[i], bb[i], silu, drop,
                                  static_cast<uint32_t>(e0 + i), key, static_cast<uint32_t>(b),
                                  p, drop_scale);
        sdz[i] += dz;
        sdzx[i] += __fmul_rn(dz, xv[i]);
      }
    }
  }
  write_partials<VEC>(sdz, sdzx, red, partial, batch, b, tile, ntiles, c, colbase, cw, rpi);
}

// grid (B): from the partials, dshift and dscale (B, C), the per-batch
// dgamma and dbeta terms (coef[5], coef[6]) and c1, c2, c3 (coef[2..4]).
// Shared memory: 2C + 2G floats.
__global__ void __launch_bounds__(kThreads)
gn_bwd_finalize_kernel(const float* __restrict__ partial, const float* __restrict__ mean,
                       const float* __restrict__ rstd, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ scale,
                       float* __restrict__ dscale, float* __restrict__ dshift,
                       float* __restrict__ coef, int batch, int ntiles, int c, int groups,
                       float n) {
  extern __shared__ float sm[];
  float* t1 = sm;
  float* t2 = sm + c;
  float* m1 = sm + 2 * c;
  float* m2 = m1 + groups;
  const size_t bc = static_cast<size_t>(batch) * c;
  const int b = blockIdx.x;
  const int cg = c / groups;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float s_dz = 0.f, s_dzx = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
      s_dz += partial[(static_cast<size_t>(b) * ntiles + tile) * c + ch];
      s_dzx += partial[((static_cast<size_t>(batch) + b) * ntiles + tile) * c + ch];
    }
    const int gi = b * groups + ch / cg;
    const int i = b * c + ch;
    const float mc = mean[gi], rc = rstd[gi], gam = gamma[ch];
    const float p = __fmul_rn(rc, gam);
    const float q = __fsub_rn(beta[ch], __fmul_rn(mc, p));
    const float sc1 = __fadd_rn(scale[i], 1.f);
    dshift[i] = s_dz;
    dscale[i] = __fadd_rn(__fmul_rn(s_dzx, p), __fmul_rn(s_dz, q));
    const float du_s = __fmul_rn(s_dz, sc1);
    const float dux_hat = __fmul_rn(__fmul_rn(__fsub_rn(s_dzx, __fmul_rn(mc, s_dz)), rc), sc1);
    coef[5 * bc + i] = dux_hat;  // dgamma term of batch element b
    coef[6 * bc + i] = du_s;     // dbeta term
    t1[ch] = __fmul_rn(du_s, gam);
    t2[ch] = __fmul_rn(dux_hat, gam);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < cg; ++i) {
      a += t1[g * cg + i];
      q += t2[g * cg + i];
    }
    m1[g] = __fdiv_rn(a, n);
    m2[g] = __fdiv_rn(q, n);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const int g = ch / cg;
    const int gi = b * groups + g;
    const int i = b * c + ch;
    const float mc = mean[gi], rc = rstd[gi];
    const float sc1 = __fadd_rn(scale[i], 1.f);
    coef[2 * bc + i] = __fmul_rn(__fmul_rn(rc, gamma[ch]), sc1);
    coef[3 * bc + i] = __fmul_rn(-__fmul_rn(rc, rc), m2[g]);
    coef[4 * bc + i] = __fmul_rn(rc, __fsub_rn(__fmul_rn(__fmul_rn(mc, rc), m2[g]), m1[g]));
  }
}

// grid (ceil(C / kThreads)): dgamma, dbeta = the batch's terms summed in order
__global__ void __launch_bounds__(kThreads)
gn_bwd_param_sum_kernel(const float* __restrict__ coef, float* __restrict__ dgamma,
                        float* __restrict__ dbeta, int batch, int c) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  const size_t bc = static_cast<size_t>(batch) * c;
  float dg = 0.f, db = 0.f;
  for (int b = 0; b < batch; ++b) {
    dg += coef[5 * bc + static_cast<size_t>(b) * c + ch];
    db += coef[6 * bc + static_cast<size_t>(b) * c + ch];
  }
  dgamma[ch] = dg;
  dbeta[ch] = db;
}

// grid (ceil(HW * C / VEC / kThreads), B): dx = dz*c1 + x*c2 + c3
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ coef, const int* __restrict__ seed,
                 T* __restrict__ dx, int batch, int hw, int c, int silu, int drop, float p,
                 float drop_scale) {
  const int b = blockIdx.y;
  const long long vi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vi * VEC >= static_cast<long long>(hw) * c) return;
  const long long e0 = vi * VEC;
  const int c0 = static_cast<int>(e0 % c);
  const size_t off = static_cast<size_t>(b) * hw * c + e0;
  const size_t bc = static_cast<size_t>(batch) * c;
  const size_t row = static_cast<size_t>(b) * c + c0;
  const uint32_t key = hash_key(seed);
  float xv[VEC], gv[VEC], a[VEC], bb[VEC], c1[VEC], c2[VEC], c3[VEC];
  loadv(x + off, xv);
  loadv(g + off, gv);
  loadv(coef + row, a);
  loadv(coef + bc + row, bb);
  loadv(coef + 2 * bc + row, c1);
  loadv(coef + 3 * bc + row, c2);
  loadv(coef + 4 * bc + row, c3);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float dz = chain_dz(xv[i], gv[i], a[i], bb[i], silu, drop,
                              static_cast<uint32_t>(e0 + i), key, static_cast<uint32_t>(b), p,
                              drop_scale);
    xv[i] = __fadd_rn(__fadd_rn(__fmul_rn(dz, c1[i]), __fmul_rn(xv[i], c2[i])), c3[i]);
  }
  storev(dx + off, xv);
}

// -- host side ---------------------------------------------------------------

struct Args {
  const void* x;
  const void* g;  // backward only
  const float* gamma;
  const float* beta;
  const float* scale;
  const float* shift;
  const int* seed;
  float* mean;
  float* rstd;
  float* work;
  int batch, hw, c, groups, silu, drop;
  float eps, p, drop_scale;
};

// work: coef (7, B, C) then partial (2, B, ntiles, C), f32
inline float* partial_of(const Args& a) { return a.work + 7 * static_cast<size_t>(a.batch) * a.c; }

inline float group_count(const Args& a) {
  return static_cast<float>(static_cast<double>(a.hw) * (a.c / a.groups));
}

template <typename T, int VEC>
cudaError_t launch_fwd(const Args& a, void* y, cudaStream_t s) {
  const Tiling t = tiling(a.hw, a.c);
  gn_fwd_stats_kernel<T, VEC><<<dim3(t.ntiles, t.nchunks, a.batch), kThreads, 0, s>>>(
      static_cast<const T*>(a.x), partial_of(a), a.batch, a.hw, a.c, t.tile_px, t.ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (2 * static_cast<size_t>(a.c) + 2 * a.groups) * sizeof(float);
  gn_fwd_finalize_kernel<<<a.batch, kThreads, smem, s>>>(
      partial_of(a), a.gamma, a.beta, a.scale, a.shift, a.mean, a.rstd, a.work, a.batch,
      t.ntiles, a.c, a.groups, group_count(a), a.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nvec = static_cast<long long>(a.hw) * a.c / VEC;
  gn_fwd_apply_kernel<T, VEC><<<dim3(static_cast<unsigned>((nvec + kThreads - 1) / kThreads),
                                     a.batch), kThreads, 0, s>>>(
      static_cast<const T*>(a.x), a.work, a.seed, static_cast<T*>(y), a.batch, a.hw, a.c,
      a.silu, a.drop, a.p, a.drop_scale);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const Args& a, void* dx, float* dgamma, float* dbeta, float* dscale,
                       float* dshift, cudaStream_t s) {
  const Tiling t = tiling(a.hw, a.c);
  const unsigned cblocks = static_cast<unsigned>((a.c + kThreads - 1) / kThreads);
  gn_bwd_coef_kernel<<<dim3(cblocks, a.batch), kThreads, 0, s>>>(
      a.mean, a.rstd, a.gamma, a.beta, a.scale, a.shift, a.work, a.batch, a.c, a.groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_reduce_kernel<T, VEC><<<dim3(t.ntiles, t.nchunks, a.batch), kThreads, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.work, a.seed, partial_of(a),
      a.batch, a.hw, a.c, t.tile_px, t.ntiles, a.silu, a.drop, a.p, a.drop_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (2 * static_cast<size_t>(a.c) + 2 * a.groups) * sizeof(float);
  gn_bwd_finalize_kernel<<<a.batch, kThreads, smem, s>>>(
      partial_of(a), a.mean, a.rstd, a.gamma, a.beta, a.scale, dscale, dshift, a.work, a.batch,
      t.ntiles, a.c, a.groups, group_count(a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_param_sum_kernel<<<cblocks, kThreads, 0, s>>>(a.work, dgamma, dbeta, a.batch, a.c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nvec = static_cast<long long>(a.hw) * a.c / VEC;
  gn_bwd_dx_kernel<T, VEC><<<dim3(static_cast<unsigned>((nvec + kThreads - 1) / kThreads),
                                  a.batch), kThreads, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.work, a.seed,
      static_cast<T*>(dx), a.batch, a.hw, a.c, a.silu, a.drop, a.p, a.drop_scale);
  return cudaGetLastError();
}

// -- C′ on one cluster per (batch element, channel part) ---------------------
//
// The route the wrapper's plan (ops/kernels/fused_gn.py:bwd_plan) picks
// for bf16 x whenever the slab fits in rows of 64 bytes: one launch (after a 4-byte memset) that reads x
// and g once and writes dx once, the bytes the bound counts. A cluster of
// `cs` blocks owns the (HW, cp) slab of one batch element's channel part
// [c0, c0 + cp), cp a multiple of the group width, so the part's groups are
// whole; block `rank` owns pixel rows [rank * rows, (rank + 1) * rows).
//
//   phase 1: every 16-byte vector (8 channels) of x and g the block owns
//            is copied into shared memory by cp.async at once; a, b from
//            the saved mean/rstd (the coefficient pass, folded in) meanwhile;
//            then dz = g * silu'(z) * mask once, kept (f32) where g was, x
//            kept in its own type, and dz and dz*x summed over the thread's
//            rows, then over the block's rows in order;
//   cluster: every block reads the cs blocks' per-channel sums through
//            distributed shared memory in rank order, so all hold the same
//            totals, and computes dshift, dscale, the dgamma/dbeta terms and
//            c1, c2, c3 for the part (the finalize, folded in); rank 0
//            writes the per-(b, channel) outputs;
//   phase 2: dx = dz*c1 + x*c2 + c3 from shared memory;
//   last:    the last cluster to finish (an integer arrival count) sums the
//            dgamma/dbeta terms over the batch in order (the batch sum,
//            folded in).
//
// A thread keeps its channels (cols = cp/8 vector columns, rpi = 256/cols
// rows at a time), so x and dz go back to the same thread: slot (it, t) of
// shared memory holds iteration it's 8 elements, conflict free. No float
// atomics; every sum in a fixed order, so the outputs are bit-reproducible.
//
// chip_smoke.py times both routes at each of its GroupNorm cases and at
// every chain shape of the flagship U-Net (PERF.md §6): the cluster
// route's life (load everything, reduce, sync, then write) leaves the
// memory idle between its bursts, so it gains over the two passes only
// where their extra reads cost more than that.
constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kRedStride = kClusterThreads + 1;  // row sums: 8 rows of this stride

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16-byte asynchronous copies from device to shared memory
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gptr) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 8 elements of x's type as raw bits (one uint4 in bf16, two in f32)
template <typename T>
struct Raw8 {
  uint4 v[sizeof(T) * 8 / 16];
};

__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  loadv(reinterpret_cast<const __nv_bfloat16*>(r.v), v);
}

__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&v)[8]) {
  loadv(reinterpret_cast<const float*>(r.v), v);
}

// Shared memory of the cluster route, in bytes: x and dz slots, the row
// sums (8 * kRedStride floats) and their segments (kClusterThreads + cp),
// the part's sums (2 cp), the finalize (5 cp), the group means (2 cp) and
// the per-channel parameters (6 cp).
__host__ __device__ inline size_t cluster_smem_bytes(int cp, int iters, int xsize) {
  return static_cast<size_t>(iters) * kClusterThreads * 8 * (xsize + 4) +
         sizeof(float) * (8 * static_cast<size_t>(kRedStride) + kClusterThreads +
                          16 * static_cast<size_t>(cp));
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 2)
gn_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const int* __restrict__ seed, T* __restrict__ dx,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      float* __restrict__ dscale, float* __restrict__ dshift,
                      float* __restrict__ terms,  // (2, B, C): dgamma, dbeta terms
                      unsigned int* __restrict__ arrived, int batch, int hw, int c, int groups,
                      int cp, int cs, int iters, int silu, int drop, float p, float drop_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nslots = iters * kClusterThreads;
  Raw8<T>* s_x = reinterpret_cast<Raw8<T>*>(smem);
  float4* s_dz = reinterpret_cast<float4*>(smem + static_cast<size_t>(nslots) * sizeof(Raw8<T>));
  float* red = reinterpret_cast<float*>(s_dz + 2 * static_cast<size_t>(nslots));
  float* seg = red + 8 * kRedStride;        // (nseg, cp) segment sums, nseg * cp <= 256 + cp
  float* part = seg + kClusterThreads + cp; // (2, cp): this block's sums
  float* fin = part + 2 * cp;               // (5, cp)
  float* gmean = fin + 5 * cp;              // (2, cp / cpg)
  float* prm = gmean + 2 * cp;              // (6, cp): the part's mean, rstd, gamma, beta,
                                            // scale, shift per channel

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int c0 = (blockIdx.x / cs) * cp;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int cols = cp / 8;
  const int rpi = kClusterThreads / cols;
  const int col = t % cols;
  const int row = t / cols;
  const bool active = row < rpi;
  const int cpg = c / groups;
  const int rows = (hw + cs - 1) / cs;
  const int r0 = static_cast<int>(rank) * rows;
  const int r1 = min(hw, r0 + rows);
  const int ch0 = c0 + col * 8;  // this thread's first channel
  const uint32_t key = hash_key(seed);

  // phase 1
  float sdz[8], sdzx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sdz[i] = sdzx[i] = 0.f;
  const size_t base = static_cast<size_t>(b) * hw * c + ch0;
  // Every load of the block is in flight at once: cp.async copies x into
  // its slot and g into the dz slot of the same iteration (dz overwrites
  // it), in two commit groups, so the first half computes while the second
  // half lands. A thread reads back only the slots it filled.
  constexpr int kVecs = sizeof(T) / 2;  // 16-byte pieces of 8 elements
  const int half = (iters + 1) / 2;
  for (int it = 0; it < iters; ++it) {
    if (it == half) cp_async_commit();
    const int px = r0 + it * rpi + row;
    if (active && px < r1) {
      const char* xp = reinterpret_cast<const char*>(x + base + static_cast<size_t>(px) * c);
      const char* gp = reinterpret_cast<const char*>(g + base + static_cast<size_t>(px) * c);
      char* xs = reinterpret_cast<char*>(&s_x[it * kClusterThreads + t]);
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        cp_async16(xs + 16 * v, xp + 16 * v);
        // bf16: the second dz plane; f32: both planes
        cp_async16(&s_dz[(2 * static_cast<size_t>(it) + 2 - kVecs + v) * kClusterThreads + t],
                   gp + 16 * v);
      }
    }
  }
  cp_async_commit();
  // the part's per-channel parameters, while the slab lands; then a, b of
  // this thread's channels (the coefficient pass)
  for (int j = t; j < cp; j += kClusterThreads) {
    const int ch = c0 + j;
    const int gi = b * groups + ch / cpg;
    prm[j] = mean[gi];
    prm[cp + j] = rstd[gi];
    prm[2 * cp + j] = gamma[ch];
    prm[3 * cp + j] = beta[ch];
    prm[4 * cp + j] = scale[b * c + ch];
    prm[5 * cp + j] = shift[b * c + ch];
  }
  __syncthreads();
  float a[8], bb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = col * 8 + i;
    a[i] = bb[i] = 0.f;
    if (active) {
      chain_coef(prm[j], prm[cp + j], prm[2 * cp + j], prm[3 * cp + j], prm[4 * cp + j],
                 prm[5 * cp + j], &a[i], &bb[i]);
    }
  }
  for (int it = 0; it < iters; ++it) {
    if (it == 0) {
      if (half < iters) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else if (it == half) {
      cp_async_wait<0>();
    }
    const int px = r0 + it * rpi + row;
    if (active && px < r1) {
      float4* d0 = &s_dz[2 * static_cast<size_t>(it) * kClusterThreads + t];
      float4* d1 = d0 + kClusterThreads;
      Raw8<T> gr;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        gr.v[v] = reinterpret_cast<const uint4*>(d1 - (kVecs - 1 - v) * kClusterThreads)[0];
      }
      float xv[8], gv[8], dz[8];
      unpack(s_x[it * kClusterThreads + t], xv);
      unpack(gr, gv);
      const uint32_t e0 = static_cast<uint32_t>(px) * static_cast<uint32_t>(c) + ch0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dz[i] = chain_dz(xv[i], gv[i], a[i], bb[i], silu, drop, e0 + i, key,
                         static_cast<uint32_t>(b), p, drop_scale);
        sdz[i] += dz[i];
        sdzx[i] += __fmul_rn(dz[i], xv[i]);
      }
      *d0 = make_float4(dz[0], dz[1], dz[2], dz[3]);
      *d1 = make_float4(dz[4], dz[5], dz[6], dz[7]);
    }
  }
  // the block's per-channel sums over its rows (Sdz, then Sdzx): each
  // channel's rpi row values in nseg segments of rps rows, then the
  // segments, all in row order
  const int nseg = cp >= kClusterThreads ? 1 : kClusterThreads / cp;
  const int rps = (rpi + nseg - 1) / nseg;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[i * kRedStride + t] = which == 0 ? sdz[i] : sdzx[i];
    __syncthreads();
    for (int u = t; u < nseg * cp; u += kClusterThreads) {
      const int j = u % cp;
      const int sg = u / cp;
      const float* rj = red + (j % 8) * kRedStride + j / 8;
      float s = 0.f;
      for (int r = sg * rps; r < min(rpi, (sg + 1) * rps); ++r) s += rj[r * cols];
      seg[u] = s;
    }
    __syncthreads();
    for (int j = t; j < cp; j += kClusterThreads) {
      float s = 0.f;
      for (int sg = 0; sg < nseg; ++sg) s += seg[sg * cp + j];
      part[which * cp + j] = s;
    }
    __syncthreads();
  }
  cluster.sync();

  // the part's totals, from every block of the cluster in rank order, and
  // the finalize (gn_bwd_finalize_kernel's arithmetic)
  const float n = static_cast<float>(static_cast<double>(hw) * cpg);
  const size_t bc = static_cast<size_t>(batch) * c;
  for (int j = t; j < cp; j += kClusterThreads) {
    float rdz[kMaxCluster], rdzx[kMaxCluster];  // all loads in flight, then summed in order
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
        const float* rp = cluster.map_shared_rank(part, r);
        rdz[r] = rp[j];
        rdzx[r] = rp[cp + j];
      }
    }
    float s_dz = 0.f, s_dzx = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
        s_dz += rdz[r];
        s_dzx += rdzx[r];
      }
    }
    const int i = b * c + c0 + j;
    const float mc = prm[j], rc = prm[cp + j], gam = prm[2 * cp + j];
    const float pp = __fmul_rn(rc, gam);
    const float qq = __fsub_rn(prm[3 * cp + j], __fmul_rn(mc, pp));
    const float sc1 = __fadd_rn(prm[4 * cp + j], 1.f);
    const float du_s = __fmul_rn(s_dz, sc1);
    const float dux_hat = __fmul_rn(__fmul_rn(__fsub_rn(s_dzx, __fmul_rn(mc, s_dz)), rc), sc1);
    if (rank == 0) {
      dshift[i] = s_dz;
      dscale[i] = __fadd_rn(__fmul_rn(s_dzx, pp), __fmul_rn(s_dz, qq));
      terms[i] = dux_hat;
      terms[bc + i] = du_s;
    }
    fin[j] = __fmul_rn(du_s, gam);
    fin[cp + j] = __fmul_rn(dux_hat, gam);
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();
  const int ng = cp / cpg;
  for (int gg = t; gg < ng; gg += kClusterThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < cpg; ++i) {
      s1 += fin[gg * cpg + i];
      s2 += fin[cp + gg * cpg + i];
    }
    gmean[gg] = __fdiv_rn(s1, n);
    gmean[ng + gg] = __fdiv_rn(s2, n);
  }
  __syncthreads();
  for (int j = t; j < cp; j += kClusterThreads) {
    const int gg = j / cpg;
    const float mc = prm[j], rc = prm[cp + j];
    const float sc1 = __fadd_rn(prm[4 * cp + j], 1.f);
    const float m1 = gmean[gg], m2 = gmean[ng + gg];
    fin[2 * cp + j] = __fmul_rn(__fmul_rn(rc, prm[2 * cp + j]), sc1);
    fin[3 * cp + j] = __fmul_rn(-__fmul_rn(rc, rc), m2);
    fin[4 * cp + j] = __fmul_rn(rc, __fsub_rn(__fmul_rn(__fmul_rn(mc, rc), m2), m1));
  }
  __syncthreads();

  // phase 2
  if (active) {
    float c1[8], c2[8], c3[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c1[i] = fin[2 * cp + col * 8 + i];
      c2[i] = fin[3 * cp + col * 8 + i];
      c3[i] = fin[4 * cp + col * 8 + i];
    }
    for (int it = 0; it < iters; ++it) {
      const int px = r0 + it * rpi + row;
      if (px >= r1) break;
      float xv[8];
      unpack(s_x[it * kClusterThreads + t], xv);
      const float4 d0 = s_dz[2 * static_cast<size_t>(it) * kClusterThreads + t];
      const float4 d1 = s_dz[(2 * static_cast<size_t>(it) + 1) * kClusterThreads + t];
      const float dz[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xv[i] = __fadd_rn(__fadd_rn(__fmul_rn(dz[i], c1[i]), __fmul_rn(xv[i], c2[i])), c3[i]);
      }
      storev(dx + base + static_cast<size_t>(px) * c, xv);
    }
  }

  // the batch sum of dgamma/dbeta, by the last cluster to write its terms
  if (rank == 0) {
    __shared__ bool last;
    __threadfence();  // this block's terms, before its arrival is counted
    __syncthreads();
    if (t == 0) {
      const unsigned total = gridDim.y * (gridDim.x / cs);
      last = atomicAdd(arrived, 1u) == total - 1;
    }
    __syncthreads();
    if (last) {
      // each channel's B terms in bseg segments of consecutive batch
      // elements, then the segments, in order
      __threadfence();
      const int bseg = c >= kClusterThreads ? 1 : min(batch, kClusterThreads / c);
      const int bps = (batch + bseg - 1) / bseg;
      for (int u = t; u < bseg * c; u += kClusterThreads) {
        const int ch = u % c;
        const int sg = u / c;
        float dg = 0.f, db = 0.f;
        const int b1 = min(batch, (sg + 1) * bps);
#pragma unroll 8
        for (int bi = sg * bps; bi < b1; ++bi) {
          dg += __ldcg(terms + static_cast<size_t>(bi) * c + ch);
          db += __ldcg(terms + bc + static_cast<size_t>(bi) * c + ch);
        }
        if (bseg == 1) {
          dgamma[ch] = dg;
          dbeta[ch] = db;
        } else {
          red[u] = dg;
          red[kClusterThreads + u] = db;
        }
      }
      if (bseg > 1) {
        __syncthreads();
        for (int ch = t; ch < c; ch += kClusterThreads) {
          float dg = 0.f, db = 0.f;
          for (int sg = 0; sg < bseg; ++sg) {
            dg += red[sg * c + ch];
            db += red[kClusterThreads + sg * c + ch];
          }
          dgamma[ch] = dg;
          dbeta[ch] = db;
        }
      }
    }
  }
  cluster_wait();  // no block leaves while another may still read its sums
}

template <typename T>
cudaError_t launch_bwd_cluster(const Args& a, void* dx, float* dgamma, float* dbeta,
                               float* dscale, float* dshift, int cp, int cs, int iters,
                               cudaStream_t s) {
  const size_t smem = cluster_smem_bytes(cp, iters, sizeof(T));
  auto kernel = gn_bwd_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* terms = a.work;
  unsigned int* arrived =
      reinterpret_cast<unsigned int*>(a.work + 2 * static_cast<size_t>(a.batch) * a.c);
  err = cudaMemsetAsync(arrived, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.c / cp * cs), static_cast<unsigned>(a.batch));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.x), static_cast<const T*>(a.g),
                           static_cast<const float*>(a.mean), static_cast<const float*>(a.rstd),
                           a.gamma, a.beta, a.scale, a.shift, a.seed, static_cast<T*>(dx), dgamma,
                           dbeta, dscale, dshift, terms, arrived, a.batch, a.hw, a.c, a.groups,
                           cp, cs, iters, a.silu, a.drop, a.p, a.drop_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The most clusters of the route's shape the card holds at once (0: none).
template <typename T>
cudaError_t cluster_occupancy(int c, int cp, int cs, int iters, int* count) {
  const size_t smem = cluster_smem_bytes(cp, iters, sizeof(T));
  auto kernel = gn_bwd_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(c / cp * cs), 1);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

// The plan's constraints (the wrapper's bwd_plan meets them; a launch that
// does not is refused).
bool cluster_plan_valid(int hw, int c, int groups, int cp, int cs, int iters, int xsize) {
  if (c % 8 != 0 || cp < 8 || cp % 8 != 0 || c % cp != 0 || cp % (c / groups) != 0) return false;
  if (cp / 8 > kClusterThreads || cs < 1 || cs > kMaxCluster || iters < 1) return false;
  const long long rows = (hw + cs - 1) / cs;
  if (static_cast<long long>(iters) * (kClusterThreads / (cp / 8)) < rows) return false;
  return cluster_smem_bytes(cp, iters, xsize) <= 232448;  // 227 KB, a block's most
}

bool valid(int batch, int hw, int c, int groups) {
  // the finalize kernels' shared memory (2C + 2G floats) must fit in 48 KB
  return batch >= 1 && batch <= 65535 && hw >= 1 && c >= 1 && groups >= 1 && c % groups == 0 &&
         static_cast<long long>(hw) * c < (1LL << 32) && 2LL * c + 2LL * groups <= 12288;
}

}  // namespace
}  // namespace probunet

extern "C" {

// Pixel tiles per batch element of the reduce passes: the work buffer of
// fused_gn_fwd / fused_gn_bwd holds 7*B*C + 2*B*ntiles*C floats.
int fused_gn_tiles(int hw, int c) { return probunet::tiling(hw, c).ntiles; }

// x, y: (B, HW, C) contiguous, f32 (is_bf16 = 0) or bf16; gamma, beta (C,),
// scale, shift (B, C), f32; seed (2,) int32 (read only when p > 0);
// mean, rstd (B, G) f32 out; work: scratch (see fused_gn_tiles).
// drop_scale = f32(1 / (1 - p)). Returns cudaGetLastError().
int fused_gn_fwd(const void* x, const void* gamma, const void* beta, const void* scale,
                 const void* shift, const void* seed, void* y, void* mean, void* rstd,
                 void* work, int batch, int hw, int c, int groups, float eps, float p,
                 float drop_scale, int silu, int is_bf16, void* stream) {
  if (!probunet::valid(batch, hw, c, groups)) return static_cast<int>(cudaErrorInvalidValue);
  const probunet::Args a{x, nullptr, static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), static_cast<const float*>(scale),
                         static_cast<const float*>(shift), static_cast<const int*>(seed),
                         static_cast<float*>(mean), static_cast<float*>(rstd),
                         static_cast<float*>(work), batch, hw, c, groups, silu, p > 0.f ? 1 : 0,
                         eps, p, drop_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v8 = probunet::vec_width(c) == 8;
  cudaError_t err;
  if (is_bf16) {
    err = v8 ? probunet::launch_fwd<__nv_bfloat16, 8>(a, y, s)
             : probunet::launch_fwd<__nv_bfloat16, 1>(a, y, s);
  } else {
    err = v8 ? probunet::launch_fwd<float, 8>(a, y, s) : probunet::launch_fwd<float, 1>(a, y, s);
  }
  return static_cast<int>(err);
}

// x, g, dx: (B, HW, C) as x of fused_gn_fwd; gamma, beta, scale, shift,
// seed as there; mean, rstd (B, G) from the forward; dgamma, dbeta (C,) and
// dscale, dshift (B, C) f32 out. The plan (ops/kernels/fused_gn.py:
// bwd_plan): route 1 is one cluster of `cluster` blocks per (batch element,
// channel part of part_channels channels), `iters` row iterations a
// thread, work (2*B*C + 1) floats; route 0 the two-pass launches, work as
// for the forward (part_channels, cluster, iters unused).
int fused_gn_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                 const void* scale, const void* shift, const void* seed, const void* mean,
                 const void* rstd, void* dx, void* dgamma, void* dbeta, void* dscale,
                 void* dshift, void* work, int batch, int hw, int c, int groups, float p,
                 float drop_scale, int silu, int is_bf16, int route, int part_channels,
                 int cluster, int iters, void* stream) {
  if (!probunet::valid(batch, hw, c, groups)) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && !probunet::cluster_plan_valid(hw, c, groups, part_channels, cluster, iters,
                                                  is_bf16 ? 2 : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const probunet::Args a{x, g, static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), static_cast<const float*>(scale),
                         static_cast<const float*>(shift), static_cast<const int*>(seed),
                         const_cast<float*>(static_cast<const float*>(mean)),
                         const_cast<float*>(static_cast<const float*>(rstd)),
                         static_cast<float*>(work), batch, hw, c, groups, silu, p > 0.f ? 1 : 0,
                         0.f, p, drop_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* dsc = static_cast<float*>(dscale);
  float* dsh = static_cast<float*>(dshift);
  cudaError_t err;
  if (route == 1) {
    err = is_bf16 ? probunet::launch_bwd_cluster<__nv_bfloat16>(a, dx, dg, db, dsc, dsh,
                                                                part_channels, cluster, iters, s)
                  : probunet::launch_bwd_cluster<float>(a, dx, dg, db, dsc, dsh, part_channels,
                                                        cluster, iters, s);
    return static_cast<int>(err);
  }
  const bool v8 = probunet::vec_width(c) == 8;
  if (is_bf16) {
    err = v8 ? probunet::launch_bwd<__nv_bfloat16, 8>(a, dx, dg, db, dsc, dsh, s)
             : probunet::launch_bwd<__nv_bfloat16, 1>(a, dx, dg, db, dsc, dsh, s);
  } else {
    err = v8 ? probunet::launch_bwd<float, 8>(a, dx, dg, db, dsc, dsh, s)
             : probunet::launch_bwd<float, 1>(a, dx, dg, db, dsc, dsh, s);
  }
  return static_cast<int>(err);
}

// The most clusters of a cluster-route plan the current device holds at
// once, written to *count (an int). Returns a cudaError_t.
int fused_gn_bwd_cluster_occupancy(int c, int part_channels, int cluster, int iters,
                                   int is_bf16, void* count) {
  int* out = static_cast<int*>(count);
  const cudaError_t err =
      is_bf16 ? probunet::cluster_occupancy<__nv_bfloat16>(c, part_channels, cluster, iters, out)
              : probunet::cluster_occupancy<float>(c, part_channels, cluster, iters, out);
  return static_cast<int>(err);
}

}  // extern "C"
