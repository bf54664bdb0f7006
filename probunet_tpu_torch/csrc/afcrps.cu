// Ensemble CRPS terms of a materialized ensemble x (B, M, P) and target
// y (B, P): forward (kernel B) and analytic backward (kernel B').
//
//   t1(b) = sum_{j, p}   |x_bjp - y_bp|
//   t2(b) = sum_{j<k, p} |x_bjp - x_bkp|
//
//   dx_j = g1 * sign(x_j - y) + g2 * sum_{k != j} sign(x_j - x_k)
//   dy   = -g1 * sum_j sign(x_j - y)
//
// B replaces the TPU kernel probunet_tpu/ops/pallas/afcrps.py:_terms_fwd_impl
// (pallas_call of _fwd_kernel), B' _terms_bwd_impl (pallas_call of
// _bwd_kernel).
//
// Bound: HBM bytes. B reads x and y once, B' reads them and writes dx and
// dy once: at f32, B=128, M=15, P=49152 that is 402 MB (0.1202 ms at 3.35
// TB/s) and 805 MB (0.2404 ms). The arithmetic is M(M+1)/2 differences a
// pixel, far below the card's ridge.
//
// The first design held a thread's M members in a column of a shared-memory
// slab and read every pair from it (B' every ordered pair, each unordered
// pair twice), so the pair loop's shared-memory loads and sign work sat on
// top of the bytes. It also took a contiguous ensemble only, which cost the
// unfused route a copy of Fcomb's member-major output. This design:
//
// - Members in registers. A thread loads 16 bytes of each member (4 f32 or
//   8 bf16 pixels, neighbouring threads on neighbouring addresses) and keeps
//   them packed in registers. The kernels are templated on a member
//   capacity MC (8, 16, 32): every loop over members is unrolled and guarded
//   by the run-time M at the row level only, so each member and sign count
//   has a static register and the pair loop does no memory access.
// - Each unordered pair once. B' takes s = sign(x_j - x_k) from two
//   compares (set.lt - set.gt: the sign of a difference of two values of
//   the input type is the order of the values) and adds s to count_j, -s to
//   count_k. The counts are integers, so their order of addition changes
//   nothing and dx = g1*s0 + g2*count rounds at the plain version's two
//   places (__fmul_rn/__fadd_rn, no FMA contraction): dx equals it bit for
//   bit. dx overwrites the member's register as soon as its pixel is done
//   and leaves as one 16-byte store a member.
// - B takes t1 and t2 from the same registers (a bf16 difference rounded to
//   bf16 before abs, as the TPU kernel does; every sum f32) and reduces
//   both in one block pass to fixed-order per-(batch, tile) partials, which
//   a second kernel adds in a fixed order (common.cuh): bit-reproducible.
// - Strides. x is read, and dx written, at their own batch and member
//   strides (pixel stride 1), so Fcomb's member-major view needs no copy.
//   16-byte accesses need 16-byte aligned rows (pointers, strides and P in
//   multiples of the vector); otherwise, and in the ragged tail of P, the
//   same thread loads its pixels one by one, masked.
// - Any M and B. M above 32 takes one thread a pixel with its members in a
//   shared-memory slab (dynamic shared memory above 48 KB by opt-in), or
//   read from device memory where the slab does not fit a block; there B'
//   evaluates each ordered pair. The grid is one-dimensional over (batch,
//   tile), so B is not bounded by the grid's y and z limits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace probunet {
namespace {

// Threads a block, every kernel but the reduce: at the training shape on an
// H100, f32 B' ran fastest with 256 of 64, 128, 256 and 512.
constexpr int kThreads = 256;
constexpr int kMaxBucket = 32;  // largest member capacity held in registers

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // pixels a thread loads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// |a - b| with the difference in the input type: a bf16 difference is
// rounded to bf16 before abs (a and b are values of the input type).
template <typename T>
__device__ __forceinline__ float abs_diff(float a, float b) {
  if constexpr (sizeof(T) == 2) {
    return fabsf(__bfloat162float(__float2bfloat16_rn(a - b)));
  } else {
    return fabsf(a - b);
  }
}

// sign(a - b) as -1, 0 or 1 (0 where a == b or either is NaN). set.* gives
// -1 where the comparison holds, else 0.
__device__ __forceinline__ int sign_cmp(float a, float b) {
  int gt, lt;
  asm("set.gt.s32.f32 %0, %1, %2;" : "=r"(gt) : "f"(a), "f"(b));
  asm("set.lt.s32.f32 %0, %1, %2;" : "=r"(lt) : "f"(a), "f"(b));
  return lt - gt;
}

// 16 bytes of one row held in registers: kVec<T> pixels, packed. Pixel v is
// word v (f32) or half v % 2 of word v / 2 (bf16); v is static after
// unrolling, so every access is a register.
template <typename T>
__device__ __forceinline__ float lane_get(const uint32_t (&w)[4], int v) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t word = w[v >> 1];
    return __uint_as_float((v & 1) ? (word & 0xffff0000u) : (word << 16));
  } else {
    return __uint_as_float(w[v]);
  }
}

// Stores f, rounded to T, as pixel v.
template <typename T>
__device__ __forceinline__ void lane_put(uint32_t (&w)[4], int v, float f) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(f));
    const uint32_t word = w[v >> 1];
    w[v >> 1] = (v & 1) ? ((word & 0xffffu) | (bits << 16)) : ((word & 0xffff0000u) | bits);
  } else {
    w[v] = __float_as_uint(f);
  }
}

// Pixels [pix, pix + kVec) of row src into w: one 16-byte load where the row
// is aligned and the vector lies inside P, else one load a pixel, zero past P.
template <typename T>
__device__ __forceinline__ void load_vec(uint32_t (&w)[4], const T* src, int pix, int p,
                                         bool aligned) {
  if (aligned && pix + kVec<T> <= p) {
    // bf16 evict-first: faster bf16 B' on an H100, no faster f32
    const uint4* at = reinterpret_cast<const uint4*>(src + pix);
    const uint4 v = sizeof(T) == 2 ? __ldcs(at) : *at;
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
    for (int v = 0; v < kVec<T>; ++v) {
      if (pix + v < p) lane_put<T>(w, v, to_f32(src[pix + v]));
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const uint32_t (&w)[4], int pix, int p,
                                          bool aligned) {
  if (aligned && pix + kVec<T> <= p) {
    // evict-first (nothing reads dx back here): faster bf16 B' on an H100
    __stcs(reinterpret_cast<uint4*>(dst + pix), make_uint4(w[0], w[1], w[2], w[3]));
  } else {
#pragma unroll
    for (int v = 0; v < kVec<T>; ++v) {
      if (pix + v < p) store(dst + pix + v, lane_get<T>(w, v));
    }
  }
}

// (t1, t2) sums of the block in one pass, valid in thread 0; every thread
// of the block must call it.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 red[kThreads / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total.x += red[w].x, total.y += red[w].y;
  }
  return total;
}

// Forward, M <= MC: one block per (batch element, tile of kThreads * kVec
// pixels), flattened onto grid x. Writes partial[0 or 1][b][tile].
template <typename T, int MC>
__global__ void __launch_bounds__(kThreads)
afcrps_tile_kernel(const T* __restrict__ ens, const T* __restrict__ tgt,
                   float* __restrict__ partial, int batch, int m, int p, int ntiles,
                   long long sb, long long sm, int aligned) {
  constexpr int V = kVec<T>;
  const int b = blockIdx.x / ntiles;
  const int tile = blockIdx.x - b * ntiles;
  const int pix = (tile * kThreads + static_cast<int>(threadIdx.x)) * V;
  float v1 = 0.f;
  float v2 = 0.f;
  if (pix < p) {  // pixels past P add nothing
    const T* x = ens + b * sb;
    uint32_t r[MC][4];
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (j >= m) break;
      load_vec<T>(r[j], x + j * sm, pix, p, aligned);
    }
    uint32_t ry[4];
    load_vec<T>(ry, tgt + static_cast<long long>(b) * p, pix, p, aligned);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float y = lane_get<T>(ry, v);
      float s1 = 0.f;
      float s2 = 0.f;
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        if (k >= m) break;
        const float xk = lane_get<T>(r[k], v);
        s1 += abs_diff<T>(xk, y);
#pragma unroll
        for (int j = 0; j < k; ++j) s2 += abs_diff<T>(lane_get<T>(r[j], v), xk);
      }
      v1 += s1;
      v2 += s2;
    }
  }
  const float2 s = block_sum2(v1, v2);
  if (threadIdx.x == 0) {
    partial[static_cast<size_t>(b) * ntiles + tile] = s.x;
    partial[(static_cast<size_t>(batch) + b) * ntiles + tile] = s.y;
  }
}

// Forward, any M: one thread a pixel. `stage`: the block's members go to a
// (M, kThreads) slab of dynamic shared memory first; else they are read
// from device memory (L1) at every use.
template <typename T>
__global__ void __launch_bounds__(kThreads)
afcrps_tile_smem_kernel(const T* __restrict__ ens, const T* __restrict__ tgt,
                        float* __restrict__ partial, int batch, int m, int p, int ntiles,
                        long long sb, long long sm, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const int b = blockIdx.x / ntiles;
  const int tile = blockIdx.x - b * ntiles;
  const int pix = tile * kThreads + static_cast<int>(threadIdx.x);
  float v1 = 0.f;
  float v2 = 0.f;
  if (pix < p) {
    const T* x = ens + b * sb + pix;
    const float y = to_f32(tgt[static_cast<long long>(b) * p + pix]);
    const T* col = stage ? slab : x;
    const long long step = stage ? kThreads : sm;
    for (int j = 0; j < m; ++j) {
      const T xj = x[j * sm];
      if (stage) slab[j * kThreads] = xj;
      v1 += abs_diff<T>(to_f32(xj), y);
    }
    for (int k = 1; k < m; ++k) {  // a sum per row: M(M-1)/2 terms in one f32 drift
      const float xk = to_f32(col[k * step]);
      float row = 0.f;
      for (int j = 0; j < k; ++j) row += abs_diff<T>(to_f32(col[j * step]), xk);
      v2 += row;
    }
  }
  const float2 s = block_sum2(v1, v2);
  if (threadIdx.x == 0) {
    partial[static_cast<size_t>(b) * ntiles + tile] = s.x;
    partial[(static_cast<size_t>(batch) + b) * ntiles + tile] = s.y;
  }
}

// B's fixed-order reduce of the partials (common.cuh), under its own name.
__global__ void __launch_bounds__(kReduceThreads)
afcrps_reduce_kernel(const float* __restrict__ partial, float* __restrict__ t1,
                     float* __restrict__ t2, int batch, int ntiles) {
  reduce_partials_block(partial, t1, t2, batch, ntiles);
}

// Backward, M <= MC: the forward's blocks and registers. Per pixel, the pair
// counts of all members, then dx in place of the members; dy packed beside.
template <typename T, int MC>
__global__ void __launch_bounds__(kThreads)
afcrps_bwd_kernel(const T* __restrict__ ens, const T* __restrict__ tgt,
                  const float* __restrict__ g1, const float* __restrict__ g2,
                  T* __restrict__ dx, T* __restrict__ dy, int m, int p, int ntiles,
                  long long sb, long long sm, long long dsb, long long dsm, int aligned) {
  constexpr int V = kVec<T>;
  const int b = blockIdx.x / ntiles;
  const int tile = blockIdx.x - b * ntiles;
  const int pix = (tile * kThreads + static_cast<int>(threadIdx.x)) * V;
  if (pix >= p) return;  // no block-wide sync below
  const T* x = ens + b * sb;
  uint32_t r[MC][4];
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    if (j >= m) break;
    load_vec<T>(r[j], x + j * sm, pix, p, aligned);
  }
  uint32_t ry[4];
  load_vec<T>(ry, tgt + static_cast<long long>(b) * p, pix, p, aligned);
  const float gb1 = g1[b];
  const float gb2 = g2[b];
  uint32_t rdy[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float xv[MC];
    int count[MC];
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (j >= m) break;
      xv[j] = lane_get<T>(r[j], v);
      count[j] = 0;
    }
#pragma unroll
    for (int k = 1; k < MC; ++k) {
      if (k >= m) break;
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const int s = sign_cmp(xv[j], xv[k]);
        count[j] += s;
        count[k] -= s;
      }
    }
    const float y = lane_get<T>(ry, v);
    int s0_sum = 0;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (j >= m) break;
      const int s0 = sign_cmp(xv[j], y);
      s0_sum += s0;
      lane_put<T>(r[j], v,
                  __fadd_rn(__fmul_rn(gb1, static_cast<float>(s0)),
                            __fmul_rn(gb2, static_cast<float>(count[j]))));
    }
    lane_put<T>(rdy, v, __fmul_rn(-gb1, static_cast<float>(s0_sum)));
  }
  T* d = dx + b * dsb;
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    if (j >= m) break;
    store_vec<T>(d + j * dsm, r[j], pix, p, aligned);
  }
  store_vec<T>(dy + static_cast<long long>(b) * p, rdy, pix, p, aligned);
}

// Backward, any M: one thread a pixel, members staged as f32 in a slab (or
// read from device memory, as the forward), each ordered pair evaluated.
template <typename T>
__global__ void __launch_bounds__(kThreads)
afcrps_bwd_smem_kernel(const T* __restrict__ ens, const T* __restrict__ tgt,
                       const float* __restrict__ g1, const float* __restrict__ g2,
                       T* __restrict__ dx, T* __restrict__ dy, int m, int p, int ntiles,
                       long long sb, long long sm, long long dsb, long long dsm, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slab = reinterpret_cast<float*>(smem_raw) + threadIdx.x;
  const int b = blockIdx.x / ntiles;
  const int tile = blockIdx.x - b * ntiles;
  const int pix = tile * kThreads + static_cast<int>(threadIdx.x);
  if (pix >= p) return;
  const T* x = ens + b * sb + pix;
  const float y = to_f32(tgt[static_cast<long long>(b) * p + pix]);
  if (stage) {
    for (int j = 0; j < m; ++j) slab[j * kThreads] = to_f32(x[j * sm]);
  }
  auto member = [&](int k) { return stage ? slab[k * kThreads] : to_f32(x[k * sm]); };
  const float gb1 = g1[b];
  const float gb2 = g2[b];
  int s0_sum = 0;
  T* d = dx + b * dsb + pix;
  for (int j = 0; j < m; ++j) {
    const float xj = member(j);
    const int s0 = sign_cmp(xj, y);
    s0_sum += s0;
    int count = 0;
    for (int k = 0; k < m; ++k) count += sign_cmp(xj, member(k));
    store(d + j * dsm, __fadd_rn(__fmul_rn(gb1, static_cast<float>(s0)),
                                 __fmul_rn(gb2, static_cast<float>(count))));
  }
  store(dy + static_cast<long long>(b) * p + pix, __fmul_rn(-gb1, static_cast<float>(s0_sum)));
}

template <typename T>
bool rows_aligned(std::initializer_list<const void*> ptrs,
                  std::initializer_list<long long> strides) {
  for (const void* ptr : ptrs) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  }
  for (long long s : strides) {
    if (s % kVec<T> != 0) return false;
  }
  return true;
}

// Shared memory of a slab kernel's block for m members of `elem` bytes, or
// 0 where it exceeds what a block may opt in to (the kernel then reads the
// members from device memory). Opts the kernel in above 48 KB.
template <typename Kernel>
cudaError_t slab_bytes(Kernel kernel, int m, size_t elem, size_t* bytes) {
  *bytes = static_cast<size_t>(m) * kThreads * elem;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return err;
  if (*bytes > static_cast<size_t>(optin)) {
    *bytes = 0;
    return cudaSuccess;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

// Blocks of the one-dimensional grid: batch * ntiles, which must fit grid x.
bool grid_fits(int batch, int ntiles) {
  return static_cast<long long>(batch) * ntiles <= 0x7fffffffLL;
}

template <typename T>
cudaError_t launch_fwd(const void* ens_v, const void* tgt_v, void* partial_v, void* t1, void* t2,
                       int batch, int m, int p, long long sb, long long sm,
                       cudaStream_t stream) {
  const T* ens = static_cast<const T*>(ens_v);
  const T* tgt = static_cast<const T*>(tgt_v);
  float* partial = static_cast<float*>(partial_v);
  int ntiles = 0;
  if (m <= kMaxBucket) {
    constexpr int kPix = kThreads * kVec<T>;
    ntiles = (p + kPix - 1) / kPix;
    if (!grid_fits(batch, ntiles)) return cudaErrorInvalidValue;
    const int aligned = rows_aligned<T>({ens, tgt}, {sb, sm, p});
    const dim3 grid(batch * ntiles);
    if (m <= 8) {
      afcrps_tile_kernel<T, 8><<<grid, kThreads, 0, stream>>>(ens, tgt, partial, batch, m, p,
                                                              ntiles, sb, sm, aligned);
    } else if (m <= 16) {
      afcrps_tile_kernel<T, 16><<<grid, kThreads, 0, stream>>>(ens, tgt, partial, batch, m, p,
                                                               ntiles, sb, sm, aligned);
    } else {
      afcrps_tile_kernel<T, 32><<<grid, kThreads, 0, stream>>>(ens, tgt, partial, batch, m, p,
                                                               ntiles, sb, sm, aligned);
    }
  } else {
    ntiles = (p + kThreads - 1) / kThreads;
    if (!grid_fits(batch, ntiles)) return cudaErrorInvalidValue;
    size_t smem = 0;
    const cudaError_t err = slab_bytes(afcrps_tile_smem_kernel<T>, m, sizeof(T), &smem);
    if (err != cudaSuccess) return err;
    afcrps_tile_smem_kernel<T><<<batch * ntiles, kThreads, smem, stream>>>(
        ens, tgt, partial, batch, m, p, ntiles, sb, sm, smem > 0);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  afcrps_reduce_kernel<<<dim3(batch, 2), kReduceThreads, 0, stream>>>(
      partial, static_cast<float*>(t1), static_cast<float*>(t2), batch, ntiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* ens_v, const void* tgt_v, const void* g1_v,
                       const void* g2_v, void* dx_v, void* dy_v, int batch, int m, int p,
                       long long sb, long long sm, long long dsb, long long dsm,
                       cudaStream_t stream) {
  const T* ens = static_cast<const T*>(ens_v);
  const T* tgt = static_cast<const T*>(tgt_v);
  const float* g1 = static_cast<const float*>(g1_v);
  const float* g2 = static_cast<const float*>(g2_v);
  T* dx = static_cast<T*>(dx_v);
  T* dy = static_cast<T*>(dy_v);
  if (m <= kMaxBucket) {
    constexpr int kPix = kThreads * kVec<T>;
    const int ntiles = (p + kPix - 1) / kPix;
    if (!grid_fits(batch, ntiles)) return cudaErrorInvalidValue;
    const int aligned = rows_aligned<T>({ens, tgt, dx, dy}, {sb, sm, dsb, dsm, p});
    const dim3 grid(batch * ntiles);
    if (m <= 8) {
      afcrps_bwd_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
          ens, tgt, g1, g2, dx, dy, m, p, ntiles, sb, sm, dsb, dsm, aligned);
    } else if (m <= 16) {
      afcrps_bwd_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          ens, tgt, g1, g2, dx, dy, m, p, ntiles, sb, sm, dsb, dsm, aligned);
    } else {
      afcrps_bwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          ens, tgt, g1, g2, dx, dy, m, p, ntiles, sb, sm, dsb, dsm, aligned);
    }
  } else {
    const int ntiles = (p + kThreads - 1) / kThreads;
    if (!grid_fits(batch, ntiles)) return cudaErrorInvalidValue;
    size_t smem = 0;
    const cudaError_t err = slab_bytes(afcrps_bwd_smem_kernel<T>, m, sizeof(float), &smem);
    if (err != cudaSuccess) return err;
    afcrps_bwd_smem_kernel<T><<<batch * ntiles, kThreads, smem, stream>>>(
        ens, tgt, g1, g2, dx, dy, m, p, ntiles, sb, sm, dsb, dsm, smem > 0);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

extern "C" {

// The fewest pixels a block of the forward covers: its partial sums need
// (2, B, ceil(P / afcrps_tile_pixels())) f32 at most.
int afcrps_tile_pixels() { return probunet::kThreads; }

// ens: (B, M, P) at element strides (sb, sm, 1); tgt: (B, P), contiguous;
// both f32 (is_bf16 = 0) or both bf16 (is_bf16 = 1). partial: f32 scratch
// of 2 * B * ceil(P / afcrps_tile_pixels()); t1, t2: (B,) f32. Returns
// cudaGetLastError() after the launches.
int afcrps_terms_fwd(const void* ens, const void* tgt, void* partial, void* t1, void* t2,
                     int batch, int m, int p, long long sb, long long sm, int is_bf16,
                     void* stream) {
  if (m < 1 || batch < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? probunet::launch_fwd<__nv_bfloat16>(ens, tgt, partial, t1, t2, batch, m, p, sb,
                                                    sm, s)
              : probunet::launch_fwd<float>(ens, tgt, partial, t1, t2, batch, m, p, sb, sm, s);
  return static_cast<int>(err);
}

// ens and tgt as for afcrps_terms_fwd; g1, g2: (B,) f32; dx (B, M, P) at
// element strides (dsb, dsm, 1) and dy (B, P) contiguous, in the input
// type. Returns cudaGetLastError().
int afcrps_terms_bwd(const void* ens, const void* tgt, const void* g1, const void* g2,
                     void* dx, void* dy, int batch, int m, int p, long long sb, long long sm,
                     long long dsb, long long dsm, int is_bf16, void* stream) {
  if (m < 1 || batch < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? probunet::launch_bwd<__nv_bfloat16>(ens, tgt, g1, g2, dx, dy, batch, m, p, sb,
                                                    sm, dsb, dsm, s)
              : probunet::launch_bwd<float>(ens, tgt, g1, g2, dx, dy, batch, m, p, sb, sm, dsb,
                                            dsm, s);
  return static_cast<int>(err);
}

}  // extern "C"
