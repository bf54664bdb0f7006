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
// x: (items, H, W, C) f32 and out: (items, H/k, W/k, C) f32, row-major. The
// k input rows of output row g = n * H/k + a are one contiguous run of
// k * W * C floats, and window row i of output column b is k * C contiguous
// floats of it.
//
// Bound: the bytes, x read once and out written once; at the main path's
// pooling (128, 128, 128, 3) f32, k = 16, 25.2 MB, 7.5 us at 3.35 TB/s. The
// order fixes only the sequence of one output's additions: rows stream, and
// the chains of different outputs interleave. Three routes, chosen per shape
// by ops/kernels/avg_pool.py:plan before the launch:
//
// - "ring" (C < 32, x and its window rows on 16 bytes): a block owns tiles
//   of R output rows x TB output columns (all C channels), one thread a
//   chain (output element), and walks its tiles in a persistent loop. The
//   tile's window rows stream through a ring of 2 or 3 slots in shared
//   memory, one window row of each of the tile's R rows a slot, filled by
//   16-byte cp.async: window row i is added while rows i+1 and i+2 land.
//   Each column's k*C floats sit at a padded stride, chosen by the plan so
//   that a warp's reads do not conflict. k = 16 and 8 (the presets' factors)
//   are template instances whose k loads run ahead of the k adds.
// - "direct" ((k, C) = (8, 1), the 64x64 presets, x on 16 bytes): a thread
//   owns one output column and reads each window row's 8 floats straight
//   from device memory as two float4s, the next row's in flight while this
//   one adds. A column's window row is 32 bytes there, and the ring's slots
//   would wait one after another.
// - "channels" (everything else: C >= 32, x or its rows off 16 bytes, or a
//   window row the ring cannot hold): a thread owns one output element; a
//   warp's 32 channels make its loads coalesce without staging. It takes
//   every shape.

#include <cuda_runtime.h>

namespace probunet {
namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 3;
constexpr int kSmemLimit = 232448;   // 227 KB a block (opt-in above 48 KB)

struct PoolArgs {
  const float* x;
  float* out;
  long long rows;    // output rows: items * (h / k)
  long long tiles;   // "ring": (rows / r) * (wo / tb)
  int k, c, w, wo;
  int r, tb;         // "ring": output rows and columns of a tile
  int cs, rs;        // "ring": floats between two columns' / two rows' window rows in a slot
  int stages;        // "ring": slots of the ring, 2 or 3
  float inv_area;
};

// One 16-byte copy from device to shared memory, both 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Route "ring". K: the instance's k (0: any k).
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
window_mean_ring_kernel(const PoolArgs a) {
  extern __shared__ __align__(16) float ring[];
  const int k = K ? K : a.k;
  const int c = a.c;
  const int kc = k * c;
  const long long row_len = static_cast<long long>(a.w) * c;   // floats of an input row
  const int seg = a.tb * kc;                 // floats of a tile row's window row
  const int slot_floats = a.r * a.rs;
  const int nvec = a.r * seg / 4;            // 16-byte copies a slot
  const int nthreads = blockDim.x;
  const int t = threadIdx.x;
  const int tpr = a.wo / a.tb;               // tiles across an output row
  // this thread's chain: output row rr, element o = bb * c + ch of the tile
  const int row_chains = a.tb * c;
  const bool active = t < a.r * row_chains;
  const int rr = t / row_chains;
  const int o = t - rr * row_chains;
  const int bb = o / c;
  const int read_off = rr * a.rs + bb * a.cs + (o - bb * c);
  const long long my_tiles =
      blockIdx.x < a.tiles ? (a.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  // The copies this thread makes into every slot: the source offset from the
  // slot's first input float and the offset in the slot. A thread makes at
  // most K / 4 of them (the plan gives a block a thread a chain).
  constexpr int kCopies = K ? K / 4 : 1;
  long long src_off[kCopies];
  int dst_off[kCopies];
  if constexpr (K != 0) {
#pragma unroll
    for (int n = 0; n < kCopies; ++n) {
      const int v = t + n * nthreads;
      src_off[n] = -1;
      dst_off[n] = 0;
      if (v < nvec) {
        const int e = v * 4;
        const int r = e / seg;
        const int q = e - r * seg;
        const int b = q / kc;
        src_off[n] = r * k * row_len + q;
        dst_off[n] = r * a.rs + b * a.cs + (q - b * kc);
      }
    }
  }

  // the producer's position: the tile and window row of the next slot filled
  long long p_tile = blockIdx.x;
  long long p_left = my_tiles * k;           // slots still to fill
  int p_row = 0;
  int p_slot = 0;
  auto fill_next = [&]() {
    if (p_left > 0) {
      const long long g0 = (p_tile / tpr) * a.r;
      const int b0 = static_cast<int>(p_tile % tpr) * a.tb;
      const float* src = a.x + (g0 * k + p_row) * row_len + static_cast<long long>(b0) * kc;
      float* dst = ring + p_slot * slot_floats;
      if constexpr (K != 0) {
#pragma unroll
        for (int n = 0; n < kCopies; ++n)
          if (src_off[n] >= 0) cp_async16(dst + dst_off[n], src + src_off[n]);
      } else {
        for (int v = t; v < nvec; v += nthreads) {
          const int e = v * 4;
          const int r = e / seg;
          const int q = e - r * seg;
          const int b = q / kc;
          cp_async16(dst + r * a.rs + b * a.cs + (q - b * kc),
                     src + r * static_cast<long long>(k) * row_len + q);
        }
      }
      --p_left;
      if (++p_row == k) {
        p_row = 0;
        p_tile += gridDim.x;
      }
      if (++p_slot == a.stages) p_slot = 0;
    }
    cp_async_commit();   // an empty group past the end keeps the count uniform
  };

  for (int s = 0; s + 1 < a.stages; ++s) fill_next();
  int slot = 0;
  long long tile = blockIdx.x;
  for (long long n = 0; n < my_tiles; ++n, tile += gridDim.x) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i) {
      // stage (n, i) has landed once at most stages - 2 groups are pending
      if (a.stages == 3) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // every thread is done with the slot read at the previous stage: refill it
      fill_next();
      if (active) {
        const float* q = ring + slot * slot_floats + read_off;
        if constexpr (K != 0) {
          float v[K];
#pragma unroll
          for (int j = 0; j < K; ++j) v[j] = q[j * c];
#pragma unroll
          for (int j = 0; j < K; ++j) acc = __fadd_rn(acc, v[j]);
        } else {
          for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, q[j * c]);
        }
      }
      if (++slot == a.stages) slot = 0;
    }
    if (active) {
      const long long g0 = (tile / tpr) * a.r;
      const int b0 = static_cast<int>(tile % tpr) * a.tb;
      a.out[((g0 + rr) * a.wo + b0) * c + o] = __fmul_rn(acc, a.inv_area);
    }
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Route "direct": a thread an output column, its C chains in registers
// (instanced for (K, C) = (8, 1)).
template <int K, int C>
__global__ void __launch_bounds__(kMaxThreads)
window_mean_direct_kernel(const PoolArgs a) {
  constexpr int kVecs = K * C / 4;            // float4s of a column's window row
  static_assert(K * C % 4 == 0, "a column's window row must be whole float4s");
  const long long row4 = static_cast<long long>(a.w) * C / 4;   // float4s of an input row
  const long long cols = a.rows * a.wo;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; n < cols;
       n += step) {
    const long long g = n / a.wo;
    const long long b = n - g * a.wo;
    const float4* p = reinterpret_cast<const float4*>(a.x) + g * K * row4 + b * kVecs;
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
    float4 cur[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) cur[v] = __ldg(p + v);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float4 nxt[kVecs];
      if (i + 1 < K) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) nxt[v] = __ldg(p + (i + 1) * row4 + v);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const int e = j * C + ch;
          acc[ch] = __fadd_rn(acc[ch], lane(cur[e / 4], e % 4));
        }
      }
      if (i + 1 < K) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) cur[v] = nxt[v];
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) a.out[n * C + ch] = __fmul_rn(acc[ch], a.inv_area);
  }
}

// Route "channels": a thread an output element, channels fastest.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
window_mean_channels_kernel(const PoolArgs a) {
  const int k = K ? K : a.k;
  const int c = a.c;
  const long long row_len = static_cast<long long>(a.w) * c;
  const long long total = a.rows * a.wo * c;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; n < total;
       n += step) {
    const long long col = n / c;
    const int ch = static_cast<int>(n - col * c);
    const long long g = col / a.wo;
    const long long b = col - g * a.wo;
    const float* p = a.x + g * k * row_len + b * k * c + ch;
    float acc = 0.f;
    for (int i = 0; i < k; ++i, p += row_len) {
      if constexpr (K != 0) {
        float v[K];
#pragma unroll
        for (int j = 0; j < K; ++j) v[j] = __ldg(p + static_cast<long long>(j) * c);
#pragma unroll
        for (int j = 0; j < K; ++j) acc = __fadd_rn(acc, v[j]);
      } else {
        for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, __ldg(p + static_cast<long long>(j) * c));
      }
    }
    a.out[n] = __fmul_rn(acc, a.inv_area);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const PoolArgs& a, int threads, int smem, long long grid,
           cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(grid), threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace probunet

extern "C" {

// x: (items, h, w, c) f32 row-major; out: (items, h/k, w/k, c) f32 row-major,
// written. inv_area: f32(1 / k^2). The launch plan (route 0 "ring", 1
// "direct", 2 "channels"; the instance's k, 16, 8 or 0 for any; "ring"'s
// tile of r output rows x tb columns, slot strides cs and rs, stages;
// threads, dynamic shared memory in bytes and blocks) is
// ops/kernels/avg_pool.py:plan's. One launch; cudaErrorInvalidValue for a
// shape or plan G does not take.
int window_mean_f32(const void* x, void* out, long long items, int h, int w, int c, int k,
                    float inv_area, int route, int k_inst, int r, int tb, int cs, int rs,
                    int stages, int threads, int smem, long long grid, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (items <= 0 || c <= 0 || k < 1 || h < k || w < k || h % k || w % k) return bad;
  if (k_inst != 0 && k_inst != k) return bad;
  if (threads < 32 || threads > probunet::kMaxThreads || threads % 32 || grid < 1 ||
      grid > 0x7fffffffLL || smem < 0 || smem > probunet::kSmemLimit)
    return bad;
  const bool aligned = reinterpret_cast<unsigned long long>(x) % 16 == 0;
  probunet::PoolArgs a{};
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.k = k;
  a.c = c;
  a.w = w;
  a.wo = w / k;
  a.rows = items * (h / k);
  a.inv_area = inv_area;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const long long kc = static_cast<long long>(k) * c;
    if (!aligned || (static_cast<long long>(w) * c) % 4 || kc % 4 || r < 1 || tb < 1 ||
        a.rows % r || a.wo % tb || (r > 1 && tb != a.wo) || cs < kc || cs % 4 ||
        rs < tb * static_cast<long long>(cs) || rs % 4 || stages < 2 ||
        stages > probunet::kMaxStages || static_cast<long long>(r) * tb * c > threads ||
        static_cast<long long>(stages) * r * rs * 4 != smem)
      return bad;
    a.r = r;
    a.tb = tb;
    a.cs = cs;
    a.rs = rs;
    a.stages = stages;
    a.tiles = (a.rows / r) * (a.wo / tb);
    switch (k_inst) {
      case 16:
        return probunet::launch(probunet::window_mean_ring_kernel<16>, a, threads, smem, grid,
                                st);
      case 8:
        return probunet::launch(probunet::window_mean_ring_kernel<8>, a, threads, smem, grid,
                                st);
      default:
        return probunet::launch(probunet::window_mean_ring_kernel<0>, a, threads, smem, grid,
                                st);
    }
  }
  if (route == 1) {
    if (!aligned || w % 4 || k != 8 || c != 1 || k_inst != 8 || smem != 0) return bad;
    return probunet::launch(probunet::window_mean_direct_kernel<8, 1>, a, threads, 0, grid, st);
  }
  if (route == 2 && smem == 0) {
    switch (k_inst) {
      case 16:
        return probunet::launch(probunet::window_mean_channels_kernel<16>, a, threads, 0, grid,
                                st);
      case 8:
        return probunet::launch(probunet::window_mean_channels_kernel<8>, a, threads, 0, grid,
                                st);
      default:
        return probunet::launch(probunet::window_mean_channels_kernel<0>, a, threads, 0, grid,
                                st);
    }
  }
  return bad;
}

}  // extern "C"
