// Kernel E: the int8 serving path's convolution. A k x k convolution (k = 1
// or 3, stride 1, SAME zero padding) of one input, or of two inputs whose
// channels are concatenated without materializing the concat (the U-Net
// decoder's split skip convolutions), int8 x int8 -> int32 on the tensor
// cores, with the quantization of the input and the rescaling of the sums
// fused around the product.
//
// No TPU kernel: the JAX package leaves this convolution to XLA
// (probunet_tpu/ops/quantize.py:63-80, lax.conv_general_dilated of int8
// operands with preferred_element_type=int32). What it computes, at the JAX
// package's rounding points (probunet_tpu/models/layers.py:215-229):
//
//   q(x)       = rint(clamp(x / s_in, -127, 127))       IEEE division, ties to even
//   acc[p, c]  = sum over taps and input channels of q(x) * w_q   (int32, exact)
//   y[p, c]    = f32(acc1) * (s_in1 * s_w1[c])
//              [+ f32(acc2) * (s_in2 * s_w2[c])]         the second input, if any
//              [+ bias[c]]                                then cast to y's type
//
// every product and sum rounded on its own (__fmul_rn/__fadd_rn: nothing is
// contracted to an FMA). The sums are exact in any order, so both routes
// equal the plain version (ops/kernels/int8_conv.py) bit for bit.
//
// Weights (ops/kernels/int8_conv.py:pack_words): quantized per output
// channel (per slice of a split convolution) and packed once as the exact
// shared-memory image of the wgmma B operand: for each block of n_tile
// output channels, each chunk of 32 input channels and each tap, a slab
// [k half (2)][n_tile channels][16 input channels] of int8, zero-padded in
// both channel counts. One slab of all taps is one bulk copy.
//
// Bound: at the flagship's shapes mostly the bytes (x read once, y written
// once); the 128x128x32 -> 32 3x3 convolution at bs=128 in bf16 moves 268 MB
// (0.080 ms at 3.35 TB/s) for 38.7 G int8 operations (0.020 ms at 1,979
// TOPS). Two routes, chosen per shape before the launch
// (ops/kernels/int8_conv.py:plan):
//
// "wgmma" (int8_conv_wgmma_kernel): every convolution whose input rows TMA
// can address (cin * element size a multiple of 16 bytes) and cout % 8 == 0.
// An implicit GEMM (M = output pixels, N = output channels, K = taps x input
// channels), persistent blocks walking 128-pixel output tiles:
// - one producer warp keeps a ring of stages in flight: each stage is one
//   chunk of 32 input channels of a tile's input, the 1-pixel halo included
//   (a 4-D TMA box over NHWC whose out-of-bounds fill is the SAME zero
//   padding; 1x1: a 2-D box of 128 flattened pixels), and that chunk's
//   weight slab of every tap (one cp.async.bulk), both completing on the
//   stage's mbarrier;
// - two consumer warpgroups quantize each staged element once (all 256
//   threads, 16 bytes a thread) into an int8 tile, then each runs one
//   wgmma.mma_async m64nNk32 s8 x s8 -> s32 per tap on its 64 output pixels
//   and all N output channels of the block (N = cout up to 256; a split
//   convolution keeps two accumulators, so N = min(cout, 128) there), the
//   accumulators in registers. The quantization of chunk i + 1 overlaps the
//   wgmmas of chunk i (three int8 buffers; wait_group 1);
// - the epilogue stages each warpgroup's outputs through shared memory and
//   writes 16 bytes a thread, each pixel's channels contiguous.
// A is read from shared memory (the SS form; PTX also admits s8 A from
// registers, as CUTLASS's SM90 S32S8S8_RS_TN atoms do, but a thread's
// fragment rows move by a pixel from tap to tap, so each tap would cost 4
// shared loads a thread all the same). The int8 tile is laid out without
// swizzle: [k half][halo pixel][16 channels], so each pixel's 16 bytes are
// one core-matrix row and tap (ky, kx)'s A operand is the same tile shifted
// by ky * row + kx pixels: a descriptor start any 16-byte multiple allows
// (LBO = the k half's stride, SBO = a halo row's 16 * (tile width + 2)
// bytes). A core matrix is 128 contiguous bytes, so the tensor cores read
// it without bank conflicts; the k halves lie 64 bytes off a multiple of
// 128 apart, so a half-warp's 8-byte quantized stores cover all 32 banks.
// The quantization keeps the IEEE quotient's integer: x * fl(1 / s_in) lies
// within 2^-23 |x / s_in| (1 + 2^-24) of x / s_in, so where that product is
// more than 2^-14 from a half-integer the correctly rounded quotient rounds
// to the same integer (ties included: fl(x / s) cannot be the half-integer
// itself); it is rounded by adding 1.5 * 2^23, no conversion instruction.
// Where any of a thread's 8 (bf16) or 4 (f32) elements lies nearer, or
// beyond +-127.5, all take __fdiv_rn (for random inputs about 1 group in
// 1,000). Three buffers of int8 tiles, ring stages and the epilogue's
// staging fit 227 KB; blocks of up to 64 accumulator columns run two to an
// SM. The wider blocks are held to 168 registers a thread (nine warps over
// four schedulers) and spill some 0.6 KB (-Xptxas -v).
//
// "mma_sync" (int8_conv_kernel, the first design): what TMA cannot address,
// the flagship's cin = 3 and cin = 6 first convolutions. 4 warps, 64 output
// pixels by 32 output channels, mma.sync m16n8k32 s8, the input quantized
// per 32-channel chunk into shared memory (zero outside the image and
// beyond cin), the chunk's weights staged from the packed slabs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace probunet {
namespace {

constexpr int kChunk = 32;             // input channels of a K step: the MMA's depth

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Word j (4 input channels) of chunk `chunk` of output channel co at tap
// `tap` in the packed weight slabs (n_tile channels a block).
__device__ __forceinline__ long long weight_word(int co, int tap, int chunk, int j, int taps,
                                                 int chunks, int n_tile) {
  const int nb = co / n_tile, n = co % n_tile;
  return ((((static_cast<long long>(nb) * chunks + chunk) * taps + tap) * 2 + (j >> 2)) *
              n_tile + n) * 4 + (j & 3);
}

// ---------------------------------------------------------------------------
// Route "mma_sync": the first design, kept for inputs TMA cannot address
// ---------------------------------------------------------------------------

namespace ms {

constexpr int kThreads = 128;          // 4 warps
constexpr int kTileH = 8, kTileW = 8;  // k = 3: output pixels of a block
constexpr int kTileP = kTileH * kTileW;
constexpr int kTileC = 32;             // output channels of a block
constexpr int kWords = kChunk / 4;     // int32 words of a pixel's chunk
constexpr int kStride = 12;            // words between shared-memory rows (8 used)

template <typename T>
struct Input {
  const T* x;          // (n, h, w, cin), row-major
  const uint32_t* w;   // the packed slabs
  const float* s_w;    // (cout,) per-channel weight scales
  float s_in;          // the input's scale
  int cin;
  int chunks;          // ceil(cin / 32)
  int n_tile;          // output channels a slab block
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where the block's output tile lies: k = 3, image `img` rows ty0.., cols
// tx0..; k = 1, flattened pixels p0..p0+63.
struct Tile {
  int img, ty0, tx0;
  long long p0;
};

// Flattened input pixel of shared-memory slot `slot`, or -1 for padding.
template <int KS>
__device__ __forceinline__ long long slot_pixel(const Tile& tile, int slot, int h, int w,
                                                long long npix) {
  if (KS == 3) {
    const int iy = tile.ty0 + slot / (kTileW + 2) - 1;
    const int ix = tile.tx0 + slot % (kTileW + 2) - 1;
    return (iy >= 0 && iy < h && ix >= 0 && ix < w)
               ? (static_cast<long long>(tile.img) * h + iy) * w + ix
               : -1;
  }
  const long long p = tile.p0 + slot;
  return p < npix ? p : -1;
}

// Flattened output pixel of the warp's MMA row `row` (0..15), or -1.
template <int KS>
__device__ __forceinline__ long long row_pixel(const Tile& tile, int warp, int row, int h, int w,
                                               long long npix) {
  if (KS == 3) {
    const int oy = tile.ty0 + 2 * warp + (row >> 3);
    const int ox = tile.tx0 + (row & 7);
    return (oy < h && ox < w) ? (static_cast<long long>(tile.img) * h + oy) * w + ox : -1;
  }
  const long long p = tile.p0 + 16 * warp + row;
  return p < npix ? p : -1;
}

// acc += the product of one input's quantized tile and its weights, over
// every chunk of 32 input channels.
template <typename T, int KS>
__device__ __forceinline__ void accumulate(const Input<T>& in, const Tile& tile, int co0,
                                           int cout, int h, int w, long long npix,
                                           uint32_t* xs, uint32_t* ws, int (&acc)[4][4]) {
  constexpr int kSlots = KS == 3 ? (kTileH + 2) * (kTileW + 2) : kTileP;
  constexpr int kTaps = KS * KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int c0 = 0; c0 < in.cin; c0 += kChunk) {
    // prologue: quantize the tile's input pixels, 4 channels a word; 8
    // neighbouring threads read a pixel's 32 channels
    for (int i = tid; i < kSlots * kWords; i += kThreads) {
      const int slot = i / kWords, j = i % kWords;
      const long long pix = slot_pixel<KS>(tile, slot, h, w, npix);
      uint32_t word = 0;
      if (pix >= 0) {
        const int c = c0 + 4 * j;
        const T* src = in.x + pix * in.cin + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < in.cin) word |= quantize(to_f32(src[e]), in.s_in) << (8 * e);
        }
      }
      xs[slot * kStride + j] = word;
    }
    // the chunk's weights: the block's 32 output channels lie in one slab
    // block (n_tile a multiple of 32), its 16-byte rows read by neighbouring
    // threads
    const uint32_t* wc =
        in.w + weight_word(co0, 0, c0 / kChunk, 0, kTaps, in.chunks, in.n_tile);
    for (int i = tid; i < kTaps * kTileC * kWords; i += kThreads) {
      const int co_l = (i >> 2) % kTileC, kh = (i / (4 * kTileC)) & 1;
      const int tap = i / (kWords * kTileC);
      ws[(tap * kTileC + co_l) * kStride + kh * 4 + (i & 3)] =
          co0 + co_l < cout ? wc[((tap * 2 + kh) * in.n_tile + co_l) * 4 + (i & 3)] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int ky = tap / KS, kx = tap % KS;
      // the slots of MMA rows g and g + 8 at this tap
      const int sa = KS == 3 ? (2 * warp + ky) * (kTileW + 2) + g + kx : 16 * warp + g;
      const int sb = KS == 3 ? sa + (kTileW + 2) : sa + 8;
      const uint32_t a[4] = {xs[sa * kStride + t], xs[sb * kStride + t],
                             xs[sa * kStride + t + 4], xs[sb * kStride + t + 4]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* wr = ws + (tap * kTileC + nt * 8 + g) * kStride;
        mma_s8(acc[nt], a, wr[t], wr[t + 4]);
      }
    }
    __syncthreads();
  }
}

template <typename T, typename TO, int KS>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(Input<T> in1, Input<T> in2, int two, const float* __restrict__ bias,
                 TO* __restrict__ y, int* __restrict__ acc_out, int n, int h, int w, int cout) {
  constexpr int kSlots = KS == 3 ? (kTileH + 2) * (kTileW + 2) : kTileP;
  __shared__ uint32_t xs[kSlots * kStride];
  __shared__ uint32_t ws[KS * KS * kTileC * kStride];
  const long long npix = static_cast<long long>(n) * h * w;
  Tile tile{0, 0, 0, 0};
  if (KS == 3) {
    const int tiles_w = (w + kTileW - 1) / kTileW;
    const int tiles_img = ((h + kTileH - 1) / kTileH) * tiles_w;
    tile.img = blockIdx.x / tiles_img;
    const int r = blockIdx.x % tiles_img;
    tile.ty0 = (r / tiles_w) * kTileH;
    tile.tx0 = (r % tiles_w) * kTileW;
  } else {
    tile.p0 = static_cast<long long>(blockIdx.x) * kTileP;
  }
  const int co0 = blockIdx.y * kTileC;
  int acc1[4][4] = {}, acc2[4][4] = {};
  accumulate<T, KS>(in1, tile, co0, cout, h, w, npix, xs, ws, acc1);
  if (two) accumulate<T, KS>(in2, tile, co0, cout, h, w, npix, xs, ws, acc2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + nt * 8 + 2 * t + (i & 1);
      const long long pix = row_pixel<KS>(tile, warp, i < 2 ? g : g + 8, h, w, npix);
      if (pix < 0 || co >= cout) continue;
      float v = __fmul_rn(__int2float_rn(acc1[nt][i]), __fmul_rn(in1.s_in, in1.s_w[co]));
      if (two) {
        v = __fadd_rn(v, __fmul_rn(__int2float_rn(acc2[nt][i]),
                                   __fmul_rn(in2.s_in, in2.s_w[co])));
      }
      if (bias != nullptr) v = __fadd_rn(v, bias[co]);
      store(y + pix * cout + co, v);
      if (acc_out != nullptr) {
        acc_out[pix * cout + co] = acc1[nt][i];
        if (two) acc_out[(npix + pix) * cout + co] = acc2[nt][i];
      }
    }
  }
}

template <typename T, typename TO, int KS>
cudaError_t launch(const Input<T>& in1, const Input<T>& in2, int two, const float* bias,
                   void* y, int* acc_out, int n, int h, int w, int cout, cudaStream_t stream) {
  long long blocks;
  if (KS == 3) {
    blocks = static_cast<long long>(n) * ((h + kTileH - 1) / kTileH) *
             ((w + kTileW - 1) / kTileW);
  } else {
    blocks = (static_cast<long long>(n) * h * w + kTileP - 1) / kTileP;
  }
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), (cout + kTileC - 1) / kTileC);
  int8_conv_kernel<T, TO, KS><<<grid, kThreads, 0, stream>>>(
      in1, in2, two, bias, static_cast<TO*>(y), acc_out, n, h, w, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Input<T>& in1, const Input<T>& in2, int two, const float* bias,
                     void* y, int* acc_out, int n, int h, int w, int cout, int ksize,
                     int out_bf16, cudaStream_t s) {
  if (ksize == 3) {
    return out_bf16 ? launch<T, __nv_bfloat16, 3>(in1, in2, two, bias, y, acc_out, n, h, w,
                                                  cout, s)
                    : launch<T, float, 3>(in1, in2, two, bias, y, acc_out, n, h, w, cout, s);
  }
  return out_bf16 ? launch<T, __nv_bfloat16, 1>(in1, in2, two, bias, y, acc_out, n, h, w, cout,
                                                s)
                  : launch<T, float, 1>(in1, in2, two, bias, y, acc_out, n, h, w, cout, s);
}

template <typename T>
Input<T> make_input(const void* x, const void* w, const void* s_w, float s_in, int cin,
                    int n_tile) {
  return Input<T>{static_cast<const T*>(x), static_cast<const uint32_t*>(w),
                  static_cast<const float*>(s_w), s_in, cin, (cin + kChunk - 1) / kChunk,
                  n_tile};
}

}  // namespace ms

// ---------------------------------------------------------------------------
// Route "wgmma": TMA ring, quantization once per staged element, s8 wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kRows = 64;                    // output pixels of a warpgroup: a wgmma's M
constexpr int kTilePixels = 2 * kRows;
constexpr int kQBufs = 3;                    // int8 tiles: quantize i + 1 during i's MMAs
constexpr int kEpiRowMax = 160;              // staging row: 128 bytes of a pass + padding
constexpr int kEpiBytes = 2 * kRows * kEpiRowMax;
constexpr float kTieGuard = 6.103515625e-05f;   // 2^-14
constexpr int kMaxSmem = 232448;             // 227 KB, the opt-in limit of a block

struct Params {
  const uint8_t* wq[2];    // packed weight slabs of each input
  const float* s_w[2];     // per-channel weight scales
  float s_in[2];           // the inputs' scales
  int chunks[2];           // ceil(cin / 32) of each input
  const float* bias;       // (cout,) or null
  void* y;                 // (n, h, w, cout)
  int* acc_out;            // (inputs, n, h, w, cout) or null
  long long npix;
  int h, w, cout;
  int taps;                // 1 or 9
  int tile_w;              // k = 3: columns of a tile, 16 or 8; k = 1: 8 flat pixels a row
  int hs;                  // slots a halo row: tile_w + 2, or 8 for k = 1
  int slots;               // halo slots of a tile: (128 / tile_w + 2) * hs, or 128
  int tiles_w, tiles_img;  // k = 3: tiles a row of tiles, tiles an image
  int n_tiles;             // output tiles
  int n_blocks;            // blocks of n_tile output channels
  int in_bf16, out_bf16;
  int stages;
  uint32_t raw_bytes;      // a stage's input box
  uint32_t raw_span;       // raw_bytes rounded up to 128
  uint32_t w_bytes;        // a stage's weight slab: taps * 32 * n_tile
  uint32_t stage_bytes;
  uint32_t q_lbo;          // an int8 tile's k-half stride: 64 bytes off a multiple of 128
  uint32_t q_bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma operand in shared memory, K-major, no swizzle: 8-row core
// matrices of 16-byte rows; LBO between the two 16-byte k halves, SBO
// between 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, s32, the warpgroup's accumulator fragment) += A (64 x 32) B^T
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// rint(clamp(x / s)) as an int8 in the low byte: the IEEE quotient's integer.
__device__ __forceinline__ uint32_t quantize_ieee(float x, float s) {
  return static_cast<uint32_t>(__float2int_rn(fminf(fmaxf(__fdiv_rn(x, s), -127.f), 127.f)));
}

// q[e] = rint(clamp(x[e] / s)) (int8 in the low byte) for N elements, with
// r = fl(1 / s): x * r is clamped to +-127 and rounded to an integer by
// adding 1.5 * 2^23 (round to nearest even), whose low mantissa bits are
// the integer, no conversion instruction; where any element's x * r lies
// within 2^-14 of a half-integer, or beyond +-127.5, or is NaN, all N take
// the IEEE quotient (see the header). r is NaN when 1 / s is not a normal
// float, which sends every element to the quotient.
template <int N>
__device__ __forceinline__ void quantize_n(const float (&x)[N], float s, float r,
                                           uint32_t (&q)[N]) {
  constexpr float kMagic = 12582912.f;   // 1.5 * 2^23
  bool near = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float qa = __fmul_rn(x[e], r);
    const float t = __fadd_rn(fminf(fmaxf(qa, -127.f), 127.f), kMagic);
    q[e] = __float_as_uint(t) - 0x4B400000u;
    near |= !(fabsf(__fsub_rn(qa, __fsub_rn(t, kMagic))) < 0.5f - kTieGuard);
  }
  if (__builtin_expect(near, 0)) {
#pragma unroll
    for (int e = 0; e < N; ++e) q[e] = quantize_ieee(x[e], s);
  }
}

// Four int8 values (the low bytes of q[0..3]) packed into a word.
__device__ __forceinline__ uint32_t pack4(const uint32_t* q) {
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// The staged chunk (raw: slots x 32 channels of T) quantized into the int8
// tile q ([k half][slot][16 channels]) by the 256 consumer threads; bf16: 8
// channels (16 bytes) a thread and step, f32: 4.
__device__ __forceinline__ void quantize_chunk(const uint8_t* raw, uint8_t* q, const Params& p,
                                               float s, float r, int tid) {
  if (p.in_bf16) {
    for (int i = tid; i < p.slots * 4; i += kConsumers) {
      const int slot = i >> 2, oct = i & 3;
      const uint4 v = *reinterpret_cast<const uint4*>(raw + slot * 64 + oct * 16);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      float x[8];
      uint32_t qv[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[2 * e] = __uint_as_float(u[e] << 16);
        x[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
      }
      quantize_n<8>(x, s, r, qv);
      *reinterpret_cast<uint2*>(q + (oct >> 1) * p.q_lbo + slot * 16 + (oct & 1) * 8) =
          make_uint2(pack4(qv), pack4(qv + 4));
    }
  } else {
    for (int i = tid; i < p.slots * 8; i += kConsumers) {
      const int slot = i >> 3, quad = i & 7;
      const float4 v = *reinterpret_cast<const float4*>(raw + slot * 128 + quad * 16);
      const float x[4] = {v.x, v.y, v.z, v.w};
      uint32_t qv[4];
      quantize_n<4>(x, s, r, qv);
      *reinterpret_cast<uint32_t*>(q + (quad >> 2) * p.q_lbo + slot * 16 + (quad & 3) * 4) =
          pack4(qv);
    }
  }
}

struct TileAt {
  int img, y0, x0, nb;
  long long p0;
};

// Work item t: output tile t / n_blocks, channel block t % n_blocks (a
// tile's channel blocks run side by side, so its input is read from memory
// once).
__device__ __forceinline__ TileAt tile_at(const Params& p, int t) {
  TileAt a{0, 0, 0, t % p.n_blocks, 0};
  const int tile = t / p.n_blocks;
  if (p.taps == 9) {
    a.img = tile / p.tiles_img;
    const int r = tile % p.tiles_img;
    a.y0 = (r / p.tiles_w) * (kTilePixels / p.tile_w);
    a.x0 = (r % p.tiles_w) * p.tile_w;
  } else {
    a.p0 = static_cast<long long>(tile) * kTilePixels;
  }
  return a;
}

// Flattened output pixel of warpgroup wg's row m, or -1 outside the image.
__device__ __forceinline__ long long out_pixel(const Params& p, const TileAt& a, int wg, int m) {
  if (p.taps == 9) {
    const int oy = a.y0 + (p.tile_w == 16 ? m / 8 : 8 * wg + m / 8);
    const int ox = a.x0 + (p.tile_w == 16 ? 8 * wg + m % 8 : m % 8);
    return (oy < p.h && ox < p.w) ? (static_cast<long long>(a.img) * p.h + oy) * p.w + ox : -1;
  }
  const long long pix = a.p0 + kRows * wg + m;
  return pix < p.npix ? pix : -1;
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// The warpgroup's 64 x N outputs: rescaled column by column, staged through
// shared memory in passes of 128 bytes a row, written 16 bytes a thread.
// Thread (warp, lane) holds rows 16 * warp + lane / 4 (+ 8) and columns
// 8 j + 2 (lane % 4) (+ 1) of each 8-column block j.
template <typename TO, int WN, int NACC>
__device__ __forceinline__ void epilogue(const Params& p, const TileAt& a, int wg, int wtid,
                                         int (&acc)[NACC][WN / 2], uint8_t* stage) {
  constexpr int kEs = sizeof(TO);
  // rows 36 words apart (bf16) or 40 (f32): a warp's 4-byte or a half-warp's
  // 8-byte fragment stores fall on distinct banks
  constexpr int kEpiRow = kEs == 2 ? 144 : 160;
  constexpr int kCols = WN < 128 / kEs ? WN : 128 / kEs;   // columns a pass
  constexpr int kVecs = kCols * kEs / 16;                   // 16-byte vectors a pass's row
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t4 = lane & 3;
  const int co0 = a.nb * WN;
  TO* y = static_cast<TO*>(p.y);
#pragma unroll
  for (int pass = 0; pass < WN / kCols; ++pass) {
    named_sync(2 + wg, 128);   // the last pass's (or tile's) reads of the staging are done
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      const int j = pass * (kCols / 8) + jj;
      const int co = co0 + 8 * j + 2 * t4;
      float cs[NACC][2], b[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = co + e < p.cout ? co + e : p.cout - 1;
#pragma unroll
        for (int i = 0; i < NACC; ++i) cs[i][e] = __fmul_rn(p.s_in[i], __ldg(p.s_w[i] + c));
        if (p.bias != nullptr) b[e] = __ldg(p.bias + c);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = __fmul_rn(__int2float_rn(acc[0][4 * j + 2 * hr + e]), cs[0][e]);
          if (NACC == 2) {
            x = __fadd_rn(x, __fmul_rn(__int2float_rn(acc[NACC - 1][4 * j + 2 * hr + e]),
                                       cs[NACC - 1][e]));
          }
          if (p.bias != nullptr) x = __fadd_rn(x, b[e]);
          v[e] = x;
        }
        const int row = 16 * warp + g + 8 * hr;
        store2(reinterpret_cast<TO*>(stage + row * kEpiRow) + 8 * jj + 2 * t4, v[0], v[1]);
      }
    }
    named_sync(2 + wg, 128);
    for (int i = wtid; i < kRows * kVecs; i += 128) {
      const int row = i / kVecs, vec = i % kVecs;
      const long long pix = out_pixel(p, a, wg, row);
      const int co = co0 + pass * kCols + vec * (16 / kEs);
      if (pix >= 0 && co < p.cout) {
        *reinterpret_cast<uint4*>(y + pix * p.cout + co) =
            *reinterpret_cast<const uint4*>(stage + row * kEpiRow + vec * 16);
      }
    }
  }
  if (p.acc_out != nullptr) {   // the int32 sums (return_acc), straight from the fragments
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * t4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long pix = out_pixel(p, a, wg, 16 * warp + g + 8 * hr);
        if (pix < 0 || co >= p.cout) continue;
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          *reinterpret_cast<int2*>(p.acc_out + (i * p.npix + pix) * p.cout + co) =
              make_int2(acc[i][4 * j + 2 * hr], acc[i][4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}

template <int WN, int NACC>
__global__ void __launch_bounds__(kThreads, WN * NACC <= 64 ? 2 : 1)
int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map0,
                       const __grid_constant__ CUtensorMap map1, const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  uint8_t* qbase = base + p.stages * p.stage_bytes;
  uint8_t* epi = qbase + kQBufs * p.q_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(epi + kEpiBytes);   // full[stages], empty[stages]
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + p.stages);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);   // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = p.n_tiles * p.n_blocks;

  if (tid >= kConsumers) {
    // producer: one thread keeps the ring full
    if (tid != kConsumers) return;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const TileAt a = tile_at(p, t);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const CUtensorMap* map = i == 0 ? &map0 : &map1;
        for (int c = 0; c < p.chunks[i]; ++c) {
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t bar = full0 + 8 * s;
          const uint32_t dst = smem_u32(base + s * p.stage_bytes);
          mbar_expect(bar, p.raw_bytes + p.w_bytes);
          if (p.taps == 9) {
            tma_load_4d(dst, map, c * kChunk, a.x0 - 1, a.y0 - 1, a.img, bar);
          } else {
            tma_load_2d(dst, map, c * kChunk, static_cast<int>(a.p0), bar);
          }
          bulk_load(dst + p.raw_span,
                    p.wq[i] + (static_cast<size_t>(a.nb) * p.chunks[i] + c) * p.w_bytes,
                    p.w_bytes, bar);
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: two warpgroups of 64 output pixels each
  const int wg = tid >> 7, wtid = tid & 127;
  float r_in[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const float r = __frcp_rn(p.s_in[i]);
    r_in[i] = (r >= 1.17549435e-38f && r <= 3.40282347e38f) ? r : __int_as_float(0x7fc00000);
  }
  // the warpgroup's first A row in the halo tile, and the A/B strides
  const int wg_slot = p.tile_w == 16 ? 8 * wg : 8 * wg * p.hs;
  const uint32_t a_sbo = 16u * p.hs, b_lbo = 16u * WN;
  uint8_t* stage_epi = epi + wg * (kRows * kEpiRowMax);
  int s = 0, qb = 0, prev = -1;
  uint32_t ph = 0;
  int acc[NACC][WN / 2];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const TileAt a = tile_at(p, t);
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
#pragma unroll
      for (int j = 0; j < WN / 2; ++j) acc[i][j] = 0;
      fence_acc(acc[i]);
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      for (int c = 0; c < p.chunks[i]; ++c) {
        mbar_wait(full0 + 8 * s, ph);
        const uint8_t* st = base + s * p.stage_bytes;
        uint8_t* q = qbase + qb * p.q_bytes;
        quantize_chunk(st, q, p, p.s_in[i], r_in[i], tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1, kConsumers);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint32_t qa = smem_u32(q) + 16u * wg_slot, wb = smem_u32(st) + p.raw_span;
        for (int tap = 0; tap < p.taps; ++tap) {
          const int off = p.taps == 9 ? (tap / 3) * p.hs + tap % 3 : 0;
          Wgmma<WN>::mma(acc[i], desc(qa + 16u * off, p.q_lbo, a_sbo),
                         desc(wb + tap * (kChunk * WN), b_lbo, 128u));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        wgmma_wait<1>();   // the previous chunk's products are done: release its stage
        if (prev >= 0 && wtid == 0) mbar_arrive(empty0 + 8 * prev);
        prev = s;
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
        qb = qb + 1 == kQBufs ? 0 : qb + 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NACC; ++i) fence_acc(acc[i]);
    if (wtid == 0) mbar_arrive(empty0 + 8 * prev);
    prev = -1;
    if (p.out_bf16) {
      epilogue<__nv_bfloat16, WN, NACC>(p, a, wg, wtid, acc, stage_epi);
    } else {
      epilogue<float, WN, NACC>(p, a, wg, wtid, acc, stage_epi);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded: the library
// links only the runtime, not libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      f = nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      f = nullptr;
    }
#endif
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The input's tensor map: k = 3, a 4-D (c, x, y, n) box of 32 channels by
// the halo tile; k = 1, a 2-D (c, pixel) box of 32 channels by 128 pixels.
// Out-of-bounds elements are filled with zeros.
cudaError_t input_map(CUtensorMap* map, const void* x, int cin, const Params& p, int n) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t es = p.in_bf16 ? 2 : 4;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      p.in_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUresult r;
  if (p.taps == 9) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(p.w),
                                static_cast<cuuint64_t>(p.h), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[3] = {cin * es, cin * es * p.w, cin * es * p.w * p.h};
    const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(p.hs),
                               static_cast<cuuint32_t>(p.slots / p.hs), 1};
    r = enc(map, type, 4, const_cast<void*>(x), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cin),
                                static_cast<cuuint64_t>(p.npix)};
    const cuuint64_t strides[1] = {cin * es};
    const cuuint32_t box[2] = {kChunk, kTilePixels};
    r = enc(map, type, 2, const_cast<void*>(x), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

uint32_t round128(uint32_t v) { return (v + 127u) & ~127u; }

// The route's geometry and shared memory for a shape; false where the route
// does not take it.
bool geometry(Params* p, int n, int h, int w, int cout, int ksize, int in_bf16, int n_tile,
              int two, int tile_w, int stages, size_t* smem) {
  if ((ksize != 1 && ksize != 3) || (ksize == 3 && tile_w != 8 && tile_w != 16) ||
      (n_tile != 32 && n_tile != 64 && n_tile != 128 && n_tile != 256) ||
      (two && n_tile > 128) || stages < 2 || cout % 8 != 0) {
    return false;
  }
  p->h = h;
  p->w = w;
  p->cout = cout;
  p->npix = static_cast<long long>(n) * h * w;
  p->taps = ksize * ksize;
  p->in_bf16 = in_bf16;
  p->stages = stages;
  if (ksize == 3) {
    const int rows = kTilePixels / tile_w;
    p->tile_w = tile_w;
    p->hs = tile_w + 2;
    p->slots = (rows + 2) * p->hs;
    p->tiles_w = (w + tile_w - 1) / tile_w;
    p->tiles_img = ((h + rows - 1) / rows) * p->tiles_w;
    const long long tiles = static_cast<long long>(n) * p->tiles_img;
    if (tiles > 0x3fffffffLL) return false;
    p->n_tiles = static_cast<int>(tiles);
  } else {
    p->tile_w = 8;
    p->hs = 8;
    p->slots = kTilePixels;
    p->tiles_w = p->tiles_img = 0;
    if (p->npix > 0x7fffffffLL - kTilePixels) return false;   // TMA coordinates are int32
    p->n_tiles = static_cast<int>((p->npix + kTilePixels - 1) / kTilePixels);
  }
  p->n_blocks = (cout + n_tile - 1) / n_tile;
  if (static_cast<long long>(p->n_tiles) * p->n_blocks > 0x7fffffffLL) return false;
  p->raw_bytes = p->slots * kChunk * (in_bf16 ? 2 : 4);
  p->raw_span = round128(p->raw_bytes);
  p->w_bytes = p->taps * kChunk * n_tile;
  p->stage_bytes = p->raw_span + round128(p->w_bytes);
  p->q_lbo = p->slots * 16;
  if (p->q_lbo % 128 != 64) p->q_lbo = round128(p->q_lbo) + 64;
  p->q_bytes = round128(2 * p->q_lbo);
  *smem = 128 + static_cast<size_t>(stages) * p->stage_bytes + kQBufs * p->q_bytes + kEpiBytes +
          16 * stages;
  return *smem <= kMaxSmem;
}

template <int WN, int NACC>
cudaError_t resident(size_t smem, int* per_sm) {
  const auto kernel = int8_conv_wgmma_kernel<WN, NACC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}

template <int WN, int NACC>
cudaError_t launch(const CUtensorMap& m0, const CUtensorMap& m1, const Params& p, size_t smem,
                   cudaStream_t stream) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = resident<WN, NACC>(smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(p.n_tiles) * p.n_blocks;
  const long long grid = total < static_cast<long long>(per_sm) * sms ? total
                                                                       : per_sm * sms;
  int8_conv_wgmma_kernel<WN, NACC><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      m0, m1, p);
  return cudaGetLastError();
}

// Blocks of the kernel for (n_tile, inputs) resident on an SM with `smem`
// bytes of dynamic shared memory, or an error for a pair it has no kernel for.
cudaError_t blocks_per_sm(int n_tile, int two, size_t smem, int* per_sm) {
  if (!two) {
    switch (n_tile) {
      case 32: return resident<32, 1>(smem, per_sm);
      case 64: return resident<64, 1>(smem, per_sm);
      case 128: return resident<128, 1>(smem, per_sm);
      case 256: return resident<256, 1>(smem, per_sm);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (n_tile) {
    case 32: return resident<32, 2>(smem, per_sm);
    case 64: return resident<64, 2>(smem, per_sm);
    case 128: return resident<128, 2>(smem, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace
}  // namespace probunet

extern "C" {

// y (n, h, w, cout) row-major, f32 (out_bf16 = 0) or bf16 (1), = the
// quantized convolution of x1 (n, h, w, cin1) [plus that of x2 (n, h, w,
// cin2) when x2 is not null] [+ bias (cout,) f32 when not null], on route
// "mma_sync". x1 and x2: f32 (in_bf16 = 0) or bf16 (1), row-major. w1, w2:
// the packed int8 weight slabs (n_tile output channels a block); sw1, sw2:
// (cout,) f32; s1, s2: the inputs' scales. acc_out: null, or (1 or 2, n, h,
// w, cout) int32 that receives the int32 sums. ksize 1 or 3. Returns
// cudaGetLastError().
int int8_conv_fwd(const void* x1, const void* w1, const void* sw1, float s1, int cin1,
                  const void* x2, const void* w2, const void* sw2, float s2, int cin2,
                  const void* bias, void* y, void* acc_out, int n, int h, int w, int cout,
                  int ksize, int in_bf16, int out_bf16, int n_tile, void* stream) {
  if ((ksize != 1 && ksize != 3) || n <= 0 || h <= 0 || w <= 0 || cout <= 0 || cin1 <= 0 ||
      (x2 != nullptr && cin2 <= 0) || n_tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  namespace ms = probunet::ms;
  const int two = x2 != nullptr;
  const float* b = static_cast<const float*>(bias);
  int* acc = static_cast<int*>(acc_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    using T = __nv_bfloat16;
    const auto in1 = ms::make_input<T>(x1, w1, sw1, s1, cin1, n_tile);
    const auto in2 = two ? ms::make_input<T>(x2, w2, sw2, s2, cin2, n_tile) : in1;
    err = ms::dispatch<T>(in1, in2, two, b, y, acc, n, h, w, cout, ksize, out_bf16, s);
  } else {
    const auto in1 = ms::make_input<float>(x1, w1, sw1, s1, cin1, n_tile);
    const auto in2 = two ? ms::make_input<float>(x2, w2, sw2, s2, cin2, n_tile) : in1;
    err = ms::dispatch<float>(in1, in2, two, b, y, acc, n, h, w, cout, ksize, out_bf16, s);
  }
  return static_cast<int>(err);
}

// The same function on route "wgmma": n_tile output channels a block (32,
// 64, 128 or 256; at most 128 with x2), k = 3 tiles of 128 / tile_w rows by
// tile_w (8 or 16) columns, `stages` ring stages. cin1 and cin2 times the
// element size must be multiples of 16 bytes, cout a multiple of 8, and x1,
// x2 16-byte aligned. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape or plan the route does not take.
int int8_conv_wgmma(const void* x1, const void* w1, const void* sw1, float s1, int cin1,
                    const void* x2, const void* w2, const void* sw2, float s2, int cin2,
                    const void* bias, void* y, void* acc_out, int n, int h, int w, int cout,
                    int ksize, int in_bf16, int out_bf16, int n_tile, int tile_w, int stages,
                    void* stream) {
  namespace wg = probunet::wg;
  const int two = x2 != nullptr;
  const int es = in_bf16 ? 2 : 4;
  if (n <= 0 || h <= 0 || w <= 0 || cout <= 0 || cin1 <= 0 || (cin1 * es) % 16 != 0 ||
      (two && (cin2 <= 0 || (cin2 * es) % 16 != 0)) ||
      reinterpret_cast<uintptr_t>(x1) % 16 != 0 ||
      (two && reinterpret_cast<uintptr_t>(x2) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wg::Params p{};
  size_t smem = 0;
  if (!wg::geometry(&p, n, h, w, cout, ksize, in_bf16, n_tile, two, tile_w, stages, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.wq[0] = static_cast<const uint8_t*>(w1);
  p.wq[1] = static_cast<const uint8_t*>(two ? w2 : w1);
  p.s_w[0] = static_cast<const float*>(sw1);
  p.s_w[1] = static_cast<const float*>(two ? sw2 : sw1);
  p.s_in[0] = s1;
  p.s_in[1] = two ? s2 : s1;
  p.chunks[0] = (cin1 + probunet::kChunk - 1) / probunet::kChunk;
  p.chunks[1] = two ? (cin2 + probunet::kChunk - 1) / probunet::kChunk : 0;
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.acc_out = static_cast<int*>(acc_out);
  p.out_bf16 = out_bf16;
  CUtensorMap m0, m1;
  cudaError_t err = wg::input_map(&m0, x1, cin1, p, n);
  if (err == cudaSuccess) err = two ? wg::input_map(&m1, x2, cin2, p, n) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!two) m1 = m0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!two) {
    switch (n_tile) {
      case 32: err = wg::launch<32, 1>(m0, m1, p, smem, s); break;
      case 64: err = wg::launch<64, 1>(m0, m1, p, smem, s); break;
      case 128: err = wg::launch<128, 1>(m0, m1, p, smem, s); break;
      default: err = wg::launch<256, 1>(m0, m1, p, smem, s); break;
    }
  } else {
    switch (n_tile) {
      case 32: err = wg::launch<32, 2>(m0, m1, p, smem, s); break;
      case 64: err = wg::launch<64, 2>(m0, m1, p, smem, s); break;
      default: err = wg::launch<128, 2>(m0, m1, p, smem, s); break;
    }
  }
  return static_cast<int>(err);
}

// Shared memory bytes of route "wgmma" for a shape and plan (0 where the
// route does not take it) and the blocks resident on an SM, into out[0..1].
int int8_conv_wgmma_occupancy(int n, int h, int w, int cout, int ksize, int in_bf16,
                              int n_tile, int two, int tile_w, int stages, void* out) {
  probunet::wg::Params p{};
  size_t smem = 0;
  int* res = static_cast<int*>(out);
  res[0] = res[1] = 0;
  if (!probunet::wg::geometry(&p, n, h, w, cout, ksize, in_bf16, n_tile, two, tile_w, stages,
                              &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  res[0] = static_cast<int>(smem);
  return static_cast<int>(probunet::wg::blocks_per_sm(n_tile, two, smem, res + 1));
}

}  // extern "C"
