// Kernel E: the int8 serving path's convolution. A k x k convolution (k = 1
// or 3, stride 1, SAME zero padding) of one input, or of two inputs whose
// channels are concatenated without materializing the concat (the U-Net
// decoder's split skip convolutions), int8 x int8 -> int32 on the tensor
// cores, with the quantization of the input and the rescaling of the sums
// fused around the product.
//
// No TPU kernel: the JAX package leaves this convolution to XLA
// (probunet_tpu/ops/quantize.py:63-80, lax.conv_general_dilated of int8
// operands with preferred_element_type=int32). It is the port's first kernel
// with no Pallas counterpart. What it computes, at the JAX package's
// rounding points (probunet_tpu/models/layers.py:215-229):
//
//   q(x)       = rint(clamp(x / s_in, -127, 127))       IEEE division, ties to even
//   acc[p, c]  = sum over taps and input channels of q(x) * w_q   (int32, exact)
//   y[p, c]    = f32(acc1) * (s_in1 * s_w1[c])
//              [+ f32(acc2) * (s_in2 * s_w2[c])]         the second input, if any
//              [+ bias[c]]                                then cast to y's type
//
// every product and sum rounded on its own (__fmul_rn/__fadd_rn: nothing is
// contracted to an FMA). The weights come quantized per output channel (per
// slice of a split convolution) by the wrapper, packed as int32 words of
// four int8 input channels, (cout, k*k, cin_words) with cin padded to a
// multiple of 32 by zeros.
//
// Bound: at the flagship's shapes the bytes (x read once, y written once);
// the 128x128x32 -> 32 3x3 convolution at bs=128 in bf16 moves 268 MB (0.080
// ms at 3.35 TB/s) for 38.7 G int8 operations (0.020 ms at 1,979 TOPS).
// Design, simple first: an implicit GEMM (M = output pixels, N = output
// channels, K = taps x input channels) on mma.sync m16n8k32 s8 x s8 -> s32.
// A block of 4 warps owns 64 output pixels (an 8x8 spatial tile for k = 3,
// 64 consecutive pixels of the flattened (n, y, x) grid for k = 1) by 32
// output channels. For each chunk of 32 input channels it quantizes the
// tile's input pixels, the 1-pixel halo included for k = 3 (zero outside the
// image and beyond cin, as JAX's padded x_q), into shared memory, stages the
// chunk's weights of every tap, and each warp runs k*k x 4 MMAs (16 pixels x
// 32 channels). With the int8 words in place the MMA fragments are single
// 32-bit shared-memory loads: thread (group g, lane t) holds words t and t+4
// of pixels g and g+8 (A) and of output channels g (B). Rows are 12 words
// apart, so a warp's fragment loads hit 32 distinct banks. The sums are exact
// whatever the order, so the kernel equals its plain version bit for bit.
// Expected to be bound by its prologue (an IEEE division per input element
// and tap halo, the input read again by every block of output channels), not
// by the MMAs: the later redesign fuses the quantization into the producer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace probunet {
namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kTileH = 8, kTileW = 8;  // k = 3: output pixels of a block
constexpr int kTileP = kTileH * kTileW;
constexpr int kTileC = 32;             // output channels of a block
constexpr int kChunk = 32;             // input channels of a K step: the MMA's depth
constexpr int kWords = kChunk / 4;     // int32 words of a pixel's chunk
constexpr int kStride = 12;            // words between shared-memory rows (8 used)

template <typename T>
struct Input {
  const T* x;          // (n, h, w, cin), row-major
  const uint32_t* w;   // (cout, k*k, cin_words) packed int8
  const float* s_w;    // (cout,) per-channel weight scales
  float s_in;          // the input's scale
  int cin;
  int cin_words;       // ceil(cin / 32) * 8
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// rint(clamp(x / s)): clamping first or rounding first agree, the bounds
// being integers; __float2int_rn rounds ties to even, as jnp.round
__device__ __forceinline__ uint32_t quantize(float x, float s) {
  const float v = fminf(fmaxf(__fdiv_rn(x, s), -127.f), 127.f);
  return static_cast<uint32_t>(__float2int_rn(v)) & 0xffu;
}

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
    for (int i = tid; i < kTaps * kTileC * kWords; i += kThreads) {
      const int j = i % kWords, co_l = (i / kWords) % kTileC, tap = i / (kWords * kTileC);
      const int co = co0 + co_l;
      ws[(tap * kTileC + co_l) * kStride + j] =
          co < cout ? in.w[(static_cast<long long>(co) * kTaps + tap) * in.cin_words + c0 / 4 + j]
                    : 0u;
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
Input<T> make_input(const void* x, const void* w, const void* s_w, float s_in, int cin) {
  return Input<T>{static_cast<const T*>(x), static_cast<const uint32_t*>(w),
                  static_cast<const float*>(s_w), s_in, cin, (cin + kChunk - 1) / kChunk * kWords};
}

}  // namespace
}  // namespace probunet

extern "C" {

// y (n, h, w, cout) row-major, f32 (out_bf16 = 0) or bf16 (1), = the
// quantized convolution of x1 (n, h, w, cin1) [plus that of x2 (n, h, w,
// cin2) when x2 is not null] [+ bias (cout,) f32 when not null]. x1 and x2:
// f32 (in_bf16 = 0) or bf16 (1), row-major. w1, w2: the packed int8 weights
// (cout, ksize^2, ceil(cin / 32) * 8 words); sw1, sw2: (cout,) f32; s1, s2:
// the inputs' scales. acc_out: null, or (1 or 2, n, h, w, cout) int32 that
// receives the int32 sums. ksize 1 or 3. Returns cudaGetLastError().
int int8_conv_fwd(const void* x1, const void* w1, const void* sw1, float s1, int cin1,
                  const void* x2, const void* w2, const void* sw2, float s2, int cin2,
                  const void* bias, void* y, void* acc_out, int n, int h, int w, int cout,
                  int ksize, int in_bf16, int out_bf16, void* stream) {
  if ((ksize != 1 && ksize != 3) || n <= 0 || h <= 0 || w <= 0 || cout <= 0 || cin1 <= 0 ||
      (x2 != nullptr && cin2 <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int two = x2 != nullptr;
  const float* b = static_cast<const float*>(bias);
  int* acc = static_cast<int*>(acc_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    using T = __nv_bfloat16;
    const auto in1 = probunet::make_input<T>(x1, w1, sw1, s1, cin1);
    const auto in2 = two ? probunet::make_input<T>(x2, w2, sw2, s2, cin2) : in1;
    err = probunet::dispatch<T>(in1, in2, two, b, y, acc, n, h, w, cout, ksize, out_bf16, s);
  } else {
    const auto in1 = probunet::make_input<float>(x1, w1, sw1, s1, cin1);
    const auto in2 = two ? probunet::make_input<float>(x2, w2, sw2, s2, cin2) : in1;
    err = probunet::dispatch<float>(in1, in2, two, b, y, acc, n, h, w, cout, ksize, out_bf16, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
