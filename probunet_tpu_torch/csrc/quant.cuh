// The int8 quantizer shared by kernel E (int8_conv.cu, the serving path's
// convolution) and kernel F (act_compress.cu, the saved convolution inputs).
//
// q = rint(clamp(x / s, -127, 127)) with the IEEE quotient, as jnp.round of
// the f32 division in the JAX package (probunet_tpu/ops/quantize.py and
// probunet_tpu/ops/act_compress.py:_quantize_channels). Nothing here may be
// built with --use_fast_math, which would turn the division into a multiply
// by an approximate reciprocal.
#pragma once

#include <stdint.h>

namespace probunet {
namespace {  // internal linkage: each .cu file gets its own copy

// rint(clamp(x / s)) as an int8 in the low byte: clamping first or rounding
// first agree, the bounds being integers; __float2int_rn rounds ties to
// even, as jnp.round
__device__ __forceinline__ uint32_t quantize(float x, float s) {
  const float v = fminf(fmaxf(__fdiv_rn(x, s), -127.f), 127.f);
  return static_cast<uint32_t>(__float2int_rn(v)) & 0xffu;
}

}  // namespace
}  // namespace probunet
