// The dropout hash shared by kernels C/C′ (fused_gn.cu) and D (dropout.cu).
//
// The JAX package's fused_gn.py:_dropout_uniform: a murmur3 finalizer of
// (position, two seed words, salt) in wrapping uint32 arithmetic,
//
//   z = pos + seed_a * 2654435761 + seed_b + salt * 40503
//   z = fmix32(z);  u = (z >> 8) * 2^-24  in [0, 1),
//
// and an element is kept when u >= p. The kernels differ only in what they
// pass as position and salt (the coordinates of the TPU kernel's blocks).
// ops/kernels/dropout.py:hash_uniform is the same function in torch.
#pragma once

#include <stdint.h>

namespace probunet {
namespace {  // internal linkage: each .cu file gets its own copy

__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 16;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// The seed words' part of the hash input, from the (2,) int32 seed on the
// device (the host never waits for it).
__device__ __forceinline__ uint32_t hash_key(const int* seed) {
  return static_cast<uint32_t>(seed[0]) * 2654435761u + static_cast<uint32_t>(seed[1]);
}

__device__ __forceinline__ float hash_uniform(uint32_t pos, uint32_t key, uint32_t salt) {
  const uint32_t z = fmix32(pos + key + salt * 40503u);
  return static_cast<float>(z >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

}  // namespace
}  // namespace probunet
