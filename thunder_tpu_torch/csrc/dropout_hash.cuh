// The stateless dropout keep mask of the training kernels (add_ln_train.cu,
// mha_train.cu): a counter-based hash of the seed and the element's absolute
// coordinates, so that a backward kernel regenerates the forward's bits
// whatever its tiling, and nothing is stored.
//
//   key  = mix32(mix32(seed ^ stream * 0x9E3779B1) ^ row)
//   bits = mix32(key ^ col * 0x85EBCA6B)
//   keep = (bits >> 9) * 2^-23 >= rate
//
// stream is (batch row * heads + head) for the attention probabilities (row =
// query, col = key) and 0 for the add + LayerNorm branch, with batch rows and
// flattened rows counted in the global batch (a launch on a slice of it adds
// its offset). The same function in
// PyTorch integer arithmetic is thunder_tpu_torch/kernels/dropout_hash.py; the
// two must stay equal bit for bit.

#pragma once

#include <cstdint>

namespace thunder_dropout {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t stream, uint32_t row) {
  return mix32(mix32(seed ^ (stream * 0x9E3779B1u)) ^ row);
}

__device__ __forceinline__ bool keep(uint32_t key, uint32_t col, float rate) {
  const uint32_t bits = mix32(key ^ (col * 0x85EBCA6Bu));
  return __uint2float_rn(bits >> 9) * 0x1p-23f >= rate;
}

// keep() as an integer compare: (bits >> 9) * 2^-23 >= rate, both sides exact in float, is
// (bits >> 9) >= ceil(rate * 2^23); threshold(rate) is that ceiling, keep_at() the compare
__host__ __device__ __forceinline__ uint32_t threshold(float rate) { return (uint32_t)ceilf(rate * 0x1p23f); }

__device__ __forceinline__ bool keep_at(uint32_t key, uint32_t col, uint32_t threshold) {
  return (mix32(key ^ (col * 0x85EBCA6Bu)) >> 9) >= threshold;
}

}  // namespace thunder_dropout
