// The dropout hash of the port, one definition for every kernel that drops:
// the attention kernels B5-B8 (attention_tile.cuh) and the elementwise hash
// dropout of the residual, MLP and embedding sites (hash_dropout_sm90.cu).
// It is ops/dropout.py's hash_bits: an xxhash-style mix of two uint32 seed
// words and an element's global index, in uint32 arithmetic that wraps as
// the reference's does. An element is kept iff u = (h >> 8) / 2^24 >= rate,
// compared in f32; as u is exact in f32, that is h >= ceil(rate * 2^24) << 8
// on the final hash h, in integers.
#pragma once

#include <math.h>
#include <stdint.h>

namespace dropout_hash {

constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 2246822519u;
constexpr unsigned kPrime3 = 3266489917u;

// The hash of an index from its first step, h = idx * kPrime1 + s0.
__host__ __device__ __forceinline__ unsigned finish(unsigned h, unsigned s1) {
  h ^= h >> 15;
  h *= kPrime2;
  h ^= (h >> 13) ^ s1;
  h *= kPrime3;
  return h ^ (h >> 16);
}

// ceil(rate * 2^24) for a rate (f32) in [0, 1]: an element is kept iff its
// final hash h has h >> 8 >= this; 2^24 keeps nothing.
__host__ __device__ __forceinline__ unsigned threshold24(float rate) {
  return (unsigned)ceilf(rate * 16777216.f);  // rate * 2^24 is exact
}

}  // namespace dropout_hash
