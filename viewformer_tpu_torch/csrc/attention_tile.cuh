// Tile geometry of the WMMA dropout forward kernels B5 and B7
// (branching_attention.cu): one frame of L = 64 tokens at head width
// dh = 64, as one contiguous [64, 64] bf16 tile of a [rows, frames * 64, 64]
// operand; and the hash of the in-kernel attention dropout, which the
// backward kernels (attention_bwd_sm90.cu) share.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace tile {

constexpr int kRows = 64;    // tokens per frame (L): query rows and keys per tile
constexpr int kDh = 64;      // head width
constexpr int kWarps = 4;    // each warp owns 16 rows of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kRows * kDh;  // elements of one [64, 64] tile

// One contiguous [64, 64] bf16 tile (8 KB) from global to shared memory,
// 16 bytes a thread per step.
__device__ inline void load_tile(bf16* dst, const bf16* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < kTile / 8; i += kThreads) d[i] = s[i];
}

// In-kernel attention dropout (kernels B5-B8), as the Pallas kernels' _hash_keep
// (viewformer_tpu/ops/attention_pallas.py:296): an xxhash-style mix of two
// uint32 seed words and the weight's global index. A weight is kept iff
// u = (h >> 8) / 2^24 >= rate, compared in f32, and a kept weight is scaled by
// `scale`. The mask is a pure function of (seeds, index), so a backward kernel
// regenerates it and nothing is saved. All index and hash arithmetic is uint32
// and wraps, as the reference's does. (B6 and B8, in attention_bwd_sm90.cu,
// run the same hash and test taken apart: keep_factors there.)
struct Dropout {
  unsigned s0, s1;  // the seed words
  float rate;
  float scale;      // f32(1 / (1 - rate)), computed in double on the host
};

// The global indices of one (query tile, key tile) pair of weights:
// index(row, col) = base + row * stride + col, row and col in [0, 64).
struct WeightIndex {
  unsigned base, stride;
};

__device__ __forceinline__ float keep_factor(const Dropout& d, unsigned idx) {
  unsigned h = idx * 2654435761u + d.s0;
  h ^= h >> 15;
  h *= 2246822519u;
  h ^= (h >> 13) ^ d.s1;
  h *= 3266489917u;
  h ^= h >> 16;
  const float u = (float)(h >> 8) * (1.f / 16777216.f);  // exact: h >> 8 < 2^24
  return u >= d.rate ? d.scale : 0.f;
}

}  // namespace tile
