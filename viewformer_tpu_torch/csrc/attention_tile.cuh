// Tile geometry shared by the branching attention kernels (forward and
// backward): one frame of L = 64 tokens at head width dh = 64, as one
// contiguous [64, 64] bf16 tile of a [rows, frames * 64, 64] operand.
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

}  // namespace tile
