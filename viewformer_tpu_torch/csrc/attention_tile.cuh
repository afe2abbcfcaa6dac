// The in-kernel attention dropout, shared by the forward kernels B5 and B7
// (attention_fwd_sm90.cu) and the backward kernels B6 and B8
// (attention_bwd_sm90.cu), over the hash that every dropping kernel of the
// port takes from dropout_hash.cuh.
#pragma once

#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace tile {

// In-kernel attention dropout (kernels B5-B8), as the Pallas kernels' _hash_keep
// (viewformer_tpu/ops/attention_pallas.py:296): an xxhash-style mix of two
// uint32 seed words and the weight's global index. A weight is kept iff
// u = (h >> 8) / 2^24 >= rate, compared in f32, and a kept weight is scaled by
// `scale`. The mask is a pure function of (seeds, index), so a backward kernel
// regenerates it and nothing is saved. All index and hash arithmetic is uint32
// and wraps, as the reference's does.
struct Dropout {
  unsigned s0, s1;  // the seed words
  float rate;
  float scale;      // f32(1 / (1 - rate)), computed in double on the host
};

// The hash taken apart, so that the 32 keep tests a thread makes for one
// (query frame, key frame) pair cost few integer operations. The hash's
// first step, h = idx * kPrime1 + s0, is formed as a frame base plus steps
// along the wgmma accumulator fragment's rows and columns; the keep test
// h >= threshold24(rate) << 8 is dropout_hash.cuh's on the final hash h.
using dropout_hash::kPrime1;

struct Keep {
  unsigned s0, s1;
  unsigned threshold;  // ceil(rate * 2^24) << 8, or 0 when no weight is kept
  float scale;         // the factor of a kept weight (0 when none is)
  unsigned stride1;    // the row stride of the weight index, times kPrime1
};

__host__ __device__ __forceinline__ Keep make_keep(const Dropout& d, unsigned stride) {
  const unsigned n = dropout_hash::threshold24(d.rate);
  const bool some = n < (1u << 24);
  return Keep{d.s0, d.s1, some ? n << 8 : 0u, some ? d.scale : 0.f, stride * kPrime1};
}

// Whether element i of the thread's accumulator fragment is kept, element i
// lying at column 8(i>>2) + (i&1) and row 8((i>>1)&1) from the thread's
// first; h0 = its first element's index * kPrime1 + s0; col1 and row1 = the
// index steps of a column and a row, times kPrime1.
__device__ __forceinline__ bool keep_test(const Keep& k, unsigned h0, unsigned col1,
                                          unsigned row1, int i) {
  const unsigned h =
      h0 + (unsigned)(8 * (i >> 2) + (i & 1)) * col1 + (unsigned)(8 * ((i >> 1) & 1)) * row1;
  return dropout_hash::finish(h, k.s1) >= k.threshold;
}

// The keep factor (scale or 0) of element i.
__device__ __forceinline__ float keep_at(const Keep& k, unsigned h0, unsigned col1,
                                         unsigned row1, int i) {
  return keep_test(k, h0, col1, row1, i) ? k.scale : 0.f;
}

__device__ __forceinline__ void keep_factors(const Keep& k, unsigned h0, unsigned col1,
                                             unsigned row1, float (&f)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) f[i] = keep_at(k, h0, col1, row1, i);
}

}  // namespace tile
