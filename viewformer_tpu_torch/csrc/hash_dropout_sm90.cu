// The hash dropout of MIGT's residual, MLP and embedding sites in one pass:
// the counterpart of the JAX package's hash_dropout
// (viewformer_tpu/ops/dropout.py), which XLA fuses into one elementwise
// kernel, and of the port's plain twin ops/dropout.hash_dropout at the
// indices of ops/dropout.frame_slice_index.
//
// x is [B, T, inner] (bf16 or f32, contiguous), a block of a global array
// [rows, frames, inner] from row batch0 and frame frame0. Element (b, t, j)
// hashes its global index ((batch0 + b) * frames + frame0 + t) * inner + j,
// formed in registers in uint32 arithmetic, whose wrap-around is the plain
// twin's int64 index taken mod 2^32. It is kept iff the hash passes
// dropout_hash.cuh's test at `rate`; a kept element is x / divisor, divided
// in f32 (IEEE, round to nearest) and rounded once to x's dtype, as torch
// divides a bf16 or f32 tensor by a 0-dim tensor of its dtype; a dropped
// element is 0. The same launch on an output gradient is the backward.
//
// Design: memory-bound (4 bytes an element in bf16, read once and written
// once). Each thread takes 16 bytes (8 bf16 or 4 f32 elements, one vector
// load and store) in a grid-stride loop; a vector never straddles a row of
// `inner`, so the row's index base is formed once a vector. Where inner or
// a pointer does not allow 16-byte vectors, one element a step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

using dropout_hash::kPrime1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// n_vec vectors of kVec elements; T_frames and inner: x's frames and row
// width; n24 = threshold24(rate) (an element is kept iff h >> 8 >= n24).
template <typename T, int kVec>
__global__ void __launch_bounds__(256)
    hash_dropout_kernel(const T* __restrict__ x, T* __restrict__ out, unsigned n_vec,
                        unsigned T_frames, unsigned inner, unsigned batch0, unsigned frame0,
                        unsigned frames, unsigned s0, unsigned s1, unsigned n24, float divisor) {
  using P = Pack<T, kVec>;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < n_vec; v += gridDim.x * blockDim.x) {
    const unsigned p = v * kVec;  // fewer than 2^31 elements (the host checks)
    const unsigned row = p / inner, j = p - row * inner;
    const unsigned b = row / T_frames, t = row - b * T_frames;
    const unsigned h0 = (((batch0 + b) * frames + frame0 + t) * inner + j) * kPrime1 + s0;
    const P in = *reinterpret_cast<const P*>(x + p);
    P res;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const bool keep = (dropout_hash::finish(h0 + (unsigned)i * kPrime1, s1) >> 8) >= n24;
      res.v[i] = keep ? from_float<T>(__fdiv_rn(to_float(in.v[i]), divisor)) : from_float<T>(0.f);
    }
    *reinterpret_cast<P*>(out + p) = res;
  }
}

template <typename T>
int launch(const void* x, void* out, unsigned n, unsigned T_frames, unsigned inner,
           unsigned batch0, unsigned frame0, unsigned frames, unsigned s0, unsigned s1,
           unsigned n24, float divisor, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = inner % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned n_vec = vec ? n / kVec : n;
  const unsigned blocks = n_vec == 0 ? 0u : (n_vec + 255) / 256 < 8192u ? (n_vec + 255) / 256 : 8192u;
  if (blocks == 0) return 0;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec)
    hash_dropout_kernel<T, kVec><<<blocks, 256, 0, stream>>>(
        xp, op, n_vec, T_frames, inner, batch0, frame0, frames, s0, s1, n24, divisor);
  else
    hash_dropout_kernel<T, 1><<<blocks, 256, 0, stream>>>(
        xp, op, n_vec, T_frames, inner, batch0, frame0, frames, s0, s1, n24, divisor);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows / T_frames, T_frames, inner] contiguous, n = rows * inner
// elements (< 2^31); bf16: 1 for bfloat16, 0 for float32; the placement's
// batch0, frame0 and frames and the seed words mod 2^32; rate in (0, 1)
// (f32); divisor: (1 - rate) rounded to x's dtype, as an f32. Returns the
// CUDA error of the launch (0: launched).
extern "C" int hash_dropout(const void* x, void* out, int bf16, int n, int T_frames, int inner,
                            unsigned batch0, unsigned frame0, unsigned frames, unsigned s0,
                            unsigned s1, float rate, float divisor, void* stream) {
  const unsigned n24 = dropout_hash::threshold24(rate);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, out, (unsigned)n, (unsigned)T_frames, (unsigned)inner,
                                      batch0, frame0, frames, s0, s1, n24, divisor, s)
              : launch<float>(x, out, (unsigned)n, (unsigned)T_frames, (unsigned)inner, batch0,
                              frame0, frames, s0, s1, n24, divisor, s);
}
