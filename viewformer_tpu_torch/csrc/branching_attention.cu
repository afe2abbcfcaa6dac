// Branching block attention forward kernels with in-kernel dropout, for
// Hopper (sm_90a), bf16 in and out.
//
// B5 block_causal_attention_dropout_fwd replaces
//    viewformer_tpu/ops/attention_pallas.py:_block_causal_do_kernel3 (stream-0
//    attention, a query in frame t attends every key of frames <= t, with
//    inverted dropout on the softmax weights).
// B7 branch_attention_dropout_fwd (one-shot form only) replaces
//    viewformer_tpu/ops/attention_pallas.py:_branch_do_kernel3 (side-stream
//    attention over stream-0 keys of earlier frames plus the query's own
//    frame, one joint softmax, with dropout).
// The dropout mask is hashed in the kernel from the seed words and each
// weight's global index (attention_tile.cuh): the bf16 numerator of a weight
// becomes e * keep, while the running sum l keeps the undropped e (dropout
// acts after the softmax), so the log-sum-exp written for the backward is
// the undropped attention's. Index spaces, as the Pallas kernels': B5
// (bh*TL + row)*TL + col over global rows and columns; B7
// (g*TL + row)*(TL + qb) + col for stream-0 keys and
// (g*TL + row)*(TL + qb) + TL + (the key's position inside the query's q-tile
// of qb rows) for own-frame keys, qb being the Pallas q-tile (_pick_q_block),
// which the host passes in. The kernels without dropout, B1 and B2, are
// attention_fwd_sm90.cu.
//
// Conventions kept from the reference: no 1/sqrt(dh) scale, f32 scores and
// softmax, the softmax weights rounded to the value dtype (bf16) before the
// product with V, f32 accumulation.
//
// For training, both kernels can also write each query row's f32
// log-sum-exp of its scores, lse = m + log(l) from the online softmax, which
// the backward kernels (B6 and B8 in attention_bwd_sm90.cu) recompute the
// weights from.
//
// Design. The Pallas kernels keep all of one (batch, head)'s K and V in VMEM
// and finish in one pass. At T*L = 1280 and dh = 64, K+V of one (b, h) in bf16
// is 320 KB, above the 227 KB of shared memory a block may use on an H100. So
// each block owns one query frame (L = 64 rows) and streams K/V one frame
// (64 keys) at a time through shared memory with an online f32 softmax
// (running max and sum per row, the f32 output rescaled in shared memory).
// Frames that the mask zeroes out are skipped, not computed: every query row
// attends at least its own frame, so the reference's -1e9 scores contribute
// exp(-1e9 - m) = 0 in f32 and skipping them is exact. Within a visited frame
// no key is masked, so the kernels hold no mask at all.
//
// What bounds it: at the main path's shapes each (query frame, key frame)
// pair is ~1 MFLOP on 16 KB of K/V. The products run on the tensor cores
// through WMMA 16x16x16 bf16 tiles (4 warps, 16 query rows each), with no
// copy/compute overlap: the loads of each K/V frame are exposed. The hash
// adds ~20 integer operations a visited weight to the softmax loop, which
// that structure hides: on an H100 (700 W) B5/B7 ran within 1% of the times
// of the same structure without dropout. Moving them onto the TMA/wgmma
// design of attention_fwd_sm90.cu is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "attention_tile.cuh"

using namespace nvcuda;
using tile::Dropout;
using tile::keep_factor;
using tile::kDh;
using tile::kRows;
using tile::kThreads;
using tile::kTile;
using tile::load_tile;
using tile::WeightIndex;

namespace {

// dynamic shared memory layout
constexpr int kOffQ = 0;
constexpr int kOffK = kOffQ + kTile * 2;
constexpr int kOffV = kOffK + kTile * 2;
constexpr int kOffP = kOffV + kTile * 2;    // bf16 softmax numerators
constexpr int kOffS = kOffP + kTile * 2;    // f32 scores
constexpr int kOffO = kOffS + kTile * 4;    // f32 output accumulator
constexpr int kOffM = kOffO + kTile * 4;    // f32 running row max
constexpr int kOffL = kOffM + kRows * 4;    // f32 running row sum
constexpr int kSmemBytes = kOffL + kRows * 4;

struct Smem {
  bf16* q;
  bf16* k;
  bf16* v;
  bf16* p;
  float* s;
  float* o;
  float* m;
  float* l;
};

__device__ Smem carve(unsigned char* base) {
  Smem sm;
  sm.q = reinterpret_cast<bf16*>(base + kOffQ);
  sm.k = reinterpret_cast<bf16*>(base + kOffK);
  sm.v = reinterpret_cast<bf16*>(base + kOffV);
  sm.p = reinterpret_cast<bf16*>(base + kOffP);
  sm.s = reinterpret_cast<float*>(base + kOffS);
  sm.o = reinterpret_cast<float*>(base + kOffO);
  sm.m = reinterpret_cast<float*>(base + kOffM);
  sm.l = reinterpret_cast<float*>(base + kOffL);
  return sm;
}

__device__ void init_state(const Smem& sm) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) sm.o[i] = 0.f;
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    sm.m[i] = -INFINITY;
    sm.l[i] = 0.f;
  }
}

// Fold one frame of keys (sm.k) and values (sm.v) into the warp's 16 rows.
// Touches only the warp's own rows of s, p, o, m, l. The weights' global
// indices are wi's.
__device__ void attend_frame(const Smem& sm, int warp, int lane, const Dropout& drop,
                             WeightIndex wi) {
  const int r0 = warp * 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;

  // S = Q K^T: K is [key, d] row-major, i.e. K^T column-major
  {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    for (int n = 0; n < kRows / 16; ++n) {
      wmma::fill_fragment(c, 0.f);
      for (int kk = 0; kk < kDh / 16; ++kk) {
        wmma::load_matrix_sync(a, sm.q + r0 * kDh + kk * 16, kDh);
        wmma::load_matrix_sync(b, sm.k + n * 16 * kDh + kk * 16, kDh);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sm.s + r0 * kRows + n * 16, c, kRows, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // online softmax: two lanes per row, 32 columns each
  const int row = r0 + lane / 2;
  const int half = lane & 1;
  const float* srow = sm.s + row * kRows + half * 32;
  float mx = -INFINITY;
  for (int j = 0; j < 32; ++j) mx = fmaxf(mx, srow[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_old = sm.m[row];
  const float m_new = fmaxf(m_old, mx);
  const float scale = expf(m_old - m_new);  // 0 on the first frame (m_old = -inf)
  bf16* prow = sm.p + row * kRows + half * 32;
  float sum = 0.f;
  for (int j = 0; j < 32; ++j) {
    const float e = expf(srow[j] - m_new);
    float p = e;
    p *= keep_factor(drop, wi.base + row * wi.stride + half * 32 + j);
    prow[j] = __float2bfloat16(p);
    sum += e;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  float* orow = sm.o + row * kDh + half * 32;
  for (int j = 0; j < 32; ++j) orow[j] *= scale;
  __syncwarp();  // both lanes of the row have read m_old
  if (half == 0) {
    sm.m[row] = m_new;
    sm.l[row] = sm.l[row] * scale + sum;
  }
  __syncwarp();

  // O += P V: V is [key, d] row-major
  {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    for (int n = 0; n < kDh / 16; ++n) {
      wmma::load_matrix_sync(c, sm.o + r0 * kDh + n * 16, kDh, wmma::mem_row_major);
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wmma::load_matrix_sync(a, sm.p + r0 * kRows + kk * 16, kRows);
        wmma::load_matrix_sync(b, sm.v + kk * 16 * kDh + n * 16, kDh);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sm.o + r0 * kDh + n * 16, c, kDh, wmma::mem_row_major);
    }
  }
  __syncwarp();
}

// Each frame's K and V pass through shared memory shared by all warps.
__device__ void attend_global_frame(const Smem& sm, const bf16* k, const bf16* v,
                                    int warp, int lane, const Dropout& drop,
                                    WeightIndex wi) {
  __syncthreads();  // every warp is done with the previous frame's K/V
  load_tile(sm.k, k);
  load_tile(sm.v, v);
  __syncthreads();
  attend_frame(sm, warp, lane, drop, wi);
}

// out: the query frame's [64, 64] tile; lse: its 64 row entries, or null.
__device__ void write_out(const Smem& sm, bf16* out, float* lse, int warp, int lane) {
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const float inv = 1.f / sm.l[row];
  const float* orow = sm.o + row * kDh + half * 32;
  bf16* grow = out + row * kDh + half * 32;
  for (int j = 0; j < 32; ++j) grow[j] = __float2bfloat16(orow[j] * inv);
  if (lse != nullptr && half == 0) lse[row] = sm.m[row] + logf(sm.l[row]);
}

// q, k, v, o: [BH, T*64, 64]; lse: [BH, T*64] or null. grid (T, BH): block
// (t, bh) computes query frame t against key frames 0..t.
__global__ void __launch_bounds__(kThreads)
block_causal_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int frames, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x;
  const size_t base = (size_t)blockIdx.y * frames * kTile;
  const unsigned tl = frames * kRows;
  const unsigned row0 = blockIdx.y * tl + t * kRows;  // global index row of query 0
  load_tile(sm.q, q + base + (size_t)t * kTile);
  init_state(sm);
  for (int f = 0; f <= t; ++f)
    attend_global_frame(sm, k + base + (size_t)f * kTile,
                               v + base + (size_t)f * kTile, warp, lane, drop,
                               WeightIndex{row0 * tl + f * kRows, tl});
  write_out(sm, o + base + (size_t)t * kTile,
            lse == nullptr ? nullptr : lse + ((size_t)blockIdx.y * frames + t) * kRows,
            warp, lane);
}

// q, kb, vb, o: [G, TQ*64, 64]; lse: [G, TQ*64] or null; k0, v0:
// [BH0, F0*64, 64] shared by the G / BH0 branches (branch g reads row
// g % BH0). grid (TQ, G): block (tq, g) computes query frame
// first_q_frame + tq against stream-0 frames < min(that frame, n_old), then
// its own frame of kb/vb. It is launched in the one-shot form only
// (first_q_frame = 0, n_old = TQ = F0), with the Pallas q-tile qb.
__global__ void __launch_bounds__(kThreads)
branch_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k0,
              const bf16* __restrict__ v0, const bf16* __restrict__ kb,
              const bf16* __restrict__ vb, bf16* __restrict__ o, float* __restrict__ lse,
              int q_frames, int old_frames, int bh0, int first_q_frame, int n_old, int qb,
              Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = blockIdx.x;
  const int g = blockIdx.y;
  const size_t own = ((size_t)g * q_frames + tq) * kTile;
  const size_t base0 = (size_t)(g % bh0) * old_frames * kTile;
  const int n_prev = min(first_q_frame + tq, n_old);
  // B7's index: rows of stride TL + qb; row_base is query 0's
  const unsigned tl = q_frames * kRows, stride = tl + qb;
  const unsigned row_base = (g * tl + tq * kRows) * stride;
  load_tile(sm.q, q + own);
  init_state(sm);
  for (int f = 0; f < n_prev; ++f)
    attend_global_frame(sm, k0 + base0 + (size_t)f * kTile,
                               v0 + base0 + (size_t)f * kTile, warp, lane, drop,
                               WeightIndex{row_base + f * kRows, stride});
  // own-frame keys: offset TL, then the key's position inside the q-tile
  attend_global_frame(sm, kb + own, vb + own, warp, lane, drop,
                             WeightIndex{row_base + tl + tq * kRows % qb, stride});
  write_out(sm, o + own, lse == nullptr ? nullptr : lse + own / kDh, warp, lane);
}

int launch_block_causal(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int frames, Dropout drop, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_causal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  block_causal_kernel<<<dim3(frames, bh), kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, frames, drop);
  return (int)cudaGetLastError();
}

int launch_branch(const void* q, const void* k0, const void* v0, const void* kb,
                  const void* vb, void* o, void* lse, int g, int q_frames, int bh0,
                  int old_frames, int first_q_frame, int n_old, int qb, Dropout drop,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      branch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  branch_kernel<<<dim3(q_frames, g), kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k0, (const bf16*)v0, (const bf16*)kb, (const bf16*)vb,
      (bf16*)o, (float*)lse, q_frames, old_frames, bh0, first_q_frame, n_old, qb, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on the given stream,
// does not synchronise, and returns cudaGetLastError() of the launch. lse may
// be null. s0, s1, rate, scale: see Dropout (attention_tile.cuh).
extern "C" int block_causal_attention_dropout_fwd(const void* q, const void* k, const void* v,
                                                  void* o, void* lse, int bh, int frames,
                                                  unsigned s0, unsigned s1, float rate,
                                                  float scale, void* stream) {
  return launch_block_causal(q, k, v, o, lse, bh, frames, Dropout{s0, s1, rate, scale}, stream);
}

// The one-shot form: q_frames = old_frames = frames, first_q_frame 0, n_old frames.
extern "C" int branch_attention_dropout_fwd(const void* q, const void* k0, const void* v0,
                                            const void* kb, const void* vb, void* o,
                                            void* lse, int g, int frames, int bh0, int qb,
                                            unsigned s0, unsigned s1, float rate,
                                            float scale, void* stream) {
  return launch_branch(q, k0, v0, kb, vb, o, lse, g, frames, bh0, frames, 0, frames, qb,
                       Dropout{s0, s1, rate, scale}, stream);
}
