// Branch attention backward kernels for Hopper (sm_90a), bf16 in and out.
// (The block-causal backward, B3 and B6, is in attention_bwd_sm90.cu.)
//
// B4 branch_attention_bwd replaces
//    viewformer_tpu/ops/attention_pallas.py:_branch_bwd_kernel3 together with
//    the sum over branches of dK0/dV0 in _fb_bwd (attention_pallas.py:630-631):
//    the backward of the one-shot branch attention, kernel B2 with
//    first_q_frame = 0 and n_old = T.
// B8 branch_attention_dropout_bwd replaces _branch_do_bwd_kernel3 with the
//    sum over branches of _fbd_bwd (attention_pallas.py:708-709): the
//    backward of B7, B4's code with the template flag kDrop set. Each block
//    regenerates the dropout mask of the weights it visits from the seed
//    words and their global indices (attention_tile.cuh; the index space is
//    B7's), so nothing is saved. With keep the scaled mask, as the reference
//    (attention_pallas.py:448-473):
//      dP' = (dO V^T) * keep,  dS = W * (dP' - D),  dV += (W * keep)^T dO.
//    D = rowsum(dO * O) still holds: O is the dropped output, so
//    rowsum(dO * O) = sum_j W_j keep_j (dO . V_j) = rowsum(W * dP'), the
//    reference's rowsum.
//
// Math, as the reference's (attention_pallas.py:138-146), no 1/sqrt(dh) scale:
//   W  = softmax(S), S = Q K^T in f32, recomputed as exp(S - lse) from the
//        forward's per-row f32 log-sum-exp (B2/B7 write it);
//   dP = dO V^T in f32;   dS = W * (dP - D);
//   dQ = dS K,   dK = dS^T Q,   dV = W^T dO,
// with dS and W rounded to bf16 before the three products and f32
// accumulation; every output rounded to bf16 once, at the end. D is taken as
// rowsum(dO * O) over the forward's bf16 output O (FlashAttention-2), not as
// the reference's rowsum(dP * W) over all keys: the two are equal up to the
// rounding of O, and this way D needs no extra pass over the keys. The
// softmax is the joint one over K0 frames < t and the own frame, so lse and D
// cover both key sets.
//
// Design. The Pallas kernels accumulate dK/dV across q-tiles in a VMEM output
// block, relying on the TPU running the grid in order. GPU blocks run in no
// order, so here each output tile has exactly one owner block, which loops
// over what feeds it; there are no atomics and the result is deterministic.
// One launch holds two kinds of block:
//   key blocks, one per (row, key frame j), own the 64 keys of K0/V0 frame j
//     and accumulate dK0/dV0 over the query frames t > j of every branch of
//     the row, so the sum over the S branches happens here, in f32, with no
//     [S*BH, ...] temporary;
//   query blocks, one per (branch row, query frame t), own the 64 query rows
//     of frame t and accumulate dQ over the K0 frames < t, then the own
//     frame, whose dKb/dVb only frame t's queries feed, so the query block
//     writes them too.
// Every block streams the other side one [64, 64] frame tile at a time
// through shared memory (one (b, h)'s K/V, 320 KB at T*L = 1280, does not
// fit in the 227 KB a block may use). Key blocks, the longest (up to
// S*(T-1) frames), come first in the grid.
//
// What bounds it: each visited (query frame, key frame) pair costs four
// 64x64x64 products in the block that owns it (S, dP, then dQ, or dK and
// dV), so the pair's S and dP are computed twice, once by each owner: ~7
// products a pair against the 5 of a single pass. The products run on the
// tensor cores through WMMA 16x16x16 bf16 tiles, with no copy/compute
// overlap. Simple and right first; TMA, wgmma and a pipelined ring are later
// work (attention_bwd_sm90.cu has them for B3/B6). The hash of B8 is hidden
// the same way: on an H100 (700 W) B8 ran within 1% of B4's time.
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

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// dynamic shared memory layout
constexpr int kOffOwnA = 0;                    // bf16: Q (query blocks) or K (key blocks)
constexpr int kOffOwnB = kOffOwnA + kTile * 2; // bf16: dO (query blocks) or V (key blocks)
constexpr int kOffInA = kOffOwnB + kTile * 2;  // bf16 streamed: K (query) or Q (key blocks)
constexpr int kOffInB = kOffInA + kTile * 2;   // bf16 streamed: V (query) or dO (key blocks)
constexpr int kOffInO = kOffInB + kTile * 2;   // bf16: O, for D
constexpr int kOffS = kOffInO + kTile * 2;     // f32 scores (transposed in key blocks)
constexpr int kOffDP = kOffS + kTile * 4;      // f32 dO V^T (transposed in key blocks)
constexpr int kOffP = kOffDP + kTile * 4;      // bf16 weights W
constexpr int kOffDS = kOffP + kTile * 2;      // bf16 dS
constexpr int kOffLse = kOffDS + kTile * 2;    // f32 per query row: log-sum-exp
constexpr int kOffD = kOffLse + kRows * 4;     // f32 per query row: rowsum(dO * O)
constexpr int kSmemBytes = kOffD + kRows * 4;

struct Smem {
  bf16* own_a;
  bf16* own_b;
  bf16* in_a;
  bf16* in_b;
  bf16* in_o;
  float* s;
  float* dp;
  bf16* p;
  bf16* ds;
  float* lse;
  float* d;
};

__device__ Smem carve(unsigned char* base) {
  Smem sm;
  sm.own_a = reinterpret_cast<bf16*>(base + kOffOwnA);
  sm.own_b = reinterpret_cast<bf16*>(base + kOffOwnB);
  sm.in_a = reinterpret_cast<bf16*>(base + kOffInA);
  sm.in_b = reinterpret_cast<bf16*>(base + kOffInB);
  sm.in_o = reinterpret_cast<bf16*>(base + kOffInO);
  sm.s = reinterpret_cast<float*>(base + kOffS);
  sm.dp = reinterpret_cast<float*>(base + kOffDP);
  sm.p = reinterpret_cast<bf16*>(base + kOffP);
  sm.ds = reinterpret_cast<bf16*>(base + kOffDS);
  sm.lse = reinterpret_cast<float*>(base + kOffLse);
  sm.d = reinterpret_cast<float*>(base + kOffD);
  return sm;
}

// out[16, 64] (f32, row stride 64) = a[16, 64] b^T, with a the warp's 16 rows
// of a row-major [64, 64] tile and b a whole row-major [64, 64] tile.
__device__ void product_abt(float* out, const bf16* a, const bf16* b) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
  Acc c;
  for (int n = 0; n < kRows / 16; ++n) {
    wmma::fill_fragment(c, 0.f);
    for (int kk = 0; kk < kDh / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16, kDh);
      wmma::load_matrix_sync(fb, b + n * 16 * kDh + kk * 16, kDh);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, kRows, wmma::mem_row_major);
  }
}

// acc[16, 64] += a[16, 64] b, a the warp's 16 rows of a row-major [64, 64]
// tile, b a row-major [64, 64] tile.
__device__ void accumulate_ab(Acc* acc, const bf16* a, const bf16* b) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  for (int n = 0; n < kDh / 16; ++n)
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16, kRows);
      wmma::load_matrix_sync(fb, b + kk * 16 * kDh + n * 16, kDh);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
}

// acc[16, 64] += a[:, c0:c0+16]^T b, a and b row-major [64, 64] tiles.
__device__ void accumulate_atb(Acc* acc, const bf16* a, int c0, const bf16* b) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  for (int n = 0; n < kDh / 16; ++n)
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wmma::load_matrix_sync(fa, a + kk * 16 * kRows + c0, kRows);
      wmma::load_matrix_sync(fb, b + kk * 16 * kDh + n * 16, kDh);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
}

__device__ void zero(Acc* acc) {
  for (int n = 0; n < kDh / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
}

// The warp's 16 rows of acc, rounded to bf16, into rows r0.. of the global
// [64, 64] tile dst, through the warp's rows of the f32 scratch tile.
__device__ void store_rows(const Acc* acc, float* scratch, bf16* dst, int r0, int lane) {
  for (int n = 0; n < kDh / 16; ++n)
    wmma::store_matrix_sync(scratch + r0 * kDh + n * 16, acc[n], kDh, wmma::mem_row_major);
  __syncwarp();
  const int row = r0 + lane / 2, half = lane & 1;
  const float* srow = scratch + row * kDh + half * 32;
  bf16* grow = dst + row * kDh + half * 32;
  for (int j = 0; j < 32; ++j) grow[j] = __float2bfloat16(srow[j]);
  __syncwarp();
}

// Loads a query frame's per-row state: O into in_o, its lse, then
// D = rowsum(dO * O) from dO (already in shared memory at `dout`). All
// threads; ends synchronised.
__device__ void load_query_state(const Smem& sm, const bf16* o, const float* lse,
                                 const bf16* dout) {
  load_tile(sm.in_o, o);
  if (threadIdx.x < kRows) sm.lse[threadIdx.x] = lse[threadIdx.x];
  __syncthreads();
  const int row = threadIdx.x / 2, half = threadIdx.x & 1;  // 2 threads a row
  const bf16* a = dout + row * kDh + half * 32;
  const bf16* b = sm.in_o + row * kDh + half * 32;
  float sum = 0.f;
  for (int j = 0; j < 32; ++j) sum += __bfloat162float(a[j]) * __bfloat162float(b[j]);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (half == 0) sm.d[row] = sum;
  __syncthreads();
}

// From the warp's rows of s and dp: W = exp(s - lse), dS = W (dp - D), both
// rounded to bf16 into p and ds. In key blocks the tiles are transposed
// ([key, query]), so lse and D follow the column. With kDrop, dp is scaled by
// the weight's keep factor first and p holds W * keep; wi gives the weights'
// global indices by (query, key).
template <bool kTransposed, bool kDrop>
__device__ void softmax_grad(const Smem& sm, int r0, int lane, const Dropout& drop,
                             WeightIndex wi) {
  const int row = r0 + lane / 2, half = lane & 1;
  for (int j = 0; j < 32; ++j) {
    const int col = half * 32 + j;
    const int i = row * kRows + col;
    const int q = kTransposed ? col : row;
    const float w = expf(sm.s[i] - sm.lse[q]);
    float dp = sm.dp[i], wk = w;
    if (kDrop) {
      const float keep = keep_factor(drop, wi.base + q * wi.stride + (kTransposed ? row : col));
      dp *= keep;
      wk *= keep;
    }
    sm.p[i] = __float2bfloat16(wk);
    sm.ds[i] = __float2bfloat16(w * (dp - sm.d[q]));
  }
  __syncwarp();
}

// Query block: one streamed key frame (K in in_a, V in in_b) into the warp's
// dQ rows. own_a holds Q, own_b dO.
template <bool kDrop>
__device__ void query_frame(const Smem& sm, Acc* dq, const bf16* k, const bf16* v, int r0,
                            int lane, const Dropout& drop, WeightIndex wi) {
  __syncthreads();  // every warp is done with the previous frame
  load_tile(sm.in_a, k);
  load_tile(sm.in_b, v);
  __syncthreads();
  product_abt(sm.s + r0 * kRows, sm.own_a + r0 * kDh, sm.in_a);   // S = Q K^T
  product_abt(sm.dp + r0 * kRows, sm.own_b + r0 * kDh, sm.in_b);  // dP = dO V^T
  __syncwarp();
  softmax_grad<false, kDrop>(sm, r0, lane, drop, wi);
  accumulate_ab(dq, sm.ds + r0 * kRows, sm.in_a);                 // dQ += dS K
}

// Key block: one streamed query frame into the warp's 16 key rows of dK/dV.
// own_a holds K, own_b V; q, dout, o are the query frame's tiles.
template <bool kDrop>
__device__ void key_frame(const Smem& sm, Acc* dk, Acc* dv, const bf16* q, const bf16* dout,
                          const bf16* o, const float* lse, int r0, int lane,
                          const Dropout& drop, WeightIndex wi) {
  __syncthreads();  // every warp is done with the previous frame
  load_tile(sm.in_a, q);
  load_tile(sm.in_b, dout);
  load_query_state(sm, o, lse, sm.in_b);
  product_abt(sm.s + r0 * kRows, sm.own_a + r0 * kDh, sm.in_a);   // S^T = K Q^T
  product_abt(sm.dp + r0 * kRows, sm.own_b + r0 * kDh, sm.in_b);  // dP^T = V dO^T
  __syncwarp();
  softmax_grad<true, kDrop>(sm, r0, lane, drop, wi);
  accumulate_ab(dv, sm.p + r0 * kRows, sm.in_b);                  // dV += W^T dO
  accumulate_ab(dk, sm.ds + r0 * kRows, sm.in_a);                 // dK += dS^T Q
}

// q, kb, vb, o, dout, dq, dkb, dvb: [G, T*64, 64]; lse: [G, T*64];
// k0, v0, dk0, dv0: [BH0, T*64, 64], shared by the S = G / BH0 branches
// (branch g reads row g % BH0). grid (T, BH0 + G): y < BH0 are key blocks of
// K0/V0 (row y, key frame x), the rest query blocks (branch row y - BH0,
// query frame x). With kDrop, qb is the Pallas q-tile of B7's index space.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
branch_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k0,
                  const bf16* __restrict__ v0, const bf16* __restrict__ kb,
                  const bf16* __restrict__ vb, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  bf16* __restrict__ dq, bf16* __restrict__ dk0, bf16* __restrict__ dv0,
                  bf16* __restrict__ dkb, bf16* __restrict__ dvb, int g_rows, int bh0,
                  int frames, int qb, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);
  const int r0 = (threadIdx.x / 32) * 16, lane = threadIdx.x % 32;
  const int f = blockIdx.x;
  // B7's index of branch row g, query frame a: rows of stride TL + qb from
  // (g*TL + a*64)*(TL + qb); K0 frame b at column b*64, the own frame at
  // TL + (a*64 mod qb), the key's position inside the query's q-tile
  const unsigned tl = frames * kRows, stride = tl + qb;
  auto index_old = [&](int g, int a, int b) {
    return WeightIndex{(g * tl + a * kRows) * stride + b * kRows, stride};
  };
  auto index_own = [&](int g, int a) {
    return WeightIndex{(g * tl + a * kRows) * stride + tl + (kDrop ? a * kRows % qb : 0), stride};
  };

  if (blockIdx.y < bh0) {  // key block: K0/V0 frame f of row blockIdx.y
    const size_t own0 = ((size_t)blockIdx.y * frames + f) * kTile;
    Acc acc_k[kDh / 16], acc_v[kDh / 16];
    zero(acc_k);
    zero(acc_v);
    load_tile(sm.own_a, k0 + own0);
    load_tile(sm.own_b, v0 + own0);
    for (int g = blockIdx.y; g < g_rows; g += bh0)  // every branch of this row
      for (int t = f + 1; t < frames; ++t) {
        const size_t at = ((size_t)g * frames + t) * kTile;
        key_frame<kDrop>(sm, acc_k, acc_v, q + at, dout + at, o + at, lse + at / kDh, r0, lane,
                         drop, index_old(g, t, f));
      }
    store_rows(acc_k, sm.s, dk0 + own0, r0, lane);
    store_rows(acc_v, sm.dp, dv0 + own0, r0, lane);
    return;
  }
  const int g = blockIdx.y - bh0;
  const size_t own = ((size_t)g * frames + f) * kTile;
  const size_t base0 = (size_t)(g % bh0) * frames * kTile;
  Acc acc[kDh / 16];
  zero(acc);
  load_tile(sm.own_a, q + own);
  load_tile(sm.own_b, dout + own);
  load_query_state(sm, o + own, lse + own / kDh, sm.own_b);
  for (int t = 0; t < f; ++t)
    query_frame<kDrop>(sm, acc, k0 + base0 + (size_t)t * kTile, v0 + base0 + (size_t)t * kTile,
                       r0, lane, drop, index_old(g, f, t));
  // the own frame, last
  query_frame<kDrop>(sm, acc, kb + own, vb + own, r0, lane, drop, index_own(g, f));
  store_rows(acc, sm.s, dq + own, r0, lane);
  __syncthreads();  // every warp's rows of p and ds (the own frame's) are written
  zero(acc);
  accumulate_atb(acc, sm.ds, r0, sm.own_a);  // dKb = dS^T Q, the warp's 16 keys
  store_rows(acc, sm.s, dkb + own, r0, lane);
  zero(acc);
  accumulate_atb(acc, sm.p, r0, sm.own_b);   // dVb = W^T dO (W * keep with kDrop)
  store_rows(acc, sm.dp, dvb + own, r0, lane);
}

template <bool kDrop>
int launch_branch_bwd(const void* q, const void* k0, const void* v0, const void* kb,
                      const void* vb, const void* o, const void* dout, const void* lse,
                      void* dq, void* dk0, void* dv0, void* dkb, void* dvb, int g, int bh0,
                      int frames, int qb, Dropout drop, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      branch_bwd_kernel<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  branch_bwd_kernel<kDrop><<<dim3(frames, bh0 + g), kThreads, kSmemBytes,
                             (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k0, (const bf16*)v0, (const bf16*)kb, (const bf16*)vb,
      (const bf16*)o, (const bf16*)dout, (const float*)lse, (bf16*)dq, (bf16*)dk0,
      (bf16*)dv0, (bf16*)dkb, (bf16*)dvb, g, bh0, frames, qb, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on the given stream,
// does not synchronise, and returns cudaGetLastError() of the launch. s0, s1,
// rate, scale: see Dropout (attention_tile.cuh).
extern "C" int branch_attention_bwd(const void* q, const void* k0, const void* v0,
                                    const void* kb, const void* vb, const void* o,
                                    const void* dout, const void* lse, void* dq, void* dk0,
                                    void* dv0, void* dkb, void* dvb, int g, int bh0,
                                    int frames, void* stream) {
  return launch_branch_bwd<false>(q, k0, v0, kb, vb, o, dout, lse, dq, dk0, dv0, dkb, dvb, g,
                                  bh0, frames, 0, Dropout{}, stream);
}

extern "C" int branch_attention_dropout_bwd(const void* q, const void* k0, const void* v0,
                                            const void* kb, const void* vb, const void* o,
                                            const void* dout, const void* lse, void* dq,
                                            void* dk0, void* dv0, void* dkb, void* dvb, int g,
                                            int bh0, int frames, int qb, unsigned s0,
                                            unsigned s1, float rate, float scale,
                                            void* stream) {
  return launch_branch_bwd<true>(q, k0, v0, kb, vb, o, dout, lse, dq, dk0, dv0, dkb, dvb, g,
                                 bh0, frames, qb, Dropout{s0, s1, rate, scale}, stream);
}
