// Attention backward kernels for Hopper (sm_90a), bf16 in and out, built on
// TMA, mbarriers and wgmma: one template, attention_bwd_kernel<kDrop,
// kBranch>, for the block-causal backward (B3, B6) and the branch backward
// (B4, B8).
//
// B3 block_causal_attention_bwd replaces the Pallas kernel
//    viewformer_tpu/ops/attention_pallas.py:_block_causal_bwd_kernel3 (the
//    backward of stream-0 block-causal attention, kernel B1).
// B6 block_causal_attention_dropout_bwd replaces _block_causal_do_bwd_kernel3
//    (the backward of B5): the same code with the template flag kDrop set,
//    which regenerates each visited weight's keep factor from the seed words
//    and the weight's global index with B5's hash (attention_tile.cuh; B5's
//    index (bh*TL + query)*TL + key in uint32), so nothing but the seeds is
//    saved.
// B4 branch_attention_bwd replaces _branch_bwd_kernel3 together with the
//    sum over branches of dK0/dV0 in _fb_bwd (attention_pallas.py:630-631):
//    the backward of the one-shot branch attention (kernel B2 with
//    first_q_frame = 0, n_old = T), kBranch set. A query of branch row g,
//    frame t sees the K0/V0 frames < t of row g % BH0 and its own frame of
//    Kb/Vb, under one joint softmax, so lse and D cover both key sets.
// B8 branch_attention_dropout_bwd replaces _branch_do_bwd_kernel3 with the
//    sum over branches of _fbd_bwd (:708-709): B4 with kDrop, over B7's
//    index space: rows of stride TL + qb from (g*TL + query)*(TL + qb), a K0
//    frame b at column b*64, the own frame at TL + (t*64 mod qb), qb the
//    Pallas q-tile the host passes.
//
// Math, as the reference's (attention_pallas.py:149-237, 347-473), no
// 1/sqrt(dh) scale:
//   W  = softmax(S), S = Q K^T in f32, recomputed as exp(S - lse) from the
//        forward's per-row f32 log-sum-exp (B1/B2/B5/B7 write it);
//   dP = (dO V^T) * keep (keep = 1 without dropout);   dS = W * (dP - D);
//   dQ = dS K,   dK = dS^T Q,   dV = (W * keep)^T dO,
// over both key sets for B4/B8 (dQ = dS_old K0 + dS_own Kb; dK0 and dV0
// summed over the S branches of a row, in f32; dKb, dVb from the own frame),
// with dS and W * keep rounded to bf16 before the products and f32
// accumulation; every output rounded to bf16 once, at the end. D is the
// reference's rowsum(dP * W), taken as rowsum(dO * O) over the forward's
// bf16 output O (FlashAttention-2): O is the dropped output, so
// rowsum(dO * O) = sum_j W_j keep_j (dO . V_j) = rowsum(W * dP), equal up to
// the rounding of O. A small first kernel (the D pass) writes it for every
// query row, on the same stream, into scratch the wrapper allocates.
//
// What bounds it: the tensor cores. At the training shapes ([768, 1280, 64],
// T = 20; B4/B8 with S = 2 branches, q [1536, 1280, 64]) the reference's 5
// products of 64 x 64 x 64 a visited (query frame, key frame) pair are
// 4.3e11 FLOP for B3 and 8.5e11 for B4 (0.43 and 0.85 ms at 989 TFLOP/s)
// against ~1 and ~2 GB of operands (0.30 and 0.6 ms at 3.35 TB/s). This
// design does 7 products a pair, not 5: the key CTA that owns the pair's
// dK/dV and the query CTA that owns its dQ each compute S and dP. A single
// pass would need one of the two sums across CTAs, by atomics or a second
// pass; two owners keep the launch free of atomics and deterministic, for
// 40% more tensor-core work (B4: 1.2e12 FLOP, 1.2 ms).
// Design:
//  - One launch, two kinds of CTA, each with one owner per output tile, the
//    longest first (a 1-D grid, so no grid dimension limits the rows):
//    key CTAs, one per (K/V row, pair of key frames 2i, 2i+1): each consumer
//      warpgroup holds its K and V frame (TMA, once) and accumulates dK and
//      dV in registers over the query frames that see it: t >= its frame
//      (B3/B6), or t > its frame in each of the S branch rows r + s*BH0 of
//      its K0 row r (B4/B8: up to S*(T-1) frames, the sum over branches in
//      registers);
//    query CTAs, one per (Q row, pair of query frames 2i, 2i+1): each
//      consumer warpgroup holds its Q and dO frame and its rows' lse and D,
//      and accumulates dQ in registers over the key frames <= its frame
//      (B3/B6) or the K0 frames < its frame (B4/B8).
//    B3/B6 alternate key and query CTAs of equal length. B4/B8's key CTAs
//    are up to S times longer than their query CTAs: both kinds are ordered
//    by the products they run (branch_plan), a key frame costing 4, a query
//    frame 3 and an own frame 7.
//  - The own frame (B4/B8). dKb = dS_own^T Q and dVb = (W keep)_own^T dO
//    need the transpose of the query warpgroup's dS and W. The query
//    warpgroup, which also holds the frame's Kb and Vb (loaded with its Q
//    and dO) and its 64 lse and D values in shared memory, runs the own
//    frame in query form into dQ with the K0 frames, stores dQ, and then
//    recomputes the own frame in key form (S^T = Kb Q^T, dP^T = Vb dO^T, lse
//    and D by column, as a key CTA's step) into dKb and dVb: route (b) of
//    the two, chosen over passing the bf16 dS and W * keep through shared
//    memory as a transposed operand. Two extra products a frame (T of the
//    T(T+1)/2 pairs of a row: ~3% at T = 20); every product is one of the
//    two wgmma forms below, and the key form runs when dQ no longer holds
//    registers, so a warpgroup never holds more than a key CTA's four
//    accumulators. With 288 threads a CTA the card gives a thread at most
//    168 registers (three warps share one of the SM's four register files),
//    so B8's own key form hashes each keep factor as the softmax gradient
//    reaches it instead of holding all 32 while the products run.
//  - A producer warp streams the other side's frames through a ring of
//    kStages stages guarded by full/empty mbarriers: 64 x 64 bf16 tiles by
//    TMA with its 128-byte swizzle (Q and dO for a key CTA, K and V for a
//    query CTA) and, for a key CTA, the frame's 64 f32 lse and D values by a
//    1-D bulk copy. Both warpgroups read each stage; one that does not visit
//    a frame (the second skips the pair's first frame) or that has no frame
//    (odd T) still waits for it and releases it, so neither runs a phase
//    ahead. A key warpgroup with nothing to stream (K0 frame T-1, or T = 1)
//    still stores its zero dK0/dV0: the outputs come from torch.empty.
//  - Every product is a wgmma m64n64k16: S^T = K Q^T and dP^T = V dO^T
//    (key form), or S = Q K^T and dP = dO V^T (query form), with both
//    operands K-major in shared memory; then dV += (W keep)^T dO and
//    dK += dS^T Q, or dQ += dS K, with A the S/dP accumulator registers
//    packed to bf16 and B read MN-major from the same swizzled tiles.
//  - The softmax gradient and the keep hash run on the accumulator
//    registers: no f32 tile goes through shared memory. In key form the
//    tile is transposed ([key, query]), so lse and D follow the column.
//  - Every output is rounded to bf16 once and stored from the registers.
//  - The keep hash is ~11 integer operations a weight, and both owners hash
//    every weight they visit: 1.3e9 hashes a call for B6 and 2.7e9 for B8 at
//    the training shapes, ~1 and ~2 ms of the integer pipe (64 lanes a clock
//    an SM). It runs while the frame's S/dP products are in flight, and is
//    still what makes B6 and B8 slower than B3 and B4 (PERF.md).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "sm90.cuh"

typedef __nv_bfloat16 bf16;
using namespace sm90;
using tile::Dropout;
using tile::Keep;
using tile::keep_at;
using tile::keep_factors;
using tile::kPrime1;
using tile::make_keep;

namespace {

constexpr int kRows = 64;                    // tokens a frame (L)
constexpr int kDh = 64;                      // head width
constexpr int kTileBytes = kRows * kDh * 2;  // one bf16 frame tile
constexpr int kRowBytes = kRows * 4;         // one frame's f32 lse (or D) values
constexpr int kStages = 4;                   // ring depth
constexpr int kConsumers = 2;                // consumer warpgroups a CTA
constexpr int kThreads = kConsumers * 128 + 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* lse;    // [rows, T * 64]
  const float* delta;  // [rows, T * 64]: D = rowsum(dO * O)
  bf16* dq;
  bf16* dk;   // dK, or dK0 (B4/B8)
  bf16* dv;   // dV, or dV0
  bf16* dkb;  // B4/B8: the own frames' dKb, dVb
  bf16* dvb;
  int bh;        // rows of K and V: B, or BH0
  int rows;      // rows of Q: bh, or G = S * BH0 (B4/B8)
  int frames;
  unsigned stride;  // the row stride of the weight index: TL, or TL + qb (B7's)
  int qb;           // B8: the Pallas q-tile of B7's index space
  Dropout drop;
};

// What one CTA computes. Consumer c owns frame own0 + c (none if >= T) of
// row `row` (of K/V for a key CTA, of Q for a query CTA) and streams
// `stages` frames of the other side: frames first, first + 1, ... of row
// in_row and, past the last frame, again from first in row in_row + bh (a
// B4/B8 key CTA's next branch row).
struct Plan {
  bool key;
  int row;
  int own0;  // 2 * pair
  int in_row, first, stages;
};

// B3/B6: 2 * pairs slots of bh CTAs, key and query slots alternating, the
// longest first.
__device__ Plan block_causal_plan(const Params& p) {
  Plan pl;
  const int pairs = (p.frames + 1) / 2;
  const int slot = blockIdx.x / p.bh;
  pl.row = blockIdx.x % p.bh;
  pl.key = slot % 2 == 0;
  const int pair = pl.key ? slot / 2 : pairs - 1 - slot / 2;
  pl.own0 = 2 * pair;
  pl.in_row = pl.row;
  pl.first = pl.key ? 2 * pair : 0;
  pl.stages = (pl.key ? p.frames : min(2 * pair + 2, p.frames)) - pl.first;
  return pl;
}

// The products (64 x 64 x 64) a B4/B8 CTA runs: a key frame visit costs 4
// (S^T, dP^T, dV, dK), a query frame visit 3 (S, dP, dQ) and an own frame 7
// (its key form and its query form).
__device__ __forceinline__ int key_cost(int pair, int frames, int branches) {
  const int f = 2 * pair;
  return 4 * branches * (frames - 1 - f + max(frames - 2 - f, 0));
}

__device__ __forceinline__ int query_cost(int pair, int frames) {
  const int f = 2 * pair;
  return 3 * f + 7 + (f + 1 < frames ? 3 * (f + 1) + 7 : 0);
}

// B4/B8: key classes (bh CTAs each, pair j ascending) and query classes
// (rows CTAs each, pair i descending) are each ordered by cost already; the
// grid walks their merge, the costlier class first.
__device__ Plan branch_plan(const Params& p) {
  const int pairs = (p.frames + 1) / 2, branches = p.rows / p.bh;
  int j = 0, i = pairs - 1;
  unsigned first = 0;
  for (;;) {
    const bool key = j < pairs && (i < 0 || key_cost(j, p.frames, branches) >=
                                                 query_cost(i, p.frames));
    const unsigned size = key ? p.bh : p.rows;
    if (blockIdx.x < first + size) {
      Plan pl;
      pl.key = key;
      pl.row = (int)(blockIdx.x - first);
      pl.own0 = 2 * (key ? j : i);
      // a key CTA streams the query frames after its first frame of each
      // branch row in turn; a query CTA the K0 frames below its second frame
      // (its first frame's, when it has no second)
      pl.in_row = key ? pl.row : pl.row % p.bh;
      pl.first = key ? pl.own0 + 1 : 0;
      pl.stages = key ? branches * (p.frames - pl.first) : min(pl.own0 + 1, p.frames - 1);
      return pl;
    }
    first += size;
    if (key)
      ++j;
    else
      --i;
  }
}

// The bf16 pairs of an accumulator as a wgmma A operand: the accumulator's
// columns 16kk..16kk+15 are acc[8kk..8kk+7], already in the A fragment's
// order (rows r, r + 8).
__device__ __forceinline__ void pack(const float (&acc)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_bfloat162 pair = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&pair);
  }
}

// Issues x = A B^T and y = C D^T over one frame, all four tiles K-major in
// shared memory; wait_products waits for them. In between the warpgroup may
// compute anything that does not touch x and y.
__device__ __forceinline__ void issue_products(float (&x)[32], uint32_t a, uint32_t b,
                                               float (&y)[32], uint32_t c, uint32_t d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.f;
  fence_regs(x);
  fence_regs(y);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_ss(x, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32), kk);
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_ss(y, desc_sw128(c + kk * 32), desc_sw128(d + kk * 32), kk);
  wgmma_commit();
}

__device__ __forceinline__ void wait_products(float (&x)[32], float (&y)[32]) {
  wgmma_wait_all();
  fence_regs(x);
  fence_regs(y);
}

// acc += A B with A a packed [64, 64] operand in registers and B a [64, 64]
// tile read MN-major (K steps of 16 rows, 2048 bytes).
__device__ __forceinline__ void accumulate(float (&acc)[32], const uint32_t (&a)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
    wgmma_rs_tb(acc, a + 4 * kk, desc_sw128(b + kk * 16 * kDh * 2));
}

// Key form, one query frame into the warpgroup's dK/dV (a key CTA's streamed
// frame, or a B4/B8 query CTA's own frame with its Kb/Vb as the key frame).
// k_s, v_s: the key frame; q_s, do_s: the query frame; lse, d: that frame's
// 64 values in shared memory. Thread t holds s[i] = S^T[r, c] with r (the
// key) = 16(t/32) + (t%32)/4 + 8((i>>1)&1) and c (the query) = 8(i>>2) +
// 2(t%4) + (i&1). index: the global weight index of (query c, key r) is
// index + c * stride + r, stride = TL or TL + qb (keep.stride1 = stride *
// kPrime1). kEarlyHash: hash the frame's 32 keep factors a thread while its
// S/dP products are in flight (32 more registers), or each one as the
// softmax gradient reaches it (the own frame's key form, which runs once a
// frame on a warpgroup short of registers).
template <bool kDrop, bool kEarlyHash = true>
__device__ __forceinline__ void key_step(uint32_t k_s, uint32_t v_s, uint32_t q_s,
                                         uint32_t do_s, const float* lse, const float* d,
                                         float (&dk)[32], float (&dv)[32], const Keep& keep,
                                         unsigned index, unsigned stride) {
  float s[32], dp[32];
  issue_products(s, k_s, q_s, dp, v_s, do_s);  // S^T = K Q^T, dP^T = V dO^T
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const unsigned h0 = (index + (unsigned)c0 * stride + (unsigned)r0) * kPrime1 + keep.s0;
  float f[32];
  if (kDrop && kEarlyHash) keep_factors(keep, h0, keep.stride1, kPrime1, f);
  wait_products(s, dp);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + c0);
    const float2 dd = *reinterpret_cast<const float2*>(d + 8 * j + c0);
    const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const float w = exp2f(fmaf(s[i], kLog2e, -l2[e]));
        float dpv = dp[i], wk = w;
        if (kDrop) {
          const float fi = kEarlyHash ? f[i] : keep_at(keep, h0, keep.stride1, kPrime1, i);
          dpv *= fi;
          wk *= fi;
        }
        dp[i] = w * (dpv - (e ? dd.y : dd.x));  // dS^T
        s[i] = wk;                              // (W keep)^T
      }
    }
  }
  uint32_t a_w[16], a_ds[16];
  pack(s, a_w);
  pack(dp, a_ds);
  fence_regs(a_w);
  fence_regs(a_ds);
  fence_regs(dv);
  fence_regs(dk);
  wgmma_fence();
  accumulate(dv, a_w, do_s);  // dV += (W keep)^T dO
  accumulate(dk, a_ds, q_s);  // dK += dS^T Q
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(dv);
  fence_regs(dk);
}

// Query form, one key frame into the warpgroup's dQ. q_s, do_s: its query
// frame; k_s, v_s: the key frame; lse2 = lse * log2(e) and d of the
// thread's rows r0 and r0 + 8. The global weight index of (query r, key c)
// is index + r * stride + c.
template <bool kDrop>
__device__ __forceinline__ void query_step(uint32_t q_s, uint32_t do_s, uint32_t k_s,
                                           uint32_t v_s, const float (&lse2)[2],
                                           const float (&d)[2], float (&dq)[32],
                                           const Keep& keep, unsigned index, unsigned stride) {
  float s[32], dp[32];
  issue_products(s, q_s, k_s, dp, do_s, v_s);  // S = Q K^T, dP = dO V^T
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  float f[32];
  if (kDrop)
    keep_factors(keep, (index + (unsigned)r0 * stride + (unsigned)c0) * kPrime1 + keep.s0,
                 kPrime1, keep.stride1, f);
  wait_products(s, dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float w = exp2f(fmaf(s[i], kLog2e, -lse2[h]));
    float dpv = dp[i];
    if (kDrop) dpv *= f[i];
    dp[i] = w * (dpv - d[h]);  // dS
  }
  uint32_t a_ds[16];
  pack(dp, a_ds);
  fence_regs(a_ds);
  fence_regs(dq);
  wgmma_fence();
  accumulate(dq, a_ds, k_s);  // dQ += dS K
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(dq);
}

// The warpgroup's [64, 64] f32 accumulator, rounded to bf16, into rows
// row0.. of out.
__device__ __forceinline__ void store(bf16* out, long long row0, const float (&acc)[32]) {
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long at = (row0 + r + 8 * h) * kDh + 8 * j + col;
      *reinterpret_cast<__nv_bfloat162*>(out + at) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// D[r] = sum_d dO[r, d] O[r, d] in f32 for every row: 8 lanes a row, 16
// bytes of each operand a lane.
__global__ void __launch_bounds__(256) delta_kernel(const bf16* __restrict__ o,
                                                    const bf16* __restrict__ dout,
                                                    float* __restrict__ delta, long long rows) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = id / 8;
  const int part = (int)(id % 8);
  float sum = 0.f;
  if (r < rows) {
    const uint4 a = reinterpret_cast<const uint4*>(o + r * kDh)[part];
    const uint4 b = reinterpret_cast<const uint4*>(dout + r * kDh)[part];
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(pa[i]), y = __bfloat1622float2(pb[i]);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (r < rows && part == 0) delta[r] = sum;
}

// Shared memory a launch needs: the own tiles of both consumers (K, V or
// Q, dO; for a B4/B8 query CTA also Kb, Vb), the ring of tile pairs, the
// ring's (lse, D) rows and, for B4/B8, each consumer's own (lse, D) rows,
// the barriers, and 1024 bytes to align the tiles.
template <bool kBranch>
__host__ __device__ constexpr int own_tiles() {
  return kBranch ? 4 : 2;
}

template <bool kBranch>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + (kConsumers * own_tiles<kBranch>() + 2 * kStages) * kTileBytes +
         2 * (kStages + (kBranch ? kConsumers : 0)) * kRowBytes + 8 * (2 * kStages + kConsumers);
}

// Maps over [rows * T * 64, 64]: q, dout, kb, vb; over [bh * T * 64, 64]: k,
// v (B3/B6: kb, vb are k, v and not read). A key CTA holds k, v and streams
// q, dout; a query CTA holds q, dout (B4/B8: and kb, vb) and streams k, v.
template <bool kDrop, bool kBranch>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_kb,
                         const __grid_constant__ CUtensorMap tm_vb, const Params p) {
  constexpr int kOwn = own_tiles<kBranch>();
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t own_s = smem_addr(smem);  // kOwn tiles a consumer
  const uint32_t ring_s = own_s + kOwn * kConsumers * kTileBytes;  // kStages tile pairs
  // kStages (lse, D) rows, then (B4/B8) a consumer's own (lse, D) rows
  unsigned char* rows = smem + (kOwn * kConsumers + 2 * kStages) * kTileBytes;
  const uint32_t rows_s = smem_addr(rows);
  const uint32_t own_rows_s = rows_s + kStages * 2 * kRowBytes;
  const uint32_t bars = own_rows_s + (kBranch ? kConsumers * 2 * kRowBytes : 0);
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const auto ownbar = [&](int c) { return bars + 8 * (2 * kStages + c); };

  const Plan pl = kBranch ? branch_plan(p) : block_causal_plan(p);
  const int tl = p.frames * kRows;
  const int row_base = pl.row * tl;  // first row of this CTA's own row in the maps
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrival a consumer warp
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(ownbar(c), 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // producer warp: one lane issues every load
    if (lane == 0) {
      const CUtensorMap* own_a = pl.key ? &tm_k : &tm_q;
      const CUtensorMap* own_b = pl.key ? &tm_v : &tm_do;
      const CUtensorMap* in_a = pl.key ? &tm_q : &tm_k;
      const CUtensorMap* in_b = pl.key ? &tm_do : &tm_v;
      const bool own_kv = kBranch && !pl.key;  // a B4/B8 query CTA's Kb, Vb, lse, D
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
        const int f = pl.own0 + c;
        if (f >= p.frames) continue;
        const int at = row_base + f * kRows;
        const uint32_t dst = own_s + kOwn * c * kTileBytes;
        mbar_expect_tx(ownbar(c), own_kv ? 4 * kTileBytes + 2 * kRowBytes : 2 * kTileBytes);
        tma_load_2d(dst, own_a, ownbar(c), 0, at);
        tma_load_2d(dst + kTileBytes, own_b, ownbar(c), 0, at);
        if (own_kv) {
          tma_load_2d(dst + 2 * kTileBytes, &tm_kb, ownbar(c), 0, at);
          tma_load_2d(dst + 3 * kTileBytes, &tm_vb, ownbar(c), 0, at);
          const uint32_t r = own_rows_s + 2 * c * kRowBytes;
          bulk_load(r, p.lse + at, kRowBytes, ownbar(c));
          bulk_load(r + kRowBytes, p.delta + at, kRowBytes, ownbar(c));
        }
      }
      for (int n = 0, g = pl.in_row, s = pl.first; n < pl.stages; ++n) {
        const int stage = n % kStages;
        const int at = g * tl + s * kRows;
        if (++s == p.frames) {  // the stream's next row (see Plan)
          s = pl.first;
          g += p.bh;
        }
        mbar_wait(empty(stage), ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full(stage), 2 * kTileBytes + (pl.key ? 2 * kRowBytes : 0));
        const uint32_t dst = ring_s + 2 * stage * kTileBytes;
        tma_load_2d(dst, in_a, full(stage), 0, at);
        tma_load_2d(dst + kTileBytes, in_b, full(stage), 0, at);
        if (pl.key) {
          bulk_load(rows_s + 2 * stage * kRowBytes, p.lse + at, kRowBytes, full(stage));
          bulk_load(rows_s + (2 * stage + 1) * kRowBytes, p.delta + at, kRowBytes, full(stage));
        }
      }
    }
    __syncwarp();
    return;
  }

  // consumer warpgroup c
  const int c = warp / 4, t = threadIdx.x % 128;
  const int f = pl.own0 + c;
  const bool active = f < p.frames;
  const uint32_t own_a = own_s + kOwn * c * kTileBytes, own_b = own_a + kTileBytes;
  const long long own_row = (long long)row_base + f * kRows;
  const unsigned tlu = (unsigned)tl;
  if (active) mbar_wait(ownbar(c), 0);
  const Keep keep = kDrop ? make_keep(p.drop, p.stride) : Keep{};
  float acc0[32], acc1[32];  // key CTA: dK, dV; query CTA: dQ, unused
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;

  if (pl.key) {
    // the streamed frame, as the producer steps it: query frame s of row g
    int g = pl.in_row, s = pl.first;
    for (int n = 0; n < pl.stages; ++n) {
      const int stage = n % kStages;
      mbar_wait(full(stage), (n / kStages) & 1);
      if (active && (kBranch ? s > f : s >= f)) {
        const float* lse = reinterpret_cast<const float*>(rows + 2 * stage * kRowBytes);
        // the index of (query frame s of row g, key frame f): B5's
        // (g*TL + s*64 + i)*TL + f*64 + j, or B7's with stride TL + qb
        const unsigned index =
            ((unsigned)g * tlu + (unsigned)(s * kRows)) * p.stride + (unsigned)(f * kRows);
        key_step<kDrop>(own_a, own_b, ring_s + 2 * stage * kTileBytes,
                        ring_s + (2 * stage + 1) * kTileBytes, lse, lse + kRows, acc0, acc1,
                        keep, index, p.stride);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
      if (++s == p.frames) {
        s = pl.first;
        g += p.bh;
      }
    }
    if (active) {  // also a warpgroup that streamed nothing: its zeros
      store(p.dk, own_row, acc0);
      store(p.dv, own_row, acc1);
    }
    return;
  }

  float lse2[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  if (active) {
    const long long r = own_row + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = p.lse[r + 8 * h] * kLog2e;
      d[h] = p.delta[r + 8 * h];
    }
  }
  // B4/B8: B7's index of (query frame f of this row, its own keys)
  const auto own_index = [&] {
    return ((unsigned)pl.row * tlu + (unsigned)(f * kRows)) * p.stride + tlu +
           (kDrop ? (unsigned)(f * kRows % p.qb) : 0u);
  };
  if (kBranch && active)  // the own frame's share of dQ
    query_step<kDrop>(own_a, own_b, own_a + 2 * kTileBytes, own_a + 3 * kTileBytes, lse2, d,
                      acc0, keep, own_index(), p.stride);
  for (int n = 0; n < pl.stages; ++n) {
    const int stage = n % kStages;
    const int s = n;  // the key frame: query CTAs stream from frame 0
    mbar_wait(full(stage), (n / kStages) & 1);
    if (active && (kBranch ? s < f : s <= f)) {
      // the index of (query frame f of this row, key frame s)
      const unsigned index =
          ((unsigned)pl.row * tlu + (unsigned)(f * kRows)) * p.stride + (unsigned)(s * kRows);
      query_step<kDrop>(own_a, own_b, ring_s + 2 * stage * kTileBytes,
                        ring_s + (2 * stage + 1) * kTileBytes, lse2, d, acc0, keep, index,
                        p.stride);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
  }
  if (!active) return;
  store(p.dq, own_row, acc0);
  if (kBranch) {
    // dKb, dVb: the own frame again, in key form, once dQ is out of the
    // registers (its lse and D by column from shared memory)
    const float* own_lse = reinterpret_cast<const float*>(rows + (kStages + c) * 2 * kRowBytes);
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    key_step<kDrop, false>(own_a + 2 * kTileBytes, own_a + 3 * kTileBytes, own_a, own_b, own_lse,
                           own_lse + kRows, dk, dv, keep, own_index(), p.stride);
    store(p.dkb, own_row, dk);
    store(p.dvb, own_row, dv);
  }
}

// The operands of one launch: q, o, dout, dq (and kb, vb, dkb, dvb) [rows,
// frames * 64, 64] bf16; k, v, dk, dv [bh, frames * 64, 64] bf16 (B4/B8: K0,
// V0, dK0, dV0); lse [rows, frames * 64] f32 from the forward; delta the
// same shape, scratch for D. lse and delta 16-byte aligned.
struct Operands {
  const void *q, *k, *v, *kb, *vb, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv, *dkb, *dvb;
};

template <bool kDrop, bool kBranch>
int launch(const Operands& a, int rows, int bh, int frames, int qb, Dropout drop,
           void* stream) {
  const long long q_rows = (long long)rows * frames * kRows;
  const long long kv_rows = (long long)bh * frames * kRows;
  const cudaStream_t s = (cudaStream_t)stream;
  delta_kernel<<<(unsigned)((q_rows * 8 + 255) / 256), 256, 0, s>>>(
      (const bf16*)a.o, (const bf16*)a.dout, (float*)a.delta, q_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap maps[6];
  const void* bases[6] = {a.q, a.k, a.v, a.dout, a.kb, a.vb};
  const long long extents[6] = {q_rows, kv_rows, kv_rows, q_rows, kBranch ? q_rows : kv_rows,
                                kBranch ? q_rows : kv_rows};
  for (int i = 0; i < 6; ++i) {
    const int e = tile_map_64x64(&maps[i], bases[i], extents[i]);
    if (e != 0) return e;
  }
  constexpr int smem = smem_bytes<kBranch>();
  auto kernel = attention_bwd_kernel<kDrop, kBranch>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.lse = (const float*)a.lse;
  p.delta = (const float*)a.delta;
  p.dq = (bf16*)a.dq;
  p.dk = (bf16*)a.dk;
  p.dv = (bf16*)a.dv;
  p.dkb = (bf16*)a.dkb;
  p.dvb = (bf16*)a.dvb;
  p.bh = bh;
  p.rows = rows;
  p.frames = frames;
  p.stride = (unsigned)(frames * kRows + qb);
  p.qb = qb;
  p.drop = drop;
  const int pairs = (frames + 1) / 2;
  const unsigned grid = (unsigned)pairs * (unsigned)(kBranch ? bh + rows : 2 * bh);
  kernel<<<grid, kThreads, smem, s>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches the D pass and then
// the main kernel on the given stream, does not synchronise, and returns 0 or
// the CUDA error of a launch (or of building its tensor maps). s0, s1, rate,
// scale: see Dropout (attention_tile.cuh).
// B3/B6: q, k, v, o, dout, dq, dk, dv: [bh, frames * 64, 64] bf16; lse: [bh,
// frames * 64] f32 from the forward; delta: [bh, frames * 64] f32 scratch for
// D. lse and delta 16-byte aligned.
extern "C" int block_causal_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int bh,
                                          int frames, void* stream) {
  return launch<false, false>(Operands{q, k, v, k, v, o, dout, lse, delta, dq, dk, dv, nullptr,
                                       nullptr},
                              bh, bh, frames, 0, Dropout{}, stream);
}

extern "C" int block_causal_attention_dropout_bwd(const void* q, const void* k, const void* v,
                                                  const void* o, const void* dout,
                                                  const void* lse, void* delta, void* dq,
                                                  void* dk, void* dv, int bh, int frames,
                                                  unsigned s0, unsigned s1, float rate,
                                                  float scale, void* stream) {
  return launch<true, false>(Operands{q, k, v, k, v, o, dout, lse, delta, dq, dk, dv, nullptr,
                                      nullptr},
                             bh, bh, frames, 0, Dropout{s0, s1, rate, scale}, stream);
}

// B4/B8: q, kb, vb, o, dout, dq, dkb, dvb: [g, frames * 64, 64] bf16; k0, v0,
// dk0, dv0: [bh0, frames * 64, 64] bf16, shared by the g / bh0 branches
// (branch row g reads row g % bh0; dk0/dv0 summed over them); lse: [g,
// frames * 64] f32 from the forward; delta: the same shape, scratch for D.
// qb: the Pallas q-tile of B7's index space (pick_q_block).
extern "C" int branch_attention_bwd(const void* q, const void* k0, const void* v0,
                                    const void* kb, const void* vb, const void* o,
                                    const void* dout, const void* lse, void* delta, void* dq,
                                    void* dk0, void* dv0, void* dkb, void* dvb, int g, int bh0,
                                    int frames, void* stream) {
  return launch<false, true>(Operands{q, k0, v0, kb, vb, o, dout, lse, delta, dq, dk0, dv0, dkb,
                                      dvb},
                             g, bh0, frames, 0, Dropout{}, stream);
}

extern "C" int branch_attention_dropout_bwd(const void* q, const void* k0, const void* v0,
                                            const void* kb, const void* vb, const void* o,
                                            const void* dout, const void* lse, void* delta,
                                            void* dq, void* dk0, void* dv0, void* dkb,
                                            void* dvb, int g, int bh0, int frames, int qb,
                                            unsigned s0, unsigned s1, float rate, float scale,
                                            void* stream) {
  return launch<true, true>(Operands{q, k0, v0, kb, vb, o, dout, lse, delta, dq, dk0, dv0, dkb,
                                     dvb},
                            g, bh0, frames, qb, Dropout{s0, s1, rate, scale}, stream);
}
