// Block-causal attention backward kernels for Hopper (sm_90a), bf16 in and
// out, built on TMA, mbarriers and wgmma.
//
// B3 block_causal_attention_bwd replaces the Pallas kernel
//    viewformer_tpu/ops/attention_pallas.py:_block_causal_bwd_kernel3 (the
//    backward of stream-0 block-causal attention, kernel B1).
// B6 block_causal_attention_dropout_bwd replaces
//    viewformer_tpu/ops/attention_pallas.py:_block_causal_do_bwd_kernel3 (the
//    backward of B5): the same code with the template flag kDrop set, which
//    regenerates each visited weight's keep factor from the seed words and
//    the weight's global index, as B5 does (attention_tile.cuh; B5's index
//    (bh*TL + query)*TL + key in uint32), so nothing but the seeds is saved.
//
// Math, as the reference's (attention_pallas.py:149-179, 347-378), no
// 1/sqrt(dh) scale:
//   W  = softmax(S), S = Q K^T in f32, recomputed as exp(S - lse) from the
//        forward's per-row f32 log-sum-exp (B1/B5 write it);
//   dP = (dO V^T) * keep (keep = 1 without dropout);   dS = W * (dP - D);
//   dQ = dS K,   dK = dS^T Q,   dV = (W * keep)^T dO,
// with dS and W * keep rounded to bf16 before the three products and f32
// accumulation; every output rounded to bf16 once, at the end. D is the
// reference's rowsum(dP * W), taken as rowsum(dO * O) over the forward's
// bf16 output O (FlashAttention-2): O is the dropped output, so
// rowsum(dO * O) = sum_j W_j keep_j (dO . V_j) = rowsum(W * dP), equal up to
// the rounding of O. A small first kernel (the D pass) writes it for every
// row, on the same stream, before the main kernel.
//
// What bounds it: at the training shape ([768, 1280, 64], T = 20) the
// reference's 5 products of 64 x 64 x 64 a visited (query frame, key frame)
// pair are 4.3e11 FLOP (0.43 ms at 989 TFLOP/s) against ~1 GB of operands
// (0.30 ms at 3.35 TB/s): the tensor cores bound it. This design does 7
// products a pair, not 5: the key CTA that owns the pair's dK/dV and the
// query CTA that owns its dQ each compute S and dP. A single pass would
// need one of the two sums across CTAs, by atomics or a second pass; two
// owners keep the launch free of atomics and deterministic, for 40% more
// tensor-core work, 5.9e11 FLOP (0.60 ms).
// Design:
//  - One launch, two kinds of CTA, each with one owner per output tile, the
//    longest first (a 1-D grid; key and query CTAs of equal length
//    alternate):
//    key CTAs, one per (bh, pair of key frames 2i, 2i+1): each consumer
//      warpgroup holds its K and V frame (TMA, once) and accumulates dK and
//      dV in registers over the query frames t >= its key frame;
//    query CTAs, one per (bh, pair of query frames 2i, 2i+1): each consumer
//      warpgroup holds its Q and dO frame and its rows' lse and D, and
//      accumulates dQ in registers over the key frames <= its query frame.
//  - A producer warp streams the other side's frames through a ring of
//    kStages stages guarded by full/empty mbarriers: 64 x 64 bf16 tiles by
//    TMA with its 128-byte swizzle (Q and dO for a key CTA, K and V for a
//    query CTA) and, for a key CTA, the frame's 64 f32 lse and D values by a
//    1-D bulk copy. Both warpgroups read each stage; one that does not visit
//    a frame (the second skips the pair's first frame) or that has no frame
//    (odd T) still waits for it and releases it, so neither runs a phase
//    ahead.
//  - Every product is a wgmma m64n64k16: S^T = K Q^T and dP^T = V dO^T
//    (key CTA), or S = Q K^T and dP = dO V^T (query CTA), with both operands
//    K-major in shared memory; then dV += (W keep)^T dO and dK += dS^T Q, or
//    dQ += dS K, with A the S/dP accumulator registers packed to bf16 and B
//    read MN-major from the same swizzled tiles.
//  - The softmax gradient and the keep hash run on the accumulator
//    registers: no f32 tile goes through shared memory. In a key CTA the
//    tile is transposed ([key, query]), so lse and D follow the column.
//  - dQ, dK and dV are rounded to bf16 once and stored from the registers.
//  - B6's keep hash is ~11 integer operations a weight, and both owners
//    hash every weight they visit: 1.3e9 hashes a call at the training
//    shape, ~1 ms of the integer pipe (64 lanes a clock an SM). It runs
//    while the frame's S/dP products are in flight, and is still what makes
//    B6 slower than B3 (PERF.md).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "sm90.cuh"

using namespace sm90;
using tile::Dropout;

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
  const float* lse;    // [bh, T * 64]
  const float* delta;  // [bh, T * 64]: D = rowsum(dO * O)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int bh, frames;
  Dropout drop;
};

// What one CTA computes. Consumer c owns frame own0 + c (none if >= T) and
// streams the frames [begin, end): a key CTA visits those >= its frame, a
// query CTA those <= its frame.
struct Plan {
  bool key;
  int row;   // bh
  int own0;  // 2 * pair
  int begin, end;
};

__device__ Plan make_plan(const Params& p) {
  Plan pl;
  const int pairs = (p.frames + 1) / 2;
  const int slot = blockIdx.x / p.bh;  // 2 * (pairs) slots, the longest first
  pl.row = blockIdx.x % p.bh;
  pl.key = slot % 2 == 0;
  const int pair = pl.key ? slot / 2 : pairs - 1 - slot / 2;
  pl.own0 = 2 * pair;
  pl.begin = pl.key ? 2 * pair : 0;
  pl.end = pl.key ? p.frames : min(2 * pair + 2, p.frames);
  return pl;
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

// tile::keep_factor taken apart, so that the 32 keep tests a thread makes a
// frame cost few integer operations and run while the frame's first
// products are in flight. The hash's first step, h = idx * kPrime1 + s0, is
// formed as a frame base plus steps along the fragment's rows and columns;
// the test u >= rate with u = (h' >> 8) / 2^24 (exact in f32) is
// h' >= ceil(rate * 2^24) << 8 on the final hash h', in integers.
constexpr unsigned kPrime1 = 2654435761u;

struct Keep {
  unsigned s0, s1;
  unsigned threshold;  // ceil(rate * 2^24) << 8, or 0 when no weight is kept
  float scale;         // the factor of a kept weight (0 when none is)
  unsigned stride1;    // the row stride of the weight index, times kPrime1
};

__device__ __forceinline__ Keep make_keep(const Dropout& d, unsigned stride) {
  const unsigned n = (unsigned)ceilf(d.rate * 16777216.f);  // rate * 2^24 is exact
  const bool some = n < (1u << 24);
  return Keep{d.s0, d.s1, some ? n << 8 : 0u, some ? d.scale : 0.f, stride * kPrime1};
}

// f[i]: the keep factor (scale or 0) of element i of the thread's
// accumulator fragment, element i lying at column 8(i>>2) + (i&1) and row
// 8((i>>1)&1) from the thread's first; h0 = its first element's index *
// kPrime1 + s0; col1 and row1 = the index steps of a column and a row, times
// kPrime1.
__device__ __forceinline__ void keep_factors(const Keep& k, unsigned h0, unsigned col1,
                                             unsigned row1, float (&f)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    unsigned h =
        h0 + (unsigned)(8 * (i >> 2) + (i & 1)) * col1 + (unsigned)(8 * ((i >> 1) & 1)) * row1;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= (h >> 13) ^ k.s1;
    h *= 3266489917u;
    h ^= h >> 16;
    f[i] = h >= k.threshold ? k.scale : 0.f;
  }
}

// acc += A B with A a packed [64, 64] operand in registers and B a [64, 64]
// tile read MN-major (K steps of 16 rows, 2048 bytes).
__device__ __forceinline__ void accumulate(float (&acc)[32], const uint32_t (&a)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
    wgmma_rs_tb(acc, a + 4 * kk, desc_sw128(b + kk * 16 * kDh * 2));
}

// Key CTA, one query frame into the warpgroup's dK/dV. k_s, v_s: its key
// frame; q_s, do_s: the streamed query frame; lse, d: that frame's 64 values
// in shared memory. Thread t holds s[i] = S^T[r, c] with r (the key) =
// 16(t/32) + (t%32)/4 + 8((i>>1)&1) and c (the query) = 8(i>>2) + 2(t%4) +
// (i&1). index: the global weight index of (query c, key r) is index + c *
// stride + r, stride = TL (keep.stride1 = stride * kPrime1).
template <bool kDrop>
__device__ __forceinline__ void key_step(uint32_t k_s, uint32_t v_s, uint32_t q_s,
                                         uint32_t do_s, const float* lse, const float* d,
                                         float (&dk)[32], float (&dv)[32], const Keep& keep,
                                         unsigned index, unsigned stride) {
  float s[32], dp[32];
  issue_products(s, k_s, q_s, dp, v_s, do_s);  // S^T = K Q^T, dP^T = V dO^T
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  float f[32];
  if (kDrop)
    keep_factors(keep, (index + (unsigned)c0 * stride + (unsigned)r0) * kPrime1 + keep.s0,
                 keep.stride1, kPrime1, f);
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
          dpv *= f[i];
          wk *= f[i];
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

// Query CTA, one key frame into the warpgroup's dQ. q_s, do_s: its query
// frame; k_s, v_s: the streamed key frame; lse2 = lse * log2(e) and d of the
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

// Maps over [bh * T * 64, 64]: q, k, v, dout. A key CTA holds k, v and
// streams q, dout; a query CTA holds q, dout and streams k, v.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t own_s = smem_addr(smem);  // a consumer's (K, V) or (Q, dO)
  const uint32_t ring_s = own_s + 2 * kConsumers * kTileBytes;  // kStages tile pairs
  unsigned char* rows = smem + 2 * (kConsumers + kStages) * kTileBytes;  // kStages (lse, D)
  const uint32_t rows_s = smem_addr(rows);
  const uint32_t bars = rows_s + kStages * 2 * kRowBytes;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const auto ownbar = [&](int c) { return bars + 8 * (2 * kStages + c); };

  const Plan pl = make_plan(p);
  const int tl = p.frames * kRows;
  const int row_base = pl.row * tl;  // first row of this bh in the maps
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
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
        const int f = pl.own0 + c;
        if (f >= p.frames) continue;
        mbar_expect_tx(ownbar(c), 2 * kTileBytes);
        tma_load_2d(own_s + 2 * c * kTileBytes, own_a, ownbar(c), 0, row_base + f * kRows);
        tma_load_2d(own_s + (2 * c + 1) * kTileBytes, own_b, ownbar(c), 0, row_base + f * kRows);
      }
      for (int f = pl.begin; f < pl.end; ++f) {
        const int n = f - pl.begin, stage = n % kStages;
        mbar_wait(empty(stage), ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full(stage), 2 * kTileBytes + (pl.key ? 2 * kRowBytes : 0));
        const uint32_t dst = ring_s + 2 * stage * kTileBytes;
        tma_load_2d(dst, in_a, full(stage), 0, row_base + f * kRows);
        tma_load_2d(dst + kTileBytes, in_b, full(stage), 0, row_base + f * kRows);
        if (pl.key) {
          const long long at = (long long)row_base + f * kRows;
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
  const uint32_t own_a = own_s + 2 * c * kTileBytes, own_b = own_a + kTileBytes;
  const long long own_row = (long long)row_base + f * kRows;
  const unsigned tlu = (unsigned)tl;
  if (active) mbar_wait(ownbar(c), 0);
  const Keep keep = kDrop ? make_keep(p.drop, tlu) : Keep{};
  float acc0[32], acc1[32];  // key CTA: dK, dV; query CTA: dQ, unused
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;

  if (pl.key) {
    for (int s = pl.begin; s < pl.end; ++s) {
      const int n = s - pl.begin, stage = n % kStages;
      mbar_wait(full(stage), (n / kStages) & 1);
      if (active && s >= f) {
        const float* lse = reinterpret_cast<const float*>(rows + 2 * stage * kRowBytes);
        // B5's index of (query frame s, key frame f): (row*TL + s*64 + i)*TL + f*64 + j
        const unsigned index =
            ((unsigned)pl.row * tlu + (unsigned)(s * kRows)) * tlu + (unsigned)(f * kRows);
        key_step<kDrop>(own_a, own_b, ring_s + 2 * stage * kTileBytes,
                        ring_s + (2 * stage + 1) * kTileBytes, lse, lse + kRows, acc0, acc1,
                        keep, index, tlu);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
    }
    if (active) {
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
  for (int s = pl.begin; s < pl.end; ++s) {
    const int n = s - pl.begin, stage = n % kStages;
    mbar_wait(full(stage), (n / kStages) & 1);
    if (active && s <= f) {
      // B5's index of (query frame f, key frame s)
      const unsigned index =
          ((unsigned)pl.row * tlu + (unsigned)(f * kRows)) * tlu + (unsigned)(s * kRows);
      query_step<kDrop>(own_a, own_b, ring_s + 2 * stage * kTileBytes,
                        ring_s + (2 * stage + 1) * kTileBytes, lse2, d, acc0, keep, index, tlu);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
  }
  if (active) store(p.dq, own_row, acc0);
}

template <bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int bh, int frames,
           Dropout drop, void* stream) {
  const long long rows = (long long)bh * frames * kRows;
  const cudaStream_t s = (cudaStream_t)stream;
  delta_kernel<<<(unsigned)((rows * 8 + 255) / 256), 256, 0, s>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int e = tile_map_64x64(&maps[i], bases[i], rows);
    if (e != 0) return e;
  }
  const int smem = 1024 + 2 * (kConsumers + kStages) * kTileBytes + 2 * kStages * kRowBytes +
                   8 * (2 * kStages + kConsumers);
  auto kernel = attention_bwd_kernel<kDrop>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  p.dq = (bf16*)dq;
  p.dk = (bf16*)dk;
  p.dv = (bf16*)dv;
  p.bh = bh;
  p.frames = frames;
  p.drop = drop;
  const int grid = 2 * ((frames + 1) / 2) * bh;
  kernel<<<grid, kThreads, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches the D pass and then
// the main kernel on the given stream, does not synchronise, and returns 0 or
// the CUDA error of a launch (or of building its tensor maps).
// q, k, v, o, dout, dq, dk, dv: [bh, frames * 64, 64] bf16; lse: [bh,
// frames * 64] f32 from the forward; delta: [bh, frames * 64] f32 scratch
// for D. lse and delta 16-byte aligned. s0, s1, rate, scale: see Dropout
// (attention_tile.cuh).
extern "C" int block_causal_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int bh,
                                          int frames, void* stream) {
  return launch<false>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, frames, Dropout{}, stream);
}

extern "C" int block_causal_attention_dropout_bwd(const void* q, const void* k, const void* v,
                                                  const void* o, const void* dout,
                                                  const void* lse, void* delta, void* dq,
                                                  void* dk, void* dv, int bh, int frames,
                                                  unsigned s0, unsigned s1, float rate,
                                                  float scale, void* stream) {
  return launch<true>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, frames,
                      Dropout{s0, s1, rate, scale}, stream);
}
