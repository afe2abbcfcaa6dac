// Branching block attention forward kernels for Hopper (sm_90a), bf16 in and
// out, built on TMA, mbarriers and wgmma: one template,
// attention_fwd_kernel<NC, kDrop>, for the four forward kernels.
//
// B1 block_causal_attention_fwd replaces the Pallas kernel
//    viewformer_tpu/ops/attention_pallas.py:_block_causal_kernel3 (stream-0
//    attention: a query in frame t attends every key of frames <= t).
// B2 branch_attention_fwd replaces
//    viewformer_tpu/ops/attention_pallas.py:_branch_kernel3 (side-stream
//    attention: stream-0 keys of frames < min(t, n_old) plus the query's own
//    frame in its own stream, one joint softmax). With one query frame over a
//    KV cache it also replaces the dense _attend_cache of
//    viewformer_tpu/models/migt_incremental.py.
// B5 block_causal_attention_dropout_fwd replaces _block_causal_do_kernel3:
//    B1 with the template flag kDrop set, inverted dropout on the softmax
//    weights.
// B7 branch_attention_dropout_fwd replaces _branch_do_kernel3: B2's one-shot
//    form (first_q_frame = 0, n_old = T) with kDrop.
//
// Conventions kept from the reference: no 1/sqrt(dh) scale, f32 scores and
// softmax, the (unnormalised) softmax weights rounded to bf16 before the
// product with V, f32 accumulation. With a non-null lse pointer each query
// row's f32 log-sum-exp lse = m + log(l), in natural log, is written for the
// backward kernels (B3, B4, B6 and B8 in attention_bwd_sm90.cu), which
// recompute the weights from it.
//
// Dropout (kDrop). Each weight's keep test is hashed in the kernel from the
// two seed words and the weight's global index (attention_tile.cuh, the hash
// B6 and B8 regenerate the mask with). The index spaces are the Pallas
// kernels': B5 (bh*TL + query)*TL + key over global rows and columns; B7
// (g*TL + query)*(TL + qb) + key for a K0 key, g the branch row, and
// (g*TL + query)*(TL + qb) + TL + (t*64 mod qb) + j for key j of the own
// frame t, qb being the Pallas q-tile (_pick_q_block), which the host passes.
// The exponentials and the row sums l stay the undropped ones, so the
// log-sum-exp is B1's and B2's; only the bf16 numerator packed into P becomes
// e * scale or 0. The port normalises by l at the end, where the reference
// divides before the keep product; the two differ by bf16 rounding.
//
// What bounds them: at the main path's shapes each (query frame, key frame)
// pair is 1 MFLOP on 16 KB of K/V, so B1 and B2's one-shot form are bound by
// the tensor cores (~1e11 FLOP a call) and B2's cache form (one query frame
// over up to 19 cached frames) by the bytes of the cache (0.13 GB a call).
// B5 and B7 add ~11 integer operations a visited weight for the hash: 0.66e9
// and 1.3e9 weights a call at the training shapes, ~0.5 and ~1 ms of the
// integer pipe if none of it overlapped the products (on the H100 they took
// ~0.4 and ~0.7 ms more than B1 and B2: PERF.md).
// Design:
//  - A frame of keys or values is one 64 x 64 bf16 tile (8 KB) that TMA
//    loads with its 128-byte swizzle, which the wgmma descriptors read
//    without bank conflicts. A producer warp keeps the K/V frames of a CTA
//    in flight through a ring of kStages stages guarded by full/empty
//    mbarriers; each consumer warpgroup owns one 64-row query tile and runs
//    S = Q K^T (wgmma, both operands in shared memory), an online softmax on
//    the accumulator registers (quad shuffles for the row max; exp2 with
//    log2(e) folded in) and O += P V with P taken from the S accumulator
//    registers as the A operand and V read transposed.
//  - kDrop: a thread hashes each of its 32 keep tests of a frame as it packs
//    that element of P, from one hash base a thread (the seed words, the
//    threshold and the index stride are read from the kernel parameters, so
//    they hold no registers). At two CTAs an SM (18 warps) ptxas gives a
//    thread 96 registers, and B1's instantiation already uses 94: 32 keep
//    factors could not be held, and hashing while S = Q K^T is in flight
//    (into a 32-bit mask) measured slower on the H100 and spilled, as the
//    other warpgroups fill the issue slots that the product leaves. The
//    query row waits for the output in shared memory, one register short.
//    One CTA an SM would give 168 registers but measured ~10% slower.
//  - Masked frames are skipped, which is exact: every query row attends at
//    least its own frame, so the reference's -1e9 scores contribute
//    exp(-1e9 - m) = 0 in f32. Within a visited frame no key is masked.
//  - B1/B5: one CTA per (bh, pair of query frames 2j, 2j+1), two consumer
//    warpgroups over one K/V stream of frames 0..2j+1 (the first skips frame
//    2j+1; the second idles at odd T's last pair); the pairs with the most
//    frames are issued first.
//  - B2/B7 one-shot: one CTA per (K0 row r, query frame t, group of two
//    branches): the branches g = s * BH0 + r share K0/V0 row r, so they share
//    one stream of its frames; each warpgroup first folds in its own Kb/Vb
//    frame. With one branch (S = 1) a CTA has one consumer warpgroup.
//  - B2's cache form (one query frame, G = BH0) runs one CTA (one consumer
//    warpgroup) a row; at the serving shape (B*H = 384 rows) three CTAs an SM
//    fill the card.
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
using tile::keep_test;
using tile::kPrime1;
using tile::make_keep;

namespace {

constexpr int kRows = 64;                     // tokens a frame (L), query rows a tile
constexpr int kDh = 64;                       // head width
constexpr int kTileBytes = kRows * kDh * 2;   // one bf16 frame tile
constexpr int kStages = 3;                    // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

enum Form { kBlockCausal = 0, kBranch = 1 };

struct Params {
  bf16* out;
  float* lse;          // or null
  int form;
  int rows;            // B1: BH; B2: G
  int frames;          // B1: T; B2: query frames TQ
  int bh0, old_frames, first_q_frame, n_old;  // B2
  int groups;          // B2: groups of NC branches a K0 row
  // B5/B7: the seed words, the keep threshold and factor, and the row stride
  // of the weight index (TL or TL + qb) times kPrime1; read from the
  // parameter space, so that the hash holds no registers for them
  Keep keep;
  int qb;              // B7: the Pallas q-tile of its index space
};

// What one CTA computes: the K/V frames [0, f_end) at rows kv_row0 + 64 f of
// the K/V maps, read by up to NC consumer warpgroups. Consumer c owns the
// query tile at row q_row[c] (-1: idle), reads the frames below f_limit[c],
// and with own[c] also the own frame of kb/vb at row q_row[c].
template <int NC>
struct Plan {
  int kv_row0, f_end;
  int q_row[NC];
  int f_limit[NC];
  bool own[NC];
};

template <int NC>
__device__ Plan<NC> make_plan(const Params& p) {
  Plan<NC> pl;
  const int idx = blockIdx.x;
  if (p.form == kBlockCausal) {
    const int pairs = (p.frames + 1) / 2;
    const int pair = pairs - 1 - idx / p.rows;  // the most key frames first
    const int bh = idx % p.rows, tl = p.frames * kRows;
    pl.kv_row0 = bh * tl;
    pl.f_end = min(2 * pair + 2, p.frames);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int t = 2 * pair + c;
      pl.q_row[c] = t < p.frames ? bh * tl + t * kRows : -1;
      pl.f_limit[c] = t + 1;
      pl.own[c] = false;
    }
  } else {  // kBranch
    const int per_frame = p.bh0 * p.groups;
    const int tq = p.frames - 1 - idx / per_frame;  // the most key frames first
    const int r = idx % per_frame % p.bh0, z = idx % per_frame / p.bh0;
    const int n_prev = min(p.first_q_frame + tq, p.n_old);
    const int branches = p.rows / p.bh0;
    pl.kv_row0 = r * p.old_frames * kRows;
    pl.f_end = n_prev;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int s = z * NC + c;
      pl.q_row[c] = s < branches ? ((s * p.bh0 + r) * p.frames + tq) * kRows : -1;
      pl.f_limit[c] = n_prev;
      pl.own[c] = true;
    }
  }
  return pl;
}

// Online-softmax state of one consumer thread: its two rows r and r + 8.
struct RowState {
  float o[32];   // unnormalised output, wgmma accumulator layout
  float m[2];    // running row max (raw scores)
  float l[2];    // this thread's part of the running row sum
};

// Fold one frame of keys (k_s) and values (v_s) into the warpgroup's 64 rows.
// kDrop: h0 is the hash's first step, index * kPrime1 + s0, of the thread's
// first accumulator element (its row r, column 2(t%4) of the frame).
template <bool kDrop>
__device__ __forceinline__ void attend(uint32_t q_s, uint32_t k_s, uint32_t v_s, RowState& st,
                                       const Keep& keep, unsigned h0) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_ss(s, desc_sw128(q_s + kk * 32), desc_sw128(k_s + kk * 32), kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  // row max over the quad of lanes that share a row
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float scale[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    scale[h] = exp2f((st.m[h] - m_new) * kLog2e);  // 0 on the first frame (m = -inf)
    base[h] = m_new * kLog2e;
    st.m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = exp2f(fmaf(s[i], kLog2e, -base[h]));
    sum[h] += s[i];
    st.o[i] *= scale[h];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * scale[h] + sum[h];

  // P as the A operand: the accumulator's columns 16kk..16kk+15 are
  // s[8kk..8kk+7], already in the A fragment's order. kDrop: each element's
  // keep test is hashed here; the numerator of a dropped weight is 0 and of
  // a kept one e * scale, while l above stays the undropped sum (dropout
  // acts after the softmax).
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float x0 = s[2 * i], x1 = s[2 * i + 1];
    if (kDrop) {
      x0 = keep_test(keep, h0, kPrime1, keep.stride1, 2 * i) ? x0 * keep.scale : 0.f;
      x1 = keep_test(keep, h0, kPrime1, keep.stride1, 2 * i + 1) ? x1 * keep.scale : 0.f;
    }
    __nv_bfloat162 pair = __floats2bfloat162_rn(x0, x1);
    a[i] = *reinterpret_cast<uint32_t*>(&pair);
  }
  fence_regs(a);
  fence_regs(st.o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
    wgmma_rs_tb(st.o, a + 4 * kk, desc_sw128(v_s + kk * 16 * kDh * 2));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(st.o);
}

template <int NC, bool kDrop>
__global__ void __launch_bounds__(NC * 128 + 32, NC == 1 ? 3 : 2)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_kb,
                         const __grid_constant__ CUtensorMap tm_vb, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const bool has_own = p.form != kBlockCausal;
  const uint32_t q_s = smem_addr(smem);                          // NC query tiles
  const uint32_t own_s = q_s + NC * kTileBytes;                  // NC own (K, V) pairs
  const uint32_t ring_s = q_s + NC * kTileBytes * (has_own ? 3 : 1);  // kStages (K, V) pairs
  const uint32_t bars = ring_s + kStages * 2 * kTileBytes;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const auto qbar = [&](int c) { return bars + 8 * (2 * kStages + c); };
  // kDrop: each consumer thread's query row, kept here across the frame loop
  int* const q_rows = reinterpret_cast<int*>(smem + (bars - q_s) + 8 * (2 * kStages + NC));

  const Plan<NC> pl = make_plan<NC>(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC);
    }
    for (int c = 0; c < NC; ++c) mbar_init(qbar(c), 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // producer warp: one lane issues every load
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (pl.q_row[c] < 0) continue;
        mbar_expect_tx(qbar(c), kTileBytes * (pl.own[c] ? 3 : 1));
        tma_load_2d(q_s + c * kTileBytes, &tm_q, qbar(c), 0, pl.q_row[c]);
        if (pl.own[c]) {
          tma_load_2d(own_s + 2 * c * kTileBytes, &tm_kb, qbar(c), 0, pl.q_row[c]);
          tma_load_2d(own_s + (2 * c + 1) * kTileBytes, &tm_vb, qbar(c), 0, pl.q_row[c]);
        }
      }
      for (int f = 0; f < pl.f_end; ++f) {
        const int stage = f % kStages;
        mbar_wait(empty(stage), ((f / kStages) & 1) ^ 1);
        mbar_expect_tx(full(stage), 2 * kTileBytes);
        const uint32_t dst = ring_s + 2 * stage * kTileBytes;
        tma_load_2d(dst, &tm_k, full(stage), 0, pl.kv_row0 + f * kRows);
        tma_load_2d(dst + kTileBytes, &tm_v, full(stage), 0, pl.kv_row0 + f * kRows);
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup c
    const int c = warp / 4, t = threadIdx.x % 128;
    // this consumer's entries of the plan, selected rather than indexed by
    // the runtime c, so that the plan stays in registers
    int q_row = pl.q_row[0], f_limit = pl.f_limit[0];
    bool own = pl.own[0];
#pragma unroll
    for (int cc = 1; cc < NC; ++cc) {
      if (c == cc) {
        q_row = pl.q_row[cc];
        f_limit = pl.f_limit[cc];
        own = pl.own[cc];
      }
    }
    const bool active = q_row >= 0;
    const uint32_t my_q = q_s + c * kTileBytes;
    // kDrop: the frame loop's peak register demand is one above the 96 a
    // thread has at two CTAs an SM, so the query row waits for the output in
    // shared memory rather than in a register that ptxas would spill
    if (kDrop) q_rows[threadIdx.x] = q_row;
    // kDrop: the hash's first step for the thread's first element at key
    // column 0, from its weight index (q_row + r) * stride + 2(t%4) (q_row
    // is the query tile's global row g*TL + t*64, r the element's row in the
    // tile); a K0 frame f adds f*64 to the index, the own frame
    // TL + (t*64 mod qb)
    unsigned h0 = 0, own_h0 = 0;
    if (kDrop && active) {
      const int r = 16 * (t / 32) + (t % 32) / 4;
      h0 = (unsigned)(q_row + r) * p.keep.stride1 + (unsigned)(2 * (t % 4)) * kPrime1 + p.keep.s0;
      if (own) {
        const int tl = p.frames * kRows;
        own_h0 = h0 + (unsigned)(tl + q_row % tl % p.qb) * kPrime1;
      }
    }
    RowState st;
#pragma unroll
    for (int i = 0; i < 32; ++i) st.o[i] = 0.f;
    st.m[0] = st.m[1] = -INFINITY;
    st.l[0] = st.l[1] = 0.f;
    if (active) {
      mbar_wait(qbar(c), 0);
      if (own)
        attend<kDrop>(my_q, own_s + 2 * c * kTileBytes, own_s + (2 * c + 1) * kTileBytes, st,
                      p.keep, own_h0);
    }
    for (int f = 0; f < pl.f_end; ++f) {
      const int stage = f % kStages;
      mbar_wait(full(stage), (f / kStages) & 1);
      if (active && f < f_limit)
        attend<kDrop>(my_q, ring_s + 2 * stage * kTileBytes,
                      ring_s + (2 * stage + 1) * kTileBytes, st, p.keep,
                      h0 + (unsigned)f * (kRows * kPrime1));
      if (t == 0) mbar_arrive(empty(stage));
    }
    // the row sums over the quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
      st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
    }
    const int row = 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
    if (kDrop) q_row = q_rows[threadIdx.x];
    if (active) {
      const float inv[2] = {1.f / st.l[0], 1.f / st.l[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t at = (size_t)(q_row + row + 8 * h) * kDh + 8 * j + col;
          *reinterpret_cast<__nv_bfloat162*>(p.out + at) = __floats2bfloat162_rn(
              st.o[4 * j + 2 * h] * inv[h], st.o[4 * j + 2 * h + 1] * inv[h]);
        }
      }
      if (p.lse != nullptr && t % 4 == 0) {
        p.lse[q_row + row] = st.m[0] + logf(st.l[0]);
        p.lse[q_row + row + 8] = st.m[1] + logf(st.l[1]);
      }
    }
  }
}

template <int NC, bool kDrop>
int launch(const Params& p, const void* q, const void* k, const void* v, const void* kb,
           const void* vb, long long q_rows, long long kv_rows, int grid, void* stream) {
  CUtensorMap maps[5];
  const void* bases[5] = {q, k, v, kb, vb};
  const long long rows[5] = {q_rows, kv_rows, kv_rows, q_rows, q_rows};
  for (int i = 0; i < 5; ++i) {
    const int err = tile_map_64x64(&maps[i], bases[i], rows[i]);
    if (err != 0) return err;
  }
  const int own_tiles = p.form == kBlockCausal ? 0 : 2 * NC;
  const int smem = 1024 + (NC + own_tiles + 2 * kStages) * kTileBytes + 8 * (2 * kStages + NC) +
                   (kDrop ? NC * 128 * 4 : 0);
  auto kernel = attention_fwd_kernel<NC, kDrop>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NC * 128 + 32, smem, (cudaStream_t)stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                               maps[4], p);
  return (int)cudaGetLastError();
}

// B1 (no dropout) or B5.
template <bool kDrop>
int block_causal(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                 int frames, Dropout drop, void* stream) {
  Params p = {};
  p.out = (bf16*)o;
  p.lse = (float*)lse;
  p.form = kBlockCausal;
  p.rows = bh;
  p.frames = frames;
  p.keep = make_keep(drop, (unsigned)(frames * kRows));
  const long long rows = (long long)bh * frames * kRows;
  return launch<2, kDrop>(p, q, k, v, k, v, rows, rows, bh * ((frames + 1) / 2), stream);
}

// B2 (no dropout) or B7 (one-shot form, qb its q-tile).
template <bool kDrop>
int branch(const void* q, const void* k0, const void* v0, const void* kb, const void* vb, void* o,
           void* lse, int g, int q_frames, int bh0, int old_frames, int first_q_frame, int n_old,
           int qb, Dropout drop, void* stream) {
  Params p = {};
  p.out = (bf16*)o;
  p.lse = (float*)lse;
  p.form = kBranch;
  p.rows = g;
  p.frames = q_frames;
  p.bh0 = bh0;
  p.old_frames = old_frames;
  p.first_q_frame = first_q_frame;
  p.n_old = n_old;
  p.keep = make_keep(drop, (unsigned)(q_frames * kRows + qb));
  p.qb = qb;
  const long long q_rows = (long long)g * q_frames * kRows;
  const long long kv_rows = (long long)bh0 * old_frames * kRows;
  const int branches = g / bh0;
  if (branches == 1) {
    p.groups = 1;
    return launch<1, kDrop>(p, q, k0, v0, kb, vb, q_rows, kv_rows, q_frames * bh0, stream);
  }
  p.groups = (branches + 1) / 2;
  return launch<2, kDrop>(p, q, k0, v0, kb, vb, q_rows, kv_rows, q_frames * bh0 * p.groups,
                          stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on the given stream,
// does not synchronise, and returns 0 or the CUDA error of the launch (or of
// building its tensor maps). lse may be null. s0, s1, rate, scale: see
// Dropout (attention_tile.cuh).

// q, k, v, o: [bh, frames * 64, 64]; lse: [bh, frames * 64].
extern "C" int block_causal_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int bh, int frames, void* stream) {
  return block_causal<false>(q, k, v, o, lse, bh, frames, Dropout{}, stream);
}

// q, kb, vb, o: [g, q_frames * 64, 64]; lse: [g, q_frames * 64]; k0, v0:
// [bh0, old_frames * 64, 64], shared by the g / bh0 branches (branch g reads
// row g % bh0). Query frame tq attends stream-0 frames
// < min(first_q_frame + tq, n_old), then its own frame of kb/vb.
extern "C" int branch_attention_fwd(const void* q, const void* k0, const void* v0,
                                    const void* kb, const void* vb, void* o, void* lse, int g,
                                    int q_frames, int bh0, int old_frames, int first_q_frame,
                                    int n_old, void* stream) {
  return branch<false>(q, k0, v0, kb, vb, o, lse, g, q_frames, bh0, old_frames, first_q_frame,
                       n_old, 0, Dropout{}, stream);
}

// B1's operands, with dropout.
extern "C" int block_causal_attention_dropout_fwd(const void* q, const void* k, const void* v,
                                                  void* o, void* lse, int bh, int frames,
                                                  unsigned s0, unsigned s1, float rate,
                                                  float scale, void* stream) {
  return block_causal<true>(q, k, v, o, lse, bh, frames, Dropout{s0, s1, rate, scale}, stream);
}

// The one-shot form of B2's operands (q_frames = old_frames = frames,
// first_q_frame 0, n_old frames), with dropout; qb: the Pallas q-tile of
// B7's index space (pick_q_block).
extern "C" int branch_attention_dropout_fwd(const void* q, const void* k0, const void* v0,
                                            const void* kb, const void* vb, void* o,
                                            void* lse, int g, int frames, int bh0, int qb,
                                            unsigned s0, unsigned s1, float rate,
                                            float scale, void* stream) {
  return branch<true>(q, k0, v0, kb, vb, o, lse, g, frames, bh0, frames, 0, frames, qb,
                      Dropout{s0, s1, rate, scale}, stream);
}
