// Tiled (flash) GQA attention over bf16 q, k, v, for Hopper.
//
// Replaces the TPU kernel flash_attention
// (whisper_tensor_tpu/backends/pallas/attention.py:175, pallas_call at
// :388). Same semantics, in all three of its modes:
//   * pos-bound: query row s of batch b sees key j iff j <= pos[b] + s
//     (the recipes' position mask; the mode prefill runs);
//   * causal: row s sees j iff j <= s + (Skv - Sq);
//   * additive: an f32 mask (1|B, 1, Sq, Skv) is added to the scores
//     (with or without causal).
// Scores are f32 sums of bf16 products, times `scale` in f32; the running
// max and sum are f32 (an online softmax); p is rounded to bf16 before
// the P @ V product, which accumulates in f32 (the TPU kernel's :309-312);
// a row with no visible key gives zeros (:335). GQA by head index: query
// head h reads KV head h / (Hq / Hkv).
//
//   q    (B, Hq, Sq, D) bf16, any strides with the feature stride 1
//   k, v (B, Hkv, Skv, D) bf16, contiguous   D = 64, 80, 128, 160, 256
//   mask (1|B, 1, Sq, Skv) f32 contiguous, or none
//   pos  (B,) int64, or none                    out (B, Hq, Sq, D) bf16
//
// What bounds it on the H100: operations. A 2,048-token prompt at
// Llama-3-8B widths does 4 * D flops per visible (query, key) pair: about
// 34 GFLOP per layer over the causal triangle, 35 us at 989 TFLOP/s,
// against 4 MB of K/V (1.3 us at 3.35 TB/s). A 128-row piece is near
// balance. The design (FlashAttention-2's) follows from that:
//   * the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate), which matches the TPU kernel's numerics; every
//     fragment of K comes by ldmatrix and of V by ldmatrix.trans, so a
//     shared-memory instruction feeds two products;
//   * a block of 8 warps takes 128 query rows, 16 a warp: 16 positions of
//     each of 8 query heads of one GQA group, 32 of 4, 64 of 2 or 128 of
//     1 (the most heads that divide the group), so every K/V tile it
//     loads serves the group's heads, as in decode_attention.cu;
//   * K and V tiles of 64 keys stream through shared memory in a ring of
//     3 cp.async stages (102 KB at D = 128), one barrier a tile; rows are
//     padded by 16 bytes so the ldmatrix rows hit distinct banks;
//   * the key loop stops at the tile holding the block's last visible key
//     (min(pos[b] + last row, Skv - 1); the TPU kernel's :320-323), so the
//     work follows the causal triangle and keys past it are never read; a
//     warp skips the products of a tile none of its rows sees;
//   * only the tiles that cross a row's visibility edge (or the ragged
//     end of the keys, or every tile in the additive mode) go through the
//     element-wise visibility test; the others take a path without it;
//   * exp2f, with log2(e) folded into the scale: the running max and the
//     scores live in the base-2 domain;
//   * the grid runs its heaviest blocks first (the last query tiles, which
//     see the most keys, have the lowest block index), so the light ones
//     fill the tail;
//   * when the grid is under one wave of the card (a 128-row piece at
//     B = 1 is 32 blocks on 132 SMs), each block's keys are split into
//     runs of whole tiles over blocks: a split writes its rows' partial
//     state (the running max m, the sum l and the unnormalized output, f32)
//     to a scratch, and a second kernel merges the splits in split order
//     (m* = max m_i, out = sum acc_i 2^(m_i - m*) / sum l_i 2^(m_i - m*);
//     decode_attention.py:merge_partial_softmax is its plain reference).
//     The wrapper picks the split count (flash_attention.py:flash_splits)
//     from the shapes and what wt_flash_limits reads on the card;
//   * the ragged edges (Sq and Skv not multiples of the tiles) are masked
//     in the kernel: no padded copies of q, k or v;
//   * head dim 256 (every Gemma) does not fit the D = 128 design: a warp's
//     16 rows of f32 output alone take 128 registers a thread there, its
//     q fragments 64 more, and the 3-stage ring of 64-key tiles would be
//     203 KB. The tile shape is a template parameter (Cfg: keys a tile,
//     stages). D = 256 keeps q in registers and streams 32-key tiles in
//     3 stages (101 KB), at twice the barriers and rescales a key; one
//     block of 8 warps fills a multiprocessor's registers, as at D = 128.
//     The other shape tried staged the block's 128 q rows in shared
//     memory once (68 KB) and read each warp's A fragments by ldmatrix
//     on every tile, with a ring of 2 stages of 64 keys (203 KB in all).
//     Timed against it by chip_smoke.py's phase 2 on an H100 80GB HBM3
//     at 700 W, the shape kept took 0.86-0.90x its device time at 2,048
//     rows and 0.60-0.63x at a 128-row prompt (PERF.md §6), though ptxas
//     gives it 255 registers and 60 bytes of spills (the other: 249,
//     none); the other was then deleted.
// Left out of the TPU kernel, each for a reason:
//   * the KV-chunk carry (its carry / carry_out, :208-229, :366-373): it
//     exists because one head's whole K/V had to sit in VMEM; here K/V
//     stream through shared memory tile by tile, at any Skv;
//   * the padding of Sq and Skv to 128 (:231-243): the edges are masked;
//   * the environment knobs (WT_PALLAS_ATTENTION*, WT_FLASH_*) and the
//     4 GiB threshold on materialized scores (:171-172), a limit of the
//     TPU's memory; the port routes every eligible call here;
//   * TRACE_USES: the wrapper's launch counter takes its place.
//   * head dims 80 and 160, the SD UNet's (640 and 1,280 channels over 8
//     heads), run natively: D only needs to be a multiple of 16 (the mma
//     k-step); their tiles are D = 128's (64 keys, 3 stages: 68 KB and
//     129 KB), and the merge pass takes any D even. The TPU path pads
//     them to 128 and 256; timed against that padded call by
//     chip_smoke.py's phase 2 on an H100 80GB HBM3 at 700 W, the native
//     call took 0.59x its time at 1,024 positions (D = 80) and 0.62x at
//     256 (D = 160), its three copies and slice included (PERF.md). The
//     UNet's 40 is not a multiple of 16: the Attention lowering pads it
//     to 64 (milli/ops/attention.py).
// What it does not do yet: wgmma and TMA (Hopper's asynchronous
// warpgroup products and tile copies) and a producer warp.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "device_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;      // query rows of a block
constexpr int kChunkKeys = 64;          // splits are whole runs of 64 keys
constexpr int kPad = 8;                 // bf16 of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

// A kernel's tile shape: head dim D, BK keys a tile and a ring of
// STAGES cp.async stages.
template <int D_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int D = D_, BK = BK_, STAGES = STAGES_;
  static constexpr int kRow = D + kPad;  // shared row, in bf16
  // a K and a V tile a stage
  static constexpr int smem_bytes = STAGES * 2 * BK * kRow * 2;
};

// Query heads of one block: the most of 8, 4, 2, 1 that divide the group.
int heads_per_block(int Hq, int Hkv) {
  const int rep = Hq / Hkv;
  return rep % 8 == 0 ? 8 : rep % 4 == 0 ? 4 : rep % 2 == 0 ? 2 : 1;
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ mask,
                       const long long* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int B, int Hq, int Hkv,
                       int Sq, int Skv, long long q_sb, long long q_sh,
                       long long q_ss, long long mask_sb, int causal,
                       int heads, float scale, int splits, int chunk_tiles) {
  constexpr int D = C::D, kBK = C::BK, kStages = C::STAGES;
  constexpr int kRow = C::kRow;         // shared row, in bf16
  constexpr int kTile = kBK * kRow;
  constexpr int kChunks = D / 8;        // 16-byte chunks of a key's row
  constexpr int NT = kBK / 8;           // n-tiles of 8 keys of a score tile
  constexpr int DT = D / 8;             // n-tiles of 8 features of O
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // [S][K | V]

  const int tq = kRows / heads;         // query positions of the block
  const int n_qt = (Sq + tq - 1) / tq;
  const int split = blockIdx.z % splits;
  const int s0 = (n_qt - 1 - blockIdx.z / splits) * tq;   // heaviest first
  const int h0 = blockIdx.x * heads;    // first query head of the block
  const int b = blockIdx.y;
  const int g = h0 / (Hq / Hkv);        // the KV head of its group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tc = lane & 3;
  const int wph = tq / 16;              // warps per query head
  const int h = h0 + warp / wph;        // this warp's query head
  const int r0 = s0 + (warp % wph) * 16;  // and its first query row

  // the last key any row of the block sees, the last any row of this
  // warp sees, and the last every row of this warp sees (tiles up to it
  // need no visibility test)
  const long long pb = pos != nullptr ? pos[b] : 0;
  auto last_seen = [&](int row) {
    long long last = Skv - 1;
    if (pos != nullptr) last = min(last, pb + row);
    if (causal) last = min(last, static_cast<long long>(row) + Skv - Sq);
    return last;
  };
  const long long block_last = last_seen(min(s0 + tq, Sq) - 1);
  const long long warp_last = last_seen(min(r0 + 15, Sq - 1));
  const long long warp_full = mask != nullptr ? -1 : last_seen(r0);
  const int n_tiles =
      block_last < 0 ? 0 : static_cast<int>(block_last / kBK) + 1;
  const int t_begin = split * chunk_tiles;
  const int t_end = min(n_tiles, t_begin + chunk_tiles);

  const size_t kv0 = (static_cast<size_t>(b) * Hkv + g) *
                     static_cast<size_t>(Skv) * D;
  auto load_tile = [&](int stage, int t) {
    __nv_bfloat16* ks = smem + stage * 2 * kTile;
    __nv_bfloat16* vs = ks + kTile;
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int j = c / kChunks, off = (c % kChunks) * 8;
      const int key = t * kBK + j;
      const bool ok = key < Skv;
      const size_t src = kv0 + static_cast<size_t>(ok ? key : 0) * D + off;
      cp_async16(ks + j * kRow + off, k + src, ok);
      cp_async16(vs + j * kRow + off, v + src, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t_begin + s < t_end) load_tile(s, t_begin + s);
    cp_async_commit();
  }

  // this warp's 16 query rows as A fragments, read through q's strides
  const __nv_bfloat16* qh = q + b * q_sb + h * q_sh;
  auto q_pair = [&](int row, int col) -> uint32_t {
    const int s = r0 + row;
    if (s >= Sq) return 0u;
    const __nv_bfloat16* p = qh + s * q_ss + col;
    return pack_raw(p[0], p[1]);
  };
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = q_pair(gr, kk * 16 + 2 * tc);
    qf[kk][1] = q_pair(gr + 8, kk * 16 + 2 * tc);
    qf[kk][2] = q_pair(gr, kk * 16 + 8 + 2 * tc);
    qf[kk][3] = q_pair(gr + 8, kk * 16 + 8 + 2 * tc);
  }

  float o[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  // rows gr, gr + 8: running max (base 2) and sum
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  const float* mrow = mask != nullptr ? mask + b * mask_sb : nullptr;
  const float c2 = scale * kLog2e;      // scores in the base-2 domain

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    cp_async_wait<kStages - 2>();       // this thread's copies of tile t
    __syncthreads();                    // everyone's; tile t-1's slot free
    if (t + kStages - 1 < t_end)
      load_tile((i + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();                  // (an empty group keeps the count)
    if (static_cast<long long>(t) * kBK > warp_last) continue;  // unseen
    const __nv_bfloat16* ks = smem + (i % kStages) * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys; an ldmatrix.x4
    // gives the B fragments of two n-tiles (keys n0..n0+15, 16 features)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                                kRow + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale (and mask), the rows' maxima, p = 2^(x - m)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    const bool full = static_cast<long long>(t) * kBK + kBK - 1 <= warp_full;
    if (full) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] *= c2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = r0 + gr + (e >> 1) * 8;
          const int j = t * kBK + nt * 8 + 2 * tc + (e & 1);
          bool vis = j < Skv && s < Sq;
          if (pos != nullptr) vis = vis && j <= pb + s;
          if (causal) vis = vis && j <= s + (Skv - Sq);
          float x = sc[nt][e] * scale;
          if (vis && mrow != nullptr)
            x += mrow[static_cast<size_t>(s) * Skv + j];
          x = vis ? x * kLog2e : -CUDART_INF_F;
          sc[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = m_run[r] == -CUDART_INF_F ? 0.f : exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    if (full) {                         // every score finite
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[nt][e] - m_run[e >> 1]);
          sc[nt][e] = p;
          sum[e >> 1] += p;
        }
    } else {                            // masked entries are 0
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[nt][e];
          const float p =
              x == -CUDART_INF_F ? 0.f : exp2f(x - m_run[e >> 1]);
          sc[nt][e] = p;
          sum[e >> 1] += p;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += bf16(P) V: the S accumulator of n-tiles 2j, 2j+1 is the A
    // fragment of keys 16j .. 16j + 15; an ldmatrix.x4.trans of V gives
    // the B fragments of two feature n-tiles
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                             pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                             pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                             pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (j * 16 + (lane & 15)) * kRow + np * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(o[2 * np], a, r[0], r[1]);
        mma_bf16(o[2 * np + 1], a, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

  const size_t rows = static_cast<size_t>(B) * Hq * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = r0 + gr + 8 * r;
    if (s >= Sq) continue;
    const size_t row = (static_cast<size_t>(b) * Hq + h) * Sq + s;
    if (part_acc != nullptr) {          // this split's partial state
      const size_t at = split * rows + row;
      if (tc == 0) {
        part_ml[2 * at] = m_run[r];
        part_ml[2 * at + 1] = l_run[r];
      }
      if (m_run[r] == -CUDART_INF_F) continue;   // the merge skips it
      float* arow = part_acc + at * D + 2 * tc;
#pragma unroll
      for (int nt = 0; nt < DT; ++nt)
        *reinterpret_cast<float2*>(arow + nt * 8) =
            make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
      continue;
    }
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* orow = out + row * D + 2 * tc;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(o[nt][2 * r] / l, o[nt][2 * r + 1] / l);
  }
}

// The second pass: warp w of block x merges row 8x + w's `splits`
// partial states in split order, lane t the feature pairs 2t + 64i. A
// split whose max is -inf (it saw no key of the row) weighs 0; a row
// with no visible key at all gives 0.
template <int D>
__global__ void __launch_bounds__(256)
flash_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   __nv_bfloat16* __restrict__ out, long long rows,
                   int splits) {
  constexpr int kP = (D + 63) / 64;     // feature pairs a lane
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float m = -CUDART_INF_F;
  for (int c = 0; c < splits; ++c) m = fmaxf(m, part_ml[2 * (c * rows + row)]);
  float l = 0.f, a[kP][2];
#pragma unroll
  for (int p = 0; p < kP; ++p) a[p][0] = a[p][1] = 0.f;
  for (int c = 0; c < splits; ++c) {
    const long long at = c * rows + row;
    const float mc = part_ml[2 * at];
    if (mc == -CUDART_INF_F) continue;
    const float w = exp2f(mc - m);
    l = fmaf(part_ml[2 * at + 1], w, l);
    const float* src = part_acc + at * D;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int e = 2 * lane + 64 * p;
      if (e >= D) continue;
      const float2 x = *reinterpret_cast<const float2*>(src + e);
      a[p][0] = fmaf(x.x, w, a[p][0]);
      a[p][1] = fmaf(x.y, w, a[p][1]);
    }
  }
  __nv_bfloat16* dst = out + row * D;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int e = 2 * lane + 64 * p;
    if (e >= D) continue;
    *reinterpret_cast<uint32_t*>(dst + e) =
        l > 0.f ? pack_bf16(a[p][0] / l, a[p][1] / l) : 0u;
  }
}

// The ring passes the 48 KB a block gets without asking: allowed once
// per device (of the first 16), not on every launch.
template <typename C>
cudaError_t allow_smem() {
  static bool allowed[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !allowed[dev]) {
    e = cudaFuncSetAttribute(flash_attention_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::smem_bytes);
    if (e != cudaSuccess) return e;
    if (dev < 16) allowed[dev] = true;
  }
  return cudaSuccess;
}

template <typename C>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* pos, void* out,
                   float* part_acc, float* part_ml, int B, int Hq, int Hkv,
                   int Sq, int Skv, long long q_sb, long long q_sh,
                   long long q_ss, long long mask_sb, int causal, float scale,
                   int splits, int chunk_tiles, cudaStream_t stream) {
  constexpr int D = C::D;
  cudaError_t e = allow_smem<C>();
  if (e != cudaSuccess) return e;
  const int heads = heads_per_block(Hq, Hkv);
  const int tq = kRows / heads;
  const dim3 grid(Hq / heads, B, ((Sq + tq - 1) / tq) * splits);
  const bool merge = splits > 1;
  flash_attention_kernel<C><<<grid, kThreads, C::smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<const long long*>(pos), static_cast<__nv_bfloat16*>(out),
      merge ? part_acc : nullptr, part_ml, B, Hq, Hkv, Sq, Skv, q_sb, q_sh,
      q_ss, mask_sb, causal, heads, scale, splits,
      chunk_tiles * (kChunkKeys / C::BK));
  e = cudaGetLastError();
  if (e != cudaSuccess || !merge) return e;
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  flash_merge_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                          stream>>>(part_acc, part_ml,
                                    static_cast<__nv_bfloat16*>(out), rows,
                                    splits);
  return cudaGetLastError();
}

// Blocks of the C kernel one multiprocessor of the current device runs
// at once.
template <typename C>
cudaError_t occupancy(int* blocks) {
  cudaError_t e = allow_smem<C>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_attention_kernel<C>, kThreads, C::smem_bytes);
}

// f(Cfg) for head dim D (64, 80, 128, 160 or 256): the tile shapes of
// the note above
template <typename F>
cudaError_t with_cfg(int D, F&& f) {
  if (D == 64) return f(Cfg<64, 64, 3>{});
  if (D == 80) return f(Cfg<80, 64, 3>{});
  if (D == 128) return f(Cfg<128, 64, 3>{});
  if (D == 160) return f(Cfg<160, 64, 3>{});
  if (D == 256) return f(Cfg<256, 32, 3>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// The limits the wrapper's split plan (flash_attention.py:flash_splits)
// sizes its grid by, for a group of Hq / Hkv heads of dim D: limits[0]
// the query heads of one block, limits[1] its query positions, limits[2]
// the blocks of the kernel one multiprocessor of the current device runs
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA
// error code.
extern "C" int wt_flash_limits(int Hq, int Hkv, int D, int* limits) {
  if (Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || limits == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  limits[0] = heads_per_block(Hq, Hkv);
  limits[1] = kRows / limits[0];
  return static_cast<int>(with_cfg(D, [&](auto c) {
    return occupancy<decltype(c)>(limits + 2);
  }));
}

// One call: the kernel over `splits` runs of `chunk` keys (a multiple of
// 64 keys), then, when splits > 1, the merge of the partial
// states (part_acc: f32 (splits, B, Hq, Sq, D), part_ml: f32 (splits, B,
// Hq, Sq, 2)) into `out`. Returns cudaGetLastError() after the launches;
// cudaErrorInvalidValue for a shape or plan the kernel does not take (the
// Python wrapper checks first). `mask` and `pos` may be null; q's strides
// (in elements) are per batch, head and row; mask_sb is 0 for a mask of
// batch 1.
extern "C" int wt_flash_attention(const void* q, const void* k,
                                  const void* v, const void* mask,
                                  const void* pos, void* out, void* part_acc,
                                  void* part_ml, int B, int Hq, int Hkv,
                                  int Sq, int Skv, int D, long long q_sb,
                                  long long q_sh, long long q_ss,
                                  long long mask_sb, int causal, float scale,
                                  int splits, int chunk, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || B <= 0 || B > 65535 || splits < 1 || chunk <= 0 ||
      chunk % kChunkKeys != 0 ||
      static_cast<long long>(splits) * chunk < Skv ||
      static_cast<long long>(splits - 1) * chunk >= Skv ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int heads = heads_per_block(Hq, Hkv);
  const int tq = kRows / heads;
  if (Hq / heads > 65535 ||
      static_cast<long long>((Sq + tq - 1) / tq) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const int ct = chunk / kChunkKeys;
  return static_cast<int>(with_cfg(D, [&](auto c) {
    return launch<decltype(c)>(q, k, v, mask, pos, out, pa, pm, B, Hq, Hkv,
                               Sq, Skv, q_sb, q_sh, q_ss, mask_sb, causal,
                               scale, splits, ct, s);
  }));
}
