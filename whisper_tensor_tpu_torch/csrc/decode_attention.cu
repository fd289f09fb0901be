// Single-query (decode) GQA attention over a bf16 KV cache, for Hopper.
//
// Replaces the TPU kernel ragged_decode_attention
// (whisper_tensor_tpu/backends/pallas/decode_attention.py:179, built at
// :85). Same semantics: row b attends keys 0..min(pos[b], L-1) of its
// cache, with scores, running max and running sum in f32 (an online
// softmax), and a row whose sum is 0 writes 0.
//
//   q   (B, Hq, 1, D) bf16, f32 or f16 (q_type 0, 1, 2)
//   k, v (B, Hkv, L, D) bf16
//   pos (B,) int64             out  (B, Hq, 1, D) in q's type
//   D   64, 128 or 256 (a template parameter: GPT-2 and llama models of
//       head dim 64, Llama-3's 128, every Gemma's 256)
//
// (an f32 or f16 q is a model computing in that type over a bf16 cache:
// the scores take q's values as they are, exactly in f32, and the output
// is rounded once from f32 to q's type)
//
// What bounds it on the H100: the bytes of LIVE K/V. Each K and V
// element of a row's live prefix is read once (2 * Hkv * (pos+1) * D *
// 2 bytes per row); the work per byte is a few FMAs, far below the
// card's compute roofline. What holds a kernel back from that bound at
// small batch is the grid: one block per (KV head, row) is 8 blocks at
// B = 1 for Llama-3-8B, and one SM cannot stream a row's megabyte of K/V
// at the card's rate. So the key range is split (flash-decoding):
//   * blocks (head group part, row, split): split c of a row takes keys
//     [c * chunk, (c + 1) * chunk). The wrapper picks the number of
//     splits from B, the head blocks and L alone
//     (decode_attention.py:decode_splits: as many blocks as the
//     multiprocessors hold at once, which wt_decode_limits reads on the
//     card, down to 32 keys a split: 64 splits of 32 keys at
//     B = 1, L = 2048, 8 of 256 at B = 8, 4 of 512 at B = 16; one split
//     once the batch alone gives 2 blocks a multiprocessor), so pos stays
//     on the device and nothing waits on the host;
//   * each block reads pos[b] and streams only the live keys of its
//     chunk; a chunk wholly past pos[b] writes an empty state (m = -inf,
//     l = 0) and exits;
//   * the rep = Hq/Hkv query heads of a group share every K/V tile the
//     block loads (a group of more than 8 heads is split over rep/R
//     blocks of R heads each, R the largest divisor of rep up to 8);
//   * K and V tiles of 32 keys (8 KB each) stream through shared memory
//     in a ring of 3 cp.async stages (48 KB, 4 blocks a multiprocessor):
//     a split's range is short (one tile at B = 1), so a deeper ring
//     would only cost occupancy; at B = 16 a chunk is 16 tiles and 2 stay
//     in flight per block;
//   * scores: 8 lanes share a key, each lane D/8 of its features (16 at
//     D = 128, 8 at D = 64) and two keys at a time (q in registers for up
//     to 4 heads, else read from shared memory once per two keys),
//     reduced with 3 shuffles;
//     P @ V: the block's 128 threads cover the D features 128 / D times:
//     at D = 128 thread t owns feature t, at D = 64 threads t and t + 64
//     own feature t, each over every other group of four keys, and the
//     two halves are added in a fixed order at the end; at D = 256
//     thread t owns features t and t + 128; every thread reads the
//     probabilities four keys at a time;
//   * at D = 256 the ring is 96 KB, so 2 blocks share a multiprocessor
//     (4 at D = 128): the launch bounds ask for 2, which leaves a thread
//     the registers to hold a key pair's 64 features, and q stays in
//     registers for up to 2 heads (4 at D <= 128);
//   * with more than one split each block writes its partial state, the
//     running max m, the sum l and the unnormalized acc (D floats) of
//     each head, to an f32 scratch, and a second kernel merges a head's
//     splits in split order: m* = max m_i, l = sum l_i e^(m_i - m*),
//     out = sum acc_i e^(m_i - m*) / l, empty splits skipped (no
//     exp(-inf + inf)), 0 where l is 0. With one split the block writes
//     the output itself.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "device_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;               // keys per stage (one per lane)
constexpr int kStages = 3;              // cp.async ring depth

// the shared memory of head dim D: bytes of one key's features, of a
// stage (a K tile and a V tile), and of the ring
template <int D> __host__ __device__ constexpr int row_bytes() {
  return D * 2;
}
template <int D> __host__ __device__ constexpr int stage_bytes() {
  return 2 * kTile * row_bytes<D>();
}
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<D>();
}

// q's element `at` as f32, and y rounded once to the output's type
// (q_type 0 bf16, 1 f32, 2 f16)
__device__ __forceinline__ float load_q(const void* q, size_t at,
                                        int q_type) {
  if (q_type == 1) return static_cast<const float*>(q)[at];
  if (q_type == 2) return __half2float(static_cast<const __half*>(q)[at]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at]);
}
__device__ __forceinline__ void store_out(void* out, size_t at, float y,
                                          int q_type) {
  if (q_type == 1)
    static_cast<float*>(out)[at] = y;
  else if (q_type == 2)
    static_cast<__half*>(out)[at] = __float2half_rn(y);
  else
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 (16 bytes, lowest address first) -> f32; a bf16 is the top
// half of the f32 with the same bits, so the conversion is exact
__device__ __forceinline__ void unpack8(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// D: the head dim; REP: the query heads of one block, all of KV head
// g's group or a part of it
template <int D, int REP>
__global__ void __launch_bounds__(kThreads, D > 128 ? 2 : 4)
decode_attention_kernel(const void* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const long long* __restrict__ pos,
                        void* __restrict__ out,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int q_type,
                        int Hq, int Hkv, int L, int chunk, float scale) {
  constexpr int kRow = row_bytes<D>();
  constexpr int kStageBytes = stage_bytes<D>();
  constexpr int NI = D / 32;            // float4s of q a lane holds
  // P @ V: thread t owns features t % kCols + u * kCols (u < FPT) over
  // the key groups of half t / kCols (KH halves)
  constexpr int FPT = D > kThreads ? D / kThreads : 1;
  constexpr int kCols = D / FPT;
  constexpr int KH = kThreads / kCols;
  extern __shared__ __align__(16) unsigned char ring[];   // [S][K | V tile]
  // query heads, pre-scaled f32, permuted so that lane c of a key's 8
  // lanes reads its NI float4s at [i][c]: conflict-free 16-byte reads
  __shared__ __align__(16) float s_q[REP][NI][8][4];
  __shared__ __align__(16) float s_p[REP][kTile];  // scores, then probs
  __shared__ float s_m[REP];            // running max
  __shared__ float s_l[REP];            // running sum
  __shared__ float s_alpha[REP];        // rescale of the previous tiles

  const int rep = Hq / Hkv;             // query heads of the group
  const int g = blockIdx.x / (rep / REP);       // KV head
  const int part = blockIdx.x % (rep / REP);    // REP heads of its group
  const int b = blockIdx.y;             // batch row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int split = blockIdx.z, splits = gridDim.z;
  const size_t head0 = static_cast<size_t>(b) * Hq +
                       static_cast<size_t>(g) * rep + part * REP;

  long long p = pos[b];
  p = p < 0 ? 0 : (p > L - 1 ? L - 1 : p);
  const int n_keys = static_cast<int>(p) + 1;
  const int k0 = split * chunk;             // this split's keys [k0, k1)
  if (k0 >= n_keys) {                       // wholly past pos: empty state
    if (tid < REP) {
      float* ml = part_ml + ((head0 + tid) * splits + split) * 2;
      ml[0] = -CUDART_INF_F;
      ml[1] = 0.f;
    }
    return;
  }
  const int k1 = min(k0 + chunk, n_keys);
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;

  const size_t kv0 = (static_cast<size_t>(b) * Hkv + g) *
                     static_cast<size_t>(L) * D;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k + kv0);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v + kv0);
  auto load_tile = [&](int slot, int t) {
    unsigned char* dst = ring + slot * kStageBytes;
    const int key0 = k0 + t * kTile;
    for (int c = tid; c < kTile * kRow / 16; c += kThreads) {
      const int j = c / (kRow / 16), off = (c % (kRow / 16)) * 16;
      const bool ok = key0 + j < k1;
      const size_t src = ok ? static_cast<size_t>(key0 + j) * kRow + off : 0;
      cp_async16(dst + j * kRow + off, kb + src, ok);
      cp_async16(dst + kTile * kRow + j * kRow + off, vb + src, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // feature of (i, c, e): lane c holds [8c, 8c+8) and, at D = 128,
  // [64+8c, 64+8c+8)
  for (int idx = tid; idx < REP * D; idx += kThreads) {
    const int h = idx / D, r = idx % D;
    const int i = r / 32, c = (r % 32) / 4, e = r % 4;
    const int d = (i >> 1) * 64 + 8 * c + (i & 1) * 4 + e;
    const size_t at = (head0 + h) * D + d;
    s_q[h][i][c][e] = load_q(q, at, q_type) * scale;
  }
  if (tid < REP) {
    s_m[tid] = -CUDART_INF_F;
    s_l[tid] = 0.f;
  }
  float acc[REP][FPT];
#pragma unroll
  for (int h = 0; h < REP; ++h)
#pragma unroll
    for (int u = 0; u < FPT; ++u) acc[h][u] = 0.f;
  const int col = tid % kCols;          // this thread's first feature

  static_assert(kTile == kWarps * 8, "a warp scores 8 keys of a tile");
  const int kk = lane >> 3;             // keys kk, kk + 4 of its warp's 8
  const int c8 = lane & 7;              // this lane's D/8 features
  // With up to 4 heads (2 at D = 256) a lane keeps its D/8 features of
  // each in registers: read from s_q on every tile they were the scores'
  // largest shared-memory traffic. More heads would not fit and stay in
  // s_q.
  constexpr bool kQRegs = REP * D <= 512;
  float4 qr[kQRegs ? REP : 1][NI];
  if constexpr (kQRegs) {
    __syncthreads();
#pragma unroll
    for (int h = 0; h < REP; ++h)
#pragma unroll
      for (int i = 0; i < NI; ++i)
        qr[h][i] = *reinterpret_cast<const float4*>(s_q[h][i][c8]);
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();       // this thread's copies of tile t
    __syncthreads();                    // everyone's; slot t-1 is free
    const int next = t + kStages - 1;
    if (next < n_tiles) load_tile(next % kStages, next);
    cp_async_commit();                  // (an empty group keeps the count)
    const unsigned char* ks = ring + (t % kStages) * kStageBytes;
    const __nv_bfloat16* vs =
        reinterpret_cast<const __nv_bfloat16*>(ks + kTile * kRow);
    const int tn = min(kTile, k1 - k0 - t * kTile);

    // scores: warp w takes keys 8w .. 8w+7; a lane scores keys kk and
    // kk + 4 together, so each q load serves two keys
    {
      const int j0 = warp * (kTile / kWarps) + kk, j1 = j0 + 4;
      float ka[D / 8], kb[D / 8];
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh) {   // 128-byte halves of a key
        unpack8(*reinterpret_cast<const uint4*>(ks + j0 * kRow + 128 * hh +
                                                16 * c8),
                ka + 8 * hh);
        unpack8(*reinterpret_cast<const uint4*>(ks + j1 * kRow + 128 * hh +
                                                16 * c8),
                kb + 8 * hh);
      }
#pragma unroll
      for (int h = 0; h < REP; ++h) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float4 qv;
          if constexpr (kQRegs)
            qv = qr[h][i];
          else
            qv = *reinterpret_cast<const float4*>(s_q[h][i][c8]);
          d0 = fmaf(qv.x, ka[4 * i], d0);
          d0 = fmaf(qv.y, ka[4 * i + 1], d0);
          d0 = fmaf(qv.z, ka[4 * i + 2], d0);
          d0 = fmaf(qv.w, ka[4 * i + 3], d0);
          d1 = fmaf(qv.x, kb[4 * i], d1);
          d1 = fmaf(qv.y, kb[4 * i + 1], d1);
          d1 = fmaf(qv.z, kb[4 * i + 2], d1);
          d1 = fmaf(qv.w, kb[4 * i + 3], d1);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, o);
          d1 += __shfl_xor_sync(0xffffffffu, d1, o);
        }
        if (c8 == 0) {
          s_p[h][j0] = d0;
          s_p[h][j1] = d1;
        }
      }
    }
    __syncthreads();
    // online softmax update: warp w owns heads w, w + kWarps, ...;
    // lane j owns key j of the tile
    for (int h = warp; h < REP; h += kWarps) {
      const bool live = lane < tn;
      const float s = live ? s_p[h][lane] : -CUDART_INF_F;
      const float m_old = s_m[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr = live ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(pr);
      s_p[h][lane] = pr;
      if (lane == 0) {
        const float alpha = m_old == -CUDART_INF_F ? 0.f : expf(m_old - m_new);
        s_alpha[h] = alpha;
        s_l[h] = s_l[h] * alpha + sum;
        s_m[h] = m_new;
      }
    }
    __syncthreads();
    // P @ V: thread tid owns feature f of every head in the group, over
    // the groups of four keys kh, kh + KH, ...; one 16-byte probability
    // read per head (keys past tn have p = 0 and zero-filled V rows, so
    // they add nothing)
#pragma unroll
    for (int h = 0; h < REP; ++h)
#pragma unroll
      for (int u = 0; u < FPT; ++u) acc[h][u] *= s_alpha[h];
    for (int j = 4 * (tid / kCols); j < tn; j += 4 * KH) {
      float vj[4][FPT];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int u = 0; u < FPT; ++u)
          vj[e][u] = __bfloat162float(vs[(j + e) * D + col + u * kCols]);
#pragma unroll
      for (int h = 0; h < REP; ++h) {
        const float4 p = *reinterpret_cast<const float4*>(&s_p[h][j]);
#pragma unroll
        for (int u = 0; u < FPT; ++u) {
          acc[h][u] = fmaf(p.x, vj[0][u], acc[h][u]);
          acc[h][u] = fmaf(p.y, vj[1][u], acc[h][u]);
          acc[h][u] = fmaf(p.z, vj[2][u], acc[h][u]);
          acc[h][u] = fmaf(p.w, vj[3][u], acc[h][u]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (KH > 1) {
    // the second half's sums (keys 4-7 of every 8) to the first half's
    // threads, added in that fixed order
    __shared__ float s_half[REP][D];
    if (tid >= D) {
#pragma unroll
      for (int h = 0; h < REP; ++h) s_half[h][tid - D] = acc[h][0];
    }
    __syncthreads();
    if (tid >= D) return;
#pragma unroll
    for (int h = 0; h < REP; ++h) acc[h][0] += s_half[h][tid];
  }
  if (part_acc != nullptr) {                // the split's partial state
#pragma unroll
    for (int h = 0; h < REP; ++h)
#pragma unroll
      for (int u = 0; u < FPT; ++u)
        part_acc[((head0 + h) * splits + split) * D + col + u * kCols] =
            acc[h][u];
    if (tid < REP) {
      float* ml = part_ml + ((head0 + tid) * splits + split) * 2;
      ml[0] = s_m[tid];
      ml[1] = s_l[tid];
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < REP; ++h) {
    const float l = s_l[h];
#pragma unroll
    for (int u = 0; u < FPT; ++u)
      store_out(out, (head0 + h) * D + col + u * kCols,
                l > 0.f ? acc[h][u] / l : 0.f, q_type);
  }
}

// The second pass: block bh = b * Hq + h merges the head's `splits`
// partial states in split order; thread d owns feature d (D threads).
// The (m, l) pairs are read once, side by side, into shared memory.
template <int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    void* __restrict__ out, int q_type, int splits) {
  extern __shared__ float s_w[];          // [splits] weights, then [splits] l
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  for (int c = d; c < splits; c += D) {
    s_w[c] = ml[2 * c];
    s_w[splits + c] = ml[2 * c + 1];
  }
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int c = 0; c < splits; ++c) m = fmaxf(m, s_w[c]);
  __syncthreads();
  for (int c = d; c < splits; c += D)   // an empty split weighs 0
    s_w[c] = s_w[c] == -CUDART_INF_F ? 0.f : expf(s_w[c] - m);
  __syncthreads();
  float l = 0.f, a = 0.f;
  const float* acc = part_acc + bh * splits * D + d;
#pragma unroll 4
  for (int c = 0; c < splits; ++c) {
    const float w = s_w[c];
    if (w == 0.f) continue;
    l = fmaf(s_w[splits + c], w, l);
    a = fmaf(acc[static_cast<size_t>(c) * D], w, a);
  }
  store_out(out, bh * D + d, l > 0.f ? a / l : 0.f, q_type);
}

// The ring and the static arrays may pass 48 KB (at D >= 128): allowed
// once per device (of the first 16), not on every launch.
template <int D, int REP>
cudaError_t allow_smem() {
  static bool allowed[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16 || !allowed[dev]) {
    e = cudaFuncSetAttribute(decode_attention_kernel<D, REP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<D>());
    if (e != cudaSuccess) return e;
    if (dev < 16) allowed[dev] = true;
  }
  return cudaSuccess;
}

template <int D, int REP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* out, float* part_acc,
                   float* part_ml, int q_type, int B, int Hq, int Hkv, int L,
                   int splits, int chunk, float scale, cudaStream_t stream) {
  cudaError_t e = allow_smem<D, REP>();
  if (e != cudaSuccess) return e;
  const bool merge = splits > 1;
  decode_attention_kernel<D, REP><<<dim3(Hq / REP, B, splits), kThreads,
                                     smem_bytes<D>(), stream>>>(
      q, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const long long*>(pos), out, merge ? part_acc : nullptr,
      part_ml, q_type, Hq, Hkv, L, chunk, scale);
  return cudaGetLastError();
}

// Blocks of the (D, REP) kernel one multiprocessor of the current
// device runs at once.
template <int D, int REP>
cudaError_t occupancy(int* blocks) {
  cudaError_t e = allow_smem<D, REP>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_attention_kernel<D, REP>, kThreads, smem_bytes<D>());
}

// Query heads of one block: the largest divisor of the group Hq / Hkv up
// to 8.
int heads_per_block(int Hq, int Hkv) {
  int heads = 8;
  while ((Hq / Hkv) % heads) --heads;
  return heads;
}

// f(std::integral_constant<int, R>) for R heads a block
template <typename F>
cudaError_t with_heads(int heads, F&& f) {
  switch (heads) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

// f(std::integral_constant<int, D>) for head dim D (64, 128 or 256)
template <typename F>
cudaError_t with_dim(int D, F&& f) {
  if (D == 64) return f(std::integral_constant<int, 64>{});
  if (D == 256) return f(std::integral_constant<int, 256>{});
  return f(std::integral_constant<int, 128>{});
}

bool head_dim_ok(int D) { return D == 64 || D == 128 || D == 256; }

}  // namespace

// The limits the wrapper's split plan (decode_attention.py:decode_splits)
// sizes its grid by, for a group of Hq / Hkv heads of dim D: limits[0]
// the query heads of one block, limits[1] the blocks of that kernel one
// multiprocessor of the current device runs at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA error
// code.
extern "C" int wt_decode_limits(int Hq, int Hkv, int D, int* limits) {
  if (Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || limits == nullptr ||
      !head_dim_ok(D))
    return static_cast<int>(cudaErrorInvalidValue);
  limits[0] = heads_per_block(Hq, Hkv);
  return static_cast<int>(with_dim(D, [&](auto d) {
    return with_heads(limits[0], [&](auto R) {
      return occupancy<decltype(d)::value, decltype(R)::value>(limits + 1);
    });
  }));
}

// One call: the split kernel over `splits` runs of `chunk` keys, then,
// when splits > 1, the merge of the partial states (part_acc: f32 (B, Hq,
// splits, D), part_ml: f32 (B, Hq, splits, 2)) into `out`. Returns
// cudaGetLastError() after the launches; cudaErrorInvalidValue for a
// shape or plan the kernel does not take (the Python wrapper checks
// first).
extern "C" int wt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   void* part_acc, void* part_ml, int q_type,
                                   int B, int Hq, int Hkv, int L, int D,
                                   int splits, int chunk, float scale,
                                   void* stream) {
  if (!head_dim_ok(D) || q_type < 0 || q_type > 2 || Hkv <= 0 ||
      Hq % Hkv != 0 || L <= 0 || B <= 0 ||
      B > 65535 || splits < 1 || splits > 4096 || chunk <= 0 ||
      static_cast<long long>(splits) * chunk < L ||
      static_cast<long long>(splits - 1) * chunk >= L ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t e = with_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    cudaError_t r = with_heads(heads_per_block(Hq, Hkv), [&](auto R) {
      return launch<kD, decltype(R)::value>(q, k, v, pos, out, pa, pm, q_type,
                                            B, Hq, Hkv, L, splits, chunk,
                                            scale, s);
    });
    if (r != cudaSuccess || splits == 1) return r;
    decode_merge_kernel<kD><<<static_cast<unsigned>(B) * Hq, kD,
                              2 * splits * sizeof(float), s>>>(
        pa, pm, out, q_type, splits);
    return cudaGetLastError();
  });
  return static_cast<int>(e);
}
