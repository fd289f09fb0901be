// Single-query (decode) GQA attention over a bf16 KV cache, for Hopper.
//
// Replaces the TPU kernel ragged_decode_attention
// (whisper_tensor_tpu/backends/pallas/decode_attention.py:179, built at
// :85). Same semantics: row b attends keys 0..min(pos[b], L-1) of its
// cache, with scores, running max and running sum in f32 (an online
// softmax), and a row whose sum is 0 writes 0.
//
//   q   (B, Hq, 1, D) bf16 or f32 (q_f32)    k, v (B, Hkv, L, D) bf16
//   pos (B,) int64             out  (B, Hq, 1, D) in q's type
//
// (an f32 q is a model computing in f32 over a bf16 cache: the scores
// take q's f32 values as they are)
//
// What bounds it on the H100: the bytes of LIVE K/V. Each K and V
// element of a row's live prefix is read once (2 * Hkv * (pos+1) * D *
// 2 bytes per row); the work per byte is a few FMAs, far below the
// card's compute roofline. The design follows from that:
//   * one block per (KV head, batch row); the rep = Hq/Hkv query heads
//     of the group share every K/V tile the block loads, so K/V is read
//     once per group and not once per query head. A group of more than
//     8 heads is split over rep/R blocks of R heads each, R the largest
//     divisor of rep up to 8 (the heads' scores and accumulators live in
//     shared memory and registers);
//   * the key loop stops at the row's live length, so dead cache slots
//     cost no traffic (the TPU kernel's clamped block index does the
//     same);
//   * K and V tiles of 32 keys (8 KB each) stream through shared memory
//     in a ring of 4 cp.async stages, so three tiles are in flight while
//     the block computes on the fourth;
//   * scores: 8 lanes share a key, each lane 16 of its 128 features, so
//     a warp scores 4 keys per pass and reduces with 3 shuffles;
//     P @ V: thread t owns feature t of every head of the group.
// What it does not do yet: B * Hkv blocks under-fill the 132 SMs at
// small batch (8 blocks at B=1 for Llama-3-8B), so one row's keys are
// streamed by one SM. Splitting the key range over several blocks, with
// a second pass that merges their partial softmax states, is the next
// step for this kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                 // head dim (one thread per feature)
constexpr int kThreads = kD;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;               // keys per stage (one per lane)
constexpr int kStages = 4;              // cp.async ring depth
constexpr int kRow = kD * 2;            // bytes of one key's features
constexpr int kStageBytes = 2 * kTile * kRow;   // a K tile and a V tile
constexpr int kSmem = kStages * kStageBytes;    // dynamic shared memory

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

// 16-byte global -> shared copy; when !valid it writes 16 zero bytes and
// reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// REP: the query heads of one block, all of KV head g's group or a
// part of it
template <int REP>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const long long* __restrict__ pos,
                        void* __restrict__ out, int q_f32,
                        int Hq, int Hkv, int L, float scale) {
  extern __shared__ __align__(16) unsigned char ring[];   // [S][K | V tile]
  // query heads, pre-scaled f32, permuted so that lane c of a key's 8
  // lanes reads its 4 float4s at [i][c]: conflict-free 16-byte reads
  __shared__ __align__(16) float s_q[REP][4][8][4];
  __shared__ float s_p[REP][kTile];     // scores, then probabilities
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

  long long p = pos[b];
  p = p < 0 ? 0 : (p > L - 1 ? L - 1 : p);
  const int n_keys = static_cast<int>(p) + 1;
  const int n_tiles = (n_keys + kTile - 1) / kTile;

  const size_t kv0 = (static_cast<size_t>(b) * Hkv + g) *
                     static_cast<size_t>(L) * kD;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k + kv0);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v + kv0);
  auto load_tile = [&](int slot, int t) {
    unsigned char* dst = ring + slot * kStageBytes;
    const int key0 = t * kTile;
    for (int c = tid; c < kTile * kRow / 16; c += kThreads) {
      const int j = c / (kRow / 16), off = (c % (kRow / 16)) * 16;
      const bool ok = key0 + j < n_keys;
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

  // feature of (i, c, e): lane c holds [8c, 8c+8) and [64+8c, 64+8c+8)
  const size_t head0 = static_cast<size_t>(b) * Hq +
                       static_cast<size_t>(g) * rep + part * REP;
  for (int idx = tid; idx < REP * kD; idx += kThreads) {
    const int h = idx / kD, r = idx % kD;
    const int i = r / 32, c = (r % 32) / 4, e = r % 4;
    const int d = (i >> 1) * 64 + 8 * c + (i & 1) * 4 + e;
    const size_t at = (head0 + h) * kD + d;
    s_q[h][i][c][e] =
        (q_f32 ? static_cast<const float*>(q)[at]
               : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])) *
        scale;
  }
  if (tid < REP) {
    s_m[tid] = -CUDART_INF_F;
    s_l[tid] = 0.f;
  }
  float acc[REP];
#pragma unroll
  for (int h = 0; h < REP; ++h) acc[h] = 0.f;

  const int kk = lane >> 3;             // key of this lane within a pass
  const int c8 = lane & 7;              // this lane's 16 features
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();       // this thread's copies of tile t
    __syncthreads();                    // everyone's; slot t-1 is free
    const int next = t + kStages - 1;
    if (next < n_tiles) load_tile(next % kStages, next);
    cp_async_commit();                  // (an empty group keeps the count)
    const unsigned char* ks = ring + (t % kStages) * kStageBytes;
    const __nv_bfloat16* vs =
        reinterpret_cast<const __nv_bfloat16*>(ks + kTile * kRow);
    const int tn = min(kTile, n_keys - t * kTile);

    // scores: warp w takes keys 8w .. 8w+7, four per pass
#pragma unroll
    for (int pass = 0; pass < kTile / kWarps / 4; ++pass) {
      const int j = warp * (kTile / kWarps) + pass * 4 + kk;
      float kf[16];
      unpack8(*reinterpret_cast<const uint4*>(ks + j * kRow + 16 * c8), kf);
      unpack8(*reinterpret_cast<const uint4*>(ks + j * kRow + 128 + 16 * c8),
              kf + 8);
#pragma unroll
      for (int h = 0; h < REP; ++h) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(s_q[h][i][c8]);
          d = fmaf(qv.x, kf[4 * i], d);
          d = fmaf(qv.y, kf[4 * i + 1], d);
          d = fmaf(qv.z, kf[4 * i + 2], d);
          d = fmaf(qv.w, kf[4 * i + 3], d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if (c8 == 0) s_p[h][j] = d;
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
    // P @ V: thread tid owns feature tid of every head in the group
#pragma unroll
    for (int h = 0; h < REP; ++h) acc[h] *= s_alpha[h];
    for (int j = 0; j < tn; ++j) {
      const float vj = __bfloat162float(vs[j * kD + tid]);
#pragma unroll
      for (int h = 0; h < REP; ++h) acc[h] = fmaf(s_p[h][j], vj, acc[h]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < REP; ++h) {
    const float l = s_l[h];
    const float y = l > 0.f ? acc[h] / l : 0.f;
    const size_t at = (head0 + h) * kD + tid;
    if (q_f32)
      static_cast<float*>(out)[at] = y;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(y);
  }
}

template <int REP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* out, int q_f32, int B, int Hq,
                   int Hkv, int L, float scale, cudaStream_t stream) {
  // the ring is above the 48 KB a block gets without asking
  const cudaError_t e = cudaFuncSetAttribute(
      decode_attention_kernel<REP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  decode_attention_kernel<REP><<<dim3(Hq / REP, B), kThreads, kSmem,
                                  stream>>>(
      q, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const long long*>(pos), out, q_f32, Hq, Hkv, L, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// a shape the kernel does not take (the Python wrapper checks first).
extern "C" int wt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int q_f32, int B, int Hq, int Hkv, int L,
                                   int D, float scale, void* stream) {
  if (D != kD || Hkv <= 0 || Hq % Hkv != 0 || L <= 0 || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int heads = 8;                        // heads per block: divides rep
  while ((Hq / Hkv) % heads) --heads;
#define WT_LAUNCH(R) \
  launch<R>(q, k, v, pos, out, q_f32, B, Hq, Hkv, L, scale, s)
  cudaError_t e;
  switch (heads) {
    case 1: e = WT_LAUNCH(1); break;
    case 2: e = WT_LAUNCH(2); break;
    case 3: e = WT_LAUNCH(3); break;
    case 4: e = WT_LAUNCH(4); break;
    case 5: e = WT_LAUNCH(5); break;
    case 6: e = WT_LAUNCH(6); break;
    case 7: e = WT_LAUNCH(7); break;
    default: e = WT_LAUNCH(8); break;
  }
#undef WT_LAUNCH
  return static_cast<int>(e);
}
