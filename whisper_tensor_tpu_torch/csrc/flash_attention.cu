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
//   k, v (B, Hkv, Skv, D) bf16, contiguous      D = 64 or 128
//   mask (1|B, 1, Sq, Skv) f32 contiguous, or none
//   pos  (B,) int64, or none                    out (B, Hq, Sq, D) bf16
//
// What bounds it on the H100: operations. A 2,048-token prompt at
// Llama-3-8B widths does 4 * D flops per visible (query, key) pair: about
// 34 GFLOP per layer over the causal triangle, 35 us at 989 TFLOP/s,
// against 4 MB of K/V (1.3 us at 3.35 TB/s). A 128-row piece is near
// balance. The design follows from that:
//   * the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate), which matches the TPU kernel's numerics;
//   * one block of 4 warps takes 64 query rows: 16 positions of each of 4
//     query heads of one GQA group (or 32 of 2, or 64 of 1, whichever
//     divides the group), so every K/V tile it loads serves the group's
//     heads, as in decode_attention.cu;
//   * the key loop stops at the tile holding the block's last visible key
//     (min(pos[b] + last row, Skv - 1); the TPU kernel's :320-323), so the
//     work follows the causal triangle and keys past it are never read;
//   * K and V tiles of 64 keys stream through shared memory in a cp.async
//     double buffer (70 KB at D = 128, set with cudaFuncSetAttribute);
//     rows are padded by 16 bytes so the fragment reads hit distinct banks;
//   * the ragged edges (Sq and Skv not multiples of the tiles) are masked
//     in the kernel: no padded copies of q, k or v.
// Left out of the TPU kernel, each for a reason:
//   * the KV-chunk carry (its carry / carry_out, :208-229, :366-373): it
//     exists because one head's whole K/V had to sit in VMEM; here K/V
//     stream through shared memory tile by tile, at any Skv;
//   * the padding of Sq and Skv to 128 (:231-243): the edges are masked;
//   * the environment knobs (WT_PALLAS_ATTENTION*, WT_FLASH_*) and the
//     4 GiB threshold on materialized scores (:171-172), a limit of the
//     TPU's memory; the port routes every eligible call here;
//   * TRACE_USES: the wrapper's launch counter takes its place.
// What it does not do yet: wgmma and TMA (Hopper's asynchronous
// warpgroup products and tile copies), a producer warp, and a split of
// the key range over blocks for grids smaller than the 132 SMs (a
// 128-row piece at B = 1 is 64 blocks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;      // query rows of a block
constexpr int kBK = 64;                 // keys per tile
constexpr int kPad = 8;                 // bf16 of padding per shared row

template <int D>
constexpr int smem_bytes() {
  return 2 * 2 * kBK * (D + kPad) * 2;  // 2 stages of a K and a V tile
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

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col). Fragments,
// with g = lane / 4 and t = lane % 4 (PTX ISA, mma.m16n8k16):
//   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   b0 (k 2t..2t+1, n g)   b1 (k 8+2t.., n g)
//   c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ mask,
                       const long long* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                       int Sq, int Skv, long long q_sb, long long q_sh,
                       long long q_ss, long long mask_sb, int causal,
                       int heads, float scale) {
  constexpr int kRow = D + kPad;        // shared row, in bf16
  constexpr int kTile = kBK * kRow;
  constexpr int kChunks = D / 8;        // 16-byte chunks of a key's row
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // [2][K | V]

  const int tq = kRows / heads;         // query positions of the block
  const int s0 = blockIdx.x * tq;
  const int h0 = blockIdx.y * heads;    // first query head of the block
  const int b = blockIdx.z;
  const int g = h0 / (Hq / Hkv);        // the KV head of its group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tc = lane & 3;
  const int wph = tq / 16;              // warps per query head
  const int h = h0 + warp / wph;        // this warp's query head
  const int r0 = s0 + (warp % wph) * 16;  // and its first query row

  // the last key any row of the block may see
  const int s_last = min(s0 + tq, Sq) - 1;
  long long last = Skv - 1;
  const long long pb = pos != nullptr ? pos[b] : 0;
  if (pos != nullptr) last = min(last, pb + s_last);
  if (causal) last = min(last, static_cast<long long>(s_last) + Skv - Sq);
  const int n_tiles = last < 0 ? 0 : static_cast<int>(last / kBK) + 1;

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
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

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

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows gr, gr + 8
  float l_run[2] = {0.f, 0.f};
  const float* mrow = mask != nullptr ? mask + b * mask_sb : nullptr;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile((t + 1) & 1, t + 1);
    cp_async_commit();                  // (an empty group keeps the count)
    cp_async_wait<1>();                 // this thread's copies of tile t
    __syncthreads();                    // and everyone's
    const __nv_bfloat16* ks = smem + (t & 1) * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + gr) * kRow + kk * 16 + 2 * tc;
        mma_bf16(sc[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, and the rows' maxima
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
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
        x = vis ? x : -CUDART_INF_F;
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
      alpha[r] = m_run[r] == -CUDART_INF_F ? 0.f : expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // p = exp(s - m), f32; masked (and all-masked) entries are 0
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[nt][e];
        const float p = x == -CUDART_INF_F ? 0.f : expf(x - m_run[e >> 1]);
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
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += bf16(P) V: the S accumulator of n-tiles 2j, 2j+1 is the A
    // fragment of keys 16j .. 16j + 15
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                             pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                             pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                             pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      const __nv_bfloat16* vr = vs + (16 * j + 2 * tc) * kRow + gr;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const __nv_bfloat16* c = vr + nt * 8;
        mma_bf16(o[nt], a, pack_raw(c[0], c[kRow]),
                 pack_raw(c[8 * kRow], c[9 * kRow]));
      }
    }
    __syncthreads();                    // stage t & 1 may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = r0 + gr + 8 * r;
    if (s >= Sq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * Hq + h) * Sq + s) * D + 2 * tc;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(o[nt][2 * r] / l, o[nt][2 * r + 1] / l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* pos, void* out, int B,
                   int Hq, int Hkv, int Sq, int Skv, long long q_sb,
                   long long q_sh, long long q_ss, long long mask_sb,
                   int causal, int heads, float scale, cudaStream_t stream) {
  // the double buffer is above the 48 KB a block gets without asking
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (e != cudaSuccess) return e;
  const int tq = kRows / heads;
  const dim3 grid((Sq + tq - 1) / tq, Hq / heads, B);
  flash_attention_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<const long long*>(pos), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, Sq, Skv, q_sb, q_sh, q_ss, mask_sb, causal, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// a shape the kernel does not take (the Python wrapper checks first).
// `mask` and `pos` may be null; q's strides (in elements) are per batch,
// head and row; mask_sb is 0 for a mask of batch 1.
extern "C" int wt_flash_attention(const void* q, const void* k,
                                  const void* v, const void* mask,
                                  const void* pos, void* out, int B, int Hq,
                                  int Hkv, int Sq, int Skv, int D,
                                  long long q_sb, long long q_sh,
                                  long long q_ss, long long mask_sb,
                                  int causal, float scale, void* stream) {
  if ((D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = Hq / Hkv;
  const int heads = rep % 4 == 0 ? 4 : (rep % 2 == 0 ? 2 : 1);
  if (Hq / heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      D == 64 ? launch<64>(q, k, v, mask, pos, out, B, Hq, Hkv, Sq, Skv,
                           q_sb, q_sh, q_ss, mask_sb, causal, heads, scale, s)
              : launch<128>(q, k, v, mask, pos, out, B, Hq, Hkv, Sq, Skv,
                            q_sb, q_sh, q_ss, mask_sb, causal, heads, scale,
                            s);
  return static_cast<int>(e);
}
