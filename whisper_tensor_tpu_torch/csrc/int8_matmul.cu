// W8A16 matmul for Hopper: y = (x @ W_i8) * scale[n], one rounding.
//
// Replaces the TPU kernel int8_matmul
// (whisper_tensor_tpu/backends/pallas/quant_matmul.py:68, pallas_call at
// :109). Same semantics: x (M, K) bf16 or f32, W (K, N) int8 row-major,
// scale (N,) f32; int8 values are exact in bf16 and f32, products and
// their sum are taken in f32, the per-column scale is applied in f32,
// and the result is rounded to x's type once. The reference's route of
// more than 512 rows to a cast and a dense dot (:81-89) is a limit of
// the TPU's scoped VMEM and is not carried over: K streams through
// shared memory in stages here, so the kernel takes every M. Nor is its
// need of aligned shapes: any K and N are taken (a row of x or of W that
// is not 16-byte aligned is staged by narrower loads).
//
// The launch plan (path, rows a block, K splits) is worked out by the
// wrapper (quant_matmul.py:int8_plan) and passed in; it sizes the grid
// by what wt_int8_limits (below) reads of each kernel on the card: rows
// of W a stage, columns a block, blocks a multiprocessor.
//
// (a) The decode path, on the CUDA cores (bf16 x up to the crossover,
// and f32 x at every M). Bound: the weight bytes, K * N of them, against
// a few operations a byte.
//   * a block owns a BM x 128 output tile (BM 1, 2, 4 or 8); stages of
//     128 rows of W (16 KB) and the matching x columns come in by 16-byte
//     cp.async copies in a ring of 4, so three are in flight while the
//     block computes on the fourth;
//   * K is split across blocks (blockIdx.z) whenever the row and column
//     blocks cannot fill the card: o and down (N = 4,096) give 32 column
//     blocks, so at M = 1 K runs in splits of whole stages. Each split
//     writes f32 partial sums to a scratch (splits, M, N); a second kernel
//     adds them in split order, scales and rounds once: no float atomics,
//     and repeats are bit-equal;
//   * thread t owns 16 columns and reads them as one 16-byte word of W a
//     row; a weight becomes a float without the converter: prmt puts the
//     byte, sign bit flipped, under the exponent of 2^23, and one
//     subtraction of 2^23 + 128 leaves its value exactly. Then one FMA a
//     row of x;
//   * the 32 slices of K a stage are added by two shuffles within each
//     warp and through shared memory across the 8 warps, in a fixed
//     order.
// (b) The prefill path, on the tensor cores (bf16 x from the crossover
// on). Bound: operations, 2 M K N.
//   * a block owns a TM x 128 output tile, TM = 16 (up to 16 rows), 64 or
//     128, as 8 warps; a stage is 64 rows of W (8 KB of int8) and its x
//     tile, in a cp.async ring of 3;
//   * each stage's int8 tile is converted once, in shared memory, to a
//     bf16 tile (exact: an int8 value has at most 8 significant bits, and
//     the f32 of the exponent trick above truncates to it exactly), and
//     the warps multiply it with bf16 x by mma.sync m16n8k16 with f32
//     accumulation (fragments by ldmatrix; B by its .trans form from the
//     k-major tile). Every product of a bf16 x and an int8 w is exact in
//     f32, so only the order of the sum differs from the plain version;
//   * the scale is applied in f32 in the epilogue, then one rounding;
//   * K is split as in (a) when the tiles do not fill the card.
//   What bounds it: the products, by mma.sync (wgmma and TMA are a later
//   step), and each stage's conversion between two barriers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "device_common.cuh"

namespace {

// Byte c of a word of int8 values whose sign bits were flipped (u = q +
// 128), as the exact f32 q: prmt builds the float 2^23 + u (byte c, two
// zero bytes, 0x4B), and 2^23 + u - (2^23 + 128) is q, exactly.
__device__ __forceinline__ float i8_value(uint32_t flipped, int c) {
  return __int_as_float(prmt(flipped, 0x4B000000u, 0x7440u | c)) -
         8388736.f;
}

// Four bytes of a W row from device memory, zero past N or past the
// split: the path for rows that are not 16-byte aligned (N % 16 != 0).
__device__ __forceinline__ uint32_t load_bytes(const int8_t* __restrict__ w,
                                               size_t row_at, int n, int N,
                                               bool row_ok) {
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (row_ok && n + e < N)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(w[row_at + n + e]))
           << (8 * e);
  return v;
}

// -- (a) the decode path: CUDA cores, K split across blocks ------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;                     // output columns a block
constexpr int kCols = 16;                    // columns a thread (16 bytes)
constexpr int kGroups = kBN / kCols;         // 8 column groups
constexpr int kSlices = kThreads / kGroups;  // 32 slices of a stage
constexpr int kRows = 128;                   // rows of W a stage
constexpr int kPer = kRows / kSlices;        // 4 rows a slice a stage
constexpr int kStages = 4;                   // cp.async ring depth
constexpr int kWTile = kRows * kBN;          // bytes of W a stage

template <typename T, int BM>
__host__ __device__ constexpr int cores_stage_bytes() {
  return kWTile + BM * kRows * static_cast<int>(sizeof(T));
}
// the ring, or the warps' partial sums where larger
template <typename T, int BM>
__host__ __device__ constexpr int cores_smem_bytes() {
  return kStages * cores_stage_bytes<T, BM>() > kWarps * BM * kBN * 4
             ? kStages * cores_stage_bytes<T, BM>()
             : kWarps * BM * kBN * 4;
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
int8_cores_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, T* __restrict__ out,
                  float* __restrict__ part, int M, int K, int N, int kchunk,
                  int x_aligned, int w_aligned) {
  constexpr int kStage = cores_stage_bytes<T, BM>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid % kGroups;             // this thread's 16 columns
  const int sl = tid / kGroups;              // and its slice of a stage
  const int kbeg = split * kchunk;           // this split's rows of W
  const int kend = min(kbeg + kchunk, K);
  const int nk = (kend - kbeg + kRows - 1) / kRows;

  auto load_stage = [&](int slot, int kt) {
    const int r0 = kbeg + kt * kRows;
    unsigned char* base = smem + slot * kStage;
    if (w_aligned) {
      for (int c = tid; c < kWTile / 16; c += kThreads) {
        const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
        const bool ok = r0 + r < kend && n0 + col < N;
        const int8_t* src =
            ok ? w + static_cast<size_t>(r0 + r) * N + n0 + col : w;
        cp_async16(base + r * kBN + col, src, ok);
      }
    } else {
      for (int c = tid; c < kWTile / 4; c += kThreads) {
        const int r = c / (kBN / 4), col = (c % (kBN / 4)) * 4;
        *reinterpret_cast<uint32_t*>(base + r * kBN + col) =
            load_bytes(w, static_cast<size_t>(r0 + r) * N, n0 + col, N,
                       r0 + r < kend);
      }
    }
    T* xdst = reinterpret_cast<T*>(base + kWTile);
    if (x_aligned) {
      constexpr int kE = 16 / static_cast<int>(sizeof(T));   // x a copy
      for (int c = tid; c < BM * kRows / kE; c += kThreads) {
        const int r = c / (kRows / kE), kc = (c % (kRows / kE)) * kE;
        const bool ok = m0 + r < M && r0 + kc < kend;
        const T* src = ok ? x + static_cast<size_t>(m0 + r) * K + r0 + kc : x;
        cp_async16(xdst + r * kRows + kc, src, ok);
      }
    } else {
      for (int c = tid; c < BM * kRows; c += kThreads) {
        const int r = c / kRows, kc = c % kRows;
        xdst[r * kRows + kc] =
            m0 + r < M && r0 + kc < kend
                ? x[static_cast<size_t>(m0 + r) * K + r0 + kc]
                : from_f32<T>(0.f);
      }
    }
  };

  float acc[BM][kCols];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage kt
    __syncthreads();                // everyone's; slot kt-1 is free again
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, next);
    cp_async_commit();              // (an empty group keeps the count)
    const unsigned char* base = smem + (kt % kStages) * kStage;
    const T* xt = reinterpret_cast<const T*>(base + kWTile);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // the 4 slices of a warp take 4 adjacent rows: 8 lanes a 128-byte
      // row, conflict-free
      const int k = j * kSlices + sl;
      const uint4 q = *reinterpret_cast<const uint4*>(base + k * kBN +
                                                      kCols * grp);
      const uint32_t words[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                                 q.z ^ 0x80808080u, q.w ^ 0x80808080u};
      float wv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) wv[c] = i8_value(words[c / 4], c % 4);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float xv = to_f32(xt[r * kRows + k]);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 4 slices of each warp by shuffles (lane bits 3 and 4), then the 8
  // warps through shared memory (the ring is free now), in a fixed order;
  // scale and round once, or keep f32 for the split sum
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][c] = v;
    }
  float* red = reinterpret_cast<float*>(smem);      // [warp][BM][kBN]
  if (lane < kGroups) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < kCols; c += 4)
        *reinterpret_cast<float4*>(red + (warp * BM + r) * kBN + kCols * grp +
                                   c) =
            make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2],
                        acc[r][c + 3]);
  }
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN, col = i % kBN;
    const int m = m0 + r, n = n0 + col;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[(v * BM + r) * kBN + col];
    const size_t at = static_cast<size_t>(m) * N + n;
    if (part != nullptr)
      part[static_cast<size_t>(split) * M * N + at] = s;
    else
      out[at] = from_f32<T>(s * scale[n]);
  }
}

// -- (b) the prefill path: tensor cores --------------------------------------

constexpr int kTThreads = 256;               // 8 warps
constexpr int kTN = 128;                     // output columns a block
constexpr int kTK = 64;                      // rows of W a stage
constexpr int kTStages = 3;                  // cp.async ring depth
constexpr int kXRow = kTK + 8;               // bf16 a row of x in smem
constexpr int kWRow = kTN + 8;               // bf16 a row of the W tile
constexpr int kQTile = kTK * kTN;            // bytes of int8 W a stage
constexpr int kWTileT = kTK * kWRow * 2;     // bytes of the bf16 W tile

// TM output rows a block: the 8 warps as WM (along M) x 8/WM (along N),
// each on MT x NT m16n8 tiles.
template <int TM> struct TShape;
template <> struct TShape<16> {
  static constexpr int WM = 1, MT = 1, NT = 2;
};
template <> struct TShape<64> {
  static constexpr int WM = 2, MT = 2, NT = 4;
};
template <> struct TShape<128> {
  static constexpr int WM = 2, MT = 4, NT = 4;
};

template <int TM>
__host__ __device__ constexpr int tensor_stage_bytes() {
  return kQTile + TM * kXRow * 2;
}
template <int TM>
__host__ __device__ constexpr int tensor_smem_bytes() {
  return kWTileT + kTStages * tensor_stage_bytes<TM>();
}

// (at least two blocks a multiprocessor, so that one block's conversion
// overlaps another's products; four of the 16-row tiles)
template <int TM>
__global__ void __launch_bounds__(kTThreads, TM == 16 ? 4 : 2)
int8_tensor_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int M, int K, int N, int kchunk, int x_aligned,
                   int w_aligned) {
  constexpr int kStage = tensor_stage_bytes<TM>();
  constexpr int WM = TShape<TM>::WM, WN = 8 / WM;
  constexpr int MT = TShape<TM>::MT, NT = TShape<TM>::NT;
  static_assert(WM * MT * 16 == TM && WN * NT * 8 == kTN, "warp tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wbf = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTK][kWRow]
  unsigned char* ring = smem + kWTileT;

  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * kTN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kbeg = split * kchunk;
  const int kend = min(kbeg + kchunk, K);
  const int nk = (kend - kbeg + kTK - 1) / kTK;

  auto load_stage = [&](int slot, int kt) {
    const int r0 = kbeg + kt * kTK;
    unsigned char* base = ring + slot * kStage;
    if (w_aligned) {
      for (int c = tid; c < kQTile / 16; c += kTThreads) {
        const int r = c / (kTN / 16), col = (c % (kTN / 16)) * 16;
        const bool ok = r0 + r < kend && n0 + col < N;
        const int8_t* src =
            ok ? w + static_cast<size_t>(r0 + r) * N + n0 + col : w;
        cp_async16(base + r * kTN + col, src, ok);
      }
    } else {
      for (int c = tid; c < kQTile / 4; c += kTThreads) {
        const int r = c / (kTN / 4), col = (c % (kTN / 4)) * 4;
        *reinterpret_cast<uint32_t*>(base + r * kTN + col) =
            load_bytes(w, static_cast<size_t>(r0 + r) * N, n0 + col, N,
                       r0 + r < kend);
      }
    }
    __nv_bfloat16* xdst = reinterpret_cast<__nv_bfloat16*>(base + kQTile);
    if (x_aligned) {
      for (int c = tid; c < TM * kTK / 8; c += kTThreads) {
        const int r = c / (kTK / 8), kc = (c % (kTK / 8)) * 8;
        const bool ok = m0 + r < M && r0 + kc < kend;
        const __nv_bfloat16* src =
            ok ? x + static_cast<size_t>(m0 + r) * K + r0 + kc : x;
        cp_async16(xdst + r * kXRow + kc, src, ok);
      }
    } else {
      for (int c = tid; c < TM * kTK; c += kTThreads) {
        const int r = c / kTK, kc = c % kTK;
        xdst[r * kXRow + kc] =
            m0 + r < M && r0 + kc < kend
                ? x[static_cast<size_t>(m0 + r) * K + r0 + kc]
                : __float2bfloat16(0.f);
      }
    }
  };

  // the stage's int8 tile as bf16, k-major (kTK x kTN): the f32 of
  // i8_value truncated to its top half, exactly
  auto convert = [&](const unsigned char* base) {
#pragma unroll
    for (int i = tid; i < kQTile / 4; i += kTThreads) {
      const int r = i / (kTN / 4), c4 = (i % (kTN / 4)) * 4;
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(base + r * kTN + c4) ^
          0x80808080u;
      const uint32_t f0 = __float_as_uint(i8_value(v, 0));
      const uint32_t f1 = __float_as_uint(i8_value(v, 1));
      const uint32_t f2 = __float_as_uint(i8_value(v, 2));
      const uint32_t f3 = __float_as_uint(i8_value(v, 3));
      *reinterpret_cast<uint2*>(wbf + r * kWRow + c4) =
          make_uint2(prmt(f0, f1, 0x7632u), prmt(f2, f3, 0x7632u));
    }
  };

  const int wm = warp / WN, wn = warp % WN;  // MT*16 x NT*8 of the tile
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTStages - 2>();  // this thread's copies of stage kt
    __syncthreads();                // everyone's; W tile and slot kt-1 free
    const int next = kt + kTStages - 1;
    if (next < nk) load_stage(next % kTStages, next);
    cp_async_commit();
    const unsigned char* base = ring + (kt % kTStages) * kStage;
    convert(base);
    __syncthreads();
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(base + kQTile);
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xs + (wm * MT * 16 + mt * 16 + (lane & 15)) *
                                    kXRow + kk * 16 + (lane >> 4) * 8);
      uint32_t b[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, wbf + (kk * 16 + (lane & 15)) * kWRow +
                                 wn * NT * 8 + np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8; the scale in
  // f32, then one rounding (or f32 partial sums for the split sum)
  const int gr = lane >> 2, tc = lane & 3;
  const bool pairs = part == nullptr && N % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + mt * 16 + gr + 8 * h;
        const int col = n0 + wn * NT * 8 + nt * 8 + 2 * tc;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        const size_t at = static_cast<size_t>(row) * N + col;
        if (part != nullptr) {
          float* p = part + static_cast<size_t>(split) * M * N + at;
          if (col < N) p[0] = v0;
          if (col + 1 < N) p[1] = v1;
        } else if (pairs && col + 1 < N) {
          *reinterpret_cast<uint32_t*>(out + at) =
              pack_bf16(v0 * scale[col], v1 * scale[col + 1]);
        } else {
          if (col < N) out[at] = __float2bfloat16(v0 * scale[col]);
          if (col + 1 < N) out[at + 1] = __float2bfloat16(v1 * scale[col + 1]);
        }
      }
}

// -- the second pass: the splits' partial sums in order, scaled, rounded -----

template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, long long MN, int N,
                                  int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * MN + i];
    out[i] = from_f32<T>(s * scale[i % N]);
  }
}

// the split sum: a grid-stride loop over M x N, 16 blocks a multiprocessor
template <typename T>
cudaError_t sum_splits(const float* part, const float* scale, void* out,
                       int M, int N, int splits, int sms, cudaStream_t s) {
  const long long MN = static_cast<long long>(M) * N;
  const long long want = (MN + 255) / 256;
  const long long most = 16LL * sms;
  sum_splits_kernel<T><<<static_cast<int>(want < most ? want : most), 256, 0,
                         s>>>(part, scale, static_cast<T*>(out), MN, N,
                              splits);
  return cudaGetLastError();
}

// The dynamic shared memory of a kernel, allowed on the current device.
template <typename T, int BM>
cudaError_t cores_smem(int* smem) {
  *smem = cores_smem_bytes<T, BM>();
  static int allowed[kDevices] = {};
  return allow_smem(int8_cores_kernel<T, BM>, *smem, allowed);
}
template <int TM>
cudaError_t tensor_smem(int* smem) {
  *smem = tensor_smem_bytes<TM>();
  static int allowed[kDevices] = {};
  return allow_smem(int8_tensor_kernel<TM>, *smem, allowed);
}

template <typename T, int BM>
cudaError_t launch_cores(const void* x, const void* w, const float* scale,
                         void* out, float* part, int M, int K, int N,
                         int splits, int kchunk, cudaStream_t stream) {
  int smem = 0;
  cudaError_t e = cores_smem<T, BM>(&smem);
  if (e != cudaSuccess) return e;
  // blockIdx.x walks M: blocks that share a weight panel run together
  const dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN, splits);
  int8_cores_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<T*>(out), splits > 1 ? part : nullptr, M, K, N, kchunk,
      (static_cast<long long>(K) * sizeof(T)) % 16 == 0, N % 16 == 0);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_tensor(const void* x, const void* w, const float* scale,
                          void* out, float* part, int M, int K, int N,
                          int splits, int kchunk, cudaStream_t stream) {
  int smem = 0;
  cudaError_t e = tensor_smem<TM>(&smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + TM - 1) / TM, (N + kTN - 1) / kTN, splits);
  int8_tensor_kernel<TM><<<grid, kTThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      scale, static_cast<__nv_bfloat16*>(out), splits > 1 ? part : nullptr, M,
      K, N, kchunk, K % 8 == 0, N % 16 == 0);
  return cudaGetLastError();
}

// f(std::integral_constant<int, BM>) for the decode path's rows a block
template <typename F>
cudaError_t with_rows(int bm, F&& f) {
  switch (bm) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}
// the same for the tensor path's tile rows
template <typename F>
cudaError_t with_tile(int tm, F&& f) {
  switch (tm) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

bool valid_rows(int path, int bm, int x_is_bf16) {
  if (path == 0) return bm == 1 || bm == 2 || bm == 4 || bm == 8;
  return path == 1 && x_is_bf16 && (bm == 16 || bm == 64 || bm == 128);
}

}  // namespace

// The limits the wrapper's plan (int8_plan) sizes its grid by, for the
// kernel that `path` (0 the decode path, 1 the tensor cores), `bm` and
// x's type pick: limits[0] its rows of W a stage (its K splits are whole
// stages), limits[1] its output columns a block, limits[2] the blocks of
// it one multiprocessor of the current device runs at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the shared memory its
// launch gives it). Returns a CUDA error code, cudaErrorInvalidValue for
// a kernel there is not.
extern "C" int wt_int8_limits(int path, int bm, int x_is_bf16, int* limits) {
  if (limits == nullptr || !valid_rows(path, bm, x_is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (path == 1) {
    limits[0] = kTK;
    limits[1] = kTN;
    e = with_tile(bm, [&](auto TM) {
      constexpr int tm = decltype(TM)::value;
      int smem = 0;
      cudaError_t r = tensor_smem<tm>(&smem);
      if (r != cudaSuccess) return r;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          limits + 2, int8_tensor_kernel<tm>, kTThreads, smem);
    });
  } else {
    limits[0] = kRows;
    limits[1] = kBN;
    e = with_rows(bm, [&](auto BM) {
      constexpr int b = decltype(BM)::value;
      int smem = 0;
      cudaError_t r;
      if (x_is_bf16) {
        r = cores_smem<__nv_bfloat16, b>(&smem);
        if (r != cudaSuccess) return r;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            limits + 2, int8_cores_kernel<__nv_bfloat16, b>, kThreads, smem);
      }
      r = cores_smem<float, b>(&smem);
      if (r != cudaSuccess) return r;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          limits + 2, int8_cores_kernel<float, b>, kThreads, smem);
    });
  }
  return static_cast<int>(e);
}

// One call: the kernel of `path` (0: the decode path with `bm` rows of x
// a block, 1: the tensor-core path with tiles of `bm` = 16, 64 or 128
// rows), K split into `splits` runs of `kchunk` rows of W; when splits >
// 1 the partial sums go to `part` (f32, splits x M x N) and a second
// kernel adds them, scales and rounds into `out` (its grid sized by
// `sms`, the device's multiprocessors). Returns cudaGetLastError() after
// the launches; cudaErrorInvalidValue for a shape or plan the kernels do
// not take (the Python wrapper checks first).
extern "C" int wt_int8_matmul(const void* x, const void* w, const void* scale,
                              void* out, void* part, int M, int K, int N,
                              int x_is_bf16, int path, int bm, int splits,
                              int kchunk, int sms, void* stream) {
  const int stage = path == 1 ? kTK : kRows;
  if (M <= 0 || K <= 0 || N <= 0 || !valid_rows(path, bm, x_is_bf16) ||
      splits < 1 || splits > 65535 || kchunk <= 0 || kchunk % stage != 0 ||
      sms <= 0 || static_cast<long long>(splits) * kchunk < K ||
      static_cast<long long>(splits - 1) * kchunk >= K ||
      (splits > 1 && part == nullptr) || (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaError_t e;
  if (path == 1) {
    e = with_tile(bm, [&](auto TM) {
      return launch_tensor<decltype(TM)::value>(x, w, sc, out, p, M, K, N,
                                                splits, kchunk, s);
    });
  } else if (x_is_bf16) {
    e = with_rows(bm, [&](auto BM) {
      return launch_cores<__nv_bfloat16, decltype(BM)::value>(
          x, w, sc, out, p, M, K, N, splits, kchunk, s);
    });
  } else {
    e = with_rows(bm, [&](auto BM) {
      return launch_cores<float, decltype(BM)::value>(x, w, sc, out, p, M, K,
                                                      N, splits, kchunk, s);
    });
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  e = x_is_bf16 ? sum_splits<__nv_bfloat16>(p, sc, out, M, N, splits, sms, s)
                : sum_splits<float>(p, sc, out, M, N, splits, sms, s);
  return static_cast<int>(e);
}
