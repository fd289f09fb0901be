// The backward of the W8A16 matmul for x: dx = (dy * scale) @ W_i8^T.
//
// y = (x @ W_i8) * scale[n] is int8_matmul (csrc/int8_matmul.cu, which
// replaces the TPU kernel int8_matmul,
// whisper_tensor_tpu/backends/pallas/quant_matmul.py:68). The JAX package
// has no Pallas backward: jax.grad differentiates its cast-and-dot
// fallback (:85-89), whose transpose sums (dy[m, n] * scale[n]) * W[k, n]
// over n in f32 and rounds once to dy's type. This file computes the
// same: dy (M, N) bf16 or f32, W (K, N) int8 row-major, scale (N,) f32,
// dx (M, K) in dy's type. It is the port's own (quant_matmul.Int8MatMul's
// backward), for the frozen int8 base of QLoRA training.
//
// What bounds it: operations, 2 M K N (at QLoRA's M = 1,024 every shape
// is far above the card's ridge). The numerics, on both paths: the scale
// lies along the reduction, so it cannot be applied after the sum, and
// bf16(dy * scale) loses the bits agreement needs. v = dy * scale is
// taken in f32 and split into bf16 hi = bf16(v) and lo = bf16(v - hi):
// 16 of v's 24 bits, an error of at most 2^-17 of |v|. Two bf16 tensor
// products, hi @ W and lo @ W, go into one f32 accumulator: int8 values
// are exact in bf16 and every product of two bf16 values is exact in f32,
// so only the split and the order of the sum differ from the plain
// version (agreement_bound holds). W's row k is contiguous over the
// reduction index n, so W as it lies is the K-major operand of the
// product: no transposed copy of the frozen weight is made.
//
// Two paths, chosen by shape (quant_matmul.dx_plan):
//
// (a) The TMA path (dx_wgmma_kernel), for N % 16 == 0 (W's rows are whole
// 16-byte units, as a tensor map needs) and K % 8 (bf16) or % 4 (f32):
//   * a block owns a 128 x 256 tile of dx (rows of dy, rows of W) and 3
//     warpgroups: two consumers and a loading warpgroup. The loading
//     warpgroup's first lane keeps TMA loads in flight, 2 stages ahead
//     of the conversion, into a ring of 4 stages (3 for f32 dy) of 64
//     reduction columns: W's 256 x 64 int8 tile, dy's 128 x 64 tile
//     (128-byte swizzle) and the scale's 64 values, each stage guarded
//     by a full and an empty mbarrier;
//   * each stage's int8 tile is converted once, by prmt (i8x4_to_bf16),
//     into the bf16 B tile of the product (K-major, 128-byte swizzle:
//     the layout a wgmma descriptor reads) in a ring of 2: the loading
//     warpgroup converts its first 128 rows, and the consumers convert
//     the other 128 while the previous stage's products run. The
//     conversion is what the tensor cores wait on (without it the
//     kernel would run at most three quarters of its time), and the
//     split between the warpgroups was chosen by timing
//     (scripts/int8_dx_variants.py, PERF.md);
//   * two consumer warpgroups, 64 rows each, read dy and the scale from
//     the staged tile, take v = dy * scale in f32 and split it into hi and
//     lo directly in wgmma's register A fragments, and issue two
//     wgmma.mma_async m64n256k16 (hi, lo) against the same B descriptor
//     for each 16 columns: the split's first pass, its 4 M N-byte
//     scratch and the scratch's rereads are gone. The next 16 columns'
//     fragments are built while the products of these are in flight
//     (wgmma.wait_group 1);
//   * setmaxnreg gives the consumers, whose accumulator is 128 f32 a
//     thread, 224 registers and the loading warpgroup 56 (168 each at
//     launch);
//   * blockIdx.x walks M, so the blocks that share a panel of W run
//     together and read it from L2.
// (b) The cp.async path (dx_split_kernel, dx_mma_kernel), for every other
// shape (N odd, say): a first pass writes hi and lo to a scratch of rows
// padded to whole 32-column stages; the product runs mma.sync m16n8k16
// over 128 x 128 tiles of dx as 8 warps, staging W by 16-byte cp.async
// (by plain loads where its rows are not 16-byte aligned) and the scratch
// in a ring of 3, and converting each int8 tile to bf16 in shared memory
// between two barriers. Any M, K and N, no row cap.
// On both paths a grid under one wave of blocks splits the reduction
// (blockIdx.z, whole stages, dx_plan); the splits' f32 partial sums are
// then added in a fixed order by a second kernel (dx_sum_kernel): no
// atomics, so the result is the same from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "device_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;                // 8 warps
constexpr int kTM = 128;                     // rows of dy and dx a block
constexpr int kTK = 128;                     // columns of dx (rows of W)
constexpr int kBN = 32;                      // reduction columns a stage
constexpr int kStages = 3;                   // cp.async ring depth
constexpr int kRow = kBN + 8;                // bf16 a row of the tiles
constexpr int kATile = kTM * kRow * 2;       // bytes of a hi or lo tile
constexpr int kWRaw = kTK * kBN;             // bytes of the int8 W tile
constexpr int kStage = kWRaw + 2 * kATile;   // W raw, hi, lo
constexpr int kSmem = kTK * kRow * 2 + kStages * kStage;   // + W as bf16
constexpr int kMT = 4, kNT = 4;              // a warp's m16 x n8 tiles

// v = dy * scale[n] in f32, split into bf16 hi + lo, written to rows of
// `np` columns (np a whole number of stages; the columns past N zero)
template <typename T>
__global__ void dx_split_kernel(const T* __restrict__ dy,
                                const float* __restrict__ scale,
                                __nv_bfloat16* __restrict__ hi,
                                __nv_bfloat16* __restrict__ lo, int M,
                                int N, int np) {
  const long long total = static_cast<long long>(M) * np;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i % np);
    const long long m = i / np;
    const float v = n < N ? to_f32(dy[m * N + n]) * scale[n] : 0.f;
    const __nv_bfloat16 h = __float2bfloat16(v);
    hi[i] = h;
    lo[i] = __float2bfloat16(v - __bfloat162float(h));
  }
}

__global__ void __launch_bounds__(kThreads, 2)
dx_mma_kernel(const __nv_bfloat16* __restrict__ hi,
              const __nv_bfloat16* __restrict__ lo,
              const int8_t* __restrict__ w, __nv_bfloat16* __restrict__ dxb,
              float* __restrict__ dxf, float* __restrict__ part, int M,
              int K, int N, int np, int w_aligned, int split_st) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wbf = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTK][kRow]
  unsigned char* ring = smem + kTK * kRow * 2;

  const int m0 = blockIdx.x * kTM;
  const int k0 = blockIdx.y * kTK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the stages of this block's split of the reduction (blockIdx.z)
  const int sb = blockIdx.z * split_st;
  const int nst = min(np / kBN, sb + split_st) - sb;

  // stage `st` (reduction columns st * kBN ..) into ring slot `slot`:
  // [W: kTK x kBN int8][hi: kTM x kRow bf16][lo: kTM x kRow bf16]
  auto load_stage = [&](int slot, int st) {
    const int n0 = (sb + st) * kBN;
    unsigned char* base = ring + slot * kStage;
    if (w_aligned) {
      for (int c = tid; c < kWRaw / 16; c += kThreads) {
        const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
        const bool ok = k0 + r < K && n0 + col < N;
        const int8_t* src =
            ok ? w + static_cast<size_t>(k0 + r) * N + n0 + col : w;
        cp_async16(base + r * kBN + col, src, ok);
      }
    } else {
      for (int c = tid; c < kWRaw; c += kThreads) {
        const int r = c / kBN, col = c % kBN;
        base[r * kBN + col] =
            k0 + r < K && n0 + col < N
                ? static_cast<unsigned char>(
                      w[static_cast<size_t>(k0 + r) * N + n0 + col])
                : 0;
      }
    }
    // hi and lo: 8 bf16 a copy, kBN / 8 copies a row, rows past M zero
    for (int c = tid; c < 2 * kTM * (kBN / 8); c += kThreads) {
      const int part = c / (kTM * (kBN / 8));
      const int rc = c % (kTM * (kBN / 8));
      const int r = rc / (kBN / 8), col = (rc % (kBN / 8)) * 8;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src = part ? lo : hi;
      src += ok ? static_cast<size_t>(m0 + r) * np + n0 + col : 0;
      cp_async16(base + kWRaw + part * kATile + (r * kRow + col) * 2, src,
                 ok);
    }
  };

  // the staged int8 tile as bf16, exactly
  auto convert = [&](const unsigned char* base) {
    for (int i = tid; i < kWRaw / 4; i += kThreads) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const uint32_t q = *reinterpret_cast<const uint32_t*>(base + r * kBN + c);
      const float f0 = static_cast<float>(static_cast<int8_t>(q & 0xFF));
      const float f1 = static_cast<float>(static_cast<int8_t>((q >> 8) & 0xFF));
      const float f2 = static_cast<float>(static_cast<int8_t>((q >> 16) & 0xFF));
      const float f3 = static_cast<float>(static_cast<int8_t>(q >> 24));
      *reinterpret_cast<uint2*>(wbf + r * kRow + c) =
          make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
    }
  };

  const int wm = warp / 4, wn = warp % 4;     // 64 x 32 of the tile
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage st
    __syncthreads();                // everyone's; wbf and slot st-1 free
    const int next = st + kStages - 1;
    if (next < nst) load_stage(next % kStages, next);
    cp_async_commit();              // (an empty group keeps the count)
    const unsigned char* base = ring + (st % kStages) * kStage;
    convert(base);
    __syncthreads();
    const __nv_bfloat16* ahi =
        reinterpret_cast<const __nv_bfloat16*>(base + kWRaw);
    const __nv_bfloat16* alo =
        reinterpret_cast<const __nv_bfloat16*>(base + kWRaw + kATile);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      // B fragments: W's rows are the product's columns, k-contiguous
      // (lanes 0-7 rows 0-7 at k 0, 8-15 rows 0-7 at k 8, 16-23 rows
      // 8-15 at k 0, 24-31 rows 8-15 at k 8)
      uint32_t b[kNT][2];
#pragma unroll
      for (int np2 = 0; np2 < kNT / 2; ++np2) {
        uint32_t r[4];
        ldmatrix_x4(r, wbf + (wn * 32 + np2 * 16 + (lane & 7) +
                              ((lane >> 4) << 3)) * kRow +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        b[2 * np2][0] = r[0];
        b[2 * np2][1] = r[1];
        b[2 * np2 + 1][0] = r[2];
        b[2 * np2 + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int at = (wm * 64 + mt * 16 + (lane & 15)) * kRow + kk * 16 +
                       (lane >> 4) * 8;
        uint32_t a[4];
        ldmatrix_x4(a, alo + at);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        ldmatrix_x4(a, ahi + at);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8; one rounding
  // to dx's type (bf16 into dxb, or f32 into dxf), or an f32 partial sum
  // of the split blockIdx.z
  const int gr = lane >> 2, tc = lane & 3;
  float* outf = part == nullptr
                    ? dxf
                    : part + static_cast<size_t>(blockIdx.z) * M * K;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + gr + 8 * h;
        const int col = k0 + wn * 32 + nt * 8 + 2 * tc;
        if (row >= M) continue;
        const size_t at = static_cast<size_t>(row) * K + col;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (outf != nullptr) {
          if (col < K) outf[at] = v0;
          if (col + 1 < K) outf[at + 1] = v1;
        } else {
          if (col < K) dxb[at] = __float2bfloat16(v0);
          if (col + 1 < K) dxb[at + 1] = __float2bfloat16(v1);
        }
      }
}

// dx = the splits' partial sums, added in split order, rounded once
template <typename T>
__global__ void dx_sum_kernel(const float* __restrict__ part,
                              T* __restrict__ dx, long long mk, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mk; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = part[i];
    for (int p = 1; p < splits; ++p) v += part[p * mk + i];
    dx[i] = from_f32<T>(v);
  }
}

// the sums of `splits` > 1 partial sums into dx (M, K), on stream s
template <typename T>
cudaError_t sum_splits(const float* part, void* dx, int M, int K, int splits,
                       int sms, cudaStream_t s) {
  const long long mk = static_cast<long long>(M) * K;
  const long long want = (mk + 255) / 256, most = 8LL * sms;
  dx_sum_kernel<T><<<static_cast<int>(want < most ? want : most), 256, 0,
                     s>>>(part, static_cast<T*>(dx), mk, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t split(const void* dy, const float* scale, __nv_bfloat16* hi,
                  __nv_bfloat16* lo, int M, int N, int np, int sms,
                  cudaStream_t s) {
  const long long total = static_cast<long long>(M) * np;
  const long long want = (total + 255) / 256;
  const long long most = 16LL * sms;
  dx_split_kernel<T><<<static_cast<int>(want < most ? want : most), 256, 0,
                       s>>>(static_cast<const T*>(dy), scale, hi, lo, M, N,
                            np);
  return cudaGetLastError();
}

// -- (a) the TMA path -----------------------------------------------------

constexpr int kWThreads = 384;    // consumers 0-7, loading warpgroup 8-11
constexpr int kWM = 128;          // rows of dy and dx a block (64 a consumer)
constexpr int kWK = 256;          // columns of dx (rows of W) a block
constexpr int kWBN = 64;          // reduction columns a stage
constexpr int kBTile = kWK * kWBN * 2;   // the bf16 B tile: 256 rows x 128 B
constexpr int kBBufs = 2;                // B tiles in their ring
constexpr int kWRawBytes = kWK * kWBN;   // the int8 W tile
constexpr int kScaleBytes = kWBN * 4;
// each of an SM's 4 schedulers holds one warp of each warpgroup: 168
// registers a lane each at launch (__launch_bounds__), then the loading
// warpgroup gives up what the consumers take (224 + 224 + 56)
constexpr int kConsumerRegs = 224, kLoaderRegs = 56;
constexpr int kLoaderUnits = 1024;       // of a B tile's 2,048 units

// a stage: [dy tile][W int8 tile][scale], 1,024-byte aligned (the swizzled
// dy tile's rows are read as TMA wrote them: chunk ^ (row % 8))
template <bool kBf16> struct DxLayout {
  static constexpr int kDyBytes = kWM * kWBN * (kBf16 ? 2 : 4);
  static constexpr int kStages = kBf16 ? 4 : 3;   // what fits 227 KB
  static constexpr int kTx = kDyBytes + kWRawBytes + kScaleBytes;
  static constexpr int kStage = (kTx + 1023) / 1024 * 1024;
  static constexpr int kBarsAt = kBBufs * kBTile + kStages * kStage;
  static constexpr int kSmem = kBarsAt + 1024 + 1024;  // barriers, alignment
};

// v = dy * scale for the A fragment of one consumer thread at the k16
// step kk of a staged tile: rows r and r + 8 of the tile (r % 8 == g),
// columns 16 kk + 2t, +1 and 16 kk + 8 + 2t, +1, split into hi (f[0..3])
// and lo (f[4..7]) in wgmma's order (dy row-major, 128-byte swizzled:
// bf16 rows of 64 values, f32 as two tiles of 32 columns)
template <bool kBf16>
__device__ __forceinline__ void dx_fragment(uint32_t* f,
                                            const unsigned char* dyt,
                                            const float* sc, int r, int g,
                                            int t, int kk) {
  float2 d[4];   // (r, cols 2t), (r + 8, 2t), (r, 8 + 2t), (r + 8, 8 + 2t)
  if (kBf16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i & 1), chunk = 2 * kk + (i >> 1);
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          dyt + row * 128 + ((chunk ^ g) << 4) + 4 * t);
      d[i] = make_float2(__uint_as_float(word << 16),
                         __uint_as_float(word & 0xFFFF0000u));
    }
  } else {
    const unsigned char* half = dyt + (kk >> 1) * (kWM * 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i & 1);
      const int chunk = 4 * (kk & 1) + 2 * (i >> 1) + (t >> 1);
      d[i] = *reinterpret_cast<const float2*>(
          half + row * 128 + ((chunk ^ g) << 4) + 8 * (t & 1));
    }
  }
  const float2 s0 = *reinterpret_cast<const float2*>(sc + 16 * kk + 2 * t);
  const float2 s1 =
      *reinterpret_cast<const float2*>(sc + 16 * kk + 8 + 2 * t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 s = i < 2 ? s0 : s1;
    const float v0 = d[i].x * s.x, v1 = d[i].y * s.y;
    const uint32_t hi = pack_bf16(v0, v1);
    f[i] = hi;
    f[4 + i] = pack_bf16(v0 - __uint_as_float(hi << 16),
                         v1 - __uint_as_float(hi & 0xFFFF0000u));
  }
}

// units u0, u0 + kStep, .. (kN of them) of a stage's int8 W tile into its
// swizzled bf16 B tile: unit u is 8 columns of row u / 8 (8 bytes in, a
// 16-byte chunk out)
template <int kStep, int kN>
__device__ __forceinline__ void convert_units(const unsigned char* raw,
                                              unsigned char* bt, int u0) {
#pragma unroll 4
  for (int j = 0; j < kN; ++j) {
    const int u = u0 + j * kStep, r = u >> 3, c = u & 7;
    const uint2 q = *reinterpret_cast<const uint2*>(raw + u * 8);
    const uint2 lo = i8x4_to_bf16(q.x), hi = i8x4_to_bf16(q.y);
    *reinterpret_cast<uint4*>(bt + r * 128 + ((c ^ (r & 7)) << 4)) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kWThreads, 1)
dx_wgmma_kernel(const __grid_constant__ CUtensorMap tm_dy,
                const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_scale,
                __nv_bfloat16* __restrict__ dxb, float* __restrict__ dxf,
                float* __restrict__ part, int M, int K, int nst,
                int split_st) {
  using L = DxLayout<kBf16>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* btiles = smem;                       // [kBBufs][kBTile]
  unsigned char* stages = smem + kBBufs * kBTile;     // [S][kStage]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarsAt);
  uint64_t* empty = full + S;       // W converted, dy read
  uint64_t* bfull = empty + S;      // a B tile converted
  uint64_t* bempty = bfull + kBBufs;   // a B tile's products done

  const int m0 = blockIdx.x * kWM, k0 = blockIdx.y * kWK;
  const int st0 = blockIdx.z * split_st;
  const int n_st = min(nst, st0 + split_st) - st0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup, uniform across each warp (as setmaxnreg needs)
  const int role = __shfl_sync(0xFFFFFFFFu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);     // 4 loading + 8 consumer warps
    }
    for (int b = 0; b < kBBufs; ++b) {
      mbar_init(&bfull[b], 12);     // every warp converts a part
      mbar_init(&bempty[b], 8);     // the consumers' warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (role == 2) {
    // the loading warpgroup: converts each stage's int8 tile into a
    // swizzled bf16 B tile (a unit is 8 columns of a row: 8 bytes in, a
    // 16-byte chunk out); its first lane also keeps the TMA loads in
    // flight, 2 stages ahead of the conversion. (By the time stage i's B
    // tile is free, the consumers have read stage i - 2's dy, so the
    // load into its slot never waits.)
    regs_dec<kLoaderRegs>();
    const int ct = threadIdx.x - 2 * 128;
    auto load = [&](int i) {            // stage i into slot i % S
      const int s = i % S;
      mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
      unsigned char* st = stages + s * L::kStage;
      const int n0 = (st0 + i) * kWBN;
      mbar_expect_tx(&full[s], L::kTx);
      tma_load_2d(st, &tm_dy, &full[s], n0, m0);
      if (!kBf16)
        tma_load_2d(st + L::kDyBytes / 2, &tm_dy, &full[s], n0 + 32, m0);
      tma_load_2d(st + L::kDyBytes, &tm_w, &full[s], n0, k0);
      tma_load_1d(st + L::kDyBytes + kWRawBytes, &tm_scale, &full[s], n0);
    };
    if (ct == 0) {
      prefetch_tensor_map(&tm_dy);
      prefetch_tensor_map(&tm_w);
      prefetch_tensor_map(&tm_scale);
      for (int i = 0; i < S && i < n_st; ++i) load(i);
    }
    for (int i = 0; i < n_st; ++i) {
      const int s = i % S, b = i % kBBufs;
      mbar_wait(&full[s], (i / S) & 1);
      mbar_wait(&bempty[b], ((i / kBBufs) & 1) ^ 1);
      if (ct == 0 && i >= 2 && i + S - 2 < n_st) load(i + S - 2);
      const unsigned char* raw = stages + s * L::kStage + L::kDyBytes;
      unsigned char* bt = btiles + b * kBTile;
      convert_units<128, kLoaderUnits / 128>(raw, bt, ct);
      fence_proxy_async();          // the tile, to wgmma's reads
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&bfull[b]);
        mbar_arrive(&empty[s]);
      }
    }
  } else {
    // a consumer warpgroup: rows 64 role .. 64 role + 63 of the tile
    regs_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int r = role * 64 + (warp & 3) * 16 + g;
    float acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.f;
    uint32_t fa[2][8];
    auto frag = [&](uint32_t* f, int i, int kk) {
      const unsigned char* st = stages + (i % S) * L::kStage;
      dx_fragment<kBf16>(f, st, reinterpret_cast<const float*>(
                                    st + L::kDyBytes + kWRawBytes),
                         r, g, t, kk);
    };
    // the consumers' part of stage i's B tile (the rows past the loading
    // warpgroup's), converted while stage i - 1's products run
    auto convert = [&](int i) {
      const int b = i % kBBufs;
      mbar_wait(&full[i % S], (i / S) & 1);
      mbar_wait(&bempty[b], ((i / kBBufs) & 1) ^ 1);
      convert_units<256, (kWK * 8 - kLoaderUnits) / 256>(
          stages + (i % S) * L::kStage + L::kDyBytes, btiles + b * kBTile,
          kLoaderUnits + threadIdx.x);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bfull[b]);
    };
    convert(0);
    frag(fa[0], 0, 0);
    for (int i = 0; i < n_st; ++i) {
      const int b = i % kBBufs;
      mbar_wait(&bfull[b], (i / kBBufs) & 1);
      const uint64_t desc = wgmma_desc_sw128(btiles + b * kBTile);
#pragma unroll
      for (int kk = 0; kk < kWBN / 16; ++kk) {
        uint32_t* f = fa[kk & 1];
#pragma unroll
        for (int e = 0; e < 128; ++e) fence_operand(acc[e]);
#pragma unroll
        for (int e = 0; e < 8; ++e) fence_operand(f[e]);
        wgmma_fence();
        wgmma_m64n256k16_rs(acc, f, desc + 2 * kk);
        wgmma_m64n256k16_rs(acc, f + 4, desc + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();            // the previous 16 columns' products
#pragma unroll
        for (int e = 0; e < 8; ++e) fence_operand(fa[(kk + 1) & 1][e]);
        if (kk == 0 && i > 0) {     // stage i - 1's products are done
          __syncwarp();
          if (lane == 0) mbar_arrive(&bempty[(i - 1) % kBBufs]);
        }
        if (kk == 1 && i + 1 < n_st) convert(i + 1);
        if (kk + 1 < kWBN / 16) {
          frag(fa[(kk + 1) & 1], i, kk + 1);
          if (kk + 2 == kWBN / 16) {   // dy and the scale of stage i read
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[i % S]);
          }
        } else if (i + 1 < n_st) {
          mbar_wait(&full[(i + 1) % S], ((i + 1) / S) & 1);
          frag(fa[0], i + 1, 0);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 128; ++e) fence_operand(acc[e]);

    // d[4j], d[4j+1] at (row r, cols 8j + 2t, +1), d[4j+2], d[4j+3] at
    // row r + 8: rounded once to dx's type, or an f32 partial sum of the
    // split blockIdx.z
    float* pz = part == nullptr
                    ? nullptr
                    : part + static_cast<size_t>(blockIdx.z) * M * K;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + 8 * j + 2 * t;   // K is even: col + 1 < K too
      if (col >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r + 8 * h;
        if (row >= M) continue;
        const size_t at = static_cast<size_t>(row) * K + col;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pz != nullptr)
          *reinterpret_cast<float2*>(pz + at) = make_float2(v0, v1);
        else if (kBf16)
          *reinterpret_cast<uint32_t*>(dxb + at) = pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(dxf + at) = make_float2(v0, v1);
      }
    }
  }
}

// each kernel's opt-in to its shared memory, once a device
cudaError_t allow_mma() {
  static int allowed[kDevices] = {};
  return allow_smem(dx_mma_kernel, kSmem, allowed);
}
template <bool kBf16> cudaError_t allow_wgmma() {
  static int allowed[kDevices] = {};
  return allow_smem(dx_wgmma_kernel<kBf16>, DxLayout<kBf16>::kSmem, allowed);
}

template <bool kBf16>
cudaError_t launch_wgmma(const CUtensorMap& tdy, const CUtensorMap& tw,
                         const CUtensorMap& ts, void* dx, float* part, int M,
                         int K, int N, int splits, int split_cols, int sms,
                         cudaStream_t s) {
  using L = DxLayout<kBf16>;
  cudaError_t e = allow_wgmma<kBf16>();
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kWM - 1) / kWM, (K + kWK - 1) / kWK, splits);
  dx_wgmma_kernel<kBf16><<<grid, kWThreads, L::kSmem, s>>>(
      tdy, tw, ts, kBf16 ? static_cast<__nv_bfloat16*>(dx) : nullptr,
      kBf16 ? nullptr : static_cast<float*>(dx), splits > 1 ? part : nullptr,
      M, K, (N + kWBN - 1) / kWBN, split_cols / kWBN);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  return sum_splits<T>(part, dx, M, K, splits, sms, s);
}

}  // namespace

// The stage width the scratch rows are padded to: the wrapper allocates
// the hi and lo scratch as (M, np) bf16 each, np = N rounded up to it.
extern "C" int wt_int8_dx_stage_cols() { return kBN; }

// The cp.async path: dx (M, K) = (dy (M, N) * scale (N,)) @ W (K, N)^T,
// dy and dx bf16 (dy_is_bf16) or f32, W int8, scale f32; hi and lo (M,
// np) bf16 scratch, np = N rounded up to wt_int8_dx_stage_cols(); all
// contiguous and 16-byte aligned. The reduction is cut into `splits`
// runs of `split_cols` columns (whole stages, the last run not empty);
// with more than one, `part` is an f32 scratch of splits x M x K for
// their partial sums. The split pass's grid is sized by `sms`. Returns
// cudaGetLastError() after the launches; cudaErrorInvalidValue for a
// shape or a plan the kernels do not take (the Python wrapper checks
// first).
extern "C" int wt_int8_matmul_dx(const void* dy, const void* w,
                                 const void* scale, void* dx, void* hi,
                                 void* lo, void* part, int M, int K, int N,
                                 int dy_is_bf16, int splits, int split_cols,
                                 int sms, void* stream) {
  const int np = (N + kBN - 1) / kBN * kBN;
  if (M <= 0 || K <= 0 || N <= 0 || sms <= 0 ||
      (K + kTK - 1) / kTK > 65535 || splits <= 0 || splits > 65535 ||
      split_cols <= 0 || split_cols % kBN != 0 ||
      static_cast<long long>(splits) * split_cols < N ||
      static_cast<long long>(splits - 1) * split_cols >= N ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(hi);
  __nv_bfloat16* l = static_cast<__nv_bfloat16*>(lo);
  cudaError_t e = dy_is_bf16
                      ? split<__nv_bfloat16>(dy, sc, h, l, M, N, np, sms, s)
                      : split<float>(dy, sc, h, l, M, N, np, sms, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_mma();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  const dim3 grid((M + kTM - 1) / kTM, (K + kTK - 1) / kTK, splits);
  dx_mma_kernel<<<grid, kThreads, kSmem, s>>>(
      h, l, static_cast<const int8_t*>(w),
      dy_is_bf16 ? static_cast<__nv_bfloat16*>(dx) : nullptr,
      dy_is_bf16 ? nullptr : static_cast<float*>(dx), p, M, K, N, np,
      N % 16 == 0, split_cols / kBN);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  e = dy_is_bf16 ? sum_splits<__nv_bfloat16>(p, dx, M, K, splits, sms, s)
                 : sum_splits<float>(p, dx, M, K, splits, sms, s);
  return static_cast<int>(e);
}

// What dx_plan sizes a path's grid by, for dy bf16 or f32 on the TMA
// path (tma 1) or the cp.async path (tma 0): out[0] reduction columns a
// stage, out[1] rows and out[2] columns of dx a block, out[3] blocks a
// multiprocessor (the occupancy calculator, on the current device).
extern "C" int wt_int8_dx_limits(int tma, int dy_is_bf16, int* out) {
  int blocks = 0;
  cudaError_t e;
  if (!tma) {
    e = allow_mma();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dx_mma_kernel, kThreads, kSmem);
  } else if (dy_is_bf16) {
    e = allow_wgmma<true>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dx_wgmma_kernel<true>, kWThreads, DxLayout<true>::kSmem);
  } else {
    e = allow_wgmma<false>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dx_wgmma_kernel<false>, kWThreads,
          DxLayout<false>::kSmem);
  }
  out[0] = tma ? kWBN : kBN;
  out[1] = tma ? kWM : kTM;
  out[2] = tma ? kWK : kTK;
  out[3] = blocks;
  return static_cast<int>(e);
}

// The TMA path: dx (M, K) = (dy (M, N) * scale (N,)) @ W (K, N)^T, dy and
// dx bf16 (dy_is_bf16) or f32, W int8, scale f32, all contiguous and
// 16-byte aligned; N % 16 == 0, K % 8 (bf16) or % 4 (f32). The reduction
// is cut into `splits` runs of `split_cols` columns (a whole number of
// stages, the last run not empty); with more than one, `part` is an f32
// scratch of splits x M x K for their partial sums. Returns
// cudaGetLastError() after the launches, cudaErrorInvalidValue for a
// shape or a plan the kernel does not take, cudaErrorNotSupported where
// the driver has no tensor-map encoder.
extern "C" int wt_int8_matmul_dx_tma(const void* dy, const void* w,
                                     const void* scale, void* dx, void* part,
                                     int M, int K, int N, int dy_is_bf16,
                                     int splits, int split_cols, int sms,
                                     void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 16 != 0 ||
      K % (dy_is_bf16 ? 8 : 4) != 0 || (K + kWK - 1) / kWK > 65535 ||
      splits <= 0 || splits > 65535 || split_cols <= 0 ||
      split_cols % kWBN != 0 ||
      static_cast<long long>(splits) * split_cols < N ||
      static_cast<long long>(splits - 1) * split_cols >= N ||
      (splits > 1 && part == nullptr) || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tdy, tw, ts;
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(N),
                               static_cast<uint64_t>(M)};
  const uint32_t dy_box[2] = {dy_is_bf16 ? 64u : 32u, 128u};
  cudaError_t e = make_tensor_map(
      &tdy,
      dy_is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, dy, dy_dims, static_cast<uint64_t>(N) * (dy_is_bf16 ? 2 : 4),
      dy_box, CU_TENSOR_MAP_SWIZZLE_128B);
  const uint64_t w_dims[2] = {static_cast<uint64_t>(N),
                              static_cast<uint64_t>(K)};
  const uint32_t w_box[2] = {kWBN, kWK};
  if (e == cudaSuccess)
    e = make_tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, w_dims,
                        static_cast<uint64_t>(N), w_box,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  const uint64_t s_dims[1] = {static_cast<uint64_t>(N)};
  const uint32_t s_box[1] = {kWBN};
  if (e == cudaSuccess)
    e = make_tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, scale,
                        s_dims, 0, s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  e = dy_is_bf16 ? launch_wgmma<true>(tdy, tw, ts, dx, p, M, K, N, splits,
                                      split_cols, sms, s)
                 : launch_wgmma<false>(tdy, tw, ts, dx, p, M, K, N, splits,
                                       split_cols, sms, s);
  return static_cast<int>(e);
}
