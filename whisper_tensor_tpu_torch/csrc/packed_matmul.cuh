// Shared by the packed_matmul sources (packed_matmul.cu, whose note says
// what the kernels do and why, and packed_cores_*.cu): the helpers, the
// decode path's kernel (a) and its launch, instantiated per type of x in
// its own source so that nvcc builds the three in parallel.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "device_common.cuh"

namespace wt_packed {

// (a) x @ W on the CUDA cores, `bm` rows of x per block (1, 2, 4, 8 or
// 16), K split into `splits` runs of `kchunk` rows of q; part (f32,
// splits x M x N) takes the partial sums when splits > 1.
cudaError_t cores_bf16(const void* x, const void* q, const void* sc,
                       const void* of, void* out, float* part, int M, int K,
                       int N, int G, int bits, int has_off, int bm,
                       int splits, int kchunk, int aligned, cudaStream_t s);
cudaError_t cores_f32(const void* x, const void* q, const void* sc,
                      const void* of, void* out, float* part, int M, int K,
                      int N, int G, int bits, int has_off, int bm,
                      int splits, int kchunk, int aligned, cudaStream_t s);
// the blocks of that kernel one multiprocessor runs at once
cudaError_t cores_bf16_blocks(int bits, int bm, int G, int* blocks);
cudaError_t cores_f32_blocks(int bits, int bm, int G, int* blocks);

namespace {

// q * s rounded once (what __fmul_rn(q, s) gives), q the value of byte c
// of v. prmt puts the byte under the exponent of 2^23 (byte c, two zero
// bytes, 0x4B): the float f = 2^23 + u, exactly. Bits 4 pass nibbles (q
// = u): one FMA, f * s + ns with ns = -2^23 s (exact, a power of two),
// is the exact q * s rounded once. Bits 8 pass bytes with the sign bit
// flipped (q = u - 128): f - (2^23 + 128) is q exactly, then one multiply.
template <int BITS>
__device__ __forceinline__ float scaled(uint32_t v, int c, float s,
                                        float ns) {
  const float f = __int_as_float(prmt(v, 0x4B000000u, 0x7440u | c));
  if (BITS == 4) return __fmaf_rn(f, s, ns);
  return __fmul_rn(f - 8388736.f, s);
}

__device__ __forceinline__ float4 neg_2p23(const float4& s) {
  return make_float4(-8388608.f * s.x, -8388608.f * s.y, -8388608.f * s.z,
                     -8388608.f * s.w);
}

// The word of 4 columns as 4 values, ready for scaled(): the low or the
// high nibbles (bits 4), or the int8 bytes with the sign bit flipped.
template <int BITS>
__device__ __forceinline__ uint32_t word_values(uint32_t word, bool high) {
  if (BITS == 4) return (high ? word >> 4 : word) & 0x0F0F0F0Fu;
  return word ^ 0x80808080u;
}

// Columns n .. n+3 of row g of a (K/G, N) f32 array, from device memory;
// zero past N. ALIGNED (N % 16 == 0): one 16-byte load.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int g,
                                        int n, int N, bool aligned) {
  const float* row = p + static_cast<size_t>(g) * N;
  if (aligned)
    return n < N ? __ldg(reinterpret_cast<const float4*>(row + n))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(n < N ? __ldg(row + n) : 0.f,
                     n + 1 < N ? __ldg(row + n + 1) : 0.f,
                     n + 2 < N ? __ldg(row + n + 2) : 0.f,
                     n + 3 < N ? __ldg(row + n + 3) : 0.f);
}

__device__ __forceinline__ float pick(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Group-row slots of one half-stage: a stage meets at most (n - 1) / G + 2
// groups in n consecutive rows of W.
__host__ __device__ __forceinline__ int group_slots(int n, int G) {
  return (n - 1) / G + 2;
}

// The group of W row `row`: a shift when G is a power of two (every GGUF
// and GPTQ group; gshift = log2 G), else a division.
__device__ __forceinline__ int group_of(int row, int G, int gshift) {
  return gshift >= 0 ? row >> gshift : row / G;
}
__device__ __forceinline__ int group_shift(int G) {
  return (G & (G - 1)) == 0 ? __ffs(G) - 1 : -1;
}

// Stage the scale (and offset) rows of the groups that W rows [a, a + n)
// meet, columns [n0, n0 + BN), into slots [0, count) of dst: slot i holds
// group a / G + i, its BN scales then its BN offsets.
template <int BN, int THREADS>
__device__ __forceinline__ void stage_groups(float* dst,
                                             const float* __restrict__ sc,
                                             const float* __restrict__ of,
                                             int a, int n, int G, int gshift,
                                             int n0, int N, bool sub,
                                             bool aligned, int tid) {
  if (n <= 0) return;
  const int g0 = group_of(a, G, gshift);
  const int count = group_of(a + n - 1, G, gshift) - g0 + 1;
  constexpr int kChunks = BN / 4;             // 16-byte chunks of a row
  const int rows = sub ? 2 * count : count;   // scale rows, offset rows
  for (int i = tid; i < rows * kChunks; i += THREADS) {
    const int row = i / kChunks, col = (i % kChunks) * 4;
    const int slot = sub ? row >> 1 : row, which = sub ? row & 1 : 0;
    const float* src = (which ? of : sc) +
                       static_cast<size_t>(g0 + slot) * N + n0 + col;
    float* d = dst + slot * 2 * BN + which * BN + col;
    if (aligned) {
      const bool ok = n0 + col < N;
      cp_async16(d, ok ? src : sc, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = n0 + col + e < N;
        cp_async4(d + e, ok ? src + e : sc, ok);
      }
    }
  }
}

// -- (a) the decode path: CUDA cores, K split across blocks ------------------

constexpr int kThreads = 256;
constexpr int kBN = 128;                     // output columns per block
constexpr int kRows = 128;                   // rows of W per stage
constexpr int kStages = 4;                   // cp.async ring depth
constexpr int kGroups = kBN / 4;             // 32 groups of 4 columns
constexpr int kSlices = kThreads / kGroups;  // 8 slices of the stage
constexpr int kPer = kRows / kSlices;        // 16 rows of W per slice

template <int BITS>
__host__ __device__ constexpr int q_rows() {  // rows of q per stage
  return BITS == 4 ? kRows / 2 : kRows;
}

// scale slots per stage: both halves at bits 4, one run of 256 rows at
// bits 8; none when the scales are read from device memory (G < 8)
__host__ __device__ inline int core_slots(int bits, int G) {
  if (G < 8) return 0;
  return bits == 4 ? 2 * group_slots(kRows / 2, G) : group_slots(kRows, G);
}

template <typename T>
__host__ __device__ inline int core_stage_bytes(int bits, int BM, int G) {
  return (bits == 4 ? kRows / 2 : kRows) * kBN +
         BM * kRows * static_cast<int>(sizeof(T)) +
         core_slots(bits, G) * 2 * kBN * 4;
}

template <typename T, int BM, int BITS>
__global__ void __launch_bounds__(kThreads)
packed_cores_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ sc,
                    const float* __restrict__ of, T* __restrict__ out,
                    float* __restrict__ part, int M, int K, int N, int G,
                    int has_off, int kchunk, int stage_bytes, int aligned) {
  constexpr int QR = q_rows<BITS>();
  constexpr int SL = QR / kPer;              // 16-row blocks per stage
  constexpr int kWTile = QR * kBN;           // bytes of q per stage
  constexpr int kXTile = BM * kRows * static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % kGroups;
  const int ks = tid / kGroups;
  const int H = K / 2;
  const int Kq = BITS == 4 ? H : K;          // rows of q
  const int qbeg = split * kchunk;           // this split's rows of q
  const int qend = min(qbeg + kchunk, Kq);
  const int nk = (qend - qbeg + QR - 1) / QR;
  const bool sub = BITS == 4 || has_off;
  const bool direct = G < 8;                 // scales from device memory
  const int srh = direct ? 0 : group_slots(BITS == 4 ? QR : kRows, G);
  const bool al = aligned != 0;
  const int gshift = group_shift(G);

  auto load_stage = [&](int slot, int kt) {
    const int r0 = qbeg + kt * QR;
    unsigned char* base = smem + slot * stage_bytes;
    uint8_t* wdst = base;
    // q row r of the stage goes to smem row (r % 16) * SL + r / 16
    if (al) {
      for (int c = tid; c < kWTile / 16; c += kThreads) {
        const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
        const bool ok = r0 + r < qend && n0 + col < N;
        const uint8_t* src =
            ok ? q + static_cast<size_t>(r0 + r) * N + n0 + col : q;
        cp_async16(wdst + ((r % kPer) * SL + r / kPer) * kBN + col, src, ok);
      }
    } else {
      for (int c = tid; c < kWTile; c += kThreads) {
        const int r = c / kBN, col = c % kBN;
        const bool ok = r0 + r < qend && n0 + col < N;
        wdst[((r % kPer) * SL + r / kPer) * kBN + col] =
            ok ? q[static_cast<size_t>(r0 + r) * N + n0 + col] : 0;
      }
    }
    constexpr int kE = 16 / static_cast<int>(sizeof(T));   // x per copy
    T* xdst = reinterpret_cast<T*>(base + kWTile);
    for (int c = tid; c < BM * kRows / kE; c += kThreads) {
      const int r = c / (kRows / kE), kc = (c % (kRows / kE)) * kE;
      int kx;
      bool ok;
      if (BITS == 4) {                   // columns [0, 128): low rows
        const int half = kc / QR, rr = r0 + kc % QR;
        kx = half * H + rr;
        ok = rr < qend;
      } else {
        kx = r0 + kc;
        ok = kx < qend;
      }
      ok = ok && m0 + r < M;
      const T* src = ok ? x + static_cast<size_t>(m0 + r) * K + kx : x;
      cp_async16(xdst + r * kRows + kc, src, ok);
    }
    if (!direct) {
      float* sdst = reinterpret_cast<float*>(base + kWTile + kXTile);
      const int n = min(QR, qend - r0);      // rows of q in the stage
      stage_groups<kBN, kThreads>(sdst, sc, of, r0, n, G, gshift, n0, N,
                                  sub, al, tid);
      if (BITS == 4)
        stage_groups<kBN, kThreads>(sdst + srh * 2 * kBN, sc, of, H + r0, n,
                                    G, gshift, n0, N, sub, al, tid);
    }
  };

  float acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  // this thread's slice: 16 contiguous rows of W per stage
  const bool hi = BITS == 4 && ks >= SL;     // high nibbles (bits 4)
  const int sidx = BITS == 4 ? ks % SL : ks;
  const int srow = sidx * kPer;
  const int xcol = (hi ? QR : 0) + srow;     // its x columns in the stage
  const int n = n0 + 4 * cg;
  auto group = [&](int row) { return group_of(row, G, gshift); };

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
    const unsigned char* base = smem + (kt % kStages) * stage_bytes;
    const uint8_t* wt = base;
    const T* xt = reinterpret_cast<const T*>(base + kWTile);
    const float* st = reinterpret_cast<const float*>(base + kWTile + kXTile) +
                      (hi ? srh * 2 * kBN : 0);
    const int r0 = qbeg + kt * QR;
    const int a = (hi ? H : 0) + r0;          // first W row of the half
    const int base_row = a + srow;            // this slice's first W row
    const int nj = max(0, min(kPer, qend - (r0 + srow)));

    auto row = [&](int j, const float4& s4, const float4& n4,
                   const float4& o4) {
      const uint32_t v = word_values<BITS>(
          *reinterpret_cast<const uint32_t*>(wt + (j * SL + sidx) * kBN +
                                             4 * cg),
          hi);
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = scaled<BITS>(v, c, pick(s4, c), pick(n4, c));
        w[c] = sub ? __fsub_rn(p, pick(o4, c)) : p;
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float xv = to_f32(xt[r * kRows + xcol + j]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv, w[c], acc[r][c]);
      }
    };
    // the slice's rows in runs of one group each
    for (int j = 0; j < nj;) {
      const int g = group(base_row + j);
      float4 s4, o4;
      if (direct) {
        s4 = load4(sc, g, n, N, al);
        o4 = sub ? load4(of, g, n, N, al) : s4;
      } else {
        const float* p = st + (g - group(a)) * 2 * kBN + 4 * cg;
        s4 = *reinterpret_cast<const float4*>(p);
        o4 = sub ? *reinterpret_cast<const float4*>(p + kBN) : s4;
      }
      const float4 n4 = neg_2p23(s4);
      const int jend = min(nj, (g + 1) * G - base_row);
      if (j == 0 && jend == kPer) {
#pragma unroll
        for (int jj = 0; jj < kPer; ++jj) row(jj, s4, n4, o4);
      } else {
        for (int jj = j; jj < jend; ++jj) row(jj, s4, n4, o4);
      }
      j = jend;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // add the 16 slices' partial sums (the ring is free now) in a fixed
  // order; round once, or keep f32 for the split sum
  float* red = reinterpret_cast<float*>(smem);     // [BM][kSlices][kBN]
#pragma unroll
  for (int r = 0; r < BM; ++r)
    reinterpret_cast<float4*>(red + (r * kSlices + ks) * kBN)[cg] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN, col = i % kBN;
    if (m0 + r >= M || n0 + col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) s += red[(r * kSlices + k) * kBN + col];
    const size_t at = static_cast<size_t>(m0 + r) * N + n0 + col;
    if (part != nullptr)
      part[static_cast<size_t>(split) * M * N + at] = s;
    else
      out[at] = from_f32<T>(s);
  }
}

// The dynamic shared memory of the (T, BM, BITS) kernel at groups of G
// rows (the ring, or the final slice sums where larger), allowed on the
// current device.
template <typename T, int BM, int BITS>
cudaError_t cores_smem(int G, int* smem) {
  const int ring = kStages * core_stage_bytes<T>(BITS, BM, G);
  const int red = BM * kSlices * kBN * 4;    // the final slice sums
  *smem = ring > red ? ring : red;
  static int allowed[kDevices] = {};
  return allow_smem(packed_cores_kernel<T, BM, BITS>, *smem, allowed);
}

template <typename T, int BM, int BITS>
cudaError_t launch_cores(const void* x, const void* q, const void* sc,
                         const void* of, void* out, float* part, int M, int K,
                         int N, int G, int has_off, int splits, int kchunk,
                         int aligned, cudaStream_t stream) {
  int smem = 0;
  cudaError_t e = cores_smem<T, BM, BITS>(G, &smem);
  if (e != cudaSuccess) return e;
  // blockIdx.x walks M: blocks that share a weight panel run together
  const dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN, splits);
  packed_cores_kernel<T, BM, BITS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(sc), static_cast<const float*>(of),
      static_cast<T*>(out), splits > 1 ? part : nullptr, M, K, N, G, has_off,
      kchunk, core_stage_bytes<T>(BITS, BM, G), aligned);
  return cudaGetLastError();
}

// Blocks of the (T, BM, BITS) kernel that one multiprocessor of the
// current device runs at once, at the shared memory its launch gives it.
template <typename T, int BM, int BITS>
cudaError_t cores_occupancy(int G, int* blocks) {
  int smem = 0;
  cudaError_t e = cores_smem<T, BM, BITS>(G, &smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, packed_cores_kernel<T, BM, BITS>, kThreads, smem);
}

// f(std::integral_constant<int, BM>) for the kernel's rows of x per block
template <typename F>
cudaError_t with_rows(int bm, F&& f) {
  switch (bm) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return f(std::integral_constant<int, 16>{});
  }
}

template <typename T, int BITS>
cudaError_t by_rows(const void* x, const void* q, const void* sc,
                    const void* of, void* out, float* part, int M, int K,
                    int N, int G, int has_off, int bm, int splits, int kchunk,
                    int aligned, cudaStream_t s) {
  return with_rows(bm, [&](auto BM) {
    return launch_cores<T, decltype(BM)::value, BITS>(
        x, q, sc, of, out, part, M, K, N, G, has_off, splits, kchunk, aligned,
        s);
  });
}

template <typename T, int BITS>
cudaError_t blocks_by_rows(int bm, int G, int* blocks) {
  return with_rows(bm, [&](auto BM) {
    return cores_occupancy<T, decltype(BM)::value, BITS>(G, blocks);
  });
}

}  // namespace
}  // namespace wt_packed
