// Packed-weight matmul for Hopper: y = x @ W, one rounding, where
//   W[k, n] = q[k, n] * s[k / G, n] - o[k / G, n]
// and q, s, o are the packed layout of a GGUF block format or a GPTQ/AWQ
// group (backends/cuda/packed_matmul.py:repack_packed_tensor).
//
// Replaces the TPU kernel packed_matmul
// (whisper_tensor_tpu/backends/pallas/packed_matmul.py:278; split-dot
// kernel :331-360, fallback kernel :390-411). Same semantics:
//   * x (M, K) bf16 or f32, row-major;
//   * bits 4: q (K/2, N) uint8, byte (r, n) holds row r of W in its low
//     nibble and row r + K/2 in its high nibble;
//   * bits 8: q (K, N) int8;
//   * s, o (K/G, N) f32: the scale and offset of each group of G rows;
//   * W is dequantized in f32 exactly as dequant_repacked does it in
//     numpy, q * s rounded, then - o rounded (__fmul_rn / __fsub_rn, so
//     nvcc cannot contract the two into one FMA, whose single rounding
//     would differ in the last bit); bits 8 without offsets (has_off = 0)
//     skips the subtraction, as the reference does;
//   * products and their sum in f32, the result rounded once to x's type.
// The reference's offset fold and split dot (:316-326, :362) were a
// v5e vector-unit trick and are not carried over: here q * s - o costs
// two instructions a weight.
//
// What bounds it on the H100: at decode M (1..16 rows) the bytes of q, s
// and o, against a handful of operations per byte: 0.75 B a weight for
// 4-bit formats at G = 32 (half a byte of nibbles and 8 bytes of f32
// scale and offset per 32 weights), 1.125 B for Q8_0 and 1.5 B for Q6_K
// (int8 values, G = 16). The design is int8_matmul.cu's, with the weight
// decode changed:
//   * a block owns a BM x 64 output tile and streams its (K, 64) panel of
//     q once for all BM rows of x it holds; consecutive blocks walk down
//     M over the same panel, so at prefill M it is read from L2 after its
//     first use;
//   * a stage holds 256 rows of W (256 rows of q at bits 8, 128 at bits
//     4) and the matching 256 columns of x; a ring of 4 cp.async stages
//     keeps three in flight while the block computes on the fourth;
//   * thread t owns 4 columns and 16 contiguous rows of W in each stage
//     (at bits 4, slices 0-7 take the low nibbles of the stage's bytes
//     and slices 8-15 the high nibbles, whose x columns lie K/2 further
//     on), so its rows meet at most two groups when G >= 16; it reads
//     those groups' scales and offsets from global memory (L2) before it
//     waits for the stage. The stage's q rows are stored transposed in
//     16-row blocks, so the two slices of a warp read neighbouring rows
//     (32 distinct banks);
//   * the 16 slices' partial sums are added through shared memory in a
//     fixed order at the end: the same inputs give the same bits.
// Any G dividing K is taken (a thread reloads at each group boundary
// when G < 16), any N (the ragged tail of columns is masked; when N is
// not a multiple of 16, q rows are not 16-byte aligned, so q is staged
// by byte loads and s, o read one float at a time), and K % 16 == 0
// (16-byte copies of x, both halves at bits 4).
// What it does not do yet: the FMAs run on the CUDA cores, not the
// tensor cores, so at prefill M the kernel is compute-bound far below the
// card's peak; N = 4096 gives only 64 blocks for 132 SMs at decode; and
// the reference layout's f32 scales and offsets are a third of the bytes
// of a 4-bit weight.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                      // output columns per block
constexpr int kRows = 256;                   // rows of W per stage
constexpr int kStages = 4;                   // cp.async ring depth
constexpr int kGroups = kBN / 4;             // 16 groups of 4 columns
constexpr int kSlices = kThreads / kGroups;  // 16 slices of the stage
constexpr int kPer = kRows / kSlices;        // 16 rows of W per slice

template <int BITS>
__host__ __device__ constexpr int q_rows() {  // rows of q per stage
  return BITS == 4 ? kRows / 2 : kRows;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
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

// Columns n .. n+3 of row g of a (K/G, N) f32 array; zero past N.
// ALIGNED (N % 16 == 0): one 16-byte load.
template <bool ALIGNED>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int g,
                                        int n, int N) {
  const float* row = p + static_cast<size_t>(g) * N;
  if (ALIGNED) {
    return n < N ? __ldg(reinterpret_cast<const float4*>(row + n))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(n < N ? __ldg(row + n) : 0.f,
                     n + 1 < N ? __ldg(row + n + 1) : 0.f,
                     n + 2 < N ? __ldg(row + n + 2) : 0.f,
                     n + 3 < N ? __ldg(row + n + 3) : 0.f);
}

__device__ __forceinline__ float pick(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <typename T, int BM, int BITS>
constexpr int smem_bytes() {
  return kStages * (q_rows<BITS>() * kBN +
                    BM * kRows * static_cast<int>(sizeof(T)));
}

template <typename T, int BM, int BITS, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                     const float* __restrict__ sc,
                     const float* __restrict__ of, T* __restrict__ out,
                     int M, int K, int N, int G, int has_off) {
  constexpr int QR = q_rows<BITS>();
  constexpr int SL = QR / kPer;              // 16-row blocks per stage
  constexpr int kWTile = QR * kBN;           // bytes of q per stage
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* ws = smem;                                          // [S][QR][kBN]
  T* xs = reinterpret_cast<T*>(smem + kStages * kWTile);       // [S][BM][kRows]
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int cg = tid % kGroups;
  const int ks = tid / kGroups;
  const int H = K / 2;
  const int Kq = BITS == 4 ? H : K;          // rows of q
  const int nk = (Kq + QR - 1) / QR;

  auto load_stage = [&](int slot, int kt) {
    const int r0 = kt * QR;
    uint8_t* wdst = ws + slot * kWTile;
    // q row r of the stage goes to smem row (r % 16) * SL + r / 16
    if (ALIGNED) {
      for (int c = tid; c < kWTile / 16; c += kThreads) {
        const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
        const bool ok = r0 + r < Kq && n0 + col < N;
        const uint8_t* src =
            ok ? q + static_cast<size_t>(r0 + r) * N + n0 + col : q;
        cp_async16(wdst + ((r % kPer) * SL + r / kPer) * kBN + col, src, ok);
      }
    } else {
      for (int c = tid; c < kWTile; c += kThreads) {
        const int r = c / kBN, col = c % kBN;
        const bool ok = r0 + r < Kq && n0 + col < N;
        wdst[((r % kPer) * SL + r / kPer) * kBN + col] =
            ok ? q[static_cast<size_t>(r0 + r) * N + n0 + col] : 0;
      }
    }
    constexpr int kE = 16 / static_cast<int>(sizeof(T));   // x per copy
    T* xdst = xs + slot * BM * kRows;
    for (int c = tid; c < BM * kRows / kE; c += kThreads) {
      const int r = c / (kRows / kE), kc = (c % (kRows / kE)) * kE;
      int kx;
      bool ok;
      if (BITS == 4) {                   // columns [0, 128): low rows
        const int half = kc / QR, rr = r0 + kc % QR;
        kx = half * H + rr;
        ok = rr < H;
      } else {
        kx = r0 + kc;
        ok = kx < K;
      }
      ok = ok && m0 + r < M;
      const T* src = ok ? x + static_cast<size_t>(m0 + r) * K + kx : x;
      cp_async16(xdst + r * kRows + kc, src, ok);
    }
  };

  float acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  // this thread's slice: 16 contiguous rows of W per stage
  const bool hi = BITS == 4 && ks >= SL;     // high nibbles (bits 4)
  const int srow = BITS == 4 ? (ks % SL) * kPer : ks * kPer;
  const int xcol = (hi ? QR : 0) + srow;     // its x columns in the stage
  const int limit = BITS == 4 && !hi ? H : K;
  const int n = n0 + 4 * cg;
  const bool sub = BITS == 4 || has_off;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // the groups of this stage's rows, read before waiting for the copies
    const int base = (hi ? H : 0) + kt * QR + srow;
    int g = base < limit ? base / G : 0;
    int bnd = (g + 1) * G;
    float4 sA = base < limit ? load4<ALIGNED>(sc, g, n, N)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 oA = base < limit && sub ? load4<ALIGNED>(of, g, n, N) : sA;
    float4 sB = sA, oB = oA;
    if (G >= kPer && bnd < limit && bnd < base + kPer) {
      sB = load4<ALIGNED>(sc, g + 1, n, N);
      oB = sub ? load4<ALIGNED>(of, g + 1, n, N) : sB;
    }
    cp_async_wait<kStages - 2>();   // this thread's copies of stage kt
    __syncthreads();                // everyone's; slot kt-1 is free again
    const int next = kt + kStages - 1;
    if (next < nk) load_stage(next % kStages, next);
    cp_async_commit();              // (an empty group keeps the count)
    const uint8_t* wt = ws + (kt % kStages) * kWTile;
    const T* xt = xs + (kt % kStages) * BM * kRows;
#pragma unroll 4
    for (int j = 0; j < kPer; ++j) {
      const int kw = base + j;
      if (kw >= limit) break;
      float4 s4, o4;
      if (G >= kPer) {
        const bool a = kw < bnd;
        s4 = a ? sA : sB;
        o4 = a ? oA : oB;
      } else {
        if (kw == bnd) {            // groups shorter than a slice
          ++g;
          bnd += G;
          sA = load4<ALIGNED>(sc, g, n, N);
          oA = sub ? load4<ALIGNED>(of, g, n, N) : sA;
        }
        s4 = sA;
        o4 = oA;
      }
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          wt + (j * SL + (BITS == 4 ? ks % SL : ks)) * kBN + 4 * cg);
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float qv;
        if (BITS == 4) {
          qv = static_cast<float>((word >> (8 * c + (hi ? 4 : 0))) & 0xF);
        } else {
          qv = static_cast<float>(static_cast<int8_t>((word >> (8 * c)) & 0xFF));
        }
        const float p = __fmul_rn(qv, pick(s4, c));
        w[c] = sub ? __fsub_rn(p, pick(o4, c)) : p;
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float xv = to_f32(xt[r * kRows + xcol + j]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv, w[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // add the 16 slices' partial sums, row by row (the ring is free now),
  // in a fixed order; round once
  float* red = reinterpret_cast<float*>(smem);              // [kSlices][kBN]
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (m0 + r >= M) break;         // the same for the whole block
    reinterpret_cast<float4*>(red)[ks * kGroups + cg] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    if (tid < kBN) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kSlices; ++i) s += red[i * kBN + tid];
      const int col = n0 + tid;
      if (col < N) out[static_cast<size_t>(m0 + r) * N + col] = from_f32<T>(s);
    }
    __syncthreads();
  }
}

template <typename T, int BM, int BITS, bool ALIGNED>
cudaError_t launch(const void* x, const void* q, const void* sc,
                   const void* of, void* out, int M, int K, int N, int G,
                   int has_off, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, BM, BITS>();
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory must be allowed first
    const cudaError_t e = cudaFuncSetAttribute(
        packed_matmul_kernel<T, BM, BITS, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  // blockIdx.x walks M: blocks that share a weight panel run together
  const dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN);
  packed_matmul_kernel<T, BM, BITS, ALIGNED><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(sc), static_cast<const float*>(of),
      static_cast<T*>(out), M, K, N, G, has_off);
  return cudaGetLastError();
}

template <typename T, int BITS, bool ALIGNED>
cudaError_t by_rows(const void* x, const void* q, const void* sc,
                    const void* of, void* out, int M, int K, int N, int G,
                    int has_off, cudaStream_t s) {
  // rows of x per block: the smallest tile that holds M, up to 16
#define WT_LAUNCH(BM) \
  launch<T, BM, BITS, ALIGNED>(x, q, sc, of, out, M, K, N, G, has_off, s)
  if (M <= 1) return WT_LAUNCH(1);
  if (M <= 2) return WT_LAUNCH(2);
  if (M <= 4) return WT_LAUNCH(4);
  if (M <= 8) return WT_LAUNCH(8);
  return WT_LAUNCH(16);
#undef WT_LAUNCH
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, const void* sc,
                     const void* of, void* out, int M, int K, int N, int G,
                     int bits, int has_off, cudaStream_t s) {
  const bool aligned = N % 16 == 0;
  if (bits == 4)
    return aligned ? by_rows<T, 4, true>(x, q, sc, of, out, M, K, N, G,
                                         has_off, s)
                   : by_rows<T, 4, false>(x, q, sc, of, out, M, K, N, G,
                                          has_off, s);
  return aligned ? by_rows<T, 8, true>(x, q, sc, of, out, M, K, N, G,
                                       has_off, s)
                 : by_rows<T, 8, false>(x, q, sc, of, out, M, K, N, G,
                                        has_off, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// a shape the kernel does not take (the Python wrapper checks first).
extern "C" int wt_packed_matmul(const void* x, const void* q, const void* sc,
                                const void* of, void* out, int M, int K,
                                int N, int G, int bits, int has_off,
                                int x_is_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || G <= 0 || K % G != 0 ||
      (bits != 4 && bits != 8) || (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_is_bf16 ? dispatch<__nv_bfloat16>(x, q, sc, of, out, M, K, N, G,
                                          bits, has_off, s)
                : dispatch<float>(x, q, sc, of, out, M, K, N, G, bits,
                                  has_off, s);
  return static_cast<int>(e);
}
