// W8A16 matmul for Hopper: y = (x @ W_i8) * scale[n], one rounding.
//
// Replaces the TPU kernel int8_matmul
// (whisper_tensor_tpu/backends/pallas/quant_matmul.py:68, pallas_call at
// :109). Same semantics: x (M, K) bf16 or f32, W (K, N) int8 row-major,
// scale (N,) f32; int8 values are exact in bf16 and f32, products and
// their sum are taken in f32, the per-column scale is applied in f32,
// and the result is rounded to x's type once.
//
// What bounds it on the H100: at decode M (1..8 rows) the int8 weight
// bytes, K * N of them per call, against a handful of FMAs per byte; to
// stream them at the card's bandwidth, megabytes of loads must be in
// flight at once. The design follows from that:
//   * a block owns a BM x 64 output tile and streams its (K, 64) weight
//     panel once for all BM rows of x it holds;
//   * weight tiles (128 rows of K x 64 columns, 8 KB) and the matching
//     x tile are staged through shared memory by a ring of 4 cp.async
//     stages (16-byte copies, 64 contiguous bytes per weight row), so
//     three tiles are in flight while the block computes on the fourth;
//   * int8 -> f32 conversion happens in registers; thread t owns 4
//     columns and a 1/16 slice of K, and the 16 slices' partial sums are
//     added through shared memory, in a fixed order, at the end;
//   * consecutive blocks walk down M over the same weight panel, so at
//     prefill M the panel is read from L2 after its first use.
// What it does not do yet: the FMAs run on the CUDA cores, not on the
// tensor cores (mma.sync / wgmma), so at prefill M (128..512) the kernel
// is compute-bound far below the card's peak; and at N = 4096 only 64
// blocks exist, fewer than the 132 SMs. A K-split across blocks and a
// tensor-core inner loop are the next steps for this kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                      // output columns per block
constexpr int kBK = 128;                     // rows of K per stage
constexpr int kStages = 4;                   // cp.async ring depth
constexpr int kGroups = kBN / 4;             // 16 groups of 4 columns
constexpr int kSlices = kThreads / kGroups;  // 16 slices of K
constexpr int kWTile = kBK * kBN;            // bytes of one weight stage

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

template <typename T, int BM>
constexpr int smem_bytes() {
  return kStages * (kWTile + BM * kBK * static_cast<int>(sizeof(T)));
}

// Needs K % 8 == 0 and N % 16 == 0 (whole 16-byte copies of x rows and
// weight rows); the wrapper checks.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ws = reinterpret_cast<int8_t*>(smem);             // [S][kBK][kBN]
  T* xs = reinterpret_cast<T*>(smem + kStages * kWTile);    // [S][BM][kBK]
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int cg = tid % kGroups;
  const int ks = tid / kGroups;
  const int nk = (K + kBK - 1) / kBK;

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kBK;
    int8_t* wdst = ws + slot * kWTile;
    for (int c = tid; c < kWTile / 16; c += kThreads) {
      const int row = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
      const bool ok = k0 + row < K && n0 + col < N;
      const int8_t* src =
          ok ? w + static_cast<size_t>(k0 + row) * N + n0 + col : w;
      cp_async16(wdst + row * kBN + col, src, ok);
    }
    constexpr int kE = 16 / static_cast<int>(sizeof(T));   // x per copy
    T* xdst = xs + slot * BM * kBK;
    for (int c = tid; c < BM * kBK / kE; c += kThreads) {
      const int r = c / (kBK / kE), kc = (c % (kBK / kE)) * kE;
      const bool ok = m0 + r < M && k0 + kc < K;
      const T* src = ok ? x + static_cast<size_t>(m0 + r) * K + k0 + kc : x;
      cp_async16(xdst + r * kBK + kc, src, ok);
    }
  };

  float acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

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
    const int8_t* wt = ws + (kt % kStages) * kWTile;
    const T* xt = xs + (kt % kStages) * BM * kBK;
#pragma unroll
    for (int i = 0; i < kBK / kSlices; ++i) {
      // slices interleave, so a warp reads two adjacent 64-byte rows:
      // 32 distinct banks
      const int k = i * kSlices + ks;
      const char4 q = *reinterpret_cast<const char4*>(wt + k * kBN + 4 * cg);
      const float w0 = q.x, w1 = q.y, w2 = q.z, w3 = q.w;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float xv = to_f32(xt[r * kBK + k]);
        acc[r][0] = fmaf(xv, w0, acc[r][0]);
        acc[r][1] = fmaf(xv, w1, acc[r][1]);
        acc[r][2] = fmaf(xv, w2, acc[r][2]);
        acc[r][3] = fmaf(xv, w3, acc[r][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // add the 16 slices' partial sums, row by row (the ring is free now);
  // scale in f32, round once
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
      const int n = n0 + tid;
      if (n < N)
        out[static_cast<size_t>(m0 + r) * N + n] = from_f32<T>(s * scale[n]);
    }
    __syncthreads();
  }
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   int M, int K, int N, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, BM>();
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory must be allowed first
    const cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  // blockIdx.x walks M: blocks that share a weight panel run together
  const dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN);
  int8_matmul_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     void* out, int M, int K, int N, cudaStream_t s) {
  // rows of x per block: the smallest tile that holds M, up to 16
  if (M <= 1) return launch<T, 1>(x, w, scale, out, M, K, N, s);
  if (M <= 2) return launch<T, 2>(x, w, scale, out, M, K, N, s);
  if (M <= 4) return launch<T, 4>(x, w, scale, out, M, K, N, s);
  if (M <= 8) return launch<T, 8>(x, w, scale, out, M, K, N, s);
  return launch<T, 16>(x, w, scale, out, M, K, N, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// a shape the kernel does not take (the Python wrapper checks first).
extern "C" int wt_int8_matmul(const void* x, const void* w, const void* scale,
                              void* out, int M, int K, int N, int x_is_bf16,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_is_bf16 ? dispatch<__nv_bfloat16>(x, w, scale, out, M, K, N, s)
                : dispatch<float>(x, w, scale, out, M, K, N, s);
  return static_cast<int>(e);
}
