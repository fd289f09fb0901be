// The backward of the W8A16 matmul for x: dx = (dy * scale) @ W_i8^T.
//
// y = (x @ W_i8) * scale[n] is int8_matmul (csrc/int8_matmul.cu, which
// replaces the TPU kernel int8_matmul,
// whisper_tensor_tpu/backends/pallas/quant_matmul.py:68). The JAX package
// has no Pallas backward: jax.grad differentiates its cast-and-dot
// fallback (:85-89), whose transpose sums (dy[m, n] * scale[n]) * W[k, n]
// over n in f32 and rounds once to dy's type. This kernel computes the
// same: dy (M, N) bf16 or f32, W (K, N) int8 row-major, scale (N,) f32,
// dx (M, K) in dy's type. It is the port's own (quant_matmul.Int8MatMul's
// backward), for the frozen int8 base of QLoRA training.
//
// What bounds it: operations, 2 M K N (at QLoRA's M = 1,024 every shape
// is far above the card's ridge). The design:
//   * the scale lies along the reduction, so it cannot be applied after
//     the sum, and bf16(dy * scale) loses the bits agreement needs. A
//     first pass (dx_split_kernel) takes v = dy * scale in f32 once and
//     splits it into bf16 hi = bf16(v) and lo = bf16(v - hi): 16 of v's
//     24 bits, an error of at most 2^-17 of |v|. It writes both to a
//     scratch whose rows are padded with zeros to whole 32-column
//     stages, so the product's loads of them are whole 16-byte copies;
//   * the product (dx_mma_kernel) runs two mma.sync m16n8k16 products,
//     hi @ W and lo @ W, into one f32 accumulator. int8 values are exact
//     in bf16 and every product of two bf16 values is exact in f32, so
//     only the split and the order of the sum differ from the plain
//     version (agreement_bound holds);
//   * W's row k is contiguous over the reduction index n, so W already is
//     the "col" operand of a row.col product: a block stages a 128 x 32
//     tile of W (rows k, columns n) as it lies, and no transposed copy of
//     the frozen weight is made (a copy would double its bytes);
//   * a block owns a 128 x 128 tile of dx as 8 warps (2 along M x 4 along
//     K, 64 x 32 each); the reduction streams through shared memory in
//     stages of 32 columns by 16-byte cp.async in a ring of 3: hi and lo
//     land in the rows ldmatrix reads, and only the int8 tile is
//     converted, once a stage, to bf16 (exact). Rows of W that are not
//     16-byte aligned (N odd, say) are staged by plain loads. Any M, K
//     and N, no row cap;
//   * blockIdx.x walks M, so the blocks that share a panel of W run
//     together and read it from L2.
//   Left for later: wgmma and TMA, and a K split for grids too small to
//   fill the card (decode-sized M, which training does not run).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_common.cuh"

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
              float* __restrict__ dxf, int M, int K, int N, int np,
              int w_aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wbf = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTK][kRow]
  unsigned char* ring = smem + kTK * kRow * 2;

  const int m0 = blockIdx.x * kTM;
  const int k0 = blockIdx.y * kTK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nst = np / kBN;

  // stage `st` (reduction columns st * kBN ..) into ring slot `slot`:
  // [W: kTK x kBN int8][hi: kTM x kRow bf16][lo: kTM x kRow bf16]
  auto load_stage = [&](int slot, int st) {
    const int n0 = st * kBN;
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
  // to dx's type (bf16 into dxb, or f32 into dxf)
  const int gr = lane >> 2, tc = lane & 3;
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
        if (dxf != nullptr) {
          if (col < K) dxf[at] = v0;
          if (col + 1 < K) dxf[at + 1] = v1;
        } else {
          if (col < K) dxb[at] = __float2bfloat16(v0);
          if (col + 1 < K) dxb[at + 1] = __float2bfloat16(v1);
        }
      }
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

}  // namespace

// The stage width the scratch rows are padded to: the wrapper allocates
// the hi and lo scratch as (M, np) bf16 each, np = N rounded up to it.
extern "C" int wt_int8_dx_stage_cols() { return kBN; }

// dx (M, K) = (dy (M, N) * scale (N,)) @ W (K, N)^T, dy and dx bf16
// (dy_is_bf16) or f32, W int8, scale f32; hi and lo (M, np) bf16 scratch,
// np = N rounded up to wt_int8_dx_stage_cols(); all contiguous and
// 16-byte aligned; the split's grid sized by `sms`. Returns
// cudaGetLastError() after the launches; cudaErrorInvalidValue for a
// shape the kernels do not take (the Python wrapper checks first).
extern "C" int wt_int8_matmul_dx(const void* dy, const void* w,
                                 const void* scale, void* dx, void* hi,
                                 void* lo, int M, int K, int N,
                                 int dy_is_bf16, int sms, void* stream) {
  const int np = (N + kBN - 1) / kBN * kBN;
  if (M <= 0 || K <= 0 || N <= 0 || sms <= 0 ||
      (K + kTK - 1) / kTK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(hi);
  __nv_bfloat16* l = static_cast<__nv_bfloat16*>(lo);
  cudaError_t e = dy_is_bf16
                      ? split<__nv_bfloat16>(dy, sc, h, l, M, N, np, sms, s)
                      : split<float>(dy, sc, h, l, M, N, np, sms, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int allowed[kDevices] = {};
  e = allow_smem(dx_mma_kernel, kSmem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kTM - 1) / kTM, (K + kTK - 1) / kTK);
  dx_mma_kernel<<<grid, kThreads, kSmem, s>>>(
      h, l, static_cast<const int8_t*>(w),
      dy_is_bf16 ? static_cast<__nv_bfloat16*>(dx) : nullptr,
      dy_is_bf16 ? nullptr : static_cast<float*>(dx), M, K, N, np,
      N % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
