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
//   * products summed in f32, the result rounded once to x's type.
// The reference's offset fold and split dot (:316-326, :362) were a v5e
// vector-unit trick and are not carried over. Nor is its route of more
// than 512 rows to a dequantize-and-dot form (:294-302): it exists
// because the (TM, K) x blocks and the dequantized f32 tile overflow the
// TPU's scoped VMEM at large K. Here K streams through shared memory in
// stages, so the kernel takes every M.
//
// The launch plan (path, rows per block, K splits) is worked out by the
// wrapper (packed_matmul.py:packed_plan) and passed in; it sizes the grid
// by what wt_packed_limits (below) reads of each kernel on the card: rows
// of q a stage, columns a block, blocks a multiprocessor.
//
// (a) The decode path, on the CUDA cores (M up to the crossover, and f32
// x at every M). Bound: the bytes of q, s and o, 0.75 B a weight for
// 4-bit formats at G = 32, against a handful of operations per weight.
//   * a block owns a BM x 128 output tile (BM 1..16); a stage holds 128
//     rows of W (64 rows of q at bits 4: the low and the high nibbles of
//     the same bytes) with its x columns and the scale and offset rows of
//     the groups it meets, all brought in by cp.async in a ring of 4, so
//     three stages are in flight while the block computes on the fourth
//     (no load waits on device memory inside the loop);
//   * K is split across blocks (blockIdx.z) whenever the row and column
//     blocks cannot fill the card: the down projection's N = 4,096 gives
//     32 column blocks, so at M = 1 its K = 14,336 runs as 16 splits. A
//     split is a whole number of stages and groups, so the two nibbles of
//     a byte stay in one split. Each split writes f32 partial sums to a
//     scratch (splits, M, N); a second kernel adds them in split order
//     and rounds once: no float atomics, and repeats are bit-equal;
//   * the 256 threads are 8 slices of 32: thread t owns 4 columns and 16
//     contiguous rows of W per stage (at bits 4 slices 0-3 take the low
//     nibbles, 4-7 the high ones); a
//     nibble becomes a float without the (quarter-rate) converter: prmt
//     puts the byte under the exponent bits of 2^23, so the float is
//     2^23 + v exactly, and one FMA with -2^23 s (exact) gives q * s
//     rounded once, bit for bit __fmul_rn(q, s); bits 8 flip the sign bit
//     first and subtract 2^23 + 128 before the multiply. Then __fsub_rn
//     and one FMA per row of x: four instructions a weight at bits 4
//     where PR 4's loop spent six, one of them the converter;
//   * the 8 slices' partial sums are added through shared memory in a
//     fixed order at the end.
//   What bounds it: at M = 1 about four instructions a weight against
//   the 0.75 B it costs, near the card's issue rate at its memory rate,
//   so large shapes reach about half the bytes bound; small ones (the o
//   projection, 2 us of bytes) pay the two launches and the split sum.
// (b) The prefill path, on the tensor cores (bf16 x, M above the
// crossover). Bound: operations at prefill M, 2 M K N.
//   * a block owns a TM x 128 output tile, TM = 64 (8 warps of 32 x 32)
//     or, for up to 16 rows, 16 (8 warps of 16 x 16: a few rows do not
//     pay for 64 in products and x tiles); a stage is 64 rows of W (32
//     rows of q at bits 4, low and high nibbles; 64 at bits 8), its x
//     tile and its scale rows, in a cp.async ring of 3;
//   * each stage's q tile is dequantized once, in f32 as above, into two
//     bf16 tiles in shared memory, W_hi = bf16(w) and W_lo = bf16(w -
//     W_hi), and the 8 warps accumulate x W_hi + x W_lo in f32 with
//     mma.sync m16n8k16 (fragments by ldmatrix; B by its .trans form
//     from the k-major tiles). One bf16 rounding of W (2^-9 a term) would
//     break agreement_bound's 2^-16 of sum |x||w| on outputs near zero;
//     the pair leaves w - W_hi - W_lo within 2^-16 |w| (about 2^-17 on
//     average), x in bf16 is exact, and for Q4_0 ((q - 8) d has at most
//     15 significant bits) the pair is exact. wgmma and TMA are a later
//     step;
//   * K is split as in (a) when the tiles do not fill the card.
//   What bounds it: below about 64 rows, the dequantization (each stage's
//   W tiles are written, then read by ldmatrix, between two barriers);
//   at prefill rows the products, run twice (hi and lo) by mma.sync.
// Both paths take any N (the ragged tail is masked; when N % 16 != 0, q
// rows are not 16-byte aligned, so q is staged by byte loads and s, o by
// 4-byte copies), any G dividing K (G < 8 reads its scales from device
// memory instead of staging them), and K % 16 == 0.
#include "packed_matmul.cuh"

namespace wt_packed {
namespace {

// -- (b) the prefill path: tensor cores --------------------------------------

constexpr int kTThreads = 256;               // 8 warps
constexpr int kTN = 128;                     // output columns per block
constexpr int kTK = 64;                      // rows of W per stage
constexpr int kTStages = 3;                  // cp.async ring depth
constexpr int kXRow = kTK + 8;               // bf16 per x row in smem
constexpr int kWRow = kTN + 8;               // bf16 per W row in smem
constexpr int kWTileT = kTK * kWRow * 2;     // bytes of one bf16 W tile

template <int BITS>
__host__ __device__ constexpr int tq_rows() {  // rows of q per stage
  return BITS == 4 ? kTK / 2 : kTK;
}

// TM output rows per block: the 8 warps as WM (along M) x 8/WM (along
// N), each on MT x NT m16n8 tiles. 64 rows for prefill; 16 for up to 16
// rows, so that a few rows do not pay for 64 in products and x tiles.
template <int TM> struct TShape;
template <> struct TShape<64> {
  static constexpr int WM = 2, MT = 2, NT = 4;
};
template <> struct TShape<16> {
  static constexpr int WM = 1, MT = 1, NT = 2;
};

__host__ __device__ inline int tensor_slots(int bits, int G) {
  if (G < 8) return 0;
  return bits == 4 ? 2 * group_slots(kTK / 2, G) : group_slots(kTK, G);
}

__host__ __device__ inline int tensor_stage_bytes(int bits, int TM, int G) {
  return (bits == 4 ? kTK / 2 : kTK) * kTN + TM * kXRow * 2 +
         tensor_slots(bits, G) * 2 * kTN * 4;
}

template <int BITS, int TM>
__global__ void __launch_bounds__(kTThreads)
packed_tensor_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ q,
                     const float* __restrict__ sc,
                     const float* __restrict__ of,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ part, int M, int K, int N, int G,
                     int has_off, int kchunk, int stage_bytes, int aligned) {
  constexpr int QR = tq_rows<BITS>();
  constexpr int kQTile = QR * kTN;           // bytes of q per stage
  constexpr int kXTile = TM * kXRow * 2;
  constexpr int WM = TShape<TM>::WM, WN = 8 / WM;
  constexpr int MT = TShape<TM>::MT, NT = TShape<TM>::NT;
  static_assert(WM * MT * 16 == TM && WN * NT * 8 == kTN, "warp tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_lo = w_hi + kTK * kWRow;
  unsigned char* ring = smem + 2 * kWTileT;

  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * kTN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = K / 2;
  const int Kq = BITS == 4 ? H : K;
  const int qbeg = split * kchunk;
  const int qend = min(qbeg + kchunk, Kq);
  const int nk = (qend - qbeg + QR - 1) / QR;
  const bool sub = BITS == 4 || has_off;
  const bool direct = G < 8;
  const int srh = direct ? 0 : group_slots(QR, G);
  const bool al = aligned != 0;
  const int gshift = group_shift(G);

  auto load_stage = [&](int slot, int kt) {
    const int r0 = qbeg + kt * QR;
    unsigned char* base = ring + slot * stage_bytes;
    if (al) {
      for (int c = tid; c < kQTile / 16; c += kTThreads) {
        const int r = c / (kTN / 16), col = (c % (kTN / 16)) * 16;
        const bool ok = r0 + r < qend && n0 + col < N;
        const uint8_t* src =
            ok ? q + static_cast<size_t>(r0 + r) * N + n0 + col : q;
        cp_async16(base + r * kTN + col, src, ok);
      }
    } else {
      for (int c = tid; c < kQTile; c += kTThreads) {
        const int r = c / kTN, col = c % kTN;
        const bool ok = r0 + r < qend && n0 + col < N;
        base[r * kTN + col] =
            ok ? q[static_cast<size_t>(r0 + r) * N + n0 + col] : 0;
      }
    }
    // x tile: TM rows by kTK columns (bits 4: the low rows' 32 columns,
    // then the high rows' 32, K/2 further on)
    __nv_bfloat16* xdst = reinterpret_cast<__nv_bfloat16*>(base + kQTile);
    for (int c = tid; c < TM * kTK / 8; c += kTThreads) {
      const int r = c / (kTK / 8), kc = (c % (kTK / 8)) * 8;
      int kx;
      bool ok;
      if (BITS == 4) {
        const int half = kc / QR, rr = r0 + kc % QR;
        kx = half * H + rr;
        ok = rr < qend;
      } else {
        kx = r0 + kc;
        ok = kx < qend;
      }
      ok = ok && m0 + r < M;
      const __nv_bfloat16* src =
          ok ? x + static_cast<size_t>(m0 + r) * K + kx : x;
      cp_async16(xdst + r * kXRow + kc, src, ok);
    }
    if (!direct) {
      float* sdst = reinterpret_cast<float*>(base + kQTile + kXTile);
      const int n = min(QR, qend - r0);
      stage_groups<kTN, kTThreads>(sdst, sc, of, r0, n, G, gshift, n0, N,
                                   sub, al, tid);
      if (BITS == 4)
        stage_groups<kTN, kTThreads>(sdst + srh * 2 * kTN, sc, of, H + r0, n,
                                     G, gshift, n0, N, sub, al, tid);
    }
  };

  // dequantize the stage's q tile into W_hi, W_lo (k-major, kTK x kTN)
  const int wc = tid % 32;                   // this thread's 4 columns
  auto group = [&](int row) { return group_of(row, G, gshift); };
  auto dequant = [&](const unsigned char* base, int kt) {
    const int r0 = qbeg + kt * QR;
    const float* st = reinterpret_cast<const float*>(base + kQTile + kXTile);
    const int n = n0 + 4 * wc;
    const int slot_lo = group(r0), slot_hi = group(H + r0) - srh;
    auto put = [&](int k, int wrow, uint32_t v, bool high) {
      const int g = group(wrow);
      float4 s4, o4;
      if (direct) {
        s4 = load4(sc, g, n, N, al);
        o4 = sub ? load4(of, g, n, N, al) : s4;
      } else {
        const float* p =
            st + (g - (high ? slot_hi : slot_lo)) * 2 * kTN + 4 * wc;
        s4 = *reinterpret_cast<const float4*>(p);
        o4 = sub ? *reinterpret_cast<const float4*>(p + kTN) : s4;
      }
      const float4 n4 = neg_2p23(s4);
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = scaled<BITS>(v, c, pick(s4, c), pick(n4, c));
        w[c] = sub ? __fsub_rn(p, pick(o4, c)) : p;
      }
      const uint32_t h01 = pack_bf16(w[0], w[1]), h23 = pack_bf16(w[2], w[3]);
      const uint32_t l01 =
          pack_bf16(w[0] - __uint_as_float(h01 << 16),
                    w[1] - __uint_as_float(h01 & 0xffff0000u));
      const uint32_t l23 =
          pack_bf16(w[2] - __uint_as_float(h23 << 16),
                    w[3] - __uint_as_float(h23 & 0xffff0000u));
      *reinterpret_cast<uint2*>(w_hi + k * kWRow + 4 * wc) =
          make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(w_lo + k * kWRow + 4 * wc) =
          make_uint2(l01, l23);
    };
#pragma unroll
    for (int i = tid / 32; i < QR; i += kTThreads / 32) {
      const int qr = r0 + i;
      if (qr >= qend) {                      // past the split: zeros
        const uint2 z = make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(w_hi + i * kWRow + 4 * wc) = z;
        *reinterpret_cast<uint2*>(w_lo + i * kWRow + 4 * wc) = z;
        if (BITS == 4) {
          *reinterpret_cast<uint2*>(w_hi + (QR + i) * kWRow + 4 * wc) = z;
          *reinterpret_cast<uint2*>(w_lo + (QR + i) * kWRow + 4 * wc) = z;
        }
        continue;
      }
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(base + i * kTN + 4 * wc);
      if (BITS == 4) {
        put(i, qr, word_values<4>(word, false), false);
        put(QR + i, H + qr, word_values<4>(word, true), true);
      } else {
        put(i, qr, word_values<8>(word, false), false);
      }
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
    __syncthreads();                // everyone's; W tiles and slot kt-1 free
    const int next = kt + kTStages - 1;
    if (next < nk) load_stage(next % kTStages, next);
    cp_async_commit();
    const unsigned char* base = ring + (kt % kTStages) * stage_bytes;
    dequant(base, kt);
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
#pragma unroll
      for (int part_ = 0; part_ < 2; ++part_) {   // W_hi, then W_lo
        const __nv_bfloat16* wt = part_ ? w_lo : w_hi;
        uint32_t b[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, wt + (kk * 16 + (lane & 15)) * kWRow +
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
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
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
          *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(v0, v1);
        } else {
          if (col < N) out[at] = __float2bfloat16(v0);
          if (col + 1 < N) out[at + 1] = __float2bfloat16(v1);
        }
      }
}

// -- the second pass: the splits' partial sums in order, rounded once --------

template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  T* __restrict__ out, long long MN,
                                  int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * MN + i];
    out[i] = from_f32<T>(s);
  }
}

// The dynamic shared memory of the (BITS, TM) kernel at groups of G rows
// (the two W tiles and the ring), allowed on the current device.
template <int BITS, int TM>
cudaError_t tensor_smem(int G, int* smem) {
  *smem = 2 * kWTileT + kTStages * tensor_stage_bytes(BITS, TM, G);
  static int allowed[kDevices] = {};
  return allow_smem(packed_tensor_kernel<BITS, TM>, *smem, allowed);
}

template <int BITS, int TM>
cudaError_t launch_tensor(const void* x, const void* q, const void* sc,
                          const void* of, void* out, float* part, int M,
                          int K, int N, int G, int has_off, int splits,
                          int kchunk, int aligned, cudaStream_t stream) {
  int smem = 0;
  cudaError_t e = tensor_smem<BITS, TM>(G, &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + TM - 1) / TM, (N + kTN - 1) / kTN, splits);
  packed_tensor_kernel<BITS, TM><<<grid, kTThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(sc), static_cast<const float*>(of),
      static_cast<__nv_bfloat16*>(out), splits > 1 ? part : nullptr, M, K, N,
      G, has_off, kchunk, tensor_stage_bytes(BITS, TM, G), aligned);
  return cudaGetLastError();
}

// Blocks of the (BITS, TM) kernel one multiprocessor of the current
// device runs at once, at the shared memory its launch gives it.
template <int BITS, int TM>
cudaError_t tensor_occupancy(int G, int* blocks) {
  int smem = 0;
  cudaError_t e = tensor_smem<BITS, TM>(G, &smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, packed_tensor_kernel<BITS, TM>, kTThreads, smem);
}

// the split sum: a grid-stride loop over M x N, 16 blocks a multiprocessor
template <typename T>
cudaError_t sum_splits(const float* part, void* out, int M, int N, int splits,
                       int sms, cudaStream_t s) {
  const long long MN = static_cast<long long>(M) * N;
  const long long want = (MN + 255) / 256;
  const long long most = 16LL * sms;
  sum_splits_kernel<T><<<static_cast<int>(want < most ? want : most), 256, 0,
                         s>>>(part, static_cast<T*>(out), MN, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wt_packed

using namespace wt_packed;

// The limits the wrapper's plan (packed_plan) sizes its grid by, for the
// kernel that `path` (0 the decode path, 1 the tensor cores), `bm`,
// `bits` and x's type pick at groups of G rows: limits[0] its rows of q a
// stage (its K splits are whole stages), limits[1] its output columns a
// block, limits[2] the blocks of it one multiprocessor of the current
// device runs at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// the shared memory its launch gives it: registers and shared memory
// both count). Returns a CUDA error code, cudaErrorInvalidValue for a
// kernel there is not.
extern "C" int wt_packed_limits(int path, int bm, int bits, int x_is_bf16,
                                int G, int* limits) {
  if ((bits != 4 && bits != 8) || G <= 0 || limits == nullptr ||
      (path == 0 && bm != 1 && bm != 2 && bm != 4 && bm != 8 && bm != 16) ||
      (path == 1 && (!x_is_bf16 || (bm != 16 && bm != 64))) ||
      (path != 0 && path != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (path == 1) {
    limits[0] = bits == 4 ? kTK / 2 : kTK;
    limits[1] = kTN;
    auto run = bits == 4
                   ? (bm == 16 ? tensor_occupancy<4, 16> : tensor_occupancy<4, 64>)
                   : (bm == 16 ? tensor_occupancy<8, 16> : tensor_occupancy<8, 64>);
    e = run(G, limits + 2);
  } else {
    limits[0] = bits == 4 ? kRows / 2 : kRows;
    limits[1] = kBN;
    e = x_is_bf16 ? cores_bf16_blocks(bits, bm, G, limits + 2)
                  : cores_f32_blocks(bits, bm, G, limits + 2);
  }
  return static_cast<int>(e);
}

// One call: the kernel of `path` (0: the decode path with `bm` rows of x
// per block, 1: the tensor-core path with tiles of `bm` = 16 or 64 rows),
// K split into `splits` runs of
// `kchunk` rows of q; when splits > 1 the partial sums go to `part` (f32,
// splits x M x N) and a second kernel adds them into `out` (its grid
// sized by `sms`, the device's multiprocessors). Returns
// cudaGetLastError() after the launches; cudaErrorInvalidValue for a
// shape or plan the kernels do not take (the Python wrapper checks first).
extern "C" int wt_packed_matmul(const void* x, const void* q, const void* sc,
                                const void* of, void* out, void* part, int M,
                                int K, int N, int G, int bits, int has_off,
                                int x_is_bf16, int path, int bm, int splits,
                                int kchunk, int sms, void* stream) {
  const int Kq = bits == 4 ? K / 2 : K;
  const int stage = path == 1 ? (bits == 4 ? kTK / 2 : kTK)
                              : (bits == 4 ? kRows / 2 : kRows);
  const int bn = path == 1 ? kTN : kBN;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || G <= 0 || K % G != 0 ||
      (bits != 4 && bits != 8) || (path != 0 && path != 1) ||
      (path == 1 && !x_is_bf16) ||
      (path == 0 && bm != 1 && bm != 2 && bm != 4 && bm != 8 && bm != 16) ||
      (path == 1 && bm != 16 && bm != 64) ||
      splits < 1 || splits > 65535 || kchunk <= 0 || kchunk % stage != 0 ||
      sms <= 0 ||
      static_cast<long long>(splits) * kchunk < Kq ||
      static_cast<long long>(splits - 1) * kchunk >= Kq ||
      (splits > 1 && part == nullptr) || (N + bn - 1) / bn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const int aligned = N % 16 == 0;
  cudaError_t e;
  if (path == 1) {
    auto run = bits == 4
                   ? (bm == 16 ? launch_tensor<4, 16> : launch_tensor<4, 64>)
                   : (bm == 16 ? launch_tensor<8, 16> : launch_tensor<8, 64>);
    e = run(x, q, sc, of, out, p, M, K, N, G, has_off, splits, kchunk, aligned,
            s);
  } else if (x_is_bf16) {
    e = cores_bf16(x, q, sc, of, out, p, M, K, N, G, bits, has_off, bm,
                   splits, kchunk, aligned, s);
  } else {
    e = cores_f32(x, q, sc, of, out, p, M, K, N, G, bits, has_off, bm, splits,
                  kchunk, aligned, s);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  e = x_is_bf16 ? sum_splits<__nv_bfloat16>(p, out, M, N, splits, sms, s)
                : sum_splits<float>(p, out, M, N, splits, sms, s);
  return static_cast<int>(e);
}
