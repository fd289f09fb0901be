// Ragged KV-cache write, for Hopper: one launch writes one cache or two
// (a layer's K and V).
//
// Replaces the TPU kernel ragged_kv_write
// (whisper_tensor_tpu/backends/pallas/kv_write.py:104, built at :30).
// Same semantics, for each cache c of the launch, as DynUpdateSliceMilli
// on axis 2 with XLA's clamp of the start:
//
//   cache_c[b, h, p + s, :] = update_c[b, h, s, :]   for s < S,
//   p = clamp(pos[b] < 0 ? pos[b] + L : pos[b], 0, L - S)
//
// (a negative start counts from the end, as numpy slicing in the oracle
// and jax.lax.dynamic_update_slice both do). pos is read through a
// stride: 1 for the batcher's per-row starts, 0 for the direct path's
// scalar start, which every row shares.
//
//   cache_c  (B, H, L, D) bf16 or f32, contiguous, written IN PLACE
//   update_c (B, H, S, D) the cache's type, f32 or f16 into a bf16
//            cache (rounded to nearest even, as XLA's convert: an f16
//            value is exact in f32 first), or bf16 or f16 into an f32
//            cache (widened, exactly); any strides, its own for each c
//   pos      (B,) or () int64 or int32, read on the device
//
// What bounds it on the H100: launch latency and the host, not bytes. A
// decode step of 16 rows of 8 heads of 128 moves 64 KB into the K and V
// caches together (0.04 us at 3.35 TB/s); a 128-row admission piece of 4
// rows 4 MB (1.25 us). The design follows from that:
//   * one launch writes both caches of a layer: the recipes emit K's and
//     V's CacheWrite with the same start, and the port's graph pass
//     pair_cache_writes (milli/transforms.py) merges them, so a layer
//     costs one launch and one wrapper call, and the direct path's
//     scalar start takes the kernel too;
//   * a flat grid over 16-byte units of the caches, (cache, row, head,
//     unit of the S * D run), so every thread of a decode step moves one
//     whole vector and a 128-row piece spreads over the card's
//     multiprocessors (1,024 blocks at B = 4); the wrapper's plan
//     (kv_write.py:kv_write_plan) sizes the grid to one wave of the card
//     and the threads stride over what is left;
//   * the S rows of a (row, head) slab are consecutive in the cache, so
//     unit u lands at slab offset u * 16 bytes and touches nothing else;
//     the TPU kernel's 8-row tile read-modify-write (kv_write.py:36-58)
//     exists for HBM sublane tiling and is not carried over;
//   * each update is read through its own strides, so the transposed V
//     view of the llama recipe needs no copy; where a cache's feature
//     dim is unit stride and every offset is 16-byte aligned its units
//     move as one 16-byte load and store (two loads for f32 into bf16,
//     one 8-byte load for bf16 or f16 into f32), else element by element;
//   * pos is read on the device (the host never waits for it), int64 or
//     int32 as it comes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 16;        // 2,048 threads a multiprocessor

struct Cache {
  void* data;                           // (B, H, L, D), contiguous
  const void* upd;                      // (B, H, S, D), strided
  long long sb, sh, ss, sd;             // update strides, in elements
  int vec;                              // 16-byte units (checked)
};

struct Geometry {
  Cache c[2];
  const void* pos;
  long long pos_stride;                 // in elements; 0: one start
  int pos_i32;
  int caches, B, H, L, D, S;
  int units_per_slab;                   // ceil(S * D / cache elements a unit)
  int units;                            // caches * B * H * units_per_slab
};

__device__ __forceinline__ long long slab_start(const Geometry& g, int b) {
  const long long i = b * g.pos_stride;
  long long p = g.pos_i32 ? static_cast<const int32_t*>(g.pos)[i]
                          : static_cast<const int64_t*>(g.pos)[i];
  if (p < 0) p += g.L;
  const long long hi = g.L - g.S;
  return p < 0 ? 0 : (p > hi ? hi : p);
}

__device__ __forceinline__ __nv_bfloat16 to_cache(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_cache(__half x,
                                                  __nv_bfloat16*) {
  return __float2bfloat16_rn(__half2float(x));
}
__device__ __forceinline__ float to_cache(float x, float*) { return x; }
__device__ __forceinline__ float to_cache(__nv_bfloat16 x, float*) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_cache(__half x, float*) {
  return __half2float(x);
}
__device__ __forceinline__ __nv_bfloat16 to_cache(__nv_bfloat16 x,
                                                  __nv_bfloat16*) {
  return x;
}

// Two f32 rounded to bf16 (nearest even), the first in the low half: the
// order they take in memory.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Thread t of the grid takes units t, t + grid, ...; unit u is the
// kVec cache elements at offset e0 of slab u / units_per_slab.
template <typename Tc, typename Tu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    kv_write(const Geometry g) {
  constexpr int kVec = 16 / sizeof(Tc);  // cache elements a unit
  const int n = g.S * g.D;
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < g.units;
       u += gridDim.x * kThreads) {
    const int slab = u / g.units_per_slab;
    const int e0 = (u - slab * g.units_per_slab) * kVec;
    const int h = slab % g.H, bc = slab / g.H;
    const int b = bc % g.B;
    const Cache k = bc < g.B ? g.c[0] : g.c[1];
    const Tu* src = static_cast<const Tu*>(k.upd) + b * k.sb + h * k.sh;
    Tc* dst = static_cast<Tc*>(k.data)
              + ((static_cast<long long>(b) * g.H + h) * g.L
                 + slab_start(g, b)) * g.D + e0;
    if (k.vec) {                         // a unit lies in one row s
      const int s = e0 / g.D, d = e0 - s * g.D;
      const Tu* sp = src + s * k.ss + d;
      uint4 out;
      if constexpr (std::is_same<Tu, Tc>::value) {
        out = *reinterpret_cast<const uint4*>(sp);
      } else if constexpr (std::is_same<Tc, float>::value) {
        const uint2 v = *reinterpret_cast<const uint2*>(sp);  // 4 bf16/f16
        const Tu* e = reinterpret_cast<const Tu*>(&v);
        float* f = nullptr;
        out = make_uint4(__float_as_uint(to_cache(e[0], f)),
                         __float_as_uint(to_cache(e[1], f)),
                         __float_as_uint(to_cache(e[2], f)),
                         __float_as_uint(to_cache(e[3], f)));
      } else if constexpr (std::is_same<Tu, __half>::value) {
        const uint4 u = *reinterpret_cast<const uint4*>(sp);  // 8 f16
        const __half2* h = reinterpret_cast<const __half2*>(&u);
        float2 f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = __half22float2(h[i]);
        out = make_uint4(pack_bf16x2(f[0].x, f[0].y),
                         pack_bf16x2(f[1].x, f[1].y),
                         pack_bf16x2(f[2].x, f[2].y),
                         pack_bf16x2(f[3].x, f[3].y));
      } else {                           // 8 f32 -> 8 bf16, nearest even
        const float4 lo = reinterpret_cast<const float4*>(sp)[0];
        const float4 hi = reinterpret_cast<const float4*>(sp)[1];
        out = make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                         pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
      }
      *reinterpret_cast<uint4*>(dst) = out;
    } else {
      const int m = n - e0 < kVec ? n - e0 : kVec;
      for (int i = 0; i < m; ++i) {
        const int s = (e0 + i) / g.D, d = e0 + i - s * g.D;
        dst[i] = to_cache(src[s * k.ss + d * k.sd],
                          static_cast<Tc*>(nullptr));
      }
    }
  }
}

template <typename Tc, typename Tu>
cudaError_t launch(Geometry g, int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(Tc);
  for (int i = 0; i < g.caches; ++i) {
    Cache& k = g.c[i];
    // every source offset of a unit is a multiple of kVec elements and
    // 16-byte aligned when these hold (slabs start at multiples of D in
    // the cache)
    k.vec = k.sd == 1 && g.D % kVec == 0 && k.ss % kVec == 0
            && k.sh % kVec == 0 && k.sb % kVec == 0
            && reinterpret_cast<uintptr_t>(k.upd) % 16 == 0
            && reinterpret_cast<uintptr_t>(k.data) % 16 == 0;
  }
  kv_write<Tc, Tu><<<blocks, kThreads, 0, s>>>(g);
  return cudaGetLastError();
}

template <typename F>
cudaError_t with_mode(int mode, F&& f) {
  switch (mode) {
    case 0: return f(static_cast<__nv_bfloat16*>(nullptr),
                     static_cast<__nv_bfloat16*>(nullptr));
    case 1: return f(static_cast<float*>(nullptr),
                     static_cast<float*>(nullptr));
    case 2: return f(static_cast<__nv_bfloat16*>(nullptr),
                     static_cast<float*>(nullptr));
    case 3: return f(static_cast<__nv_bfloat16*>(nullptr),
                     static_cast<__half*>(nullptr));
    case 4: return f(static_cast<float*>(nullptr),
                     static_cast<__nv_bfloat16*>(nullptr));
    case 5: return f(static_cast<float*>(nullptr),
                     static_cast<__half*>(nullptr));
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// limits (int[3]) for `mode`: threads a block, blocks a multiprocessor of
// the current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and
// cache elements a unit. Returns a CUDA error code.
extern "C" int wt_kv_write_limits(int mode, int* limits) {
  if (limits == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_mode(mode, [&](auto* c, auto* u) {
    using Tc = typename std::remove_pointer<decltype(c)>::type;
    using Tu = typename std::remove_pointer<decltype(u)>::type;
    limits[0] = kThreads;
    limits[2] = 16 / sizeof(Tc);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        limits + 1, kv_write<Tc, Tu>, kThreads, 0);
  }));
}

// One launch writes `caches` (1 or 2) caches. geom (int64): caches, B, H,
// L, D, S, mode (0 bf16 into bf16, 1 f32 into f32, 2 f32 into bf16,
// 3 f16 into bf16, 4 bf16 into f32, 5 f16 into f32),
// pos_i32, pos stride, units a slab, units, blocks, then the update
// strides (b, h, s, d) of cache 0 and of cache 1. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// geometry the kernel does not take (the Python wrapper checks first).
extern "C" int wt_kv_write(void* cache0, const void* upd0, void* cache1,
                           const void* upd1, const void* pos,
                           const long long* geom, void* stream) {
  const long long caches = geom[0], B = geom[1], H = geom[2], L = geom[3],
                  D = geom[4], S = geom[5], mode = geom[6],
                  per_slab = geom[9], units = geom[10], blocks = geom[11];
  const long long vec = mode == 1 || mode >= 4 ? 4 : 8;  // f32 cache: 4
  if ((caches != 1 && caches != 2) || B <= 0 || H <= 0 || D <= 0 || S <= 0
      || S > L || L > 0x7fffffffLL || S * D > 0x7fffffffLL || mode < 0
      || mode > 5
      || per_slab != (S * D + vec - 1) / vec
      || units != caches * B * H * per_slab || units >= (1LL << 30)
      || blocks <= 0 || blocks > (1LL << 20) || cache0 == nullptr
      || upd0 == nullptr || pos == nullptr
      || (caches == 2 && (cache1 == nullptr || upd1 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{};
  g.c[0] = Cache{cache0, upd0, geom[12], geom[13], geom[14], geom[15], 0};
  g.c[1] = caches == 2
      ? Cache{cache1, upd1, geom[16], geom[17], geom[18], geom[19], 0}
      : g.c[0];
  g.pos = pos;
  g.pos_i32 = static_cast<int>(geom[7]);
  g.pos_stride = geom[8];
  g.caches = static_cast<int>(caches);
  g.B = static_cast<int>(B);
  g.H = static_cast<int>(H);
  g.L = static_cast<int>(L);
  g.D = static_cast<int>(D);
  g.S = static_cast<int>(S);
  g.units_per_slab = static_cast<int>(per_slab);
  g.units = static_cast<int>(units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  return static_cast<int>(with_mode(static_cast<int>(mode),
                                    [&](auto* c, auto* u) {
    using Tc = typename std::remove_pointer<decltype(c)>::type;
    using Tu = typename std::remove_pointer<decltype(u)>::type;
    return launch<Tc, Tu>(g, nb, s);
  }));
}
