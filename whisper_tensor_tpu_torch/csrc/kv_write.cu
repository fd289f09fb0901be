// Ragged per-row KV-cache write, for Hopper.
//
// Replaces the TPU kernel ragged_kv_write
// (whisper_tensor_tpu/backends/pallas/kv_write.py:104, built at :30).
// Same semantics as DynUpdateSliceMilli with a (B,) start on axis 2,
// with XLA's clamp of the start:
//
//   cache[b, h, p + s, :] = update[b, h, s, :]   for s < S,
//   p = clamp(pos[b] < 0 ? pos[b] + L : pos[b], 0, L - S)
//
// (a negative start counts from the end, as numpy slicing in the oracle
// and jax.lax.dynamic_update_slice both do)
//
//   cache  (B, H, L, D) bf16 or f32, contiguous, written IN PLACE
//   update (B, H, S, D) the cache's type, or f32 into a bf16 cache
//          (rounded to nearest even); any strides
//   pos    (B,) int64, read on the device
//
// What bounds it on the H100: nothing but launch latency at the decode
// shape. A decode step writes B * H * D elements per K or V cache (32 KB
// at B = 16, H = 8, D = 128 in bf16); an admission piece k * H * S * D
// (1 MB at k = 4, S = 128). The design follows from that:
//   * one block per (row, head); the S rows of a slab are consecutive in
//     the cache, so each block writes one contiguous run of S * D
//     elements and touches nothing else of the cache;
//   * the TPU kernel's 8-row tile read-modify-write (kv_write.py:36-58)
//     exists for HBM sublane tiling and is not carried over: a Hopper
//     store needs no tile alignment;
//   * the update is read through its strides, so the transposed V view
//     of the llama recipe needs no copy; where the feature dim is unit
//     stride and every offset is 16-byte aligned, each thread moves 16
//     bytes per load and store, else one element;
//   * pos is read on the device: the host never waits for it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Geometry {
  int H, L, D, S;
  long long sb, sh, ss, sd;             // update strides, in elements
};

__device__ __forceinline__ long long slab_start(const int64_t* pos, int b,
                                                const Geometry& g) {
  long long p = pos[b];
  if (p < 0) p += g.L;
  const long long hi = g.L - g.S;
  return p < 0 ? 0 : (p > hi ? hi : p);
}

__device__ __forceinline__ __nv_bfloat16 to_cache(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_cache(float x, float*) { return x; }
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

// One element per thread and step: any strides.
template <typename Tc, typename Tu>
__global__ void __launch_bounds__(kThreads)
    kv_write_scalar(Tc* __restrict__ cache, const Tu* __restrict__ upd,
                    const int64_t* __restrict__ pos, Geometry g) {
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  Tc* dst = cache + ((static_cast<long long>(b) * g.H + h) * g.L
                     + slab_start(pos, b, g)) * g.D;
  const Tu* src = upd + b * g.sb + h * g.sh;
  const int n = g.S * g.D;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int s = e / g.D, d = e - s * g.D;
    dst[e] = to_cache(src[s * g.ss + d * g.sd], static_cast<Tc*>(nullptr));
  }
}

// 16 bytes of the cache per thread and step; the caller checked that
// the feature dim is unit stride and every offset is aligned.
template <typename Tc, typename Tu>
__global__ void __launch_bounds__(kThreads)
    kv_write_vec(Tc* __restrict__ cache, const Tu* __restrict__ upd,
                 const int64_t* __restrict__ pos, Geometry g) {
  constexpr int kVec = 16 / sizeof(Tc);  // cache elements per store
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  Tc* dst = cache + ((static_cast<long long>(b) * g.H + h) * g.L
                     + slab_start(pos, b, g)) * g.D;
  const Tu* src = upd + b * g.sb + h * g.sh;
  const int n = g.S * g.D / kVec;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int e = i * kVec, s = e / g.D, d = e - s * g.D;
    const Tu* sp = src + s * g.ss + d;
    uint4 out;
    if constexpr (sizeof(Tu) == sizeof(Tc)) {
      out = *reinterpret_cast<const uint4*>(sp);
    } else {                             // 8 f32 -> 8 bf16, nearest even
      const float4 lo = reinterpret_cast<const float4*>(sp)[0];
      const float4 hi = reinterpret_cast<const float4*>(sp)[1];
      out = make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                       pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
    }
    *reinterpret_cast<uint4*>(dst + e) = out;
  }
}

template <typename Tc, typename Tu>
cudaError_t launch(void* cache, const void* upd, const void* pos, int B,
                   const Geometry& g, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(Tc);
  // every source offset of a vector is a multiple of kVec elements and
  // 16-byte aligned when these hold (the cache rows start at multiples
  // of D, and the cache pointer comes from PyTorch's allocator)
  const bool vec = g.sd == 1 && g.D % kVec == 0 && g.ss % kVec == 0
                   && g.sh % kVec == 0 && g.sb % kVec == 0
                   && reinterpret_cast<uintptr_t>(upd) % 16 == 0
                   && reinterpret_cast<uintptr_t>(cache) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(B) * g.H);
  Tc* c = static_cast<Tc*>(cache);
  const Tu* u = static_cast<const Tu*>(upd);
  const int64_t* p = static_cast<const int64_t*>(pos);
  if (vec)
    kv_write_vec<Tc, Tu><<<grid, kThreads, 0, s>>>(c, u, p, g);
  else
    kv_write_scalar<Tc, Tu><<<grid, kThreads, 0, s>>>(c, u, p, g);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 bf16 update into a bf16 cache, 1 f32 into f32, 2 f32 into bf16.
extern "C" int wt_ragged_kv_write(void* cache, const void* upd,
                                  const void* pos, int B, int H, int L, int D,
                                  int S, long long sb, long long sh,
                                  long long ss, long long sd, int mode,
                                  void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || S <= 0 || S > L
      || static_cast<long long>(B) * H > 0x7fffffffLL
      || static_cast<long long>(S) * D > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{H, L, D, S, sb, sh, ss, sd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(
        launch<__nv_bfloat16, __nv_bfloat16>(cache, upd, pos, B, g, s));
    case 1: return static_cast<int>(
        launch<float, float>(cache, upd, pos, B, g, s));
    case 2: return static_cast<int>(
        launch<__nv_bfloat16, float>(cache, upd, pos, B, g, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
