// Device helpers shared by the kernel sources: type conversions, cp.async
// copies, prmt and the exact int8 conversions it makes, the bf16
// tensor-core product and its ldmatrix fragment loads, and the opt-in to
// more than 48 KB of dynamic shared memory.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
// the same for 4 bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Byte c of a word of int8 values whose sign bits were flipped (u = q +
// 128), as the exact f32 q: prmt builds the float 2^23 + u (byte c, two
// zero bytes, 0x4B), and 2^23 + u - (2^23 + 128) is q, exactly.
__device__ __forceinline__ float i8_value(uint32_t flipped, int c) {
  return __int_as_float(prmt(flipped, 0x4B000000u, 0x7440u | c)) -
         8388736.f;
}

// A word of four int8 values (byte 0 the lowest column) as two bf16x2
// words, exactly: i8_value truncated to its top half (an int8 value has at
// most 7 significant bits, bf16 has 8).
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t q) {
  const uint32_t v = q ^ 0x80808080u;
  const uint32_t f0 = __float_as_uint(i8_value(v, 0));
  const uint32_t f1 = __float_as_uint(i8_value(v, 1));
  const uint32_t f2 = __float_as_uint(i8_value(v, 2));
  const uint32_t f3 = __float_as_uint(i8_value(v, 3));
  return make_uint2(prmt(f0, f1, 0x7632u), prmt(f2, f3, 0x7632u));
}

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

// four 8x8 b16 matrices from shared memory, lane l giving a row address
// of matrix l / 8; .trans transposes each
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Above 48 KB a block's dynamic shared memory must be allowed first, on
// each device. `allowed` is the caller's record (a static per kernel) of
// the most it allowed on each of the first kDevices devices: the
// attribute is set once per size and device, not on every launch.
constexpr int kDevices = 16;
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < kDevices) allowed[dev] = bytes;
  return e;
}

}  // namespace
