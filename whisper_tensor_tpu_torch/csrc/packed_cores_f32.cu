// packed_matmul's decode path (a) for f32 x: see packed_matmul.cu.
#include "packed_matmul.cuh"

namespace wt_packed {

cudaError_t cores_f32(const void* x, const void* q, const void* sc,
                      const void* of, void* out, float* part, int M, int K,
                      int N, int G, int bits, int has_off, int bm,
                      int splits, int kchunk, int aligned, cudaStream_t s) {
  auto run = bits == 4 ? by_rows<float, 4> : by_rows<float, 8>;
  return run(x, q, sc, of, out, part, M, K, N, G, has_off, bm, splits, kchunk,
             aligned, s);
}

cudaError_t cores_f32_blocks(int bits, int bm, int G, int* blocks) {
  return bits == 4 ? blocks_by_rows<float, 4>(bm, G, blocks)
                   : blocks_by_rows<float, 8>(bm, G, blocks);
}

}  // namespace wt_packed
