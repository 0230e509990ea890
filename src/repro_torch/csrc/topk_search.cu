// Masked exact top-k similarity search, fp32 and int8, for sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/topk_search/topk_search.py:
//   topk_search_f32 <- `_kernel`, launched by `topk_block_candidates`;
//   topk_search_q8  <- `_kernel_q8`, launched by
//                      `topk_block_candidates_q8`.
// Both: Q x N dot scores, rows whose mask is false set to -inf before
// ranking, per-block top-k candidates merged by the caller
// (kernels/topk_search/ops.py). The int8 entry takes queries with the
// per-dimension quantization scale already folded in (qs = q * scale)
// and widens each int8 row element to float as it is staged, so its
// score is the exact dequantized dot product, summed in the same fmaf
// order as the fp32 entry.
//
// What bounds it on an H100 SXM: the larger of
//   bytes:      N*D*4 (corpus; N*D for int8) + N (mask) + Q*D*4
//               (queries), read once, over 3.35 TB/s of HBM3;
//   operations: 2*Q*N*D fp32 FLOPs over the 67 TFLOP/s fp32 rate of the
//               CUDA cores (no tensor cores: TF32 keeps ~3 decimal digits
//               and would break id parity with the JAX package).
// At the hot tier's fused block (N ~ 8k, D = 384) the scan is small and
// launch-bound at every batch size; the design keeps it to one launch
// plus one stable sort. The int8 entry cuts the corpus bytes by 4 but
// not the FMAs, so it gains only where bytes bound. The shared body and
// its batch-invariance argument are in topk_tile.cuh.
#include "topk_tile.cuh"

namespace {

struct BoolMask {
  const uint8_t* m;                     // torch.bool: one byte, 0 or 1
  struct Row {
    bool on;
  };
  struct Qry {};
  __device__ Row row(int r) const { return {m[r] != 0}; }
  __device__ Qry query(int) const { return {}; }
  __device__ static bool valid(const Qry&, const Row& r) { return r.on; }
};

}  // namespace

// q (Q, D) f32, corpus (N, D) f32, mask (N,) bool, all contiguous on one
// device; out_s/out_i (grid_x, q_count, topk_tile_list_len(k)) for the
// queries [q_begin, q_begin + q_count), grid_x from topk_tile_grid_x.
// Returns cudaGetLastError().
extern "C" int topk_search_f32(const float* q, const float* corpus,
                               const uint8_t* mask, float* out_s, int* out_i,
                               long long Q, long long N, long long D,
                               long long k, long long grid_x,
                               long long q_begin, long long q_count,
                               void* stream) {
  return topk_tile::launch(q, corpus, BoolMask{mask}, out_s, out_i, Q, N, D,
                           k, grid_x, q_begin, q_count, stream);
}

// qs (Q, D) f32 scale-folded queries, c8 (N, D) int8, mask (N,) bool,
// all contiguous on one device; outputs as topk_search_f32.
extern "C" int topk_search_q8(const float* qs, const int8_t* c8,
                              const uint8_t* mask, float* out_s, int* out_i,
                              long long Q, long long N, long long D,
                              long long k, long long grid_x,
                              long long q_begin, long long q_count,
                              void* stream) {
  return topk_tile::launch(qs, c8, BoolMask{mask}, out_s, out_i, Q, N, D, k,
                           grid_x, q_begin, q_count, stream);
}
