// Masked exact top-k similarity search, fp32, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/topk_search/topk_search.py,
// `_kernel` launched by `topk_block_candidates`: Q x N dot scores, rows
// whose mask is false set to -inf before ranking, per-block top-k
// candidates merged by the caller (kernels/topk_search/ops.py).
//
// What bounds it on an H100 SXM: the larger of
//   bytes:      N*D*4 (corpus) + N (mask) + Q*D*4 (queries), read once,
//               over 3.35 TB/s of HBM3;
//   operations: 2*Q*N*D fp32 FLOPs over the 67 TFLOP/s fp32 rate of the
//               CUDA cores (no tensor cores: TF32 keeps ~3 decimal digits
//               and would break id parity with the JAX package).
// At the hot tier's fused block (N ~ 8k, D = 384) the scan is small and
// launch-bound at every batch size; the design keeps it to one launch
// plus one stable sort. The shared body and its batch-invariance
// argument are in topk_tile.cuh.
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
// device; out_s/out_i (grid_x, Q, k) with grid_x from topk_tile_grid_x.
// Returns cudaGetLastError().
extern "C" int topk_search_f32(const float* q, const float* corpus,
                               const uint8_t* mask, float* out_s, int* out_i,
                               long long Q, long long N, long long D,
                               long long k, long long grid_x, void* stream) {
  return topk_tile::launch(q, corpus, BoolMask{mask}, out_s, out_i, Q, N, D,
                           k, grid_x, stream);
}
