// Validity-masked temporal top-k (the point-in-time leakage guard), fp32
// and int8, for sm_90a.
//
// Replaces the TPU kernels of
// src/repro/kernels/temporal_mask_score/temporal_mask_score.py:
//   temporal_window_topk_f32 <- `_kernel`, launched by
//                               `temporal_block_candidates`;
//   temporal_window_topk_q8  <- `_kernel_q8`, launched by
//                               `temporal_block_candidates_q8`
//                               (int8 history, scale folded into the
//                               queries, rows widened to float as staged).
// Both: a row is a candidate for query
// q only if its validity interval overlaps the query's window,
// valid_from < t1[q] and t0[q] < valid_to, and every other row is -inf
// BEFORE ranking, so an out-of-window row can never be returned. The TPU
// split each int64 timestamp into (hi, lo) int32 halves; Hopper compares
// int64 natively, so epoch-microsecond stamps above 2^32 and
// VALID_TO_OPEN (int64 max) are compared as they are.
//
// What bounds it on an H100 SXM: the larger of
//   bytes:      N*D*4 (history; N*D for int8) + 16*N (valid_from,
//               valid_to) + Q*D*4 + 16*Q (windows), read once, over
//               3.35 TB/s of HBM3;
//   operations: 2*Q*N*D fp32 FLOPs over the 67 TFLOP/s fp32 CUDA-core
//               rate.
// Over a resident history of 384-wide rows, with every row in window,
// the bytes bound below Q ~ 40 and the FLOPs above it; for int8 the
// crossing is at Q ~ 10, since the FMAs do not shrink with the bytes.
// Scores are computed for masked pairs too (the tile is dense), so the
// work does not shrink with the window. The shared body and its
// batch-invariance argument are in topk_tile.cuh.
#include "topk_tile.cuh"

namespace {

struct WindowMask {
  const int64_t* vf;                    // (N,) valid_from
  const int64_t* vt;                    // (N,) valid_to (exclusive)
  const int64_t* t0;                    // (Q,) window start
  const int64_t* t1;                    // (Q,) window end (exclusive)
  struct Row {
    int64_t vf, vt;
  };
  struct Qry {
    int64_t t0, t1;
  };
  __device__ Row row(int r) const { return {vf[r], vt[r]}; }
  __device__ Qry query(int i) const { return {t0[i], t1[i]}; }
  __device__ static bool valid(const Qry& w, const Row& r) {
    return r.vf < w.t1 && w.t0 < r.vt;
  }
};

}  // namespace

// q (Q, D) f32, corpus (N, D) f32, vf/vt (N,) int64, t0/t1 (Q,) int64,
// all contiguous on one device; outputs and `work` for the queries
// [q_begin, q_begin + q_count) as topk_tile::launch says, grid_x from
// topk_tile_grid_x. Returns cudaGetLastError().
extern "C" int temporal_window_topk_f32(
    const float* q, const float* corpus, const int64_t* vf,
    const int64_t* vt, const int64_t* t0, const int64_t* t1, float* out_s,
    int* out_i, void* work, long long Q, long long N, long long D,
    long long k, long long grid_x, long long q_begin, long long q_count,
    void* stream) {
  return topk_tile::launch(q, corpus, WindowMask{vf, vt, t0, t1}, out_s,
                           out_i, work, Q, N, D, k, grid_x, q_begin, q_count,
                           stream);
}

// qs (Q, D) f32 scale-folded queries, c8 (N, D) int8 history, the rest
// as temporal_window_topk_f32.
extern "C" int temporal_window_topk_q8(
    const float* qs, const int8_t* c8, const int64_t* vf,
    const int64_t* vt, const int64_t* t0, const int64_t* t1, float* out_s,
    int* out_i, void* work, long long Q, long long N, long long D,
    long long k, long long grid_x, long long q_begin, long long q_count,
    void* stream) {
  return topk_tile::launch(qs, c8, WindowMask{vf, vt, t0, t1}, out_s, out_i,
                           work, Q, N, D, k, grid_x, q_begin, q_count,
                           stream);
}
