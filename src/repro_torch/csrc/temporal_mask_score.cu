// Validity-masked temporal top-k (the point-in-time leakage guard), fp32,
// for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/temporal_mask_score/temporal_mask_score.py, `_kernel`
// launched by `temporal_block_candidates`: a row is a candidate for query
// q only if its validity interval overlaps the query's window,
// valid_from < t1[q] and t0[q] < valid_to, and every other row is -inf
// BEFORE ranking, so an out-of-window row can never be returned. The TPU
// split each int64 timestamp into (hi, lo) int32 halves; Hopper compares
// int64 natively, so epoch-microsecond stamps above 2^32 and
// VALID_TO_OPEN (int64 max) are compared as they are.
//
// What bounds it on an H100 SXM: the larger of
//   bytes:      N*D*4 (history) + 16*N (valid_from, valid_to) + Q*D*4
//               + 16*Q (windows), read once, over 3.35 TB/s of HBM3;
//   operations: 2*Q*N*D fp32 FLOPs over the 67 TFLOP/s fp32 CUDA-core
//               rate.
// Over a resident history of a million 384-wide rows the bytes bound at
// small Q and the FLOPs above Q ~ 20. Scores are computed for masked
// pairs too (the tile is dense), so the work does not shrink with the
// window. The shared body and its batch-invariance argument are in
// topk_tile.cuh.
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
// all contiguous on one device; out_s/out_i (grid_x, Q, k) with grid_x
// from topk_tile_grid_x. Returns cudaGetLastError().
extern "C" int temporal_window_topk_f32(
    const float* q, const float* corpus, const int64_t* vf,
    const int64_t* vt, const int64_t* t0, const int64_t* t1, float* out_s,
    int* out_i, long long Q, long long N, long long D, long long k,
    long long grid_x, void* stream) {
  return topk_tile::launch(q, corpus, WindowMask{vf, vt, t0, t1}, out_s,
                           out_i, Q, N, D, k, grid_x, stream);
}
