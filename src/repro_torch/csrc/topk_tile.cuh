// Shared body of the two masked top-k scan kernels (topk_search.cu and
// temporal_mask_score.cu): fp32 scores on CUDA cores, a validity mask
// applied before ranking, and an exact per-block top-k under the order
// (score descending, row id ascending).
//
// Layout of one launch: grid (gx, ceil(Q / TQ)). Block (bx, by) owns
// the query tile [by*TQ, by*TQ + TQ) and a contiguous run of row tiles
// [bx*tiles_per_block, (bx+1)*tiles_per_block) of TR rows each (a
// block past the last tile writes empty lists). For
// every row tile it
//   1. computes the TQ x TR score tile: each thread owns QPT x RPT
//      scores and sums the D products of each score in ascending d with
//      one fmaf per product, staging DK-deep slices of the query and
//      corpus tiles through shared memory;
//   2. writes the tile to shared memory with -inf at masked pairs and at
//      the ragged edge past N (the mask policy decides per (query, row));
//   3. folds the tile into a running top-k per query kept in registers:
//      one warp per query, repeated warp-argmax of the tile's remaining
//      scores, each winner inserted in order, until the best remaining
//      score no longer beats the list's k-th entry.
// It then writes its lists as candidates (gx, Q, k): score and row id,
// (-inf, -1) where fewer than k rows were valid. The caller merges the
// gx lists of each query with one stable sort.
//
// Batch invariance: every score is one thread's ascending-d fmaf chain,
// whatever Q, gx or the tile a query lands in, so a query scores
// bit-identically alone or inside any batch. The selection is exact
// under a total order, so its result does not depend on the launch
// shape either.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace topk_tile {

constexpr int TQ = 32;                  // queries per block
constexpr int TR = 128;                 // corpus rows per tile
constexpr int DK = 32;                  // depth of one staged slice of D
constexpr int THREADS = 256;
constexpr int TX = 16;                  // threads along rows
constexpr int TY = THREADS / TX;        // threads along queries
constexpr int QPT = TQ / TY;            // queries per thread (2)
constexpr int RPT = TR / TX;            // rows per thread (8)
constexpr int WARPS = THREADS / 32;
constexpr int QPW = TQ / WARPS;         // queries selected per warp (4)
constexpr int RPL = TR / 32;            // tile scores per lane (4)
constexpr int KMAX = 64;                // two list entries per lane

struct Smem {
  float qs[DK][TQ + 1];                 // query slice, transposed
  float cs[DK][TR + 1];                 // corpus slice, transposed
  float sc[TQ][TR + 1];                 // masked score tile
};

// (a, ia) ranks before (b, ib): higher score, then lower row id.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <class Mask>
__global__ void __launch_bounds__(THREADS)
topk_tile_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 Mask mask, float* __restrict__ out_s,
                 int* __restrict__ out_i, int Q, int N, int D, int k,
                 int tiles_per_block) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.y * TQ;
  const int ntiles = (N + TR - 1) / TR;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(ntiles, t_begin + tiles_per_block);

  // running top-k of each of this warp's queries: entry j lives in lane
  // j % 32, slot j / 32; (-inf, -1) marks an empty entry
  float ls[QPW][2];
  int li[QPW][2];
  float thr_s[QPW];                     // entry k-1: the bar to beat
  int thr_i[QPW];
#pragma unroll
  for (int t = 0; t < QPW; ++t) {
    ls[t][0] = ls[t][1] = -CUDART_INF_F;
    li[t][0] = li[t][1] = -1;
    thr_s[t] = -CUDART_INF_F;
    thr_i[t] = -1;
  }

  typename Mask::Qry qry[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int gq = q0 + ty * QPT + i;
    qry[i] = mask.query(gq < Q ? gq : 0);
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int r0 = tile * TR;
    float acc[QPT][RPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[i][j] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      for (int e = tid; e < TQ * DK; e += THREADS) {
        const int qq = e / DK, dd = e % DK;
        const int gq = q0 + qq, gd = d0 + dd;
        sm.qs[dd][qq] = (gq < Q && gd < D) ? q[(size_t)gq * D + gd] : 0.0f;
      }
      for (int e = tid; e < TR * DK; e += THREADS) {
        const int rr = e / DK, dd = e % DK;
        const int gr = r0 + rr, gd = d0 + dd;
        sm.cs[dd][rr] = (gr < N && gd < D) ? c[(size_t)gr * D + gd] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < DK; ++dd) {
        float qv[QPT], cv[RPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) qv[i] = sm.qs[dd][ty * QPT + i];
#pragma unroll
        for (int j = 0; j < RPT; ++j) cv[j] = sm.cs[dd][tx + TX * j];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < RPT; ++j)
            acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // masked score tile -> shared memory
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int rr = tx + TX * j;
      const int gr = r0 + rr;
      const bool in_n = gr < N;
      const typename Mask::Row row = mask.row(in_n ? gr : 0);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int gq = q0 + ty * QPT + i;
        const bool ok = in_n && gq < Q && Mask::valid(qry[i], row);
        sm.sc[ty * QPT + i][rr] = ok ? acc[i][j] : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // fold the tile into each query's running top-k (one warp a query)
#pragma unroll
    for (int t = 0; t < QPW; ++t) {
      const int ql = warp * QPW + t;
      if (q0 + ql >= Q) continue;                    // warp-uniform
      float s[RPL];
#pragma unroll
      for (int m = 0; m < RPL; ++m) s[m] = sm.sc[ql][lane + 32 * m];
      while (true) {
        // lane-local best: rows rise with m, so ">" keeps the lower row
        float bv = -CUDART_INF_F;
        int bi = 0x7fffffff;
#pragma unroll
        for (int m = 0; m < RPL; ++m)
          if (s[m] > bv) {
            bv = s[m];
            bi = r0 + lane + 32 * m;
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (!(bv > -CUDART_INF_F)) break;            // nothing valid left
        if (!better(bv, bi, thr_s[t], thr_i[t])) break;
        // insert at pos = number of entries that rank before (bv, bi)
        const bool a_before = lane < k && better(ls[t][0], li[t][0], bv, bi);
        const bool b_before =
            lane + 32 < k && better(ls[t][1], li[t][1], bv, bi);
        const int pos = __popc(__ballot_sync(0xffffffffu, a_before)) +
                        __popc(__ballot_sync(0xffffffffu, b_before));
        float a_prev_s = __shfl_up_sync(0xffffffffu, ls[t][0], 1);
        int a_prev_i = __shfl_up_sync(0xffffffffu, li[t][0], 1);
        float b_prev_s = __shfl_up_sync(0xffffffffu, ls[t][1], 1);
        int b_prev_i = __shfl_up_sync(0xffffffffu, li[t][1], 1);
        const float a31_s = __shfl_sync(0xffffffffu, ls[t][0], 31);
        const int a31_i = __shfl_sync(0xffffffffu, li[t][0], 31);
        if (lane == 0) {
          b_prev_s = a31_s;
          b_prev_i = a31_i;
        }
        const int ja = lane, jb = lane + 32;
        if (ja == pos) {
          ls[t][0] = bv;
          li[t][0] = bi;
        } else if (ja > pos) {
          ls[t][0] = a_prev_s;
          li[t][0] = a_prev_i;
        }
        if (jb == pos) {
          ls[t][1] = bv;
          li[t][1] = bi;
        } else if (jb > pos) {
          ls[t][1] = b_prev_s;
          li[t][1] = b_prev_i;
        }
        const int last = k - 1;
        const float la_s = __shfl_sync(0xffffffffu, ls[t][0], last & 31);
        const int la_i = __shfl_sync(0xffffffffu, li[t][0], last & 31);
        const float lb_s = __shfl_sync(0xffffffffu, ls[t][1], last & 31);
        const int lb_i = __shfl_sync(0xffffffffu, li[t][1], last & 31);
        thr_s[t] = last < 32 ? la_s : lb_s;
        thr_i[t] = last < 32 ? la_i : lb_i;
        // retire the winner from its lane
#pragma unroll
        for (int m = 0; m < RPL; ++m)
          if (r0 + lane + 32 * m == bi) s[m] = -CUDART_INF_F;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < QPW; ++t) {
    const int gq = q0 + warp * QPW + t;
    if (gq >= Q) continue;
    const size_t base = ((size_t)blockIdx.x * Q + gq) * k;
    if (lane < k) {
      out_s[base + lane] = ls[t][0];
      out_i[base + lane] = li[t][0];
    }
    if (lane + 32 < k) {
      out_s[base + lane + 32] = ls[t][1];
      out_i[base + lane + 32] = li[t][1];
    }
  }
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Row blocks for a scan of N rows by Q queries on a card with `sms`
// SMs: about four blocks per SM in all, each given at least one tile.
inline long long grid_x_for(long long N, long long Q, long long sms) {
  const long long ntiles = ceil_div(N > 0 ? N : 1, TR);
  const long long gy = ceil_div(Q > 0 ? Q : 1, TQ);
  long long want = ceil_div(4 * sms, gy);
  if (want > ntiles) want = ntiles;
  if (want < 1) want = 1;
  return ceil_div(ntiles, ceil_div(ntiles, want));
}

// Any grid_x >= 1 is correct: block bx scans tiles
// [bx * per, (bx + 1) * per) and a block past the end writes empty lists.
template <class Mask>
int launch(const float* q, const float* c, Mask mask, float* out_s,
           int* out_i, long long Q, long long N, long long D, long long k,
           long long grid_x, void* stream) {
  if (k < 1 || k > KMAX || Q < 1 || N < 1 || D < 1 || grid_x < 1)
    return (int)cudaErrorInvalidValue;
  const long long per = ceil_div(ceil_div(N, TR), grid_x);
  const dim3 grid((unsigned)grid_x, (unsigned)ceil_div(Q, TQ));
  topk_tile_kernel<Mask><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      q, c, mask, out_s, out_i, (int)Q, (int)N, (int)D, (int)k, (int)per);
  return (int)cudaGetLastError();
}

}  // namespace topk_tile

// Number of row blocks (the leading dim of the candidate output) that a
// launch for N rows and Q queries should use.
extern "C" long long topk_tile_grid_x(long long N, long long Q,
                                      long long sms) {
  return topk_tile::grid_x_for(N, Q, sms);
}

// Message for a cudaError_t returned by a launch entry.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
