// Shared body of the masked top-k scan kernels (topk_search.cu and
// temporal_mask_score.cu, fp32 and int8): fp32 scores on CUDA cores, a
// validity mask applied before ranking, and an exact per-block top-k
// under the order (score descending, row id ascending). Two selection
// paths share one scoring loop:
//
// List path (k <= KMAX = 128), topk_tile_kernel. Grid (gx, ceil(Qc /
// TQ)) over the Qc queries [q_begin, q_begin + Qc). Block (bx, by) owns
// the query tile [q_begin + by*TQ, +TQ) and a contiguous run of row
// tiles [bx*tiles_per_block, (bx+1)*tiles_per_block) of TR rows each (a
// block past the last tile writes empty lists). For every row tile it
//   1. computes the TQ x TR score tile (score_tile): each thread owns
//      QPT x RPT scores and sums the D products of each score in
//      ascending d with one fmaf per product, staging DK-deep slices of
//      the query and corpus tiles through shared memory (an int8 corpus
//      is widened to float as it is staged: exact, so the sum is the same
//      fmaf chain as over the dequantized fp32 rows with the scale in the
//      query);
//   2. writes the tile to shared memory with -inf at masked pairs and at
//      the ragged edge past N (the mask policy decides per (query, row));
//   3. folds the tile into a running top-k per query kept in registers:
//      one warp per query, repeated warp-argmax of the tile's remaining
//      scores, each winner inserted in order, until the best remaining
//      score no longer beats the list's k-th entry. The list holds SLOTS
//      entries per lane (k <= 32 * SLOTS); the launch takes the smallest
//      depth that holds k.
// It then writes its lists as candidates (gx, Qc, k): score and row id,
// (-inf, -1) where fewer than k rows were valid.
//
// Sort path (k > KMAX), topk_sort_kernel. Grid (ceil(N / SORT_ROWS),
// ceil(Qc / TQ)). Block (bx, by) scores the same query tile against the
// SORT_ROWS rows [bx*SORT_ROWS, +SORT_ROWS) with the same score_tile
// loop and mask, packs each (score, row) into one 64-bit key that sorts
// ascending in (score descending, row ascending), bitonic-sorts every
// query's SORT_ROWS keys in shared memory, and writes the first
// min(k, SORT_ROWS) as candidates (gx, Qc, min(k, SORT_ROWS)). Exact:
// a row outside its block's first min(k, SORT_ROWS) has at least that
// many better rows in the block, so it cannot be in the global top-k.
//
// The caller merges the gx lists of each query with one stable sort
// (kernels/common.py), and bounds the candidates of one launch by
// launching over chunks of the queries.
//
// Batch invariance: every score is one thread's ascending-d fmaf chain,
// whatever Q, gx, the path or the tile a query lands in, so a query
// scores bit-identically alone or inside any batch. Both selections are
// exact under a total order, so their result does not depend on the
// launch shape or the list depth either.
#pragma once

#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

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
constexpr int SLOTS_MAX = 4;            // list entries per lane, at most
constexpr int KMAX = 32 * SLOTS_MAX;    // largest k of the list path (128)
constexpr int SORT_ROWS = 512;          // rows one sort-path block ranks
constexpr int SORT_TILES = SORT_ROWS / TR;

struct Smem {
  float qs[DK][TQ + 1];                 // query slice, transposed
  float cs[DK][TR + 1];                 // corpus slice, transposed
  float sc[TQ][TR + 1];                 // masked score tile
};

struct SortSmem {                       // 151,808 bytes: dynamic
  float qs[DK][TQ + 1];
  float cs[DK][TR + 1];
  unsigned long long key[TQ][SORT_ROWS];  // sort_key(score, row)
};

// (a, ia) ranks before (b, ib): higher score, then lower row id.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Stage the DK-deep slice [d0, d0 + DK) of corpus rows [r0, r0 + TR)
// into cs, transposed and widened to float, zero past N and D. An
// int8 corpus with 4-byte aligned rows (vec4) is read a char4 at a time.
template <class T>
__device__ __forceinline__ void stage_corpus(float (&cs)[DK][TR + 1],
                                             const T* __restrict__ c,
                                             int r0, int d0, int N, int D,
                                             bool vec4, int tid) {
  if constexpr (std::is_same<T, int8_t>::value) {
    if (vec4) {
      constexpr int V = DK / 4;                 // char4 per row slice
      for (int e = tid; e < TR * V; e += THREADS) {
        const int rr = e / V, dd = (e % V) * 4;
        const int gr = r0 + rr, gd = d0 + dd;
        char4 v = make_char4(0, 0, 0, 0);
        if (gr < N && gd < D)                   // D % 4 == 0: gd + 3 < D
          v = *reinterpret_cast<const char4*>(c + (size_t)gr * D + gd);
        cs[dd][rr] = static_cast<float>(v.x);
        cs[dd + 1][rr] = static_cast<float>(v.y);
        cs[dd + 2][rr] = static_cast<float>(v.z);
        cs[dd + 3][rr] = static_cast<float>(v.w);
      }
      return;
    }
  }
  for (int e = tid; e < TR * DK; e += THREADS) {
    const int rr = e / DK, dd = e % DK;
    const int gr = r0 + rr, gd = d0 + dd;
    cs[dd][rr] = (gr < N && gd < D)
                        ? static_cast<float>(c[(size_t)gr * D + gd])
                        : 0.0f;
  }
}

// acc[i][j] = the score of query q0 + ty*QPT + i against corpus row
// r0 + tx + TX*j (ty, tx from tid): one ascending-d fmaf chain each, over
// DK-deep slices staged through qs and cs. Queries at or past q_end and
// rows at or past N read zeros. Starts and ends with the block in step.
template <class T>
__device__ __forceinline__ void score_tile(
    float (&qs)[DK][TQ + 1], float (&cs)[DK][TR + 1],
    const float* __restrict__ q, const T* __restrict__ c, int q0,
    int q_end, int r0, int N, int D, bool vec4, int tid,
    float (&acc)[QPT][RPT]) {
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = tid; e < TQ * DK; e += THREADS) {
      const int qq = e / DK, dd = e % DK;
      const int gq = q0 + qq, gd = d0 + dd;
      qs[dd][qq] = (gq < q_end && gd < D) ? q[(size_t)gq * D + gd] : 0.0f;
    }
    stage_corpus<T>(cs, c, r0, d0, N, D, vec4, tid);
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < DK; ++dd) {
      float qv[QPT], cv[RPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) qv[i] = qs[dd][ty * QPT + i];
#pragma unroll
      for (int j = 0; j < RPT; ++j) cv[j] = cs[dd][tx + TX * j];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <class T, int SLOTS, class Mask>
__global__ void __launch_bounds__(THREADS)
topk_tile_kernel(const float* __restrict__ q, const T* __restrict__ c,
                 Mask mask, float* __restrict__ out_s,
                 int* __restrict__ out_i, int q_begin, int q_count, int N,
                 int D, int k, int tiles_per_block, bool vec4) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = q_begin + blockIdx.y * TQ;
  const int q_end = q_begin + q_count;
  const int ntiles = (N + TR - 1) / TR;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(ntiles, t_begin + tiles_per_block);

  // running top-k of each of this warp's queries: entry j lives in lane
  // j % 32, slot j / 32; (-inf, -1) marks an empty entry
  float ls[QPW][SLOTS];
  int li[QPW][SLOTS];
  float thr_s[QPW];                     // entry k-1: the bar to beat
  int thr_i[QPW];
#pragma unroll
  for (int t = 0; t < QPW; ++t) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      ls[t][s] = -CUDART_INF_F;
      li[t][s] = -1;
    }
    thr_s[t] = -CUDART_INF_F;
    thr_i[t] = -1;
  }

  typename Mask::Qry qry[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int gq = q0 + ty * QPT + i;
    qry[i] = mask.query(gq < q_end ? gq : q_begin);
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int r0 = tile * TR;
    float acc[QPT][RPT];
    score_tile<T>(sm.qs, sm.cs, q, c, q0, q_end, r0, N, D, vec4, tid, acc);

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
        const bool ok = in_n && gq < q_end && Mask::valid(qry[i], row);
        sm.sc[ty * QPT + i][rr] = ok ? acc[i][j] : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // fold the tile into each query's running top-k (one warp a query)
#pragma unroll
    for (int t = 0; t < QPW; ++t) {
      const int ql = warp * QPW + t;
      if (q0 + ql >= q_end) continue;                // warp-uniform
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
        int pos = 0;
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl)
          pos += __popc(__ballot_sync(
              0xffffffffu, lane + 32 * sl < k &&
                               better(ls[t][sl], li[t][sl], bv, bi)));
        // entry j - 1 of every entry j: the lane below, or lane 31 of the
        // slot below for lane 0 (read before anything moves)
        float prev_s[SLOTS];
        int prev_i[SLOTS];
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          prev_s[sl] = __shfl_up_sync(0xffffffffu, ls[t][sl], 1);
          prev_i[sl] = __shfl_up_sync(0xffffffffu, li[t][sl], 1);
        }
#pragma unroll
        for (int sl = 1; sl < SLOTS; ++sl) {
          const float w_s = __shfl_sync(0xffffffffu, ls[t][sl - 1], 31);
          const int w_i = __shfl_sync(0xffffffffu, li[t][sl - 1], 31);
          if (lane == 0) {
            prev_s[sl] = w_s;
            prev_i[sl] = w_i;
          }
        }
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          const int j = lane + 32 * sl;
          if (j == pos) {
            ls[t][sl] = bv;
            li[t][sl] = bi;
          } else if (j > pos) {
            ls[t][sl] = prev_s[sl];
            li[t][sl] = prev_i[sl];
          }
        }
        // the new bar: entry k - 1, in lane (k-1) % 32, slot (k-1) / 32
        const int last = k - 1;
        float mine_s = ls[t][0];
        int mine_i = li[t][0];
#pragma unroll
        for (int sl = 1; sl < SLOTS; ++sl)
          if ((last >> 5) == sl) {
            mine_s = ls[t][sl];
            mine_i = li[t][sl];
          }
        thr_s[t] = __shfl_sync(0xffffffffu, mine_s, last & 31);
        thr_i[t] = __shfl_sync(0xffffffffu, mine_i, last & 31);
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
    if (gq >= q_end) continue;
    const size_t base = ((size_t)blockIdx.x * q_count + (gq - q_begin)) * k;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      const int j = lane + 32 * sl;
      if (j < k) {
        out_s[base + j] = ls[t][sl];
        out_i[base + j] = li[t][sl];
      }
    }
  }
}

// One 64-bit key per (score, row) whose ascending order is (score
// descending, row ascending): the high word is the score's bits mapped to
// an unsigned order and inverted, the low word the row. -0 is keyed as
// +0, so the two tie as they do under float comparison.
__device__ __forceinline__ unsigned long long sort_key(float s, int row) {
  unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);   // ascending in s
  return ((unsigned long long)(~u) << 32) | (unsigned)row;
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned u = ~(unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

template <class T, class Mask>
__global__ void __launch_bounds__(THREADS)
topk_sort_kernel(const float* __restrict__ q, const T* __restrict__ c,
                 Mask mask, float* __restrict__ out_s,
                 int* __restrict__ out_i, int q_begin, int q_count, int N,
                 int D, int kk, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SortSmem& sm = *reinterpret_cast<SortSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = q_begin + blockIdx.y * TQ;
  const int q_end = q_begin + q_count;
  const int c0 = blockIdx.x * SORT_ROWS;
  // a row past N: after every masked row, and read back as (-inf, -1)
  const unsigned long long pad = sort_key(-CUDART_INF_F, 0x7fffffff);

  typename Mask::Qry qry[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int gq = q0 + ty * QPT + i;
    qry[i] = mask.query(gq < q_end ? gq : q_begin);
  }

  for (int t = 0; t < SORT_TILES; ++t) {
    const int r0 = c0 + t * TR;
    float acc[QPT][RPT];
    score_tile<T>(sm.qs, sm.cs, q, c, q0, q_end, r0, N, D, vec4, tid, acc);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int rr = tx + TX * j;
      const int gr = r0 + rr;
      const bool in_n = gr < N;
      const typename Mask::Row row = mask.row(in_n ? gr : 0);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int gq = q0 + ty * QPT + i;
        const bool ok = in_n && gq < q_end && Mask::valid(qry[i], row);
        sm.key[ty * QPT + i][t * TR + rr] =
            in_n ? sort_key(ok ? acc[i][j] : -CUDART_INF_F, gr) : pad;
      }
    }
  }
  __syncthreads();

  // bitonic sort of each query's SORT_ROWS keys, ascending; one
  // compare-exchange per (query, pair) and stage, TQ queries at once
  constexpr int PAIRS = SORT_ROWS / 2;
  for (int size = 2; size <= SORT_ROWS; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < TQ * PAIRS; p += THREADS) {
        const int ql = p / PAIRS;
        const int pp = p % PAIRS;
        const int a = (pp / stride) * 2 * stride + pp % stride;
        const int b = a + stride;
        const bool up = (a & size) == 0;
        const unsigned long long ka = sm.key[ql][a];
        const unsigned long long kb = sm.key[ql][b];
        if ((ka > kb) == up) {
          sm.key[ql][a] = kb;
          sm.key[ql][b] = ka;
        }
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < TQ * kk; e += THREADS) {
    const int ql = e / kk, j = e % kk;
    const int gq = q0 + ql;
    if (gq >= q_end) continue;
    const unsigned long long key = sm.key[ql][j];
    const float s = key_score(key);
    const size_t o = ((size_t)blockIdx.x * q_count + (gq - q_begin)) * kk + j;
    out_s[o] = s;
    out_i[o] = s > -CUDART_INF_F ? (int)(unsigned)(key & 0xffffffffu) : -1;
  }
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Candidates each block writes per query: k on the list path,
// min(k, SORT_ROWS) on the sort path.
inline long long list_len(long long k) {
  return k <= KMAX ? k : (k < SORT_ROWS ? k : SORT_ROWS);
}

// Row blocks for a scan of N rows by Q queries at this k on a card with
// `sms` SMs. List path: about four blocks per SM in all, each given at
// least one tile. Sort path: one block per SORT_ROWS rows.
inline long long grid_x_for(long long N, long long Q, long long sms,
                            long long k) {
  if (k > KMAX) return ceil_div(N > 0 ? N : 1, SORT_ROWS);
  const long long ntiles = ceil_div(N > 0 ? N : 1, TR);
  const long long gy = ceil_div(Q > 0 ? Q : 1, TQ);
  long long want = ceil_div(4 * sms, gy);
  if (want > ntiles) want = ntiles;
  if (want < 1) want = 1;
  return ceil_div(ntiles, ceil_div(ntiles, want));
}

// One launch over the queries [q_begin, q_begin + q_count) of Q; writes
// candidates (grid_x, q_count, list_len(k)). T is the corpus element
// type: float, or int8_t (scale folded into q).
// List path (k <= KMAX): any grid_x >= 1 is correct: block bx scans
// tiles [bx * per, (bx + 1) * per) and a block past the end writes empty
// lists. The list depth is the smallest that holds k: 2 entries a lane
// for k <= 64, 4 for k <= 128.
// Sort path (k > KMAX): grid_x must be grid_x_for(N, ., ., k).
template <class T, class Mask>
int launch(const float* q, const T* c, Mask mask, float* out_s,
           int* out_i, long long Q, long long N, long long D, long long k,
           long long grid_x, long long q_begin, long long q_count,
           void* stream) {
  if (k < 1 || Q < 1 || N < 1 || D < 1 || grid_x < 1 || q_begin < 0 ||
      q_count < 1 || q_begin + q_count > Q || N > 0x7ffffffeLL ||
      (k > KMAX && grid_x != grid_x_for(N, Q, 1, k)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)ceil_div(q_count, TQ));
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 4 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (k > KMAX) {
    const int smem = (int)sizeof(SortSmem);
    const cudaError_t err = cudaFuncSetAttribute(
        topk_sort_kernel<T, Mask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    topk_sort_kernel<T, Mask><<<grid, THREADS, smem, st>>>(
        q, c, mask, out_s, out_i, (int)q_begin, (int)q_count, (int)N,
        (int)D, (int)list_len(k), vec4);
    return (int)cudaGetLastError();
  }
  const long long per = ceil_div(ceil_div(N, TR), grid_x);
  if (k <= 64)
    topk_tile_kernel<T, 2, Mask><<<grid, THREADS, 0, st>>>(
        q, c, mask, out_s, out_i, (int)q_begin, (int)q_count, (int)N,
        (int)D, (int)k, (int)per, vec4);
  else
    topk_tile_kernel<T, SLOTS_MAX, Mask><<<grid, THREADS, 0, st>>>(
        q, c, mask, out_s, out_i, (int)q_begin, (int)q_count, (int)N,
        (int)D, (int)k, (int)per, vec4);
  return (int)cudaGetLastError();
}

}  // namespace topk_tile

// Number of row blocks (the leading dim of the candidate output) that a
// launch for N rows and Q queries at this k should use.
extern "C" long long topk_tile_grid_x(long long N, long long Q,
                                      long long sms, long long k) {
  return topk_tile::grid_x_for(N, Q, sms, k);
}

// Candidates per (block, query) that a launch at this k writes.
extern "C" long long topk_tile_list_len(long long k) {
  return topk_tile::list_len(k);
}
