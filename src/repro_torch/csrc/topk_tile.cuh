// Shared body of the masked top-k scan kernels (topk_search.cu and
// temporal_mask_score.cu, fp32 and int8): fp32 scores on CUDA cores, a
// validity mask applied before ranking, and an exact top-k under the
// order (score descending, row id ascending).
//
// Scoring loop (scan_tiles), shared by both selection paths. A block of
// 256 threads owns a tile of 8 QW queries (QW = 4: TQ = 32) and walks a
// run of row tiles of TR = 128 rows. Warp w owns queries [QW w, QW w +
// QW) of the tile and lane l rows l, l + 32, l + 64, l + 96 of each row
// tile, so a thread holds a QW x 4 block of scores in registers (QW = 8
// only where the select path scores more than 32 queries). The query and
// corpus tiles reach shared memory DK = 32 deep at a time through a ring
// of STAGES = 4 stages filled by 16-byte cp.async copies (zero-filled
// past N, D and the last query), so the copies of the next three slices,
// and of the next row tile, are in flight while the FMAs and the
// selection of this one run. Rows stay row-major in shared memory, padded
// so that the eight lanes of each quarter warp read eight different
// 16-byte bank groups: a thread reads a float4 of each of its queries (a
// broadcast: a warp shares them) and of each of its rows, and issues 16
// QW fmaf for every QW + 4 shared loads. An int8 corpus is copied as raw
// bytes (16 d a load) and widened at use, exactly, by the 2^23
// magic-number trick (one byte permute and one fadd). Every score is one
// thread's fmaf chain over d = 0, 1, ..., D - 1 and the zero padding to a
// multiple of DK, starting from 0.0f: the same chain, bit for bit,
// whatever the path, the launch shape, the batch or the tile a query
// lands in. Without 16-byte alignment (D * element size not a multiple
// of 16) the stages are filled by plain loads and stores instead: the
// same values, no overlap.
//
// List path (k <= KMAX = 128), topk_list_kernel. Grid (ceil(Qc / TQ),
// grid_x); block (bx, by) scans row tiles [by * per, (by + 1) * per). At
// the end of each row tile a warp folds its four queries' masked scores,
// straight from registers, into a running top-k per query kept in
// registers: repeated warp-argmax of the tile's remaining scores, each
// winner inserted in order, until the best remaining score no longer
// beats the list's k-th entry (SLOTS entries a lane, k <= 32 * SLOTS).
// It writes candidates (grid_x, Qc, k), (-inf, -1) where fewer than k
// rows were valid; the caller merges them (kernels/common.py).
//
// Select path (k > KMAX): an exact radix select over one 32-bit order key
// per (query, row), so that each query's work ends in k rows, not in
// candidate lists.
//   1. topk_key_kernel scores as above and writes key(score) to a
//      (Qc, N) buffer: ascending in score, -0 keyed as +0, 0 for a
//      masked row (below every valid key: -inf keys as 0x007fffff).
//   2. Four passes of an 8-bit digit, most significant first: a
//      histogram of the digit over the keys that match the prefix found
//      so far (select_hist_kernel, one block a (4096-row block, query),
//      warp-aggregated shared atomics), then select_digit_kernel picks,
//      per query, the digit in which the k-th largest key lies. After
//      them, T is that key and `need` the number of keys equal to T that
//      belong to the top k (k - need keys are above T). The keys of
//      masked rows are counted like any other, so a query with fewer than
//      k valid rows ends with T = 0 and fills the rest with masked rows.
//   3. select_above_kernel writes every (key > T, row) to the query's k
//      slots (warp-aggregated atomic slots; their order does not matter)
//      and counts each row block's keys equal to T; select_ties_kernel
//      then writes the `need` lowest rows whose key is T, in row order,
//      from a prefix count of ties over the row blocks: ties at the k-th
//      slot go to the lower row id.
//   4. select_order_kernel sorts each query's k packed (key, row) 64-bit
//      values in shared memory (bitonic, k <= ORDER_MAX = 8192, 64 KB)
//      and writes (score, row), (-inf, -1) for a masked row. For a larger
//      k the caller sorts the k packed values (torch.sort over k, not N)
//      and topk_tile_decode writes them out.
// Exact under a total order and fed the same scores, both paths return the
// same answers for any batch and launch shape, and the select path's
// first 128 entries are the list path's at k = 128. Its scores come back
// from the keys, so a -0 score is returned as +0.
#pragma once

#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace topk_tile {

constexpr int TQ = 32;                  // queries per block
constexpr int TR = 128;                 // corpus rows per tile
constexpr int DK = 32;                  // depth of one staged slice of D
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QPT = TQ / WARPS;         // queries per thread = per warp (4)
constexpr int RPT = TR / 32;            // rows per thread (4)
constexpr int STAGES = 4;               // depth of the cp.async ring
constexpr int QP = DK + 4;              // floats per staged query row
constexpr int SLOTS_MAX = 4;            // list entries per lane, at most
constexpr int KMAX = 32 * SLOTS_MAX;    // largest k of the list path (128)
constexpr int SEL_THREADS = 256;
constexpr int SEL_ROWS = 4096;          // rows of one select-pass block
constexpr int ORDER_MAX = 8192;         // largest k ordered in the kernel
constexpr int ORDER_THREADS = 1024;

// Bytes of one staged corpus row: fp32 DK + 4 floats (144), int8 DK + 16
// (48). Both put 8 consecutive rows in 8 different 16-byte bank groups.
template <class T>
__host__ __device__ constexpr int c_pitch() {
  return std::is_same<T, int8_t>::value ? DK + 16 : (DK + 4) * 4;
}
// One stage for QW queries a warp (8 QW a block).
template <class T, int QW>
__host__ __device__ constexpr int stage_bytes() {
  return WARPS * QW * QP * 4 + TR * c_pitch<T>();
}
// Dynamic shared memory of a scan block: fp32 92,160 B at QW = 4 and
// 110,592 B at 8; int8 43,008 B and 61,440 B.
template <class T, int QW>
__host__ __device__ constexpr int scan_smem() {
  return STAGES * stage_bytes<T, QW>();
}

// (a, ia) ranks before (b, ib): higher score, then lower row id.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fill one stage: queries [q0, q0 + 8 QW) and corpus rows [r0, r0 + TR),
// columns [d0, d0 + DK), zero past q_end, N and D.
template <class T, int QW>
__device__ __forceinline__ void stage_load(unsigned char* st,
                                           const float* __restrict__ q,
                                           const T* __restrict__ c, int q0,
                                           int q_end, int r0, int d0, int N,
                                           int D, bool vec, int tid) {
  constexpr int NQ = WARPS * QW;
  float* qs = reinterpret_cast<float*>(st);
  unsigned char* cs = st + NQ * QP * 4;
  constexpr int CP = c_pitch<T>();
  if (vec) {
    constexpr int QCH = DK * 4 / 16;                // 16-byte chunks a row
    for (int e = tid; e < NQ * QCH; e += THREADS) {
      const int qq = e / QCH, ch = e % QCH;
      const int gq = q0 + qq, gd = d0 + ch * 4;
      const bool in = gq < q_end && gd < D;
      cp_async16(hopper::smem_u32(qs + qq * QP + ch * 4),
                 in ? q + (size_t)gq * D + gd : q, in);
    }
    constexpr int EPC = 16 / (int)sizeof(T);        // elements a chunk
    constexpr int CCH = DK / EPC;
    for (int e = tid; e < TR * CCH; e += THREADS) {
      const int rr = e / CCH, ch = e % CCH;
      const int gr = r0 + rr, gd = d0 + ch * EPC;
      const bool in = gr < N && gd < D;
      cp_async16(hopper::smem_u32(cs + rr * CP + ch * 16),
                 in ? c + (size_t)gr * D + gd : c, in);
    }
    return;
  }
  for (int e = tid; e < NQ * DK; e += THREADS) {
    const int qq = e / DK, dd = e % DK;
    const int gq = q0 + qq, gd = d0 + dd;
    qs[qq * QP + dd] = (gq < q_end && gd < D) ? q[(size_t)gq * D + gd] : 0.0f;
  }
  for (int e = tid; e < TR * DK; e += THREADS) {
    const int rr = e / DK, dd = e % DK;
    const int gr = r0 + rr, gd = d0 + dd;
    reinterpret_cast<T*>(cs + rr * CP)[dd] =
        (gr < N && gd < D) ? c[(size_t)gr * D + gd] : T(0);
  }
}

// The int8 value in byte b of x, as float, exactly: 0x4B0000uu is
// 2^23 + uu with uu = byte + 128 (x pre-flipped by 0x80808080).
template <int B>
__device__ __forceinline__ float widen(uint32_t xf) {
  return __uint_as_float(__byte_perm(xf, 0x4B000000u, 0x7540 | B)) -
         8388736.0f;
}

__device__ __forceinline__ uint32_t word(const int4& v, int w) {
  return (uint32_t)(w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w);
}

// acc[i][j] += the products of query QW * warp + i and row lane + 32 j
// over one staged slice, in ascending d.
template <int QW>
__device__ __forceinline__ void fma_stage(const unsigned char* st,
                                          const float*, int warp, int lane,
                                          float (&acc)[QW][RPT]) {
  const float* qs = reinterpret_cast<const float*>(st) + warp * QW * QP;
  const float* cs =
      reinterpret_cast<const float*>(st + WARPS * QW * QP * 4);
#pragma unroll
  for (int dd = 0; dd < DK; dd += 4) {
    float4 qv[QW], cv[RPT];
#pragma unroll
    for (int i = 0; i < QW; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qs + i * QP + dd);
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      cv[j] = *reinterpret_cast<const float4*>(cs + (lane + 32 * j) * QP + dd);
#pragma unroll
    for (int i = 0; i < QW; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        acc[i][j] = fmaf(qv[i].x, cv[j].x, acc[i][j]);
        acc[i][j] = fmaf(qv[i].y, cv[j].y, acc[i][j]);
        acc[i][j] = fmaf(qv[i].z, cv[j].z, acc[i][j]);
        acc[i][j] = fmaf(qv[i].w, cv[j].w, acc[i][j]);
      }
  }
}

template <int QW>
__device__ __forceinline__ void fma_stage(const unsigned char* st,
                                          const int8_t*, int warp, int lane,
                                          float (&acc)[QW][RPT]) {
  const float* qs = reinterpret_cast<const float*>(st) + warp * QW * QP;
  const unsigned char* cs = st + WARPS * QW * QP * 4;
  constexpr int CP = c_pitch<int8_t>();
#pragma unroll
  for (int dd = 0; dd < DK; dd += 16) {
    int4 cw[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      cw[j] = *reinterpret_cast<const int4*>(cs + (lane + 32 * j) * CP + dd);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float4 qv[QW];
#pragma unroll
      for (int i = 0; i < QW; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + i * QP + dd + 4 * w);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const uint32_t xf = word(cw[j], w) ^ 0x80808080u;
        const float c0 = widen<0>(xf), c1 = widen<1>(xf);
        const float c2 = widen<2>(xf), c3 = widen<3>(xf);
#pragma unroll
        for (int i = 0; i < QW; ++i) {
          acc[i][j] = fmaf(qv[i].x, c0, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, c1, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, c2, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, c3, acc[i][j]);
        }
      }
    }
  }
}

// Score queries [q0, q0 + 8 QW) against row tiles [t_begin, t_end)
// through the cp.async ring in `smem`; after the last slice of each tile
// call epi(tile, acc) with acc[i][j] = the score of query q0 + QW * warp
// + i and row tile * TR + lane + 32 j. A warp whose queries all lie at or
// past q_end skips the FMAs (its scores are never read).
template <class T, int QW, class Epi>
__device__ __forceinline__ void scan_tiles(unsigned char* smem,
                                           const float* __restrict__ q,
                                           const T* __restrict__ c, int q0,
                                           int q_end, int N, int D,
                                           int t_begin, int t_end, bool vec,
                                           Epi&& epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nd = (D + DK - 1) / DK;
  const int total = t_end > t_begin ? (t_end - t_begin) * nd : 0;
  const bool busy = q0 + warp * QW < q_end;
  auto issue = [&](int s) {
    if (s < total)
      stage_load<T, QW>(smem + (s % STAGES) * stage_bytes<T, QW>(), q, c,
                        q0, q_end, (t_begin + s / nd) * TR, (s % nd) * DK,
                        N, D, vec, tid);
    cp_async_commit();                   // an empty group past the end
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  float acc[QW][RPT];
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();        // slice s has landed (own copies)
    __syncthreads();                    // ... everyone's; s - 1 is free
    issue(s + STAGES - 1);
    const int ds = s % nd;
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < QW; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) acc[i][j] = 0.0f;
    }
    if (busy)
      fma_stage<QW>(smem + (s % STAGES) * stage_bytes<T, QW>(),
                    static_cast<const T*>(nullptr), warp, lane, acc);
    if (ds == nd - 1) epi(t_begin + s / nd, acc);
  }
  cp_async_wait<0>();
}

template <class T, int SLOTS, class Mask>
__global__ void __launch_bounds__(THREADS, 2)
topk_list_kernel(const float* __restrict__ q, const T* __restrict__ c,
                 Mask mask, float* __restrict__ out_s,
                 int* __restrict__ out_i, int q_begin, int q_count, int N,
                 int D, int k, int tiles_per_block, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = q_begin + blockIdx.x * TQ;
  const int q_end = q_begin + q_count;
  const int ntiles = (N + TR - 1) / TR;
  const int t_begin = blockIdx.y * tiles_per_block;
  const int t_end = min(ntiles, t_begin + tiles_per_block);

  // running top-k of each of this warp's queries: entry j lives in lane
  // j % 32, slot j / 32; (-inf, -1) marks an empty entry
  float ls[QPT][SLOTS];
  int li[QPT][SLOTS];
  float thr_s[QPT];                     // entry k-1: the bar to beat
  int thr_i[QPT];
  typename Mask::Qry qry[QPT];
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      ls[t][s] = -CUDART_INF_F;
      li[t][s] = -1;
    }
    thr_s[t] = -CUDART_INF_F;
    thr_i[t] = -1;
    const int gq = q0 + warp * QPT + t;
    qry[t] = mask.query(gq < q_end ? gq : q_begin);
  }

  scan_tiles<T, QPT>(smem, q, c, q0, q_end, N, D, t_begin, t_end, vec,
                     [&](int tile, float (&acc)[QPT][RPT]) {
    const int r0 = tile * TR;
    typename Mask::Row row[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int gr = r0 + lane + 32 * m;
      row[m] = mask.row(gr < N ? gr : 0);
    }
    // fold the tile into each query's running top-k (one warp a query)
#pragma unroll
    for (int t = 0; t < QPT; ++t) {
      if (q0 + warp * QPT + t >= q_end) continue;    // warp-uniform
      float s[RPT];
#pragma unroll
      for (int m = 0; m < RPT; ++m)
        s[m] = (r0 + lane + 32 * m < N && Mask::valid(qry[t], row[m]))
                   ? acc[t][m] : -CUDART_INF_F;
      while (true) {
        // lane-local best: rows rise with m, so ">" keeps the lower row
        float bv = -CUDART_INF_F;
        int bi = 0x7fffffff;
#pragma unroll
        for (int m = 0; m < RPT; ++m)
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
        for (int m = 0; m < RPT; ++m)
          if (r0 + lane + 32 * m == bi) s[m] = -CUDART_INF_F;
      }
    }
  });

#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    const int gq = q0 + warp * QPT + t;
    if (gq >= q_end) continue;
    const size_t base = ((size_t)blockIdx.y * q_count + (gq - q_begin)) * k;
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

// -- the select path ---------------------------------------------------------
// Order key of a valid score: ascending in s, -0 keyed as +0; never 0
// (-inf keys as 0x007fffff), so 0 marks a masked row.
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// (key, row) as one 64-bit value whose ascending order is (key
// descending, row ascending); below 2^63, so it sorts as an int64 too.
__device__ __forceinline__ unsigned long long pack(uint32_t key, int row) {
  return ((unsigned long long)(~key) << 31) | (unsigned)row;
}

template <class T, int QW, class Mask>
__global__ void __launch_bounds__(THREADS, 2)
topk_key_kernel(const float* __restrict__ q, const T* __restrict__ c,
                Mask mask, uint32_t* __restrict__ keys, int q_begin,
                int q_count, int N, int D, int tiles_per_block, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = q_begin + blockIdx.x * WARPS * QW;
  const int q_end = q_begin + q_count;
  const int ntiles = (N + TR - 1) / TR;
  const int t_begin = blockIdx.y * tiles_per_block;
  const int t_end = min(ntiles, t_begin + tiles_per_block);
  scan_tiles<T, QW>(smem, q, c, q0, q_end, N, D, t_begin, t_end, vec,
                    [&](int tile, float (&acc)[QW][RPT]) {
    const int r0 = tile * TR;
    typename Mask::Row row[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int gr = r0 + lane + 32 * m;
      row[m] = mask.row(gr < N ? gr : 0);
    }
#pragma unroll
    for (int t = 0; t < QW; ++t) {
      const int gq = q0 + warp * QW + t;
      if (gq >= q_end) continue;                     // warp-uniform
      const typename Mask::Qry qry = mask.query(gq);  // once a tile
      uint32_t* kq = keys + (size_t)(gq - q_begin) * N;
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int gr = r0 + lane + 32 * m;
        if (gr < N)
          kq[gr] = Mask::valid(qry, row[m]) ? order_key(acc[t][m]) : 0u;
      }
    }
  });
}

// state: 4 words a query: the key prefix found so far (then T), the rank
// still wanted among keys with that prefix (then `need`), the count of
// slots taken by keys above T, unused.

// Histogram of digit `pass` (bits 31 - 8 pass .. 24 - 8 pass) of the keys
// of rows [bx * SEL_ROWS, +SEL_ROWS) of query by that match the prefix.
__global__ void __launch_bounds__(SEL_THREADS)
select_hist_kernel(const uint32_t* __restrict__ keys, int N,
                   const uint32_t* __restrict__ state,
                   uint32_t* __restrict__ hist, int pass) {
  __shared__ uint32_t h[256];
  const int tid = threadIdx.x, lane = tid & 31;
  const int qi = blockIdx.y;
  const int r_begin = blockIdx.x * SEL_ROWS;
  const int r_end = min(N, r_begin + SEL_ROWS);
  h[tid] = 0;
  __syncthreads();
  const int shift = 24 - 8 * pass;
  const uint32_t hi = pass == 0 ? 0u : 0xffffffffu << (32 - 8 * pass);
  const uint32_t prefix = pass == 0 ? 0u : state[4 * qi];
  const uint32_t* kq = keys + (size_t)qi * N;
  for (int base = r_begin; base < r_end; base += SEL_THREADS) {
    const int r = base + tid;
    int dg = -1;
    if (r < r_end) {
      const uint32_t key = kq[r];
      if ((key & hi) == prefix) dg = (int)((key >> shift) & 255u);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (dg >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&h[dg], (uint32_t)__popc(peers));
  }
  __syncthreads();
  if (h[tid]) atomicAdd(&hist[256 * qi + tid], h[tid]);
}

// Per query: the digit whose keys hold the wanted rank, counted from the
// top; extends the prefix, lowers the rank by the keys above that digit,
// and clears the histogram for the next pass.
__global__ void __launch_bounds__(256)
select_digit_kernel(uint32_t* __restrict__ hist, uint32_t* __restrict__ state,
                    int k, int pass) {
  __shared__ uint32_t sfx[257];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  const uint32_t prefix = pass == 0 ? 0u : state[4 * qi];
  const uint32_t want = pass == 0 ? (uint32_t)k : state[4 * qi + 1];
  sfx[tid] = hist[256 * qi + tid];
  hist[256 * qi + tid] = 0;
  if (tid == 0) sfx[256] = 0;
  __syncthreads();
  for (int off = 1; off < 256; off <<= 1) {         // sfx[d] = sum d' >= d
    const uint32_t v = tid + off < 256 ? sfx[tid + off] : 0u;
    __syncthreads();
    sfx[tid] += v;
    __syncthreads();
  }
  if (sfx[tid] >= want && sfx[tid + 1] < want) {
    state[4 * qi] = prefix | ((uint32_t)tid << (24 - 8 * pass));
    state[4 * qi + 1] = want - sfx[tid + 1];
  }
}

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  uint32_t total = 0;
  for (int w = 0; w < SEL_THREADS / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Every (key > T, row) of the block's rows to the query's slots; the
// block's count of keys equal to T to eq[qi][bx].
__global__ void __launch_bounds__(SEL_THREADS)
select_above_kernel(const uint32_t* __restrict__ keys, int N,
                    uint32_t* __restrict__ state,
                    unsigned long long* __restrict__ sel, int k,
                    uint32_t* __restrict__ eq, int nb) {
  __shared__ uint32_t red[SEL_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int qi = blockIdx.y;
  const int r_begin = blockIdx.x * SEL_ROWS;
  const int r_end = min(N, r_begin + SEL_ROWS);
  const uint32_t T = state[4 * qi];
  uint32_t* taken = &state[4 * qi + 2];
  unsigned long long* sq = sel + (size_t)qi * k;
  const uint32_t* kq = keys + (size_t)qi * N;
  uint32_t ties = 0;
  for (int base = r_begin; base < r_end; base += SEL_THREADS) {
    const int r = base + tid;
    const uint32_t key = r < r_end ? kq[r] : 0u;
    const bool above = r < r_end && key > T;
    ties += (r < r_end && key == T) ? 1u : 0u;
    const unsigned b = __ballot_sync(0xffffffffu, above);
    if (b) {
      const int leader = __ffs(b) - 1;
      uint32_t off = 0;
      if (lane == leader) off = atomicAdd(taken, (uint32_t)__popc(b));
      off = __shfl_sync(0xffffffffu, off, leader);
      if (above)
        sq[off + __popc(b & ((1u << lane) - 1u))] = pack(key, r);
    }
  }
  ties = block_sum(ties, red);
  if (tid == 0) eq[(size_t)qi * nb + blockIdx.x] = ties;
}

// The `need` lowest rows whose key equals T, in row order, after the k -
// need slots of the keys above T: block bx starts at the ties of blocks
// [0, bx) and writes while the rank is below `need`.
__global__ void __launch_bounds__(SEL_THREADS)
select_ties_kernel(const uint32_t* __restrict__ keys, int N,
                   const uint32_t* __restrict__ state,
                   unsigned long long* __restrict__ sel, int k,
                   const uint32_t* __restrict__ eq, int nb) {
  __shared__ uint32_t red[SEL_THREADS / 32];
  __shared__ uint32_t wcount[SEL_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = blockIdx.y;
  const uint32_t* eq_q = eq + (size_t)qi * nb;
  if (eq_q[blockIdx.x] == 0) return;                 // block-uniform
  const uint32_t T = state[4 * qi];
  const uint32_t need = state[4 * qi + 1];
  const uint32_t above = (uint32_t)k - need;
  uint32_t before = 0;
  for (int b = tid; b < (int)blockIdx.x; b += SEL_THREADS) before += eq_q[b];
  uint32_t run = block_sum(before, red);
  if (run >= need) return;
  const int r_begin = blockIdx.x * SEL_ROWS;
  const int r_end = min(N, r_begin + SEL_ROWS);
  const uint32_t* kq = keys + (size_t)qi * N;
  unsigned long long* sq = sel + (size_t)qi * k;
  for (int base = r_begin; base < r_end && run < need;
       base += SEL_THREADS) {
    const int r = base + tid;
    const bool tie = r < r_end && kq[r] == T;
    const unsigned b = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) wcount[warp] = (uint32_t)__popc(b);
    __syncthreads();
    uint32_t woff = 0, total = 0;
    for (int w = 0; w < SEL_THREADS / 32; ++w) {
      woff += w < warp ? wcount[w] : 0u;
      total += wcount[w];
    }
    if (tie) {
      const uint32_t rank = run + woff + __popc(b & ((1u << lane) - 1u));
      if (rank < need) sq[above + rank] = pack(T, r);
    }
    __syncthreads();
    run += total;
  }
}

// One block a query: its k packed values in order (sorted here when
// `sort`, else already sorted by the caller) -> (score, row); (-inf, -1)
// for a masked row, row -1 for a -inf score.
__global__ void __launch_bounds__(ORDER_THREADS)
select_order_kernel(const unsigned long long* __restrict__ sel, int k,
                    int sort, float* __restrict__ out_s,
                    int* __restrict__ out_i) {
  extern __shared__ unsigned long long buf[];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  const unsigned long long* sq = sel + (size_t)qi * k;
  if (sort) {
    int p2 = 1;
    while (p2 < k) p2 <<= 1;
    for (int i = tid; i < p2; i += ORDER_THREADS)
      buf[i] = i < k ? sq[i] : ~0ull;
    __syncthreads();
    const int pairs = p2 / 2;
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int p = tid; p < pairs; p += ORDER_THREADS) {
          const int a = (p / stride) * 2 * stride + p % stride;
          const int b = a + stride;
          const bool up = (a & size) == 0;
          const unsigned long long ka = buf[a], kb = buf[b];
          if ((ka > kb) == up) {
            buf[a] = kb;
            buf[b] = ka;
          }
        }
        __syncthreads();
      }
    }
  }
  for (int i = tid; i < k; i += ORDER_THREADS) {
    const unsigned long long p = sort ? buf[i] : sq[i];
    const uint32_t key = ~(uint32_t)(p >> 31);
    const float s = key == 0u ? -CUDART_INF_F : key_score(key);
    out_s[(size_t)qi * k + i] = s;
    out_i[(size_t)qi * k + i] =
        s > -CUDART_INF_F ? (int)(p & 0x7fffffffu) : -1;
  }
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Row blocks of a scan of N rows by Q queries on a card with `sms` SMs:
// about four blocks per SM in all, each given at least one tile.
inline long long grid_x_for(long long N, long long Q, long long sms) {
  const long long ntiles = ceil_div(N > 0 ? N : 1, TR);
  const long long gy = ceil_div(Q > 0 ? Q : 1, TQ);
  long long want = ceil_div(4 * sms, gy);
  if (want > ntiles) want = ntiles;
  if (want < 1) want = 1;
  return ceil_div(ntiles, ceil_div(ntiles, want));
}

// Workspace of a select launch over q_count queries, in this order: the
// k packed slots a query (8 B each; first, so that the caller can sort
// them for k > ORDER_MAX), the (q_count, N) keys, 256 histogram bins and
// 4 state words a query, and a tie count a (query, row block).
struct Work {
  size_t sel, keys, hist, state, eq, bytes;
  long long nb;
};
inline Work work_layout(long long q_count, long long N, long long k) {
  Work w;
  w.nb = ceil_div(N, SEL_ROWS);
  w.sel = 0;
  w.keys = w.sel + (size_t)q_count * k * 8;
  w.hist = w.keys + (size_t)q_count * N * 4;
  w.state = w.hist + (size_t)q_count * 256 * 4;
  w.eq = w.state + (size_t)q_count * 4 * 4;
  w.bytes = w.eq + (size_t)q_count * w.nb * 4;
  return w;
}

inline int order_smem(long long k) {
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  return p2 * 8;
}

// Optional CUDA events around the select path's four steps (score,
// select, gather, order) of the next launches, for timing; off unless
// topk_tile_split_on(1).
struct Split {
  bool on = false;
  cudaEvent_t ev[5] = {};
};
inline Split& split() {
  static Split s;
  return s;
}
inline void split_mark(int i, cudaStream_t st) {
  if (split().on) cudaEventRecord(split().ev[i], st);
}

// Scores to keys: 8 queries a warp when the launch has more than one
// 32-query tile (half the corpus loads a fmaf), else 4 (at Q <= 4 only
// one warp a block has queries to score).
template <class T, int QW, class Mask>
cudaError_t launch_keys(const float* q, const T* c, Mask mask,
                        uint32_t* keys, long long N, long long D,
                        long long grid_x, long long q_begin,
                        long long q_count, bool vec, cudaStream_t st) {
  static bool smem_key[port::kMaxDevices];
  const cudaError_t err = port::set_smem_once(
      smem_key, topk_key_kernel<T, QW, Mask>, scan_smem<T, QW>());
  if (err != cudaSuccess) return err;
  const long long per = ceil_div(ceil_div(N, TR), grid_x);
  topk_key_kernel<T, QW, Mask>
      <<<dim3((unsigned)ceil_div(q_count, WARPS * QW), (unsigned)grid_x),
         THREADS, scan_smem<T, QW>(), st>>>(q, c, mask, keys, (int)q_begin,
                                           (int)q_count, (int)N, (int)D,
                                           (int)per, vec);
  return cudaSuccess;
}

template <class T, class Mask>
int launch_select(const float* q, const T* c, Mask mask, float* out_s,
                  int* out_i, void* work, long long N, long long D,
                  long long k, long long grid_x, long long q_begin,
                  long long q_count, bool vec, cudaStream_t st) {
  static bool smem_order[port::kMaxDevices];
  const Work w = work_layout(q_count, N, k);
  unsigned char* base = static_cast<unsigned char*>(work);
  auto* sel = reinterpret_cast<unsigned long long*>(base + w.sel);
  auto* keys = reinterpret_cast<uint32_t*>(base + w.keys);
  auto* hist = reinterpret_cast<uint32_t*>(base + w.hist);
  auto* state = reinterpret_cast<uint32_t*>(base + w.state);
  auto* eq = reinterpret_cast<uint32_t*>(base + w.eq);
  cudaError_t err = cudaMemsetAsync(hist, 0, w.eq - w.hist, st);
  if (err != cudaSuccess) return (int)err;            // histograms, state
  split_mark(0, st);
  err = q_count > TQ
            ? launch_keys<T, 8>(q, c, mask, keys, N, D, grid_x, q_begin,
                                q_count, vec, st)
            : launch_keys<T, QPT>(q, c, mask, keys, N, D, grid_x, q_begin,
                                  q_count, vec, st);
  if (err != cudaSuccess) return (int)err;
  split_mark(1, st);
  const dim3 rows((unsigned)w.nb, (unsigned)q_count);
  for (int pass = 0; pass < 4; ++pass) {
    select_hist_kernel<<<rows, SEL_THREADS, 0, st>>>(keys, (int)N, state,
                                                     hist, pass);
    select_digit_kernel<<<(unsigned)q_count, 256, 0, st>>>(hist, state,
                                                           (int)k, pass);
  }
  split_mark(2, st);
  select_above_kernel<<<rows, SEL_THREADS, 0, st>>>(
      keys, (int)N, state, sel, (int)k, eq, (int)w.nb);
  select_ties_kernel<<<rows, SEL_THREADS, 0, st>>>(
      keys, (int)N, state, sel, (int)k, eq, (int)w.nb);
  split_mark(3, st);
  if (k <= ORDER_MAX) {
    err = port::set_smem_once(smem_order, select_order_kernel,
                              order_smem(ORDER_MAX));
    if (err != cudaSuccess) return (int)err;
    select_order_kernel<<<(unsigned)q_count, ORDER_THREADS, order_smem(k),
                          st>>>(sel, (int)k, 1, out_s, out_i);
  }
  split_mark(4, st);
  return (int)cudaGetLastError();
}

// One launch over the queries [q_begin, q_begin + q_count) of Q. T is the
// corpus element type: float, or int8_t (scale folded into q). Any
// grid_x >= 1 is correct: row block by scans tiles [by * per, (by + 1) *
// per) and a block past the end writes empty lists.
// k <= KMAX: candidates (grid_x, q_count, k) in out_s / out_i; `work` is
// unused. The list depth is the smallest that holds k: 2 entries a lane
// for k <= 64, 4 for k <= 128.
// k > KMAX: the answers (q_count, k) in out_s / out_i, in `work` of
// topk_tile_work_bytes(q_count, N, k) bytes; for k > ORDER_MAX the k
// packed slots a query are left unsorted at the start of `work`, and
// out_s / out_i unwritten (the caller sorts, then topk_tile_decode).
template <class T, class Mask>
int launch(const float* q, const T* c, Mask mask, float* out_s,
           int* out_i, void* work, long long Q, long long N, long long D,
           long long k, long long grid_x, long long q_begin,
           long long q_count, void* stream) {
  static bool smem_list2[port::kMaxDevices];
  static bool smem_list4[port::kMaxDevices];
  if (k < 1 || k > N || Q < 1 || N < 1 || D < 1 || grid_x < 1 ||
      grid_x > 65535 || q_begin < 0 || q_count < 1 || q_begin + q_count > Q ||
      N > 0x7ffffffeLL || (k > KMAX && (q_count > 65535 || work == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool vec = (D * (long long)sizeof(T)) % 16 == 0 && D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (k > KMAX)
    return launch_select(q, c, mask, out_s, out_i, work, N, D, k, grid_x,
                         q_begin, q_count, vec, st);
  const dim3 grid((unsigned)ceil_div(q_count, TQ), (unsigned)grid_x);
  const long long per = ceil_div(ceil_div(N, TR), grid_x);
  cudaError_t err;
  if (k <= 64) {
    err = port::set_smem_once(smem_list2, topk_list_kernel<T, 2, Mask>,
                              scan_smem<T, QPT>());
    if (err != cudaSuccess) return (int)err;
    topk_list_kernel<T, 2, Mask><<<grid, THREADS, scan_smem<T, QPT>(), st>>>(
        q, c, mask, out_s, out_i, (int)q_begin, (int)q_count, (int)N,
        (int)D, (int)k, (int)per, vec);
  } else {
    err = port::set_smem_once(smem_list4,
                              topk_list_kernel<T, SLOTS_MAX, Mask>,
                              scan_smem<T, QPT>());
    if (err != cudaSuccess) return (int)err;
    topk_list_kernel<T, SLOTS_MAX, Mask>
        <<<grid, THREADS, scan_smem<T, QPT>(), st>>>(
            q, c, mask, out_s, out_i, (int)q_begin, (int)q_count, (int)N,
            (int)D, (int)k, (int)per, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace topk_tile

// Number of row blocks (the leading dim of the list path's candidates)
// that a launch for N rows and Q queries should use.
extern "C" long long topk_tile_grid_x(long long N, long long Q,
                                      long long sms) {
  return topk_tile::grid_x_for(N, Q, sms);
}

// Bytes of the workspace of a select launch (k > 128) over q_count
// queries; 0 for the list path.
extern "C" long long topk_tile_work_bytes(long long q_count, long long N,
                                          long long k) {
  if (k <= topk_tile::KMAX) return 0;
  return (long long)topk_tile::work_layout(q_count, N, k).bytes;
}

// (q_count, k) packed slots, each row of k sorted ascending (as int64) ->
// scores and row ids, (-inf, -1) for a masked row.
extern "C" int topk_tile_decode(const void* sorted, float* out_s, int* out_i,
                                long long q_count, long long k,
                                void* stream) {
  if (q_count < 1 || k < 1) return (int)cudaErrorInvalidValue;
  topk_tile::select_order_kernel<<<(unsigned)q_count,
                                   topk_tile::ORDER_THREADS, 0,
                                   (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(sorted), (int)k, 0, out_s,
      out_i);
  return (int)cudaGetLastError();
}

// Record CUDA events around the select path's steps from now on (on = 1)
// or stop (on = 0).
extern "C" int topk_tile_split_on(int on) {
  topk_tile::Split& sp = topk_tile::split();
  for (int i = 0; on && i < 5; ++i)
    if (sp.ev[i] == nullptr) {
      const cudaError_t err = cudaEventCreate(&sp.ev[i]);
      if (err != cudaSuccess) return (int)err;
    }
  sp.on = on != 0;
  return 0;
}

// ms[0..3]: device time of the last select launch's score, select (four
// histogram and digit passes), gather (above T, then ties) and order
// steps, after waiting for it.
extern "C" int topk_tile_split_ms(float* ms) {
  topk_tile::Split& sp = topk_tile::split();
  cudaError_t err = cudaEventSynchronize(sp.ev[4]);
  for (int i = 0; err == cudaSuccess && i < 4; ++i)
    err = cudaEventElapsedTime(&ms[i], sp.ev[i], sp.ev[i + 1]);
  return (int)err;
}
