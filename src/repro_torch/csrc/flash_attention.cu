// Block-streaming attention forward (online softmax), GQA, causal or not,
// fp32 or bf16 inputs, for sm_90a.
//
// Replaces the TPU kernel of
// src/repro/kernels/flash_attention/flash_attention.py: `_kernel`,
// launched by `flash_attention_fwd`. The same function: for each query
// row, softmax(scale * q . k) over the key columns, times v, where
//   - query head h reads key/value head h / (H / KV) (GQA, no copy);
//   - causal: column c is visible from row r iff r + (Skv - Sq) >= c (the
//     queries are the last Sq positions of the key sequence);
//   - a row with no visible column comes out as 0, not NaN;
//   - logits, the running (m, l, acc) and every sum are fp32 whatever the
//     input type; the output is rounded once to the input type.
// Any Sq and Skv: ragged tiles are masked.
//
// What bounds it on an H100 SXM: the larger of
//   bytes:      B*H*Sq*D (q) + 2*B*KV*Skv*D (k, v) + B*H*Sq*D (out), in
//               the input type, over 3.35 TB/s;
//   operations: 4*B*H*Sq*Skv*D FLOPs (about half of that under the
//               causal mask), over 989 TFLOP/s in bf16 on the tensor
//               cores; in fp32, 3 x those FLOPs over 495 TFLOP/s of TF32
//               (the 3xTF32 route below: the card's fastest way to
//               fp32-accurate products; its 67 TFLOP/s of fp32 FMA is
//               2.5x slower).
// Three bodies:
//
// bf16, D in {64, 128}: tensor cores (`fa_wgmma_kernel`). A block owns
// BM = 128 query rows of one (b, h) and has three warpgroups:
//   - a producer: one thread loads the block's q once and then keeps a
//     ring of STAGES (K, V) tiles of BN = 128 rows full with TMA copies
//     (128-byte swizzle, 64 columns a box; rows past Skv or Sq arrive as
//     zeros), each stage completing on a `full` mbarrier and released by
//     the consumers on an `empty` one;
//   - two consumers of 64 query rows each. Per tile: S = q k^T on wgmma
//     (bf16 in, fp32 accumulate, q and K from shared memory); the scale
//     times log2(e) applied to the fp32 logits (not folded into a bf16
//     q, which would round q); the mask where the tile crosses Skv or the
//     causal diagonal; the online softmax in registers on the accumulator
//     fragment (exp2f; each thread keeps its part of l, summed over the
//     row's four threads at the end); then O += P V on wgmma with P from
//     registers and V read MN-major (the transpose bit: no transposed
//     copy). P is split as P_hi + P_lo, two bf16 values whose sum is P to
//     ~2^-17, and both are multiplied into O against the same V tile:
//     P rounded once to bf16 (2^-9 a term) would move outputs of N(0, 1)
//     inputs by more than the one output rounding step the port allows.
//     Cost: 1.5x the tensor FLOPs of a single rounding.
// Under the causal mask a block stops at the last tile any of its rows
// sees; blocks are numbered heaviest (last query rows) first, so the
// longest blocks start first and the short ones fill the tail.
//
// fp32, D in {32, 64}: tensor cores in 3xTF32 (`fa_tf32_kernel`; MiniLM's
// and BERT4Rec's D 32). One TF32 product keeps 10 mantissa bits (~2^-11
// a term) and does not hold the fp32 checks. Each operand x is split as
// x_hi = tf32(x) and x_lo = tf32(x - x_hi) (round to nearest, in integer
// operations: hopper.cuh), and each product a b is a_lo b_hi + a_hi b_lo
// + a_hi b_hi on `wgmma` .tf32 (m64nNk8, fp32 accumulate): within ~2^-20
// of |a b|. Bound: 3 x the FLOPs at 495 TFLOP/s, or the bytes. Design:
//   - wgmma reads .tf32 operands K-major only (the transpose bit is for
//     16-bit types), and O += P V needs V with its keys contiguous. So a
//     producer warpgroup splits every operand and lays it out: q's 128
//     rows (hi, lo) into one of QSLOTS slots, each (K, V) tile of BN rows
//     (64 at D 32, 32 at D 64) as K_hi, K_lo (K-major along D) and
//     V^T_hi, V^T_lo (K-major along the keys) into a ring of STAGES
//     stages, all in the 128-byte swizzle, each handed over by
//     fence.proxy.async and an arrive on an mbarrier. An fp32 row at D 32
//     is 128 bytes: one swizzle row. Its input comes through a ring of RAW
//     16 KB units copied by cp.async (rows past Sq or Skv as zeros),
//     RAW units ahead: a thread reads back only its own copies, so
//     cp.async.wait_group is all the synchronisation it needs, and the
//     64 KB in flight hide the memory's latency (a TMA copy would land the
//     raw tile for the same threads to read back). Its lanes walk rows, so
//     the swizzled 16-byte stores and the transposed 4-byte ones hit 32
//     banks a phase.
//   - two consumer warpgroups of 64 query rows: S = q k^T from shared
//     memory, the bf16 body's online softmax (base 2, scale * log2(e) on
//     the fp32 logits), then P enters O += P V from the S accumulator
//     fragment as register A operands (hi and lo), whose k order within
//     each 8 keys is 0, 2, 4, 6, 1, 3, 5, 7 (hopper.cuh): the producer
//     writes V^T's columns in that order, so no shuffle is needed.
//   - persistent: one block a streaming multiprocessor walks the query
//     blocks (heaviest first, strided by the grid), so the producer fills
//     the next block's q slot and tiles while the consumers finish the
//     last one. A row's output is the same whichever block computes it.
//
// bf16 at D = 32 (a 64-byte row is below the 128-byte swizzle the bf16
// tensor-core path is laid out for) and fp32 at D = 128 (two slots of
// q's halves would not fit the shared memory beside the ring): the
// CUDA-core body (`flash_attention_kernel`, the port's first design).
// Grid (ceil(Sq / BQ), H, B), THREADS threads. A block owns BQ query rows
// of one (b, h): their scaled q in shared memory (scale folded into q in
// fp32, as the Pallas kernel does), the running max m and sum l of each
// row and its D-wide accumulator in registers. It streams the key/value
// rows in BK-row tiles through shared memory (widened to fp32 as staged)
// and, per tile,
//   1. scores: thread (ty, tx) owns rows ty*RPT.. and columns tx + 16*j,
//      each score one ascending-d fmaf chain;
//   2. masks, and updates (m, l, acc) with the tile's row max (a 16-lane
//      butterfly; every lane of a row gets the same bits);
//   3. writes p = exp(s - m) to shared memory and adds p . v to its acc
//      columns tx + 16*dd.
//
// Any batch: the entry launches batches in slices of at most 65,535 (the
// CUDA-core body's grid z), offsetting each tensor; a row's output does
// not depend on its slice or on the other rows.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so no -lcuda
#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 32;                  // key/value rows per tile
constexpr int THREADS = 256;
constexpr int TX = 16;                  // threads along columns
constexpr int TY = THREADS / TX;        // threads along rows (16)
constexpr int RPT = BQ / TY;            // rows per thread (4)
constexpr int CPT = BK / TX;            // score columns per thread (2)

using port::from_f;
using port::to_f;

template <int D>
struct Smem {
  float qs[BQ][D + 1];                  // scaled queries
  float ks[BK][D + 1];                  // key tile
  float vs[BK][D];                      // value tile
  float ps[BQ][BK + 1];                 // probabilities of the tile
};

template <class T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int KV, int Sq,
                       int Skv, bool causal, float scale) {
  constexpr int DPT = D / TX;           // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Skv - Sq;
  const T* qb = q + ((size_t)(b * H + h) * Sq) * D;
  const T* kb = k + ((size_t)(b * KV + kvh) * Skv) * D;
  const T* vb = v + ((size_t)(b * KV + kvh) * Skv) * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    sm.qs[r][d] = q0 + r < Sq ? to_f(qb[(size_t)(q0 + r) * D + d]) * scale
                              : 0.0f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.0f;
  }

  // columns any row of this block can see
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, q0 + BQ + q_offset));

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();                    // qs staged; last tile consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool in = kv0 + r < Skv;
      const size_t off = (size_t)(kv0 + r) * D + d;
      sm.ks[r][d] = in ? to_f(kb[off]) : 0.0f;
      sm.vs[r][d] = in ? to_f(vb[off]) : 0.0f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sm.qs[ty * RPT + i][d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sm.ks[tx + TX * j][d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = kv0 + tx + TX * j;
        if (col >= Skv || (causal && col > row + q_offset))
          s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p =
            s[i][j] == -CUDART_INF_F ? 0.0f : expf(s[i][j] - m_safe);
        sm.ps[ty * RPT + i][tx + TX * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = m[i] == -CUDART_INF_F ? 0.0f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sm.ps[ty * RPT + i][j];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float vv = sm.vs[j][tx + TX * dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][dd] = fmaf(pv[i], vv, acc[i][dd]);
      }
    }
  }

  T* ob = o + ((size_t)(b * H + h) * Sq) * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= Sq) continue;
    const float den = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      ob[(size_t)row * D + tx + TX * dd] = from_f<T>(acc[i][dd] / den);
    // row logsumexp of the scaled logits (natural log; -inf for a row
    // with no visible key), for the backward
    if (lse != nullptr && tx == 0)
      lse[(size_t)(b * H + h) * Sq + row] =
          l[i] == 0.0f ? -CUDART_INF_F : m[i] + logf(l[i]);
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long B, long long H, long long KV, long long Sq,
           long long Skv, bool causal, float scale, cudaStream_t st) {
  const int smem = (int)sizeof(Smem<D>);
  static bool attr_set[port::kMaxDevices] = {};
  const cudaError_t err =
      port::set_smem_once(attr_set, flash_attention_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, (int)H, (int)KV,
      (int)Sq, (int)Skv, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;                 // query rows a block (2 x 64)
constexpr int BN = 128;                 // key/value rows a tile
constexpr int STAGES = 2;               // (K, V) tiles in flight
constexpr int THREADS = 384;            // producer + 2 consumer warpgroups
constexpr int BOX = 64;                 // bf16 columns of one swizzled box

template <int D>
struct Layout {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;       // one K or V tile
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

using namespace hopper;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int B, int H, int KV, int Sq, int Skv, int nm, bool causal,
                float scale_log2) {
  using L = Layout<D>;
  constexpr int NB = D / BOX;           // swizzled boxes across D
  constexpr int NO = D / 2;             // O accumulator registers a thread
  constexpr int NS = BN / 2;            // S accumulator registers a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = s_q + L::Q_BYTES;
  const uint32_t s_v = s_k + STAGES * L::KV_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + STAGES]);   // + 8 * stage

  // heaviest query block first: block index -> (m block, b, h)
  const int bh = blockIdx.x % (B * H);
  const int mb = nm - 1 - (int)(blockIdx.x / (B * H));
  const int h = bh % H;
  const int b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = mb * BM;
  const int q_offset = Skv - Sq;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, q0 + BM + q_offset));
  const int ntiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread issues every copy ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int x = 0; x < NB; ++x)
        tma_load_3d(s_q + x * BM * 128, &tq, bar_q, x * BOX, q0, b * H + h);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) + 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::KV_BYTES);
        const uint32_t dk = s_k + s * L::KV_BYTES;
        const uint32_t dv = s_v + s * L::KV_BYTES;
        for (int x = 0; x < NB; ++x) {
          tma_load_3d(dk + x * BN * 128, &tk, bar_full + 8 * s, x * BOX,
                      t * BN, b * KV + kvh);
          tma_load_3d(dv + x * BN * 128, &tv, bar_full + 8 * s, x * BOX,
                      t * BN, b * KV + kvh);
        }
      }
    }
    return;
  }

  // -- consumers: 64 query rows each -----------------------------------------
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int quad = lane % 4;
  const int r_lo = q0 + cw * 64 + (t128 / 32) * 16 + lane / 4;  // and + 8
  const int wg_row0 = q0 + cw * 64;

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.0f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows r_lo, r_lo + 8
  float l0 = 0.0f, l1 = 0.0f;                    // this thread's part

  mbar_wait(bar_q, 0);
  const uint32_t qa = s_q + cw * 64 * 128;       // this warpgroup's rows

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t kt = s_k + s * L::KV_BYTES;
    const uint32_t vt = s_v + s * L::KV_BYTES;

    // S = q k^T, 64 x BN fp32
    float sacc[NS];
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns of 64
      wgmma_ss_n128(sacc,
                    desc_sw128(qa + (kk / 4) * BM * 128 + off, 16, 1024),
                    desc_sw128(kt + (kk / 4) * BN * 128 + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // scale, mask, online softmax (base 2)
    const int kv0 = t * BN;
    const bool mask = kv0 + BN > Skv ||
                      (causal && kv0 + BN - 1 > wg_row0 + q_offset);
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x0 = sacc[4 * j + c] * scale_log2;
        float x1 = sacc[4 * j + 2 + c] * scale_log2;
        if (mask) {
          const int col = kv0 + 8 * j + 2 * quad + c;
          if (col >= Skv || (causal && col > r_lo + q_offset))
            x0 = -CUDART_INF_F;
          if (col >= Skv || (causal && col > r_lo + 8 + q_offset))
            x1 = -CUDART_INF_F;
        }
        sacc[4 * j + c] = x0;
        sacc[4 * j + 2 + c] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 == -CUDART_INF_F ? 0.0f : mn0;
    const float ms1 = mn1 == -CUDART_INF_F ? 0.0f : mn1;
    const float alpha0 = exp2f(m0 - ms0), alpha1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    uint32_t phi[BN / 16][4], plo[BN / 16][4];
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p00 = exp2f(sacc[4 * j + 0] - ms0);
      const float p01 = exp2f(sacc[4 * j + 1] - ms0);
      const float p10 = exp2f(sacc[4 * j + 2] - ms1);
      const float p11 = exp2f(sacc[4 * j + 3] - ms1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      // columns 8j.. of the tile are k rows 8 (j % 2).. of k step j / 2
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(p00, p01);
      const __nv_bfloat162 h1 = __floats2bfloat162_rn(p10, p11);
      const __nv_bfloat162 r0 = __floats2bfloat162_rn(
          p00 - __low2float(h0), p01 - __high2float(h0));
      const __nv_bfloat162 r1 = __floats2bfloat162_rn(
          p10 - __low2float(h1), p11 - __high2float(h1));
      const int kk = j / 2, hi = (j % 2) * 2;
      phi[kk][hi + 0] = *reinterpret_cast<const uint32_t*>(&h0);
      phi[kk][hi + 1] = *reinterpret_cast<const uint32_t*>(&h1);
      plo[kk][hi + 0] = *reinterpret_cast<const uint32_t*>(&r0);
      plo[kk][hi + 1] = *reinterpret_cast<const uint32_t*>(&r1);
    }
    l0 = alpha0 * l0 + ps0;
    l1 = alpha1 * l1 + ps1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      oacc[4 * j + 0] *= alpha0;
      oacc[4 * j + 1] *= alpha0;
      oacc[4 * j + 2] *= alpha1;
      oacc[4 * j + 3] *= alpha1;
    }

    // O += (P_hi + P_lo) V
    fence_regs(oacc);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = desc_sw128(vt + kk * 16 * 128, BN * 128, 1024);
      if constexpr (D == 128) {
        wgmma_rs_n128(oacc, phi[kk], dv);
        wgmma_rs_n128(oacc, plo[kk], dv);
      } else {
        wgmma_rs_n64(oacc, phi[kk], dv);
        wgmma_rs_n64(oacc, plo[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // the row's four threads hold parts of l
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
  if (lse != nullptr && quad == 0) {
    // natural-log row logsumexp: m is in log2 units of the scaled logits
    constexpr float LN2 = 0.6931471805599453f;
    float* lb = lse + (size_t)(b * H + h) * Sq;
    if (r_lo < Sq)
      lb[r_lo] = l0 == 0.0f ? -CUDART_INF_F : (m0 + log2f(l0)) * LN2;
    if (r_lo + 8 < Sq)
      lb[r_lo + 8] = l1 == 0.0f ? -CUDART_INF_F : (m1 + log2f(l1)) * LN2;
  }
  __nv_bfloat16* ob = o + (size_t)(b * H + h) * Sq * D;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + 2 * quad;
    if (r_lo < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r_lo * D + col) =
          __floats2bfloat162_rn(oacc[4 * j + 0] * inv0,
                                oacc[4 * j + 1] * inv0);
    if (r_lo + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(r_lo + 8) * D + col) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv1,
                                oacc[4 * j + 3] * inv1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Makes the current device's primary context current on the calling
// thread, which cuTensorMapEncodeTiled needs, once a thread. A thread that
// PyTorch starts (autograd's device thread) may not have it yet: PyTorch
// calls cudaSetDevice only when the device index changes, and the other
// runtime calls a launch makes here need no context. Once bound, a thread
// keeps a context: a later change of device makes that device's current.
cudaError_t bind_context() {
  thread_local bool bound = false;
  if (bound) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  bound = err == cudaSuccess;
  return err;
}

// (rows, D) bf16 matrices, `mats` of them back to back, read in boxes of
// (box_rows, 64) with the 128-byte swizzle; rows past `rows` read as 0.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
              long long D, long long rows, long long mats, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)(D * 2 * rows)};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long B, long long H, long long KV, long long Sq,
           long long Skv, bool causal, float scale, cudaStream_t st) {
  const int smem = Layout<D>::SMEM;
  static bool attr_set[port::kMaxDevices] = {};
  const cudaError_t err =
      port::set_smem_once(attr_set, fa_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return (int)bound;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, D, Sq, B * H, BM) ||
      !make_map(enc, &tk, k, D, Skv, B * KV, BN) ||
      !make_map(enc, &tv, v, D, Skv, B * KV, BN))
    return (int)cudaErrorInvalidValue;
  const long long nm = (Sq + BM - 1) / BM;
  const long long blocks = nm * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fa_wgmma_kernel<D><<<(unsigned)blocks, THREADS, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, (int)B, (int)H,
      (int)KV, (int)Sq, (int)Skv, (int)nm, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 on the tensor cores: 3xTF32
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace hopper;

constexpr int BM = 128;                 // query rows a block (2 x 64)
constexpr int THREADS = 384;            // producer + 2 consumer warpgroups
constexpr int QSLOTS = 2;               // q blocks in flight
constexpr int PRODUCER_REGS = 104;      // 128 x 104 + 256 x 192 <= 65,536
constexpr int CONSUMER_REGS = 192;
constexpr float LOG2E = 1.4426950408889634f;

// The slot of a tile's row i (a key, or a query in the backward) in a
// K-major operand that a register A operand taken from an accumulator
// fragment multiplies: within each 8, k order 0, 2, 4, 6, 1, 3, 5, 7
// (hopper.cuh, wgmma_tf32_rs_*).
__device__ __forceinline__ int k_slot(int i) {
  return (i & ~7) | ((i & 1) << 2) | ((i >> 1) & 3);
}

__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// R rows of a row-major (rows, D) fp32 matrix as the 128 threads of a
// producer warpgroup hold them: float4 f = p + 128 j of thread p is row
// f % R, columns 4 (f / R) on (a warp's lanes on 32 rows); rows past the
// matrix are 0. `store` writes them as the hi and lo tf32 halves of a
// K-major operand along D (rows of 128 bytes, boxes of 32 columns `box`
// bytes apart, the 128-byte swizzle); `store_t` transposed, K-major along
// the R rows (D rows of R / 32 boxes D * 128 bytes apart, row i at column
// k_slot(i)). Either way the 8 lanes of a 16-byte store phase, and the 32
// of a 4-byte one, hit distinct banks.
template <int D, int R>
struct Rows {
  static constexpr int C4 = D / 4;      // float4 a row
  static constexpr int NF = R * C4 / 128;
  static_assert(NF * 128 == R * C4 && R % 32 == 0, "whole warps a row");
  float4 x[NF];

  __device__ __forceinline__ void load(const float* src, int r0, int rows,
                                       int p) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = p + 128 * j, r = r0 + f % R;
      x[j] = r < rows ? __ldg(reinterpret_cast<const float4*>(
                                  src + (size_t)r * D) + f / R)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // The same rows copied to shared memory by cp.async instead (zeros past
  // the matrix), float4 f of thread p at `dst` + 16 (128 j + p); `read`
  // takes them back into this thread's registers once its copies landed.
  __device__ __forceinline__ static void copy(uint32_t dst, const float* src,
                                              int r0, int rows, int p) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = p + 128 * j, r = r0 + f % R;
      const bool in = r < rows;
      cp_async16(dst + (128 * j + p) * 16,
                 src + (in ? (size_t)r * D + 4 * (f / R) : 0), in ? 16 : 0);
    }
  }

  __device__ __forceinline__ void read(uint32_t src, int p) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x[j].x), "=f"(x[j].y), "=f"(x[j].z), "=f"(x[j].w)
                   : "r"(src + (128 * j + p) * 16)
                   : "memory");
  }

  __device__ __forceinline__ void store(uint32_t hi, uint32_t lo, int p,
                                        uint32_t box = R * 128,
                                        int row0 = 0) const {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = p + 128 * j, r = row0 + f % R, c4 = f / R;
      const uint32_t off =
          (c4 / 8) * box + r * 128 + (((c4 % 8) ^ (r % 8)) << 4);
      uint32_t h[4], l[4];
      split_tf32(x[j].x, h[0], l[0]);
      split_tf32(x[j].y, h[1], l[1]);
      split_tf32(x[j].z, h[2], l[2]);
      split_tf32(x[j].w, h[3], l[3]);
      sts128(hi + off, h[0], h[1], h[2], h[3]);
      sts128(lo + off, l[0], l[1], l[2], l[3]);
    }
  }

  // `store` and `store_t` at once, each value split once.
  __device__ __forceinline__ void store_both(uint32_t hi, uint32_t lo,
                                             uint32_t thi, uint32_t tlo,
                                             int p) const {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = p + 128 * j, r = f % R, c4 = f / R, s = k_slot(r);
      const uint32_t off = (c4 / 8) * (R * 128) + r * 128 +
                           (((c4 % 8) ^ (r % 8)) << 4);
      const uint32_t col = (s / 32) * (D * 128) + (s % 4) * 4;
      const int ch = (s % 32) / 4;
      uint32_t h[4], l[4];
      split_tf32(x[j].x, h[0], l[0]);
      split_tf32(x[j].y, h[1], l[1]);
      split_tf32(x[j].z, h[2], l[2]);
      split_tf32(x[j].w, h[3], l[3]);
      sts128(hi + off, h[0], h[1], h[2], h[3]);
      sts128(lo + off, l[0], l[1], l[2], l[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * c4 + i;
        const uint32_t toff = col + d * 128 + ((ch ^ (d % 8)) << 4);
        sts32(thi + toff, h[i]);
        sts32(tlo + toff, l[i]);
      }
    }
  }

  __device__ __forceinline__ void store_t(uint32_t hi, uint32_t lo,
                                          int p) const {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = p + 128 * j, s = k_slot(f % R), c4 = f / R;
      const uint32_t col = (s / 32) * (D * 128) + (s % 4) * 4;
      const int ch = (s % 32) / 4;
      const float e[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * c4 + i;
        const uint32_t off = col + d * 128 + ((ch ^ (d % 8)) << 4);
        uint32_t h, l;
        split_tf32(e[i], h, l);
        sts32(hi + off, h);
        sts32(lo + off, l);
      }
    }
  }
};

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  if constexpr (N == 32)
    wgmma_tf32_rs_n32(d, a, b, accumulate);
  else
    wgmma_tf32_rs_n64(d, a, b, accumulate);
}

// d (64 x N) = or += (a_hi + a_lo)(b_hi + b_lo) without a_lo b_lo, the
// small terms first; A from registers, B at the hi and lo addresses.
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&ahi)[4],
                                        const uint32_t (&alo)[4],
                                        uint32_t bhi, uint32_t blo,
                                        int accumulate) {
  mma_rs<N>(d, alo, kdesc(bhi), accumulate);
  mma_rs<N>(d, ahi, kdesc(blo), 1);
  mma_rs<N>(d, ahi, kdesc(bhi), 1);
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int accumulate) {
  if constexpr (N == 32)
    wgmma_tf32_ss_n32(d, a, b, accumulate);
  else
    wgmma_tf32_ss_n64(d, a, b, accumulate);
}

// The same with A from shared memory.
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint32_t ahi,
                                        uint32_t alo, uint32_t bhi,
                                        uint32_t blo, int accumulate) {
  mma_ss<N>(d, kdesc(alo), kdesc(bhi), accumulate);
  mma_ss<N>(d, kdesc(ahi), kdesc(blo), 1);
  mma_ss<N>(d, kdesc(ahi), kdesc(bhi), 1);
}

// The register A operands of the K columns of a 64 x K accumulator
// fragment x (k step j: columns 8j..8j+7, in k_slot order), hi and lo.
template <int K>
__device__ __forceinline__ void split_frag(const float (&x)[K / 2],
                                           uint32_t (&hi)[K / 8][4],
                                           uint32_t (&lo)[K / 8][4]) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    split_tf32(x[4 * j + 0], hi[j][0], lo[j][0]);   // (r, 2t)
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);   // (r + 8, 2t)
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);   // (r, 2t + 1)
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);   // (r + 8, 2t + 1)
  }
}

// The producer works in units of two U-row blocks (8 KB each): q's 128
// rows in NQ units, then each key tile's K and V rows as one. A ring of
// RAW units in flight by cp.async (64 KB at D 32) feeds it; each unit is
// split into the q slot or a stage of the converted ring.
template <int D>
struct FwdLayout {
  static constexpr int U = 2048 / D;             // rows a producer block
  static constexpr int BN = U;                   // key rows a tile
  static constexpr int NQ = BM / (2 * U);        // units of q's 128 rows
  static constexpr int Q_HALF = BM * D * 4;      // q hi or lo, 128 rows
  static constexpr int HALF = BN * D * 4;        // K hi, K lo, V^T hi or lo
  static constexpr int STAGE = 4 * HALF;
  static constexpr int STAGES = D == 32 ? 3 : 2;
  static constexpr int RAW = D == 32 ? 4 : 2;    // units in flight
  static constexpr int RAW_UNIT = 2 * U * D * 4;
  static constexpr int SMEM = QSLOTS * 2 * Q_HALF + STAGES * STAGE +
                              RAW * RAW_UNIT + 1024;
};

// A query block of the walk: block index -> (m block, b, h), heaviest
// (last query rows) first, and the key tiles its rows see.
struct Item {
  int b, h, kvh, q0, ntiles;
  __device__ __forceinline__ Item(int i, int B, int H, int KV, int Sq,
                                  int Skv, int nm, bool causal, int bn) {
    const int bh = i % (B * H);
    h = bh % H;
    b = bh / H;
    kvh = h / (H / KV);
    q0 = (nm - 1 - i / (B * H)) * BM;
    int kv_end = Skv;
    if (causal) kv_end = min(Skv, max(0, q0 + BM + Skv - Sq));
    ntiles = (kv_end + bn - 1) / bn;
  }
};

// Persistent: a block a streaming multiprocessor walks the query blocks
// i = blockIdx.x, + gridDim.x, ... The producer runs ahead across them (q
// of the next block into the other of QSLOTS slots, its tiles into the
// ring) while the consumers finish the last one.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int B, int H, int KV, int Sq,
               int Skv, int nm, bool causal, float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int BN = L::BN, U = L::U, NQ = L::NQ, STAGES = L::STAGES;
  constexpr int KS = D / 8;             // k steps over D
  constexpr int NO = D / 2;             // O accumulator registers a thread
  constexpr int NS = BN / 2;            // S accumulator registers a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * QSLOTS + 2 * STAGES];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // + slot
  const uint32_t ring = s_q + QSLOTS * 2 * L::Q_HALF;          // + stage
  const uint32_t raw = ring + STAGES * L::STAGE;               // + unit
  const uint32_t bar_qfull = smem_u32(&bars[0]);               // + 8 * slot
  const uint32_t bar_qempty = smem_u32(&bars[QSLOTS]);
  const uint32_t bar_full = smem_u32(&bars[2 * QSLOTS]);       // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[2 * QSLOTS + STAGES]);
  const int items = nm * B * H;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QSLOTS; ++s) {
      mbar_init(bar_qfull + 8 * s, 128);  // one arrival a producer thread
      mbar_init(bar_qempty + 8 * s, 8);   // one arrival a consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: q of each query block, then its (K, V) tiles, a unit at
    //    a time; the copies run RAW units ahead
    setmaxnreg_dec<PRODUCER_REGS>();
    const int p = threadIdx.x;
    if ((int)blockIdx.x >= items) return;
    auto item = [&](int i) {
      return Item(i, B, H, KV, Sq, Skv, nm, causal, BN);
    };
    int ci = blockIdx.x, cw = 0;        // the next unit to copy
    Item cit = item(ci);
    auto copy_next = [&](int slot) {
      if (ci < items) {
        const uint32_t dst = raw + slot * L::RAW_UNIT;
        if (cw < NQ) {
          const float* src = q + (size_t)(cit.b * H + cit.h) * Sq * D;
          const int r0 = cit.q0 + 2 * U * cw;
          Rows<D, U>::copy(dst, src, r0, Sq, p);
          Rows<D, U>::copy(dst + L::RAW_UNIT / 2, src, r0 + U, Sq, p);
        } else {
          const size_t base = (size_t)(cit.b * KV + cit.kvh) * Skv * D;
          const int r0 = (cw - NQ) * BN;
          Rows<D, U>::copy(dst, k + base, r0, Skv, p);
          Rows<D, U>::copy(dst + L::RAW_UNIT / 2, v + base, r0, Skv, p);
        }
        if (++cw == NQ + cit.ntiles) {
          cw = 0;
          ci += gridDim.x;
          if (ci < items) cit = item(ci);
        }
      }
      cp_async_commit();                // an empty group past the end
    };
#pragma unroll 1
    for (int a = 0; a < L::RAW; ++a) copy_next(a);
    Item it = item(blockIdx.x);
    int w = 0, n = 0, t = 0;            // unit of the item, items, tiles
#pragma unroll 1
    for (int i = blockIdx.x, u = 0; i < items; ++u) {
      const int slot = u % L::RAW;
      cp_async_wait<L::RAW - 1>();      // this thread's copies of unit u
      Rows<D, U> x, y;
      x.read(raw + slot * L::RAW_UNIT, p);
      y.read(raw + slot * L::RAW_UNIT + L::RAW_UNIT / 2, p);
      if (w < NQ) {
        const int qs = n % QSLOTS;
        if (w == 0 && n >= QSLOTS)
          mbar_wait(bar_qempty + 8 * qs, ((n / QSLOTS) + 1) & 1);
        const uint32_t hi = s_q + qs * 2 * L::Q_HALF;
        x.store(hi, hi + L::Q_HALF, p, BM * 128, 2 * U * w);
        y.store(hi, hi + L::Q_HALF, p, BM * 128, 2 * U * w + U);
        if (w == NQ - 1) {
          fence_proxy_async();
          mbar_arrive(bar_qfull + 8 * qs);
        }
      } else {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) + 1) & 1);
        const uint32_t st = ring + s * L::STAGE;
        x.store(st, st + L::HALF, p);
        y.store_t(st + 2 * L::HALF, st + 3 * L::HALF, p);
        fence_proxy_async();
        mbar_arrive(bar_full + 8 * s);
        ++t;
      }
      copy_next(slot);                  // x and y are read: reuse the slot
      if (++w == NQ + it.ntiles) {
        w = 0;
        ++n;
        i += gridDim.x;
        if (i < items) it = item(i);
      }
    }
    return;
  }

  // -- consumers: 64 query rows each of every query block of the walk ------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int quad = lane % 4;
  const int q_offset = Skv - Sq;
  int t = 0;                            // tiles consumed
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const Item it(i, B, H, KV, Sq, Skv, nm, causal, BN);
    const int wg_row0 = it.q0 + cw * 64;
    const int r_lo = wg_row0 + (t128 / 32) * 16 + lane / 4;  // and + 8
    const int slot = n % QSLOTS;
    const uint32_t qhi = s_q + slot * 2 * L::Q_HALF + cw * 64 * 128;
    const uint32_t qlo = qhi + L::Q_HALF;
    mbar_wait(bar_qfull + 8 * slot, (n / QSLOTS) & 1);

    float oacc[NO];
#pragma unroll
    for (int x = 0; x < NO; ++x) oacc[x] = 0.0f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows r_lo, r_lo + 8
    float l0 = 0.0f, l1 = 0.0f;                    // this thread's part

    for (int j0 = 0; j0 < it.ntiles; ++j0, ++t) {
      const int s = t % STAGES;
      mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
      const uint32_t st = ring + s * L::STAGE;

      // S = q k^T, 64 x BN fp32, three tf32 products a k step
      float sacc[NS];
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t a = (kk / 4) * (BM * 128) + (kk % 4) * 32;
        const uint32_t off = (kk / 4) * (BN * 128) + (kk % 4) * 32;
        mma3_ss<BN>(sacc, qhi + a, qlo + a, st + off, st + L::HALF + off,
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // scale, mask, online softmax (base 2)
      const int kv0 = j0 * BN;
      const bool mask = kv0 + BN > Skv ||
                        (causal && kv0 + BN - 1 > wg_row0 + q_offset);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x0 = sacc[4 * j + c] * scale_log2;
          float x1 = sacc[4 * j + 2 + c] * scale_log2;
          if (mask) {
            const int col = kv0 + 8 * j + 2 * quad + c;
            if (col >= Skv || (causal && col > r_lo + q_offset))
              x0 = -CUDART_INF_F;
            if (col >= Skv || (causal && col > r_lo + 8 + q_offset))
              x1 = -CUDART_INF_F;
          }
          sacc[4 * j + c] = x0;
          sacc[4 * j + 2 + c] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = mn0 == -CUDART_INF_F ? 0.0f : mn0;
      const float ms1 = mn1 == -CUDART_INF_F ? 0.0f : mn1;
      const float alpha0 = exp2f(m0 - ms0), alpha1 = exp2f(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sacc[4 * j + 0] = exp2f(sacc[4 * j + 0] - ms0);
        sacc[4 * j + 1] = exp2f(sacc[4 * j + 1] - ms0);
        sacc[4 * j + 2] = exp2f(sacc[4 * j + 2] - ms1);
        sacc[4 * j + 3] = exp2f(sacc[4 * j + 3] - ms1);
        ps0 += sacc[4 * j + 0] + sacc[4 * j + 1];
        ps1 += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
      uint32_t phi[BN / 8][4], plo[BN / 8][4];
      split_frag<BN>(sacc, phi, plo);
      l0 = alpha0 * l0 + ps0;
      l1 = alpha1 * l1 + ps1;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        oacc[4 * j + 0] *= alpha0;
        oacc[4 * j + 1] *= alpha0;
        oacc[4 * j + 2] *= alpha1;
        oacc[4 * j + 3] *= alpha1;
      }

      // O += (P_hi + P_lo)(V_hi + V_lo), V^T read K-major along the keys
      fence_regs(oacc);
      fence_regs(phi);
      fence_regs(plo);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t off = (j / 4) * (D * 128) + (j % 4) * 32;
        mma3_rs<D>(oacc, phi[j], plo[j], st + 2 * L::HALF + off,
                   st + 3 * L::HALF + off, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_qempty + 8 * slot);

    // the row's four threads hold parts of l
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
    const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
    if (lse != nullptr && quad == 0) {
      // natural-log row logsumexp: m is in log2 units of the scaled logits
      constexpr float LN2 = 0.6931471805599453f;
      float* lb = lse + (size_t)(it.b * H + it.h) * Sq;
      if (r_lo < Sq)
        lb[r_lo] = l0 == 0.0f ? -CUDART_INF_F : (m0 + log2f(l0)) * LN2;
      if (r_lo + 8 < Sq)
        lb[r_lo + 8] = l1 == 0.0f ? -CUDART_INF_F : (m1 + log2f(l1)) * LN2;
    }
    float* ob = o + (size_t)(it.b * H + it.h) * Sq * D;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + 2 * quad;
      if (r_lo < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)r_lo * D + col) =
            make_float2(oacc[4 * j + 0] * inv0, oacc[4 * j + 1] * inv0);
      if (r_lo + 8 < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)(r_lo + 8) * D + col) =
            make_float2(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
  }
}

// Streaming multiprocessors of the current device, read once a device.
inline int sm_count() {
  static int sms[port::kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < port::kMaxDevices && sms[dev] > 0) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < port::kMaxDevices) sms[dev] = n;
  return n;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long B, long long H, long long KV, long long Sq,
           long long Skv, bool causal, float scale, cudaStream_t st) {
  const int smem = FwdLayout<D>::SMEM;
  static bool attr_set[port::kMaxDevices] = {};
  const cudaError_t err =
      port::set_smem_once(attr_set, fa_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long nm = (Sq + BM - 1) / BM;
  const long long items = nm * B * H;
  const int sms = sm_count();
  if (items > 0x7fffffffLL || sms < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = items < sms ? items : sms;
  fa_tf32_kernel<D><<<(unsigned)blocks, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, (int)B,
      (int)H, (int)KV, (int)Sq, (int)Skv, (int)nm, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace tf32

// Kernel bodies of the two entries, for the launch counts their wrappers
// read (`flash_attention_launches`).
enum Body {
  kFwdWgmma = 0,      // bf16, D 64 and 128: tc::fa_wgmma_kernel
  kFwdTf32 = 1,       // fp32, D 32 and 64: tf32::fa_tf32_kernel
  kFwdCudaCores = 2,  // bf16 at D 32, fp32 at D 128: flash_attention_kernel
  kBwdWgmma = 3,      // bf16, D 64 and 128: the three bwd_tc kernels
  kBwdTf32 = 4,       // fp32, D 32: the three bwd_tf32 kernels
  kBwdCudaCores = 5,  // bf16 at D 32, fp32 at D 64 and 128: bwd's three
  kBodies = 6
};

// Launches of each body on the calling thread: a forward kernel, or a
// backward's three kernels, on one slice of the batch.
thread_local long long body_launches[kBodies] = {};

// Batches a launch takes: the CUDA-core bodies put the batch on grid z.
constexpr long long kBatchSlice = 65535;

// One slice of `flash_attention_fwd`: pointers at its first batch.
int fwd_slice(const void* q, const void* k, const void* v, void* o,
              float* lse, int dtype, long long B, long long H, long long KV,
              long long Sq, long long Skv, long long D, bool causal,
              float scale, cudaStream_t st) {
  int err = (int)cudaErrorInvalidValue;
  Body body = kBodies;
  if (dtype == 0 && (D == 32 || D == 64)) {
    body = kFwdTf32;
    err = D == 32 ? tf32::launch<32>(q, k, v, o, lse, B, H, KV, Sq, Skv,
                                     causal, scale, st)
                  : tf32::launch<64>(q, k, v, o, lse, B, H, KV, Sq, Skv,
                                     causal, scale, st);
  } else if (dtype == 0 && D == 128) {
    body = kFwdCudaCores;
    err = launch<float, 128>(q, k, v, o, lse, B, H, KV, Sq, Skv, causal,
                             scale, st);
  } else if (dtype == 1 && (D == 64 || D == 128)) {
    body = kFwdWgmma;
    err = D == 64 ? tc::launch<64>(q, k, v, o, lse, B, H, KV, Sq, Skv,
                                   causal, scale, st)
                  : tc::launch<128>(q, k, v, o, lse, B, H, KV, Sq, Skv,
                                    causal, scale, st);
  } else if (dtype == 1 && D == 32) {
    body = kFwdCudaCores;
    err = launch<__nv_bfloat16, 32>(q, k, v, o, lse, B, H, KV, Sq, Skv,
                                    causal, scale, st);
  }
  if (err == 0) ++body_launches[body];
  return err;
}

}  // namespace

// Launches of a kernel body (enum Body: 0 bf16 forward on wgmma, 1 fp32
// forward in 3xTF32, 2 forward on the CUDA cores, 3-5 the backward's the
// same way) made on the calling thread, counted where they are launched:
// one a forward kernel, or a backward's three kernels, on one slice of at
// most 65,535 batches.
extern "C" long long flash_attention_launches(int body) {
  return body >= 0 && body < kBodies ? body_launches[body] : -1;
}

// q (B, H, Sq, D), k/v (B, KV, Skv, D), o (B, H, Sq, D), all contiguous
// on one device, of one type: dtype 0 = fp32 (3xTF32 on the tensor cores
// at D 32 and 64, the CUDA-core body at D 128), 1 = bf16 (the tensor
// cores at D 64 and 128, the CUDA-core body at D 32). Any B >= 1.
// lse: null (serving), or an fp32 (B, H, Sq) buffer that receives each
// row's logsumexp of its scaled logits for the backward (natural log,
// -inf for a row with no visible key); writing it changes no output bit.
// D in {32, 64, 128}; H % KV == 0. Returns the first cudaError_t that is
// not cudaSuccess, else cudaSuccess.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int dtype, long long B, long long H,
                                   long long KV, long long Sq, long long Skv,
                                   long long D, int causal, float scale,
                                   void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  for (long long b0 = 0; b0 < B; b0 += kBatchSlice) {
    const long long nb = B - b0 < kBatchSlice ? B - b0 : kBatchSlice;
    const long long qo = b0 * H * Sq * D * es, ko = b0 * KV * Skv * D * es;
    const int err = fwd_slice(
        static_cast<const char*>(q) + qo, static_cast<const char*>(k) + ko,
        static_cast<const char*>(v) + ko, static_cast<char*>(o) + qo,
        lse == nullptr ? nullptr : lse + b0 * H * Sq, dtype, nb, H, KV, Sq,
        Skv, D, causal != 0, scale, (cudaStream_t)stream);
    if (err != 0) return err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Backward of the attention above. The TPU kernel it belongs to is
// src/repro/kernels/flash_attention/flash_attention.py `_kernel`; repro
// has no Pallas backward and differentiates its reference with XLA
// (jax.vjp). Given q, k, v, the forward's o and row logsumexp lse, and
// dO, the gradients of o = softmax(scale * q k^T) v, in fp32:
//   P  = exp(scale * q k^T - lse)      (0 where masked or the row is empty)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Delta),  Delta = rowsum(dO o)
//   dQ = scale * dS K,   dK = scale * dS^T Q,
// summed over the query heads of a GQA group for dK and dV. No atomics:
// dK and dV are summed inside the block that owns their key rows, dQ
// inside the block that owns its query rows, each in a fixed order, so a
// backward is bit-for-bit repeatable. Outputs are rounded once.
//
// What bounds it on an H100 SXM: operations. The least work is five
// products of Sq x Skv x D a head (S, dP, dV, dK, dQ: 10 * pairs * D
// FLOPs, pairs = B * H * Sq * Skv, about half under the causal mask),
// against the bytes of q, k, v, o, dO and the three gradients once: in
// bf16 at 989 TFLOP/s, in fp32 as 3 x 10 * pairs * D FLOPs at 495 TFLOP/s
// of TF32 (3xTF32, as the forward).
//
// bf16 at D 64 and 128: the tensor cores (namespace bwd_tc), three
// launches, each with a producer warpgroup (one thread issues every TMA
// copy: 128-byte swizzle, 64-column boxes, rows past Sq or Skv read as
// zeros) and two consumer warpgroups of 64 rows:
//   bwd_prep_kernel: Delta (a warp a row, a fixed shuffle tree) and
//     lse * log2(e), padded to a multiple of PAD rows a (b, h), +inf at
//     rows that see no key or lie past Sq: their P is exp2(-inf) = 0;
//   bwd_dkdv_wgmma_kernel: a block owns 128 key rows of one (b, kv head).
//     Its K and V tiles are loaded once; (Q, dO) tiles of 64 query rows
//     with their lse and Delta stream through a ring of STAGES full/empty
//     mbarriers, over every head of the group and, causal, only the tiles
//     from the diagonal on. Per tile, keys as the M side: S^T = K Q^T and
//     dP^T = V dO^T on wgmma from shared memory; P^T and dS^T on the
//     accumulator fragments; dV += P^T dO and dK += dS^T Q with A from
//     registers and Q, dO read MN-major (the transpose bit);
//   bwd_dq_wgmma_kernel: a block owns 128 query rows of one (b, h), the
//     forward's layout; (K, V) tiles of 64 rows stream through the ring.
//     Per tile: S = Q K^T and dP = dO V^T, then dQ += dS K with K read
//     MN-major. Causal, a block stops at its last visible tile; blocks
//     are numbered heaviest first.
// The tensor cores take bf16 operands and P and dS are fp32: rounded once
// (2^-9 a term) they move the gradients by ~20x the one output rounding
// step the port allows. Each enters as hi + lo, two bf16 values whose sum
// is it to ~2^-17, in two wgmmas into one accumulator (both emulated in
// tests/test_torch_kernels_attention.py). So the body executes 20 * pairs
// * D FLOPs (dK/dV: 2 score products + 2 x 2 split ones; dQ: 2 + 2), 2x
// the least work, at up to 989 TFLOP/s.
//
// fp32 at D 32 (MiniLM's and BERT4Rec's): the tensor cores in 3xTF32
// (namespace bwd_tf32), the same three launches and block shapes as
// bwd_tc (prep_kernel, bwd_dkdv_tf32_kernel, bwd_dq_tf32_kernel; no
// atomics, each sum in a fixed order), every product a_lo b_hi + a_hi
// b_lo + a_hi b_hi on `wgmma` .tf32 as in the forward (emulated in
// tests/test_torch_kernels_attention.py, where one TF32 product misses
// the fp32 rule). .tf32 operands are K-major only, so the producer
// warpgroup splits each input and lays out every operand a product
// reads: the dK/dV kernel keeps K and V (hi, lo) and streams (Q, dO)
// tiles both K-major along D (for S^T = K Q^T, dP^T = V dO^T) and
// transposed (Q^T, dO^T, K-major along the queries, for dV += P^T dO and
// dK += dS^T Q), each value split once for both; the dQ kernel keeps q
// and dO and streams K and V along D and K^T along the keys (for dQ +=
// dS K). Its input comes through a cp.async ring as the forward's. A
// transposed copy writes its columns in the k order of a register A
// operand taken from an accumulator fragment (0, 2, 4, 6, 1, 3, 5, 7
// within each 8; P^T and dS^T enter from registers). The dK/dV consumers
// read their columns' lse2 and Delta from the scratch while S^T and dP^T
// run, and add dV and dK one after the other (both products' operands at
// once would not fit the registers). At D 32 each kernel's kept rows,
// ring and copies take 209-225 KB of shared memory: D 64 and 128 would
// not fit. Executed: 3 x 14 * pairs * D FLOPs (S and dP in both kernels)
// at up to 495 TFLOP/s.
//
// bf16 at D 32 (a 64-byte row is below the swizzle) and fp32 at D 64 and
// 128: the CUDA-core body (namespace bwd, the first backward), three
// launches: bwd_delta_kernel
// (Delta, as above); bwd_dkdv_kernel, a block a key tile of BKV rows of
// one (b, kv head) that keeps K and V in shared memory while it walks the
// query tiles of the group that see it; bwd_dq_kernel, a block a query
// tile that walks the key tiles its rows see. 64 x 64 tiles, fp32 in
// shared memory, each product an ascending-d fmaf chain: exact fp32
// products, 14 * pairs * D FLOPs at 67 TFLOP/s at best.
//
// Any batch: the entry runs batches in slices of at most 65,535 (the
// CUDA-core body's grid z), each slice's three launches reusing the
// scratch from its start.
// ---------------------------------------------------------------------------
namespace {
namespace bwd {

constexpr int BQ = 64;                  // query rows a tile
constexpr int BKV = 64;                 // key rows a tile
constexpr int THREADS = 256;
constexpr int TX = 16;
constexpr int TY = THREADS / TX;        // 16
constexpr int RPT = BQ / TY;            // rows of the 64 x 64 tile a thread (4)
constexpr int CPT = BKV / TX;           // columns of it a thread (4)

using port::from_f;
using port::to_f;

template <class T>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int D) {
  const long long r = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(o[r * D + d]), to_f(dout[r * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <int D>
struct DkdvSmem {
  float ks[BKV][D + 1];
  float vs[BKV][D + 1];
  float qs[BQ][D + 1];                  // scaled q
  float dos[BQ][D + 1];
  float ps[BQ][BKV + 1];
  float ds[BQ][BKV + 1];
  float lse[BQ];
  float delta[BQ];
};

template <int D>
struct DqSmem {
  float qs[BQ][D + 1];
  float dos[BQ][D + 1];
  float ks[BKV][D + 1];
  float vs[BKV][D + 1];
  float ds[BQ][BKV + 1];
  float lse[BQ];
  float delta[BQ];
};

// rows [r0, r0 + n) of a (rows, D) matrix of T into dst (fp32, times mul),
// zeros past `rows`
template <class T, int D, int N>
__device__ __forceinline__ void stage(float (*dst)[D + 1], const T* src,
                                      int r0, int rows, float mul) {
  for (int e = threadIdx.x; e < N * D; e += THREADS) {
    const int r = e / D, d = e % D;
    dst[r][d] = r0 + r < rows ? to_f(src[(size_t)(r0 + r) * D + d]) * mul
                              : 0.0f;
  }
}

// The tile's P and dS for the thread's RPT x CPT entries: rows q0 + ty*RPT
// + i (of Sq), columns kv0 + tx + TX*j (of Skv).
template <int D>
__device__ __forceinline__ void tile_p_ds(
    const float (*qs)[D + 1], const float (*dos)[D + 1],
    const float (*ks)[D + 1], const float (*vs)[D + 1], const float* lse_s,
    const float* delta_s, int q0, int kv0, int Sq, int Skv, int q_offset,
    bool causal, float (*ps)[BKV + 1], float (*ds)[BKV + 1]) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RPT], gv[RPT], kv[CPT], vv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = qs[ty * RPT + i][d];
      gv[i] = dos[ty * RPT + i][d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kv[j] = ks[tx + TX * j][d];
      vv[j] = vs[tx + TX * j][d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rl = ty * RPT + i;
    const int row = q0 + rl;
    const float l = lse_s[rl];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int cl = tx + TX * j;
      const int col = kv0 + cl;
      const bool vis = row < Sq && col < Skv && l != -CUDART_INF_F &&
                       !(causal && col > row + q_offset);
      const float p = vis ? expf(s[i][j] - l) : 0.0f;
      ps[rl][cl] = p;
      ds[rl][cl] = p * (dp[i][j] - delta_s[rl]);
    }
  }
}

template <class T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int H, int KV, int Sq, int Skv,
                bool causal, float scale) {
  constexpr int DPT = D / TX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkdvSmem<D>& sm = *reinterpret_cast<DkdvSmem<D>*>(smem_raw);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int kv0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int q_offset = Skv - Sq;
  const size_t kv_base = (size_t)(b * KV + kvh) * Skv * D;
  stage<T, D, BKV>(sm.ks, k + kv_base, kv0, Skv, 1.0f);
  stage<T, D, BKV>(sm.vs, v + kv_base, kv0, Skv, 1.0f);

  float adk[RPT][DPT], adv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) adk[i][dd] = adv[i][dd] = 0.0f;

  // the first query tile with a row that sees column kv0
  int qt0 = 0;
  if (causal) qt0 = max(0, kv0 - q_offset) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_base = (size_t)(b * H + h) * Sq;
    for (int q0 = qt0 * BQ; q0 < Sq; q0 += BQ) {
      __syncthreads();                  // the last tile is consumed
      stage<T, D, BQ>(sm.qs, q + q_base * D, q0, Sq, scale);
      stage<T, D, BQ>(sm.dos, dout + q_base * D, q0, Sq, 1.0f);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const bool in = q0 + r < Sq;
        sm.lse[r] = in ? lse[q_base + q0 + r] : -CUDART_INF_F;
        sm.delta[r] = in ? delta[q_base + q0 + r] : 0.0f;
      }
      __syncthreads();
      tile_p_ds<D>(sm.qs, sm.dos, sm.ks, sm.vs, sm.lse, sm.delta, q0, kv0,
                   Sq, Skv, q_offset, causal, sm.ps, sm.ds);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[RPT], dr[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pr[i] = sm.ps[r][ty * RPT + i];
          dr[i] = sm.ds[r][ty * RPT + i];
        }
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          const float gv = sm.dos[r][tx + TX * dd];
          const float qv = sm.qs[r][tx + TX * dd];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            adv[i][dd] = fmaf(pr[i], gv, adv[i][dd]);
            adk[i][dd] = fmaf(dr[i], qv, adk[i][dd]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = kv0 + ty * RPT + i;
    if (row >= Skv) continue;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const size_t off = kv_base + (size_t)row * D + tx + TX * dd;
      dk[off] = from_f<T>(adk[i][dd]);   // q was staged scaled
      dv[off] = from_f<T>(adv[i][dd]);
    }
  }
}

template <class T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int KV, int Sq, int Skv, bool causal,
              float scale) {
  constexpr int DPT = D / TX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Skv - Sq;
  const size_t q_base = (size_t)(b * H + h) * Sq;
  const size_t kv_base = (size_t)(b * KV + kvh) * Skv * D;
  stage<T, D, BQ>(sm.qs, q + q_base * D, q0, Sq, scale);
  stage<T, D, BQ>(sm.dos, dout + q_base * D, q0, Sq, 1.0f);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < Sq;
    sm.lse[r] = in ? lse[q_base + q0 + r] : -CUDART_INF_F;
    sm.delta[r] = in ? delta[q_base + q0 + r] : 0.0f;
  }

  float adq[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) adq[i][dd] = 0.0f;

  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, q0 + BQ + q_offset));
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();                    // q staged; the last tile consumed
    stage<T, D, BKV>(sm.ks, k + kv_base, kv0, Skv, 1.0f);
    stage<T, D, BKV>(sm.vs, v + kv_base, kv0, Skv, 1.0f);
    __syncthreads();
    tile_p_ds<D>(sm.qs, sm.dos, sm.ks, sm.vs, sm.lse, sm.delta, q0, kv0, Sq,
                 Skv, q_offset, causal, sm.ds, sm.ds);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      float dr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dr[i] = sm.ds[ty * RPT + i][c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float kv = sm.ks[c][tx + TX * dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) adq[i][dd] = fmaf(dr[i], kv, adq[i][dd]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      dq[(q_base + row) * D + tx + TX * dd] = from_f<T>(adq[i][dd] * scale);
  }
}

template <class T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, long long B, long long H, long long KV,
               long long Sq, long long Skv, bool causal, float scale,
               cudaStream_t st) {
  static bool set_dkdv[port::kMaxDevices] = {};
  static bool set_dq[port::kMaxDevices] = {};
  const int s1 = (int)sizeof(DkdvSmem<D>), s2 = (int)sizeof(DqSmem<D>);
  cudaError_t err = port::set_smem_once(set_dkdv, bwd_dkdv_kernel<T, D>, s1);
  if (err == cudaSuccess)
    err = port::set_smem_once(set_dq, bwd_dq_kernel<T, D>, s2);
  if (err != cudaSuccess) return (int)err;
  const long long rows = B * H * Sq;
  const long long g0 = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (g0 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  bwd_delta_kernel<T><<<(unsigned)g0, THREADS, 0, st>>>(
      static_cast<const T*>(o), tg, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((unsigned)((Skv + BKV - 1) / BKV), (unsigned)KV,
                (unsigned)B);
  bwd_dkdv_kernel<T, D><<<g1, THREADS, s1, st>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      (int)H, (int)KV, (int)Sq, (int)Skv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  bwd_dq_kernel<T, D><<<g2, THREADS, s2, st>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), (int)H, (int)KV,
      (int)Sq, (int)Skv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd

namespace bwd_tc {

using namespace hopper;

constexpr int THREADS = 384;            // producer + 2 consumer warpgroups
constexpr int BOX = 64;                 // bf16 columns of one swizzled box
constexpr int BIG = 128;                // rows a block owns (2 x 64)
constexpr int TILE = 64;                // rows of a streamed tile
constexpr int STAGES = 4;               // streamed tiles in flight
constexpr int PAD = 128;                // lse2 / Delta rows a (b, h): a multiple
constexpr int PREP_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int BIG_BYTES = BIG * D * 2;     // a 128-row tile
  static constexpr int TILE_BYTES = TILE * D * 2;   // a 64-row tile
  static constexpr int LD_BYTES = 2 * TILE * 4;     // lse2 and Delta of one
  // two 128-row tiles the block keeps, a ring of two 64-row tiles (and, in
  // the dK/dV kernel, their lse2 and Delta) a stage, 1024 for alignment
  static constexpr int SMEM =
      2 * BIG_BYTES + STAGES * (2 * TILE_BYTES + LD_BYTES) + 1024;
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The register A operand of a product over the 64 columns of an m64n64
// fp32 accumulator fragment x (k step kk: columns 16kk..16kk+15), as two
// bf16 terms: hi = x rounded, lo = (x - hi) rounded.
__device__ __forceinline__ void split_frag(const float (&x)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(x[4 * j], x[4 * j + 1]);
    const __nv_bfloat162 h1 =
        __floats2bfloat162_rn(x[4 * j + 2], x[4 * j + 3]);
    const __nv_bfloat162 r0 = __floats2bfloat162_rn(
        x[4 * j] - __low2float(h0), x[4 * j + 1] - __high2float(h0));
    const __nv_bfloat162 r1 = __floats2bfloat162_rn(
        x[4 * j + 2] - __low2float(h1), x[4 * j + 3] - __high2float(h1));
    const int kk = j / 2, o = (j % 2) * 2;
    hi[kk][o] = bits(h0);
    hi[kk][o + 1] = bits(h1);
    lo[kk][o] = bits(r0);
    lo[kk][o + 1] = bits(r1);
  }
}

// acc (64 x D) += the split A (64 x 64) times the 64 x D tile at `b`, read
// MN-major (its rows the reduction; `box` bytes between 64-column boxes).
template <int D>
__device__ __forceinline__ void mma_split(float (&acc)[D / 2],
                                          const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4],
                                          uint32_t b, uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * 128, box, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, hi[kk], db);
      wgmma_rs_n128(acc, lo[kk], db);
    } else {
      wgmma_rs_n64(acc, hi[kk], db);
      wgmma_rs_n64(acc, lo[kk], db);
    }
  }
}

// acc (64 x 64) = A (64 x D at `a`) times B^T (64 x D at `b`), both K-major
// with `a_box` and `b_box` bytes between their 64-column boxes.
template <int D>
__device__ __forceinline__ void mma_scores(float (&acc)[32], uint32_t a,
                                           uint32_t a_box, uint32_t b,
                                           uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;     // 16 columns of a 64-column box
    wgmma_ss_n64(acc, desc_sw128(a + (kk / 4) * a_box + off, 16, 1024),
                 desc_sw128(b + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
}

// lse2 = lse * log2(e), +inf where the row sees no key (lse = -inf) or
// lies past Sq, and Delta = rowsum(dO o) (0 past Sq), Sqp rows a (b, h); a
// warp a row.
__global__ void __launch_bounds__(PREP_THREADS)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, long long rows, int Sq, int Sqp,
                int D) {
  const long long r =
      (long long)blockIdx.x * (PREP_THREADS / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = r / Sqp;
  const int row = (int)(r % Sqp);
  float acc = 0.0f, l2 = CUDART_INF_F;
  if (row < Sq) {
    const size_t src = (size_t)(bh * Sq + row);
    for (int d = lane; d < D; d += 32)
      acc = fmaf(port::to_f(o[src * D + d]), port::to_f(dout[src * D + d]),
                 acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float l = lse[src];
    if (l != -CUDART_INF_F) l2 = l * LOG2E;
  }
  if (lane == 0) {
    lse2[r] = l2;
    delta[r] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,    // 64 rows
                      const __grid_constant__ CUtensorMap tdo,   // 64 rows
                      const __grid_constant__ CUtensorMap tk,    // 128 rows
                      const __grid_constant__ CUtensorMap tv,    // 128 rows
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int B, int H, int KV,
                      int Sq, int Skv, int Sqp, bool causal, float scale,
                      float scale_log2) {
  using L = Layout<D>;
  constexpr int NB = D / BOX;
  constexpr int NA = D / 2;             // dK, dV accumulator registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + L::BIG_BYTES;
  const uint32_t s_q = s_v + L::BIG_BYTES;              // + stage * TILE_BYTES
  const uint32_t s_do = s_q + STAGES * L::TILE_BYTES;
  const uint32_t s_ld = s_do + STAGES * L::TILE_BYTES;  // + stage * LD_BYTES
  const float* ld = reinterpret_cast<const float*>(smem_raw + (s_ld - raw));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + STAGES]);   // + 8 * stage

  // key tiles in order: under the causal mask the first sees the most
  // query tiles, so the heaviest blocks start first
  const int bkv = blockIdx.x % (B * KV);
  const int k0 = (int)(blockIdx.x / (B * KV)) * BIG;
  const int kvh = bkv % KV;
  const int b = bkv / KV;
  const int G = H / KV;
  const int q_offset = Skv - Sq;
  // the first query tile with a row that sees key k0; tiles t of the walk:
  // head kvh * G + t / nqt, query tile qt0 + t % nqt
  const int qt0 = causal ? max(0, k0 - q_offset) / TILE : 0;
  const int nqt = max(0, (Sq + TILE - 1) / TILE - qt0);
  const int ntiles = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread issues every copy ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, 2 * L::BIG_BYTES);
      for (int x = 0; x < NB; ++x) {
        tma_load_3d(s_k + x * BIG * 128, &tk, bar_kv, x * BOX, k0,
                    b * KV + kvh);
        tma_load_3d(s_v + x * BIG * 128, &tv, bar_kv, x * BOX, k0,
                    b * KV + kvh);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const int h = kvh * G + t / nqt;
        const int q0 = (qt0 + t % nqt) * TILE;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) + 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::TILE_BYTES + L::LD_BYTES);
        for (int x = 0; x < NB; ++x) {
          tma_load_3d(s_q + s * L::TILE_BYTES + x * TILE * 128, &tq, full,
                      x * BOX, q0, b * H + h);
          tma_load_3d(s_do + s * L::TILE_BYTES + x * TILE * 128, &tdo, full,
                      x * BOX, q0, b * H + h);
        }
        const size_t row = (size_t)(b * H + h) * Sqp + q0;
        bulk_load(s_ld + s * L::LD_BYTES, lse2 + row, TILE * 4, full);
        bulk_load(s_ld + s * L::LD_BYTES + TILE * 4, delta + row, TILE * 4,
                  full);
      }
    }
    return;
  }

  // -- consumers: 64 key rows each -------------------------------------------
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int quad = lane % 4;
  const int kw0 = k0 + cw * 64;                        // the warpgroup's keys
  const int key = kw0 + (t128 / 32) * 16 + lane / 4;   // and key + 8

  float adk[NA], adv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) adk[i] = adv[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  const uint32_t ka = s_k + cw * 64 * 128;
  const uint32_t va = s_v + cw * 64 * 128;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int q0 = (qt0 + t % nqt) * TILE;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t qt = s_q + s * L::TILE_BYTES;
    const uint32_t dot = s_do + s * L::TILE_BYTES;

    // S^T = K q^T and dP^T = V dO^T, 64 keys x 64 queries fp32
    float sacc[32], pacc[32];
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
    mma_scores<D>(sacc, ka, BIG * 128, qt, TILE * 128);
    mma_scores<D>(pacc, va, BIG * 128, dot, TILE * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);

    // P^T and dS^T in place: column c of the tile is query q0 + c
    const float* l2 = ld + s * (L::LD_BYTES / 4);
    const float* dl = l2 + TILE;
    const bool mask = causal && kw0 + 63 > q0 + q_offset;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * quad + c;
        const float lj = l2[col], dj = dl[col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          float p = exp2f(fmaf(sacc[x], scale_log2, -lj));
          if (mask && key + 8 * i > q0 + col + q_offset) p = 0.0f;
          sacc[x] = p;
          pacc[x] = p * (pacc[x] - dj);
        }
      }
    }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    split_frag(sacc, phi, plo);
    split_frag(pacc, dhi, dlo);

    // dV += (P_hi + P_lo)^T dO, dK += (dS_hi + dS_lo)^T q
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(dhi);
    fence_regs(dlo);
    wgmma_fence();
    mma_split<D>(adv, phi, plo, dot, TILE * 128);
    mma_split<D>(adk, dhi, dlo, qt, TILE * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adv);
    fence_regs(adk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  const size_t kv_base = (size_t)(b * KV + kvh) * Skv * D;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = 8 * j + 2 * quad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key + 8 * i >= Skv) continue;
      const size_t off = kv_base + (size_t)(key + 8 * i) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          adk[4 * j + 2 * i] * scale, adk[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(
          adv[4 * j + 2 * i], adv[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,    // 128 rows
                    const __grid_constant__ CUtensorMap tdo,   // 128 rows
                    const __grid_constant__ CUtensorMap tk,    // 64 rows
                    const __grid_constant__ CUtensorMap tv,    // 64 rows
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int B, int H, int KV,
                    int Sq, int Skv, int Sqp, int nm, bool causal,
                    float scale, float scale_log2) {
  using L = Layout<D>;
  constexpr int NB = D / BOX;
  constexpr int NA = D / 2;             // dQ accumulator registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_do = s_q + L::BIG_BYTES;
  const uint32_t s_k = s_do + L::BIG_BYTES;             // + stage * TILE_BYTES
  const uint32_t s_v = s_k + STAGES * L::TILE_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + STAGES]);   // + 8 * stage

  // heaviest query block first: block index -> (m block, b, h)
  const int bh = blockIdx.x % (B * H);
  const int mb = nm - 1 - (int)(blockIdx.x / (B * H));
  const int h = bh % H;
  const int b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = mb * BIG;
  const int q_offset = Skv - Sq;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, q0 + BIG + q_offset));
  const int ntiles = (kv_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread issues every copy ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * L::BIG_BYTES);
      for (int x = 0; x < NB; ++x) {
        tma_load_3d(s_q + x * BIG * 128, &tq, bar_q, x * BOX, q0, b * H + h);
        tma_load_3d(s_do + x * BIG * 128, &tdo, bar_q, x * BOX, q0,
                    b * H + h);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) + 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::TILE_BYTES);
        for (int x = 0; x < NB; ++x) {
          tma_load_3d(s_k + s * L::TILE_BYTES + x * TILE * 128, &tk, full,
                      x * BOX, t * TILE, b * KV + kvh);
          tma_load_3d(s_v + s * L::TILE_BYTES + x * TILE * 128, &tv, full,
                      x * BOX, t * TILE, b * KV + kvh);
        }
      }
    }
    return;
  }

  // -- consumers: 64 query rows each -----------------------------------------
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int quad = lane % 4;
  const int wg_row0 = q0 + cw * 64;
  const int r_lo = wg_row0 + (t128 / 32) * 16 + lane / 4;    // and r_lo + 8
  const size_t lrow = (size_t)bh * Sqp + r_lo;               // < Sqp rows
  const float l0 = lse2[lrow], l1 = lse2[lrow + 8];
  const float d0 = delta[lrow], d1 = delta[lrow + 8];

  float adq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) adq[i] = 0.0f;

  mbar_wait(bar_q, 0);
  const uint32_t qa = s_q + cw * 64 * 128;       // this warpgroup's rows
  const uint32_t da = s_do + cw * 64 * 128;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t kt = s_k + s * L::TILE_BYTES;
    const uint32_t vt = s_v + s * L::TILE_BYTES;

    // S = q K^T and dP = dO V^T, 64 queries x 64 keys fp32
    float sacc[32], pacc[32];
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
    mma_scores<D>(sacc, qa, BIG * 128, kt, TILE * 128);
    mma_scores<D>(pacc, da, BIG * 128, vt, TILE * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);

    // dS in place of dP
    const int kv0 = t * TILE;
    const bool mask = kv0 + TILE > Skv ||
                      (causal && kv0 + TILE - 1 > wg_row0 + q_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = kv0 + 8 * j + 2 * quad + c;
        float p0 = exp2f(fmaf(sacc[4 * j + c], scale_log2, -l0));
        float p1 = exp2f(fmaf(sacc[4 * j + 2 + c], scale_log2, -l1));
        if (mask) {
          if (col >= Skv || (causal && col > r_lo + q_offset)) p0 = 0.0f;
          if (col >= Skv || (causal && col > r_lo + 8 + q_offset)) p1 = 0.0f;
        }
        pacc[4 * j + c] = p0 * (pacc[4 * j + c] - d0);
        pacc[4 * j + 2 + c] = p1 * (pacc[4 * j + 2 + c] - d1);
      }
    }
    uint32_t dhi[4][4], dlo[4][4];
    split_frag(pacc, dhi, dlo);

    // dQ += (dS_hi + dS_lo) K
    fence_regs(adq);
    fence_regs(dhi);
    fence_regs(dlo);
    wgmma_fence();
    mma_split<D>(adq, dhi, dlo, kt, TILE * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adq);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  __nv_bfloat16* qb = dq + (size_t)(b * H + h) * Sq * D;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = 8 * j + 2 * quad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r_lo + 8 * i >= Sq) continue;
      *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)(r_lo + 8 * i) * D +
                                         col) =
          __floats2bfloat162_rn(adq[4 * j + 2 * i] * scale,
                                adq[4 * j + 2 * i + 1] * scale);
    }
  }
}

// Rows of lse2 and Delta a (b, h) in the scratch.
inline long long padded_rows(long long Sq) {
  return (Sq + PAD - 1) / PAD * PAD;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, long long B, long long H, long long KV,
           long long Sq, long long Skv, bool causal, float scale,
           cudaStream_t st) {
  const int smem = Layout<D>::SMEM;
  static bool set_dkdv[port::kMaxDevices] = {};
  static bool set_dq[port::kMaxDevices] = {};
  cudaError_t err =
      port::set_smem_once(set_dkdv, bwd_dkdv_wgmma_kernel<D>, smem);
  if (err == cudaSuccess)
    err = port::set_smem_once(set_dq, bwd_dq_wgmma_kernel<D>, smem);
  if (err == cudaSuccess) err = tc::bind_context();
  if (err != cudaSuccess) return (int)err;
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // (Q, dO) in boxes of 64 rows for the dK/dV kernel and 128 for dQ;
  // (K, V) the other way round
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!tc::make_map(enc, &q64, q, D, Sq, B * H, TILE) ||
      !tc::make_map(enc, &do64, dout, D, Sq, B * H, TILE) ||
      !tc::make_map(enc, &k128, k, D, Skv, B * KV, BIG) ||
      !tc::make_map(enc, &v128, v, D, Skv, B * KV, BIG) ||
      !tc::make_map(enc, &q128, q, D, Sq, B * H, BIG) ||
      !tc::make_map(enc, &do128, dout, D, Sq, B * H, BIG) ||
      !tc::make_map(enc, &k64, k, D, Skv, B * KV, TILE) ||
      !tc::make_map(enc, &v64, v, D, Skv, B * KV, TILE))
    return (int)cudaErrorInvalidValue;
  const long long Sqp = padded_rows(Sq);
  const long long rows = B * H * Sqp;
  const long long nm = (Sq + BIG - 1) / BIG;
  const long long g0 = (rows + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32);
  const long long g1 = (Skv + BIG - 1) / BIG * B * KV;
  const long long g2 = nm * B * H;
  if (g0 > 0x7fffffffLL || g1 > 0x7fffffffLL || g2 > 0x7fffffffLL ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  const float sl2 = scale * LOG2E;
  bwd_prep_kernel<<<(unsigned)g0, PREP_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, rows,
      (int)Sq, (int)Sqp, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_wgmma_kernel<D><<<(unsigned)g1, THREADS, smem, st>>>(
      q64, do64, k128, v128, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), (int)B, (int)H, (int)KV, (int)Sq,
      (int)Skv, (int)Sqp, causal, scale, sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_wgmma_kernel<D><<<(unsigned)g2, THREADS, smem, st>>>(
      q128, do128, k64, v64, lse2, delta, static_cast<__nv_bfloat16*>(dq),
      (int)B, (int)H, (int)KV, (int)Sq, (int)Skv, (int)Sqp, (int)nm, causal,
      scale, sl2);
  return (int)cudaGetLastError();
}

}  // namespace bwd_tc

namespace bwd_tf32 {

using namespace hopper;
using tf32::kdesc;
using tf32::mma3_rs;
using tf32::mma3_ss;
using tf32::Rows;
using tf32::split_frag;

constexpr int THREADS = 384;            // producer + 2 consumer warpgroups
constexpr int BIG = 128;                // rows a block owns (2 x 64)
constexpr int TILE = 64;                // rows of a streamed tile
constexpr int STAGES = 2;               // converted tiles in flight
constexpr int PRODUCER_REGS = 88;       // 128 x 88 + 256 x 208 <= 65,536
constexpr int CONSUMER_REGS = 208;

// The producer works in units of two 64-row blocks (8 KB each at D 32),
// copied RAW units ahead by cp.async: first the block's two kept
// matrices (a unit each: rows 0-63 and 64-127), then one unit a tile.
template <int D>
struct Layout {
  static constexpr int BIG_HALF = BIG * D * 4;     // hi or lo of 128 rows
  static constexpr int TILE_HALF = TILE * D * 4;   // hi or lo of 64 rows
  // the two 128-row matrices a block keeps, hi and lo
  static constexpr int KEEP = 4 * BIG_HALF;
  static constexpr int RAW_UNIT = 2 * TILE * D * 4;
  // dK/dV: a stage is Q, dO (hi, lo) K-major along D, then Q^T, dO^T (hi,
  // lo) K-major along the queries
  static constexpr int DKDV_STAGE = 8 * TILE_HALF;
  static constexpr int DKDV_RAW = 2;
  static constexpr int DKDV_SMEM =
      KEEP + STAGES * DKDV_STAGE + DKDV_RAW * RAW_UNIT + 1024;
  // dQ: a stage is K, V (hi, lo) K-major along D, then K^T (hi, lo)
  static constexpr int DQ_STAGE = 6 * TILE_HALF;
  static constexpr int DQ_RAW = 3;
  static constexpr int DQ_SMEM =
      KEEP + STAGES * DQ_STAGE + DQ_RAW * RAW_UNIT + 1024;
};

constexpr int PREP_THREADS = 256;

// lse2 = lse * log2(e) (+inf where the row sees no key or lies past Sq)
// and Delta = rowsum(dO o) (0 past Sq), Sqp rows a (b, h), as
// bwd_tc::bwd_prep_kernel; D / 4 lanes a row, a float4 each, summed by
// a fixed shuffle tree.
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ o, const float* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2,
            float* __restrict__ delta, long long rows, int Sq, int Sqp) {
  constexpr int LPR = D / 4;            // lanes a row
  const long long r = ((long long)blockIdx.x * PREP_THREADS + threadIdx.x) /
                      LPR;
  const int part = threadIdx.x % LPR;
  const bool in = r < rows;
  const long long bh = in ? r / Sqp : 0;
  const int row = in ? (int)(r % Sqp) : Sq;
  float acc = 0.0f, l2 = CUDART_INF_F;
  if (row < Sq) {
    const size_t src = (size_t)(bh * Sq + row);
    const float4 a = __ldg(reinterpret_cast<const float4*>(o + src * D) + part);
    const float4 g =
        __ldg(reinterpret_cast<const float4*>(dout + src * D) + part);
    acc = fmaf(a.w, g.w, fmaf(a.z, g.z, fmaf(a.y, g.y, a.x * g.x)));
    const float l = lse[src];
    if (l != -CUDART_INF_F) l2 = l * tf32::LOG2E;
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && part == 0) {
    lse2[r] = l2;
    delta[r] = acc;
  }
}

// The producer's walk over a block's units: `copy(u, dst)` issues unit
// u's copies (if u < n) and commits a group; `take(u)` waits for unit u,
// reads it back and hands it to `put(u, x, y)`; the copies run RAW units
// ahead.
template <int D, int RAW, class Copy, class Put>
__device__ __forceinline__ void walk_units(int n, uint32_t raw, int p,
                                           Copy copy, Put put) {
  constexpr int UNIT = 2 * TILE * D * 4;
#pragma unroll 1
  for (int u = 0; u < RAW; ++u) {
    if (u < n) copy(u, raw + u * UNIT);
    cp_async_commit();
  }
#pragma unroll 1
  for (int u = 0; u < n; ++u) {
    const uint32_t slot = raw + (u % RAW) * UNIT;
    cp_async_wait<RAW - 1>();           // this thread's copies of unit u
    Rows<D, TILE> x, y;
    x.read(slot, p);
    y.read(slot + UNIT / 2, p);
    put(u, x, y);                       // x and y used: reuse the slot
    if (u + RAW < n) copy(u + RAW, slot);
    cp_async_commit();
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int B, int H, int KV, int Sq,
                     int Skv, int Sqp, bool causal, float scale,
                     float scale_log2) {
  using L = Layout<D>;
  constexpr int TH = L::TILE_HALF;
  constexpr int KS = D / 8;             // k steps over D
  constexpr int NA = D / 2;             // dK, dV accumulator registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_khi = base, s_klo = base + L::BIG_HALF;
  const uint32_t s_vhi = base + 2 * L::BIG_HALF;
  const uint32_t s_vlo = base + 3 * L::BIG_HALF;
  const uint32_t s_ring = base + L::KEEP;           // + stage * DKDV_STAGE
  const uint32_t s_raw = s_ring + STAGES * L::DKDV_STAGE;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + STAGES]);   // + 8 * stage

  // key tiles in order: under the causal mask the first sees the most
  // query tiles, so the heaviest blocks start first
  const int bkv = blockIdx.x % (B * KV);
  const int k0 = (int)(blockIdx.x / (B * KV)) * BIG;
  const int kvh = bkv % KV;
  const int b = bkv / KV;
  const int G = H / KV;
  const int q_offset = Skv - Sq;
  // the first query tile with a row that sees key k0; tiles t of the walk:
  // head kvh * G + t / nqt, query tile qt0 + t % nqt
  const int qt0 = causal ? max(0, k0 - q_offset) / TILE : 0;
  const int nqt = max(0, (Sq + TILE - 1) / TILE - qt0);
  const int ntiles = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 128);             // one arrival a producer thread
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: K and V, then the (Q, dO) tiles, split and laid out
    setmaxnreg_dec<PRODUCER_REGS>();
    const int p = threadIdx.x;
    const size_t kv_base = (size_t)(b * KV + kvh) * Skv * D;
    auto copy = [&](int u, uint32_t dst) {
      if (u < 2) {
        const float* src = (u == 0 ? k : v) + kv_base;
        Rows<D, TILE>::copy(dst, src, k0, Skv, p);
        Rows<D, TILE>::copy(dst + L::RAW_UNIT / 2, src, k0 + TILE, Skv, p);
      } else {
        const int t = u - 2;
        const int h = kvh * G + t / nqt;
        const int q0 = (qt0 + t % nqt) * TILE;
        const size_t qbase = (size_t)(b * H + h) * Sq * D;
        Rows<D, TILE>::copy(dst, q + qbase, q0, Sq, p);
        Rows<D, TILE>::copy(dst + L::RAW_UNIT / 2, dout + qbase, q0, Sq, p);
      }
    };
    auto put = [&](int u, const Rows<D, TILE>& x, const Rows<D, TILE>& y) {
      if (u < 2) {
        const uint32_t hi = u == 0 ? s_khi : s_vhi;
        x.store(hi, hi + L::BIG_HALF, p, BIG * 128, 0);
        y.store(hi, hi + L::BIG_HALF, p, BIG * 128, TILE);
        if (u == 1) {
          fence_proxy_async();
          mbar_arrive(bar_kv);
        }
        return;
      }
      const int t = u - 2, s = t % STAGES;
      if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) + 1) & 1);
      const uint32_t st = s_ring + s * L::DKDV_STAGE;
      x.store_both(st, st + TH, st + 4 * TH, st + 5 * TH, p);
      y.store_both(st + 2 * TH, st + 3 * TH, st + 6 * TH, st + 7 * TH, p);
      fence_proxy_async();
      mbar_arrive(bar_full + 8 * s);
    };
    walk_units<D, L::DKDV_RAW>(2 + ntiles, s_raw, p, copy, put);
    return;
  }

  // -- consumers: 64 key rows each -------------------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int quad = lane % 4;
  const int kw0 = k0 + cw * 64;                        // the warpgroup's keys
  const int key = kw0 + (t128 / 32) * 16 + lane / 4;   // and key + 8

  float adk[NA], adv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) adk[i] = adv[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  const uint32_t kw = cw * 64 * 128;    // the warpgroup's rows in a kept half

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int h = kvh * G + t / nqt;
    const int q0 = (qt0 + t % nqt) * TILE;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t st = s_ring + s * L::DKDV_STAGE;

    // S^T = K q^T and dP^T = V dO^T, 64 keys x 64 queries fp32
    float sacc[32], pacc[32];
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t a = (kk / 4) * (BIG * 128) + kw + (kk % 4) * 32;
      const uint32_t o = (kk / 4) * (TILE * 128) + (kk % 4) * 32;
      mma3_ss<TILE>(sacc, s_khi + a, s_klo + a, st + o, st + TH + o, kk > 0);
      mma3_ss<TILE>(pacc, s_vhi + a, s_vlo + a, st + 2 * TH + o,
                    st + 3 * TH + o, kk > 0);
    }
    wgmma_commit();
    // this thread's columns' lse2 and Delta while the products run (rows
    // < Sqp: no bound check)
    const size_t lrow = (size_t)(b * H + h) * Sqp + q0 + 2 * quad;
    float2 lj[8], dj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lj[j] = __ldg(reinterpret_cast<const float2*>(lse2 + lrow + 8 * j));
      dj[j] = __ldg(reinterpret_cast<const float2*>(delta + lrow + 8 * j));
    }
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);

    // P^T and dS^T in place: column c of the tile is query q0 + c
    const bool mask = causal && kw0 + 63 > q0 + q_offset;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * quad + c;
        const float l = c ? lj[j].y : lj[j].x, dl = c ? dj[j].y : dj[j].x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          float p = exp2f(fmaf(sacc[x], scale_log2, -l));
          if (mask && key + 8 * i > q0 + col + q_offset) p = 0.0f;
          sacc[x] = p;
          pacc[x] = p * (pacc[x] - dl);
        }
      }
    }

    // dV += P^T dO, then dK += dS^T q (dO^T, q^T K-major along the
    // queries), one after the other: P's and dS's operands at once would
    // not fit the registers
    uint32_t phi[8][4], plo[8][4];
    split_frag<TILE>(sacc, phi, plo);
    fence_regs(adv);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = (j / 4) * (D * 128) + (j % 4) * 32;
      mma3_rs<D>(adv, phi[j], plo[j], st + 6 * TH + off, st + 7 * TH + off,
                 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adv);
    uint32_t dhi[8][4], dlo[8][4];
    split_frag<TILE>(pacc, dhi, dlo);
    fence_regs(adk);
    fence_regs(dhi);
    fence_regs(dlo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = (j / 4) * (D * 128) + (j % 4) * 32;
      mma3_rs<D>(adk, dhi[j], dlo[j], st + 4 * TH + off, st + 5 * TH + off,
                 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adv);
    fence_regs(adk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  const size_t kv_base = (size_t)(b * KV + kvh) * Skv * D;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = 8 * j + 2 * quad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key + 8 * i >= Skv) continue;
      const size_t off = kv_base + (size_t)(key + 8 * i) * D + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(
          adk[4 * j + 2 * i] * scale, adk[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(adv[4 * j + 2 * i], adv[4 * j + 2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int B, int H, int KV, int Sq, int Skv, int Sqp, int nm,
                   bool causal, float scale, float scale_log2) {
  using L = Layout<D>;
  constexpr int TH = L::TILE_HALF;
  constexpr int KS = D / 8;
  constexpr int NA = D / 2;             // dQ accumulator registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_qhi = base, s_qlo = base + L::BIG_HALF;
  const uint32_t s_ghi = base + 2 * L::BIG_HALF;
  const uint32_t s_glo = base + 3 * L::BIG_HALF;
  const uint32_t s_ring = base + L::KEEP;           // + stage * DQ_STAGE
  const uint32_t s_raw = s_ring + STAGES * L::DQ_STAGE;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + STAGES]);   // + 8 * stage

  // heaviest query block first: block index -> (m block, b, h)
  const int bh = blockIdx.x % (B * H);
  const int mb = nm - 1 - (int)(blockIdx.x / (B * H));
  const int h = bh % H;
  const int b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = mb * BIG;
  const int q_offset = Skv - Sq;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, max(0, q0 + BIG + q_offset));
  const int ntiles = (kv_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 128);              // one arrival a producer thread
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: q and dO, then the (K, V) tiles, split and laid out
    setmaxnreg_dec<PRODUCER_REGS>();
    const int p = threadIdx.x;
    const size_t qbase = (size_t)(b * H + h) * Sq * D;
    const size_t kv_base = (size_t)(b * KV + kvh) * Skv * D;
    auto copy = [&](int u, uint32_t dst) {
      if (u < 2) {
        const float* src = (u == 0 ? q : dout) + qbase;
        Rows<D, TILE>::copy(dst, src, q0, Sq, p);
        Rows<D, TILE>::copy(dst + L::RAW_UNIT / 2, src, q0 + TILE, Sq, p);
      } else {
        const int r0 = (u - 2) * TILE;
        Rows<D, TILE>::copy(dst, k + kv_base, r0, Skv, p);
        Rows<D, TILE>::copy(dst + L::RAW_UNIT / 2, v + kv_base, r0, Skv, p);
      }
    };
    auto put = [&](int u, const Rows<D, TILE>& x, const Rows<D, TILE>& y) {
      if (u < 2) {
        const uint32_t hi = u == 0 ? s_qhi : s_ghi;
        x.store(hi, hi + L::BIG_HALF, p, BIG * 128, 0);
        y.store(hi, hi + L::BIG_HALF, p, BIG * 128, TILE);
        if (u == 1) {
          fence_proxy_async();
          mbar_arrive(bar_q);
        }
        return;
      }
      const int t = u - 2, s = t % STAGES;
      if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) + 1) & 1);
      const uint32_t st = s_ring + s * L::DQ_STAGE;
      x.store_both(st, st + TH, st + 4 * TH, st + 5 * TH, p);
      y.store(st + 2 * TH, st + 3 * TH, p);
      fence_proxy_async();
      mbar_arrive(bar_full + 8 * s);
    };
    walk_units<D, L::DQ_RAW>(2 + ntiles, s_raw, p, copy, put);
    return;
  }

  // -- consumers: 64 query rows each -----------------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int quad = lane % 4;
  const int wg_row0 = q0 + cw * 64;
  const int r_lo = wg_row0 + (t128 / 32) * 16 + lane / 4;    // and r_lo + 8
  const size_t lrow = (size_t)bh * Sqp + r_lo;               // < Sqp rows
  const float l0 = lse2[lrow], l1 = lse2[lrow + 8];
  const float d0 = delta[lrow], d1 = delta[lrow + 8];

  float adq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) adq[i] = 0.0f;

  mbar_wait(bar_q, 0);
  const uint32_t qw = cw * 64 * 128;    // the warpgroup's rows in a kept half

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t st = s_ring + s * L::DQ_STAGE;

    // S = q K^T and dP = dO V^T, 64 queries x 64 keys fp32
    float sacc[32], pacc[32];
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t a = (kk / 4) * (BIG * 128) + qw + (kk % 4) * 32;
      const uint32_t o = (kk / 4) * (TILE * 128) + (kk % 4) * 32;
      mma3_ss<TILE>(sacc, s_qhi + a, s_qlo + a, st + o, st + TH + o, kk > 0);
      mma3_ss<TILE>(pacc, s_ghi + a, s_glo + a, st + 2 * TH + o,
                    st + 3 * TH + o, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);

    // dS in place of dP
    const int kv0 = t * TILE;
    const bool mask = kv0 + TILE > Skv ||
                      (causal && kv0 + TILE - 1 > wg_row0 + q_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = kv0 + 8 * j + 2 * quad + c;
        float p0 = exp2f(fmaf(sacc[4 * j + c], scale_log2, -l0));
        float p1 = exp2f(fmaf(sacc[4 * j + 2 + c], scale_log2, -l1));
        if (mask) {
          if (col >= Skv || (causal && col > r_lo + q_offset)) p0 = 0.0f;
          if (col >= Skv || (causal && col > r_lo + 8 + q_offset)) p1 = 0.0f;
        }
        pacc[4 * j + c] = p0 * (pacc[4 * j + c] - d0);
        pacc[4 * j + 2 + c] = p1 * (pacc[4 * j + 2 + c] - d1);
      }
    }

    // dQ += dS K (K^T K-major along the keys)
    uint32_t dhi[8][4], dlo[8][4];
    split_frag<TILE>(pacc, dhi, dlo);
    fence_regs(adq);
    fence_regs(dhi);
    fence_regs(dlo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = (j / 4) * (D * 128) + (j % 4) * 32;
      mma3_rs<D>(adq, dhi[j], dlo[j], st + 4 * TH + off, st + 5 * TH + off,
                 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adq);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  float* qb = dq + (size_t)(b * H + h) * Sq * D;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = 8 * j + 2 * quad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r_lo + 8 * i >= Sq) continue;
      *reinterpret_cast<float2*>(qb + (size_t)(r_lo + 8 * i) * D + col) =
          make_float2(adq[4 * j + 2 * i] * scale,
                      adq[4 * j + 2 * i + 1] * scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, long long B, long long H, long long KV,
           long long Sq, long long Skv, bool causal, float scale,
           cudaStream_t st) {
  using L = Layout<D>;
  static bool set_dkdv[port::kMaxDevices] = {};
  static bool set_dq[port::kMaxDevices] = {};
  cudaError_t err = port::set_smem_once(set_dkdv, bwd_dkdv_tf32_kernel<D>,
                                        L::DKDV_SMEM);
  if (err == cudaSuccess)
    err = port::set_smem_once(set_dq, bwd_dq_tf32_kernel<D>, L::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long Sqp = bwd_tc::padded_rows(Sq);
  const long long rows = B * H * Sqp;
  const long long nm = (Sq + BIG - 1) / BIG;
  const long long g0 = (rows * (D / 4) + PREP_THREADS - 1) / PREP_THREADS;
  const long long g1 = (Skv + BIG - 1) / BIG * B * KV;
  const long long g2 = nm * B * H;
  if (g0 > 0x7fffffffLL || g1 > 0x7fffffffLL || g2 > 0x7fffffffLL ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  const float sl2 = scale * tf32::LOG2E;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tg = static_cast<const float*>(dout);
  prep_kernel<D><<<(unsigned)g0, PREP_THREADS, 0, st>>>(
      static_cast<const float*>(o), tg, lse, lse2, delta, rows, (int)Sq,
      (int)Sqp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_tf32_kernel<D><<<(unsigned)g1, THREADS, L::DKDV_SMEM, st>>>(
      tq, tk, tv, tg, lse2, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), (int)B, (int)H, (int)KV, (int)Sq, (int)Skv,
      (int)Sqp, causal, scale, sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_tf32_kernel<D><<<(unsigned)g2, THREADS, L::DQ_SMEM, st>>>(
      tq, tk, tv, tg, lse2, delta, static_cast<float*>(dq), (int)B, (int)H,
      (int)KV, (int)Sq, (int)Skv, (int)Sqp, (int)nm, causal, scale, sl2);
  return (int)cudaGetLastError();
}

}  // namespace bwd_tf32

// One slice of `flash_attention_bwd`: pointers at its first batch.
int bwd_slice(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* scratch, void* dq,
              void* dk, void* dv, int dtype, long long B, long long H,
              long long KV, long long Sq, long long Skv, long long D,
              bool causal, float scale, cudaStream_t st) {
  int err = (int)cudaErrorInvalidValue;
  Body body = kBodies;
#define BWD_ARGS q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, KV, Sq, \
                 Skv, causal, scale, st
  if (dtype == 0 && D == 32) {
    body = kBwdTf32;
    err = bwd_tf32::launch<32>(BWD_ARGS);
  } else if (dtype == 0 && (D == 64 || D == 128)) {
    body = kBwdCudaCores;
    err = D == 64 ? bwd::launch_bwd<float, 64>(BWD_ARGS)
                  : bwd::launch_bwd<float, 128>(BWD_ARGS);
  } else if (dtype == 1 && (D == 64 || D == 128)) {
    body = kBwdWgmma;
    err = D == 64 ? bwd_tc::launch<64>(BWD_ARGS)
                  : bwd_tc::launch<128>(BWD_ARGS);
  } else if (dtype == 1 && D == 32) {
    body = kBwdCudaCores;
    err = bwd::launch_bwd<__nv_bfloat16, 32>(BWD_ARGS);
  }
#undef BWD_ARGS
  if (err == 0) ++body_launches[body];
  return err;
}

}  // namespace

// Floats of the fp32 scratch `flash_attention_bwd` takes as `delta`: two
// arrays (lse * log2 e and Delta) of B * H * Sq rows, Sq rounded up to a
// multiple of bwd_tc::PAD; the CUDA-core body uses the first B * H * Sq.
extern "C" long long flash_attention_bwd_scratch_floats(long long B,
                                                         long long H,
                                                         long long Sq) {
  return 2 * B * H * bwd_tc::padded_rows(Sq);
}

// The backward of `flash_attention_fwd`: q, o, dout, dq (B, H, Sq, D); k,
// v, dk, dv (B, KV, Skv, D); lse (B, H, Sq) fp32 as the forward wrote it;
// delta an fp32 scratch of `flash_attention_bwd_scratch_floats(B, H, Sq)`
// floats; all contiguous on one device, of one type (dtype 0 fp32, 1
// bf16), D in {32, 64, 128}, H % KV == 0, any B >= 1. Every element of
// dq, dk and dv is written. Three launches on `stream` a slice of at most
// 65,535 batches (bf16 at D 64 and 128 and fp32 at D 32 on the tensor
// cores, else on the CUDA cores); returns the first cudaError_t that is
// not cudaSuccess, else cudaSuccess.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int dtype, long long B,
                                   long long H, long long KV, long long Sq,
                                   long long Skv, long long D, int causal,
                                   float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      H > 65535 || KV > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  for (long long b0 = 0; b0 < B; b0 += kBatchSlice) {
    const long long nb = B - b0 < kBatchSlice ? B - b0 : kBatchSlice;
    const long long qo = b0 * H * Sq * D * es, ko = b0 * KV * Skv * D * es;
    const char* cq = static_cast<const char*>(q);
    const char* ck = static_cast<const char*>(k);
    const char* cv = static_cast<const char*>(v);
    const char* co = static_cast<const char*>(o);
    const char* cg = static_cast<const char*>(dout);
    const int err = bwd_slice(
        cq + qo, ck + ko, cv + ko, co + qo, cg + qo, lse + b0 * H * Sq, delta,
        static_cast<char*>(dq) + qo, static_cast<char*>(dk) + ko,
        static_cast<char*>(dv) + ko, dtype, nb, H, KV, Sq, Skv, D,
        causal != 0, scale, (cudaStream_t)stream);
    if (err != 0) return err;
  }
  return 0;
}
