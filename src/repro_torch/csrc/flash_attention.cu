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
//   - scale = D**-0.5 is folded into q once, in fp32; logits, the running
//     (m, l, acc) and every product are fp32 whatever the input type; the
//     output is rounded once to the input type.
//
// Layout of one launch: grid (ceil(Sq / BQ), H, B), THREADS threads. A
// block owns BQ query rows of one (b, h): their scaled q in shared
// memory, the running max m and sum l of each row and its D-wide
// accumulator in registers. It streams the key/value rows in BK-row
// tiles through shared memory (widened to fp32 as staged) and, per tile,
//   1. scores: thread (ty, tx) owns rows ty*RPT.. and columns tx + 16*j,
//      each score one ascending-d fmaf chain;
//   2. masks, and updates (m, l, acc) with the tile's row max (a 16-lane
//      butterfly; every lane of a row gets the same bits);
//   3. writes p = exp(s - m) to shared memory and adds p . v to its acc
//      columns tx + 16*dd.
// Under the causal mask a block stops at the last tile any of its rows
// can see (a skipped tile would leave (m, l, acc) unchanged).
//
// What bounds it on an H100 SXM: the larger of
//   bytes:      B*H*Sq*D (q) + 2*B*KV*Skv*D (k, v) + B*H*Sq*D (out), in
//               the input type, over 3.35 TB/s;
//   operations: 4*B*H*Sq*Skv*D FLOPs (half of that under the causal
//               mask), over 67 TFLOP/s in fp32 or 989 TFLOP/s in bf16 on
//               the tensor cores.
// Attention at these shapes is operation-bound. This kernel runs every
// product on the CUDA cores in fp32 (for bf16 too: the function of the
// Pallas kernel, which computes in fp32), so it is far from the bf16
// bound; wgmma tiles are the later step.
#include <math_constants.h>

#include "common.cuh"

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
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Skv, bool causal, float scale) {
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
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long H, long long KV, long long Sq, long long Skv,
           bool causal, float scale, cudaStream_t st) {
  const int smem = (int)sizeof(Smem<D>);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)H, (int)KV, (int)Sq,
      (int)Skv, causal, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             long long B, long long H, long long KV, long long Sq,
             long long Skv, long long D, bool causal, float scale,
             cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, causal, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KV, Skv, D), o (B, H, Sq, D), all contiguous
// on one device, of one type: dtype 0 = fp32, 1 = bf16. D in {32, 64,
// 128}; H % KV == 0. Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype,
                                   long long B, long long H, long long KV,
                                   long long Sq, long long Skv, long long D,
                                   int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, H, KV, Sq, Skv, D, causal != 0,
                           scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, D,
                                   causal != 0, scale, st);
  return (int)cudaErrorInvalidValue;
}
