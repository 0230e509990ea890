// Split-K single-token decode attention (FlashDecoding partials), GQA,
// fp32 or bf16 caches, for sm_90a.
//
// Replaces the TPU kernel of src/repro/kernels/flash_decode/flash_decode.py:
// `_kernel`, launched by `flash_decode_partials`. The same function: the
// cache's S columns are cut into ns = ceil(S / bs) splits; for each
// (b, query head h, split) the kernel writes the split's softmax partials
//   m   = max of the split's logits (-inf when none is valid),
//   l   = sum of exp(logit - m),
//   acc = sum of exp(logit - m) * v (unnormalised), D wide,
// all fp32, with logit = (scale * q) . k, scale = D**-0.5 folded into q
// in fp32, and every column at or past cache_len masked (the last split
// may be ragged: columns past S do not exist). Query head h reads
// key/value head h / G, G = H / KV. The merge of the partials by
// log-sum-exp weights runs in torch (kernels/flash_decode/ops.py), as it
// ran outside the Pallas kernel.
//
// Layout of one launch: grid (ns, KV, B), THREADS threads. A block owns
// one split of one key/value head and computes the partials of all G
// query heads that read it, so each cache row is read from memory once
// (the TPU grid had one step per query head). Per block:
//   1. scaled q of the G heads -> shared memory;
//   2. scores: warp w takes rows w, w + 8, ...; lane t holds the
//      elements d = t + 32*e of the row and of each head's q, sums its
//      products in ascending e, and a butterfly gives every lane the row's
//      G logits; masked rows are not read;
//   3. per head (one warp each): the split's max, p = exp(s - m) in place,
//      and l, by strided loops and butterflies;
//   4. acc: thread (r, d) sums p * v[row][d] over rows r, r + R, ...
//      (R = THREADS / D), for up to GMAX heads per pass over v, and the R
//      partial sums are added in order through shared memory.
//
// What bounds it on an H100 SXM: bytes. Per call B*KV*min(S, cache_len)
// rows of k and v are read once (2*D elements each) plus q, and the
// partials are written: 4 FLOPs per (head, column, d) are ~2*G FLOPs a
// cache byte in bf16, far below the card's ~295 FLOPs a byte.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;                 // heads per pass over v

using port::to_f;

template <class T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ acc_out,
                    int H, int KV, int S, int cache_len, int bs,
                    float scale) {
  constexpr int VPL = D / 32;           // row elements per lane
  constexpr int R = THREADS / D;        // row groups of the acc pass
  extern __shared__ __align__(16) float smem[];
  const int G = H / KV;
  const int ns = gridDim.x;
  float* qs = smem;                     // [G][D]
  float* sc = qs + G * D;               // [G][bs]: logits, then p
  float* red = sc + G * bs;             // [R][GMAX][D]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = split * bs;
  const int valid_end = min(S, cache_len);
  const int nvalid = max(0, min(bs, valid_end - c0));  // rows to read
  const int ncols = min(bs, S - c0);                   // rows that exist
  const T* kb = kc + ((size_t)(b * KV + kvh) * S) * D;
  const T* vb = vc + ((size_t)(b * KV + kvh) * S) * D;

  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    qs[e] = to_f(q[((size_t)b * H + kvh * G + g) * D + d]) * scale;
  }
  __syncthreads();

  for (int j = warp; j < ncols; j += WARPS) {
    if (j >= nvalid) {                  // warp-uniform
      if (lane == 0)
        for (int g = 0; g < G; ++g) sc[g * bs + j] = -CUDART_INF_F;
      continue;
    }
    float kv[VPL];
#pragma unroll
    for (int e = 0; e < VPL; ++e)
      kv[e] = to_f(kb[(size_t)(c0 + j) * D + lane + 32 * e]);
    for (int g = 0; g < G; ++g) {
      float part = 0.0f;
#pragma unroll
      for (int e = 0; e < VPL; ++e)
        part = fmaf(qs[g * D + lane + 32 * e], kv[e], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) sc[g * bs + j] = part;
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += WARPS) {
    float* s = sc + g * bs;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < ncols; j += 32) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_safe = mx == -CUDART_INF_F ? 0.0f : mx;
    float sum = 0.0f;
    for (int j = lane; j < ncols; j += 32) {
      const float p = s[j] == -CUDART_INF_F ? 0.0f : expf(s[j] - m_safe);
      s[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const size_t o = ((size_t)b * H + kvh * G + g) * ns + split;
      m_out[o] = mx;
      l_out[o] = sum;
    }
  }
  __syncthreads();

  const int r = tid / D;
  const int d = tid % D;
  for (int g0 = 0; g0 < G; g0 += GMAX) {
    const int gn = min(GMAX, G - g0);
    float a[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) a[g] = 0.0f;
    for (int j = r; j < nvalid; j += R) {
      const float vv = to_f(vb[(size_t)(c0 + j) * D + d]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < gn) a[g] = fmaf(sc[(g0 + g) * bs + j], vv, a[g]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < gn) red[(r * GMAX + g) * D + d] = a[g];
    __syncthreads();
    if (r == 0) {
      for (int g = 0; g < gn; ++g) {
        float t = red[g * D + d];
        for (int rr = 1; rr < R; ++rr) t += red[(rr * GMAX + g) * D + d];
        acc_out[(((size_t)b * H + kvh * G + g0 + g) * ns + split) * D + d] =
            t;
      }
    }
    __syncthreads();
  }
}

template <class T, int D>
int launch(const void* q, const void* kc, const void* vc, float* m,
           float* l, float* acc, long long B, long long H, long long KV,
           long long S, long long cache_len, long long bs, float scale,
           cudaStream_t st) {
  const long long G = H / KV;
  const long long smem =
      (G * D + G * bs + (long long)(THREADS / D) * GMAX * D) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + bs - 1) / bs), (unsigned)KV, (unsigned)B);
  flash_decode_kernel<T, D><<<grid, THREADS, (size_t)smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), m, l, acc, (int)H, (int)KV, (int)S,
      (int)cache_len, (int)bs, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_d(const void* q, const void* kc, const void* vc, float* m,
             float* l, float* acc, long long B, long long H, long long KV,
             long long S, long long D, long long cache_len, long long bs,
             float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kc, vc, m, l, acc, B, H, KV, S, cache_len, bs,
                           scale, st);
    case 64:
      return launch<T, 64>(q, kc, vc, m, l, acc, B, H, KV, S, cache_len, bs,
                           scale, st);
    case 128:
      return launch<T, 128>(q, kc, vc, m, l, acc, B, H, KV, S, cache_len,
                            bs, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D), k_cache/v_cache (B, KV, S, D), contiguous, of one type:
// dtype 0 = fp32, 1 = bf16. m/l (B, H, ns) and acc (B, H, ns, D) fp32,
// ns = ceil(S / bs). D in {32, 64, 128}; H % KV == 0; columns at or past
// cache_len are masked. Returns cudaGetLastError().
extern "C" int flash_decode_partials(const void* q, const void* kc,
                                     const void* vc, float* m, float* l,
                                     float* acc, int dtype, long long B,
                                     long long H, long long KV, long long S,
                                     long long D, long long cache_len,
                                     long long bs, float scale,
                                     void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || bs < 1 ||
      cache_len < 0 || KV > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, kc, vc, m, l, acc, B, H, KV, S, D, cache_len,
                           bs, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, kc, vc, m, l, acc, B, H, KV, S, D,
                                   cache_len, bs, scale, st);
  return (int)cudaErrorInvalidValue;
}
