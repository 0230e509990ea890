// Split-K single-token decode attention (FlashDecoding), GQA, fp32 or bf16
// caches, for sm_90a: the split partials and, in the same call, their merge.
//
// Replaces the TPU kernel of src/repro/kernels/flash_decode/flash_decode.py:
// `_kernel`, launched by `flash_decode_partials`. The same function: the
// cache's columns are cut into splits of bs; for each (b, query head h,
// split) the partials kernel computes
//   m   = max of the split's logits (-inf when none is valid),
//   l   = sum of exp(logit - m),
//   acc = sum of exp(logit - m) * v (unnormalised), D wide,
// all fp32, with logit = (scale * q) . k, scale = D**-0.5 folded into q
// in fp32, and every column at or past cache_len masked (the last split
// may be ragged: columns past S do not exist). Query head h reads
// key/value head h / G, G = H / KV. The merge kernel then combines a
// (b, h)'s splits in split order by log-sum-exp weights (repro's
// `merge_partials`, which ran outside the Pallas kernel) and writes the
// (B, H, D) output, rounded once to q's type. `flash_decode_fwd` launches
// both on one stream; with no output pointer it stops at the partials
// (the wrapper's `flash_decode_partials`, which the checks hold to the
// plain partials).
//
// Layout of the partials kernel: grid (ns, KV * G / GC, B), THREADS
// threads. A block owns one split of one key/value head and GC of the G
// query heads that read it (GC: the largest of 8, 4, 2, 1 that divides
// G), so each cache row is read from memory once for GC heads. The split's K and V
// rows are contiguous in the cache: one thread streams them, TILE rows at
// a time, through a ring of STAGES shared-memory stages with 1-d bulk
// copies (cp.async.bulk) completing on an mbarrier each, STAGES - 1 tiles
// ahead of the compute. Each row is read by LPR lanes, 16 bytes a lane
// (a row group; a warp holds 32 / LPR of them); a row group keeps an
// online softmax (m, l, acc) for its GC heads over the rows it takes
// (rows rg, rg + NRG, ... of each tile): logits by a butterfly over its
// lanes, one max update and rescale per tile. At the end the row groups
// merge, within a warp by shuffles and across warps through shared
// memory, in a fixed order, into the split's partials.
//
// What bounds it on an H100 SXM: bytes. Per call B*KV*min(S, cache_len)
// rows of k and v are read once (2*D elements each) plus q, and the
// output is written: 4 FLOPs per (head, column, d) are ~2*G FLOPs a cache
// byte in bf16, far below the card's ~295 FLOPs a byte, so CUDA cores fed
// with 16-byte vectors suffice. The ring keeps ~STAGES * TILE * 2 rows in
// flight a block; the wrapper chooses splits that fill the card at B = 1
// (kernels/flash_decode/ops.py `choose_split`).
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;                // cache rows a ring stage
constexpr int STAGES = 4;

using namespace hopper;
using port::from_f;
using port::to_f;

template <class T, int D, int GC>
struct Cfg {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements a lane reads
  static constexpr int LPR = D / VEC;               // lanes a row
  static constexpr int RPW = 32 / LPR;              // row groups a warp
  static constexpr int NRG = WARPS * RPW;           // row groups a block
  static constexpr int RPG = (TILE + NRG - 1) / NRG;  // rows a group a tile
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  static constexpr int STAGE_BYTES = 2 * TILE * ROW_BYTES;   // K then V
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int MERGE = WARPS * GC * (D + 2) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
};

// 16 bytes of shared memory -> VEC floats
__device__ __forceinline__ void load_vec(const unsigned char* p, float* f,
                                         float) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_vec(const unsigned char* p, float* f,
                                         __nv_bfloat16) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    f[2 * i] = __low2float(h);
    f[2 * i + 1] = __high2float(h);
  }
}

template <class T, int D, int GC>
__global__ void __launch_bounds__(THREADS)
decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                       const T* __restrict__ vc, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ acc_out,
                       int H, int KV, int S, int cache_len, int bs,
                       float scale) {
  using C = Cfg<T, D, GC>;
  constexpr int VEC = C::VEC, LPR = C::LPR, NRG = C::NRG, RPG = C::RPG;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int part = lane % LPR;                  // 16-byte chunk of a row
  const int rg = warp * C::RPW + lane / LPR;    // row group
  const int G = H / KV;
  const int chunks = G / GC;
  const int split = blockIdx.x;
  const int ns = gridDim.x;
  const int kvh = blockIdx.y / chunks;
  const int h0 = kvh * G + (blockIdx.y % chunks) * GC;   // first head
  const int b = blockIdx.z;
  const int c0 = split * bs;
  const int nvalid = max(0, min(bs, min(S, cache_len) - c0));
  const int ntiles = (nvalid + TILE - 1) / TILE;
  const T* kb = kc + ((size_t)(b * KV + kvh) * S + c0) * D;
  const T* vb = vc + ((size_t)(b * KV + kvh) * S + c0) * D;
  const uint32_t ring = smem_u32(smem);
  const uint32_t bar = smem_u32(full);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int t) {
    const int s = t % STAGES;
    const uint32_t bytes =
        (uint32_t)min(TILE, nvalid - t * TILE) * C::ROW_BYTES;
    const uint32_t dst = ring + s * C::STAGE_BYTES;
    mbar_expect_tx(bar + 8 * s, 2 * bytes);
    bulk_load(dst, kb + (size_t)t * TILE * D, bytes, bar + 8 * s);
    bulk_load(dst + TILE * C::ROW_BYTES, vb + (size_t)t * TILE * D, bytes,
              bar + 8 * s);
  };
  if (tid == 0)
    for (int t = 0; t < min(STAGES, ntiles); ++t) issue(t);

  float qf[GC][VEC], acc[GC][VEC], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[g][e] = to_f(q[((size_t)b * H + h0 + g) * D + part * VEC + e]) *
                 scale;
      acc[g][e] = 0.0f;
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar + 8 * s, (t / STAGES) & 1);
    const int rows = min(TILE, nvalid - t * TILE);
    const unsigned char* kt = smem + s * C::STAGE_BYTES;
    const unsigned char* vt = kt + TILE * C::ROW_BYTES;
    float sc[RPG][GC], vf[RPG][VEC];
    bool ok[RPG];
#pragma unroll
    for (int k = 0; k < RPG; ++k) {
      const int r = rg + k * NRG;
      ok[k] = r < rows;
      float kf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = vf[k][e] = 0.0f;
      if (ok[k]) {
        load_vec(kt + r * C::ROW_BYTES + part * 16, kf, T());
        load_vec(vt + r * C::ROW_BYTES + part * 16, vf[k], T());
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float x = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) x = fmaf(qf[g][e], kf[e], x);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        sc[k][g] = ok[k] ? x : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < RPG; ++k) mt = fmaxf(mt, sc[k][g]);
      if (mt == -CUDART_INF_F) continue;        // no row of this group
      const float mn = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - mn);      // 0 while m = -inf
      float ps = 0.0f, a[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = acc[g][e] * alpha;
#pragma unroll
      for (int k = 0; k < RPG; ++k) {
        const float p = ok[k] ? expf(sc[k][g] - mn) : 0.0f;
        ps += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = fmaf(p, vf[k][e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = a[e];
      l[g] = l[g] * alpha + ps;
      m[g] = mn;
    }
    __syncthreads();                            // stage s consumed
    if (tid == 0 && t + STAGES < ntiles) issue(t + STAGES);
  }

  // merge the row groups of a warp (lanes LPR apart hold the same d)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float wa = m[g] == -CUDART_INF_F ? 0.0f : expf(m[g] - mn);
      const float wb = mo == -CUDART_INF_F ? 0.0f : expf(mo - mn);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = wa * acc[g][e] + wb * ao;
      }
      l[g] = wa * l[g] + wb * lo;
      m[g] = mn;
    }
  }
  // then the warps, in warp order, through shared memory
  float* mm = reinterpret_cast<float*>(smem);   // [WARPS][GC]
  float* ll = mm + WARPS * GC;                  // [WARPS][GC]
  float* aa = ll + WARPS * GC;                  // [WARPS][GC][D]
  __syncthreads();                              // the ring is idle
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (part == 0) {
        mm[warp * GC + g] = m[g];
        ll[warp * GC + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        aa[(warp * GC + g) * D + part * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < GC * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = -CUDART_INF_F;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mm[w * GC + g]);
    float sl = 0.0f, sa = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      const float mw = mm[w * GC + g];
      const float wt = mw == -CUDART_INF_F ? 0.0f : expf(mw - mx);
      sl += wt * ll[w * GC + g];
      sa += wt * aa[(w * GC + g) * D + d];
    }
    const size_t o = ((size_t)b * H + h0 + g) * ns + split;
    if (d == 0) {
      m_out[o] = mx;
      l_out[o] = sl;
    }
    acc_out[o * D + d] = sa;
  }
}

// out (B, H, D) from the partials of ns splits, merged in split order:
// w_s = exp(m_s - max m), out = sum w_s acc_s / sum w_s l_s (0 where no
// split holds a valid column).
template <class T>
__global__ void __launch_bounds__(128)
decode_merge_kernel(const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ acc, T* __restrict__ out,
                    int ns, int D) {
  const int bh = blockIdx.x;
  const float* mb = m + (size_t)bh * ns;
  const float* lb = l + (size_t)bh * ns;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, mb[s]);
  const float ms = mx == -CUDART_INF_F ? 0.0f : mx;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.0f, den = 0.0f;
    for (int s = 0; s < ns; ++s) {
      const float w = mb[s] == -CUDART_INF_F ? 0.0f : expf(mb[s] - ms);
      den += w * lb[s];
      num += w * acc[((size_t)bh * ns + s) * D + d];
    }
    out[(size_t)bh * D + d] = from_f<T>(num / (den == 0.0f ? 1.0f : den));
  }
}

template <class T, int D, int GC>
int launch(const void* q, const void* kc, const void* vc, void* out,
           float* m, float* l, float* acc, long long B, long long H,
           long long KV, long long S, long long cache_len, long long bs,
           long long ns, float scale, cudaStream_t st) {
  using C = Cfg<T, D, GC>;
  static bool attr_set[port::kMaxDevices] = {};
  const cudaError_t err = port::set_smem_once(
      attr_set, decode_partials_kernel<T, D, GC>, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ns, (unsigned)(KV * (H / KV) / GC),
                  (unsigned)B);
  decode_partials_kernel<T, D, GC><<<grid, THREADS, C::SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), m, l, acc, (int)H, (int)KV, (int)S,
      (int)cache_len, (int)bs, scale);
  if (out != nullptr) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    decode_merge_kernel<T><<<(unsigned)(B * H), 128, 0, st>>>(
        m, l, acc, static_cast<T*>(out), (int)ns, D);
  }
  return (int)cudaGetLastError();
}

template <class T, int D>
int launch_g(const void* q, const void* kc, const void* vc, void* out,
             float* m, float* l, float* acc, long long B, long long H,
             long long KV, long long S, long long cache_len, long long bs,
             long long ns, float scale, cudaStream_t st) {
  const long long G = H / KV;
#define FD_LAUNCH(GC)                                                    \
  launch<T, D, GC>(q, kc, vc, out, m, l, acc, B, H, KV, S, cache_len, bs, \
                   ns, scale, st)
  if (G % 8 == 0) return FD_LAUNCH(8);
  if (G % 4 == 0) return FD_LAUNCH(4);
  if (G % 2 == 0) return FD_LAUNCH(2);
  return FD_LAUNCH(1);
#undef FD_LAUNCH
}

template <class T>
int launch_d(const void* q, const void* kc, const void* vc, void* out,
             float* m, float* l, float* acc, long long B, long long H,
             long long KV, long long S, long long D, long long cache_len,
             long long bs, long long ns, float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_g<T, 32>(q, kc, vc, out, m, l, acc, B, H, KV, S,
                             cache_len, bs, ns, scale, st);
    case 64:
      return launch_g<T, 64>(q, kc, vc, out, m, l, acc, B, H, KV, S,
                             cache_len, bs, ns, scale, st);
    case 128:
      return launch_g<T, 128>(q, kc, vc, out, m, l, acc, B, H, KV, S,
                              cache_len, bs, ns, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Batches a launch takes: the partials kernel puts the batch on grid z.
constexpr long long kBatchSlice = 65535;

// Partials launches (each with its merge, where one is asked for) made on
// the calling thread: one a slice of at most 65,535 batches.
thread_local long long launches = 0;

}  // namespace

extern "C" long long flash_decode_launches() { return launches; }

// q (B, H, D), k_cache/v_cache (B, KV, S, D), contiguous, the caches
// 16-byte aligned, of one type: dtype 0 = fp32, 1 = bf16. part: fp32 m
// (B, H, ns), then l (B, H, ns), then acc (B, H, ns, D): the partials of
// splits [s * bs, (s + 1) * bs), s < ns (ns * bs may stop short of S
// where the splits past cache_len are not wanted). out (B, H, D) in q's
// type, or NULL for the partials alone. D in {32, 64, 128}; H % KV == 0;
// any B >= 1, in slices of at most 65,535 (the partials kernel's grid z);
// columns at or past cache_len are masked. Returns the first cudaError_t
// that is not cudaSuccess, else cudaSuccess.
extern "C" int flash_decode_fwd(const void* q, const void* kc, const void* vc,
                                void* out, float* part, int dtype,
                                long long B, long long H, long long KV,
                                long long S, long long D, long long cache_len,
                                long long bs, long long ns, float scale,
                                void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || bs < 1 ||
      ns < 1 || ns > 0x7fffffffLL || (ns - 1) * bs >= S || cache_len < 0 ||
      H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) %
      16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const long long es = dtype == 0 ? 4 : 2;
  float* m = part;
  float* l = m + B * H * ns;
  float* acc = l + B * H * ns;
  for (long long b0 = 0; b0 < B; b0 += kBatchSlice) {
    const long long nb = B - b0 < kBatchSlice ? B - b0 : kBatchSlice;
    const char* sq = static_cast<const char*>(q) + b0 * H * D * es;
    const char* sk = static_cast<const char*>(kc) + b0 * KV * S * D * es;
    const char* sv = static_cast<const char*>(vc) + b0 * KV * S * D * es;
    char* so = out == nullptr ? nullptr
                              : static_cast<char*>(out) + b0 * H * D * es;
    const long long po = b0 * H * ns;
    const int err =
        dtype == 0
            ? launch_d<float>(sq, sk, sv, so, m + po, l + po, acc + po * D,
                              nb, H, KV, S, D, cache_len, bs, ns, scale, st)
            : launch_d<__nv_bfloat16>(sq, sk, sv, so, m + po, l + po,
                                      acc + po * D, nb, H, KV, S, D,
                                      cache_len, bs, ns, scale, st);
    if (err != 0) return err;
    ++launches;
  }
  return 0;
}
