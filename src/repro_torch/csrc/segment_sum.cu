// Gather-segment-sum: SchNet's message passing and readout on the card.
//
//   out[d, :] = sum over edges e with dst[e] = d of x[src[e], :] * w[e, :]
//
// Replaces no Pallas kernel: repro leaves this to XLA, as
// `jax.ops.segment_sum(jnp.take(h, src, axis=0) * w, dst, n)`
// (src/repro/models/schnet.py:99-100, the cfconv aggregation; :135, the
// energy readout; and the VJP of the atom embedding's `jnp.take`, :113).
// The plain translation, `index_add_`, adds with float atomics, so a
// gradient would change from run to run and a resumed run would not
// repeat an uninterrupted one bit for bit. This kernel sums in a fixed
// order, with no atomics.
//
// The wrapper's index work (kernels/segment_sum/plain.EdgePlan, once a
// batch) sorts the edges stably by output row and cuts each row's run
// into chunks of at most 256 edges (plain.CHUNK). The forward
// (`gather_segment_sum_fwd`, over the plan's dst order):
//   gss_chunks: a warp a chunk, lanes over D (two columns a lane, 64 a
//     pass), sums its slots' x[gather] * w[edge] in slot order from 0,
//     one rounded product and one rounded add a slot (__fmul_rn then
//     __fadd_rn: no FMA contraction), and writes the row where the chunk
//     is its row's only one, else an fp32 partial. A slot's gather index
//     of -1 reads a row of NaN (jnp.take's fill for an out-of-range src).
//     The slots' indices come 32 at a time, one a lane, and go round by
//     __shfl_sync, so each slot costs two row loads, not two index loads
//     on the warp's critical path;
//   gss_rows: a warp a row of several chunks sums its partials in order,
//     from 0, and writes the row.
// A hot row (a sampled batch pads with the edge (0, 0), so node 0 may
// receive most of a batch's edges) is then many chunks in parallel and
// one short sum, not one warp walking every edge. Rows no edge reaches
// stay as the wrapper zeroed them.
//
// The backward (`gather_segment_sum_bwd`) is the VJP of the forward's
// function against the cotangent g, both gradients in one pass over the
// plan's src order:
//   dx[s] = sum over the edges e with src s of g[dst[e]] * w[e]
//   dw[e] = x[src[e]] * g[dst[e]]
//   gss_bwd_chunks: a lane group a chunk (16 lanes of float4 where D is a
//     multiple of 4 and the rows 16-byte aligned, else a warp of floats),
//     a block a run of 256 chunks, 16 lane groups taking them in turn
//     (fewer where the plan has long chunks: a hot row's chunks of 256
//     edges then each get a lane group, not one group 16 of them).
//     The group loads x[src] once (the chunk's row), adds its slots'
//     g[gather] * w[edge] in slot order, as the forward does (so dx
//     equals the forward body over this order bit for bit), and writes
//     each slot's dw row, one rounded product. It writes zero into the
//     rows between its row and the previous chunk's, so dx needs no
//     memset (the wrapper zeroes dx instead only where the plan leaves a
//     run of more than 64 such rows). Blocks past the chunks' give the
//     edges outside the order (an out-of-range src: a NaN row; a dropped
//     dst: x[src] * 0) their dw rows;
//   gss_rows: as in the forward, for the rows of several chunks.
// SchNet's edges are uniform in src: at ogb_products' 2^22-edge chunks
// the src order has ~2 edges a row, so a warp a chunk (the forward's
// body) would leave most lanes idle; here two chunks share a warp and a
// small register budget (48 at float4) keeps many chunks in flight. Also
// measured on the card and dropped: staging a block's indices in shared
// memory (<= 1% faster), loading 2-8 slots' rows before their adds
// (slower: registers cost more chunks in flight than the loads saved).
//
// What bounds it on an H100 SXM: bytes. The forward reads one row of x
// and one of w (D * 4 bytes each) and two 4-byte indices a slot and
// writes each output row once; the backward reads a row of g and of w a
// slot, a row of x a chunk, and writes dx once and a dw row a slot. 2
// FLOPs an element.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int GSS_THREADS = 256;
constexpr int GSS_WARPS = GSS_THREADS / 32;
constexpr int GSS_COLS = 64;            // columns a warp holds (2 a lane)
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(GSS_THREADS)
gss_chunks(const float* __restrict__ x, int D,
           const int* __restrict__ gather, const float* __restrict__ w,
           const int* __restrict__ edge, const int* __restrict__ start,
           const int* __restrict__ count, const int* __restrict__ key,
           const int* __restrict__ part, long long C,
           float* __restrict__ out, float* __restrict__ partial) {
  const long long c =
      (long long)blockIdx.x * GSS_WARPS + threadIdx.x / 32;
  if (c >= C) return;                   // uniform across the warp
  const int lane = threadIdx.x % 32;
  const int s0 = start[c];
  const int n = count[c];
  const int p = part[c];
  const float nan = __int_as_float(0x7fc00000);
  for (int c0 = 0; c0 < D; c0 += GSS_COLS) {
    const int d0 = c0 + lane;
    const int d1 = c0 + lane + 32;
    const bool in0 = d0 < D;
    const bool in1 = d1 < D;
    float a0 = 0.0f;
    float a1 = 0.0f;
    for (int b = 0; b < n; b += 32) {
      const int m = min(32, n - b);
      int my_g = 0;
      int my_e = 0;
      if (lane < m) {
        my_g = gather[s0 + b + lane];
        if (w != nullptr) my_e = edge[s0 + b + lane];
      }
#pragma unroll 4
      for (int t = 0; t < m; ++t) {
        const int g = __shfl_sync(FULL_MASK, my_g, t);
        const int e = __shfl_sync(FULL_MASK, my_e, t);
        float v0 = nan;
        float v1 = nan;
        if (g >= 0) {
          const float* xr = x + (long long)g * D;
          if (in0) v0 = xr[d0];
          if (in1) v1 = xr[d1];
        }
        if (w != nullptr) {
          const float* wr = w + (long long)e * D;
          if (in0) v0 = __fmul_rn(v0, wr[d0]);
          if (in1) v1 = __fmul_rn(v1, wr[d1]);
        }
        a0 = __fadd_rn(a0, v0);
        a1 = __fadd_rn(a1, v1);
      }
    }
    float* o = p < 0 ? out + (long long)key[c] * D
                     : partial + (long long)p * D;
    if (in0) o[d0] = a0;
    if (in1) o[d1] = a1;
  }
}

__global__ void __launch_bounds__(GSS_THREADS)
gss_rows(const float* __restrict__ partial, const int* __restrict__ first,
         const int* __restrict__ cnt, const int* __restrict__ key,
         long long M, int D, float* __restrict__ out) {
  const long long r =
      (long long)blockIdx.x * GSS_WARPS + threadIdx.x / 32;
  if (r >= M) return;
  const int lane = threadIdx.x % 32;
  const float* p = partial + (long long)first[r] * D;
  const int n = cnt[r];
  float* o = out + (long long)key[r] * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, p[(long long)j * D + d]);
    o[d] = acc;
  }
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
constexpr int BWD_THREADS = 256;
constexpr int BWD_CHUNKS = 256;         // chunks a block walks, at most
constexpr int BWD_SLOTS = 256;          // slots a lane group walks, about

// a lane's VEC columns of a row: float4 (16 lanes a 64-column pass) or
// float (32 lanes a 32-column pass)
template <int VEC>
struct Cols;

template <>
struct Cols<4> {
  using T = float4;
  static constexpr int LANES = 16;
  static __device__ __forceinline__ T ld(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T ld_once(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void st(float* p, T v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  static __device__ __forceinline__ T all(float f) {
    return make_float4(f, f, f, f);
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                       __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
};

template <>
struct Cols<1> {
  using T = float;
  static constexpr int LANES = 32;
  static __device__ __forceinline__ T ld(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T ld_once(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void st(float* p, T v) { __stcs(p, v); }
  static __device__ __forceinline__ T all(float f) { return f; }
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
};

struct BwdArgs {
  const float* h;          // (n_rows, D) x of the forward; null without dw
  const float* g;          // (rows of the cotangent, D)
  const float* w;          // (E, D) or null: unit weights
  int D;
  const int* gather;       // per slot: its row of g (the edge's dst)
  const int* edge;         // per slot: its edge
  const int* start;        // per chunk: first slot, length, row, partial
  const int* count;
  const int* key;
  const int* part;
  long long C;
  int run;                 // chunks a block walks
  long long chunk_blocks;  // blocks of chunks; the rest do the tail
  float* dx;               // (n_rows, D) or null: no dx
  float* partial;          // the multi-chunk rows' partials
  long long n_rows;
  bool fill;               // zero the rows no chunk reaches
  float* dw;               // (E, D) or null: no dw
  const int* skip;         // the edges outside the order (dw only)
  long long n_skip;
  const int* src;          // per edge: its row of h, -1 out of range
  const int* dst;          // per edge: its row of g, -1 dropped
};

template <int VEC>
__device__ __forceinline__ void zero_rows(float* dx, long long lo,
                                          long long hi, int D, int col) {
  using V = Cols<VEC>;
  for (long long r = lo; r < hi; ++r) V::st(dx + r * D + col, V::all(0.0f));
}

template <int VEC>
__global__ void __launch_bounds__(BWD_THREADS)
gss_bwd_chunks(BwdArgs a) {
  using V = Cols<VEC>;
  using T = typename V::T;
  constexpr int LANES = V::LANES;
  constexpr int GROUPS = BWD_THREADS / LANES;
  constexpr int PASS = VEC * LANES;
  const int D = a.D;
  const int grp = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const float nan = __int_as_float(0x7fc00000);

  if (blockIdx.x >= a.chunk_blocks) {   // the tail: dw of skipped edges
    const long long t =
        (long long)(blockIdx.x - a.chunk_blocks) * GROUPS + grp;
    if (t >= a.n_skip) return;
    const int e = a.skip[t];
    const int s = a.src[e];
    const int d = a.dst[e];
    for (int col = lane * VEC; col < D; col += PASS) {
      const T hv = s >= 0 ? V::ld(a.h + (long long)s * D + col) : V::all(nan);
      const T gv = d >= 0 ? V::ld(a.g + (long long)d * D + col)
                          : V::all(0.0f);
      V::st(a.dw + (long long)e * D + col, V::mul(hv, gv));
    }
    return;
  }

  const long long c0 = (long long)blockIdx.x * a.run;
  const long long c1 = min(c0 + a.run, a.C);
  for (long long c = c0 + grp; c < c1; c += GROUPS) {
    const int row = a.key[c];
    const int n = a.count[c];
    const int first = a.start[c];
    const int p = a.part[c];
    const int prev = c > 0 ? a.key[c - 1] : -1;
    for (int col = lane * VEC; col < D; col += PASS) {
      const T hv = a.dw != nullptr
                       ? V::ld_once(a.h + (long long)row * D + col)
                       : V::all(0.0f);
      T acc = V::all(0.0f);
      for (int s = first; s < first + n; ++s) {
        const int gi = a.gather[s];
        const int e = a.edge[s];
        const T gv = gi >= 0 ? V::ld(a.g + (long long)gi * D + col)
                             : V::all(nan);
        if (a.dx != nullptr)
          acc = V::add(acc, a.w != nullptr
                                ? V::mul(gv, V::ld_once(a.w + (long long)e * D
                                                        + col))
                                : gv);
        if (a.dw != nullptr)
          V::st(a.dw + (long long)e * D + col, V::mul(hv, gv));
      }
      if (a.dx == nullptr) continue;
      V::st((p < 0 ? a.dx + (long long)row * D : a.partial + (long long)p * D)
                + col, acc);
      if (a.fill) {
        if (prev != row) zero_rows<VEC>(a.dx, prev + 1, row, D, col);
        if (c == a.C - 1) zero_rows<VEC>(a.dx, row + 1, a.n_rows, D, col);
      }
    }
  }
}

}  // namespace

// The sums of one order of an EdgePlan: x (rows, D) fp32 contiguous; w
// (E, D) fp32 contiguous, or null for unit weights; per sorted slot its
// row of x (`gather`, -1 = a NaN row) and its edge (`edge`, its row of
// w); C chunks (`start`, `count`, output row `key`, `part` -1 or the
// chunk's partial) and M rows of several chunks (`mfirst`, `mcount`,
// `mkey`), `partial` an fp32 scratch of one D row a partial; out (n_out,
// D) fp32, zeroed by the caller, written at every row a chunk reaches.
// Two launches on `stream`; returns the last cudaError_t.
extern "C" int gather_segment_sum_fwd(
    const float* x, long long D, const int* gather, const float* w,
    const int* edge, const int* start, const int* count, const int* key,
    const int* part, long long C, const int* mfirst, const int* mcount,
    const int* mkey, long long M, float* partial, float* out,
    void* stream) {
  if (D < 1 || D > (1LL << 30) || C < 0 || M < 0)
    return (int)cudaErrorInvalidValue;
  const long long g1 = (C + GSS_WARPS - 1) / GSS_WARPS;
  const long long g2 = (M + GSS_WARPS - 1) / GSS_WARPS;
  if (g1 > 0x7fffffffLL || g2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (g1 > 0)
    gss_chunks<<<(unsigned)g1, GSS_THREADS, 0, st>>>(
        x, (int)D, gather, w, edge, start, count, key, part, C, out,
        partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g2 == 0) return (int)err;
  gss_rows<<<(unsigned)g2, GSS_THREADS, 0, st>>>(partial, mfirst, mcount,
                                                  mkey, M, (int)D, out);
  return (int)cudaGetLastError();
}


// Both gradients of `gather_segment_sum_fwd` over an EdgePlan's src order
// (`plan.bwd`: its slots gather the cotangent's rows, its chunks' keys are
// rows of x), against the cotangent g (rows, D) fp32 contiguous:
//   dx (n_rows, D): each chunk sums g[gather] * w[edge] (g[gather] where w
//     is null) over its slots in order from 0, a rounded product and a
//     rounded add a slot; rows of several chunks sum their partials in
//     order (`mfirst`, `mcount`, `mkey`, scratch `partial`). `longest`:
//     the most slots of a chunk (`plan.bwd["longest"]`). With `fill`
//     the kernel writes every row of dx (zero where no chunk lands), else
//     the caller zeroed it. Null: no dx.
//   dw (E, D): dw[e] = h[src[e]] * g[dst[e]], one rounded product, over
//     the order's slots and the `n_skip` edges of `skip` (the edges the
//     order leaves out: src -1 reads a NaN row of h, dst -1 a zero row of
//     g). Null: no dw (h may then be null).
// Two launches on `stream` (one without dx or without multi-chunk rows);
// returns the last cudaError_t.
extern "C" int gather_segment_sum_bwd(
    const float* h, const float* g, const float* w, long long D,
    const int* gather, const int* edge, const int* start, const int* count,
    const int* key, const int* part, long long C, long long longest,
    const int* mfirst,
    const int* mcount, const int* mkey, long long M, float* partial,
    float* dx, long long n_rows, int fill, const int* skip,
    long long n_skip, const int* src, const int* dst, float* dw,
    void* stream) {
  if (D < 1 || D > (1LL << 30) || C < 0 || M < 0 || n_skip < 0 ||
      longest < 0 || (dw != nullptr && h == nullptr))
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return ((unsigned long long)p & 15ULL) == 0;
  };
  const bool vec4 = D % 4 == 0 && aligned(h) && aligned(g) && aligned(w) &&
                    aligned(dx) && aligned(partial) && aligned(dw);
  const int groups = BWD_THREADS / (vec4 ? Cols<4>::LANES : Cols<1>::LANES);
  // a block's run of chunks: up to BWD_CHUNKS, fewer where chunks are long
  // (a hot row's), so that no lane group walks many more than BWD_SLOTS
  // slots one after the other
  const long long per_group =
      longest > 0 ? BWD_SLOTS / longest : BWD_CHUNKS;
  const int run = groups * (int)std::max(
      1LL, std::min<long long>(BWD_CHUNKS / groups, per_group));
  BwdArgs a{h, g, w, (int)D, gather, edge, start, count, key, part, C, run,
            (C + run - 1) / run, dx, partial, n_rows, fill != 0, dw, skip,
            n_skip, src, dst};
  const long long tail = dw != nullptr ? (n_skip + groups - 1) / groups : 0;
  const long long g1 = a.chunk_blocks + tail;
  const long long g2 = dx != nullptr ? (M + GSS_WARPS - 1) / GSS_WARPS : 0;
  if (g1 > 0x7fffffffLL || g2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (g1 > 0) {
    if (vec4)
      gss_bwd_chunks<4><<<(unsigned)g1, BWD_THREADS, 0, st>>>(a);
    else
      gss_bwd_chunks<1><<<(unsigned)g1, BWD_THREADS, 0, st>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g2 == 0) return (int)err;
  gss_rows<<<(unsigned)g2, GSS_THREADS, 0, st>>>(partial, mfirst, mcount,
                                                  mkey, M, (int)D, dx);
  return (int)cudaGetLastError();
}
