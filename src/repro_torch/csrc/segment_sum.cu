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
// into chunks of at most 256 edges (plain.CHUNK). Then
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
// stay as the wrapper zeroed them. The gradient of x is the same kernel
// over the plan's other order (edges by src, gathering the cotangent's
// row dst).
//
// What bounds it on an H100 SXM: bytes. Each slot reads one row of x and
// one of w (D * 4 bytes each) and two 4-byte indices; each output row is
// written once. 2 FLOPs an element.

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
