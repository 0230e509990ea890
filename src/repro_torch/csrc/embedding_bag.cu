// Multi-hot embedding lookup-reduce (EmbeddingBag) over a group of tables
// in one launch, fp32 or bf16, for sm_90a.
//
// Replaces the TPU kernel of src/repro/kernels/embedding_bag/embedding_bag.py:
// `_kernel`, launched by `embedding_bag_kernel`. The same function, for
// each bag (b, f) of L slots over table f of the group:
//   out[b, f] = sum_j w[b, f, j] * table_f[idx[b, f, j]]   over idx >= 0,
// summed in fp32 in ascending j (one fmaf chain an element), divided by
// max(sum of those w, 1e-9) for the mean combiner, and rounded once to
// the tables' dtype. Every negative id is padding: it adds nothing and
// does not count toward the sum of w, so an all-padding bag is 0. A bag
// holding an id >= V_f is NaN, the row repro's ref gives (`jnp.take`
// fills out-of-range rows with NaN); the kernel checks each id against
// V_f itself and never reads such a row. Every output equals that of the
// one-table kernel this body replaced (one launch a table, one warp a
// bag) bit for bit: the same chain an element, the same sum of w, the
// same division.
//
// One launch covers F <= 64 tables of one dtype and one width D, each a
// (pointer, V) pair passed by value in the kernel's parameters (no copy
// to the device before the launch). The ids (B, F, L) int32 and weights
// (B, F, L) fp32 are read through their (b, f) strides as they lie
// (slots contiguous; null weights are unit weights), and the bags are
// written through the output's own (b, f) strides: DLRM's land in its
// (B, F + 1, D) feature stack after x_bot. F = 1 is the one-table entry
// `embedding_bag_fwd`. Row offsets are 64-bit (idx * D overflows 32 bits
// above 16.8M rows at D = 128).
//
// Layout. A lane group of lpb lanes (the power of two that covers a row
// in 16-byte chunks, at most 32: a 128-wide fp32 row takes a warp, a
// 128-wide bf16 row half of one, so a warp serves two bf16 bags) takes R
// consecutive bags and walks their R * L slots ("items") in order. Lane
// t of the group loads item t's id and weight in one coalesced load a
// window of lpb items, checks the id against its table's V and holds the
// row's address and its bag's output row; __shfl_sync hands each item's
// to the group (the output row rather than a running bag counter: the
// counter's 64-bit offsets cost the 8-row fp32 kernel 12 registers, a
// block an SM and 12-14% at serve_bulk, PERF.md section 6, H100). The group
// issues the row loads of U items (U = 8, or 4 where only 4's registers
// fit the whole grid on the card at once) before it chains the first of
// them, and a one-hot bag window holds R = U bags, so U cold rows are in
// flight a group where the one-table kernel's serial walk had one. Bags
// go in f-major order (bag k is (b, f) = (k % B, k / B)): the blocks in
// flight then read from one or two tables, so a small table stays in L2
// as it did with a launch a table; b-major order interleaved all 26 of
// DLRM's and ran serve_bulk 0.06-0.13 ms slower (PERF.md section 6,
// H100).
//
// What bounds it on an H100 SXM: bytes, and the rate of random row
// reads. A bag reads its valid rows once (D * itemsize each), its ids
// and weights (8 bytes a slot) and writes D * itemsize; two FLOPs a row
// element are far below the ~20 FLOPs a byte at which fp32 compute would
// bound. The rows of a large table are scattered far beyond the 50 MB
// L2, so each read is a cold row of 256 or 512 bytes; a small table (DLRM
// has ten under 1 MB) stays in L2 and costs its size once.
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

// One table of a group: its rows (V x D, contiguous) and V.
struct BagTable {
  const void* data;
  long long rows;
};

constexpr int BAG_MAX_TABLES = 64;

// The group, by value in the kernel's parameters: 64 x 16 = 1 KB of the
// 4 KB a launch may pass.
struct BagGroup {
  BagTable t[BAG_MAX_TABLES];
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

using port::from_f;
using port::to_f;

// A chunk of BYTES bytes as one load or store.
template <int BYTES>
struct Chunk;
template <>
struct Chunk<16> {
  using type = uint4;
};
template <>
struct Chunk<8> {
  using type = uint2;
};
template <>
struct Chunk<4> {
  using type = unsigned int;
};
template <>
struct Chunk<2> {
  using type = unsigned short;
};

// The chunk's bits seen as VEC elements, in registers (a union, not a
// local array that the compiler may put on the stack).
template <class T, int VEC>
union Raw {
  typename Chunk<VEC * (int)sizeof(T)>::type c;
  T t[VEC];
};

template <class T, int VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           float (&x)[VEC]) {
  Raw<T, VEC> raw;
  raw.c = __ldg(reinterpret_cast<const decltype(raw.c)*>(p));
#pragma unroll
  for (int e = 0; e < VEC; ++e) x[e] = to_f(raw.t[e]);
}

template <class T, int VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                            const float (&x)[VEC]) {
  Raw<T, VEC> raw;
#pragma unroll
  for (int e = 0; e < VEC; ++e) raw.t[e] = from_f<T>(x[e]);
  *reinterpret_cast<decltype(raw.c)*>(p) = raw.c;
}

// The launch's shape, by value in the kernel's parameters.
struct Shape {
  long long bags;                 // B * F; bag k is (k % B, k / B)
  long long B;
  long long ids_b, ids_f, w_b, w_f, out_b, out_f;   // strides, elements
  int D, L;
  int R;                          // bags a lane group takes in turn
  int lpb;                        // lanes a bag (a lane group): 1 to 32
  int mean;
};


template <class T, int VEC>
__device__ __forceinline__ void finish(T* __restrict__ p, float (&acc)[VEC],
                                       float wsum, bool out_of_range,
                                       int mean) {
  if (mean) {
    const float den = fmaxf(wsum, 1e-9f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = acc[e] / den;
  }
  if (out_of_range) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = CUDART_NAN_F;
  }
  store_chunk<T, VEC>(p, acc);
}

// A lane group of s.lpb lanes takes the s.R bags bag0 .. bag0 + R - 1 and
// walks their R * L slots ("items") in order, U items at a time: the rows
// of U items are loaded before the first of them is chained. Lane t of
// the group holds item i0 + t's row pointer, state, weight and output
// row, read in one coalesced load of ids and one of weights per lpb
// items.
template <class T, int VEC, int U>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const __grid_constant__ BagGroup g,
                     const int* __restrict__ idx,
                     const float* __restrict__ w, T* __restrict__ out,
                     const Shape s) {
  const int lane = threadIdx.x & 31;
  const int lpb = s.lpb;
  const int gl = lane & (lpb - 1);               // lane within the group
  const int base = lane - gl;                    // the group's first lane
  const unsigned gmask = lpb == 32 ? FULL : ((1u << lpb) - 1u) << base;
  const long long unit =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * (32 / lpb) +
      lane / lpb;
  const long long bag0 = unit * s.R;
  if (bag0 >= s.bags) return;                    // a whole lane group
  const int nb = (int)min((long long)s.R, s.bags - bag0);
  const int items = nb * s.L;
  const int chunks = s.D / VEC;
  for (int c0 = 0; c0 < chunks; c0 += lpb) {
    const int c = c0 + gl;
    const bool mine = c < chunks;
    const long long col = (long long)c * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    float wsum = 0.f;
    bool out_of_range = false;
    // the slot cj of the next item to chain
    int cj = 0;
    if (s.L == 0) {                              // empty bags: 0
      long long cf = bag0 / s.B, cb = bag0 - cf * s.B;
      for (int r = 0; r < nb; ++r) {
        if (mine) store_chunk<T, VEC>(out + cb * s.out_b + cf * s.out_f +
                                      col, acc);
        if (++cb == s.B) cb = 0, ++cf;
      }
      continue;
    }
    for (int i0 = 0; i0 < items; i0 += lpb) {
      const int n = min(lpb, items - i0);
      // state: 0 padding, 1 a row to read, 2 an id >= V (never read)
      const T* my_row = nullptr;
      T* my_out = nullptr;                       // its bag's output row
      int my_st = 0;
      float my_w = 1.f;
      if (gl < n) {
        const int i = i0 + gl, r = i / s.L, j = i - r * s.L;
        const long long bag = bag0 + r, f = bag / s.B, b = bag - f * s.B;
        const int id = __ldg(idx + b * s.ids_b + f * s.ids_f + j);
        my_out = out + b * s.out_b + f * s.out_f;
        if (w) my_w = __ldg(w + b * s.w_b + f * s.w_f + j);
        if (id >= 0) {
          my_st = id < g.t[f].rows ? 1 : 2;
          if (my_st == 1)
            my_row = static_cast<const T*>(g.t[f].data) + (long long)id * s.D;
        }
      }
      for (int s0 = 0; s0 < n; s0 += U) {
        int st[U];
        float x[U][VEC];
        // the U rows' loads first: none waits on another or on an fmaf
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int src = base + ((s0 + u) & (lpb - 1));
          st[u] = __shfl_sync(gmask, my_st, src);
          const T* row = reinterpret_cast<const T*>(__shfl_sync(
              gmask, reinterpret_cast<unsigned long long>(my_row), src));
          if (s0 + u >= n) st[u] = -1;           // past the group's items
          if (mine && st[u] == 1) {
            load_chunk<T, VEC>(row + col, x[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) x[u][e] = 0.f;
          }
        }
        // then the chain, in item order (st[u] is uniform in the group)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float wj =
              __shfl_sync(gmask, my_w, base + ((s0 + u) & (lpb - 1)));
          if (st[u] < 0) break;
          if (st[u] > 0) {                       // not padding
            wsum += wj;
            if (st[u] == 2) {
              out_of_range = true;               // NaN bag, row not read
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[e] = fmaf(wj, x[u][e], acc[e]);
            }
          }
          if (++cj == s.L) {                     // the bag's last slot
            T* o = reinterpret_cast<T*>(__shfl_sync(
                gmask, reinterpret_cast<unsigned long long>(my_out),
                base + ((s0 + u) & (lpb - 1))));
            if (mine)
              finish<T, VEC>(o + col, acc, wsum, out_of_range, s.mean);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
            wsum = 0.f;
            out_of_range = false;
            cj = 0;
          }
        }
      }
    }
  }
}

// `s` with the bags a lane group takes at U items in flight: enough
// one-hot (or few-slot) bags to fill the window, else one.
Shape with_depth(Shape s, int U) {
  s.R = s.L == 0 || s.L >= U ? 1 : U / s.L;
  return s;
}

long long grid_blocks(const Shape& s) {
  const long long units = (s.bags + s.R - 1) / s.R;
  const long long warps = (units + 32 / s.lpb - 1) / (32 / s.lpb);
  return (warps + WARPS - 1) / WARPS;
}

// Blocks of the <T, VEC, U> kernel that the current card holds at once
// (its SMs times the blocks an SM holds at the kernel's registers),
// asked once a device; 0 where the runtime cannot tell.
template <class T, int VEC, int U>
long long resident_blocks() {
  static long long known[port::kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < port::kMaxDevices && known[dev]) return known[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, embedding_bag_kernel<T, VEC, U>, THREADS, 0) !=
          cudaSuccess)
    return 0;
  const long long n = (long long)sms * per_sm;
  if (dev < port::kMaxDevices) known[dev] = n;
  return n;
}

template <class T, int VEC, int U>
bool one_wave(const Shape& s) {
  return grid_blocks(with_depth(s, U)) <= resident_blocks<T, VEC, U>();
}

template <class T, int VEC, int U>
cudaError_t launch(const BagGroup& g, const void* idx, const void* w,
                   void* out, const Shape& shape, cudaStream_t stream) {
  const Shape s = with_depth(shape, U);
  const long long blocks = grid_blocks(s);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embedding_bag_kernel<T, VEC, U><<<(unsigned)blocks, THREADS, 0, stream>>>(
      g, static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<T*>(out), s);
  return cudaGetLastError();
}

// The deeper window, 8 items, unless its grid would need a second wave of
// blocks where 4 items' grid fits the card in one (at L = 100 and B = 4096
// the 8-item kernel's registers leave room for 3 blocks an SM, the 4-item
// kernel's for 4: 512 blocks then run in one wave).
template <class T, int VEC>
cudaError_t launch_depth(const BagGroup& g, const void* idx, const void* w,
                         void* out, const Shape& s, cudaStream_t stream) {
  if (!one_wave<T, VEC, 8>(s) && one_wave<T, VEC, 4>(s))
    return launch<T, VEC, 4>(g, idx, w, out, s, stream);
  return launch<T, VEC, 8>(g, idx, w, out, s, stream);
}

// The widest chunk (16 or 8 bytes, else one element) to which every row
// start (tables and output) is aligned.
int chunk_bytes(const BagTable* tables, int F, const void* out, long long D,
                long long out_b, long long out_f, int es) {
  uintptr_t bits = reinterpret_cast<uintptr_t>(out) |
                   (uintptr_t)(D * es) | (uintptr_t)(out_b * es) |
                   (uintptr_t)(out_f * es);
  for (int i = 0; i < F; ++i)
    bits |= reinterpret_cast<uintptr_t>(tables[i].data);
  return bits % 16 == 0 ? 16 : (bits % 8 == 0 ? 8 : es);
}

}  // namespace

// F tables (`tables`: F (pointer, V) pairs, each (V, D) contiguous of
// `dtype`: 0 fp32, 1 bf16) in one launch. idx (B, F, L) int32 with
// strides (ids_b, ids_f, 1) and w (B, F, L) fp32 with strides (w_b, w_f,
// 1) (elements), or w null for unit weights; out (B, F, D) of `dtype` with
// strides (out_b, out_f, 1); all on the current device. `mean` 0 for the
// sum combiner, 1 for the mean. Returns the launch's cudaError_t.
extern "C" int embedding_bag_grouped_fwd(
    const BagTable* tables, int F, const void* idx, const void* w, void* out,
    int dtype, long long D, long long B, long long L, long long ids_b,
    long long ids_f, long long w_b, long long w_f, long long out_b,
    long long out_f, int mean, void* stream) {
  if (F < 1 || F > BAG_MAX_TABLES || D <= 0 || D > (1LL << 30) || L < 0 ||
      L > (1LL << 30) || B < 0 || ids_b < 0 || ids_f < 0 || w_b < 0 ||
      w_f < 0 || out_b < 0 || out_f < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.bags = B * F;
  if (s.bags == 0) return 0;
  const int es = dtype == 0 ? 4 : 2;
  const int vec = chunk_bytes(tables, F, out, D, out_b, out_f, es) / es;
  const long long chunks = D / vec;
  s.lpb = 1;
  while (s.lpb < 32 && s.lpb < chunks) s.lpb *= 2;
  s.ids_b = ids_b, s.ids_f = ids_f, s.w_b = w_b, s.w_f = w_f;
  s.out_b = out_b, s.out_f = out_f;
  s.B = B, s.D = (int)D, s.L = (int)L, s.mean = mean;
  BagGroup g;
  memset(&g, 0, sizeof(g));
  memcpy(g.t, tables, sizeof(BagTable) * F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (dtype == 0 && vec == 4)
    return (int)launch_depth<float, 4>(g, idx, w, out, s, st);
  if (dtype == 0 && vec == 2)
    return (int)launch_depth<float, 2>(g, idx, w, out, s, st);
  if (dtype == 0)
    return (int)launch_depth<float, 1>(g, idx, w, out, s, st);
  if (vec == 8) return (int)launch_depth<bf, 8>(g, idx, w, out, s, st);
  if (vec == 4) return (int)launch_depth<bf, 4>(g, idx, w, out, s, st);
  return (int)launch_depth<bf, 1>(g, idx, w, out, s, st);
}

// One table: table (V, D) of `dtype` (0 fp32, 1 bf16) and out (B, D) of
// `dtype`, both contiguous; idx (B, L) int32 with row stride `ldi` and w
// (B, L) fp32 with row stride `ldw` (elements; slots contiguous within a
// row), or w null for unit weights; all on one device. `mean` 0 for the
// sum combiner, 1 for the mean. The group of one table above. Returns the
// launch's cudaError_t.
extern "C" int embedding_bag_fwd(const void* table, const void* idx,
                                 const void* w, void* out, int dtype,
                                 long long V, long long D, long long B,
                                 long long L, long long ldi, long long ldw,
                                 int mean, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const BagTable t{table, V};
  return embedding_bag_grouped_fwd(&t, 1, idx, w, out, dtype, D, B, L, ldi,
                                   0, ldw, 0, D, 0, mean, stream);
}

// ---------------------------------------------------------------------------
// Backward: the dense table gradient (no Pallas counterpart: repro
// differentiates its reference with XLA, whose VJP of `jnp.take` is a
// scatter-add into a dense table gradient).
//
// For the group's stacked gradient (the F tables' rows back to back) each
// row gets sum over its slots of coef * g[b, f], coef the slot's weight
// (1 without weights; over max(bag's weight sum, 1e-9) for the mean
// combiner); padding and ids >= V_f add nothing. Deterministic, with no
// atomics: the wrapper sorts the (row, slot) pairs stably (index work,
// kernels/embedding_bag/plain.bag_segments) and cuts each row's run of
// slots into chunks of at most BWD_CHUNK. Then
//   bag_bwd_chunks: a warp a chunk sums its slots' coef * g in slot order
//     (one rounded product and one rounded add a slot, no FMA, from 0) in
//     fp32, 4 columns a lane (128 a pass), and writes the row (rounded
//     once to the tables' dtype) where the chunk is its row's only one,
//     else an fp32 partial;
//   bag_bwd_rows: a warp a row of several chunks sums its partials in
//     order, from 0, and writes the row.
// A hot row (DLRM's smoke batch draws every id below 3: 65,536 slots on
// each of three rows a table) is then 256 chunks in parallel and one
// 256-term sum, not one warp walking 65,536 slots. Rows no slot reaches
// stay as the wrapper zeroed them.
//
// What bounds it on an H100 SXM: bytes. Each valid slot reads its
// cotangent row (D * itemsize) and its sort entry; each touched row is
// written once (D * itemsize), partials twice in fp32; the zeroing of
// the dense gradient (every table row, D * itemsize) is the wrapper's
// memset. 2 FLOPs an element.
// ---------------------------------------------------------------------------
namespace {

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_COLS = 128;           // columns a warp holds (4 a lane)

template <class T>
__global__ void __launch_bounds__(BWD_THREADS)
bag_bwd_chunks(const T* __restrict__ grad, long long g_b, long long g_f,
               int F, int L, int D, const int* __restrict__ slot,
               const float* __restrict__ coef, const int* __restrict__ start,
               const int* __restrict__ count,
               const long long* __restrict__ key,
               const int* __restrict__ part, long long C, T* __restrict__ out,
               float* __restrict__ partial) {
  const long long c =
      (long long)blockIdx.x * BWD_WARPS + threadIdx.x / 32;
  if (c >= C) return;
  const int lane = threadIdx.x % 32;
  const int s0 = start[c];
  const int n = count[c];
  const int p = part[c];
  for (int c0 = 0; c0 < D; c0 += BWD_COLS) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < n; ++j) {
      const int s = slot[s0 + j];       // flat (b, f, l)
      const int bf = s / L;
      const long long b = bf / F;
      const int f = bf - (int)b * F;
      const float w = coef != nullptr ? coef[s0 + j] : 1.0f;
      const T* g = grad + b * g_b + (long long)f * g_f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = c0 + lane + 32 * k;
        if (d < D) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, to_f(g[d])));
      }
    }
    if (p < 0) {
      T* o = out + key[c] * D;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = c0 + lane + 32 * k;
        if (d < D) o[d] = from_f<T>(acc[k]);
      }
    } else {
      float* o = partial + (long long)p * D;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = c0 + lane + 32 * k;
        if (d < D) o[d] = acc[k];
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(BWD_THREADS)
bag_bwd_rows(const float* __restrict__ partial,
             const int* __restrict__ first, const int* __restrict__ cnt,
             const long long* __restrict__ key, long long M, int D,
             T* __restrict__ out) {
  const long long r =
      (long long)blockIdx.x * BWD_WARPS + threadIdx.x / 32;
  if (r >= M) return;
  const int lane = threadIdx.x % 32;
  const float* p = partial + (long long)first[r] * D;
  const int n = cnt[r];
  T* o = out + key[r] * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, p[(long long)j * D + d]);
    o[d] = from_f<T>(acc);
  }
}

template <class T>
int launch_bwd(const void* grad, long long g_b, long long g_f, int F, int L,
               int D, const int* slot, const float* coef, const int* start,
               const int* count, const long long* key, const int* part,
               long long C, const int* mfirst, const int* mcount,
               const long long* mkey, long long M, float* partial, void* out,
               cudaStream_t st) {
  const long long g1 = (C + BWD_WARPS - 1) / BWD_WARPS;
  const long long g2 = (M + BWD_WARPS - 1) / BWD_WARPS;
  if (g1 > 0x7fffffffLL || g2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (g1 > 0)
    bag_bwd_chunks<T><<<(unsigned)g1, BWD_THREADS, 0, st>>>(
        static_cast<const T*>(grad), g_b, g_f, F, L, D, slot, coef, start,
        count, key, part, C, static_cast<T*>(out), partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g2 == 0) return (int)err;
  bag_bwd_rows<T><<<(unsigned)g2, BWD_THREADS, 0, st>>>(
      partial, mfirst, mcount, mkey, M, D, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of a grouped bag call: grad (B, F, D) of `dtype` (0 fp32,
// 1 bf16) with strides (g_b, g_f, 1), the cotangent of its output; the
// sorted slots and their chunks as `bag_segments` lays them out (C
// chunks, M rows of several chunks, `partial` an fp32 scratch of one D
// row a chunk of those rows); out: the group's stacked (rows, D) gradient
// of `dtype`, zeroed by the caller, written at every row a slot reaches.
// Ints: slot/start/count/part/mfirst/mcount int32, key/mkey int64, coef
// fp32 or null for unit coefficients. Two launches on `stream`; returns
// the last cudaError_t.
extern "C" int embedding_bag_grouped_bwd(
    const void* grad, int dtype, long long g_b, long long g_f, int F,
    long long L, long long D, const int* slot, const float* coef,
    const int* start, const int* count, const long long* key,
    const int* part, long long C, const int* mfirst, const int* mcount,
    const long long* mkey, long long M, float* partial, void* out,
    void* stream) {
  if (F < 1 || L < 1 || D < 1 || D > (1LL << 30) || L > (1LL << 30) ||
      C < 0 || M < 0 || g_b < 0 || g_f < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(grad, g_b, g_f, F, (int)L, (int)D, slot, coef,
                             start, count, key, part, C, mfirst, mcount,
                             mkey, M, partial, out, st);
  return launch_bwd<__nv_bfloat16>(grad, g_b, g_f, F, (int)L, (int)D, slot,
                                   coef, start, count, key, part, C, mfirst,
                                   mcount, mkey, M, partial, out, st);
}
