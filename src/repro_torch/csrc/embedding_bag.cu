// Multi-hot embedding lookup-reduce (EmbeddingBag), fp32 or bf16 tables,
// for sm_90a.
//
// Replaces the TPU kernel of src/repro/kernels/embedding_bag/embedding_bag.py:
// `_kernel`, launched by `embedding_bag_kernel`. The same function: for
// each bag b of L slots,
//   out[b] = sum_j w[b, j] * table[idx[b, j]]   over the slots idx >= 0,
// summed in fp32 in ascending j (one fmaf chain an element), divided by
// max(sum of those w, 1e-9) for the mean combiner, and rounded once to
// the table's dtype. Every negative id is padding: it adds nothing and
// does not count toward the sum of w, so an all-padding bag is 0. A bag
// holding an id >= V is NaN, the row repro's ref gives (`jnp.take` fills
// out-of-range rows with NaN); the kernel checks each id against V
// itself and never reads such a row.
//
// Layout of one launch: one warp a bag, WARPS bags a block, grid
// ceil(B / WARPS). Lane t owns the 16-byte column chunks t, t + 32, ...
// of the row (4 fp32 or 8 bf16 widened to fp32), so one 128-wide fp32
// row is one coalesced 512-byte read by the warp; a width that is not a
// multiple of the chunk, or a table or output not 16-byte aligned, takes
// the same loop one element a lane. Every lane reads the bag's ids and
// weights itself (one broadcast load a slot). The ids and weights are
// read through a row stride, so a field of a (B, F, L) id tensor is
// passed as it lies, and null weights mean unit weights: DLRM's one-hot
// lookups need no copy and no fill before the launch. Row offsets are
// 64-bit: idx * D overflows 32 bits above 16.8M rows at D = 128.
//
// What bounds it on an H100 SXM: bytes. A bag reads its valid rows once
// (D * itemsize each), its ids and weights (8 bytes a slot) and writes
// D * itemsize; two FLOPs a row element are far below the ~20 FLOPs a
// byte at which fp32 compute would bound. The rows are scattered over a
// table far larger than the 50 MB L2, so each read is a cold 512-byte
// row: the kernel lives on how many rows are in flight (8 warps a block,
// up to 64 warps an SM, the slot loop unrolled by 4).
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

using port::from_f;
using port::to_f;

template <class T, int VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           float (&x)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T raw[VEC];
    *reinterpret_cast<uint4*>(raw) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = to_f(raw[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = to_f(p[e]);
  }
}

template <class T, int VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                            const float (&x)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T raw[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) raw[e] = from_f<T>(x[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(raw);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = from_f<T>(x[e]);
  }
}

template <class T, int VEC>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ w, T* __restrict__ out,
                     long long V, int D, long long B, int L, long long ldi,
                     long long ldw, int mean) {
  const long long bag = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bag >= B) return;
  const int lane = threadIdx.x & 31;
  const int* ib = idx + bag * ldi;
  const float* wb = w ? w + bag * ldw : nullptr;
  const int chunks = D / VEC;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool mine = c < chunks;
    const long long col = (long long)c * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    float wsum = 0.f;
    bool out_of_range = false;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const int id = __ldg(ib + j);
      if (id < 0) continue;                     // padding
      const float wj = wb ? __ldg(wb + j) : 1.f;
      wsum += wj;
      if (id >= V) {                            // NaN bag, row not read
        out_of_range = true;
        continue;
      }
      if (mine) {
        float x[VEC];
        load_chunk<T, VEC>(table + (long long)id * D + col, x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, x[e], acc[e]);
      }
    }
    if (!mine) continue;
    if (mean) {
      const float den = fmaxf(wsum, 1e-9f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = acc[e] / den;
    }
    if (out_of_range) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = CUDART_NAN_F;
    }
    store_chunk<T, VEC>(out + bag * D + col, acc);
  }
}

template <class T, int VEC>
void launch(const void* table, const void* idx, const void* w, void* out,
            long long V, long long D, long long B, long long L,
            long long ldi, long long ldw, int mean, cudaStream_t stream) {
  const long long blocks = (B + WARPS - 1) / WARPS;
  embedding_bag_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), V, (int)D, B,
      (int)L, ldi, ldw, mean);
}

}  // namespace

// table (V, D) of `dtype` (0 fp32, 1 bf16) and out (B, D) of `dtype`,
// both contiguous; idx (B, L) int32 with row stride `ldi` and w (B, L)
// fp32 with row stride `ldw` (elements; slots contiguous within a row),
// or w null for unit weights; all on one device. `mean` 0 for the sum
// combiner, 1 for the mean. Returns the launch's cudaError_t.
extern "C" int embedding_bag_fwd(const void* table, const void* idx,
                                 const void* w, void* out, int dtype,
                                 long long V, long long D, long long B,
                                 long long L, long long ldi, long long ldw,
                                 int mean, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (D > (1LL << 30) || L > (1LL << 30) || (B + WARPS - 1) / WARPS >
      0x7fffffffLL || ldi < 0 || ldw < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (dtype == 0) {
    if (aligned && D % 4 == 0)
      launch<float, 4>(table, idx, w, out, V, D, B, L, ldi, ldw, mean, s);
    else
      launch<float, 1>(table, idx, w, out, V, D, B, L, ldi, ldw, mean, s);
  } else if (dtype == 1) {
    if (aligned && D % 8 == 0)
      launch<__nv_bfloat16, 8>(table, idx, w, out, V, D, B, L, ldi, ldw, mean,
                               s);
    else
      launch<__nv_bfloat16, 1>(table, idx, w, out, V, D, B, L, ldi, ldw, mean,
                               s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
