// Helpers every CUDA source of the port shares: fp32/bf16 conversion for
// kernels that compute in fp32 whatever their input type, a kernel's
// shared-memory attribute set once, and the error message entry each
// library exports for its wrapper (kernels/build.py `check`). Include it
// once per source: it defines that entry.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace port {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device the first time it launches there (`done`: the caller's flags, one
// array a kernel), not at every launch.
template <class K>
inline cudaError_t set_smem_once(bool (&done)[kMaxDevices], K kernel,
                                 int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace port

// Message for a cudaError_t returned by a launch entry.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
