// Loads at a serving storage type: float, or __nv_bfloat16 for
// reduced-precision serving (K10).  Each value is widened to float as it
// is loaded; the kernels compute and keep shared memory in float.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ float ld(const T* p);

template <>
__device__ __forceinline__ float ld<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
