// Copies from device memory to shared memory that do not wait (cp.async,
// sm_80 and later): a thread issues them, commits them as a group, and
// later waits for its own groups; a barrier after the wait makes every
// thread's copies visible to the block.  The LSTM kernels stage the next
// step's (lstm_layer.cu) or the next rows' (lstm_layer_bwd.cu) inputs so
// while they compute on the last ones.

#pragma once

#include <cuda_runtime.h>

// 4 bytes
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// 16 bytes, both addresses 16-byte aligned
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}
