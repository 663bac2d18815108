// A bitonic network over unique 64-bit keys held by a warp: key e of a
// segment of 32 K keys in lane e / K, register e % K, and the stages of a
// network over more keys than a warp holds done in shared memory.  Shared
// by fleet_init.cu (permutations) and rolling_median.cu (a window's
// values), which both sort keys that are unique, so any network that sorts
// gives the same order.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void order(uint64_t& a, uint64_t& b, bool ascending) {
  const bool swap = (a > b) == ascending;
  const uint64_t x = a;
  a = swap ? b : a;
  b = swap ? x : b;
}

// The network's stages over a warp's segment of 32 K keys, key e of it in
// lane e / K, register e % K; `e0` is the index in the whole network of
// the calling lane's register 0.  The stage loops run at run time (the
// code stays small enough for the instruction cache); each stage's body is
// unrolled over the registers, and a stage within a thread is chosen by a
// switch over its distance, so v is only ever indexed by constants and
// stays in registers.
// (e0 is a multiple of K, so bit k of e0 + r is bit k of e0 or of r.)
template <int K, int J>
__device__ __forceinline__ void thread_stage(uint64_t (&v)[K], int e0, int k) {
  if constexpr (J < K) {
    const int ek = e0 & k;
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (!(r & J)) order(v[r], v[r | J], (ek | (r & k)) == 0);
  }
}

template <int K>
__device__ __forceinline__ void warp_stage(uint64_t (&v)[K], int e0, int k, int j) {
  if (j >= K) {  // across lanes: the shuffle with lane ^ (j / K); k > K, one direction a lane
    const int m = j / K;
    const bool keep_min = !(threadIdx.x & m) == ((e0 & k) == 0);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, v[r], m);
      v[r] = (o < v[r]) == keep_min ? o : v[r];
    }
    return;
  }
  switch (j) {
    case 1: thread_stage<K, 1>(v, e0, k); break;
    case 2: thread_stage<K, 2>(v, e0, k); break;
    case 4: thread_stage<K, 4>(v, e0, k); break;
    case 8: thread_stage<K, 8>(v, e0, k); break;
    default: thread_stage<K, 16>(v, e0, k); break;
  }
}

// The network's levels k = 2 .. 32 K over the segment whose first key is
// at `base`.
template <int K>
__device__ __forceinline__ void warp_sort(uint64_t (&v)[K], int base) {
  const int e0 = base + (threadIdx.x & 31) * K;
  for (int k = 2; k <= 32 * K; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) warp_stage<K>(v, e0, k, j);
}

// Level k's stages j = 16 K .. 1 over the segment (k > 32 K).
template <int K>
__device__ __forceinline__ void warp_merge(uint64_t (&v)[K], int base, int k) {
  const int e0 = base + (threadIdx.x & 31) * K;
  for (int j = 16 * K; j > 0; j >>= 1) warp_stage<K>(v, e0, k, j);
}

// index of key i in a block's padded key array
__device__ __forceinline__ int kpad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void order_shared(uint64_t* x, uint64_t* y, bool ascending) {
  const uint64_t u = *x, v = *y;
  if ((u > v) == ascending) {
    *x = v;
    *y = u;
  }
}
