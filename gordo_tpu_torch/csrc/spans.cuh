// Block-wide walks and copies of contiguous spans between device memory
// and shared memory, for kernels whose blocks are not DR_THREADS wide
// (fleet_score.cu's two paths, chain_apply.cu's row and elementwise paths).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "copy_async.cuh"
#include "storage.cuh"

__device__ __forceinline__ int pad4(int v) { return (v + 3) & ~3; }

// Calls body(q, c) for each pair of [0, nq) x [0, nc) that falls to thread
// `tid` of `nt` walking them in row-major order (walk2d for any block).
template <typename Body>
__device__ __forceinline__ void walk_nt(int nq, int nc, int tid, int nt, Body body) {
  int q = tid / nc;
  int c = tid - q * nc;
  const int dq = nt / nc;
  const int dc = nt - dq * nc;
  while (q < nq) {
    body(q, c);
    q += dq;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++q;
    }
  }
}

// body(q, c) as walk_nt, B pairs at a time: load(q, c) of all B, then
// store(q, c, v) of all B, so that B loads are in flight a thread (a loop
// that stores each value before its next load waits a full memory latency
// a value: the compiler cannot tell that the store to shared memory does
// not alias the load)
template <int B, typename Load, typename Store>
__device__ __forceinline__ void walk_batched(int nq, int nc, int tid, int nt, Load load, Store store) {
  int q = tid / nc;
  int c = tid - q * nc;
  const int dq = nt / nc;
  const int dc = nt - dq * nc;
  while (q < nq) {
    float v[B];
    int qs[B], cs[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      qs[u] = q;
      cs[u] = c;
      if (q < nq) v[u] = load(q, c);
      q += dq;
      c += dc;
      if (c >= nc) {
        c -= nc;
        ++q;
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (qs[u] < nq) store(qs[u], cs[u], v[u]);
  }
}

// `rows` x `cols` values of `src` (row stride cols) into `dst` (shared,
// row stride `stride`), widened: floats by cp.async (the caller commits
// and waits before its barrier), bf16 eight loads in flight a thread
__device__ __forceinline__ void gather_rows(float* dst, int stride, const float* src, int rows, int cols, int tid,
                                            int nt) {
  walk_nt(rows, cols, tid, nt, [&](int r, int c) { copy_async(dst + r * stride + c, src + r * cols + c); });
}

__device__ __forceinline__ void gather_rows(float* dst, int stride, const __nv_bfloat16* src, int rows, int cols,
                                            int tid, int nt) {
  walk_batched<8>(
      rows, cols, tid, nt, [&](int r, int c) { return ld(src + r * cols + c); },
      [&](int r, int c, float v) { dst[r * stride + c] = v; });
}

// `count` floats from shared `src` (16-byte aligned) to device memory, in
// 16-byte stores where `dst` is aligned
__device__ __forceinline__ void store_span(float* dst, const float* src, int count, int tid, int nt) {
  int i0 = 0;
  if (!(reinterpret_cast<size_t>(dst) & 15)) {
    const int n4 = count >> 2;
    for (int i = tid; i < n4; i += nt) reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    i0 = n4 << 2;
  }
  for (int i = i0 + tid; i < count; i += nt) dst[i] = src[i];
}

// `nbytes` of device memory from `src` into shared `dst` (16-byte aligned)
// as they are: 16-byte cp.async copies where `src` is 16-byte aligned,
// 4-byte ones where it is 4-byte aligned, the rest (a bf16 span at an odd
// element, a span's last bytes) by 2-byte loads; the caller commits and
// waits before its barrier
__device__ __forceinline__ void copy_raw(void* dst, const void* src, int nbytes, int tid, int nt) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  int done = 0;
  if (!(reinterpret_cast<size_t>(s) & 15)) {
    const int n16 = nbytes >> 4;
    for (int i = tid; i < n16; i += nt)
      copy_async16(reinterpret_cast<float*>(d + 16 * i), reinterpret_cast<const float*>(s + 16 * i));
    done = n16 << 4;
  } else if (!(reinterpret_cast<size_t>(s) & 3)) {
    const int n4 = nbytes >> 2;
    for (int i = tid; i < n4; i += nt)
      copy_async(reinterpret_cast<float*>(d + 4 * i), reinterpret_cast<const float*>(s + 4 * i));
    done = n4 << 2;
  }
  for (int i = (done >> 1) + tid; i < (nbytes >> 1); i += nt)
    reinterpret_cast<unsigned short*>(d)[i] = __ldg(reinterpret_cast<const unsigned short*>(s) + i);
}

// a value of a raw copy, widened
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
