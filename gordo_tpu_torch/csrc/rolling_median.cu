// rolling_median: the detector's trailing rolling median over the tag
// scores and the total score of every dispatch slot, and the confidence
// of the smoothed total.
//
// Replaces `_rolling_median` and `_rolling_median_blocked`
// (gordo_tpu/serve/scorer.py:165,178), which give identical results, and
// the confidence of the smoothed total (scorer.py:272).  Per slot, series
// (each tag, then the total) and row r < n_rows:
//
//   med  = nanmedian(s[max(0, r - w + 1) .. r])    (rows before 0 are NaN)
//   conf = med_total / max(threshold, 1e-12)
//
// jnp.nanmedian is nanquantile(q=0.5, method="midpoint"): NaNs are
// dropped and the result is (lo + hi) * 0.5 in float32 of the two middle
// values of the c values left (lo = hi for odd c); no values give NaN.
//
// Bound: each input and output crosses device memory once, about 2 x 4
// bytes per element against a few hundred compares: bound by bytes.
//
// Design: a warp takes one series of one slot over a chunk of 32 E output
// rows (E rows a lane, consecutive), so every lane works whatever the
// number of tags.  It sorts the chunk's values once: the w - 1 rows
// before the chunk and its own, as unique keys (orderable float bits,
// local row), NaNs (and rows before 0) last, by a bitonic network over a
// power of two P of keys (bitonic.cuh: in the lanes' registers up to 512,
// segments of 512 merged in shared memory past that).  From the sorted
// keys it keeps each position's row and value and each row's position.  A
// lane then finds the ((c - 1) / 2)-th key of its first row's window by
// walking the sorted rows from the start, eight a step (one 16-byte load
// gives a mask of the eight that lie in the window), and slides down its
// E rows: the row that leaves and the row that enters move its count of
// window keys before its group of eight by one at most, so the walk moves
// a group or none to the next row's middle value.  The two
// middle values are the same keys as any other order would pick, so the
// output is the parent's bit for bit.  A block is up to 4 warps
// (RM_MAX_THREADS), the series next to each other: the block stages its chunk's rows of all its
// series by coalesced loads (a row's series are neighbours) into each
// warp's value array before the warps sort.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bitonic.cuh"

#define RM_SEG_KEYS 16        // keys a lane holds in registers (a segment of 512 a warp)
#define RM_NONE 0xFFFFu       // no row / no position (a NaN)
#ifndef RM_MAX_THREADS
#define RM_MAX_THREADS 128    // a block's threads at most: 32 x MAX_WARPS in the wrapper
#endif
#ifndef RM_MIN_BLOCKS
#define RM_MIN_BLOCKS 1       // __launch_bounds__'s blocks an SM on the register path
#endif

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/rolling_median.py;
// rolling_median_args_size() lets the wrapper check the two agree.
struct RollingMedianArgs {
  const float* tag;       // (m, n, f) tag scores
  const float* total;     // (m, n) total scores
  const int* idx;         // (m,) stacked machine of each slot, or null: slot
  const int* n_rows;      // (m,) valid rows of each slot, or null: n
  const float* agg_thr;   // (M,) aggregate thresholds, or null: no confidence
  float* tag_out;         // (m, n, f)
  float* total_out;       // (m, n)
  float* conf;            // (m, n)  written when agg_thr is set
  int m;
  int n;
  int f;
  int window;
  int lane_rows;          // E: output rows a lane slides over
  int keys;               // P: keys a warp sorts, a power of two >= 32 E + w - 1
  int warps;              // series a block, one a warp
  int warp_bytes;         // shared memory of one warp
  int smem_bytes;
  int groups;             // the grid: blocks of series (x) and chunks of rows (y), a slot a z
  int chunks;
};

__device__ __forceinline__ float load_series(const RollingMedianArgs& a, int slot, int c, int r) {
  const size_t row = (size_t)slot * a.n + r;
  return c < a.f ? __ldg(a.tag + row * a.f + c) : __ldg(a.total + row);
}

// ascending in the float's order, NaN last (scaler_quantiles.cu's key)
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// One warp's series over one chunk: output rows r0 .. r_end - 1, local row
// e the series' row r0 - w + 1 + e (nk of them).
struct Chunk {
  int slot;
  int c;       // series: tags, then the total
  int r0;
  int r_end;
  int nk;
};

// local row e's unique key from its staged value (NaN last), ~0 for the
// padding past nk
__device__ __forceinline__ uint64_t row_key(const float* val, int nk, int e) {
  return e < nk ? ((uint64_t)order_key(val[e]) << 32) | (uint32_t)e : ~0ull;
}

// A warp's arrays: sorted position -> value and local row (RM_NONE for
// NaNs and padding); local row -> sorted position (RM_NONE for a NaN);
// pre[e] = rows with a value among local rows 0 .. e - 1.
struct WarpArrays {
  uint64_t* keys;  // the network's keys, past 512 of them
  float* val;
  unsigned short* row;
  unsigned short* pos;
  unsigned short* pre;
};

__device__ __forceinline__ void place(const WarpArrays& s, uint64_t k, int e) {
  const uint32_t hi = (uint32_t)(k >> 32), lo = (uint32_t)k;
  if (hi != 0xFFFFFFFFu) {
    s.val[e] = key_value(hi);
    s.row[e] = (unsigned short)lo;
    s.pos[lo] = (unsigned short)e;
  } else {
    s.row[e] = RM_NONE;
    if (lo != 0xFFFFFFFFu) s.pos[lo] = RM_NONE;
  }
}

// bit i set: sorted position 8 g + i holds a key of the window's rows
// lo_row .. lo_row + w - 1 (one 16-byte load of 8 rows)
__device__ __forceinline__ unsigned window_bits(const unsigned short* srow, int g, unsigned lo_row, unsigned w) {
  const uint4 q = *reinterpret_cast<const uint4*>(srow + 8 * g);
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
  unsigned m = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    m |= ((words[h] & 0xFFFFu) - lo_row < w ? 1u : 0u) << (2 * h);
    m |= ((words[h] >> 16) - lo_row < w ? 2u : 0u) << (2 * h);
  }
  return m;
}

// index of the n-th set bit of the 8-bit m, from 0 (n < popc(m)): three
// halvings, no loop
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int at = 0;
#pragma unroll
  for (int half = 4; half > 0; half >>= 1) {
    const int c = __popc(m & ((1u << half) - 1u));
    const bool up = n >= c;
    n -= up ? c : 0;
    at += up ? half : 0;
    m = up ? m >> half : m;
  }
  return at;
}

// P = 32 K keys sorted in the lanes' registers
template <int K>
__device__ void sort_in_registers(const Chunk& ch, const WarpArrays& s) {
  const int lane = threadIdx.x & 31;
  uint64_t v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = row_key(s.val, ch.nk, lane * K + r);
  warp_sort<K>(v, 0);
#pragma unroll
  for (int r = 0; r < K; ++r) place(s, v[r], lane * K + r);
}

// P > 512 keys: segments of 512 sorted in registers, the stages across
// segments in shared memory
__device__ void sort_in_shared(const Chunk& ch, const WarpArrays& s, int P) {
  constexpr int K = RM_SEG_KEYS;
  constexpr int SEG = 32 * K;
  const int lane = threadIdx.x & 31;
  uint64_t* keys = s.keys;
  for (int e = lane; e < P; e += 32) keys[kpad(e)] = row_key(s.val, ch.nk, e);
  __syncwarp();
  auto each_segment = [&](auto stages) {
    for (int seg = 0; seg < P; seg += SEG) {
      uint64_t v[K];
#pragma unroll
      for (int r = 0; r < K; ++r) v[r] = keys[kpad(seg + lane * K + r)];
      stages(v, seg);
#pragma unroll
      for (int r = 0; r < K; ++r) keys[kpad(seg + lane * K + r)] = v[r];
    }
    __syncwarp();
  };
  each_segment([&](uint64_t(&v)[K], int seg) { warp_sort<K>(v, seg); });
  for (int k = 2 * SEG; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= SEG; j >>= 1) {
      for (int q = lane; q < P / 2; q += 32) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        order_shared(keys + kpad(i), keys + kpad(i + j), (i & k) == 0);
      }
      __syncwarp();
    }
    each_segment([&](uint64_t(&v)[K], int seg) { warp_merge<K>(v, seg, k); });
  }
  for (int e = lane; e < P; e += 32) place(s, keys[kpad(e)], e);
}

// One warp's series over its chunk: the sort, the prefix counts and the
// lanes' walks, each output stored as it is found.
template <bool REG>
__device__ void smooth_chunk(const RollingMedianArgs& a, const Chunk& ch, unsigned char* base, int keys_bytes,
                             float thr) {
  const int w = a.window;
  const int P = a.keys;
  const int E = a.lane_rows;
  const int lane = threadIdx.x & 31;
  WarpArrays s;
  s.keys = reinterpret_cast<uint64_t*>(base);
  s.val = reinterpret_cast<float*>(base + keys_bytes);
  s.row = reinterpret_cast<unsigned short*>(base + keys_bytes + 4 * P);
  s.pos = s.row + P;
  s.pre = s.pos + P;

  if constexpr (REG) {
    switch (P) {
      case 32: sort_in_registers<1>(ch, s); break;
      case 64: sort_in_registers<2>(ch, s); break;
      case 128: sort_in_registers<4>(ch, s); break;
      case 256: sort_in_registers<8>(ch, s); break;
      default: sort_in_registers<16>(ch, s); break;
    }
  } else {
    sort_in_shared(ch, s, P);
  }
  __syncwarp();
  unsigned running = 0;
  for (int b = 0; b < P; b += 32) {
    const int e = b + lane;
    const unsigned has = __ballot_sync(0xffffffffu, e < ch.nk && s.pos[e] != RM_NONE);
    s.pre[e] = (unsigned short)(running + __popc(has & ((1u << lane) - 1u)));
    running += __popc(has);
  }
  if (lane == 0) s.pre[P] = (unsigned short)running;
  __syncwarp();

  const unsigned short* srow = s.row;
  int g = 0, below = 0, cnt = 0;  // below: window keys at sorted positions < 8 g
  const int rows_here = ch.r_end - ch.r0;
  for (int i = 0; i < E; ++i) {
    const int j = lane * E + i;  // output row r0 + j, local row j + w - 1
    if (j >= rows_here) break;
    const int rho = j + w - 1;
    if (i == 0) {
      cnt = s.pre[rho + 1] - s.pre[rho + 1 - w];
    } else {
      const unsigned out = s.pos[rho - w], in = s.pos[rho];
      if (out != RM_NONE) {
        --cnt;
        below -= (int)out < 8 * g;
      }
      if (in != RM_NONE) {
        ++cnt;
        below += (int)in < 8 * g;
      }
    }
    const unsigned lo_row = (unsigned)(rho - w + 1);
    float med = __int_as_float(0x7fc00000);  // NaN: no values
    if (cnt > 0) {
      // the group of the t-th window key: back while too many keys lie
      // before the group, then on while the group ends before it
      const int t = (cnt - 1) >> 1;
      unsigned m;
      if (below > t) {
        do {
          --g;
          m = window_bits(srow, g, lo_row, w);
          below -= __popc(m);
        } while (below > t);
      } else {
        m = window_bits(srow, g, lo_row, w);
      }
      while (below + __popc(m) <= t) {
        below += __popc(m);
        m = window_bits(srow, ++g, lo_row, w);
      }
      const float lo = s.val[8 * g + nth_bit(m, t - below)];
      float hi = lo;
      if (!(cnt & 1)) {
        int gh = g, bh = below;
        unsigned mh = m;
        while (bh + __popc(mh) <= t + 1) {
          bh += __popc(mh);
          mh = window_bits(srow, ++gh, lo_row, w);
        }
        hi = s.val[8 * gh + nth_bit(mh, t + 1 - bh)];
      }
      med = (lo + hi) * 0.5f;
    }
    const size_t row = (size_t)ch.slot * a.n + ch.r0 + j;
    if (ch.c < a.f) {
      a.tag_out[row * a.f + ch.c] = med;
    } else {
      a.total_out[row] = med;
      if (a.agg_thr) a.conf[row] = med / thr;
    }
  }
}

// REG: every chunk's keys fit the lanes' registers (P <= 512), so the
// registers are capped for RM_MIN_BLOCKS blocks an SM; else P > 512 keys
// merged in shared memory, one block an SM at the longest windows.
template <bool REG>
__global__ void __launch_bounds__(RM_MAX_THREADS, REG ? RM_MIN_BLOCKS : 1)
rolling_median_kernel(const RollingMedianArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int w = a.window;
  const int P = a.keys;
  const int E = a.lane_rows;
  const int W = a.warps;
  Chunk ch;
  ch.slot = blockIdx.z;
  ch.c = blockIdx.x * W + warp;
  ch.r0 = blockIdx.y * 32 * E;
  const int n_valid = a.n_rows ? a.n_rows[ch.slot] : a.n;
  if (ch.r0 >= n_valid) return;  // the whole block alike
  ch.r_end = min(ch.r0 + 32 * E, n_valid);
  ch.nk = ch.r_end - ch.r0 + w - 1;
  const int keys_bytes = P > 32 * RM_SEG_KEYS ? 8 * (P + P / 32) : 0;

  // the block's series at its chunk's rows, each into its warp's value
  // array by local row: a row's series are neighbours in device memory,
  // so the loads are coalesced; eight in flight a thread
  const int c0 = blockIdx.x * a.warps;
  const int staged = ch.nk * a.warps;
  for (int b = threadIdx.x; b < staged; b += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = b + u * blockDim.x;
      const int e = idx / a.warps, c = c0 + idx - e * a.warps;
      const int g = ch.r0 - w + 1 + e;
      v[u] = idx < staged && c <= a.f && g >= 0 && g < ch.r_end ? load_series(a, ch.slot, c, g)
                                                                 : __int_as_float(0x7fc00000);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = b + u * blockDim.x;
      const int e = idx / a.warps, cw = idx - e * a.warps;
      if (idx < staged)
        reinterpret_cast<float*>(smem + (size_t)cw * a.warp_bytes + keys_bytes)[e] = v[u];
    }
  }
  __syncthreads();
  if (ch.c > a.f) return;  // the whole warp alike
  float thr = 0.f;
  if (a.agg_thr && ch.c == a.f) {
    const float t = __ldg(a.agg_thr + (a.idx ? a.idx[ch.slot] : ch.slot));
    thr = isnan(t) ? t : fmaxf(t, 1e-12f);
  }
  smooth_chunk<REG>(a, ch, smem + (size_t)warp * a.warp_bytes, keys_bytes, thr);
}

extern "C" int rolling_median_args_size() { return (int)sizeof(RollingMedianArgs); }

extern "C" const char* rolling_median_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int rolling_median_launch(const RollingMedianArgs* a, void* stream) {
  auto kernel = a->keys <= 32 * RM_SEG_KEYS ? rolling_median_kernel<true> : rolling_median_kernel<false>;
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a->groups, a->chunks, a->m), 32 * a->warps, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
