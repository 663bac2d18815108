// Sums in XLA:CPU's order, so that a kernel's sum is the JAX package's
// bit for bit (scaler_stats.cu's means and Standard statistic,
// cv_epilogue.cu's CV metrics).
//
// XLA:CPU's tree-reduction rewrite splits a reduction over more than
// XO_WINDOW values into windows of XO_WINDOW, padded with zeros to a
// multiple of it (half the padding in front, the rest behind), sums each
// window in order, and reduces the window sums the same way, until
// XO_WINDOW or fewer are left, which it sums in order.  A reduction over
// two dimensions windows each dimension longer than XO_WINDOW the same
// way (a shorter one is one window) and sums a window row-major
// (`xla_order_sum2`).  The padding's zeros are skipped (x + 0 = x: no
// sum here starts at or reaches -0).  A mean is the sum times 1 / N (XLA
// turns the division by a constant into that product).

#pragma once

#include <cuda_runtime.h>

#define XO_WINDOW 32

// K values a column a row, as a reduction's callback gives them
template <int N>
struct Vals {
  static constexpr int size = N;
  float v[N];
};

__device__ __forceinline__ Vals<1> as_vals(float x) { return {{x}}; }
template <int N>
__device__ __forceinline__ Vals<N> as_vals(Vals<N> x) { return x; }

// The threads that take part in a sum: the whole block, or its first `n`
// (a multiple of 32) while the others work elsewhere, synchronised on
// named barrier 1.
struct Team {
  int n;
  __device__ __forceinline__ void sync() const {
    if (n == (int)blockDim.x) {
      __syncthreads();
    } else {
#ifdef __CUDA_ARCH__
      asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
#endif
    }
  }
};

__device__ __forceinline__ Team whole_block() { return {(int)blockDim.x}; }

// the number of windows of n values (n itself when no window is cut)
__host__ __device__ __forceinline__ int xo_windows(int n) { return (n + XO_WINDOW - 1) / XO_WINDOW; }

// floats `xla_order_sums` needs in `part` for nc columns of n values and K
// sums a value
__host__ __device__ __forceinline__ int xo_part_floats(int nc, int k, int n) {
  const int l1 = xo_windows(n);
  return nc * k * (l1 + xo_windows(l1));
}

// The window sums of each of the block's `nc` columns, `n` values each
// read by `at(c, i)` (a float, or Vals<K> for K sums at once), into `out`
// (sum q of column c at out + (q * nc + c) * stride, ceil(n / W) of
// them).  COUNT: a NaN adds 0 and each column's other values (of the
// first sum) are counted into `cnt`.  Thread t takes column t % nc of
// window t / nc, so that a warp's loads are the columns of the same rows.
template <bool COUNT, typename At>
__device__ void window_sums(int nc, int n, At at, float* out, int stride, int* cnt, Team team = whole_block()) {
  constexpr int K = decltype(as_vals(at(0, 0)))::size;
  const int m = xo_windows(n) * XO_WINDOW;
  const int lo = (m - n) / 2;
  for (int task = threadIdx.x; task < nc * (m / XO_WINDOW); task += team.n) {
    const int c = task % nc;
    const int i0 = task / nc * XO_WINDOW - lo;  // the window's first value
    const int j1 = min(XO_WINDOW, n - i0);
    float s[K];
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] = 0.f;
    int k = 0;
#pragma unroll 8
    for (int j = max(0, -i0); j < j1; ++j) {
      const auto v = as_vals(at(c, i0 + j));
#pragma unroll
      for (int q = 0; q < K; ++q) {
        float x = v.v[q];
        if (COUNT) {
          if (q == 0) k += x == x;
          x = x == x ? x : 0.f;
        }
        s[q] = __fadd_rn(s[q], x);
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) out[(q * nc + c) * stride + task / nc] = s[q];
    if (COUNT) atomicAdd(cnt + c, k);
  }
}

// The sums of each of the block's `nc` columns in XLA's order into `res`
// (shared, K * nc floats, sum q of column c at res[q * nc + c]), and with
// COUNT each column's non-NaN values into `cnt` (shared, zeroed before),
// which every thread of `team` sees on return.  `part` holds xo_part_floats(nc, K,
// n) floats: the window sums, then those of the levels above (the two
// halves in turn).
template <bool COUNT, typename At>
__device__ void xla_order_sums(int nc, int n, At at, float* part, float* res, int* cnt, Team team = whole_block()) {
  constexpr int K = decltype(as_vals(at(0, 0)))::size;
  const int level1 = xo_windows(n);
  const int cols = nc * K;  // above the first level each sum is a column
  float* cur = part;
  float* nxt = part + cols * level1;
  int s_cur = level1, s_nxt = xo_windows(level1);
  int len = n;
  const bool leaves = n > XO_WINDOW;
  if (leaves) {
    window_sums<COUNT>(nc, len, at, cur, s_cur, cnt, team);
    len = level1;
    team.sync();
    while (len > XO_WINDOW) {
      window_sums<false>(cols, len, [&](int c, int i) { return cur[c * s_cur + i]; }, nxt, s_nxt, cnt, team);
      len = xo_windows(len);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      const int s_tmp = s_cur;
      s_cur = s_nxt;
      s_nxt = s_tmp;
      team.sync();
    }
    for (int c = threadIdx.x; c < cols; c += team.n) {
      float s = 0.f;
      for (int i = 0; i < len; ++i) s = __fadd_rn(s, cur[c * s_cur + i]);
      res[c] = s;
    }
  } else {
    for (int c = threadIdx.x; c < nc; c += team.n) {
      float s[K];
#pragma unroll
      for (int q = 0; q < K; ++q) s[q] = 0.f;
      int k = 0;
      for (int i = 0; i < len; ++i) {
        const auto v = as_vals(at(c, i));
#pragma unroll
        for (int q = 0; q < K; ++q) {
          float x = v.v[q];
          if (COUNT) {
            if (q == 0) k += x == x;
            x = x == x ? x : 0.f;
          }
          s[q] = __fadd_rn(s[q], x);
        }
      }
#pragma unroll
      for (int q = 0; q < K; ++q) res[q * nc + c] = s[q];
      if (COUNT) cnt[c] = k;
    }
  }
  team.sync();
}

// A dimension of n in a two-dimensional reduction: `windows` windows of
// `width`, `lo` values of padding in front (n itself, one window, none,
// when n <= XO_WINDOW).
__host__ __device__ __forceinline__ void xo_dim(int n, int& windows, int& width, int& lo) {
  windows = n > XO_WINDOW ? xo_windows(n) : 1;
  width = n > XO_WINDOW ? XO_WINDOW : n;
  lo = n > XO_WINDOW ? (windows * XO_WINDOW - n) / 2 : 0;
}

// floats `xla_order_sum2` needs in `part` for an n x f array and K sums
__host__ __device__ __forceinline__ int xo_sum2_part_floats(int n, int f, int k) {
  int r1, c1, r2, c2, w, lo;
  xo_dim(n, r1, w, lo);
  xo_dim(f, c1, w, lo);
  xo_dim(r1, r2, w, lo);
  xo_dim(c1, c2, w, lo);
  return k * (r1 * c1 + r2 * c2);
}

// The levels above an R x C grid of window sums (K grids, sum q's at
// part + q * R * C, row-major) into `res` (K floats), as
// `xla_order_sum2` takes them; every thread sees `res` on return.
template <int K>
__device__ void xo_sum2_finish(int R, int C, float* part, float* res) {
  float* cur = part;
  float* nxt = part + K * R * C;
  int wr, wc, lr, lc;
  while (R > XO_WINDOW || C > XO_WINDOW) {
    int R2, C2;
    xo_dim(R, R2, wr, lr);
    xo_dim(C, C2, wc, lc);
    for (int task = threadIdx.x; task < K * R2 * C2; task += blockDim.x) {
      const int q = task / (R2 * C2);
      const int cell = task - q * R2 * C2;
      const int r0 = cell / C2 * wr - lr;
      const int c0 = cell % C2 * wc - lc;
      float s = 0.f;
      for (int r = max(0, r0); r < min(R, r0 + wr); ++r)
        for (int c = max(0, c0); c < min(C, c0 + wc); ++c) s = __fadd_rn(s, cur[q * R * C + r * C + c]);
      nxt[q * R2 * C2 + cell] = s;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    R = R2;
    C = C2;
  }
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int i = 0; i < R * C; ++i) s = __fadd_rn(s, cur[threadIdx.x * R * C + i]);
    res[threadIdx.x] = s;
  }
  __syncthreads();
}

// The sum of an n x f array read by `at(r, c)` (a float or Vals<K>) over
// both dimensions in XLA's order into `res` (shared, K floats), which
// every thread sees on return: each window summed row-major by a thread,
// the grid of window sums windowed again until neither dimension exceeds
// XO_WINDOW, then summed row-major.  `part` holds xo_sum2_part_floats(n,
// f, K) floats.
template <typename At>
__device__ void xla_order_sum2(int n, int f, At at, float* part, float* res) {
  constexpr int K = decltype(as_vals(at(0, 0)))::size;
  int R, C, wr, wc, lr, lc;
  xo_dim(n, R, wr, lr);
  xo_dim(f, C, wc, lc);
  float* cur = part;
  for (int task = threadIdx.x; task < R * C; task += blockDim.x) {
    const int r0 = task / C * wr - lr;
    const int c0 = task % C * wc - lc;
    float s[K];
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] = 0.f;
    for (int r = max(0, r0); r < min(n, r0 + wr); ++r)
      for (int c = max(0, c0); c < min(f, c0 + wc); ++c) {
        const auto v = as_vals(at(r, c));
#pragma unroll
        for (int q = 0; q < K; ++q) s[q] = __fadd_rn(s[q], v.v[q]);
      }
#pragma unroll
    for (int q = 0; q < K; ++q) cur[q * R * C + task] = s[q];
  }
  __syncthreads();
  xo_sum2_finish<K>(R, C, part, res);
}
