// Device code shared by chol.cu and newton_dir.cu: one warp factors and
// solves one small SPD matrix.
//
// Layout. An N x N matrix (N <= 64) in shared memory has leading dimension
// lead(N), which is odd, so that 32 lanes reading one column (lane i at row
// i) hit 32 different banks. Lane l owns rows l and l + 32; each row lives
// in registers, T a[R][N] with R = ceil(N / 32), indexed only by
// compile-time constants (every loop over columns is unrolled). A matrix of
// order n < N is padded with the identity, so one instance serves every
// n <= N and its factor is blockdiag(L, I).
//
// Factor. Right-looking, one column per step: lane j's pivot reaches every
// lane by one shuffle; every lane takes its root and the root's reciprocal,
// the lanes below scale their entry of column j by it, write it into
// shared memory (as row j of Lᵀ) and, after one __syncwarp, subtract their
// multiple of that column from the rest of their own rows. Each entry takes
// its subtractions in increasing column order, as a left-looking update
// would. No block barrier.
//
// Forward solve for free. Where N is not a multiple of 32, row N has a
// register slot that no matrix row uses (lane N % 32, slot R - 1). A caller
// that puts bᵀ there gets the forward solution y = L⁻¹ b in it, since the
// factor treats it as one more row below the matrix: its entry j becomes
// (b_j − Σ_k<j y_k L_jk) / L_jj.
//
// Semantics (JAX's): a non-positive or NaN pivot makes every lane's `ok`
// false; the callers then write NaN over the whole lower triangle of L or
// over the whole solution.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace chol {

constexpr int kMaxN = 64;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T nan_value();
template <>
__device__ __forceinline__ float nan_value<float>() { return CUDART_NAN_F; }
template <>
__device__ __forceinline__ double nan_value<double>() { return CUDART_NAN; }

__host__ __device__ constexpr int lead(int n) { return n | 1; }
__host__ __device__ constexpr int rows_per_lane(int n) { return (n + 31) / 32; }
// Whether row N has a free register slot (see "Forward solve for free").
__host__ __device__ constexpr bool has_spare_row(int n) { return n % 32 != 0; }

// Copies `count` contiguous elements of src into the (rows of length n,
// lead ld) layout of dst, by `nthreads` threads of which this is `tid`.
// Consecutive threads read consecutive addresses; the (row, column) of each
// element advances by a fixed step, so no division per element. Each
// thread issues kBatch loads before it stores any, so that their latencies
// overlap.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, T* dst,
                                          int count, int n, int ld, int tid,
                                          int nthreads) {
  constexpr int kBatch = 8;
  const int q = nthreads / n, s = nthreads % n;
  int r = tid / n, c = tid % n;
  for (int e0 = tid; e0 < count; e0 += kBatch * nthreads) {
    T v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nthreads;
      at[u] = r * ld + c;
      v[u] = e < count ? src[e] : T(0);
      c += s;
      r += q;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (e0 + u * nthreads < count) dst[at[u]] = v[u];
    }
  }
}

// The inverse of load_rows.
template <typename T>
__device__ __forceinline__ void store_rows(const T* src, T* __restrict__ dst,
                                           int count, int n, int ld, int tid,
                                           int nthreads) {
  const int q = nthreads / n, s = nthreads % n;
  int r = tid / n, c = tid % n;
  for (int e = tid; e < count; e += nthreads) {
    dst[e] = src[r * ld + c];
    c += s;
    r += q;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// Reads the lower triangle of the n x n matrix in `buf` (lead lead(N)) into
// the lane's row registers, padded with the identity (rows past N: zero).
template <typename T, int N>
__device__ __forceinline__ void read_lower(const T* buf, int n, int lane,
                                           T (&a)[rows_per_lane(N)][N]) {
  constexpr int ld = lead(N);
#pragma unroll
  for (int h = 0; h < rows_per_lane(N); ++h) {
    const int i = lane + 32 * h;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      T v = k == i ? T(1) : T(0);
      if (i < n && k < n && k <= i) v = buf[i * ld + k];
      a[h][k] = v;
    }
  }
}

// Puts bᵀ in the spare row's slot (see has_spare_row).
template <typename T, int N>
__device__ __forceinline__ void set_spare_row(const T* __restrict__ b, int lane,
                                              T (&a)[rows_per_lane(N)][N]) {
  static_assert(has_spare_row(N), "no spare row");
  if (lane == N % 32) {
#pragma unroll
    for (int k = 0; k < N; ++k) a[rows_per_lane(N) - 1][k] = b[k];
  }
}

// Factors the rows in `a` in place (on return: rows of L, zeros above the
// diagonal), writes Lᵀ into lt (lt[j * lead(N) + i] = L[i][j], all N rows)
// and 1 / L[j][j] into inv[j]. lt may alias the buffer the rows were read
// from, once the warp has passed a __syncwarp after the read. Returns
// whether every pivot was positive, the same in every lane. The pivot's
// reciprocal root is one rsqrt (within 2 ulp in f32, 1 in f64) and the
// root its product with the pivot, a shorter chain per column than the
// correctly rounded root and a division.
template <typename T, int N>
__device__ __forceinline__ bool warp_factor(T (&a)[rows_per_lane(N)][N],
                                            T* lt, T* inv, int lane) {
  constexpr int R = rows_per_lane(N);
  constexpr int ld = lead(N);
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T piv = __shfl_sync(kFullMask, a[j / 32][j], j % 32);
    ok = ok && (piv > T(0));
    const T rdj = rsqrt(piv);
    const T djj = piv * rdj;
    if (lane == 0) inv[j] = rdj;
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int i = lane + 32 * h;
      // Rows of slot h reach the diagonal of column j only while
      // j <= 32 h + 31: past it they hold 0 there.
      T c = T(0);
      if (32 * h + 31 >= j) {
        if (i > j) c = a[h][j] * rdj;
        if (i == j) c = djj;
      }
      a[h][j] = c;
      if (i < N) lt[j * ld + i] = c;
    }
    __syncwarp();
    // Rows below 32 need no column past 31: what lies above the diagonal
    // is overwritten with 0 when its column's step comes.
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const T lij = a[h][j];
      constexpr int kend0 = N < 32 ? N : 32;
#pragma unroll
      for (int k = j + 1; k < (h == 0 ? kend0 : N); ++k) {
        a[h][k] -= lij * lt[j * ld + k];
      }
    }
  }
  return ok;
}

// y (lane i holds y_i in y[i / 32]) from the spare row of a factor.
// `scratch` holds N elements of shared memory.
template <typename T, int N>
__device__ __forceinline__ void spare_row_to_lanes(
    const T (&a)[rows_per_lane(N)][N], T* scratch, int lane,
    T (&y)[rows_per_lane(N)]) {
  static_assert(has_spare_row(N), "no spare row");
  if (lane == N % 32) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k] = a[rows_per_lane(N) - 1][k];
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < rows_per_lane(N); ++h) {
    const int i = lane + 32 * h;
    y[h] = i < N ? scratch[i] : T(0);
  }
}

// Forward substitution L y = b, one warp, with L[i][j] at
// buf[i * si + j * sj] (si, sj = lead, 1 for L row-major; 1, lead for Lᵀ
// as warp_factor leaves it) and inv[j] = 1 / L[j][j]. r[h] enters as b at
// row lane + 32 h (0 past n); y[h] leaves as the solution there.
template <typename T, int N>
__device__ __forceinline__ void warp_forward(const T* buf, int si, int sj,
                                             const T* inv, int n, int lane,
                                             T (&r)[rows_per_lane(N)],
                                             T (&y)[rows_per_lane(N)]) {
  constexpr int R = rows_per_lane(N);
#pragma unroll
  for (int h = 0; h < R; ++h) y[h] = T(0);
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const T rj = __shfl_sync(kFullMask, R == 1 || j < 32 ? r[0] : r[R - 1], j & 31);
    const T yj = rj * inv[j];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int i = lane + 32 * h;
      if (i == j) y[h] = yj;
      if (i > j && i < n) r[h] -= buf[i * si + j * sj] * yj;
    }
  }
}

// Back substitution Lᵀ x = y, same arguments; y is consumed.
template <typename T, int N>
__device__ __forceinline__ void warp_backward(const T* buf, int si, int sj,
                                              const T* inv, int n, int lane,
                                              T (&y)[rows_per_lane(N)],
                                              T (&x)[rows_per_lane(N)]) {
  constexpr int R = rows_per_lane(N);
#pragma unroll
  for (int h = 0; h < R; ++h) x[h] = T(0);
#pragma unroll 8
  for (int j = n - 1; j >= 0; --j) {
    const T yj = __shfl_sync(kFullMask, R == 1 || j < 32 ? y[0] : y[R - 1], j & 31);
    const T xj = yj * inv[j];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int i = lane + 32 * h;
      if (i == j) x[h] = xj;
      if (i < j) y[h] -= buf[j * si + i * sj] * xj;
    }
  }
}

// x with L Lᵀ x = b after warp_factor<T, N>(a, lt, inv, lane): through the
// spare row if N has one (bᵀ must then have been put there before the
// factor), else by forward substitution from r = b. `scratch`: N elements.
template <typename T, int N>
__device__ __forceinline__ void solve_factored(const T (&a)[rows_per_lane(N)][N],
                                               const T* lt, const T* inv,
                                               T* scratch, int n, int lane,
                                               T (&r)[rows_per_lane(N)],
                                               T (&x)[rows_per_lane(N)]) {
  constexpr int ld = lead(N);
  T y[rows_per_lane(N)];
  if constexpr (has_spare_row(N)) {
    spare_row_to_lanes<T, N>(a, scratch, lane, y);
  } else {
    warp_forward<T, N>(lt, 1, ld, inv, n, lane, r, y);
  }
  warp_backward<T, N>(lt, 1, ld, inv, n, lane, y, x);
}

}  // namespace chol
