// Batched dense Cholesky factor and triangular solves for small SPD
// matrices (n <= 64), one thread block per matrix.
//
// Replaces the XLA-fused jnp.linalg.cholesky + solve_triangular pairs of the
// JAX package: smooth.factor_m / solve_m (mjlab_tpu/physics/smooth.py:233,
// 238-239), the Newton step (solver.py:227-229) and the implicit integrator
// (forward.py:116-118). Every physics substep runs 12 factorizations.
//
// Bound on the H100: at B=4096, n=35, f32 the factor needs A's lower
// triangle (630 of 1225 elements, 10.3 MB) and writes all of L (20.1 MB),
// ~9.1 us at 3.35 TB/s; a solve needs L's lower triangle and b and writes x
// (11.5 MB, ~3.4 us). Against ~59 MFLOP (~0.9 us at 67 TFLOP/s) the kernel
// is memory and, above all, latency bound. The design keeps the
// whole matrix in shared memory (n*(n|1) elements, odd row stride so that
// column reads are free of bank conflicts), gives thread i row i, and runs a
// left-looking factorization with one __syncthreads per column. Each thread
// computes the pivot of column j itself, so no second barrier is needed. The
// solves keep the running right-hand side of a row in that row's register.
//
// Semantics follow JAX: a non-positive (or NaN) pivot makes the whole lower
// triangle of L NaN (and the whole solution NaN) instead of raising; the
// Newton step's cost comparison relies on it.
//
// C interface (ctypes): every entry point returns cudaGetLastError() of its
// launch and runs on the given stream.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 64;

template <typename T>
__device__ __forceinline__ T nan_value();
template <>
__device__ __forceinline__ float nan_value<float>() { return CUDART_NAN_F; }
template <>
__device__ __forceinline__ double nan_value<double>() { return CUDART_NAN; }

__host__ __device__ __forceinline__ int row_stride(int n) { return n | 1; }

// Loads the whole matrix, though only its lower triangle is used: loading
// the lower triangle alone was measured slower on an H100 (PERF.md).
template <typename T>
__device__ void load_matrix(const T* __restrict__ A, T* a, int n, int lda) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    a[(idx / n) * lda + idx % n] = A[idx];
  }
}

// Left-looking Cholesky in shared memory. On return the strict lower part of
// `a` holds L's off-diagonal entries and `dg` its diagonal. Returns whether
// every pivot was positive (the same value in every thread).
template <typename T>
__device__ bool factor_smem(T* a, T* dg, int n, int lda) {
  const int i = threadIdx.x;
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    const T* rj = a + j * lda;
    T s = rj[j];
    for (int k = 0; k < j; ++k) s -= rj[k] * rj[k];
    ok = ok && (s > T(0));
    const T djj = sqrt(s);
    if (i == j) {
      dg[j] = djj;
    } else if (i > j && i < n) {
      T* ri = a + i * lda;
      T t = ri[j];
      for (int k = 0; k < j; ++k) t -= ri[k] * rj[k];
      ri[j] = t / djj;
    }
    __syncthreads();
  }
  return ok;
}

// Solves L Lᵀ x = b for thread i's row; `r` enters as b[i] and the result is
// left in xs[i]. ys/xs are shared scratch of length n.
template <typename T>
__device__ void solve_smem(const T* a, const T* dg, T r, T* ys, T* xs, int n,
                           int lda) {
  const int i = threadIdx.x;
  for (int j = 0; j < n; ++j) {  // forward: L y = b
    if (i == j) ys[j] = r / dg[j];
    __syncthreads();
    if (i > j && i < n) r -= a[i * lda + j] * ys[j];
  }
  r = i < n ? ys[i] : T(0);
  for (int j = n - 1; j >= 0; --j) {  // backward: Lᵀ x = y
    if (i == j) xs[j] = r / dg[j];
    __syncthreads();
    if (i < j) r -= a[j * lda + i] * xs[j];
  }
}

template <typename T>
__global__ void chol_factor_kernel(const T* __restrict__ A, T* __restrict__ L,
                                   int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int lda = row_stride(n);
  T* dg = a + n * lda;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  load_matrix(A + off, a, n, lda);
  __syncthreads();
  const bool ok = factor_smem(a, dg, n, lda);
  const T nan = nan_value<T>();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    T v = c < r ? a[r * lda + c] : (c == r ? dg[r] : T(0));
    if (!ok && c <= r) v = nan;
    L[off + idx] = v;
  }
}

template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ L,
                                  const T* __restrict__ b, T* __restrict__ x,
                                  int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int lda = row_stride(n);
  T* dg = a + n * lda;
  T* ys = dg + n;
  T* xs = ys + n;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  load_matrix(L + off, a, n, lda);
  __syncthreads();
  const int i = threadIdx.x;
  if (i < n) dg[i] = a[i * lda + i];
  const T r = i < n ? b[static_cast<size_t>(blockIdx.x) * n + i] : T(0);
  __syncthreads();
  solve_smem(a, dg, r, ys, xs, n, lda);
  if (i < n) x[static_cast<size_t>(blockIdx.x) * n + i] = xs[i];
}

template <typename T>
__global__ void chol_factor_solve_kernel(const T* __restrict__ A,
                                         const T* __restrict__ b,
                                         T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int lda = row_stride(n);
  T* dg = a + n * lda;
  T* ys = dg + n;
  T* xs = ys + n;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  load_matrix(A + off, a, n, lda);
  const int i = threadIdx.x;
  const T r = i < n ? b[static_cast<size_t>(blockIdx.x) * n + i] : T(0);
  __syncthreads();
  const bool ok = factor_smem(a, dg, n, lda);
  solve_smem(a, dg, r, ys, xs, n, lda);
  if (i < n) x[static_cast<size_t>(blockIdx.x) * n + i] = ok ? xs[i] : nan_value<T>();
}

inline int threads_for(int n) { return n <= 32 ? 32 : kMaxN; }

template <typename T>
size_t smem_bytes(int n) {
  return (static_cast<size_t>(n) * row_stride(n) + 3 * n) * sizeof(T);
}

template <typename T>
int factor(const T* A, T* L, int batch, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  chol_factor_kernel<T><<<batch, threads_for(n), smem_bytes<T>(n), stream>>>(A, L, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve(const T* L, const T* b, T* x, int batch, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  chol_solve_kernel<T><<<batch, threads_for(n), smem_bytes<T>(n), stream>>>(L, b, x, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int factor_solve(const T* A, const T* b, T* x, int batch, int n,
                 cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  chol_factor_solve_kernel<T><<<batch, threads_for(n), smem_bytes<T>(n), stream>>>(
      A, b, x, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int chol_factor_f32(const float* A, float* L, int batch, int n, void* stream) {
  return factor(A, L, batch, n, static_cast<cudaStream_t>(stream));
}
int chol_factor_f64(const double* A, double* L, int batch, int n, void* stream) {
  return factor(A, L, batch, n, static_cast<cudaStream_t>(stream));
}
int chol_solve_f32(const float* L, const float* b, float* x, int batch, int n,
                   void* stream) {
  return solve(L, b, x, batch, n, static_cast<cudaStream_t>(stream));
}
int chol_solve_f64(const double* L, const double* b, double* x, int batch,
                   int n, void* stream) {
  return solve(L, b, x, batch, n, static_cast<cudaStream_t>(stream));
}
int chol_factor_solve_f32(const float* A, const float* b, float* x, int batch,
                          int n, void* stream) {
  return factor_solve(A, b, x, batch, n, static_cast<cudaStream_t>(stream));
}
int chol_factor_solve_f64(const double* A, const double* b, double* x,
                          int batch, int n, void* stream) {
  return factor_solve(A, b, x, batch, n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
