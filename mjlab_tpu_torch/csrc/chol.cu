// Batched dense Cholesky factor and triangular solves for small SPD
// matrices (n <= 64): one warp per matrix, several matrices per block.
//
// Replaces the XLA-fused jnp.linalg.cholesky + solve_triangular pairs of the
// JAX package: smooth.factor_m / solve_m (mjlab_tpu/physics/smooth.py:233,
// 238-239) and the implicit integrator (forward.py:116-118). The Newton
// step's factor-and-solve (solver.py:227-229) now runs inside
// newton_dir.cu, which shares this file's device code (chol_core.cuh).
//
// Bound on the H100: at B=4096, n=35, f32 the factor needs A's lower
// triangle (630 of 1225 elements, 10.3 MB) and writes all of L (20.1 MB),
// ~9.1 us at 3.35 TB/s; a solve needs L's lower triangle and b and writes x
// (11.5 MB, ~3.4 us). Against ~59 MFLOP (~0.9 us at 67 TFLOP/s) the work is
// memory bound, and a 35-column factor is a chain of 35 dependent steps, so
// the design is about latency:
//   - one warp per matrix, kWarpsPerBlock matrices per block, so a column
//     step costs one shuffle and one __syncwarp, never a block barrier
//     (chol_core.cuh has the factor and the solves);
//   - one reciprocal per pivot, by which a column (and each solve step) is
//     scaled, and, at n = 35, the forward solve done inside the factor as
//     one more row (chol_core.cuh, "Forward solve for free");
//   - each warp copies its matrix's contiguous bytes with coalesced loads
//     into shared memory (odd leading dimension) and stores L the same way;
//     the (row, column) of an element advances by a fixed step, with no
//     division per element;
//   - an instance fully unrolled for n = 35 (G1's nv), and two padded ones
//     (N = 32, 64) for every other n <= 64.
// The whole batch is resident at once on the card at B=4096 (one matrix per
// warp), so there is no next matrix whose load could overlap a factor:
// the loads are plain, not cp.async.
//
// Semantics follow JAX: a non-positive (or NaN) pivot makes the whole lower
// triangle of L NaN (and the whole solution NaN) instead of raising; the
// Newton step's cost comparison relies on it.
//
// C interface (ctypes): every entry point returns cudaGetLastError() of its
// launch and runs on the given stream.

#include "chol_core.cuh"

namespace {

using chol::lead;
using chol::rows_per_lane;

constexpr int kWarpsPerBlock = 4;
constexpr size_t kStaticSmem = 48 * 1024;

enum class Op { kFactor, kSolve, kFactorSolve };

// One warp per matrix: `in` is A (factor, factor-solve) or L (solve), `b`
// the right-hand side, `out` L or x. Instances with kPad take any n <= N.
template <typename T, int N, bool kPad, Op kOp>
__device__ __forceinline__ void chol_body(const T* __restrict__ in,
                                          const T* __restrict__ b,
                                          T* __restrict__ out, int batch,
                                          int n_arg) {
  constexpr int ld = lead(N);
  constexpr int R = rows_per_lane(N);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mat = blockIdx.x * (blockDim.x / 32) + warp;
  if (mat >= batch) return;
  const int n = kPad ? n_arg : N;
  T* buf = reinterpret_cast<T*>(smem_raw) + warp * (N * ld + 2 * N);
  T* inv = buf + N * ld;  // 1 / L[j][j]
  T* scratch = inv + N;
  const size_t off = static_cast<size_t>(mat) * n * n;
  chol::load_rows(in + off, buf, n * n, n, ld, lane, 32);
  T r[R];
  if constexpr (kOp != Op::kFactor) {
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int i = lane + 32 * h;
      r[h] = i < n ? b[static_cast<size_t>(mat) * n + i] : T(0);
    }
  }
  __syncwarp();
  T x[R];
  if constexpr (kOp == Op::kSolve) {
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int i = lane + 32 * h;
      if (i < n) inv[i] = T(1) / buf[i * ld + i];
    }
    __syncwarp();
    T y[R];
    chol::warp_forward<T, N>(buf, ld, 1, inv, n, lane, r, y);
    chol::warp_backward<T, N>(buf, ld, 1, inv, n, lane, y, x);
  } else {
    T a[R][N];
    chol::read_lower<T, N>(buf, n, lane, a);
    if constexpr (kOp == Op::kFactorSolve && chol::has_spare_row(N)) {
      chol::set_spare_row<T, N>(b + static_cast<size_t>(mat) * n, lane, a);
    }
    __syncwarp();
    const bool ok = chol::warp_factor<T, N>(a, buf, inv, lane);
    __syncwarp();
    if constexpr (kOp == Op::kFactorSolve) {
      chol::solve_factored<T, N>(a, buf, inv, scratch, n, lane, r, x);
#pragma unroll
      for (int h = 0; h < R; ++h) {
        if (!ok) x[h] = chol::nan_value<T>();
      }
    } else {
      // L's rows back into buf (row-major), then one coalesced store.
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int i = lane + 32 * h;
        if (i < n) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (k < n) {
              buf[i * ld + k] = ok ? a[h][k] : (k <= i ? chol::nan_value<T>() : T(0));
            }
          }
        }
      }
      __syncwarp();
      chol::store_rows(buf, out + off, n * n, n, ld, lane, 32);
      return;
    }
  }
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int i = lane + 32 * h;
    if (i < n) out[static_cast<size_t>(mat) * n + i] = x[h];
  }
}

// One kernel name per entry point, so that a profile tells them apart.
template <typename T, int N, bool kPad>
__global__ void chol_factor_kernel(const T* __restrict__ A, const T* __restrict__ unused,
                                   T* __restrict__ L, int batch, int n) {
  chol_body<T, N, kPad, Op::kFactor>(A, unused, L, batch, n);
}
template <typename T, int N, bool kPad>
__global__ void chol_solve_kernel(const T* __restrict__ L, const T* __restrict__ b,
                                  T* __restrict__ x, int batch, int n) {
  chol_body<T, N, kPad, Op::kSolve>(L, b, x, batch, n);
}
template <typename T, int N, bool kPad>
__global__ void chol_factor_solve_kernel(const T* __restrict__ A,
                                         const T* __restrict__ b,
                                         T* __restrict__ x, int batch, int n) {
  chol_body<T, N, kPad, Op::kFactorSolve>(A, b, x, batch, n);
}

template <typename T, int N, bool kPad, Op kOp>
int launch_instance(const T* in, const T* b, T* out, int batch, int n,
                    cudaStream_t stream) {
  const size_t per_warp = static_cast<size_t>(N * lead(N) + 2 * N) * sizeof(T);
  int warps = static_cast<int>(kStaticSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > kWarpsPerBlock ? kWarpsPerBlock : warps);
  const int blocks = (batch + warps - 1) / warps;
  auto kernel = kOp == Op::kFactor  ? chol_factor_kernel<T, N, kPad>
                : kOp == Op::kSolve ? chol_solve_kernel<T, N, kPad>
                                    : chol_factor_solve_kernel<T, N, kPad>;
  kernel<<<blocks, 32 * warps, warps * per_warp, stream>>>(in, b, out, batch, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Op kOp>
int launch(const T* in, const T* b, T* out, int batch, int n,
           cudaStream_t stream) {
  if (n < 1 || n > chol::kMaxN || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 35) return launch_instance<T, 35, false, kOp>(in, b, out, batch, n, stream);
  if (n <= 32) return launch_instance<T, 32, true, kOp>(in, b, out, batch, n, stream);
  return launch_instance<T, 64, true, kOp>(in, b, out, batch, n, stream);
}

}  // namespace

extern "C" {

int chol_factor_f32(const float* A, float* L, int batch, int n, void* stream) {
  return launch<float, Op::kFactor>(A, nullptr, L, batch, n,
                                    static_cast<cudaStream_t>(stream));
}
int chol_factor_f64(const double* A, double* L, int batch, int n, void* stream) {
  return launch<double, Op::kFactor>(A, nullptr, L, batch, n,
                                     static_cast<cudaStream_t>(stream));
}
int chol_solve_f32(const float* L, const float* b, float* x, int batch, int n,
                   void* stream) {
  return launch<float, Op::kSolve>(L, b, x, batch, n,
                                   static_cast<cudaStream_t>(stream));
}
int chol_solve_f64(const double* L, const double* b, double* x, int batch,
                   int n, void* stream) {
  return launch<double, Op::kSolve>(L, b, x, batch, n,
                                    static_cast<cudaStream_t>(stream));
}
int chol_factor_solve_f32(const float* A, const float* b, float* x, int batch,
                          int n, void* stream) {
  return launch<float, Op::kFactorSolve>(A, b, x, batch, n,
                                         static_cast<cudaStream_t>(stream));
}
int chol_factor_solve_f64(const double* A, const double* b, double* x,
                          int batch, int n, void* stream) {
  return launch<double, Op::kFactorSolve>(A, b, x, batch, n,
                                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
