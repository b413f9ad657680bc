// Projected Gauss-Seidel on the dual of MuJoCo's soft-constraint problem,
// one world per one-warp block, without forming A = J M^-1 J^T.
//
// Replaces the JAX package's pgs_solve (mjlab_tpu/physics/solver.py:327-362),
// which forms A (nefc x nefc per world: 47.3 GB in f32 at G1's 1699 rows and
// 4096 worlds) and sweeps its rows in a fori_loop inside a fori_loop. Per
// world, in the JAX package's row order, each sweep updates every row i:
//   g   = A_i f + R_i f_i + b_i
//   f_i = clip(f_i - g / max(A_ii + R_i, 1e-15), lo_i, hi_i)
// with R = 1/max(D, 1e-15) on the active rows (D > 0). An inactive row's
// bounds are [0, 0] in the JAX package, so its force stays exactly 0; the
// kernel skips it. The kernel keeps u = M^-1 J^T f instead of A: A_i f =
// J_i u, and a row's change d adds d w_i to u, with w_i = M^-1 J_i^T.
//
// Per world:
//   1. L (the mass matrix's Cholesky factor, smooth.factor_m's qLD) is
//      copied into shared memory with an odd leading dimension;
//   2. the active rows are compacted (a ballot per 32 rows) into a list
//      with their R, b, lo and hi, and for each one w_i (a forward and a
//      back substitution against L, one column per step, the warp's lanes
//      over the rows) and the diagonal J_i w_i + R_i are written to the
//      scratch the wrapper allocates (W, nefc x nv per world: the size of
//      J);
//   3. the sweeps run over the compact list with u in registers (lane j
//      holds u_j and u_{j+32}), each row a dot product with a butterfly
//      reduction and an axpy, the next row's J_i and w_i loaded while the
//      current one is reduced;
//   4. f is scattered back (zero on the inactive rows) and u written.
//
// Bound on the H100: the work is sequential over a world's active rows
// (iterations x active rows dependent steps of a dot, a clip and an axpy),
// so worlds are the parallelism: 4096 one-warp blocks are one wave at 32
// resident per SM. Bytes: J's active rows, L, D, b, lo and hi once, f and
// u written once. Operations: 2 nv^2 per active row for w_i, 4 nv per
// active row and sweep. Both are far below the latency of the row chain;
// this is the simple, right kernel, not yet a fast one.
//
// C interface (ctypes): the entry points return cudaGetLastError() of the
// launch and run on the given stream.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 64;
constexpr double kEps = 1e-15;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// min(max(x, lo), hi), NaN passing through as in jnp.clip.
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The element (column) c of a vector spread over the lanes as r[h] =
// v[lane + 32 h], on every lane.
template <typename T, int R>
__device__ __forceinline__ T lane_pick(const T (&r)[R], int c) {
  const int ch = c >> 5;
  T v = r[0];
#pragma unroll
  for (int h = 1; h < R; ++h) {
    if (h == ch) v = r[h];
  }
  return __shfl_sync(kFull, v, c & 31);
}

// R = rows of nv per lane: 1 for nv <= 32, 2 for nv <= 64.
template <typename T, int R>
__global__ void __launch_bounds__(32)
    pgs_kernel(const T* __restrict__ L, const T* __restrict__ J,
               const T* __restrict__ D, const T* __restrict__ b,
               const T* __restrict__ lo, const T* __restrict__ hi,
               T* __restrict__ f, T* __restrict__ u, T* __restrict__ W,
               T* __restrict__ S, int* __restrict__ idx, int n, int m,
               int iterations) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n | 1;
  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* inv = Ls + n * ld;  // 1 / L[c][c]
  const int lane = threadIdx.x;
  const size_t world = blockIdx.x;
  const size_t wm = world * m;
  L += world * n * n;
  J += wm * n;
  W += wm * n;
  D += wm;
  b += wm;
  lo += wm;
  hi += wm;
  f += wm;
  idx += wm;
  // Per compact entry: R, b, lo, hi, the diagonal and f.
  T* Rc = S + world * 6 * m;
  T* bc = Rc + m;
  T* loc = bc + m;
  T* hic = loc + m;
  T* dc = hic + m;
  T* fc = dc + m;

  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n;
    Ls[r * ld + (e - r * n)] = L[e];
  }
  __syncwarp();
  for (int c = lane; c < n; c += 32) inv[c] = T(1) / Ls[c * ld + c];

  // 2. Compact the active rows.
  int na = 0;
  for (int row0 = 0; row0 < m; row0 += 32) {
    const int i = row0 + lane;
    const T Di = i < m ? D[i] : T(0);
    if (i < m) f[i] = T(0);
    const bool active = Di > T(0);
    const unsigned mask = __ballot_sync(kFull, active);
    const int pos = na + __popc(mask & ((1u << lane) - 1u));
    if (active) {
      idx[pos] = i;
      Rc[pos] = T(1) / (Di > T(kEps) ? Di : T(kEps));
      bc[pos] = b[i];
      loc[pos] = lo[i];
      hic[pos] = hi[i];
      fc[pos] = T(0);
    }
    na += __popc(mask);
  }
  __syncwarp();

  //    w_k = M^-1 J_i^T and the diagonal of each active row.
  for (int k = 0; k < na; ++k) {
    const size_t i = idx[k];
    T jr[R], r[R];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int j = lane + 32 * h;
      jr[h] = j < n ? J[i * n + j] : T(0);
      r[h] = jr[h];
    }
    for (int c = 0; c < n; ++c) {  // L y = J_i^T, y kept in r
      const T y = lane_pick(r, c) * inv[c];
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int j = lane + 32 * h;
        if (j == c) {
          r[h] = y;
        } else if (j > c && j < n) {
          r[h] -= Ls[j * ld + c] * y;
        }
      }
    }
    for (int c = n - 1; c >= 0; --c) {  // L^T x = y, x kept in r
      const T x = lane_pick(r, c) * inv[c];
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int j = lane + 32 * h;
        if (j == c) {
          r[h] = x;
        } else if (j < c) {
          r[h] -= Ls[c * ld + j] * x;
        }
      }
    }
    T dot = T(0);
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int j = lane + 32 * h;
      if (j < n) {
        W[static_cast<size_t>(k) * n + j] = r[h];
        dot += jr[h] * r[h];
      }
    }
    dot = warp_sum(dot);
    if (lane == 0) dc[k] = dot + Rc[k];
  }
  __syncwarp();

  // 3. The sweeps, u = M^-1 J^T f in registers (f starts at 0).
  T uu[R];
#pragma unroll
  for (int h = 0; h < R; ++h) uu[h] = T(0);
  for (int it = 0; it < iterations; ++it) {
    for (int k0 = 0; k0 < na; k0 += 32) {
      const int k = k0 + lane;
      const bool valid = k < na;
      const int ik = valid ? idx[k] : 0;
      const T Rk = valid ? Rc[k] : T(0);
      const T bk = valid ? bc[k] : T(0);
      const T lok = valid ? loc[k] : T(0);
      const T hik = valid ? hic[k] : T(0);
      const T dk = valid ? dc[k] : T(1);
      T fk = valid ? fc[k] : T(0);
      const int cnt = na - k0 < 32 ? na - k0 : 32;
      T jn[R], wn[R];
      {
        const size_t i = __shfl_sync(kFull, ik, 0);
#pragma unroll
        for (int h = 0; h < R; ++h) {
          const int j = lane + 32 * h;
          jn[h] = j < n ? J[i * n + j] : T(0);
          wn[h] = j < n ? W[static_cast<size_t>(k0) * n + j] : T(0);
        }
      }
      for (int e = 0; e < cnt; ++e) {
        T jr[R], wr[R];
#pragma unroll
        for (int h = 0; h < R; ++h) {
          jr[h] = jn[h];
          wr[h] = wn[h];
        }
        if (e + 1 < cnt) {  // the next row's loads, ahead of this row's chain
          const size_t i = __shfl_sync(kFull, ik, e + 1);
#pragma unroll
          for (int h = 0; h < R; ++h) {
            const int j = lane + 32 * h;
            jn[h] = j < n ? J[i * n + j] : T(0);
            wn[h] = j < n ? W[static_cast<size_t>(k0 + e + 1) * n + j] : T(0);
          }
        }
        T dot = T(0);
#pragma unroll
        for (int h = 0; h < R; ++h) dot += jr[h] * uu[h];
        dot = warp_sum(dot);
        T delta = T(0);
        if (lane == e) {
          const T g = dot + Rk * fk + bk;
          const T fnew = clip(fk - g / (dk > T(kEps) ? dk : T(kEps)), lok, hik);
          delta = fnew - fk;
          fk = fnew;
        }
        delta = __shfl_sync(kFull, delta, e);
#pragma unroll
        for (int h = 0; h < R; ++h) uu[h] += delta * wr[h];
      }
      if (valid) fc[k] = fk;
    }
  }
  __syncwarp();

  // 4. f back in row order, and u.
  for (int k = lane; k < na; k += 32) f[idx[k]] = fc[k];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int j = lane + 32 * h;
    if (j < n) u[world * n + j] = uu[h];
  }
}

template <typename T>
int launch(const T* L, const T* J, const T* D, const T* b, const T* lo,
           const T* hi, T* f, T* u, T* W, T* S, int* idx, int batch, int n,
           int m, int iterations, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || m < 1 || batch < 1 || iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n * (n | 1) + n) * sizeof(T);
  if (n <= 32) {
    pgs_kernel<T, 1><<<batch, 32, smem, stream>>>(L, J, D, b, lo, hi, f, u, W,
                                                  S, idx, n, m, iterations);
  } else {
    pgs_kernel<T, 2><<<batch, 32, smem, stream>>>(L, J, D, b, lo, hi, f, u, W,
                                                  S, idx, n, m, iterations);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pgs_solve_f32(const float* L, const float* J, const float* D,
                  const float* b, const float* lo, const float* hi, float* f,
                  float* u, float* W, float* S, int* idx, int batch, int n,
                  int m, int iterations, void* stream) {
  return launch<float>(L, J, D, b, lo, hi, f, u, W, S, idx, batch, n, m,
                       iterations, static_cast<cudaStream_t>(stream));
}
int pgs_solve_f64(const double* L, const double* J, const double* D,
                  const double* b, const double* lo, const double* hi,
                  double* f, double* u, double* W, double* S, int* idx,
                  int batch, int n, int m, int iterations, void* stream) {
  return launch<double>(L, J, D, b, lo, hi, f, u, W, S, idx, batch, n, m,
                        iterations, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
