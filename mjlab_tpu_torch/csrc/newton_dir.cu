// The Newton step's direction, fused: x with
//   (qM + Jᵀ diag(w) J + 1e-10·I) x = grad,
// one warp per world, several worlds per block, for nv <= 64 and up to
// 65535 rows nefc.
//
// Replaces mjlab_tpu/physics/solver.py:222 (H = qM + (J.T * w) @ J) and
// :227-229 (cholesky of H + 1e-10·I and the two solve_triangular calls).
// Neither H nor a scaled copy of J reaches device memory.
//
// Bound on the H100 at G1's shapes (4096 worlds, nefc 1699, nv 35, f32):
// J is 0.97 GB, so reading it once takes 0.29 ms at 3.35 TB/s, while
// Σ_r w_r J_ri J_rj over the 630 lower entries is 8.8 GFLOP, 0.13 ms at
// 67 TFLOP/s on the CUDA cores: the kernel is bound by bytes. Rows with
// w_r = 0 add exactly nothing (+0 is exact in f32 and f64), so the kernel
// reads only the rows whose weight is not 0, and the bytes it must move
// shrink with the active share (about 1% of G1's rows in a standing
// rollout). The products run as f32 (or f64) FMAs on the CUDA cores, not
// the tensor cores: the port keeps TF32 off.
//
// Design, per world (one warp, no block barrier):
//   1. Read w (6.8 KB at G1) and compact the indices of the active rows
//      into shared memory, in row order (a NaN weight counts as active, so
//      NaN reaches the result as it does in the plain version).
//   2. Stream the active rows of J and their weights through a
//      double-buffered pair of kTileRows-row tiles with 4- or 8-byte
//      cp.async copies: a world's J starts at world × nefc × nv elements,
//      an odd count at G1, so no wider alignment holds. Consecutive lanes
//      copy consecutive elements of a row.
//   3. Lane l < 28 owns one block of the 7 × 7 grid of BS × BS blocks of
//      H's lower half (BS = ceil(N / 7), 5 at nv 35) and keeps it in
//      registers: per row it reads 2 × BS values (the 7 blocks a warp
//      reads are ≥ 5 columns apart within a row of ≤ 35 consecutive words,
//      so no bank conflicts) for BS² FMAs.
//   4. The lanes write their blocks into H in shared memory; each lane
//      then reads its row of qM + H, adds 1e-10 on the diagonal, as
//      solver._hessian does, and the warp factors and solves with
//      chol_core.cuh's code and writes x (NaN if a pivot was not positive).
// A warp per world, rather than a block, lets some 16 worlds share an SM
// at once, so that one world's dependent factor steps overlap other
// worlds' loads.
//
// The elliptic cone's entry (newton_direction_cone) adds, per world,
//   Σ_s J_sᵀ B_s J_s
// over the cone slots s: B_s is the slot's (cd × cd) cone Hessian, J_s its
// cd consecutive rows of J (a slot's rows are contiguous). It replaces the
// einsum at mjlab_tpu/physics/solver.py:223-225, which the JAX package adds
// to H before the same factor and solves. B_s is 0 in the cone's top zone
// and for an inactive contact, so the kernel first compacts the slots
// whose block is not all 0 (a NaN counts), reading the packed blocks once
// (379 × 9 values per world at G1), then for each such slot loads its rows
// U = J_s (cd × n) and B_s into shared memory, forms the "virtual rows"
// V = B_s U there, and adds Σ_c U_c V_cᵀ to the lane-owned blocks of H's
// lower half as it adds w_r J_r J_rᵀ for a regular row. B_s is symmetric,
// so the lower half is exact. Per active slot that is (cd + 1) row reads
// and (cd² + cd) · n FMAs; the regular rows (w = 0 on every cone row) go
// through steps 1-3 unchanged. The slots are taken one at a time with plain
// loads, no double buffering: a first, simple design. Its bound is the
// same as the regular kernel's: J's active rows once, plus the blocks.
//
// C interface (ctypes): returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for shapes it does not take) and runs on the given
// stream.

#include <cstdint>

#include "chol_core.cuh"

namespace {

using chol::lead;
using chol::rows_per_lane;

constexpr int kWarpsPerBlock = 4;
constexpr int kTileRows = 32;
constexpr int kGrid = 7;  // H's lower half as 7 × 7 blocks: 28, one per lane
constexpr int kOwners = kGrid * (kGrid + 1) / 2;
constexpr int kMaxRows = 65535;  // row indices are kept as uint16
constexpr size_t kStaticSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int block_cols(int n) { return (n + kGrid - 1) / kGrid; }
__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
// A tile holds kTileRows rows of J, or one N x N matrix (lead(N)).
__host__ __device__ constexpr int tile_elems(int n) {
  return kTileRows * n > n * lead(n) ? kTileRows * n : n * lead(n);
}

// One warp's shared memory: two tiles (H, then Lᵀ, reuse the first; qM the
// second; a cone slot's U, V and B in between), their rows' weights,
// 1 / L[j][j], scratch, the active rows' indices (nefc of them at most)
// and the active cone slots' (ncone at most).
template <typename T, int N>
struct Layout {
  size_t wt, inv, scratch, idx, slots, per_warp;
  __host__ __device__ Layout(int m, int ncone) {
    wt = align16(2 * tile_elems(N) * sizeof(T));
    inv = align16(wt + 2 * kTileRows * sizeof(T));
    scratch = align16(inv + N * sizeof(T));
    idx = align16(scratch + N * sizeof(T));
    slots = align16(idx + static_cast<size_t>(m) * sizeof(uint16_t));
    per_warp = align16(slots + static_cast<size_t>(ncone) * sizeof(uint16_t));
  }
};

constexpr int kMaxConeDim = 6;

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies active rows first .. first + rows - 1 of the world's J into dst
// (rows of length n, contiguous) and their weights into wdst.
template <typename T>
__device__ __forceinline__ void issue_tile(const T* __restrict__ Jw,
                                           const T* __restrict__ ww,
                                           const uint16_t* idx, int first,
                                           int rows, int n, T* dst, T* wdst,
                                           int lane) {
  const int q = 32 / n, s = 32 % n;
  int t = lane / n, c = lane % n;
  for (int e = lane; e < rows * n; e += 32) {
    cp_async<sizeof(T)>(dst + e, Jw + static_cast<size_t>(idx[first + t]) * n + c);
    c += s;
    t += q;
    if (c >= n) {
      c -= n;
      ++t;
    }
  }
  if (lane < rows) cp_async<sizeof(T)>(wdst + lane, ww + idx[first + lane]);
}

template <typename T, int N, bool kPad, bool kCone>
__global__ void newton_direction_kernel(const T* __restrict__ qM,
                                        const T* __restrict__ J,
                                        const T* __restrict__ w,
                                        const T* __restrict__ grad,
                                        const T* __restrict__ cone_B,
                                        const int* __restrict__ cone_tab,
                                        T* __restrict__ x, int batch, int n_arg,
                                        int m, int ncone, int nb) {
  constexpr int ld = lead(N);
  constexpr int R = rows_per_lane(N);
  constexpr int BS = block_cols(N);
  constexpr int kTile = tile_elems(N);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t world = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (world >= static_cast<size_t>(batch)) return;
  const Layout<T, N> lay(m, kCone ? ncone : 0);
  unsigned char* mine = smem_raw + warp * lay.per_warp;
  T* tiles = reinterpret_cast<T*>(mine);
  T* wt = reinterpret_cast<T*>(mine + lay.wt);
  T* inv = reinterpret_cast<T*>(mine + lay.inv);
  T* scratch = reinterpret_cast<T*>(mine + lay.scratch);
  uint16_t* idx = reinterpret_cast<uint16_t*>(mine + lay.idx);

  const int n = kPad ? n_arg : N;
  const T* Jw = J + world * m * n;
  const T* ww = w + world * m;

  // 1. Active rows, in order; kBatch loads of w in flight per lane.
  constexpr int kBatch = 8;
  int total = 0;
  for (int base = 0; base < m; base += 32 * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = base + 32 * u + lane;
      v[u] = r < m ? ww[r] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool act = v[u] != T(0);
      const unsigned ball = __ballot_sync(chol::kFullMask, act);
      if (act) {
        idx[total + __popc(ball & ((1u << lane) - 1u))] =
            static_cast<uint16_t>(base + 32 * u + lane);
      }
      total += __popc(ball);
    }
  }
  __syncwarp();

  // 2-3. Stream the active rows' tiles and accumulate this lane's block.
  int bi = 0, bj = lane;  // lane = bi (bi + 1) / 2 + bj, bj <= bi
  while (bj > bi) {
    bj -= bi + 1;
    ++bi;
  }
  const bool owner = lane < kOwners;
  if (!owner) bi = bj = 0;
  T acc[BS][BS];
#pragma unroll
  for (int a = 0; a < BS; ++a) {
#pragma unroll
    for (int b = 0; b < BS; ++b) acc[a][b] = T(0);
  }
  const int ntiles = (total + kTileRows - 1) / kTileRows;
  if (ntiles > 0) issue_tile(Jw, ww, idx, 0, min(kTileRows, total), n, tiles, wt, lane);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int first = t * kTileRows;
    const int rows = min(kTileRows, total - first);
    const int nxt = (t + 1) & 1;
    if (t + 1 < ntiles) {
      issue_tile(Jw, ww, idx, first + kTileRows, min(kTileRows, total - first - kTileRows),
                 n, tiles + nxt * kTile, wt + nxt * kTileRows, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const T* tile = tiles + (t & 1) * kTile;
    const T* wtile = wt + (t & 1) * kTileRows;
#pragma unroll 2
    for (int rr = 0; rr < rows; ++rr) {
      const T* row = tile + rr * n;
      const T wr = wtile[rr];
      T wji[BS], jj[BS];
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        const int ci = bi * BS + a, cj = bj * BS + a;
        wji[a] = !kPad || ci < n ? row[ci] * wr : T(0);
        jj[a] = !kPad || cj < n ? row[cj] : T(0);
      }
#pragma unroll
      for (int a = 0; a < BS; ++a) {
#pragma unroll
        for (int b = 0; b < BS; ++b) acc[a][b] = fma(wji[a], jj[b], acc[a][b]);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncwarp();

  if constexpr (kCone) {
    // 3b. The cone slots whose block is not all 0, in order, then each
    // one's Σ_c U_c V_cᵀ, V = B_s U, into the lane-owned blocks.
    uint16_t* slots = reinterpret_cast<uint16_t*>(mine + lay.slots);
    const T* Bw = cone_B + world * static_cast<size_t>(nb);
    int nact = 0;
    for (int base = 0; base < ncone; base += 32) {
      const int s = base + lane;
      bool act = false;
      if (s < ncone) {
        const int cd = cone_tab[3 * s + 1], off = cone_tab[3 * s + 2];
        for (int e = 0; e < cd * cd; ++e) act = act || !(Bw[off + e] == T(0));
      }
      const unsigned ball = __ballot_sync(chol::kFullMask, act);
      if (act) slots[nact + __popc(ball & ((1u << lane) - 1u))] = static_cast<uint16_t>(s);
      nact += __popc(ball);
    }
    __syncwarp();
    T* U = tiles;
    T* V = tiles + kMaxConeDim * n;
    T* Bs = tiles + 2 * kMaxConeDim * n;
    for (int k = 0; k < nact; ++k) {
      const int s = slots[k];
      const int adr = cone_tab[3 * s], cd = cone_tab[3 * s + 1], off = cone_tab[3 * s + 2];
      const T* Js = Jw + static_cast<size_t>(adr) * n;
      for (int e = lane; e < cd * n; e += 32) U[e] = Js[e];
      if (lane < cd * cd) Bs[lane] = Bw[off + lane];
      if (lane + 32 < cd * cd) Bs[lane + 32] = Bw[off + lane + 32];
      __syncwarp();
      for (int e = lane; e < cd * n; e += 32) {
        const int a = e / n, j = e - a * n;
        T v = T(0);
        for (int b = 0; b < cd; ++b) v = fma(Bs[a * cd + b], U[b * n + j], v);
        V[e] = v;
      }
      __syncwarp();
      if (owner) {
        for (int c = 0; c < cd; ++c) {
          T uu[BS], vv[BS];
#pragma unroll
          for (int a = 0; a < BS; ++a) {
            const int ci = bi * BS + a, cj = bj * BS + a;
            uu[a] = !kPad || ci < n ? U[c * n + ci] : T(0);
            vv[a] = !kPad || cj < n ? V[c * n + cj] : T(0);
          }
#pragma unroll
          for (int a = 0; a < BS; ++a) {
#pragma unroll
            for (int b = 0; b < BS; ++b) acc[a][b] = fma(uu[a], vv[b], acc[a][b]);
          }
        }
      }
      __syncwarp();
    }
  }

  // 4. H = Σ_r w_r J_r J_rᵀ into the first tile, qM into the second.
  T* H = tiles;
  T* qs = tiles + kTile;
  if (owner) {
#pragma unroll
    for (int a = 0; a < BS; ++a) {
#pragma unroll
      for (int b = 0; b < BS; ++b) {
        const int i = bi * BS + a, c = bj * BS + b;
        if (i < n && c <= i) H[i * ld + c] = acc[a][b];
      }
    }
  }
  chol::load_rows(qM + world * n * n, qs, n * n, n, ld, lane, 32);
  __syncwarp();
  T hrows[R][N];
  T r[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int i = lane + 32 * h;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      T v = k == i ? T(1) : T(0);
      if (i < n && k < n && k <= i) {
        v = qs[i * ld + k] + H[i * ld + k];
        if (k == i) v += T(1e-10);
      }
      hrows[h][k] = v;
    }
    r[h] = i < n ? grad[world * n + i] : T(0);
  }
  if constexpr (chol::has_spare_row(N)) {
    chol::set_spare_row<T, N>(grad + world * n, lane, hrows);
  }
  __syncwarp();
  const bool ok = chol::warp_factor<T, N>(hrows, H, inv, lane);
  __syncwarp();
  T xs[R];
  chol::solve_factored<T, N>(hrows, H, inv, scratch, n, lane, r, xs);
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int i = lane + 32 * h;
    if (i < n) x[world * n + i] = ok ? xs[h] : chol::nan_value<T>();
  }
}

template <typename T, int N, bool kPad, bool kCone>
int launch_instance(const T* qM, const T* J, const T* w, const T* grad, const T* cone_B,
                    const int* cone_tab, T* x, int batch, int n, int m, int ncone, int nb,
                    cudaStream_t stream) {
  const size_t per_warp = Layout<T, N>(m, kCone ? ncone : 0).per_warp;
  if (per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int warps = static_cast<int>(kMaxSmem / per_warp);
  warps = warps > kWarpsPerBlock ? kWarpsPerBlock : warps;
  const size_t bytes = warps * per_warp;
  auto kernel = newton_direction_kernel<T, N, kPad, kCone>;
  if (bytes > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (batch + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, bytes, stream>>>(qM, J, w, grad, cone_B, cone_tab, x, batch,
                                                n, m, ncone, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kCone>
int launch(const T* qM, const T* J, const T* w, const T* grad, const T* cone_B,
           const int* cone_tab, T* x, int batch, int n, int m, int ncone, int nb,
           cudaStream_t stream) {
  if (n < 1 || n > chol::kMaxN || batch < 1 || m < 0 || m > kMaxRows || ncone < 0 ||
      ncone > kMaxRows || nb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A slot's U and V (cd rows each) and its block share one tile.
  static_assert(2 * kMaxConeDim * 64 + kMaxConeDim * kMaxConeDim <= 2 * tile_elems(64),
                "cone scratch exceeds the tiles");
  if (n == 35) {
    return launch_instance<T, 35, false, kCone>(qM, J, w, grad, cone_B, cone_tab, x, batch, n,
                                                m, ncone, nb, stream);
  }
  if (n <= 32) {
    return launch_instance<T, 32, true, kCone>(qM, J, w, grad, cone_B, cone_tab, x, batch, n,
                                               m, ncone, nb, stream);
  }
  return launch_instance<T, 64, true, kCone>(qM, J, w, grad, cone_B, cone_tab, x, batch, n, m,
                                             ncone, nb, stream);
}

}  // namespace

extern "C" {

int newton_direction_f32(const float* qM, const float* J, const float* w,
                         const float* grad, float* x, int batch, int n, int m,
                         void* stream) {
  return launch<float, false>(qM, J, w, grad, nullptr, nullptr, x, batch, n, m, 0, 0,
                              static_cast<cudaStream_t>(stream));
}
int newton_direction_f64(const double* qM, const double* J, const double* w,
                         const double* grad, double* x, int batch, int n, int m,
                         void* stream) {
  return launch<double, false>(qM, J, w, grad, nullptr, nullptr, x, batch, n, m, 0, 0,
                               static_cast<cudaStream_t>(stream));
}
// cone_B: (batch, nb) packed cone blocks; cone_tab: (ncone, 3) int32
// [first row, cd <= 6, offset of the block in a world's nb].
int newton_direction_cone_f32(const float* qM, const float* J, const float* w,
                              const float* grad, const float* cone_B, const int* cone_tab,
                              float* x, int batch, int n, int m, int ncone, int nb,
                              void* stream) {
  return launch<float, true>(qM, J, w, grad, cone_B, cone_tab, x, batch, n, m, ncone, nb,
                             static_cast<cudaStream_t>(stream));
}
int newton_direction_cone_f64(const double* qM, const double* J, const double* w,
                              const double* grad, const double* cone_B, const int* cone_tab,
                              double* x, int batch, int n, int m, int ncone, int nb,
                              void* stream) {
  return launch<double, true>(qM, J, w, grad, cone_B, cone_tab, x, batch, n, m, ncone, nb,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
