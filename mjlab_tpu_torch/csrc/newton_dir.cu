// The Newton step's direction, fused: x with
//   (qM + Jᵀ diag(w) J [+ Σ_s J_sᵀ B_s J_s] + 1e-10·I) x = grad,
// one warp per world, for nv <= 64 and up to 65535 rows nefc (and cone
// slots).
//
// Replaces mjlab_tpu/physics/solver.py:222 (H = qM + (J.T * w) @ J), the
// cone blocks' einsum at :223-225 (newton_direction_cone) and :227-229
// (cholesky of H + 1e-10·I and the two solve_triangular calls). Neither H
// nor a scaled copy of J reaches device memory.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 on the CUDA cores) at G1's
// shapes (4096 worlds, nefc 1699, nv 35, f32): rows with w_r = 0 add
// exactly nothing (+0 is exact in f32 and f64), so the kernel must read w,
// qM, grad and only the rows of J whose weight is not 0, and write x: at a
// standing rollout's active share (~2% of the rows) ~61 MB, 0.018 ms; the
// dense J alone is 0.97 GB, 0.29 ms. The arithmetic (2 FLOP per active row
// and lower entry of H, then the factor and solves) is below both, but
// each world is a chain of dependent steps (read w, find the active rows,
// read them, factor: 35 columns, each a shuffle, a root and a __syncwarp),
// and on the card the kernel is bound by that chain's latency and by the
// factor's instructions, not by bytes. The products run as f32 (or f64)
// FMAs on the CUDA cores, not the tensor cores: the port keeps TF32 off.
//
// Design: one world per block of one warp, the whole batch launched at
// once. At G1's shapes in f32 a warp takes ≤ 128 registers (the factor's
// rows, 70 of them, dominate) and 13.5 KB of shared memory, so 16 share an
// SM; as blocks retire the scheduler starts the next ones, and one world's
// factor overlaps other worlds' loads. Measured slower on the card and not
// kept (PERF.md §6): a persistent version, one resident wave of warps each
// walking over worlds with the next world's inputs prefetched (with
// several warps per block ptxas also emitted a second, divergent-safe copy
// of every collective section); issuing each active row's copy as the scan
// finds it, with no nefc-long list and qM loaded straight into the lanes'
// blocks; and testing the cone blocks from 16-byte loads of consecutive
// values through a bit per value. Per world, with no block barrier:
//   1. qM is copied into the second tile with cp.async while the scans run
//      (16-byte copies for its body: it lands at its source's offset from a
//      16-byte boundary); the lane-owned blocks of H start as qM.
//   2. Scan: each lane reads kVec rows of w with one 16-byte load
//      (elementwise at w's two ends), kBatch loads in flight, so that
//      G1's 1699 rows take two round trips; the active rows (w != 0; a NaN
//      counts, so that it reaches x as in the plain version) are listed in
//      row order (uint16, nefc at most), a lane's rank from one ballot per
//      element.
//   3. The listed rows of J stream through a double-buffered pair of
//      kTileRows-row tiles with 4- or 8-byte cp.async copies (consecutive
//      lanes on consecutive elements), their weights beside them. Lane
//      l < 28 owns one block of the 7 × 7 grid of BS × BS blocks of H's
//      lower half (BS = ceil(N / 7), 5 at nv 35) and keeps it in registers:
//      per row it reads 2 × BS values (≥ 5 columns apart within a row of
//      ≤ 35 consecutive words: no bank conflicts) for BS² FMAs, in row
//      order, so that a row of weight 0 changes nothing, bitwise.
//   4. The lanes write their blocks into the first tile, read their rows
//      with 1e-10 on the diagonal, as solver._hessian does, and factor and
//      solve with chol_core.cuh's code, each pivot's reciprocal root one
//      rsqrt; x is NaN if a pivot was not positive.
//
// The elliptic cone (newton_direction_cone) adds Σ_s J_sᵀ B_s J_s over the
// cone slots s: B_s is the slot's (cd × cd) cone Hessian, J_s its cd
// consecutive rows of J; B_s is 0 in the cone's top zone and for an
// inactive contact. A lane per slot tests its block (not all 0; a NaN
// counts), the loads of four chunks of 32 dim-3 slots in flight at once,
// and the active slots follow the regular rows through the same tiles,
// several to a tile, none split across two. Per slot and row c the lanes
// form their columns of the virtual row V_c = Σ_d B_s[c][d] U_d (U = J_s)
// in registers and add U_c V_cᵀ to their blocks. B_s is symmetric, so the
// lower half is exact. The regular rows have w = 0 on every cone row.
//
// Why not TMA: a world's qM starts at world × n² elements and its J at
// world × nefc × nv (odd counts at G1), so neither is 16-byte aligned, and
// a row of J (140 bytes at nv 35) is not a multiple of 16 bytes. The rows
// move as 4- or 8-byte cp.async copies; qM's body as 16-byte ones, and w
// is read in 16-byte loads from its first 16-byte boundary on.
//
// C interface (ctypes): returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for shapes it does not take) and runs on the given
// stream. newton_direction_config reports the launch it would make.

#include <cstdint>
#include <cstring>

#include "chol_core.cuh"

namespace {

using chol::lead;
using chol::rows_per_lane;

constexpr int kTileRows = 32;
constexpr int kBatch = 8;  // 16-byte loads of w in flight per lane
constexpr int kGrid = 7;   // H's lower half as 7 × 7 blocks: 28, one per lane
constexpr int kOwners = kGrid * (kGrid + 1) / 2;
constexpr int kMaxRows = 65535;  // row and slot indices are kept as uint16
constexpr int kMaxConeDim = 6;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int block_cols(int n) { return (n + kGrid - 1) / kGrid; }
__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
// A tile holds kTileRows rows of J, or one N x N matrix (lead(N)), or qM
// at up to 16 bytes past the tile's start; a whole number of 16 bytes.
template <typename T>
__host__ __device__ constexpr int tile_elems(int n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  return ((kTileRows * n > n * lead(n) ? kTileRows * n : n * lead(n)) + kVec - 1 + kVec - 1) /
         kVec * kVec;
}
// Resident one-warp blocks asked of the compiler: 16 (≤ 128 registers)
// where the factor's rows fit, f32 up to nv 35.
template <typename T, int N>
constexpr int min_blocks() { return sizeof(T) == 4 && N <= 35 ? 16 : 1; }

// One warp's shared memory, 13.5 KB at G1 in f32, so that 16 warps share an
// SM: the two tiles (the second receives qM first, and holds 1 / L[j][j]
// and the solve's scratch at the end; the first is H, then Lᵀ), each
// tile's weights (or, in a tile of cone slots, its slot list), each issued
// tile's row and slot counts, and the active rows' indices (nefc at most;
// once the regular rows are issued, the cone tiles' row lists) and active
// cone slots' (ncone at most).
template <typename T, int N>
struct Layout {
  size_t wt, meta, idx, slots, per_warp;
  __host__ __device__ Layout(int m, int ncone) {
    wt = align16(2 * tile_elems<T>(N) * sizeof(T));
    meta = align16(wt + 2 * kTileRows * sizeof(T));
    idx = align16(meta + 4 * sizeof(int));
    const int list = ncone > 0 && m < 2 * kTileRows ? 2 * kTileRows : m;
    slots = align16(idx + static_cast<size_t>(list) * sizeof(uint16_t));
    per_warp = align16(slots + static_cast<size_t>(ncone) * sizeof(uint16_t));
  }
};

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(kBytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Elements from p down to the 16-byte boundary below it.
template <typename T>
__device__ __forceinline__ int shift_of(const T* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) % 16) / static_cast<int>(sizeof(T));
}

// Copies count contiguous elements of src to dst + shift_of(src) (dst is
// 16-byte aligned with room for count + 16 / sizeof(T) - 1 elements): head
// and tail element by element, the body in 16-byte copies.
template <typename T>
__device__ __forceinline__ void copy_contig(T* dst, const T* __restrict__ src, int count,
                                            int lane) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int sh = shift_of(src);
  const int head = min(count, (kVec - sh) % kVec);
  T* d = dst + sh;
  if (lane < head) cp_async<sizeof(T)>(d + lane, src + lane);
  const int body = (count - head) / kVec;
  for (int v = lane; v < body; v += 32) {
    cp_async<16>(d + head + v * kVec, src + head + v * kVec);
  }
  const int rest = head + body * kVec;
  if (rest + lane < count) cp_async<sizeof(T)>(d + rest + lane, src + rest + lane);
}

// Copies the listed rows rows_of[0 .. rows - 1] of the world's J into dst
// (rows of length n, contiguous); consecutive lanes copy consecutive
// elements.
template <typename T>
__device__ __forceinline__ void issue_rows(const T* __restrict__ Jw, const uint16_t* rows_of,
                                           int rows, int n, T* dst, int lane) {
  const int q = 32 / n, s = 32 % n;
  int t = lane / n, c = lane % n;
  for (int e = lane; e < rows * n; e += 32) {
    cp_async<sizeof(T)>(dst + e, Jw + static_cast<size_t>(rows_of[t]) * n + c);
    c += s;
    t += q;
    if (c >= n) {
      c -= n;
      ++t;
    }
  }
}

template <typename T, int N, bool kPad, bool kCone>
__global__ void __launch_bounds__(32, (min_blocks<T, N>()))
newton_direction_kernel(const T* __restrict__ qM, const T* __restrict__ J,
                        const T* __restrict__ w, const T* __restrict__ grad,
                        const T* __restrict__ cone_B, const int* __restrict__ cone_tab,
                        T* __restrict__ x, int batch, int n_arg, int m, int ncone, int nb) {
  constexpr int ld = lead(N);
  constexpr int R = rows_per_lane(N);
  constexpr int BS = block_cols(N);
  constexpr int kTile = tile_elems<T>(N);
  // One world per one-warp block.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= batch) return;
  const size_t wd = blockIdx.x;
  const Layout<T, N> lay(m, kCone ? ncone : 0);
  unsigned char* mine = smem_raw;
  T* tiles = reinterpret_cast<T*>(mine);
  T* inv = tiles + kTile;  // in the second tile, free by the factor
  T* scratch = inv + N;
  T* wt = reinterpret_cast<T*>(mine + lay.wt);
  // A tile of cone slots keeps its slot list where a tile of rows keeps its
  // weights.
  auto tsl = [&](int t) { return reinterpret_cast<uint16_t*>(wt + t * kTileRows); };
  int* meta = reinterpret_cast<int*>(mine + lay.meta);
  uint16_t* idx = reinterpret_cast<uint16_t*>(mine + lay.idx);
  uint16_t* tl = idx;
  uint16_t* slots = reinterpret_cast<uint16_t*>(mine + lay.slots);
  const int n = kPad ? n_arg : N;
  const unsigned below = (1u << lane) - 1u;

  int bi = 0, bj = lane;  // lane = bi (bi + 1) / 2 + bj, bj <= bi
  while (bj > bi) {
    bj -= bi + 1;
    ++bi;
  }
  const bool owner = lane < kOwners;
  if (!owner) bi = bj = 0;

  const T* Jw = J + wd * m * n;
  const T* ww = w + wd * m;
  const T* Bw = kCone ? cone_B + wd * nb : nullptr;
  const T* q = qM + wd * n * n;
  const T* g = grad + wd * n;
  // qM into the second tile while the scans run.
  copy_contig(tiles + kTile, q, n * n, lane);
  cp_async_commit();

  // 1. The active rows (w != 0; a NaN counts, so that it reaches x as in
  // the plain version), in order. Each lane reads kVec rows with one
  // 16-byte load (elementwise at w's two ends), kBatch loads in flight;
  // a lane's rank among the active rows is the count of active rows in
  // the lanes below it, from one ballot per element.
  int total = 0;
  {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const int sh = shift_of(ww);
    const T* base = ww - sh;  // 16-byte aligned
    const int chunks = (m + sh + kVec - 1) / kVec;
    for (int c0 = 0; c0 < chunks; c0 += 32 * kBatch) {
      T v[kBatch][kVec];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + 32 * u + lane, r0 = c * kVec - sh;
        if (r0 >= 0 && r0 + kVec <= m) {
          const uint4 raw = *reinterpret_cast<const uint4*>(base + c * kVec);
          memcpy(v[u], &raw, 16);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            v[u][e] = r0 + e >= 0 && r0 + e < m ? ww[r0 + e] : T(0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r0 = (c0 + 32 * u + lane) * kVec - sh;
        int rank = total, here = 0;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const unsigned ball = __ballot_sync(chol::kFullMask, v[u][e] != T(0));
          rank += __popc(ball & below);
          here += __popc(ball);
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (v[u][e] != T(0)) idx[rank++] = static_cast<uint16_t>(r0 + e);
        }
        total += here;
      }
    }
  }
  // 1b. The cone slots whose block is not all 0 (a NaN counts), in order;
  // each lane tests one slot of each of kSlotChunks chunks of 32, the
  // blocks' loads all in flight at once (dim-3 blocks; other dims one
  // slot at a time).
  int nact = 0;
  if constexpr (kCone) {
    constexpr int kSlotChunks = 4;
    for (int base = 0; base < ncone; base += 32 * kSlotChunks) {
      T e[kSlotChunks][9];
      int cd[kSlotChunks];
#pragma unroll
      for (int u = 0; u < kSlotChunks; ++u) {
        const int s = base + 32 * u + lane;
        cd[u] = s < ncone ? __ldg(cone_tab + 3 * s + 1) : 0;
        const T* b = Bw + (s < ncone ? __ldg(cone_tab + 3 * s + 2) : 0);
#pragma unroll
        for (int k = 0; k < 9; ++k) e[u][k] = cd[u] == 3 ? b[k] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kSlotChunks; ++u) {
        const int s = base + 32 * u + lane;
        bool act = false;
#pragma unroll
        for (int k = 0; k < 9; ++k) act |= !(e[u][k] == T(0));
        if (cd[u] != 3 && s < ncone) {
          const T* b = Bw + __ldg(cone_tab + 3 * s + 2);
          for (int k = 0; k < cd[u] * cd[u]; ++k) act |= !(b[k] == T(0));
        }
        const unsigned ball = __ballot_sync(chol::kFullMask, act);
        if (act) slots[nact + __popc(ball & below)] = static_cast<uint16_t>(s);
        nact += __popc(ball);
      }
    }
  }

  // 2. The lane's block of H starts as qM's.
  cp_async_wait<0>();
  __syncwarp();
  T acc[BS][BS];
  {
    const T* qs = tiles + kTile + shift_of(q);
#pragma unroll
    for (int a = 0; a < BS; ++a) {
#pragma unroll
      for (int b = 0; b < BS; ++b) {
        const int i = bi * BS + a, c = bj * BS + b;
        acc[a][b] = !kPad || (i < n && c < n) ? qs[i * n + c] : T(0);
      }
    }
  }
  __syncwarp();

  // 3. Tiles of the active rows, then of the active slots (several to a
  // tile, none split), two in flight: fills tile t's row list (and slot
  // list), issues its copies and returns whether there was one.
  int rpos = 0, spos = 0;
  auto produce = [&](int t) {
    uint16_t* rows_of = tl + t * kTileRows;
    int rows = 0, ns = 0;
    if (rpos < total) {
      rows = min(kTileRows, total - rpos);
      rows_of = idx + rpos;
      if (lane < rows) cp_async<sizeof(T)>(wt + t * kTileRows + lane, ww + idx[rpos + lane]);
      rpos += rows;
    } else if (kCone) {
      while (spos < nact) {
        const int s = slots[spos];
        const int cd = __ldg(cone_tab + 3 * s + 1);
        if (rows + cd > kTileRows) break;
        if (lane < cd) rows_of[rows + lane] = static_cast<uint16_t>(__ldg(cone_tab + 3 * s) + lane);
        if (lane == 0) tsl(t)[ns] = static_cast<uint16_t>(s);
        rows += cd;
        ++ns;
        ++spos;
      }
      __syncwarp();
    }
    if (rows == 0) return false;
    issue_rows(Jw, rows_of, rows, n, tiles + t * kTile, lane);
    cp_async_commit();
    if (lane == 0) {
      meta[2 * t] = rows;
      meta[2 * t + 1] = ns;
    }
    return true;
  };
  auto consume = [&](int t) {
    const int rows = meta[2 * t], ns = meta[2 * t + 1];
    const T* tile = tiles + t * kTile;
    if (!kCone || ns == 0) {
      const T* wtile = wt + t * kTileRows;
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
    } else {
      // Per slot and row c, the lane's columns of V_c = Σ_d B_s[c][d] U_d
      // (U = the slot's rows), then U_c V_cᵀ into its block.
      int p = 0;
      for (int k = 0; k < ns; ++k) {
        const int s = tsl(t)[k];
        const int cd = __ldg(cone_tab + 3 * s + 1), off = __ldg(cone_tab + 3 * s + 2);
        const T* U = tile + p * n;
        T uj[kMaxConeDim][BS];
#pragma unroll
        for (int d = 0; d < kMaxConeDim; ++d) {
#pragma unroll
          for (int b = 0; b < BS; ++b) {
            const int cj = bj * BS + b;
            uj[d][b] = d < cd && (!kPad || cj < n) ? U[d * n + cj] : T(0);
          }
        }
#pragma unroll
        for (int c = 0; c < kMaxConeDim; ++c) {
          if (c < cd) {
            T vv[BS], uu[BS];
#pragma unroll
            for (int b = 0; b < BS; ++b) vv[b] = T(0);
#pragma unroll
            for (int d = 0; d < kMaxConeDim; ++d) {
              if (d < cd) {
                const T bcd = Bw[off + c * cd + d];
#pragma unroll
                for (int b = 0; b < BS; ++b) vv[b] = fma(bcd, uj[d][b], vv[b]);
              }
            }
#pragma unroll
            for (int a = 0; a < BS; ++a) {
              const int ci = bi * BS + a;
              uu[a] = !kPad || ci < n ? U[c * n + ci] : T(0);
            }
#pragma unroll
            for (int a = 0; a < BS; ++a) {
#pragma unroll
              for (int b = 0; b < BS; ++b) acc[a][b] = fma(uu[a], vv[b], acc[a][b]);
            }
          }
        }
        p += cd;
      }
    }
  };
  __syncwarp();
  bool have = produce(0);
  for (int t = 0; have; t ^= 1) {
    const bool more = produce(t ^ 1);
    if (more) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    consume(t);
    __syncwarp();
    have = more;
  }

  // 4. H = qM + Σ into the first tile, its rows with 1e-10 on the
  // diagonal (solver._hessian), the factor and the solves.
  T* H = tiles;
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
        v = H[i * ld + k];
        if (k == i) v += T(1e-10);
      }
      hrows[h][k] = v;
    }
    r[h] = i < n ? g[i] : T(0);
  }
  if constexpr (chol::has_spare_row(N)) chol::set_spare_row<T, N>(g, lane, hrows);
  __syncwarp();
  const bool ok = chol::warp_factor<T, N>(hrows, H, inv, lane);
  __syncwarp();
  T xs[R];
  chol::solve_factored<T, N>(hrows, H, inv, scratch, n, lane, r, xs);
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int i = lane + 32 * h;
    if (i < n) x[wd * n + i] = ok ? xs[h] : chol::nan_value<T>();
  }
}

// Lets the instance take up to kMaxSmem of dynamic shared memory and the
// whole carveout, once per device.
template <typename T, int N, bool kPad, bool kCone>
cudaError_t prepare(int* dev) {
  static int dev_seen = -1;
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess || *dev == dev_seen) return e;
  auto kernel = newton_direction_kernel<T, N, kPad, kCone>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess) dev_seen = *dev;
  return e;
}

// One block of one warp per world. With `report`, launches nothing and
// fills it instead (see newton_direction_config).
template <typename T, int N, bool kPad, bool kCone>
int launch_instance(const T* qM, const T* J, const T* w, const T* grad, const T* cone_B,
                    const int* cone_tab, T* x, int batch, int n, int m, int ncone, int nb,
                    cudaStream_t stream, int* report) {
  auto kernel = newton_direction_kernel<T, N, kPad, kCone>;
  const size_t bytes = Layout<T, N>(m, kCone ? ncone : 0).per_warp;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = prepare<T, N, kPad, kCone>(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (report != nullptr) {
    cudaFuncAttributes attr;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, bytes);
    }
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int out[8] = {1, per_sm, sms, batch, static_cast<int>(bytes), attr.numRegs,
                        static_cast<int>(attr.localSizeBytes), N};
    for (int k = 0; k < 8; ++k) report[k] = out[k];
    return static_cast<int>(cudaSuccess);
  }
  kernel<<<batch, 32, bytes, stream>>>(qM, J, w, grad, cone_B, cone_tab, x, batch, n, m, ncone,
                                       nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kCone>
int launch(const T* qM, const T* J, const T* w, const T* grad, const T* cone_B,
           const int* cone_tab, T* x, int batch, int n, int m, int ncone, int nb,
           cudaStream_t stream, int* report = nullptr) {
  if (n < 1 || n > chol::kMaxN || batch < 1 || m < 0 || m > kMaxRows || ncone < 0 ||
      ncone > kMaxRows || nb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxConeDim <= kTileRows, "a cone slot must fit a tile");
  static_assert(2 * 64 <= tile_elems<double>(32), "1 / L[j][j] and scratch fit a tile");
  if (n == 35) {
    return launch_instance<T, 35, false, kCone>(qM, J, w, grad, cone_B, cone_tab, x, batch, n,
                                                m, ncone, nb, stream, report);
  }
  if (n <= 32) {
    return launch_instance<T, 32, true, kCone>(qM, J, w, grad, cone_B, cone_tab, x, batch, n,
                                               m, ncone, nb, stream, report);
  }
  return launch_instance<T, 64, true, kCone>(qM, J, w, grad, cone_B, cone_tab, x, batch, n, m,
                                             ncone, nb, stream, report);
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
// The launch the entry point of this (cone, element size) would make for
// these shapes, launching nothing: out[0..7] = warps per block, resident
// blocks per SM, SMs, blocks of the grid, shared bytes per warp, registers
// per thread, local (spill) bytes per thread, the instance's N.
int newton_direction_config(int cone, int elem_bytes, int batch, int n, int m, int ncone,
                            int nb, int* out) {
  if (elem_bytes == 4) {
    return cone ? launch<float, true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, batch, n, m, ncone, nb, nullptr, out)
                : launch<float, false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                       nullptr, batch, n, m, 0, 0, nullptr, out);
  }
  if (elem_bytes == 8) {
    return cone ? launch<double, true>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                       nullptr, batch, n, m, ncone, nb, nullptr, out)
                : launch<double, false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                        nullptr, batch, n, m, 0, 0, nullptr, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
