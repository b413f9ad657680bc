// Projected Gauss-Seidel on the dual of MuJoCo's soft-constraint problem,
// one world per one-warp block, the dual formed on the world's active rows.
//
// Replaces the JAX package's pgs_solve (mjlab_tpu/physics/solver.py:327-362)
// with b = J a0 - aref formed inside it (:342) and its caller's
// qfrc_constraint = J^T f (:366). The JAX package forms A = J M^-1 J^T on
// every row (47.3 GB in f32 at G1's 1699 rows and 4096 worlds) and sweeps
// its rows in a fori_loop inside a fori_loop. Per world, in row order, each
// sweep updates every row i:
//   g   = A_i f + R_i f_i + b_i
//   f_i = clip(f_i - g / max(A_ii + R_i, 1e-15), lo_i, hi_i)
// with R = 1/max(D, 1e-15) on the active rows (D > 0). An inactive row's box
// is [0, 0], so its force stays exactly 0 and it changes no other row: the
// kernel skips it and reads J, aref, lo and hi on the active rows only.
//
// Per world (na active rows, at most kCap):
//   1. L (the mass matrix's Cholesky factor, smooth.factor_m's qLD) and a0
//      go to shared memory by cp.async while the active rows are listed in
//      row order (idx; D read 16 chunks of 32 rows ahead of their ballots);
//      then the reciprocals of L's pivots replace its diagonal;
//   2. one lane per active row (32 rows at once): the lane loads J_c and
//      forms w_c = M^-1 J_c^T by a forward substitution row by row and a
//      back substitution column by column, every lane reading the same L
//      entries (16-byte broadcasts, a few in flight at a time: all at once,
//      they spilled), and writes w_c to the scratch W (rows of NP = N
//      rounded up to 4);
//   3. the dual on the active rows, AR = J_a W_a^T + diag(R_a), into the
//      scratch AR (nr x nr, nr = na rounded up to 4): W's rows come to
//      shared memory (L's place) 64 at a time, lane c holds J_c and reads
//      each w_r there, AR[r][c] = J_c . w_r, so that A_cr = J_c . w_r as the
//      plain version's J @ (M^-1 J^T) orients it; and b_c = J_c a0 - aref_c;
//   4. the sweeps keep g = AR f + b, not u: lane l holds g, f, the box and
//      1 / the diagonal of the compact rows H l .. H l + H - 1 (H = 1, 2 or
//      4 for na up to 32, 64 or 128). Row r's lane computes its new f_r and
//      the change d; one shuffle broadcasts d and every lane adds
//      AR[r][its H columns] d to its g. AR's rows stream through a ring in
//      shared memory by cp.async, 16 to 32 rows ahead, each lane copying and
//      reading only its own H entries, so that no load and no barrier is in
//      the row chain;
//   5. f goes back to its rows (0 on the inactive ones, written during 1),
//      u = W_a^T f_a and qfrc = J_a^T f_a with the lanes over the dofs.
// A world with more than kCap active rows takes the u-based sweep instead,
// in this kernel (u_path): per active row w_i by a warp substitution into a
// scratch of J's size, then sweeps that keep u = M^-1 J^T f in registers.
//
// Bound on the H100: the bytes are J's active rows, L, a0, D on every row,
// aref, lo and hi on the active rows, f, u and qfrc written: ~0.03 ms at
// G1's ~40 active rows per world. The work is iterations x na dependent row
// updates per world, so the kernel runs at its slowest world's chain: an
// FMA, a clip, a shuffle and H FMAs per row, with no reduction and no load
// in it; forming AR (na^2 dots of N) costs the most before it. The f32
// instances at N <= 35 keep 12 worlds resident per SM (162 registers, no
// spill, 9360 bytes of shared memory at N = 35): one wave of 32 (64
// registers) spilled and ran slower (PERF.md §6). The products run on
// the CUDA cores: TF32 would break the f32 check, and na x 35 is far below
// a wgmma tile.
//
// C interface (ctypes): the entry points return cudaGetLastError() of the
// launch (cudaErrorInvalidValue for shapes or scratch they do not take) and
// run on the given stream; pgs_solve_config reports the launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 64;
constexpr int kCap = 128;  // active rows per world on the dual path
constexpr int kDBatch = 16;  // 32-row chunks of D in flight before their ballots
constexpr double kEps = 1e-15;

// Rows a sweep takes per step: one wait and one commit of copies for each
// group of kRowGroup rows (a multiple of H); the rows swept, na rounded up
// to a group (the rows past na have f = 0 and change nothing).
constexpr int kRowGroup = 4;
__device__ __forceinline__ int rows_swept(int na) {
  return (na + kRowGroup - 1) / kRowGroup * kRowGroup;
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int k = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int k = 2;
};

// Row length of L in shared memory and of W: N rounded up to 4 (16 bytes).
template <int N>
__host__ __device__ constexpr int padded() {
  return (N + 3) / 4 * 4;
}

// Resident worlds per SM asked of ptxas: 12 for f32 at N <= 35 (<= 168
// registers). At 32 (one wave of 4096 worlds on 132 SMs, <= 64 registers)
// and at every budget up to 128 registers ptxas spilled, and one wave ran
// slower than fewer resident worlds (PERF.md §6).
template <typename T, int N>
__host__ __device__ constexpr int min_blocks() {
  return N > 35 ? 8 : (sizeof(T) == 4 ? 12 : 16);
}

// W's rows in shared memory at a time in step 3, and the most rows of AR
// in flight in the sweeps.
constexpr int kStageRows = 64;
constexpr int kRingRows = 32;

// Elements of the shared region that holds L in steps 1-2, W's rows in
// step 3 and the ring of AR's rows in step 4; a0 follows it.
template <int N>
__host__ __device__ constexpr int region() {
  return (N > kStageRows ? N : kStageRows) * padded<N>();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// max and min that return NaN when either operand is NaN, as torch.clamp
// and jnp.clip do.
__device__ __forceinline__ float nan_max(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float y;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || b != b) ? a + b : (a < b ? b : a);
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return nan_min(nan_max(x, lo), hi);
}

// A warp barrier before every G-th 16-byte load of a broadcast vector (L's
// rows, a0, w_r, from shared memory): the loads of one group are in flight
// at once, and ptxas does not hoist the others above it. Without it ptxas
// issued all of L's loads of both substitutions at once and spilled them
// (3.6 KB a lane).
template <int G>
__device__ __forceinline__ void group_fence(int q) {
  if (q % G == 0) __syncwarp();
}
constexpr int kGroupW = 1;  // in step 2, beside the 35-value row
constexpr int kGroupAR = 4;  // in step 3

// The lane's index, read again where it is used: an address computed from
// it there is not kept live across the substitutions and spilled, as one
// computed from threadIdx.x at the kernel's start was.
__device__ __forceinline__ int lane_id() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(l));
  return l;
}

// cp.async of `bytes` (4, 8 or 16; a multiple of 16 above) from global to
// shared memory, its groups, and a wait for all but the newest `pending`.
template <int bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (bytes <= 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src), "n"(bytes)
                 : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < bytes / 16; ++k) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s + 16 * k),
                   "l"(static_cast<const char*>(src) + 16 * k)
                   : "memory");
    }
  }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
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

// (v[0] + v[1]) + (v[2] + v[3]), or v[0] + v[1]: K partial sums of a dot.
template <typename T, int K>
__device__ __forceinline__ T sum_of(const T (&v)[K]) {
  if constexpr (K == 4) {
    return (v[0] + v[1]) + (v[2] + v[3]);
  } else {
    return v[0] + v[1];
  }
}

// J_i (N values, zero past n), or zeros; an exact instance's rows are N
// long.
template <typename T, int N, bool kPad>
__device__ __forceinline__ void load_row(const T* __restrict__ J, int i, bool valid, int n,
                                         T (&r)[N]) {
  const T* row = J + static_cast<size_t>(i) * (kPad ? n : N);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = (valid && (!kPad || j < n)) ? row[j] : T(0);
}

// Step 2: w_c = M^-1 J_c^T for the rows c < 32 chunks, one lane a row; the
// rows past na get w = 0.
template <typename T, int N, bool kPad>
__device__ void form_w(const T* Ls, const T* __restrict__ J, const int* __restrict__ idx,
                       T* __restrict__ W, int n, int na, int lane) {
  constexpr int NP = padded<N>(), K = Vec<T>::k;
  using V = typename Vec<T>::type;
  for (int kc = 0; 32 * kc < rows_swept(na); ++kc) {
    const int c = 32 * kc + lane;
    const bool valid = c < na;
    const int i = valid ? idx[c] : 0;
    T r[N];
    load_row<T, N, kPad>(J, i, valid, n, r);
    // The loops run to constant bounds, their triangles cut by conditions
    // that unrolling resolves, so that r stays in registers.
#pragma unroll
    for (int j = 0; j < N; ++j) {  // L y = J_c^T, row j of L at a time
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < NP / K; ++q) {
        if (q * K < j) {
          group_fence<kGroupW>(q);
          const V v = *reinterpret_cast<const V*>(Ls + j * NP + q * K);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int t = 0; t < K; ++t) {
            if (q * K + t < j) acc += e[t] * r[q * K + t];
          }
        }
      }
      r[j] = (r[j] - acc) * Ls[j * NP + j];
    }
#pragma unroll
    for (int c2 = N - 1; c2 >= 0; --c2) {  // L^T x = y, column c2 of L^T at a time
      const T x = r[c2] * Ls[c2 * NP + c2];
      r[c2] = x;
#pragma unroll
      for (int q = 0; q < NP / K; ++q) {
        if (q * K < c2) {
          group_fence<kGroupW>(q);
          const V v = *reinterpret_cast<const V*>(Ls + c2 * NP + q * K);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int t = 0; t < K; ++t) {
            if (q * K + t < c2) r[q * K + t] -= e[t] * x;
          }
        }
      }
    }
    T* w = W + static_cast<size_t>(32 * kc + lane_id()) * NP;
#pragma unroll
    for (int q = 0; q < NP / K; ++q) {
      V v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int t = 0; t < K; ++t) e[t] = q * K + t < N ? r[q * K + t] : T(0);
      *reinterpret_cast<V*>(w + q * K) = v;
    }
  }
}

// Step 3: AR[r][c] = J_c . w_r (+ R_c on the diagonal) for r, c < nr (rows
// nr apart); zero in the rows and columns past na. W's rows come to shared
// memory (Ws, L's place) 32 at a time by cp.async, and every lane reads the
// same w_r there (16-byte broadcasts) against its J_c.
template <typename T, int N, bool kPad>
__device__ void form_ar(T* Ws, const T* a0s, const T* __restrict__ aref, T* __restrict__ bS,
                        const T* __restrict__ J, const T* __restrict__ D,
                        const int* __restrict__ idx, const T* __restrict__ W,
                        T* __restrict__ AR, int n, int na, int chunks, int nr, int lane) {
  constexpr int NP = padded<N>(), K = Vec<T>::k;
  using V = typename Vec<T>::type;
  for (int rb = 0; rb < nr; rb += kStageRows) {
    const int rows = min(kStageRows, nr - rb);
    __syncwarp();  // the last block's reads are done
#pragma unroll 1
    for (int e = lane; e < rows * NP / K; e += 32) {
      copy_async<16>(Ws + e * K, W + static_cast<size_t>(rb) * NP + e * K);
    }
    copy_commit();
    copy_wait<0>();
    __syncwarp();
    for (int kc = 0; kc < chunks; ++kc) {
      const int c = 32 * kc + lane;
      const bool valid = c < na;
      const int i = valid ? idx[c] : 0;
      T jc[N];
      load_row<T, N, kPad>(J, i, valid, n, jc);
      const T Rc = valid ? T(1) / nan_max(D[i], T(kEps)) : T(0);
      if (rb == 0) {  // b_c = J_c a0 - aref_c, a0 in shared memory past W's rows
        T bb[K] = {};
#pragma unroll
        for (int q = 0; q < NP / K; ++q) {
          group_fence<kGroupAR>(q);
          const V v = *reinterpret_cast<const V*>(a0s + q * K);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int t = 0; t < K; ++t) {
            if (q * K + t < N) bb[t] += jc[q * K + t] * e[t];
          }
        }
        if (valid) bS[c] = sum_of<T, K>(bb) - aref[i];
      }
      for (int r = 0; r < rows; ++r) {
        T part[K] = {};
#pragma unroll
        for (int q = 0; q < NP / K; ++q) {
          group_fence<kGroupAR>(q);
          const V v = *reinterpret_cast<const V*>(Ws + r * NP + q * K);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int t = 0; t < K; ++t) {
            if (q * K + t < N) part[t] += jc[q * K + t] * e[t];
          }
        }
        T dot = sum_of<T, K>(part);
        if (rb + r == c) dot += Rc;
        if (c < nr) AR[(rb + r) * nr + c] = dot;
      }
    }
  }
}

// qfrc += J_i^T f_i (and, with Wc, u += W_c^T f_c) over the rows c < cnt of
// a block whose row c = H o + h lane o holds, its f as fl[h] and its row of J
// as il[h]; the lanes run over the dofs, and the loads of kOutRows rows are
// in flight at once.
constexpr int kOutRows = 4;
template <typename T, int R, int H>
__device__ __forceinline__ void add_rows(const T* __restrict__ J, const T* Wc, int wld,
                                         const T (&fl)[H], const int (&il)[H], int cnt, int n,
                                         int lane, T (&uu)[R], T (&qq)[R]) {
  static_assert(kOutRows % H == 0, "a batch of rows starts at a lane's first row");
  for (int c0 = 0; c0 < cnt; c0 += kOutRows) {
    T fv[kOutRows], jv[kOutRows][R], wv[kOutRows][R];
#pragma unroll
    for (int b = 0; b < kOutRows; ++b) {
      const int c = c0 + b, o = c0 / H + b / H;
      const bool ok = c < cnt;
      fv[b] = __shfl_sync(kFull, fl[b % H], o);
      const size_t i = __shfl_sync(kFull, il[b % H], o);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int j = lane + 32 * q;
        jv[b][q] = ok && j < n ? J[i * n + j] : T(0);
        wv[b][q] = ok && j < n && Wc != nullptr ? Wc[static_cast<size_t>(c) * wld + j] : T(0);
      }
    }
#pragma unroll
    for (int b = 0; b < kOutRows; ++b) {
      if (c0 + b < cnt) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          qq[q] += jv[b][q] * fv[b];
          if (Wc != nullptr) uu[q] += wv[b][q] * fv[b];
        }
      }
    }
  }
}

// Rows of AR in flight per lane in the sweeps: as many as shared memory
// (L's and a0's place, free after step 2) holds, at most 16, in whole
// groups.
template <int N, int H>
__host__ __device__ constexpr int ring_depth() {
  return (region<N>() / (32 * H) < kRingRows ? region<N>() / (32 * H) : kRingRows) /
         kRowGroup * kRowGroup;
}

template <typename T, int H>
struct alignas(H * sizeof(T) < 16 ? H * sizeof(T) : 16) Pack {
  T v[H];
};

// Steps 4 and 5. Lane l holds g, f, the box and 1 / the diagonal of the
// compact rows H l + h (h < H), and row r is lane r / H's. AR's rows stream
// through a ring of D rows in shared memory by cp.async, each lane copying
// and reading its own H entries of a row (no barrier), D rows ahead, a
// group of kRowGroup rows at a time (nr is a multiple of it).
template <typename T, int N, int H>
__device__ void sweep_out(T* ring, const T* __restrict__ J, const T* __restrict__ lo,
                          const T* __restrict__ hi, T* __restrict__ f, T* __restrict__ u,
                          T* __restrict__ qfrc, const T* __restrict__ W,
                          const T* __restrict__ AR, const T* __restrict__ bS,
                          const int* __restrict__ idx, int n, int na, int nr, int iterations,
                          int lane) {
  constexpr int S = 32 * H, NP = padded<N>(), R = (N + 31) / 32, D = ring_depth<N, H>();
  constexpr int G = kRowGroup;
  // AR's rows are nr apart; a ring slot holds 32 H entries, lane l's at H l.
  constexpr int kBytes = H * sizeof(T);
  static_assert(G % H == 0 && D % G == 0 && D >= G, "whole groups of rows");
  T g[H], fr[H], lor[H], hir[H], rd[H];
  int ir[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int c = H * lane + h;
    const bool valid = c < na;
    ir[h] = valid ? idx[c] : 0;
    g[h] = valid ? bS[c] : T(0);  // g = AR f + b at f = 0
    fr[h] = T(0);
    lor[h] = valid ? lo[ir[h]] : T(0);
    hir[h] = valid ? hi[ir[h]] : T(0);
    rd[h] = valid ? T(1) / nan_max(AR[c * nr + c], T(kEps)) : T(0);
  }
  if (nr > 0) {
    T* mine = ring + H * lane;
    const T* arl = AR + H * lane;
    const bool copies = H * lane < nr;  // the lane holds rows that are swept
    int next = 0;  // the first row of the group whose entries are copied next
#pragma unroll
    for (int s = 0; s < D; s += G) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (copies) copy_async<kBytes>(mine + (s + k) * S, arl + (next + k) * nr);
      }
      copy_commit();
      next = next + G == nr ? 0 : next + G;
    }
    int slot = 0;  // the group's first slot
    for (int it = 0; it < iterations; ++it) {
      for (int og = 0; og < nr / G; ++og) {
        copy_wait<D / G - 1>();
        T* group = mine + slot * S;
#pragma unroll
        for (int k = 0; k < G; ++k) {  // row G og + k, lane o's entry h
          const int o = og * (G / H) + k / H, h = k % H;
          const Pack<T, H> a = *reinterpret_cast<const Pack<T, H>*>(group + k * S);
          const T x = clip(fr[h] - g[h] * rd[h], lor[h], hir[h]);
          T delta = x - fr[h];
          if (lane == o) fr[h] = x;
          delta = __shfl_sync(kFull, delta, o);
#pragma unroll
          for (int e = 0; e < H; ++e) g[e] += a.v[e] * delta;
        }
#pragma unroll
        for (int k = 0; k < G; ++k) {
          if (copies) copy_async<kBytes>(group + k * S, arl + (next + k) * nr);
        }
        copy_commit();
        next = next + G == nr ? 0 : next + G;
        slot = slot + G == D ? 0 : slot + G;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  T uu[R], qq[R];
#pragma unroll
  for (int q = 0; q < R; ++q) uu[q] = qq[q] = T(0);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (H * lane + h < na) f[ir[h]] = fr[h];
  }
  add_rows<T, R, H>(J, W, NP, fr, ir, na, n, lane, uu, qq);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = lane_id() + 32 * q;
    if (j < n) {
      u[j] = uu[q];
      qfrc[j] = qq[q];
    }
  }
}

// A world with more than kCap active rows: per active row w_i (a warp
// substitution, the lanes over the dofs) into W, then sweeps that keep
// u = M^-1 J^T f in registers, each row a dot, a clip and an axpy.
template <typename T, int N>
__device__ void u_path(const T* __restrict__ Ls, const T* __restrict__ a0s,
                       const T* __restrict__ J, const T* __restrict__ aref,
                       const T* __restrict__ D, const T* __restrict__ lo,
                       const T* __restrict__ hi, T* __restrict__ f, T* __restrict__ u,
                       T* __restrict__ qfrc, T* __restrict__ W, T* __restrict__ S,
                       const int* __restrict__ idx, int n, int m, int na, int iterations,
                       int lane) {
  constexpr int NP = padded<N>(), R = (N + 31) / 32;
  // Per compact entry: R, b, lo, hi, the diagonal and f.
  T* Rc = S;
  T* bc = Rc + m;
  T* loc = bc + m;
  T* hic = loc + m;
  T* dc = hic + m;
  T* fc = dc + m;
  T a0r[R];
#pragma unroll
  for (int h = 0; h < R; ++h) a0r[h] = lane + 32 * h < n ? a0s[lane + 32 * h] : T(0);

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
      const T y = lane_pick(r, c) * Ls[c * NP + c];
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int j = lane + 32 * h;
        if (j == c) {
          r[h] = y;
        } else if (j > c && j < n) {
          r[h] -= Ls[j * NP + c] * y;
        }
      }
    }
    for (int c = n - 1; c >= 0; --c) {  // L^T x = y, x kept in r
      const T x = lane_pick(r, c) * Ls[c * NP + c];
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const int j = lane + 32 * h;
        if (j == c) {
          r[h] = x;
        } else if (j < c) {
          r[h] -= Ls[c * NP + j] * x;
        }
      }
    }
    T dot = T(0), ab = T(0);
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int j = lane + 32 * h;
      if (j < n) {
        W[static_cast<size_t>(k) * n + j] = r[h];
        dot += jr[h] * r[h];
        ab += jr[h] * a0r[h];
      }
    }
    dot = warp_sum(dot);
    ab = warp_sum(ab);
    if (lane == 0) {
      const T Ri = T(1) / nan_max(D[i], T(kEps));
      Rc[k] = Ri;
      bc[k] = ab - aref[i];
      loc[k] = lo[i];
      hic[k] = hi[i];
      dc[k] = dot + Ri;
      fc[k] = T(0);
    }
  }
  __syncwarp();

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
          const T fnew = clip(fk - g / nan_max(dk, T(kEps)), lok, hik);
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

  T qq[R], none[R];
#pragma unroll
  for (int h = 0; h < R; ++h) qq[h] = none[h] = T(0);
  for (int k0 = 0; k0 < na; k0 += 32) {
    const int k = k0 + lane;
    const T fl = k < na ? fc[k] : T(0);
    const int il = k < na ? idx[k] : 0;
    if (k < na) f[il] = fl;
    const T fl1[1] = {fl};
    const int il1[1] = {il};
    add_rows<T, R, 1>(J, static_cast<const T*>(nullptr), 0, fl1, il1, min(32, na - k0), n, lane,
                      none, qq);
  }
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int j = lane_id() + 32 * h;
    if (j < n) {
      u[j] = uu[h];
      qfrc[j] = qq[h];
    }
  }
}

template <typename T, int N, bool kPad>
__global__ void __launch_bounds__(32, min_blocks<T, N>())
    pgs_kernel(const T* __restrict__ L, const T* __restrict__ J, const T* __restrict__ a0,
               const T* __restrict__ aref, const T* __restrict__ D, const T* __restrict__ lo,
               const T* __restrict__ hi, T* __restrict__ f, T* __restrict__ u,
               T* __restrict__ qfrc, T* __restrict__ W, T* __restrict__ AR,
               T* __restrict__ S, int* __restrict__ idx, int n, int m, int iterations,
               int w_stride, int ar_stride) {
  constexpr int NP = padded<N>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);  // N x NP, 1 / L[c][c] on the diagonal
  T* a0s = Ls + region<N>();
  const int lane = threadIdx.x;
  const size_t world = blockIdx.x;
  const size_t wm = world * m;
  L += world * n * n;
  J += wm * n;
  a0 += world * n;
  aref += wm;
  D += wm;
  lo += wm;
  hi += wm;
  f += wm;
  idx += wm;
  u += world * n;
  qfrc += world * n;
  W += world * w_stride;
  AR += world * ar_stride;
  S += world * 6 * m;

  // L and a0 go to shared memory by cp.async while the active rows are
  // listed; a padded instance's rows past n are the identity's.
  for (int r = 0; r < n; ++r) {
    for (int c = lane; c < n; c += 32) copy_async<sizeof(T)>(Ls + r * NP + c, L + r * n + c);
  }
  for (int c = lane; c < n; c += 32) copy_async<sizeof(T)>(a0s + c, a0 + c);
  copy_commit();
  if (kPad) {
    for (int e = n * NP + lane; e < N * NP; e += 32) Ls[e] = T(e % NP == e / NP ? 1 : 0);
    for (int c = n + lane; c < NP; c += 32) a0s[c] = T(0);
  }

  // Step 1: the active rows in row order; f = 0 on the others.
  int na = 0;
  for (int row0 = 0; row0 < m; row0 += 32 * kDBatch) {
    T d[kDBatch];
#pragma unroll
    for (int q = 0; q < kDBatch; ++q) {
      const int i = row0 + 32 * q + lane;
      d[q] = i < m ? D[i] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kDBatch; ++q) {
      const int i = row0 + 32 * q + lane;
      const bool active = d[q] > T(0);
      const unsigned mask = __ballot_sync(kFull, active);
      if (active) {
        idx[na + __popc(mask & ((1u << lane) - 1u))] = i;
      } else if (i < m) {
        f[i] = T(0);
      }
      na += __popc(mask);
    }
  }
  copy_wait<0>();
  __syncwarp();
  for (int c = lane; c < n; c += 32) Ls[c * NP + c] = T(1) / Ls[c * NP + c];
  na = __reduce_max_sync(kFull, na);  // the same on every lane: uniform registers
  __syncwarp();

  if (na > kCap) {
    u_path<T, N>(Ls, a0s, J, aref, D, lo, hi, f, u, qfrc, W, S, idx, n, m, na, iterations,
                 lane);
    return;
  }
  form_w<T, N, kPad>(Ls, J, idx, W, n, na, lane);
  __syncwarp();
  // H entries of a row per lane in the sweeps: 32 H columns of AR.
  const int H = na <= 32 ? 1 : (na <= 64 ? 2 : 4);
  const int nr = rows_swept(na);
  const int chunks = (nr + 31) >> 5;
  form_ar<T, N, kPad>(Ls, a0s, aref, S, J, D, idx, W, AR, n, na, chunks, nr, lane);
  __syncwarp();
  if (H == 1) {
    sweep_out<T, N, 1>(Ls, J, lo, hi, f, u, qfrc, W, AR, S, idx, n, na, nr, iterations, lane);
  } else if (H == 2) {
    sweep_out<T, N, 2>(Ls, J, lo, hi, f, u, qfrc, W, AR, S, idx, n, na, nr, iterations, lane);
  } else {
    sweep_out<T, N, 4>(Ls, J, lo, hi, f, u, qfrc, W, AR, S, idx, n, na, nr, iterations, lane);
  }
}

// Scratch per world, in elements: W and AR (the wrapper allocates them).
template <int N>
long long w_elems(int n, int m) {
  const long long capr = m < kCap ? (m + 31) / 32 * 32 : kCap;
  const long long a = static_cast<long long>(m) * n, b = capr * padded<N>();
  return a > b ? a : b;
}
inline long long ar_elems(int m) {
  const long long capr = m < kCap ? (m + 31) / 32 * 32 : kCap;
  return capr * capr;
}

template <typename T, int N, bool kPad>
int launch_instance(const T* L, const T* J, const T* a0, const T* aref, const T* D, const T* lo,
                    const T* hi, T* f, T* u, T* qfrc, T* W, T* AR, T* S, int* idx, int batch,
                    int n, int m, int iterations, int w_stride, int ar_stride,
                    cudaStream_t stream, int* report) {
  if (w_stride < w_elems<N>(n, m) || w_stride % 4 != 0 || ar_stride < ar_elems(m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(region<N>() + padded<N>()) * sizeof(T);
  auto kernel = pgs_kernel<T, N, kPad>;
  if (report != nullptr) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, smem);
    }
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int out[6] = {per_sm, sms, static_cast<int>(smem), attr.numRegs,
                        static_cast<int>(attr.localSizeBytes), N};
    for (int k = 0; k < 6; ++k) report[k] = out[k];
    return static_cast<int>(cudaSuccess);
  }
  kernel<<<batch, 32, smem, stream>>>(L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx, n,
                                      m, iterations, w_stride, ar_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* L, const T* J, const T* a0, const T* aref, const T* D, const T* lo,
           const T* hi, T* f, T* u, T* qfrc, T* W, T* AR, T* S, int* idx, int batch, int n,
           int m, int iterations, int w_stride, int ar_stride, cudaStream_t stream,
           int* report = nullptr) {
  if (n < 1 || n > kMaxN || m < 1 || batch < 1 || iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 35) {
    return launch_instance<T, 35, false>(L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx,
                                         batch, n, m, iterations, w_stride, ar_stride, stream,
                                         report);
  }
  if (n <= 32) {
    return launch_instance<T, 32, true>(L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx,
                                        batch, n, m, iterations, w_stride, ar_stride, stream,
                                        report);
  }
  return launch_instance<T, 64, true>(L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx,
                                      batch, n, m, iterations, w_stride, ar_stride, stream,
                                      report);
}

}  // namespace

extern "C" {

// L (batch, n, n), J (batch, m, n), a0 (batch, n), aref, D, lo, hi (batch,
// m); out f (batch, m), u and qfrc (batch, n); scratch W (batch, w_stride),
// AR (batch, ar_stride), S (batch, 6 m), idx (batch, m) int32.
int pgs_solve_f32(const float* L, const float* J, const float* a0, const float* aref,
                  const float* D, const float* lo, const float* hi, float* f, float* u,
                  float* qfrc, float* W, float* AR, float* S, int* idx, int batch, int n, int m,
                  int iterations, int w_stride, int ar_stride, void* stream) {
  return launch<float>(L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx, batch, n, m,
                       iterations, w_stride, ar_stride, static_cast<cudaStream_t>(stream));
}
int pgs_solve_f64(const double* L, const double* J, const double* a0, const double* aref,
                  const double* D, const double* lo, const double* hi, double* f, double* u,
                  double* qfrc, double* W, double* AR, double* S, int* idx, int batch, int n,
                  int m, int iterations, int w_stride, int ar_stride, void* stream) {
  return launch<double>(L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx, batch, n, m,
                        iterations, w_stride, ar_stride, static_cast<cudaStream_t>(stream));
}
// The launch of this element size's instance for n, launching nothing:
// out[0..5] = resident worlds per SM, SMs, shared bytes per world,
// registers per thread, local (spill) bytes per thread, the instance's N.
int pgs_solve_config(int elem_bytes, int n, int* out) {
  const int m = 1;
  const int ws = static_cast<int>(64 * kCap), as = kCap * kCap;
  if (elem_bytes == 4) {
    return launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, n, m, 0, ws,
                         as, nullptr, out);
  }
  if (elem_bytes == 8) {
    return launch<double>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, n,
                          m, 0, ws, as, nullptr, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
