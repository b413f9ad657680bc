// The rest of the Newton iteration, on each world's active rows: the
// gradient (and the row weights and cone blocks the Newton direction
// reads), the exact linesearch with the step's acceptance, and the cost at
// given points; the solve's final forces as a mode of the gradient.
//
// Replaces what XLA fused in the JAX package's solver, for which no TPU
// kernel existed: mjlab_tpu/physics/solver.py newton_iter up to H and after
// the direction (:218-224, :231-266), linesearch (:268-287), the gradients
// and steps of cg_solve (:289-325), the warm start (:189-192) and the final
// forces (:378-386), with the cost pieces they call (residual :166,
// row_cost :169, total_cost :182, row_force :194, row_hess :207, the cone
// functions :105-164). The plain PyTorch versions are in
// kernels/newton.py.
//
// Per world, over qacc x (a0 = qacc_smooth, r = J x - aref):
//   cost(x) = 0.5 (x - a0)^T M (x - a0) + sum_i cost_i(r_i) + sum_s cone_s
// a row's cost by its class (one-sided, equality, friction loss with its
// Huber threshold fl / D), the elliptic cone's slots in three zones. A row
// with D == 0 (and a slot with Dn <= 0) adds exactly nothing to any output:
// the kernels never read its J or aref.
//
// Bound on the H100 (3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores): per
// launch the bytes of D on every row, the active rows of J, their aref (and
// fl), qM's lower triangle, the vectors and the outputs (w or efc_force on
// every row for the gradient): at G1's shapes (4096 worlds, nefc 1699,
// nv 35, f32) with ~40 active rows per world ~63 MB, ~19 us, for the
// linesearch; the arithmetic (a few FLOP per active row and linesearch
// step, 2 n^2 per quadratic form) is far below. Each world is a chain of
// dependent steps (scan D, list, read the rows, reduce, then the
// linesearch's steps, each a warp reduction), so the kernels are bound by
// that chain's latency at this share of active rows, not by bytes.
//
// Design: one world per block of one warp, the whole batch in one grid, so
// that many worlds share an SM and one world's chain overlaps others'
// loads. Per world, with no block barrier:
//   1. qM, a0, x (and p) into shared memory; D is scanned with 16-byte
//      loads, kBatch in flight per lane, and the active rows (D != 0, a NaN
//      counts; not a cone row) listed in row order (uint16), a lane's rank
//      from one ballot per element; in the gradient modes w (or efc_force)
//      is written 0 on every other row during the scan. The cone slots with
//      Dn > 0 follow, one lane per slot, their rows appended to the list
//      (a warp prefix sum of their dims); an inactive slot's Hessian block
//      is written 0.
//   2. The listed rows of J stream through a tile of 32 rows in shared
//      memory (coalesced loads, kBatch in flight per lane; an odd row
//      stride, so that lane l reading row l is free of bank conflicts), and
//      lane l takes the tile's row l: r = J x - aref (and J p) by one FMA
//      chain over the columns, in one order wherever a product is taken.
//      Each row's r, J p, D and fl go to shared memory for the first kCap
//      rows and to a global scratch (the wrapper's) beyond them: a world
//      with more active rows runs the same steps over both.
//   3. Gradient: each regular row's force and weight by its lane, J^T f
//      into the lanes' columns from the tile; each active slot's forces and
//      (cd x cd) Hessian block by one lane, then J^T f over its rows;
//      grad = M (x - a0) - J^T f from qM in shared memory.
//      Linesearch: p M (x - a0) and p M p, then `iterations` steps of the
//      1-D Newton on phi'(alpha) from alpha = 1, the lanes over the stored
//      rows and slots (cone_line's closed forms), two warp reductions per
//      step, until a step returns alpha bitwise (every later one would);
//      then the acceptance, each candidate's cost from the candidate
//      point x + c p (rounded as PyTorch rounds it, no FMA), two points per
//      pass over the rows, so that a candidate equal to x ties with x
//      exactly.
// The quadratic forms and products run as f32 (or f64) FMAs on the CUDA
// cores; tensor cores and TMA are later work (a world's J starts at an odd
// offset and a row of J is 140 bytes at nv 35).
//
// C interface (ctypes): the entry points return cudaGetLastError() of the
// launch (cudaErrorInvalidValue for shapes they do not take) and run on the
// given stream; newton_iter_config reports the launch.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCap = 128;   // listed rows per world in shared memory
constexpr int kFields = 5;  // per listed row: r, J p, D, fl, a scratch value
enum Field { kR = 0, kJv = 1, kD = 2, kFl = 3, kT = 4 };
constexpr int kMaxN = 64;
constexpr int kMaxRows = 65535;  // row and slot indices are kept as uint16
constexpr int kMaxConeDim = 6;
constexpr int kBatch = 8;  // 16-byte loads of D (and of a tile of J) in flight per lane
constexpr size_t kMaxSmem = 227 * 1024;

enum Mode { kGradient = 0, kForces = 1, kLinesearch = 2, kSafeguard = 3, kCost = 4 };
enum Kind { kOneSided = 0, kEq = 1, kFric = 2, kConeRow = 3 };

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// A tile of 32 rows of J keeps an odd row stride, so that lane l reading
// row l's column c hits bank (l ld + c) % 32: 32 banks in float32.
__host__ __device__ constexpr int lead(int n) { return n | 1; }

// One warp's shared memory: qM (n x n), seven vectors of n (x, p, a0, two
// points whose cost is taken together and their differences from a0), a
// tile of 32 rows of J and their 32 forces, the first kCap listed rows'
// fields, the list (m at most) and the active slots' ids and offsets in it.
template <typename T>
struct Layout {
  size_t vec, tile, ftile, store, idx, slot, slot_off, total;
  __host__ __device__ Layout(int n, int m, int ncone) {
    vec = align16(static_cast<size_t>(n) * n * sizeof(T));
    tile = align16(vec + 7 * static_cast<size_t>(n) * sizeof(T));
    ftile = align16(tile + 32 * static_cast<size_t>(lead(n)) * sizeof(T));
    store = align16(ftile + 32 * sizeof(T));
    idx = align16(store + kFields * kCap * sizeof(T));
    slot = align16(idx + static_cast<size_t>(m) * sizeof(uint16_t));
    slot_off = align16(slot + static_cast<size_t>(ncone) * sizeof(uint16_t));
    total = align16(slot_off + static_cast<size_t>(ncone) * sizeof(uint16_t));
  }
};

template <typename T>
struct Args {
  const T* qM;
  const T* J;
  const T* D;
  const T* aref;
  const T* fl;        // (batch, m) or null: no friction-loss row
  const int* kind;    // (m) row classes or null: every row one-sided
  const int* tab;     // (ncone, 3) [first row, cd, block offset]
  const T* mu0;       // (batch, ncone)
  const T* a0;
  const T* x;         // (batch, n); (batch, count, n) for the cost
  const T* p;
  T* out0;
  T* out1;
  T* out2;
  unsigned char* improved;
  T* scratch;         // (batch, kFields, max(m - kCap, 0))
  int batch, n, m, ncone, nb, count;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The same sum in every lane (a + b == b + a exactly).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_int(a) == __float_as_int(b);
}
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// torch.clamp_min: a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) { return v < lo ? lo : v; }

// -- regular rows (kernels/newton.py Rows.row_cost, row_hess, regular_force) --

template <typename T>
__device__ __forceinline__ T row_force(int kind, T D, T fl, T r) {
  const T q = -D * r;
  if (kind == kFric) return q < -fl ? -fl : (q > fl ? fl : q);
  if (kind == kEq) return q;
  return r < T(0) ? q : T(0);
}

template <typename T>
__device__ __forceinline__ T row_hess(int kind, T D, T fl, T r) {
  if (kind == kFric) return fabs(r) <= fl / clamp_min(D, T(1e-30)) ? D : T(0);
  if (kind == kEq) return D;
  return r < T(0) ? D : T(0);
}

template <typename T>
__device__ __forceinline__ T row_cost(int kind, T D, T fl, T r) {
  const T quad = T(0.5) * D * r * r;
  if (kind == kFric) {
    const T lin = fl / clamp_min(D, T(1e-30));
    const T ar = fabs(r);
    return ar > lin ? fl * ar - T(0.5) * fl * lin : quad;
  }
  if (kind == kEq) return quad;
  return r < T(0) ? quad : T(0);
}

// -- one elliptic cone slot (Rows.groups, zones, cone_force, cone_hess,
// cone_cost, cone_line), handled whole by one lane --

template <typename T>
struct Cone {
  static constexpr int kTan = kMaxConeDim - 1;
  int cd;
  T Dn, Df[kTan], s[kTan], mu, one_mu2;

  // Dv: the slot's cd values of D, Dv[0] = Dn > 0.
  __device__ __forceinline__ Cone(int cd_, const T* Dv, T mu0) : cd(cd_) {
    const T eps = T(1e-15);
    Dn = Dv[0];
    const T safe_Dn = clamp_min(Dn, eps);
#pragma unroll
    for (int i = 0; i < kTan; ++i) {
      Df[i] = i < cd - 1 ? Dv[1 + i] : T(0);
      s[i] = i < cd - 1 ? sqrt(clamp_min(Df[i], eps) / safe_Dn) : T(0);
    }
    mu = mu0 * sqrt(safe_Dn / clamp_min(Df[0], eps));
    one_mu2 = add_rn(T(1), mul_rn(mu, mu));
  }

  // The zones at the residuals u (cd): T_, whether top or bottom, a.
  __device__ __forceinline__ void zones(const T* u, T* ut_w, T& Tn, bool& top, bool& bottom,
                                        T& a) const {
    T ss = T(0);
#pragma unroll
    for (int i = 0; i < kTan; ++i) {
      ut_w[i] = i < cd - 1 ? u[1 + i] * s[i] : T(0);
      ss += ut_w[i] * ut_w[i];
    }
    Tn = sqrt(ss + T(1e-15));
    const T N = u[0];
    top = mu * Tn <= N;
    bottom = Tn <= -mu * N;
    a = (mu * Tn - N) / one_mu2;
  }

  __device__ __forceinline__ T cost(const T* u) const {
    T ut_w[kTan], Tn, a;
    bool top, bottom;
    zones(u, ut_w, Tn, top, bottom, a);
    if (top) return T(0);
    if (bottom) {
      T sf = T(0);
#pragma unroll
      for (int i = 0; i < kTan; ++i) sf += i < cd - 1 ? Df[i] * (u[1 + i] * u[1 + i]) : T(0);
      return T(0.5) * (Dn * u[0] * u[0] + sf);
    }
    return T(0.5) * Dn * a * a * one_mu2;
  }

  __device__ __forceinline__ void force(const T* u, T* f) const {
    T ut_w[kTan], Tn, a;
    bool top, bottom;
    zones(u, ut_w, Tn, top, bottom, a);
    const T fn = Dn * a;
#pragma unroll
    for (int c = 0; c < kMaxConeDim; ++c) {
      const int t = c > 0 ? c - 1 : 0;
      T v = T(0);
      if (!top && c < cd) {
        if (bottom) {
          v = c == 0 ? -(Dn * u[0]) : -(Df[t] * u[c]);
        } else {
          v = c == 0 ? fn : -mu * fn * ut_w[t] / Tn * s[t];
        }
      }
      f[c] = v;
    }
  }

  // The (cd x cd) block, row-major, into B.
  __device__ __forceinline__ void hess(const T* u, T* B) const {
    T ut_w[kTan], Tn, a;
    bool top, bottom;
    zones(u, ut_w, Tn, top, bottom, a);
    T gr[kMaxConeDim], s2u[kTan];
    gr[0] = -T(1) / one_mu2;
#pragma unroll
    for (int i = 0; i < kTan; ++i) {
      gr[1 + i] = mu * s[i] * ut_w[i] / Tn / one_mu2;
      s2u[i] = s[i] * ut_w[i];
    }
    const T T3 = Tn * Tn * Tn, k = mu / one_mu2, Dn1 = Dn * one_mu2;
#pragma unroll
    for (int r = 0; r < kMaxConeDim; ++r) {
      const int tr = r > 0 ? r - 1 : 0;
#pragma unroll
      for (int c = 0; c < kMaxConeDim; ++c) {
        const int tc = c > 0 ? c - 1 : 0;
        if (r < cd && c < cd) {
          T v = T(0);
          if (!top) {
            if (bottom) {
              v = r != c ? T(0) : (r == 0 ? Dn : Df[tr]);
            } else {
              T ha = T(0);
              if (r > 0 && c > 0) {
                const T diag = r == c ? s[tr] * s[tr] / Tn : T(0);
                ha = k * (diag - s2u[tr] * s2u[tc] / T3);
              }
              v = Dn1 * (gr[r] * gr[c] + a * ha);
            }
          }
          B[r * cd + c] = v;
        }
      }
    }
  }

  // The linesearch's slope sum_i f_i v_i and curvature v^T B v at
  // u = r0 + alpha v.
  __device__ __forceinline__ void line(const T* r0, const T* v, T alpha, T& slope,
                                       T& curv) const {
    T vsv = T(0), cb = T(0), ut[kTan], ut_w[kTan], ss = T(0), sv = T(0), sb = T(0);
#pragma unroll
    for (int i = 0; i < kTan; ++i) {
      const bool in = i < cd - 1;
      const T vt = in ? v[1 + i] : T(0);
      const T sv_t = s[i] * vt;
      vsv += sv_t * sv_t;
      cb += Df[i] * vt * vt;
      ut[i] = in ? r0[1 + i] + alpha * vt : T(0);
      ut_w[i] = ut[i] * s[i];
      ss += ut_w[i] * ut_w[i];
      sv += ut_w[i] * sv_t;
      sb += Df[i] * vt * ut[i];
    }
    const T v0 = v[0];
    const T curv_bot = Dn * v0 * v0 + cb;
    const T inv1 = T(1) / one_mu2, k = mu / one_mu2, Dn1 = Dn * one_mu2;
    const T N = r0[0] + alpha * v0;
    const T Tn = sqrt(ss + T(1e-15));
    const T muT = mu * Tn;
    const bool top = muT <= N, bottom = Tn <= -mu * N;
    const T a = (muT - N) * inv1;
    const T q = mu * sv / Tn;
    if (top) {
      slope = curv = T(0);
    } else if (bottom) {
      slope = -(Dn * v0 * N + sb);
      curv = curv_bot;
    } else {
      slope = (Dn * a) * (v0 - q);
      const T ga = (q - v0) * inv1;
      const T ha = k * (vsv / Tn - sv * sv / (Tn * Tn * Tn));
      curv = Dn1 * (ga * ga + a * ha);
    }
  }
};

template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 16 : 8; }

// The safeguard's fixed candidates after the linesearch's alpha, in the
// plain version's order (kernels/newton.py SAFEGUARD_STEPS).
template <typename T>
__device__ __forceinline__ T safeguard_step(int c) {
  switch (c) {
    case 1: return T(1);
    case 2: return T(0.5);
    case 3: return T(0.25);
    case 4: return T(0.1);
    default: return T(0.01);
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(32, (min_blocks<T>()))
newton_iter_kernel(const Args<T> g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const size_t wd = blockIdx.x;
  const int n = g.n, m = g.m, S = g.ncone;
  const Layout<T> lay(n, m, S);
  T* qs = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + lay.vec);
  T* ps = xs + n;
  T* a0s = ps + n;
  T* ya = a0s + n;
  T* yb = ya + n;
  T* dya = yb + n;
  T* dyb = dya + n;
  T* tile = reinterpret_cast<T*>(smem + lay.tile);
  T* ftile = reinterpret_cast<T*>(smem + lay.ftile);
  T* st = reinterpret_cast<T*>(smem + lay.store);
  uint16_t* idx = reinterpret_cast<uint16_t*>(smem + lay.idx);
  uint16_t* slot_id = reinterpret_cast<uint16_t*>(smem + lay.slot);
  uint16_t* slot_off = reinterpret_cast<uint16_t*>(smem + lay.slot_off);
  const int ext = m > kCap ? m - kCap : 0;
  T* gs = g.scratch + wd * kFields * static_cast<size_t>(ext);
  // A listed row's field: shared memory for the first kCap rows, the
  // global scratch beyond.
  auto ref = [&](int f, int k) -> T& {
    return k < kCap ? st[f * kCap + k] : gs[static_cast<size_t>(f) * ext + (k - kCap)];
  };
  const T* Dw = g.D + wd * m;
  const T* Jw = g.J + wd * static_cast<size_t>(m) * n;
  const T* arw = g.aref + wd * m;
  const T* flw = g.fl != nullptr ? g.fl + wd * m : nullptr;
  auto kind_of = [&](int row) { return g.kind != nullptr ? __ldg(g.kind + row) : int(kOneSided); };
  constexpr bool kGrad = kMode == kGradient || kMode == kForces;
  constexpr bool kLine = kMode == kLinesearch || kMode == kSafeguard;

  // 1. qM, a0, x (and p) into shared memory.
  {
    const T* q = g.qM + wd * static_cast<size_t>(n) * n;
    for (int e = lane; e < n * n; e += 32) qs[e] = q[e];
    for (int i = lane; i < n; i += 32) {
      a0s[i] = g.a0[wd * n + i];
      if (kMode != kCost) xs[i] = g.x[wd * n + i];
      if (kLine) ps[i] = g.p[wd * n + i];
    }
  }
  // 1b. The active regular rows, in row order; the gradient modes write w
  // (or efc_force) 0 on every other row.
  T* per_row = kGrad ? g.out1 + wd * m : nullptr;
  const unsigned below = (1u << lane) - 1u;
  int nreg = 0;
  {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(Dw) % 16) /
                   static_cast<int>(sizeof(T));
    const T* base = Dw - sh;  // 16-byte aligned
    const int chunks = (m + sh + kVec - 1) / kVec;
    for (int c0 = 0; c0 < chunks; c0 += 32 * kBatch) {
      T v[kBatch][kVec];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + 32 * u + lane, r0 = c * kVec - sh;
        if (r0 >= 0 && r0 + kVec <= m) {
          const uint4 raw = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(c) * kVec);
          memcpy(v[u], &raw, 16);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            v[u][e] = r0 + e >= 0 && r0 + e < m ? Dw[r0 + e] : T(0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r0 = (c0 + 32 * u + lane) * kVec - sh;
        bool listed[kVec];
        int rank = nreg, here = 0;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int row = r0 + e;
          listed[e] = row >= 0 && row < m && v[u][e] != T(0) && kind_of(row) != kConeRow;
          const unsigned ball = __ballot_sync(kFull, listed[e]);
          rank += __popc(ball & below);
          here += __popc(ball);
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int row = r0 + e;
          if (listed[e]) {
            idx[rank++] = static_cast<uint16_t>(row);
          } else if (kGrad && row >= 0 && row < m) {
            per_row[row] = T(0);
          }
        }
        nreg += here;
      }
    }
  }
  // 1c. The cone slots with Dn > 0, their rows after the regular ones.
  int cnt = nreg, nslot = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    int first = 0, cd = 0;
    bool act = false;
    if (s < S) {
      first = __ldg(g.tab + 3 * s);
      cd = __ldg(g.tab + 3 * s + 1);
      act = Dw[first] > T(0);
    }
    const int c = act ? cd : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned ball = __ballot_sync(kFull, act);
    if (act) {
      const int j = nslot + __popc(ball & below), off = cnt + incl - c;
      slot_id[j] = static_cast<uint16_t>(s);
      slot_off[j] = static_cast<uint16_t>(off);
      for (int q = 0; q < cd; ++q) idx[off + q] = static_cast<uint16_t>(first + q);
    } else if (kMode == kGradient && s < S) {
      T* blk = g.out2 + wd * g.nb + __ldg(g.tab + 3 * s + 2);
      for (int q = 0; q < cd * cd; ++q) blk[q] = T(0);
    }
    nslot += __popc(ball);
    cnt += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();

  // 2. The listed rows k0 .. k1 - 1 of J, 32 at a time: a tile's rows are
  // copied into shared memory with coalesced loads (kBatch in flight per
  // lane), then `fn(lane's row k or -1, its J row in the tile, rows)` runs
  // with lane l on the tile's row l; the tile stays until the next one.
  const int ld = lead(n);
  auto each_tile = [&](int k0, int k1, auto&& fn) {
    const int q = 32 / n, s = 32 % n;
    for (int t0 = k0; t0 < k1; t0 += 32) {
      const int rows = min(32, k1 - t0), count = rows * n;
      __syncwarp();
      int t = lane / n, c = lane % n;
      for (int e0 = lane; e0 < count; e0 += 32 * kBatch) {
        T v[kBatch];
        int at[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool in = e0 + 32 * u < count;
          at[u] = t * ld + c;
          v[u] = in ? __ldg(Jw + static_cast<size_t>(idx[t0 + t]) * n + c) : T(0);
          c += s;
          t += q;
          if (c >= n) {
            c -= n;
            ++t;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (e0 + 32 * u < count) tile[at[u]] = v[u];
        }
      }
      __syncwarp();
      fn(lane < rows ? t0 + lane : -1, tile + lane * ld, rows);
    }
  };
  // A row's product with v (shared memory), in one order wherever taken.
  auto dot = [&](const T* jr, const T* v) {
    T acc = T(0);
    for (int c = 0; c < n; ++c) acc = fma(jr[c], v[c], acc);
    return acc;
  };
  // The lanes' columns of sum over the tile's rows of ftile[t] J_t.
  auto add_jtf = [&](int rows, T& acc0, T& acc1) {
    __syncwarp();
    for (int t = 0; t < rows; ++t) {
      const T f = ftile[t];
      if (lane < n) acc0 = fma(f, tile[t * ld + lane], acc0);
      if (lane + 32 < n) acc1 = fma(f, tile[t * ld + lane + 32], acc1);
    }
  };
  // (M v)_i from qM in shared memory.
  auto mv_row = [&](int i, const T* v) {
    T s = T(0);
    for (int j = 0; j < n; ++j) s += qs[i * n + j] * v[j];
    return s;
  };
  // The slot's u (cd values of field f) and D.
  auto slot_rows = [&](int j, int f, T* u, T* Dv, int& cd, int& first) {
    const int s = slot_id[j], off = slot_off[j];
    first = __ldg(g.tab + 3 * s);
    cd = __ldg(g.tab + 3 * s + 1);
#pragma unroll
    for (int q = 0; q < kMaxConeDim; ++q) {
      u[q] = q < cd ? ref(f, off + q) : T(0);
      Dv[q] = q < cd ? Dw[first + q] : T(0);
    }
    return Cone<T>(cd, Dv, g.mu0[wd * S + s]);
  };

  // The costs at the points pa and pb (shared memory), the same in every
  // lane; each point's arithmetic is its own (a point's cost does not
  // depend on the other point). The cone rows' residuals go to the fields
  // kT (pa) and kJv (pb), free by then.
  auto cost_pair = [&](const T* pa, const T* pb, T& ca, T& cb) {
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      dya[i] = pa[i] - a0s[i];
      dyb[i] = pb[i] - a0s[i];
    }
    __syncwarp();
    T qa = T(0), qb = T(0);
    for (int i = lane; i < n; i += 32) {
      qa += dya[i] * mv_row(i, dya);
      qb += dyb[i] * mv_row(i, dyb);
    }
    qa = warp_sum(qa);
    qb = warp_sum(qb);
    T rca = T(0), rcb = T(0);
    each_tile(0, cnt, [&](int k, const T* jr, int) {
      if (k < 0) return;
      const int row = idx[k];
      const T ar = arw[row];
      const T ra = dot(jr, pa) - ar, rb = dot(jr, pb) - ar;
      if (k < nreg) {
        const int kd = kind_of(row);
        const T Dr = Dw[row], flr = flw != nullptr ? flw[row] : T(0);
        rca += row_cost(kd, Dr, flr, ra);
        rcb += row_cost(kd, Dr, flr, rb);
      } else {
        ref(kT, k) = ra;
        ref(kJv, k) = rb;
      }
    });
    rca = warp_sum(rca);
    rcb = warp_sum(rcb);
    __syncwarp();
    T cca = T(0), ccb = T(0);
    for (int j = lane; j < nslot; j += 32) {
      T ua[kMaxConeDim], ub[kMaxConeDim], Dv[kMaxConeDim];
      int cd, first;
      const Cone<T> cone = slot_rows(j, kT, ua, Dv, cd, first);
      const int off = slot_off[j];
#pragma unroll
      for (int q = 0; q < kMaxConeDim; ++q) ub[q] = q < cd ? ref(kJv, off + q) : T(0);
      cca += cone.cost(ua);
      ccb += cone.cost(ub);
    }
    cca = warp_sum(cca);
    ccb = warp_sum(ccb);
    __syncwarp();
    ca = T(0.5) * qa + rca + cca;
    cb = T(0.5) * qb + rcb + ccb;
  };
  // A candidate point x + c p into y, rounded as PyTorch rounds it.
  auto fill = [&](T* y, T c) {
    __syncwarp();
    for (int i = lane; i < n; i += 32) y[i] = add_rn(xs[i], mul_rn(c, ps[i]));
  };

  if constexpr (kMode == kCost) {
    // The points two at a time (the last one twice for an odd count).
    for (int j = 0; j < g.count; j += 2) {
      const int j2 = j + 1 < g.count ? j + 1 : j;
      __syncwarp();
      for (int i = lane; i < n; i += 32) {
        ya[i] = g.x[(wd * g.count + j) * n + i];
        yb[i] = g.x[(wd * g.count + j2) * n + i];
      }
      T ca, cb;
      cost_pair(ya, yb, ca, cb);
      if (lane == 0) {
        g.out0[wd * g.count + j] = ca;
        g.out0[wd * g.count + j2] = cb;
      }
    }
    return;
  }

  if constexpr (kGrad) {
    // 3. Forces and weights (lane l on the tile's row l); J^T f in the
    // lanes' columns, the tile's regular rows first, the cone rows' after
    // their slots' forces.
    T acc0 = T(0), acc1 = T(0);
    each_tile(0, cnt, [&](int k, const T* jr, int rows) {
      T f = T(0);
      if (k >= 0) {
        const int row = idx[k];
        const T r = dot(jr, xs) - arw[row];
        if (k < nreg) {
          const int kd = kind_of(row);
          const T Dr = Dw[row], flr = flw != nullptr ? flw[row] : T(0);
          f = row_force(kd, Dr, flr, r);
          per_row[row] = kMode == kForces ? f : row_hess(kd, Dr, flr, r);
        } else {
          ref(kR, k) = r;
        }
      }
      ftile[lane] = f;
      add_jtf(rows, acc0, acc1);
    });
    __syncwarp();
    for (int j = lane; j < nslot; j += 32) {
      T u[kMaxConeDim], Dv[kMaxConeDim], f[kMaxConeDim];
      int cd, first;
      const Cone<T> cone = slot_rows(j, kR, u, Dv, cd, first);
      cone.force(u, f);
      const int off = slot_off[j];
#pragma unroll
      for (int q = 0; q < kMaxConeDim; ++q) {
        if (q < cd) {
          ref(kT, off + q) = f[q];
          if (kMode == kForces) per_row[first + q] = f[q];
        }
      }
      if (kMode == kGradient) cone.hess(u, g.out2 + wd * g.nb + __ldg(g.tab + 3 * slot_id[j] + 2));
    }
    __syncwarp();
    each_tile(nreg, cnt, [&](int k, const T*, int rows) {
      ftile[lane] = k >= 0 ? ref(kT, k) : T(0);
      add_jtf(rows, acc0, acc1);
    });
    T* out = g.out0 + wd * n;
    if (kMode == kForces) {
      if (lane < n) out[lane] = acc0;
      if (lane + 32 < n) out[lane + 32] = acc1;
    } else {
      for (int i = lane; i < n; i += 32) dya[i] = xs[i] - a0s[i];
      __syncwarp();
      if (lane < n) out[lane] = mv_row(lane, dya) - acc0;
      if (lane + 32 < n) out[lane + 32] = mv_row(lane + 32, dya) - acc1;
    }
    return;
  }

  if constexpr (kLine) {
    // 3. The rows' r, J p, D and fl; p M (x - a0) and p M p.
    each_tile(0, cnt, [&](int k, const T* jr, int) {
      if (k < 0) return;
      const int row = idx[k];
      ref(kR, k) = dot(jr, xs) - arw[row];
      ref(kJv, k) = dot(jr, ps);
      ref(kD, k) = Dw[row];
      ref(kFl, k) = flw != nullptr ? flw[row] : T(0);
    });
    for (int i = lane; i < n; i += 32) dya[i] = xs[i] - a0s[i];
    __syncwarp();
    T pmdx = T(0), pmp = T(0);
    for (int i = lane; i < n; i += 32) {
      pmdx += ps[i] * mv_row(i, dya);
      pmp += ps[i] * mv_row(i, ps);
    }
    pmdx = warp_sum(pmdx);
    pmp = warp_sum(pmp);
    // The 1-D Newton on phi'(alpha).
    T alpha = T(1);
    for (int it = 0; it < g.count; ++it) {
      T sf = T(0), sh = T(0), ss = T(0), sc = T(0);
      for (int k = lane; k < nreg; k += 32) {
        const T v = ref(kJv, k), Dr = ref(kD, k), flr = ref(kFl, k);
        const int kd = kind_of(idx[k]);
        const T ra = ref(kR, k) + alpha * v;
        sf += row_force(kd, Dr, flr, ra) * v;
        sh += row_hess(kd, Dr, flr, ra) * (v * v);
      }
      for (int j = lane; j < nslot; j += 32) {
        T u[kMaxConeDim], v[kMaxConeDim], Dv[kMaxConeDim];
        int cd, first;
        const Cone<T> cone = slot_rows(j, kR, u, Dv, cd, first);
        const int off = slot_off[j];
#pragma unroll
        for (int q = 0; q < kMaxConeDim; ++q) v[q] = q < cd ? ref(kJv, off + q) : T(0);
        T slope, curv;
        cone.line(u, v, alpha, slope, curv);
        ss += slope;
        sc += curv;
      }
      const T slope = warp_sum(sf + ss), curv = warp_sum(sh + sc);
      const T dphi = pmdx + alpha * pmp - slope;
      const T ddphi = pmp + curv;
      const T next = alpha - dphi / clamp_min(ddphi, T(1e-30));
      // A step is a function of alpha alone: once it returns alpha, so
      // does every later one (the same in every lane, so the warp leaves
      // together).
      if (same_bits(next, alpha)) break;
      alpha = next;
    }
    // 4. The acceptance, each candidate's cost from its own point, two
    // points per pass over the rows.
    T* out = g.out0 + wd * n;
    bool better = false;
    if constexpr (kMode == kLinesearch) {
      fill(yb, alpha);
      T c0, c1;
      cost_pair(xs, yb, c0, c1);
      better = c1 < c0;
      for (int i = lane; i < n; i += 32) out[i] = better ? yb[i] : xs[i];
    } else {
      // x, then the candidates alpha, 1, 0.5, 0.25, 0.1, 0.01 in order.
      T cand[6], best_cost;
      fill(yb, alpha);
      cost_pair(xs, yb, best_cost, cand[0]);
#pragma unroll
      for (int c = 1; c < 6; c += 2) {
        const int c2 = c + 1 < 6 ? c + 1 : c;
        fill(ya, safeguard_step<T>(c));
        fill(yb, safeguard_step<T>(c2));
        T cb;
        cost_pair(ya, yb, cand[c], cb);
        if (c2 != c) cand[c2] = cb;
      }
      T best = T(0);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (cand[c] < best_cost) {
          best_cost = cand[c];
          best = c == 0 ? alpha : safeguard_step<T>(c);
          better = true;
        }
      }
      __syncwarp();
      for (int i = lane; i < n; i += 32) out[i] = add_rn(xs[i], mul_rn(best, ps[i]));
    }
    if (lane == 0) {
      g.out1[wd] = alpha;
      g.improved[wd] = better ? 1 : 0;
    }
  }
}

// Lets the instance take up to kMaxSmem of dynamic shared memory, once per
// device.
template <typename T, int kMode>
cudaError_t prepare(int* dev) {
  static int dev_seen = -1;
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess || *dev == dev_seen) return e;
  e = cudaFuncSetAttribute(newton_iter_kernel<T, kMode>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e == cudaSuccess) dev_seen = *dev;
  return e;
}

// One block of one warp per world. With `report`, launches nothing and
// fills it instead (see newton_iter_config).
template <typename T, int kMode>
int launch(const Args<T>& a, cudaStream_t stream, int* report = nullptr) {
  if (a.n < 1 || a.n > kMaxN || a.batch < 1 || a.m < 1 || a.m > kMaxRows || a.ncone < 0 ||
      a.ncone > kMaxRows || a.nb < 0 || a.count < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = Layout<T>(a.n, a.m, a.ncone).total;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = prepare<T, kMode>(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (report != nullptr) {
    cudaFuncAttributes attr;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, newton_iter_kernel<T, kMode>, 32,
                                                        bytes);
    }
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, newton_iter_kernel<T, kMode>);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int out[5] = {per_sm, sms, static_cast<int>(bytes), attr.numRegs,
                        static_cast<int>(attr.localSizeBytes)};
    for (int k = 0; k < 5; ++k) report[k] = out[k];
    return static_cast<int>(cudaSuccess);
  }
  newton_iter_kernel<T, kMode><<<a.batch, 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int mode, const Args<T>& a, cudaStream_t stream, int* report = nullptr) {
  switch (mode) {
    case kGradient: return launch<T, kGradient>(a, stream, report);
    case kForces: return launch<T, kForces>(a, stream, report);
    case kLinesearch: return launch<T, kLinesearch>(a, stream, report);
    case kSafeguard: return launch<T, kSafeguard>(a, stream, report);
    case kCost: return launch<T, kCost>(a, stream, report);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int entry(int mode, const T* qM, const T* J, const T* D, const T* aref, const T* fl,
          const int* kind, const int* tab, const T* mu0, const T* a0, const T* x, const T* p,
          T* out0, T* out1, T* out2, unsigned char* improved, T* scratch, int batch, int n,
          int m, int ncone, int nb, int count, void* stream) {
  const Args<T> a{qM, J, D, aref, fl, kind, tab, mu0, a0, x, p, out0, out1, out2, improved,
                  scratch, batch, n, m, ncone, nb, count};
  return dispatch<T>(mode, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Every entry point takes the same arguments: qM (batch, n, n), J (batch,
// m, n), D, aref (batch, m), fl (batch, m) or null, kind (m) int32 or null,
// tab (ncone, 3) int32 [first row, cd <= 6, block offset] and mu0 (batch,
// ncone) (null when ncone is 0), a0 (batch, n), x, p, out0, out1, out2,
// improved (uint8), scratch (batch, 5 * max(m - 128, 0)), then batch, n, m,
// ncone, nb (the packed cone blocks per world), count, flag and the stream.
//   newton_gradient: x (batch, n); flag 0: out0 = grad (batch, n), out1 =
//     w (batch, m), out2 = the cone blocks (batch, nb); flag 1: out0 =
//     qfrc = J^T f (batch, n), out1 = efc_force (batch, m).
//   newton_linesearch: x, p (batch, n), count = linesearch steps, flag 1
//     for the safeguard's acceptance; out0 = x' (batch, n), out1 = alpha
//     (batch), improved (batch).
//   constraint_cost: x = X (batch, count, n); out0 = cost (batch, count).
#define NEWTON_ENTRIES(T, SUF)                                                                   \
  int newton_gradient_##SUF(const T* qM, const T* J, const T* D, const T* aref, const T* fl,   \
                            const int* kind, const int* tab, const T* mu0, const T* a0,        \
                            const T* x, const T* p, T* out0, T* out1, T* out2,                 \
                            unsigned char* improved, T* scratch, int batch, int n, int m,      \
                            int ncone, int nb, int count, int flag, void* stream) {            \
    return entry<T>(flag ? kForces : kGradient, qM, J, D, aref, fl, kind, tab, mu0, a0, x, p,   \
                    out0, out1, out2, improved, scratch, batch, n, m, ncone, nb, count,        \
                    stream);                                                                   \
  }                                                                                            \
  int newton_linesearch_##SUF(const T* qM, const T* J, const T* D, const T* aref, const T* fl, \
                              const int* kind, const int* tab, const T* mu0, const T* a0,      \
                              const T* x, const T* p, T* out0, T* out1, T* out2,               \
                              unsigned char* improved, T* scratch, int batch, int n, int m,    \
                              int ncone, int nb, int count, int flag, void* stream) {          \
    return entry<T>(flag ? kSafeguard : kLinesearch, qM, J, D, aref, fl, kind, tab, mu0, a0, x, \
                    p, out0, out1, out2, improved, scratch, batch, n, m, ncone, nb, count,     \
                    stream);                                                                   \
  }                                                                                            \
  int constraint_cost_##SUF(const T* qM, const T* J, const T* D, const T* aref, const T* fl,   \
                            const int* kind, const int* tab, const T* mu0, const T* a0,        \
                            const T* x, const T* p, T* out0, T* out1, T* out2,                 \
                            unsigned char* improved, T* scratch, int batch, int n, int m,      \
                            int ncone, int nb, int count, int flag, void* stream) {            \
    (void)flag;                                                                                \
    return entry<T>(kCost, qM, J, D, aref, fl, kind, tab, mu0, a0, x, p, out0, out1, out2,      \
                    improved, scratch, batch, n, m, ncone, nb, count, stream);                 \
  }

extern "C" {

NEWTON_ENTRIES(float, f32)
NEWTON_ENTRIES(double, f64)

// The launch of `mode` (0 gradient, 1 forces, 2 linesearch, 3 with the
// safeguard, 4 cost) for these shapes and element size, launching nothing:
// out[0..4] = resident worlds per SM, SMs, shared bytes per world,
// registers and local (spill) bytes per thread.
int newton_iter_config(int mode, int elem_bytes, int n, int m, int ncone, int batch, int* out) {
  if (elem_bytes == 4) {
    Args<float> a{};
    a.batch = batch, a.n = n, a.m = m, a.ncone = ncone;
    return dispatch<float>(mode, a, nullptr, out);
  }
  if (elem_bytes == 8) {
    Args<double> a{};
    a.batch = batch, a.n = n, a.m = m, a.ncone = ncone;
    return dispatch<double>(mode, a, nullptr, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
