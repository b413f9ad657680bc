// The rest of the Newton iteration, on each world's active rows: the warm
// start (the solve's first launch: it lists the solve's active rows, picks
// between qacc_warmstart and a0 by cost and ends with the gradient, the row
// weights and the cone blocks at the point it picks), the exact linesearch
// with the step's acceptance that ends with the gradient at the point it
// returns (or, for a solve's last iteration, the final forces), and the
// gradient (or the forces) at a given point.
//
// Replaces what XLA fused in the JAX package's solver, for which no TPU
// kernel existed: mjlab_tpu/physics/solver.py's warm start (:182-192) with
// the first iteration's gradient at the chosen point (:218-224; cg_solve's
// :300-303), newton_iter up to H and after the direction (:218-224,
// :231-266), linesearch (:268-287), the gradients and steps of cg_solve
// (:289-325) and the final forces (:378-386), with the cost pieces they call
// (residual :166, row_cost :169, total_cost :182, row_force :194, row_hess
// :207, the cone functions :105-164). The plain PyTorch versions are in
// kernels/newton.py.
//
// Per world, over qacc x (a0 = qacc_smooth, r = J x - aref):
//   cost(x) = 0.5 (x - a0)^T M (x - a0) + sum_i cost_i(r_i) + sum_s cone_s
// a row's cost by its class (one-sided, equality, friction loss with its
// Huber threshold fl / D), the elliptic cone's slots in three zones. A row
// with D == 0 (and a slot with Dn <= 0) adds exactly nothing to any output:
// the kernels never read its J or aref.
//
// Bound on the H100 (3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores): D does
// not change during a solve, so its scan, the list of active rows and the
// zeros of w on the inactive rows are once per solve (in the warm start);
// each launch then moves the active rows' J, aref, fl, D and list entry,
// qM's lower triangle, the vectors and w and the blocks on the active rows:
// at G1's shapes (4096 worlds, nefc 1699, nv 35, f32, ~76 active rows per
// world) ~58 MB, ~0.018 ms. The arithmetic (a few FLOP per active row and
// linesearch step, 2 n^2 per quadratic form) is far below. Each world is a
// chain of dependent steps (read the rows, reduce, the linesearch's steps,
// each two warp reductions), so the kernels are bound by that chain's
// latency at this share of active rows.
//
// Design: one world per block of one warp, the whole batch in one grid, so
// that many worlds share an SM and one world's chain overlaps others'.
//   * One list per solve, kept on the card (the wrapper's buffers): the warm
//     start scans D with 16-byte loads, lists the active regular rows (D !=
//     0, a NaN counts) in row order and then the rows of the active cone
//     slots (Dn > 0), each entry row | class << 16, writes 0 once on every
//     other row of w and in every inactive slot's block, and keeps the counts
//     on the card. Every later launch reads the list; none scans D or writes
//     an inactive row again. newton_gradient builds it too (kBuild) for a
//     caller that starts without a warm start.
//   * The listed rows of J stream through a ring of kStages tiles of 32
//     rows in shared memory by 4-byte (8 in float64) cp.async copies, each
//     tile with its rows' list entries, aref, D and fl, the next tile's
//     copies in flight while lane l computes on this tile's row l (an odd
//     row stride: no bank conflicts); a lane loads its list entry a tile
//     ahead, so that no copy waits on the list; qM joins the first tile's
//     copies, and the acceptance's pass issues its first tiles before the
//     linesearch's steps.
//   * The linesearch holds its first kCap regular rows' r, J p, D, fl and
//     entry in registers (kRegs a lane), past them in a global scratch; the
//     cone rows' values live in shared memory up to kConeCap, past it in
//     the scratch. Its steps run from registers, two warp reductions each,
//     a lane's cone slot kept whole in registers, until a step returns alpha
//     bitwise (every later one would).
//   * The acceptance takes each candidate's cost from its own point x + c p
//     (rounded as PyTorch rounds it, no FMA): one more pass over the rows
//     forms each row's residual at the candidate by the same dot, its cost,
//     force and weight, and J^T f at x (from the first pass) and at the
//     candidate; the cost comparison picks one, whose weights (or forces),
//     cone blocks and gradient the launch writes. With the safeguard the
//     six candidates' residuals come from one read of each row, and one
//     more pass over the rows at the chosen point gives the output.
//   * The warm start is that acceptance from x = a0 to the candidate ws =
//     qacc_warmstart after the list's build: its one pass over the listed
//     rows forms each row's residual at both points, their costs and forces
//     and J^T f at both; ws is taken where its cost is lower (a tie or a NaN
//     keeps a0), and the output at the point taken needs no second read of
//     the regular rows (the cone rows' J^T f reads the cone rows again).
//   * Every product is taken in one order wherever it is taken (one FMA
//     chain per dot, J^T f row by row in list order, the regular rows'
//     first) and the file builds without contraction (-fmad=false), so the
//     gradient a linesearch or the warm start returns at its point is
//     bitwise newton_gradient's there.
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
constexpr int kCap = 128;         // listed regular rows a linesearch holds in registers
constexpr int kRegs = kCap / 32;  // ... a lane
constexpr int kConeCap = 64;      // listed cone rows per world in shared memory
constexpr int kRegFields = 5;     // per regular row past kCap: r, J p, D, fl, r at the candidate
enum RegField { kR = 0, kJv = 1, kD = 2, kFl = 3, kRy = 4 };
// Per cone row: r, J p (after the steps, the residual at the first
// candidate), the residuals at five more candidates (or a force).
constexpr int kConeFields = 7;
enum ConeField { kCr = 0, kCv = 1, kCt = 2 };
constexpr int kCand = 6;    // the safeguard's candidates
constexpr int kStages = 2;  // tiles of J in flight
constexpr int kMaxN = 64;
constexpr int kMaxRows = 65535;  // row indices and offsets are kept in 16 bits
constexpr int kMaxConeDim = 6;
constexpr int kBatch = 8;  // 16-byte loads of D in flight per lane
constexpr size_t kMaxSmem = 227 * 1024;

enum Mode { kGradient = 0, kLinesearch = 1, kSafeguard = 2, kWarmStart = 3 };
enum Flag { kForcesOut = 1, kBuild = 2, kWithSafeguard = 4 };
enum Kind { kOneSided = 0, kEq = 1, kFric = 2, kConeRow = 3 };

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// A tile of 32 rows of J keeps an odd row stride, so that lane l reading
// row l's column c hits bank (l ld + c) % 32: 32 banks in float32.
__host__ __device__ constexpr int lead(int n) { return n | 1; }

// Vectors of n in shared memory: x (or the point z), a0, z - a0; the
// linesearch's p, y - a0 and its candidate points (1, or kCand); the warm
// start's x = a0 and its candidate ws in the linesearch's places (p unused).
__host__ __device__ constexpr int vectors(int mode) {
  return mode == kGradient ? 3 : mode == kSafeguard ? 5 + kCand : 6;
}
// Columns of 32 row forces: the warm start's at its two points.
__host__ __device__ constexpr int force_tiles(int mode) { return mode == kWarmStart ? 2 : 1; }
__host__ __device__ constexpr int cone_fields(int mode) {
  return mode == kSafeguard ? kConeFields : 3;
}

// One warp's shared memory: qM (n x n), the vectors, kStages tiles of 32
// rows of J with their entries, aref, D and fl, 32 forces (twice for the
// warm start), and the first kConeCap cone rows' fields.
template <typename T>
struct Layout {
  size_t vec, tile, ents, sides, ftile, cone, total;
  __host__ __device__ Layout(int n, int mode, bool cone_rows) {
    vec = align16(static_cast<size_t>(n) * n * sizeof(T));
    tile = align16(vec + static_cast<size_t>(vectors(mode)) * n * sizeof(T));
    ents = align16(tile + static_cast<size_t>(kStages) * 32 * lead(n) * sizeof(T));
    sides = align16(ents + static_cast<size_t>(kStages) * 32 * sizeof(unsigned));
    ftile = align16(sides + static_cast<size_t>(kStages) * 3 * 32 * sizeof(T));
    cone = align16(ftile + static_cast<size_t>(force_tiles(mode)) * 32 * sizeof(T));
    total = align16(cone + (cone_rows ? static_cast<size_t>(cone_fields(mode)) * kConeCap *
                                            sizeof(T)
                                      : 0));
  }
};

template <typename T>
struct Args {
  const T* qM;
  const T* J;
  const T* D;
  const T* aref;
  const T* fl;         // (batch, m) or null: no friction-loss row
  const int* kind;     // (m) row classes or null: every row one-sided
  const int* tab;      // (ncone, 3) [first row, cd, block offset]
  const T* mu0;        // (batch, ncone)
  const T* a0;
  const T* x;          // (batch, n): the point, or the warm start's ws
  const T* p;
  T* xo;               // the linesearch's x' (batch, n)
  T* alpha;            // the linesearch's alpha (batch); the warm start's costs (batch, 2)
  unsigned char* improved;
  T* vec;              // grad, or qfrc with forces (batch, n)
  T* force;            // efc_force (batch, m), with forces: 0 on the unlisted rows
  T* w;                // the solve's row weights (batch, m)
  T* blocks;           // the solve's cone blocks (batch, nb)
  unsigned* lst;       // the solve's list (batch, m): row | class << 16
  int* counts;         // the solve's (batch, 4): regular rows, listed rows, active slots
  unsigned* slots;     // the solve's active slots (batch, ncone): slot | offset << 16
  T* scratch;          // (batch, kRegFields ext_reg + kConeFields ext_cone)
  int batch, n, m, ncone, nb, count, flags, ext_reg, ext_cone;
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

// A lane's register slot i of kRegs, with i known only at run time (selects,
// no local memory).
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[kRegs], int i) {
  V v = a[0];
#pragma unroll
  for (int j = 1; j < kRegs; ++j) v = i == j ? a[j] : v;
  return v;
}
template <typename V>
__device__ __forceinline__ void put(V (&a)[kRegs], int i, V v) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) a[j] = i == j ? v : a[j];
}

// -- asynchronous copies to shared memory --

template <typename T>
__device__ __forceinline__ void async_copy(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T))
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// The listed rows k0 .. k1 - 1 of J through kStages tiles of 32 rows, each
// with its rows' list entries, aref, D and fl: start issues the first
// tiles' copies; wait returns the tile `used` once its copies have landed
// (entry and side then read its row of this lane); release lets its stage
// take the next tile. A lane loads its entry of the next tile one issue
// ahead, so that no copy waits on the list. Every group is committed, empty
// ones past the end too, so that wait_group counts alike in every lane and
// call.
template <typename T>
struct Ring {
  T* tiles;        // kStages x 32 rows x ld
  unsigned* ents;  // kStages x 32 list entries
  T* sides;        // kStages x 3 x 32: the rows' aref, D and fl
  const T* J;
  const T* aref;
  const T* D;
  const T* fl;
  const unsigned* lst;
  int n, ld, lane;
  int k0, k1, issued, used;
  unsigned next;  // this lane's entry of the tile `issued`

  __device__ __forceinline__ void start(int a, int b) {
    k0 = a;
    k1 = b;
    issued = used = 0;
    next = a + lane < b ? lst[a + lane] : 0u;
#pragma unroll
    for (int s = 0; s < kStages; ++s) issue();
  }
  __device__ __forceinline__ bool more() const { return k0 + 32 * used < k1; }
  __device__ __forceinline__ int first() const { return k0 + 32 * used; }
  __device__ __forceinline__ int rows() const { return min(32, k1 - first()); }
  __device__ __forceinline__ const T* wait() {
    async_wait<kStages - 1>();
    __syncwarp();
    return tiles + (used % kStages) * 32 * ld;
  }
  __device__ __forceinline__ unsigned entry() const { return ents[(used % kStages) * 32 + lane]; }
  __device__ __forceinline__ T side(int f) const {
    return sides[((used % kStages) * 3 + f) * 32 + lane];
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    ++used;
    issue();
  }
  __device__ __forceinline__ void issue() {
    const int t0 = k0 + 32 * issued;
    const unsigned e = next;
    next = t0 + 32 + lane < k1 ? lst[t0 + 32 + lane] : 0u;
    if (t0 < k1) {
      const int rows = min(32, k1 - t0), count = rows * n, st = issued % kStages;
      T* dst = tiles + st * 32 * ld;
      const unsigned mine = lane < rows ? (e & 0xffffu) : 0u;
      if (lane < rows) {
        T* sd = sides + st * 3 * 32 + lane;
        ents[st * 32 + lane] = e;
        async_copy(sd, aref + mine);
        async_copy(sd + 32, D + mine);
        if (fl != nullptr) async_copy(sd + 64, fl + mine);
      }
      const int q = 32 / n, s = 32 % n;
      int t = lane / n, c = lane % n;
      for (int e0 = 0; e0 < count; e0 += 32) {
        const unsigned row = __shfl_sync(kFull, mine, t & 31);
        if (e0 + lane < count) async_copy(dst + t * ld + c, J + static_cast<size_t>(row) * n + c);
        c += s;
        t += q;
        if (c >= n) {
          c -= n;
          ++t;
        }
      }
    }
    async_commit();
    ++issued;
  }
};

// A row's product with v (shared memory): one FMA chain over the columns,
// wherever the product is taken.
template <typename T>
__device__ __forceinline__ T dot(const T* jr, const T* v, int n) {
  T acc = T(0);
  for (int c = 0; c < n; ++c) acc = fma(jr[c], v[c], acc);
  return acc;
}

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

  Cone() = default;

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

// Resident worlds per SM that each launch asks registers for: what its
// shared memory allows at G1's shapes (nv 35; 1 KB of each block's shared
// memory is the card's): f32 15.5 KB for the gradient (14 worlds), 15.9 KB
// for the linesearch (13), 16.0 KB for the warm start (13), 18.4 KB with the
// safeguard (12); f64 about twice.
template <typename T>
constexpr int min_blocks(int mode) {
  return sizeof(T) == 4 ? (mode == kGradient ? 16 : mode == kSafeguard ? 12 : 13)
                        : (mode == kGradient ? 8 : mode == kSafeguard ? 6 : 7);
}

// The safeguard's candidates in the plain version's order
// (kernels/newton.py SAFEGUARD_STEPS after the linesearch's alpha).
template <typename T>
__device__ __forceinline__ T safeguard_step(int c, T alpha) {
  switch (c) {
    case 0: return alpha;
    case 1: return T(1);
    case 2: return T(0.5);
    case 3: return T(0.25);
    case 4: return T(0.1);
    default: return T(0.01);
  }
}

// newton_gradient (kMode kGradient; with kBuild it lists the solve's rows
// first), newton_linesearch (kLinesearch, kSafeguard) and the warm start
// (kWarmStart: the list's build, then the linesearch's acceptance from a0 to
// ws), each ending with the output at one point: grad, w and the blocks, or
// with kForcesOut efc_force and qfrc.
template <typename T, int kMode, bool kCone>
__global__ void __launch_bounds__(32, (min_blocks<T>(kMode)))
newton_iter_kernel(const Args<T> g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kWarm = kMode == kWarmStart;
  constexpr bool kLine = kMode == kLinesearch || kMode == kSafeguard;
  constexpr bool kSafe = kMode == kSafeguard;
  const int lane = threadIdx.x;
  const size_t wd = blockIdx.x;
  const int n = g.n, m = g.m, S = kCone ? g.ncone : 0;
  const Layout<T> lay(n, kMode, kCone);
  T* qs = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + lay.vec);
  T* a0s = xs + n;
  T* dz = a0s + n;
  T* ps = dz + n;
  T* dy = ps + n;
  T* ys = dy + n;
  T* ftile = reinterpret_cast<T*>(smem + lay.ftile);
  T* cst = reinterpret_cast<T*>(smem + lay.cone);
  const bool forces = (g.flags & kForcesOut) != 0;
  const T* Dw = g.D + wd * m;
  const T* arw = g.aref + wd * m;
  const T* flw = g.fl != nullptr ? g.fl + wd * m : nullptr;
  unsigned* lw = g.lst + wd * m;
  T* ww = g.w + wd * m;
  T* fw = g.force != nullptr ? g.force + wd * m : nullptr;
  unsigned* sw = g.slots + wd * S;
  T* gsr = g.scratch + wd * (static_cast<size_t>(kRegFields) * g.ext_reg +
                             static_cast<size_t>(kConeFields) * g.ext_cone);
  T* gsc = gsr + static_cast<size_t>(kRegFields) * g.ext_reg;
  // A regular row's field past kCap (the global scratch), a cone row's
  // (shared memory for the first kConeCap, the scratch beyond).
  auto reg_ref = [&](int f, int k) -> T& {
    return gsr[static_cast<size_t>(f) * g.ext_reg + (k - kCap)];
  };
  auto cone_ref = [&](int f, int c) -> T& {
    return c < kConeCap ? cst[f * kConeCap + c]
                        : gsc[static_cast<size_t>(f) * g.ext_cone + (c - kConeCap)];
  };
  auto kind_of = [&](int row) { return g.kind != nullptr ? __ldg(g.kind + row) : int(kOneSided); };

  // 1. qM by asynchronous copies (they join the first tile's group; the
  // final forces need none); the vectors (the warm start's x is a0, its
  // candidate ws).
  {
    const T* q = g.qM + wd * static_cast<size_t>(n) * n;
    if (kLine || !forces) {
      for (int e = lane; e < n * n; e += 32) async_copy(qs + e, q + e);
    }
    for (int i = lane; i < n; i += 32) {
      const T a = g.a0[wd * n + i];
      a0s[i] = a;
      xs[i] = kWarm ? a : g.x[wd * n + i];
      if (kWarm) ys[i] = g.x[wd * n + i];
      if (kLine) ps[i] = g.p[wd * n + i];
    }
  }

  // 2. The solve's list: built here by the warm start (or a gradient with
  // kBuild), read otherwise.
  int nreg = 0, cnt = 0, nslot = 0;
  if (kWarm || (!kLine && (g.flags & kBuild) != 0)) {
    // 2a. The active regular rows, in row order; 0 on every other row of w.
    const unsigned below = (1u << lane) - 1u;
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
        unsigned ent[kVec];
        int rank = nreg, here = 0;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int row = r0 + e;
          const bool in = row >= 0 && row < m && v[u][e] != T(0);
          const int kd = in ? kind_of(row) : int(kOneSided);
          listed[e] = in && kd != kConeRow;
          ent[e] = static_cast<unsigned>(row) | (static_cast<unsigned>(kd) << 16);
          const unsigned ball = __ballot_sync(kFull, listed[e]);
          rank += __popc(ball & below);
          here += __popc(ball);
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int row = r0 + e;
          if (listed[e]) {
            lw[rank++] = ent[e];
          } else if (row >= 0 && row < m) {
            ww[row] = T(0);
          }
        }
        nreg += here;
      }
    }
    // 2b. The cone slots with Dn > 0, their rows after the regular ones; 0
    // in every other slot's block.
    cnt = nreg;
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
        sw[j] = static_cast<unsigned>(s) | (static_cast<unsigned>(off) << 16);
        for (int q = 0; q < cd; ++q) {
          lw[off + q] = static_cast<unsigned>(first + q) | (static_cast<unsigned>(kConeRow) << 16);
        }
      } else if (s < S) {
        T* blk = g.blocks + wd * g.nb + __ldg(g.tab + 3 * s + 2);
        for (int q = 0; q < cd * cd; ++q) blk[q] = T(0);
      }
      nslot += __popc(ball);
      cnt += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) {
      g.counts[wd * 4] = nreg;
      g.counts[wd * 4 + 1] = cnt;
      g.counts[wd * 4 + 2] = nslot;
      g.counts[wd * 4 + 3] = 0;
    }
  } else {
    nreg = g.counts[wd * 4];
    cnt = g.counts[wd * 4 + 1];
    nslot = g.counts[wd * 4 + 2];
  }
  __syncwarp();

  const int ld = lead(n);
  Ring<T> ring{reinterpret_cast<T*>(smem + lay.tile),
               reinterpret_cast<unsigned*>(smem + lay.ents),
               reinterpret_cast<T*>(smem + lay.sides),
               g.J + wd * static_cast<size_t>(m) * n,
               arw, Dw, flw, lw, n, ld, lane, 0, 0, 0, 0, 0u};
  // The lanes' columns of sum over the tile's rows of ftile[t] J_t, row by
  // row.
  auto add_jtf = [&](const T* tl, int rows, T& acc0, T& acc1) {
    for (int t = 0; t < rows; ++t) {
      const T f = ftile[t];
      if (lane < n) acc0 = fma(f, tl[t * ld + lane], acc0);
      if (lane + 32 < n) acc1 = fma(f, tl[t * ld + lane + 32], acc1);
    }
  };
  // The same for the warm start's two force columns (ftile, ftile + 32),
  // each sum rounded as add_jtf rounds it.
  auto add_jtf2 = [&](const T* tl, int rows, T& acc0, T& acc1, T& bcc0, T& bcc1) {
    for (int t = 0; t < rows; ++t) {
      const T f = ftile[t], h = ftile[32 + t];
      if (lane < n) {
        const T j = tl[t * ld + lane];
        acc0 = fma(f, j, acc0);
        bcc0 = fma(h, j, bcc0);
      }
      if (lane + 32 < n) {
        const T j = tl[t * ld + lane + 32];
        acc1 = fma(f, j, acc1);
        bcc1 = fma(h, j, bcc1);
      }
    }
  };
  // (M v)_i from qM in shared memory.
  auto mv_row = [&](int i, const T* v) {
    T s = T(0);
    for (int j = 0; j < n; ++j) s = fma(qs[i * n + j], v[j], s);
    return s;
  };
  // d = z - a0 and the lanes' rows of M d (`drain`: qM's copies may be in
  // flight yet).
  auto m_of = [&](const T* z, T* d, T& m0, T& m1, bool drain = true) {
    __syncwarp();
    for (int i = lane; i < n; i += 32) d[i] = z[i] - a0s[i];
    if (drain) async_wait<0>();
    __syncwarp();
    m0 = lane < n ? mv_row(lane, d) : T(0);
    m1 = lane + 32 < n ? mv_row(lane + 32, d) : T(0);
  };
  // The quadratic form d^T M d from d and the lanes' rows of M d.
  auto quad = [&](const T* d, T m0, T m1) {
    T q = T(0);
    if (lane < n) q += d[lane] * m0;
    if (lane + 32 < n) q += d[lane + 32] * m1;
    return warp_sum(q);
  };
  // Active slot j: its u (cd values of cone field fu) and its Cone.
  auto slot_of = [&](int j, int fu, T* u, int& cd, int& first, int& c0) {
    const unsigned e = sw[j];
    const int s = static_cast<int>(e & 0xffffu);
    first = __ldg(g.tab + 3 * s);
    cd = __ldg(g.tab + 3 * s + 1);
    c0 = static_cast<int>(e >> 16) - nreg;
    T Dv[kMaxConeDim];
#pragma unroll
    for (int q = 0; q < kMaxConeDim; ++q) {
      u[q] = q < cd ? cone_ref(fu, c0 + q) : T(0);
      Dv[q] = q < cd ? Dw[first + q] : T(0);
    }
    return Cone<T>(cd, Dv, g.mu0[wd * S + s]);
  };
  // The cone slots' forces (and efc_force on their rows) and blocks at the
  // point whose residuals are in cone field fu, then the cone rows' J^T f.
  auto cone_out = [&](int fu, T& acc0, T& acc1) {
    __syncwarp();
    for (int j = lane; j < nslot; j += 32) {
      T u[kMaxConeDim], f[kMaxConeDim];
      int cd, first, c0;
      const Cone<T> cone = slot_of(j, fu, u, cd, first, c0);
      cone.force(u, f);
#pragma unroll
      for (int q = 0; q < kMaxConeDim; ++q) {
        if (q < cd) {
          cone_ref(kCt, c0 + q) = f[q];
          if (forces) fw[first + q] = f[q];
        }
      }
      if (!forces) cone.hess(u, g.blocks + wd * g.nb + __ldg(g.tab + 3 * (sw[j] & 0xffffu) + 2));
    }
    __syncwarp();
    for (ring.start(nreg, cnt); ring.more(); ring.release()) {
      const T* tl = ring.wait();
      const int k = ring.first() + lane;
      ftile[lane] = k < cnt ? cone_ref(kCt, k - nreg) : T(0);
      __syncwarp();
      add_jtf(tl, ring.rows(), acc0, acc1);
    }
  };
  // grad = M (z - a0) - J^T f (or qfrc = J^T f) from the lanes' rows of
  // M (z - a0).
  auto finish = [&](T m0, T m1, T acc0, T acc1) {
    async_wait<0>();  // nothing left in flight at the kernel's end
    T* out = g.vec + wd * n;
    if (lane < n) out[lane] = forces ? acc0 : m0 - acc0;
    if (lane + 32 < n) out[lane + 32] = forces ? acc1 : m1 - acc1;
  };
  // The whole output at the point z (shared memory; d a vector of scratch).
  auto output_at = [&](const T* z, T* d) {
    T acc0 = T(0), acc1 = T(0);
    for (ring.start(0, cnt); ring.more(); ring.release()) {
      const T* tl = ring.wait();
      const int k = ring.first() + lane;
      T f = T(0);
      if (k < cnt) {
        const unsigned e = ring.entry();
        const int row = static_cast<int>(e & 0xffffu);
        const T r = dot(tl + lane * ld, z, n) - ring.side(0);
        if (k < nreg) {
          const int kd = static_cast<int>(e >> 16);
          const T Dr = ring.side(1), flr = flw != nullptr ? ring.side(2) : T(0);
          f = row_force(kd, Dr, flr, r);
          if (forces) {
            fw[row] = f;
          } else {
            ww[row] = row_hess(kd, Dr, flr, r);
          }
        } else if (kCone) {
          cone_ref(kCr, k - nreg) = r;
        }
      }
      ftile[lane] = f;
      __syncwarp();
      add_jtf(tl, ring.rows(), acc0, acc1);
    }
    if (kCone) cone_out(kCr, acc0, acc1);
    T m0 = T(0), m1 = T(0);
    if (!forces) m_of(z, d, m0, m1);
    finish(m0, m1, acc0, acc1);
  };

  if constexpr (!kLine && !kWarm) {
    output_at(xs, dz);
    return;
  }

  // 3. The rows' r = J x - aref and J p, D, fl and entry (registers up to
  // kCap, the scratch beyond), the cone rows' r and J p; without the
  // safeguard also J^T f at x over the regular rows. The warm start keeps
  // r at both of its points instead (ry for ws).
  T rr[kRegs], rv[kRegs], rD[kRegs], rfl[kRegs], ry[kRegs];
  unsigned re[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    rr[i] = rv[i] = rD[i] = rfl[i] = ry[i] = T(0);
    re[i] = 0u;
  }
  constexpr int kPts = kSafe ? kCand : 1;

  // 5b-6. The acceptance from the pass's sums (rc, the regular rows' costs
  // at x and at the candidates; J^T f at x and at ws in ax, ay) and
  // M (x - a0) (mx), then the output at the point it keeps. Each mode
  // declares these where its passes first need them: declared before both
  // modes' first pass, they made the safeguard linesearch 3-8% slower on an
  // H100 (kernel_ab.py's elliptic rows).
  auto accept = [&](const T (&rc)[kPts + 1], T mx0, T mx1, T ax0, T ax1, T ay0, T ay1,
                    T alpha) {
    T* xo = g.xo + wd * n;
    const int nr = min(nreg, kCap);
    // The costs: 0.5 d^T M d, the regular rows', the cone slots'.
    T cost[kPts + 1], my0 = T(0), my1 = T(0);
    cost[0] = quad(dz, mx0, mx1);
#pragma unroll
    for (int c = 0; c < kPts; ++c) {
      T m0, m1;
      m_of(ys + c * n, dy, m0, m1);
      cost[1 + c] = quad(dy, m0, m1);
      if (c == 0) {
        my0 = m0;
        my1 = m1;
      }
    }
    T cc[kPts + 1];
#pragma unroll
    for (int c = 0; c <= kPts; ++c) cc[c] = T(0);
    if (kCone) {
      __syncwarp();
      for (int j = lane; j < nslot; j += 32) {
        T u[kMaxConeDim];
        int cd, first, c0;
        const Cone<T> cone = slot_of(j, kCr, u, cd, first, c0);
        cc[0] += cone.cost(u);
#pragma unroll
        for (int c = 0; c < kPts; ++c) {
#pragma unroll
          for (int q = 0; q < kMaxConeDim; ++q) u[q] = q < cd ? cone_ref(kCv + c, c0 + q) : T(0);
          cc[1 + c] += cone.cost(u);
        }
      }
    }
#pragma unroll
    for (int c = 0; c <= kPts; ++c) {
      cost[c] = T(0.5) * cost[c] + warp_sum(rc[c]) + warp_sum(cc[c]);
    }
    __syncwarp();

    if constexpr (kSafe) {
      // x, then the candidates in order; x + 0 p where none is better.
      T best_cost = cost[0], best = T(0);
      bool better = false;
#pragma unroll
      for (int c = 0; c < kCand; ++c) {
        if (cost[1 + c] < best_cost) {
          best_cost = cost[1 + c];
          best = safeguard_step<T>(c, alpha);
          better = true;
        }
      }
      for (int i = lane; i < n; i += 32) {
        const T v = add_rn(xs[i], mul_rn(best, ps[i]));
        xo[i] = v;
        ys[i] = v;
      }
      if (lane == 0) {
        g.alpha[wd] = alpha;
        g.improved[wd] = better ? 1 : 0;
      }
      // 6. The output at x' from one more pass over the rows.
      output_at(ys, dy);
    } else {
      // The candidate where its cost is lower (a tie or a NaN keeps x).
      const bool better = cost[1] < cost[0];
      for (int i = lane; i < n; i += 32) xo[i] = better ? ys[i] : xs[i];
      if (lane == 0) {
        if constexpr (kWarm) {
          g.alpha[2 * wd] = cost[1];
          g.alpha[2 * wd + 1] = cost[0];
        } else {
          g.alpha[wd] = alpha;
          g.improved[wd] = better ? 1 : 0;
        }
      }
      // 6. The output at the chosen point from the passes: the regular rows'
      // weights (or forces), then the cone slots' and J^T f.
#pragma unroll
      for (int i = 0; i < kRegs; ++i) {
        if (lane + 32 * i < nr) {
          const int row = static_cast<int>(re[i] & 0xffffu), kd = static_cast<int>(re[i] >> 16);
          const T r = better ? ry[i] : rr[i];
          if (forces) {
            fw[row] = row_force(kd, rD[i], rfl[i], r);
          } else {
            ww[row] = row_hess(kd, rD[i], rfl[i], r);
          }
        }
      }
      for (int k = kCap + lane; k < nreg; k += 32) {
        const unsigned e = lw[k];
        const int row = static_cast<int>(e & 0xffffu), kd = static_cast<int>(e >> 16);
        const T r = reg_ref(better ? kRy : kR, k), Dr = reg_ref(kD, k), flr = reg_ref(kFl, k);
        if (forces) {
          fw[row] = row_force(kd, Dr, flr, r);
        } else {
          ww[row] = row_hess(kd, Dr, flr, r);
        }
      }
      T acc0 = better ? ay0 : ax0, acc1 = better ? ay1 : ax1;
      if (kCone) cone_out(better ? kCv : kCr, acc0, acc1);
      finish(better ? my0 : mx0, better ? my1 : mx1, acc0, acc1);
    }
  };

  if constexpr (kWarm) {
    // 3-5a of the warm start: one pass over the rows gives each row's
    // residual at x = a0 and at y = ws by the dot's own chain, the regular
    // rows' costs and forces at both, J^T f at both and the cone rows'
    // residuals at both (cone fields kCr and kCv).
    T ax0 = T(0), ax1 = T(0), ay0 = T(0), ay1 = T(0);
    T rc[kPts + 1] = {T(0), T(0)};
    for (ring.start(0, cnt); ring.more(); ring.release()) {
      const T* tl = ring.wait();
      const int i = ring.used, k = ring.first() + lane;
      T fx = T(0), fy = T(0);
      if (k < cnt) {
        const unsigned e = ring.entry();
        const T* jr = tl + lane * ld;
        T r = T(0), r1 = T(0);
        for (int c = 0; c < n; ++c) {
          r = fma(jr[c], xs[c], r);
          r1 = fma(jr[c], ys[c], r1);
        }
        const T ar = ring.side(0);
        r = r - ar;
        r1 = r1 - ar;
        if (k < nreg) {
          const int kd = static_cast<int>(e >> 16);
          const T Dr = ring.side(1), flr = flw != nullptr ? ring.side(2) : T(0);
          if (k < kCap) {
            put(rr, i, r);
            put(ry, i, r1);
            put(rD, i, Dr);
            put(rfl, i, flr);
            put(re, i, e);
          } else {
            reg_ref(kR, k) = r;
            reg_ref(kRy, k) = r1;
            reg_ref(kD, k) = Dr;
            reg_ref(kFl, k) = flr;
          }
          rc[0] += row_cost(kd, Dr, flr, r);
          rc[1] += row_cost(kd, Dr, flr, r1);
          fx = row_force(kd, Dr, flr, r);
          fy = row_force(kd, Dr, flr, r1);
        } else if (kCone) {
          cone_ref(kCr, k - nreg) = r;
          cone_ref(kCv, k - nreg) = r1;
        }
      }
      ftile[lane] = fx;
      ftile[32 + lane] = fy;
      __syncwarp();
      add_jtf2(tl, ring.rows(), ax0, ax1, ay0, ay1);
    }
    T mx0, mx1;
    m_of(xs, dz, mx0, mx1);
    accept(rc, mx0, mx1, ax0, ax1, ay0, ay1, T(1));
  } else {
    T ax0 = T(0), ax1 = T(0);
    for (ring.start(0, cnt); ring.more(); ring.release()) {
      const T* tl = ring.wait();
      const int i = ring.used, k = ring.first() + lane;
      T f = T(0);
      if (k < cnt) {
        const unsigned e = ring.entry();
        const T* jr = tl + lane * ld;
        T r = T(0), v = T(0);
        for (int c = 0; c < n; ++c) {
          r = fma(jr[c], xs[c], r);
          v = fma(jr[c], ps[c], v);
        }
        r = r - ring.side(0);
        if (k < nreg) {
          const T Dr = ring.side(1), flr = flw != nullptr ? ring.side(2) : T(0);
          if (k < kCap) {
            put(rr, i, r);
            put(rv, i, v);
            put(rD, i, Dr);
            put(rfl, i, flr);
            put(re, i, e);
          } else {
            reg_ref(kR, k) = r;
            reg_ref(kJv, k) = v;
            reg_ref(kD, k) = Dr;
            reg_ref(kFl, k) = flr;
          }
          if (!kSafe) f = row_force(static_cast<int>(e >> 16), Dr, flr, r);
        } else if (kCone) {
          cone_ref(kCr, k - nreg) = r;
          cone_ref(kCv, k - nreg) = v;
        }
      }
      if (!kSafe) {
        ftile[lane] = f;
        __syncwarp();
        add_jtf(tl, ring.rows(), ax0, ax1);
      }
    }
    // The acceptance's pass reads the same rows: their copies go in flight
    // now (they need no candidate point) and land during the steps.
    async_wait<0>();
    __syncwarp();
    ring.start(0, cnt);
    const int nr = min(nreg, kCap);
    // p M (x - a0) and p M p; M (x - a0) kept for x's cost and gradient.
    T mx0, mx1;
    m_of(xs, dz, mx0, mx1, false);
    T pmdx = T(0), pmp = T(0);
    if (lane < n) {
      pmdx += ps[lane] * mx0;
      pmp += ps[lane] * mv_row(lane, ps);
    }
    if (lane + 32 < n) {
      pmdx += ps[lane + 32] * mx1;
      pmp += ps[lane + 32] * mv_row(lane + 32, ps);
    }
    pmdx = warp_sum(pmdx);
    pmp = warp_sum(pmp);

    // 4. The 1-D Newton on phi'(alpha). With at most 32 active slots each
    // lane keeps its slot whole in registers.
    __syncwarp();
    const bool cached = kCone && nslot <= 32;
    Cone<T> mine;
    T cu[kMaxConeDim], cv[kMaxConeDim];
    if (kCone && cached && lane < nslot) {
      int cd, first, c0;
      mine = slot_of(lane, kCr, cu, cd, first, c0);
#pragma unroll
      for (int q = 0; q < kMaxConeDim; ++q) cv[q] = q < cd ? cone_ref(kCv, c0 + q) : T(0);
    }
    T alpha = T(1);
    for (int it = 0; it < g.count; ++it) {
      T sf = T(0), sh = T(0), ss = T(0), sc = T(0);
#pragma unroll
      for (int i = 0; i < kRegs; ++i) {
        if (lane + 32 * i < nr) {
          const int kd = static_cast<int>(re[i] >> 16);
          const T ra = rr[i] + alpha * rv[i];
          sf += row_force(kd, rD[i], rfl[i], ra) * rv[i];
          sh += row_hess(kd, rD[i], rfl[i], ra) * (rv[i] * rv[i]);
        }
      }
      for (int k = kCap + lane; k < nreg; k += 32) {
        const T v = reg_ref(kJv, k), Dr = reg_ref(kD, k), flr = reg_ref(kFl, k);
        const int kd = static_cast<int>(lw[k] >> 16);
        const T ra = reg_ref(kR, k) + alpha * v;
        sf += row_force(kd, Dr, flr, ra) * v;
        sh += row_hess(kd, Dr, flr, ra) * (v * v);
      }
      if (kCone) {
        if (cached) {
          if (lane < nslot) {
            T slope, curv;
            mine.line(cu, cv, alpha, slope, curv);
            ss += slope;
            sc += curv;
          }
        } else {
          for (int j = lane; j < nslot; j += 32) {
            T u[kMaxConeDim], v[kMaxConeDim];
            int cd, first, c0;
            const Cone<T> cone = slot_of(j, kCr, u, cd, first, c0);
#pragma unroll
            for (int q = 0; q < kMaxConeDim; ++q) v[q] = q < cd ? cone_ref(kCv, c0 + q) : T(0);
            T slope, curv;
            cone.line(u, v, alpha, slope, curv);
            ss += slope;
            sc += curv;
          }
        }
      }
      const T slope = warp_sum(sf + ss), curv = warp_sum(sh + sc);
      const T dphi = pmdx + alpha * pmp - slope;
      const T ddphi = pmp + curv;
      const T next = alpha - dphi / clamp_min(ddphi, T(1e-30));
      // A step is a function of alpha alone: once it returns alpha, so does
      // every later one (the same in every lane, so the warp leaves
      // together).
      if (same_bits(next, alpha)) break;
      alpha = next;
    }

    // 5a. The acceptance, each candidate's cost from its own point.
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
#pragma unroll
      for (int c = 0; c < kPts; ++c) {
        ys[c * n + i] = add_rn(xs[i], mul_rn(safeguard_step<T>(c, alpha), ps[i]));
      }
    }
    __syncwarp();
    // One pass over the rows: each row's residual at the candidates by the
    // dot's own chain, x's and their costs; without the safeguard the
    // candidate's forces, its J^T f and r kept for the output.
    T rc[kPts + 1];
#pragma unroll
    for (int c = 0; c <= kPts; ++c) rc[c] = T(0);
    T ay0 = T(0), ay1 = T(0);
    for (; ring.more(); ring.release()) {
      const T* tl = ring.wait();
      const int i = ring.used, k = ring.first() + lane;
      T f = T(0);
      if (k < cnt) {
        const unsigned e = ring.entry();
        const T* jr = tl + lane * ld;
        T r[kPts];
#pragma unroll
        for (int c = 0; c < kPts; ++c) r[c] = T(0);
        for (int col = 0; col < n; ++col) {
          const T jc = jr[col];
#pragma unroll
          for (int c = 0; c < kPts; ++c) r[c] = fma(jc, ys[c * n + col], r[c]);
        }
        const T ar = ring.side(0);
#pragma unroll
        for (int c = 0; c < kPts; ++c) r[c] = r[c] - ar;
        if (k < nreg) {
          const int kd = static_cast<int>(e >> 16);
          T r_x, Dr, flr;
          if (k < kCap) {
            r_x = pick(rr, i);
            Dr = pick(rD, i);
            flr = pick(rfl, i);
            if (!kSafe) put(ry, i, r[0]);
          } else {
            r_x = reg_ref(kR, k);
            Dr = reg_ref(kD, k);
            flr = reg_ref(kFl, k);
            if (!kSafe) reg_ref(kRy, k) = r[0];
          }
          rc[0] += row_cost(kd, Dr, flr, r_x);
#pragma unroll
          for (int c = 0; c < kPts; ++c) rc[1 + c] += row_cost(kd, Dr, flr, r[c]);
          if (!kSafe) f = row_force(kd, Dr, flr, r[0]);
        } else if (kCone) {
#pragma unroll
          for (int c = 0; c < kPts; ++c) cone_ref(kCv + c, k - nreg) = r[c];
        }
      }
      if (!kSafe) {
        ftile[lane] = f;
        __syncwarp();
        add_jtf(tl, ring.rows(), ay0, ay1);
      }
    }
    accept(rc, mx0, mx1, ax0, ax1, ay0, ay1, alpha);
  }
}

// Runs `kernel`, one block of one warp per world, letting it take up to
// kMaxSmem of dynamic shared memory (once per device, `seen`). With
// `report`, launches nothing and fills it instead (see newton_iter_config).
template <typename T, typename K>
int run(K kernel, int& seen, size_t bytes, const Args<T>& a, cudaStream_t stream, int* report) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != seen) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
    if (e == cudaSuccess) seen = dev;
  }
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
    const int out[5] = {per_sm, sms, static_cast<int>(bytes), attr.numRegs,
                        static_cast<int>(attr.localSizeBytes)};
    for (int k = 0; k < 5; ++k) report[k] = out[k];
    return static_cast<int>(cudaSuccess);
  }
  kernel<<<a.batch, 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode, bool kCone>
int launch(const Args<T>& a, cudaStream_t stream, int* report) {
  static int seen = -1;
  return run<T>(newton_iter_kernel<T, kMode, kCone>, seen, Layout<T>(a.n, kMode, kCone).total, a,
                stream, report);
}

template <typename T>
int dispatch(int mode, const Args<T>& a, cudaStream_t stream, int* report = nullptr) {
  if (a.n < 1 || a.n > kMaxN || a.batch < 1 || a.m < 1 || a.m > kMaxRows || a.ncone < 0 ||
      a.ncone > kMaxRows || a.nb < 0 || a.count < 0 || a.ext_reg < 0 || a.ext_cone < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool cone = a.ncone > 0;
  switch (mode) {
    case kGradient:
      return cone ? launch<T, kGradient, true>(a, stream, report)
                  : launch<T, kGradient, false>(a, stream, report);
    case kLinesearch:
      return cone ? launch<T, kLinesearch, true>(a, stream, report)
                  : launch<T, kLinesearch, false>(a, stream, report);
    case kSafeguard: return launch<T, kSafeguard, true>(a, stream, report);
    case kWarmStart:
      return cone ? launch<T, kWarmStart, true>(a, stream, report)
                  : launch<T, kWarmStart, false>(a, stream, report);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point takes the same arguments: qM (batch, n, n), J (batch,
// m, n), D, aref (batch, m), fl (batch, m) or null, kind (m) int32 or null,
// tab (ncone, 3) int32 [first row, cd <= 6, block offset] and mu0 (batch,
// ncone) (null when ncone is 0), a0 (batch, n), x, p, xo, alpha, improved
// (uint8), vec, force, w, blocks, lst, counts, slots, scratch, then batch,
// n, m, ncone, nb (the packed cone blocks per world), count, flags, ext_reg
// and ext_cone (rows past the register and shared caps that the scratch
// holds, newton_iter_scratch_elems) and the stream. w (batch, m), blocks
// (batch, nb), lst (batch, m) int32, counts (batch, 4) int32, slots (batch,
// ncone) int32 and scratch are one solve's: the warm start (or a
// newton_gradient with flags & 2) fills lst, counts, slots and the zeros of w
// and blocks, and every later launch on the solve reads them.
//   warm_start: x = ws (batch, n); xo = x0, ws where its cost is lower than
//     a0's (else a0), alpha = the costs at ws and a0 (batch, 2), and
//     newton_gradient's outputs at x0 (vec = grad, w, blocks).
//   newton_gradient: x (batch, n); vec = grad (batch, n), w and blocks at x;
//     with flags & 1, vec = qfrc = J^T f and force = efc_force (batch, m),
//     zero-filled by the caller, instead.
//   newton_linesearch: x, p (batch, n), count = linesearch steps, flags & 4
//     for the safeguard's acceptance; xo = x', alpha, improved (batch), and
//     newton_gradient's outputs at x' (flags & 1: the forces).
#define NEWTON_ENTRY(NAME, T, SUF, MODE)                                                         \
  int NAME##_##SUF(const T* qM, const T* J, const T* D, const T* aref, const T* fl,             \
                   const int* kind, const int* tab, const T* mu0, const T* a0, const T* x,      \
                   const T* p, T* xo, T* alpha, unsigned char* improved, T* vec, T* force,      \
                   T* w, T* blocks, unsigned* lst, int* counts, unsigned* slots, T* scratch,    \
                   int batch, int n, int m, int ncone, int nb, int count, int flags,           \
                   int ext_reg, int ext_cone, void* stream) {                                   \
    const Args<T> a{qM,    J,     D,     aref,  fl,     kind,  tab,     mu0,      a0,          \
                    x,     p,     xo,    alpha, improved, vec, force,   w,        blocks,      \
                    lst,   counts, slots, scratch, batch, n,   m,       ncone,    nb,          \
                    count, flags, ext_reg, ext_cone};                                           \
    return dispatch<T>(MODE, a, static_cast<cudaStream_t>(stream));                             \
  }

extern "C" {

NEWTON_ENTRY(newton_gradient, float, f32, kGradient)
NEWTON_ENTRY(newton_gradient, double, f64, kGradient)
NEWTON_ENTRY(newton_linesearch, float, f32, (flags & kWithSafeguard) ? kSafeguard : kLinesearch)
NEWTON_ENTRY(newton_linesearch, double, f64, (flags & kWithSafeguard) ? kSafeguard : kLinesearch)
NEWTON_ENTRY(warm_start, float, f32, kWarmStart)
NEWTON_ENTRY(warm_start, double, f64, kWarmStart)

// Elements per world of a solve's scratch for m rows of which mc are cone
// rows.
int newton_iter_scratch_elems(int m, int mc) {
  return kRegFields * (m > kCap ? m - kCap : 0) + kConeFields * (mc > kConeCap ? mc - kConeCap : 0);
}

// The launch of `mode` (0 gradient, 1 linesearch, 2 with the safeguard, 3
// warm start) for these shapes and element size, launching nothing: out[0..4] =
// resident worlds per SM, SMs, shared bytes per world, registers and local
// (spill) bytes per thread.
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
