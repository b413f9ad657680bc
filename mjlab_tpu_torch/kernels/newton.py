"""The rest of the Newton iteration on each world's active rows: the warm
start, the exact linesearch with the step's acceptance, and the gradient, as
CUDA kernels' wrappers and their plain PyTorch versions.

Replaces what XLA fused in the JAX package's solver (no TPU kernel existed
for it): the warm start (mjlab_tpu/physics/solver.py:182-192), `newton_iter`
up to H and its linesearch and acceptance (:217-266), `linesearch`
(:268-287), the gradients and steps of `cg_solve` (:289-325) and the final
forces (:378-386), with the cost pieces they call (`residual` :166,
`row_cost` :169, `total_cost` :182, `row_force` :194, `row_hess` :207 and
the cone functions :105-164). The Newton direction stays with
`chol.newton_direction[_cone]`.

The cost, per world, over qacc x (a0 = qacc_smooth):
  Φ(x) = 0.5 (x − a0)ᵀ M (x − a0) + Σ_i cost_i(J_i x − aref_i) + Σ_s cone_s
with each row's cost by its class (`Rows.kind`): one-sided quadratic
0.5 D r² iff r < 0 (limits, pyramidal facets, condim-1 contacts), bilateral
quadratic (equality rows), Huber (dof friction-loss rows, linear outside
|D r| ≤ fl), and the elliptic cone's three zones per slot (condim ≥ 3
contacts under cone="elliptic"), whose rows are left out of the regular sum.
A row with D = 0 is inert.

Entry points, each taking a `Rows` (one solve's inputs):
- `warm_start(rows, ws)` → (x0, cost (B, 2), ∇Φ(x0), w, blocks): MuJoCo's
  choice x0 = ws where Φ(ws) < Φ(a0), else a0 (a tie or a NaN keeps a0),
  the two costs [Φ(ws), Φ(a0)], and `newton_gradient(rows, x0)`'s output,
  from one launch: the solve's first.
- `newton_gradient(rows, x)` → (∇Φ(x), the row weights w, the packed cone
  Hessians or None); with `forces=True` → (efc_force, qfrc_constraint =
  Jᵀ efc_force) at x instead, the end of a solve of 0 iterations.
- `newton_linesearch(rows, x, p, iterations, safeguard[, forces])` → (x',
  α, improved, at): `iterations` steps of the 1-D Newton on φ'(α) from
  α = 1, then x + αp if its cost is lower than x's (else x) or, with
  `safeguard` (the elliptic Newton step), the best improving step of {α, 1,
  0.5, 0.25, 0.1, 0.01} (ties to the earlier candidate), x + 0·p if none;
  `at` is `newton_gradient(rows, x', forces)`'s output, from the same launch.
A Newton or CG solve of K ≥ 1 iterations launches one warm_start and then
one newton_linesearch per iteration, the last one with `forces`.

Kernels (csrc/newton_iter.cu): one world per one-warp block, the whole
batch in one grid. The warm start lists each world's active rows (D ≠ 0,
NaN counted) and active cone slots (Dn > 0) from one scan of D into buffers
the Rows keeps on the card (`_state`), and writes w and the cone blocks on
the inactive rows and slots once (a newton_gradient on a Rows without a
list builds it the same way); every later launch of the solve reads that
list, and the w and blocks it returns are those buffers, rewritten by the
next launch on the same Rows. The listed rows of J stream through a ring of
32-row tiles in shared memory (cp.async), one lane per row: the warm start
takes one pass over them for its two points' residuals, costs and Jᵀf; the
linesearch holds its rows' residuals, J p, D and fl in registers up to CAP
rows and in a global scratch beyond; qM in shared memory. Bound: the bytes
of D on every row and w on the inactive rows once per solve, then per
launch the active rows of J, aref, fl and D, qM and the vectors
(chip_smoke.py `newton_bounds` reckons it from the run's rows).

A linesearch step and a Newton or CG iteration are functions of α, x (and
CG's state) alone: once one returns its input bitwise, so does every later
one. The kernel stops a world's linesearch there; on the CPU the plain
linesearch and the solver's iterations stop there too (a host check that
the card path does not make). Either way the result is the one every step
would give, bitwise.

Each wrapper takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, with no fallback between them. Launches are
counted in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

MAX_N = 64
MAX_ROWS = 65535
CAP = 128  # listed regular rows per world a linesearch holds in registers
FIELDS = 5  # per regular row past CAP: r, J p, D, fl, r at the candidate
CONE_CAP = 64  # listed cone rows per world in shared memory
CONE_FIELDS = 7  # per cone row past CONE_CAP: r, J p, and five values at other points
_EPS = 1e-15
# Row classes (`Rows.kind`).
ONE_SIDED, EQUALITY, FRICTION, CONE_ROW = 0, 1, 2, 3
SAFEGUARD_STEPS = (1.0, 0.5, 0.25, 0.1, 0.01)

LAUNCHES = {"warm_start": 0, "newton_gradient": 0, "newton_linesearch": 0}


def reset_counts() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Batched matrix-vector product (B, n, m) @ (B, m) → (B, n)."""
  return (M @ x[..., None])[..., 0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
  """Whether two float tensors hold the same bits (a NaN equals itself, and
  −0 differs from +0)."""
  as_int = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
  return torch.equal(a.view(as_int), b.view(as_int))


class Rows:
  """One solve's inputs: qM (B, n, n), J (B, m, n), D, aref (B, m), a0
  (B, n); the friction loss fl (B, m) where the model has friction-loss
  rows; the row classes as the constraint tables hold them (float masks
  is_eq, is_fric and reg, 0 on the cone rows, each None where the model has
  no such row, and `kind` (m,) int32 for the kernels, None where every row
  is one-sided); the cone slots' layout (chol.ConeLayout) and their
  friction coefficients mu0 (B, S) in layout order, or None. The methods
  are the plain version's cost pieces."""

  def __init__(self, qM, J, D, aref, a0, *, fl=None, is_eq=None, is_fric=None, reg=None,
               kind=None, layout=None, mu0=None):
    self.qM, self.J, self.D, self.aref, self.a0 = qM, J, D, aref, a0
    self.fl, self.is_eq, self.is_fric, self.reg, self.kind = fl, is_eq, is_fric, reg, kind
    self.layout = layout if layout is not None and layout.table.shape[0] else None
    self.mu0 = mu0 if self.layout is not None else None
    self._card = None  # the solve's buffers on the card (`_state`)

  @classmethod
  def of(cls, tp, d) -> "Rows":
    """A solve's rows from the forward's Data and the constraint tables."""
    t = tp.dev.con
    mu0 = None
    if t.cone_groups:
      mu0 = torch.cat([d.contact.friction[:, g.slots, 0] for g in t.cone_groups], 1)
    return cls(d.qM.contiguous(), d.efc_J.contiguous(), d.efc_D.contiguous(),
               d.efc_aref.contiguous(), d.qacc_smooth.contiguous(),
               fl=d.efc_frictionloss.contiguous() if t.is_fric is not None else None,
               is_eq=t.is_eq, is_fric=t.is_fric, reg=t.reg, kind=t.kind,
               layout=t.cone_kernel_layout,
               mu0=mu0.contiguous() if mu0 is not None else None)

  @functools.cached_property
  def groups(self) -> list[SimpleNamespace]:
    """Per condim group of cone slots: its rows and per-solve whitening."""
    out = []
    if self.layout is None:
      return out
    for cd, s0, n in self.layout.groups:
      rows = (self.layout.table[s0 : s0 + n, 0].long()[:, None]
              + torch.arange(cd, device=self.D.device))
      mu0 = self.mu0[:, s0 : s0 + n]
      Dn = self.D[:, rows[:, 0]]
      Df = self.D[:, rows[:, 1:]]
      safe_Dn = torch.clamp_min(Dn, _EPS)
      mu = mu0 * torch.sqrt(safe_Dn / torch.clamp_min(Df[..., 0], _EPS))
      out.append(SimpleNamespace(
        rows=rows, flat_rows=rows.reshape(-1), Dn=Dn, Df=Df, active=Dn > 0,
        s=torch.sqrt(torch.clamp_min(Df, _EPS) / safe_Dn[..., None]), mu=mu,
        one_mu2=1.0 + mu * mu,
      ))
    return out

  def residual(self, x):
    return _mv(self.J, x) - self.aref

  # -- per-row costs (regular rows) --

  def _masked(self, fric, eq, other):
    """Pick each row's value by its class."""
    out = other
    if self.is_eq is not None:
      out = torch.where(self.is_eq > 0, eq, out)
    if self.is_fric is not None:
      out = torch.where(self.is_fric > 0, fric, out)
    if self.reg is not None:
      out = out * self.reg
    return out

  def row_cost(self, r):
    quad = 0.5 * self.D * r * r
    huber = None
    if self.is_fric is not None:
      lin = self.fl / torch.clamp_min(self.D, 1e-30)
      huber = torch.where(torch.abs(r) > lin, self.fl * torch.abs(r) - 0.5 * self.fl * lin, quad)
    return self._masked(huber, quad, torch.where(r < 0, quad, torch.zeros_like(r)))

  def row_hess(self, r):
    huber = None
    if self.is_fric is not None:
      lin = self.fl / torch.clamp_min(self.D, 1e-30)
      huber = torch.where(torch.abs(r) <= lin, self.D, torch.zeros_like(r))
    return self._masked(huber, self.D, torch.where(r < 0, self.D, torch.zeros_like(r)))

  def regular_force(self, r):
    """−∂cost/∂r per row, 0 on the cone rows."""
    quad = -self.D * r
    huber = torch.clamp(quad, -self.fl, self.fl) if self.is_fric is not None else None
    return self._masked(huber, quad, torch.where(r < 0, quad, torch.zeros_like(r)))

  def row_force(self, r):
    """−∂cost/∂r per row, the cone rows' included."""
    f = self.regular_force(r)
    for g in self.groups:
      f = f.index_copy(1, g.flat_rows, self.cone_force(g, r[:, g.rows]).flatten(1))
    return f

  # -- the elliptic cone --

  @staticmethod
  def zones(g, u):
    """u (B, Sg, cd) cone-row residuals → zone classification."""
    N = u[..., 0]
    ut_w = u[..., 1:] * g.s
    T = torch.sqrt(torch.sum(ut_w * ut_w, dim=-1) + _EPS)
    top = g.mu * T <= N
    bottom = T <= -g.mu * N
    a = (g.mu * T - N) / g.one_mu2
    return N, ut_w, T, top, bottom, a

  def cone_cost(self, r):
    total = 0.0
    for g in self.groups:
      u = r[:, g.rows]
      N, ut_w, T, top, bottom, a = self.zones(g, u)
      c_bot = 0.5 * (g.Dn * N * N + torch.sum(g.Df * u[..., 1:] ** 2, dim=-1))
      c_mid = 0.5 * g.Dn * a * a * g.one_mu2
      c = torch.where(top, torch.zeros_like(N), torch.where(bottom, c_bot, c_mid))
      total = total + torch.sum(torch.where(g.active, c, torch.zeros_like(c)), dim=-1)
    return total

  def cone_force(self, g, u):
    """Per-row cone forces (B, Sg, cd) in row space."""
    N, ut_w, T, top, bottom, a = self.zones(g, u)
    f_bot = -torch.cat([(g.Dn * u[..., 0])[..., None], g.Df * u[..., 1:]], dim=-1)
    fn_mid = g.Dn * a
    ft_mid = -g.mu[..., None] * fn_mid[..., None] * ut_w / T[..., None] * g.s
    f_mid = torch.cat([fn_mid[..., None], ft_mid], dim=-1)
    f = torch.where(top[..., None], torch.zeros_like(f_mid),
                    torch.where(bottom[..., None], f_bot, f_mid))
    return torch.where(g.active[..., None], f, torch.zeros_like(f))

  def cone_hess(self, g, u):
    """Per-slot (B, Sg, cd, cd) cost Hessians (row space, exact)."""
    N, ut_w, T, top, bottom, a = self.zones(g, u)
    s, mu, one_mu2, Dn = g.s, g.mu, g.one_mu2, g.Dn
    g_t = mu[..., None] * s * ut_w / T[..., None] / one_mu2[..., None]
    gr = torch.cat([(-1.0 / one_mu2)[..., None], g_t], dim=-1)
    gg = gr[..., :, None] * gr[..., None, :]
    s2u = s * ut_w
    t_outer = s2u[..., :, None] * s2u[..., None, :] / (T ** 3)[..., None, None]
    t_diag = torch.diag_embed(s * s) / T[..., None, None]
    hess_a = torch.zeros_like(gg)
    hess_a[..., 1:, 1:] = (mu / one_mu2)[..., None, None] * (t_diag - t_outer)
    B_mid = (Dn * one_mu2)[..., None, None] * (gg + a[..., None, None] * hess_a)
    B_bot = torch.diag_embed(torch.cat([Dn[..., None], g.Df], dim=-1))
    Bm = torch.where(top[..., None, None], torch.zeros_like(B_mid),
                     torch.where(bottom[..., None, None], B_bot, B_mid))
    return torch.where(g.active[..., None, None], Bm, torch.zeros_like(Bm))

  @staticmethod
  def cone_line(g, r0, v):
    """The linesearch's cone terms along u(α) = r0 + α v (solver.py:
    239-244): a function of α (B,) giving, per slot (B, Sg), the force's
    slope Σ_i f_i v_i and the curvature vᵀ B v, without forming the force
    rows or B. In the middle zone f = Dn·a·[1, −μ S ũ/T] and
    B = Dn(1+μ²)(∇a∇aᵀ + a∇²a); at the bottom f = −D u and B = diag(D); 0
    at the top. What does not depend on α is taken once."""
    s, mu, one_mu2, Dn = g.s, g.mu, g.one_mu2, g.Dn
    v0, vt, r00, rt = v[..., 0], v[..., 1:], r0[..., 0], r0[..., 1:]
    sv_t = s * vt
    vsv = torch.sum(sv_t * sv_t, dim=-1)  # Σ s² v_t²
    curv_bot = Dn * v0 * v0 + torch.sum(g.Df * vt * vt, dim=-1)
    Dn_v0, Df_vt = Dn * v0, g.Df * vt
    inv1, k, Dn1, neg_mu = 1.0 / one_mu2, mu / one_mu2, Dn * one_mu2, -mu
    zeros = torch.zeros_like(v0)

    def at(alpha):
      al = alpha[:, None]
      N = r00 + al * v0
      ut = rt + al[..., None] * vt
      ut_w = ut * s
      T = torch.sqrt(torch.sum(ut_w * ut_w, dim=-1) + _EPS)
      muT = mu * T
      top, bottom = muT <= N, T <= neg_mu * N
      a = (muT - N) * inv1
      sv = torch.sum(ut_w * sv_t, dim=-1)
      q = mu * sv / T
      slope_mid = (Dn * a) * (v0 - q)
      slope_bot = -(Dn_v0 * N + torch.sum(Df_vt * ut, dim=-1))
      ga = (q - v0) * inv1
      ha = k * (vsv / T - sv * sv / (T * T * T))
      curv_mid = Dn1 * (ga * ga + a * ha)

      def pick(mid, bot):
        return torch.where(g.active, torch.where(top, zeros, torch.where(bottom, bot, mid)),
                           zeros)

      return pick(slope_mid, slope_bot), pick(curv_mid, curv_bot)

    return at

  def cone_blocks(self, r):
    """The packed cone Hessians (B, nb) the Newton kernel reads."""
    return torch.cat([self.cone_hess(g, r[:, g.rows]).flatten(1) for g in self.groups], dim=1)

  # -- the cost and the linesearch --

  def total_cost(self, x):
    dx = x - self.a0
    r = self.residual(x)
    c = 0.5 * _bdot(dx, _mv(self.qM, dx)) + torch.sum(self.row_cost(r), dim=-1)
    return c + self.cone_cost(r) if self.groups else c

  def linesearch(self, x, r, p, iterations: int):
    """Exact 1-D Newton linesearch along p from x (shared by Newton and CG)."""
    jv = _mv(self.J, p)
    p_m_dx = _bdot(p, _mv(self.qM, x - self.a0))
    p_m_p = _bdot(p, _mv(self.qM, p))
    cones = [self.cone_line(g, r[:, g.rows], jv[:, g.rows]) for g in self.groups]
    alpha = torch.ones_like(p_m_p)
    for _ in range(iterations):
      ra = r + alpha[:, None] * jv
      dphi = p_m_dx + alpha * p_m_p - _bdot(self.regular_force(ra), jv)
      ddphi = p_m_p + _bdot(self.row_hess(ra), jv * jv)
      for line in cones:
        slope, curv = line(alpha)
        dphi = dphi - torch.sum(slope, dim=-1)
        ddphi = ddphi + torch.sum(curv, dim=-1)
      step = alpha - dphi / torch.clamp_min(ddphi, 1e-30)
      # A step is a function of α alone: once it returns α in every world,
      # so does every later one. On the CPU the loop stops there.
      if step.device.type == "cpu" and same_bits(step, alpha):
        break
      alpha = step
    return alpha


def row_classes(kind, dtype, device) -> dict:
  """The class tables of rows whose classes are `kind` (m,) (numpy ints,
  ONE_SIDED ... CONE_ROW): the masks the plain version reads and the int32
  table the kernels read, each None where no row has that class."""
  import numpy as np

  kind = np.asarray(kind, dtype=np.int32)

  def mask(x):
    return torch.as_tensor(x.astype(np.float64), dtype=dtype, device=device)

  return dict(
    is_eq=mask(kind == EQUALITY) if (kind == EQUALITY).any() else None,
    is_fric=mask(kind == FRICTION) if (kind == FRICTION).any() else None,
    reg=mask(kind != CONE_ROW) if (kind == CONE_ROW).any() else None,
    kind=torch.as_tensor(kind, device=device) if kind.any() else None,
  )


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' check).
# ---------------------------------------------------------------------------


def newton_gradient_plain(rows: Rows, x: torch.Tensor, forces: bool = False):
  r = rows.residual(x)
  f = rows.row_force(r)
  Jt = rows.J.transpose(-1, -2)
  if forces:
    return f, _mv(Jt, f)
  grad = _mv(rows.qM, x - rows.a0) - _mv(Jt, f)
  return grad, rows.row_hess(r), rows.cone_blocks(r) if rows.groups else None


def newton_linesearch_plain(rows: Rows, x: torch.Tensor, p: torch.Tensor, iterations: int,
                            safeguard: bool):
  alpha = rows.linesearch(x, rows.residual(x), p, iterations)
  if safeguard:
    # The elliptic Newton step: the 1-D Newton can diverge on the cone
    # landscape; keep the best improving step of a small candidate set.
    best_cost, best_alpha = rows.total_cost(x), torch.zeros_like(alpha)
    improved = torch.zeros_like(alpha, dtype=torch.bool)
    for cand in (alpha, *SAFEGUARD_STEPS):
      ca = cand if torch.is_tensor(cand) else torch.full_like(alpha, cand)
      c = rows.total_cost(x + ca[:, None] * p)
      better = c < best_cost
      best_cost = torch.where(better, c, best_cost)
      best_alpha = torch.where(better, ca, best_alpha)
      improved = improved | better
    return x + best_alpha[:, None] * p, alpha, improved
  # Reject non-improving steps (keeps lockstep envs safe post-convergence).
  x_new = x + alpha[:, None] * p
  improved = rows.total_cost(x_new) < rows.total_cost(x)
  return torch.where(improved[:, None], x_new, x), alpha, improved


def warm_start_plain(rows: Rows, ws: torch.Tensor):
  cost = torch.stack([rows.total_cost(ws), rows.total_cost(rows.a0)], dim=1)
  x0 = torch.where((cost[:, 0] < cost[:, 1])[:, None], ws, rows.a0)
  return (x0, cost, *newton_gradient_plain(rows, x0))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_bound: dict[str, ctypes._CFuncPtr] = {}
_PTRS = ("qM", "J", "D", "aref", "fl", "kind", "tab", "mu0", "a0", "x", "p", "xo", "alpha",
         "improved", "vec", "force", "w", "blocks", "lst", "counts", "slots", "scratch")
_NINT = 9  # batch, n, m, ncone, nb, count, flags, ext_reg, ext_cone
FORCES, BUILD, WITH_SAFEGUARD = 1, 2, 4  # the entry points' flags


def _bind(lib: ctypes.CDLL, key: str):
  """An entry point of a newton_iter library with its argument types."""
  f = getattr(lib, key)
  if key == "newton_iter_config":
    f.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
  elif key == "newton_iter_scratch_elems":
    f.argtypes = [ctypes.c_int] * 2
  else:
    f.argtypes = [ctypes.c_void_p] * len(_PTRS) + [ctypes.c_int] * _NINT + [ctypes.c_void_p]
  f.restype = ctypes.c_int
  return f


def check_library(lib: ctypes.CDLL) -> None:
  """Raises unless the library sizes its scratch as `scratch_elems` does."""
  sizes = _bind(lib, "newton_iter_scratch_elems")
  if sizes(1000, 200) != scratch_elems(1000, 200):
    raise RuntimeError("kernels/newton.py's scratch sizes disagree with csrc/newton_iter.cu's")


def _fn(key: str):
  if key not in _bound:
    from mjlab_tpu_torch.kernels import build

    lib = build.library("newton_iter")
    if not _bound:
      check_library(lib)
    _bound[key] = _bind(lib, key)
  return _bound[key]


def scratch_elems(m: int, mc: int = 0) -> int:
  """Elements per world of a solve's scratch for m rows of which mc are cone
  rows: FIELDS values for each regular row past CAP, CONE_FIELDS for each
  cone row past CONE_CAP (the library's newton_iter_scratch_elems)."""
  return FIELDS * max(m - CAP, 0) + CONE_FIELDS * max(mc - CONE_CAP, 0)


def cone_rows(layout) -> int:
  """The cone rows of a layout (Σ cd over its slots), from its host-side
  groups."""
  return 0 if layout is None else sum(cd * k for cd, _, k in layout.groups)


def _check(rows: Rows, what: str, *vecs) -> tuple[int, int, int]:
  qM = rows.qM
  if qM.device.type != "cuda":
    raise ValueError(f"{what}: expected a CUDA tensor, got {qM.device}")
  if qM.dtype not in _SUFFIX:
    raise TypeError(f"{what}: dtype {qM.dtype} (float32/float64 only)")
  if qM.dim() != 3 or qM.shape[1] != qM.shape[2] or not 1 <= qM.shape[1] <= MAX_N:
    raise ValueError(f"{what}: expected qM (B, n, n) with n <= {MAX_N}, got {tuple(qM.shape)}")
  B, n = qM.shape[:2]
  if rows.J.dim() != 3 or not 1 <= rows.J.shape[1] <= MAX_ROWS:
    raise ValueError(f"{what}: expected J (B, m, n) with 1 <= m <= {MAX_ROWS}")
  m = rows.J.shape[1]
  shapes = [(rows.J, (B, m, n)), (rows.D, (B, m)), (rows.aref, (B, m)), (rows.a0, (B, n))]
  if rows.fl is not None:
    shapes.append((rows.fl, (B, m)))
  if rows.layout is not None:
    shapes.append((rows.mu0, (B, rows.layout.table.shape[0])))
  shapes += [(v, shape) for v, shape in vecs]
  for t, shape in shapes:
    if t.device != qM.device or t.dtype != qM.dtype:
      raise ValueError(f"{what}: every tensor must match qM's device and dtype")
    if tuple(t.shape) != shape:
      raise ValueError(f"{what}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
      raise ValueError(f"{what}: tensors must be contiguous")
  for t in (rows.kind, None if rows.layout is None else rows.layout.table):
    if t is not None and (t.device != qM.device or t.dtype != torch.int32
                          or not t.is_contiguous()):
      raise ValueError(f"{what}: the row classes and cone layout must be contiguous int32 "
                       "on the card")
  if rows.kind is not None and tuple(rows.kind.shape) != (m,):
    raise ValueError(f"{what}: kind has shape {tuple(rows.kind.shape)}, expected ({m},)")
  return B, n, m


def _state(rows: Rows) -> SimpleNamespace:
  """The solve's buffers on the card, allocated at its first launch: the
  list of active rows (B, m) int32 (row | class << 16), the counts (B, 4)
  int32 (regular rows, listed rows, active slots), the active slots (B, S)
  int32 (slot | offset << 16), the row weights w (B, m), the cone blocks
  (B, nb) and the scratch; `built` once a launch has listed the rows (the
  warm start, or a newton_gradient on a Rows without a list; a host flag:
  nothing leaves the card)."""
  if rows._card is None:
    B, m = rows.D.shape
    lay = rows.layout
    S, mc = (0, 0) if lay is None else (lay.table.shape[0], cone_rows(lay))
    like = dict(dtype=rows.D.dtype, device=rows.D.device)
    ints = dict(dtype=torch.int32, device=rows.D.device)
    rows._card = SimpleNamespace(
      built=False, lst=torch.empty((B, m), **ints), counts=torch.empty((B, 4), **ints),
      slots=torch.empty((B, max(S, 1)), **ints), w=torch.empty((B, m), **like),
      blocks=None if lay is None else torch.empty((B, lay.nb), **like),
      scratch=torch.empty((B, max(scratch_elems(m, mc), 1)), **like),
      ext=(max(m - CAP, 0), max(mc - CONE_CAP, 0)))
  return rows._card


def _launch(name: str, rows: Rows, tensors: dict, count: int, flags: int,
            ext: tuple[int, int]) -> None:
  """One launch of an entry point on the tensors' pointers (`_PTRS`). A CPU
  tensor reaches it only from the CPU emulation of the kernels
  (tools/warp_emu), with no stream."""
  B, n = rows.qM.shape[:2]
  m = rows.J.shape[1]
  lay = rows.layout
  S, nb = (0, 0) if lay is None else (lay.table.shape[0], lay.nb)
  t = dict(qM=rows.qM, J=rows.J, D=rows.D, aref=rows.aref, fl=rows.fl, kind=rows.kind,
           tab=None if lay is None else lay.table, mu0=rows.mu0, a0=rows.a0, **tensors)
  ptrs = [None if t.get(k) is None else t[k].data_ptr() for k in _PTRS]
  fn = _fn(f"{name}_{_SUFFIX[rows.qM.dtype]}")
  dev = rows.qM.device
  if dev.type == "cuda":
    with torch.cuda.device(dev):
      rc = fn(*ptrs, B, n, m, S, nb, count, flags, *ext, torch.cuda.current_stream(dev).cuda_stream)
  else:
    rc = fn(*ptrs, B, n, m, S, nb, count, flags, *ext, None)
  if rc != 0:
    raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
  LAUNCHES[name] += 1


def _gradient_kernel(rows: Rows, x: torch.Tensor, forces: bool = False):
  st = _state(rows)
  vec = torch.empty_like(x)
  force = torch.zeros_like(rows.D) if forces else None
  _launch("newton_gradient", rows, dict(x=x, vec=vec, force=force, w=st.w, blocks=st.blocks,
                                         lst=st.lst, counts=st.counts, slots=st.slots,
                                         scratch=st.scratch),
          0, (FORCES if forces else 0) | (0 if st.built else BUILD), st.ext)
  st.built = True
  return (force, vec) if forces else (vec, st.w, st.blocks)


def _warm_start_kernel(rows: Rows, ws: torch.Tensor):
  st = _state(rows)
  B = ws.shape[0]
  x0, vec = torch.empty_like(ws), torch.empty_like(ws)
  cost = torch.empty((B, 2), dtype=ws.dtype, device=ws.device)
  _launch("warm_start", rows, dict(x=ws, xo=x0, alpha=cost, vec=vec, w=st.w, blocks=st.blocks,
                                   lst=st.lst, counts=st.counts, slots=st.slots,
                                   scratch=st.scratch),
          0, 0, st.ext)
  st.built = True
  return x0, cost, vec, st.w, st.blocks


def _linesearch_kernel(rows: Rows, x, p, iterations: int, safeguard: bool,
                       forces: bool = False):
  st = rows._card
  if st is None or not st.built:
    raise ValueError("newton_linesearch: the rows' list is not built (the solve's warm_start "
                     "builds it)")
  B = x.shape[0]
  xo = torch.empty_like(x)
  alpha = torch.empty((B,), dtype=x.dtype, device=x.device)
  improved = torch.empty((B,), dtype=torch.bool, device=x.device)
  vec = torch.empty_like(x)
  force = torch.zeros_like(rows.D) if forces else None
  _launch("newton_linesearch", rows,
          dict(x=x, p=p, xo=xo, alpha=alpha, improved=improved, vec=vec, force=force, w=st.w,
               blocks=st.blocks, lst=st.lst, counts=st.counts, slots=st.slots,
               scratch=st.scratch),
          int(iterations), (FORCES if forces else 0) | (WITH_SAFEGUARD if safeguard else 0),
          st.ext)
  return xo, alpha, improved, (force, vec) if forces else (vec, st.w, st.blocks)


def warm_start(rows: Rows, ws: torch.Tensor):
  """(x0 (B, n), the costs [Φ(ws), Φ(a0)] (B, 2), ∇Φ(x0), w, blocks): the
  solve's start, x0 = ws where its cost is lower than a0's, else a0, with
  newton_gradient(rows, x0)'s output. On the card it lists the solve's
  active rows (see the module's docstring)."""
  if rows.qM.device.type == "cpu":
    return warm_start_plain(rows, ws)
  _check(rows, "warm_start", (ws, tuple(rows.a0.shape)))
  return _warm_start_kernel(rows, ws)


def newton_gradient(rows: Rows, x: torch.Tensor, forces: bool = False):
  """(∇Φ(x) (B, n), the row weights w (B, m), the packed cone Hessians
  (B, nb) or None) at x; with `forces`, (efc_force (B, m), qfrc_constraint
  (B, n)) at x instead. On the card w and the blocks are the solve's buffers
  (see the module's docstring)."""
  if rows.qM.device.type == "cpu":
    return newton_gradient_plain(rows, x, forces)
  _check(rows, "newton_gradient", (x, tuple(rows.a0.shape)))
  return _gradient_kernel(rows, x, forces)


def newton_linesearch(rows: Rows, x: torch.Tensor, p: torch.Tensor, iterations: int,
                      safeguard: bool, forces: bool = False):
  """(x' (B, n), α (B,), improved (B,) bool, at): the exact linesearch along
  p from x, the step's acceptance (see the module's docstring), and `at`,
  newton_gradient(rows, x', forces)'s output at the point it returns. On
  the card the rows' list must be built (the solve's warm_start)."""
  if rows.qM.device.type == "cpu":
    xo, alpha, improved = newton_linesearch_plain(rows, x, p, iterations, safeguard)
    return xo, alpha, improved, newton_gradient_plain(rows, xo, forces)
  if iterations < 0:
    raise ValueError(f"newton_linesearch: iterations {iterations} < 0")
  _check(rows, "newton_linesearch", (x, tuple(rows.a0.shape)), (p, tuple(rows.a0.shape)))
  return _linesearch_kernel(rows, x, p, iterations, safeguard, forces)


def launch_config(name: str, dtype: torch.dtype, n: int, m: int, ncone: int = 0,
                  safeguard: bool = False) -> dict:
  """The launch an entry point makes for these shapes (on the current card),
  launching nothing: resident worlds per SM, SMs, shared bytes per world,
  registers and local (spill) bytes per thread."""
  out = (ctypes.c_int * 5)()
  mode = {"newton_gradient": 0, "newton_linesearch": 2 if safeguard else 1,
          "warm_start": 3}[name]
  rc = _fn("newton_iter_config")(mode, torch.empty((), dtype=dtype).element_size(), n, m, ncone,
                                 1, out)
  if rc != 0:
    raise RuntimeError(f"newton_iter_config failed with CUDA error {rc}")
  return dict(zip(("worlds_per_sm", "sms", "shared_bytes", "registers", "spill_bytes"),
                  list(out)))
