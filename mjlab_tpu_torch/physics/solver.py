"""Constraint solver: Newton's method, or nonlinear CG, on MuJoCo's primal
soft-constraint problem (port of mjlab_tpu/physics/solver.py).

Minimizes over qacc x, per env:
  Φ(x) = 0.5 (x − a0)ᵀ M (x − a0) + Σ_i cost_i(J_i x − aref_i)
with a0 = qacc_smooth and per-row costs, as in the JAX package:
  * one-sided quadratic 0.5 D r² iff r < 0 (limits, pyramidal facets,
    condim-1 contacts);
  * bilateral quadratic (equality rows);
  * Huber (dof friction-loss rows): quadratic inside |D r| ≤ fl, linear
    outside;
  * the elliptic cone (condim ≥ 3 contacts under cone="elliptic"): the
    squared distance to the negated friction cone in the D-whitened metric,
    in three zones (top: no force; middle: projection onto the cone; bottom:
    full quadratic), with a (cd × cd) Hessian block per slot.
A fixed number of iterations runs in lockstep over the batch; the JAX
package's `fori_loop`s are Python loops here. A Newton iteration takes its
direction from `chol.newton_direction` (diagonal weights) or, with cone
slots, `chol.newton_direction_cone` (and the cone blocks), which solve with
H = M + Jᵀ diag(w) J (+ Σ J_sᵀ B_s J_s) + 1e-10·I without forming H in
device memory; a non-positive pivot gives a NaN step that the cost
comparison rejects, as in the JAX package. CG preconditions with M's factor
(`chol.chol_factor` once per solve, `chol.chol_solve` per iteration).

A model whose rows are all one-sided quadratics (neither equality nor
friction-loss rows, no cone slots) takes the original pyramidal path below
(`_newton_iter`), whose launches are unchanged; every other model takes the
general cost (`GeneralCost`).

The PGS solver (mjSOL_PGS, pyramidal cone) works on the dual instead
(`_pgs`, the JAX package's pgs_solve): one `pgs.pgs_solve` per forward, from
f = 0, its sweeps over A = J M⁻¹ Jᵀ taken without forming A on the card.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from mjlab_tpu_torch.kernels import chol, pgs
from mjlab_tpu_torch.physics.types import Data, Model, Topology, mjtSolver

_EPS = 1e-15


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Batched matrix-vector product (B, n, m) @ (B, m) → (B, n)."""
  return (M @ x[..., None])[..., 0]


def _row_force(D: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
  """−∂cost/∂r per row: −D r on the active (r < 0) side, else 0."""
  return torch.where(r < 0, -D * r, torch.zeros_like(r))


def _row_hess(D: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
  return torch.where(r < 0, D, torch.zeros_like(r))


def _cost(d: Data, dx: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
  quad = torch.where(r < 0, 0.5 * d.efc_D * r * r, torch.zeros_like(r))
  return 0.5 * _bdot(dx, _mv(d.qM, dx)) + torch.sum(quad, dim=-1)


def total_cost(d: Data, a0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Φ(x) per env, (B,)."""
  return _cost(d, x - a0, _mv(d.efc_J, x) - d.efc_aref)


def newton_weights(d: Data, x: torch.Tensor) -> torch.Tensor:
  """The row weights w of the Newton matrix at x, (B, nefc)."""
  return _row_hess(d.efc_D, _mv(d.efc_J, x) - d.efc_aref)


def hessian(d: Data, x: torch.Tensor) -> torch.Tensor:
  """The Newton step's regularized matrix M + Jᵀ diag(w) J + 1e-10·I at x,
  formed as the plain version does (the main path never forms it)."""
  return chol.newton_matrix(d.qM, d.efc_J, newton_weights(d, x))


def _gradient(d: Data, a0: torch.Tensor, x: torch.Tensor):
  """Residual r = J x − aref and ∇Φ(x)."""
  r = _mv(d.efc_J, x) - d.efc_aref
  grad = _mv(d.qM, x - a0) - _mv(d.efc_J.transpose(-1, -2), _row_force(d.efc_D, r))
  return r, grad


def _direction(d: Data, r: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
  return -chol.newton_direction(d.qM, d.efc_J, _row_hess(d.efc_D, r), grad)


def _linesearch(m: Model, d: Data, a0: torch.Tensor, x: torch.Tensor,
                r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
  """Exact linesearch along p (1-D Newton on φ'(α)), then the step if it
  lowers the cost."""
  J, D, M = d.efc_J, d.efc_D, d.qM
  jv = _mv(J, p)
  p_m_dx = _bdot(p, _mv(M, x - a0))
  p_m_p = _bdot(p, _mv(M, p))
  alpha = torch.ones_like(p_m_p)
  for _ in range(m.opt.ls_iterations):
    ra = r + alpha[:, None] * jv
    dphi = p_m_dx + alpha * p_m_p - _bdot(_row_force(D, ra), jv)
    ddphi = p_m_p + _bdot(_row_hess(D, ra), jv * jv)
    alpha = alpha - dphi / torch.clamp_min(ddphi, 1e-30)
  # Reject non-improving steps (keeps lockstep envs safe post-convergence).
  x_new = x + alpha[:, None] * p
  better = total_cost(d, a0, x_new) < _cost(d, x - a0, r)
  return torch.where(better[:, None], x_new, x)


def _newton_iter(m: Model, d: Data, a0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  r, grad = _gradient(d, a0, x)
  return _linesearch(m, d, a0, x, r, _direction(d, r, grad))


def _warm_start(d: Data, a0: torch.Tensor) -> torch.Tensor:
  """MuJoCo's choice between the warm start and a0, by cost."""
  ws = d.qacc_warmstart
  use_ws = total_cost(d, a0, ws) < total_cost(d, a0, a0)
  return torch.where(use_ws[:, None], ws, a0)


def _forces(d: Data, x: torch.Tensor):
  """efc_force and qfrc_constraint at x."""
  efc_force = _row_force(d.efc_D, _mv(d.efc_J, x) - d.efc_aref)
  return efc_force, _mv(d.efc_J.transpose(-1, -2), efc_force)


class GeneralCost:
  """The general cost on one solve's rows: row-class masks, the cone
  groups and their per-solve whitening (solver.py:67-164)."""

  def __init__(self, tp: Topology, m: Model, d: Data):
    t = tp.dev.con
    self.m, self.d, self.t = m, d, t
    self.J, self.D, self.aref, self.fl = d.efc_J, d.efc_D, d.efc_aref, d.efc_frictionloss
    self.a0 = d.qacc_smooth
    self.groups = []
    for g in t.cone_groups:
      rows = g.rows
      mu0 = d.contact.friction[:, g.slots, 0]
      Dn = self.D[:, rows[:, 0]]
      Df = self.D[:, rows[:, 1:]]
      safe_Dn = torch.clamp_min(Dn, _EPS)
      mu = mu0 * torch.sqrt(safe_Dn / torch.clamp_min(Df[..., 0], _EPS))
      self.groups.append(SimpleNamespace(
        rows=rows, flat_rows=g.flat_rows, Dn=Dn, Df=Df, active=Dn > 0,
        s=torch.sqrt(torch.clamp_min(Df, _EPS) / safe_Dn[..., None]), mu=mu,
        one_mu2=1.0 + mu * mu,
      ))
    self.layout = t.cone_kernel_layout

  def residual(self, x):
    return _mv(self.J, x) - self.aref

  # -- per-row costs (regular rows) --

  def _masked(self, fric, eq, other):
    """Pick each row's value by its class."""
    t = self.t
    out = other
    if t.is_eq is not None:
      out = torch.where(t.is_eq > 0, eq, out)
    if t.is_fric is not None:
      out = torch.where(t.is_fric > 0, fric, out)
    if t.reg is not None:
      out = out * t.reg
    return out

  def row_cost(self, r):
    quad = 0.5 * self.D * r * r
    huber = None
    if self.t.is_fric is not None:
      lin = self.fl / torch.clamp_min(self.D, 1e-30)
      huber = torch.where(torch.abs(r) > lin, self.fl * torch.abs(r) - 0.5 * self.fl * lin, quad)
    return self._masked(huber, quad, torch.where(r < 0, quad, torch.zeros_like(r)))

  def row_hess(self, r):
    huber = None
    if self.t.is_fric is not None:
      lin = self.fl / torch.clamp_min(self.D, 1e-30)
      huber = torch.where(torch.abs(r) <= lin, self.D, torch.zeros_like(r))
    return self._masked(huber, self.D, torch.where(r < 0, self.D, torch.zeros_like(r)))

  def regular_force(self, r):
    """−∂cost/∂r per row, 0 on the cone rows."""
    quad = -self.D * r
    huber = torch.clamp(quad, -self.fl, self.fl) if self.t.is_fric is not None else None
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

  # -- the cost, the linesearch, the iterations --

  def total_cost(self, x):
    dx = x - self.a0
    r = self.residual(x)
    c = 0.5 * _bdot(dx, _mv(self.d.qM, dx)) + torch.sum(self.row_cost(r), dim=-1)
    return c + self.cone_cost(r) if self.groups else c

  def grad(self, x, r):
    return _mv(self.d.qM, x - self.a0) - _mv(self.J.transpose(-1, -2), self.row_force(r))

  def linesearch(self, x, r, p):
    """Exact 1-D Newton linesearch along p from x (shared by Newton and CG)."""
    jv = _mv(self.J, p)
    p_m_dx = _bdot(p, _mv(self.d.qM, x - self.a0))
    p_m_p = _bdot(p, _mv(self.d.qM, p))
    cones = [self.cone_line(g, r[:, g.rows], jv[:, g.rows]) for g in self.groups]
    alpha = torch.ones_like(p_m_p)
    for _ in range(self.m.opt.ls_iterations):
      ra = r + alpha[:, None] * jv
      dphi = p_m_dx + alpha * p_m_p - _bdot(self.regular_force(ra), jv)
      ddphi = p_m_p + _bdot(self.row_hess(ra), jv * jv)
      for line in cones:
        slope, curv = line(alpha)
        dphi = dphi - torch.sum(slope, dim=-1)
        ddphi = ddphi + torch.sum(curv, dim=-1)
      alpha = alpha - dphi / torch.clamp_min(ddphi, 1e-30)
    return alpha

  def direction(self, r, grad):
    w = self.row_hess(r)
    if self.groups:
      return -chol.newton_direction_cone(
        self.d.qM, self.J, w, grad, self.cone_blocks(r), self.layout)
    return -chol.newton_direction(self.d.qM, self.J, w, grad)

  def newton_iter(self, x):
    r = self.residual(x)
    p = self.direction(r, self.grad(x, r))
    alpha = self.linesearch(x, r, p)
    if self.groups:
      # Safeguard (elliptic only): the 1-D Newton can diverge on the cone
      # landscape; keep the best improving step of a small candidate set.
      best_cost, best_alpha = self.total_cost(x), torch.zeros_like(alpha)
      for cand in (alpha, 1.0, 0.5, 0.25, 0.1, 0.01):
        ca = cand if torch.is_tensor(cand) else torch.full_like(alpha, cand)
        c = self.total_cost(x + ca[:, None] * p)
        better = c < best_cost
        best_cost = torch.where(better, c, best_cost)
        best_alpha = torch.where(better, ca, best_alpha)
      return x + best_alpha[:, None] * p
    x_new = x + alpha[:, None] * p
    return torch.where((self.total_cost(x_new) < self.total_cost(x))[:, None], x_new, x)

  def cg_solve(self, x0):
    """Nonlinear CG (Polak-Ribière+, M-preconditioned), MuJoCo's mjSOL_CG:
    M + 1e-12·I factored once, its solves per iteration."""
    qM = self.d.qM
    Lm = chol.chol_factor(qM + 1e-12 * torch.eye(qM.shape[-1], dtype=qM.dtype, device=qM.device))
    g_prev = self.grad(x0, self.residual(x0))
    mg_prev = chol.chol_solve(Lm, g_prev)
    x, p = x0, -mg_prev
    for _ in range(self.m.opt.iterations):
      r = self.residual(x)
      alpha = self.linesearch(x, r, p)
      x_new = x + alpha[:, None] * p
      improve = self.total_cost(x_new) < self.total_cost(x)
      x = torch.where(improve[:, None], x_new, x)
      g = self.grad(x, self.residual(x))
      mg = chol.chol_solve(Lm, g)
      beta = torch.clamp_min(
        _bdot(g, mg - mg_prev) / torch.clamp_min(_bdot(g_prev, mg_prev), _EPS), 0.0)
      p = -mg + torch.where(improve, beta, torch.zeros_like(beta))[:, None] * p
      g_prev, mg_prev = g, mg
    return x

  def solve(self) -> Data:
    d = self.d
    ws = d.qacc_warmstart
    x = torch.where((self.total_cost(ws) < self.total_cost(self.a0))[:, None], ws, self.a0)
    if self.m.opt.solver == mjtSolver.mjSOL_CG:
      x = self.cg_solve(x)
    else:
      for _ in range(self.m.opt.iterations):
        x = self.newton_iter(x)
    efc_force = self.row_force(self.residual(x))
    return d.replace(
      qacc=x, efc_force=efc_force,
      qfrc_constraint=_mv(self.J.transpose(-1, -2), efc_force), qacc_warmstart=x,
    )


def general(tp: Topology, m: Model) -> bool:
  """Whether the model needs the general cost: equality or friction-loss
  rows, cone slots, or the CG solver."""
  t = tp.dev.con
  return bool(t.ne or t.nf or t.cone_groups or m.opt.solver == mjtSolver.mjSOL_CG)


def pgs_inputs(tp: Topology, d: Data):
  """The dual problem's rows (solver.py:339-350): (D, lo, hi), each row's
  box by the classes of _row_masks: equality rows unbounded, friction-loss
  rows [−fl, fl], the rest [0, ∞), inactive rows (D = 0) [0, 0]; b = J a0 −
  aref is formed by pgs.pgs_solve."""
  t = tp.dev.con
  D, fl = d.efc_D.contiguous(), d.efc_frictionloss
  zero = torch.zeros_like(D)
  inf = torch.full_like(D, float("inf"))
  lo, hi = zero, inf
  if t.is_fric is not None:
    lo = torch.where(t.is_fric > 0, -fl, lo)
    hi = torch.where(t.is_fric > 0, fl, hi)
  if t.is_eq is not None:
    lo = torch.where(t.is_eq > 0, -inf, lo)
    hi = torch.where(t.is_eq > 0, inf, hi)
  active = D > 0
  lo = torch.where(active, lo, zero)
  hi = torch.where(active, hi, zero)
  return D, lo, hi


def _pgs(tp: Topology, m: Model, d: Data) -> Data:
  """Projected Gauss-Seidel on the dual (solver.py:327-372), from f = 0:
  qacc = a0 + M⁻¹Jᵀf and qfrc_constraint = Jᵀf, its factor the forward's
  qLD."""
  D, lo, hi = pgs_inputs(tp, d)
  f, u, qfrc = pgs.pgs_solve(d.qLD, d.efc_J.contiguous(), d.qacc_smooth.contiguous(),
                             d.efc_aref.contiguous(), D, lo, hi, m.opt.iterations)
  x = d.qacc_smooth + u
  return d.replace(qacc=x, efc_force=f, qfrc_constraint=qfrc, qacc_warmstart=x)


def solve(tp: Topology, m: Model, d: Data) -> Data:
  """Compute qacc, efc_force, qfrc_constraint."""
  a0 = d.qacc_smooth
  if tp.nefc == 0:
    return d.replace(
      qacc=a0, qfrc_constraint=torch.zeros_like(a0), qacc_warmstart=a0
    )
  if m.opt.solver == mjtSolver.mjSOL_PGS:
    return _pgs(tp, m, d)
  if general(tp, m):
    return GeneralCost(tp, m, d).solve()
  x = _warm_start(d, a0)
  for _ in range(m.opt.iterations):
    x = _newton_iter(m, d, a0, x)
  efc_force, qfrc_constraint = _forces(d, x)
  return d.replace(
    qacc=x, efc_force=efc_force, qfrc_constraint=qfrc_constraint,
    qacc_warmstart=x,
  )
