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
package's `fori_loop`s are Python loops here.

Where each stage runs (the kernels' wrappers take their plain PyTorch
versions on a CPU tensor):
  * the warm start's choice between qacc_warmstart and a0 by cost, and the
    gradient, the row weights and the cone blocks at the point it picks:
    `newton.warm_start`, one launch that also lists the solve's active rows
    on the card;
  * per Newton iteration, the direction: `chol.newton_direction` (diagonal
    weights) or, with cone slots, `chol.newton_direction_cone`, which solve
    with H = M + Jᵀ diag(w) J (+ Σ J_sᵀ B_s J_s) + 1e-10·I without forming H
    in device memory; then the exact linesearch and the step's acceptance
    (with cone slots, the safeguard's candidates), ending with the next
    iteration's gradient, weights and blocks at the accepted point:
    `newton.newton_linesearch`. A non-positive pivot gives a NaN step that
    the cost comparison rejects, as in the JAX package;
  * CG: M + 1e-12·I factored once (`chol.chol_factor`), per iteration the
    linesearch and acceptance with the gradient at the accepted point
    (`newton.newton_linesearch`) and its preconditioning
    (`chol.chol_solve`); β in PyTorch;
  * efc_force and qfrc_constraint at the solution: the last iteration's
    `newton.newton_linesearch(..., forces=True)` (with no iteration,
    `newton.newton_gradient(..., forces=True)` at the warm start's point, on
    its list).
A Newton or CG solve of K ≥ 1 iterations launches 1 warm_start and K
newton_linesearch (on the CPU the solve may stop early at an exact fixed
point, with one newton_gradient for the forces).

The PGS solver (mjSOL_PGS, pyramidal cone) works on the dual instead
(`_pgs`, the JAX package's pgs_solve): one `pgs.pgs_solve` per forward, from
f = 0, its sweeps over A = J M⁻¹ Jᵀ taken without forming A on the card.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.kernels import chol, newton, pgs
from mjlab_tpu_torch.physics.types import Data, Model, Topology, mjtSolver

_EPS = 1e-15


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def newton_weights(d: Data, x: torch.Tensor) -> torch.Tensor:
  """The pyramidal row weights w of the Newton matrix at x, (B, nefc)."""
  r = (d.efc_J @ x[..., None])[..., 0] - d.efc_aref
  return torch.where(r < 0, d.efc_D, torch.zeros_like(r))


def hessian(d: Data, x: torch.Tensor) -> torch.Tensor:
  """The Newton step's regularized matrix M + Jᵀ diag(w) J + 1e-10·I at x,
  formed as the plain version does (the main path never forms it)."""
  return chol.newton_matrix(d.qM, d.efc_J, newton_weights(d, x))


def direction(rows: newton.Rows, grad: torch.Tensor, w: torch.Tensor, blocks) -> torch.Tensor:
  """The Newton step −H⁻¹∇Φ."""
  if rows.layout is not None:
    return -chol.newton_direction_cone(rows.qM, rows.J, w, grad, blocks, rows.layout)
  return -chol.newton_direction(rows.qM, rows.J, w, grad)


def _forces(rows: newton.Rows, x: torch.Tensor):
  """(x, efc_force, qfrc_constraint) at x."""
  return (x, *newton.newton_gradient(rows, x, forces=True))


def newton_solve(m: Model, rows: newton.Rows, x: torch.Tensor, at):
  """`m.opt.iterations` Newton iterations from x, `at` the gradient, the
  row weights and the cone blocks there (the warm start's): (x, efc_force,
  qfrc_constraint) at the end."""
  iterations = m.opt.iterations
  if iterations == 0:
    return _forces(rows, x)
  grad, w, blocks = at
  for k in range(iterations):
    last = k == iterations - 1
    x_new, _, _, at = newton.newton_linesearch(rows, x, direction(rows, grad, w, blocks),
                                               m.opt.ls_iterations, rows.layout is not None,
                                               forces=last)
    if last:
      return (x_new, *at)
    # An iteration is a function of x alone: once it returns x in every
    # world, so does every later one. On the CPU the loop stops there.
    if x.device.type == "cpu" and newton.same_bits(x_new, x):
      return _forces(rows, x)
    x = x_new
    grad, w, blocks = at


def cg_solve(m: Model, rows: newton.Rows, x: torch.Tensor, at):
  """Nonlinear CG (Polak-Ribière+, M-preconditioned), MuJoCo's mjSOL_CG:
  M + 1e-12·I factored once, its solves per iteration, from x with `at` the
  warm start's gradient there. Returns (x, efc_force, qfrc_constraint) at
  the end."""
  iterations = m.opt.iterations
  if iterations == 0:
    return _forces(rows, x)
  qM = rows.qM
  Lm = chol.chol_factor(qM + 1e-12 * torch.eye(qM.shape[-1], dtype=qM.dtype, device=qM.device))
  g_prev = at[0]
  mg_prev = chol.chol_solve(Lm, g_prev)
  p = -mg_prev
  for k in range(iterations):
    last = k == iterations - 1
    state = (x, g_prev, mg_prev, p)
    x, _, improve, at = newton.newton_linesearch(rows, x, p, m.opt.ls_iterations, False,
                                                 forces=last)
    if last:
      return (x, *at)
    g = at[0]
    mg = chol.chol_solve(Lm, g)
    beta = torch.clamp_min(
      _bdot(g, mg - mg_prev) / torch.clamp_min(_bdot(g_prev, mg_prev), _EPS), 0.0)
    p = -mg + torch.where(improve, beta, torch.zeros_like(beta))[:, None] * p
    g_prev, mg_prev = g, mg
    # An iteration is a function of (x, g, M⁻¹g, p) alone: once it returns
    # them in every world, so does every later one. On the CPU the loop
    # stops there.
    if x.device.type == "cpu" and all(map(newton.same_bits, state, (x, g, mg, p))):
      return _forces(rows, x)


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
  """Compute qacc, efc_force, qfrc_constraint (inside the profiler span
  "solver.solve")."""
  with torch.profiler.record_function("solver.solve"):
    return _solve(tp, m, d)


def _solve(tp: Topology, m: Model, d: Data) -> Data:
  a0 = d.qacc_smooth
  if tp.nefc == 0:
    return d.replace(
      qacc=a0, qfrc_constraint=torch.zeros_like(a0), qacc_warmstart=a0
    )
  if m.opt.solver == mjtSolver.mjSOL_PGS:
    return _pgs(tp, m, d)
  rows = newton.Rows.of(tp, d)
  x, _, *at = newton.warm_start(rows, d.qacc_warmstart.contiguous())
  solve_fn = cg_solve if m.opt.solver == mjtSolver.mjSOL_CG else newton_solve
  x, efc_force, qfrc_constraint = solve_fn(m, rows, x, at)
  return d.replace(
    qacc=x, efc_force=efc_force, qfrc_constraint=qfrc_constraint,
    qacc_warmstart=x,
  )
