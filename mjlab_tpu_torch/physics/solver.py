"""Constraint solver: Newton's method on MuJoCo's primal soft-constraint
problem (port of mjlab_tpu/physics/solver.py, Newton + pyramidal path).

Minimizes over qacc x, per env:
  Φ(x) = 0.5 (x − a0)ᵀ M (x − a0) + Σ_i 0.5 D_i r_i² [r_i < 0],  r = J x − aref
with a0 = qacc_smooth. Every row of this slice (joint limits, pyramidal
contact facets) is one-sided quadratic. A fixed number of iterations runs in
lockstep over the batch; the JAX package's `fori_loop`s are Python loops
here. Each iteration takes its direction from `chol.newton_direction`,
which solves with H = M + Jᵀ diag(w) J + 1e-10·I without forming H in
device memory; a non-positive pivot gives a NaN step that the cost
comparison rejects, as in the JAX package.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.kernels import chol
from mjlab_tpu_torch.physics.types import Data, Model, Topology


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


def solve(tp: Topology, m: Model, d: Data) -> Data:
  """Compute qacc, efc_force, qfrc_constraint."""
  a0 = d.qacc_smooth
  if tp.nefc == 0:
    return d.replace(
      qacc=a0, qfrc_constraint=torch.zeros_like(a0), qacc_warmstart=a0
    )
  x = _warm_start(d, a0)
  for _ in range(m.opt.iterations):
    x = _newton_iter(m, d, a0, x)
  efc_force, qfrc_constraint = _forces(d, x)
  return d.replace(
    qacc=x, efc_force=efc_force, qfrc_constraint=qfrc_constraint,
    qacc_warmstart=x,
  )
