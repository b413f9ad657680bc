"""Forward dynamics pipeline and the integrators: implicitfast, Euler (with
implicit dof damping) and RK4 (port of mjlab_tpu/physics/forward.py).

`forward` keeps mj_forward's stage order; `step` = forward + integrate, or
RK4's three more forwards. Each function takes and returns a batched Data
(env axis first).
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.kernels import chol
from mjlab_tpu_torch.physics import collision as coll
from mjlab_tpu_torch.physics import constraint, kinematics, sensors, smooth, solver
from mjlab_tpu_torch.physics.types import Data, Integrator, Model, Topology


def fwd_position(tp: Topology, m: Model, d: Data) -> Data:
  d = kinematics.kinematics(tp, m, d)
  d = smooth.com_pos(tp, m, d)
  d = smooth.tendon(tp, m, d)
  d = smooth.crb(tp, m, d)
  d = smooth.factor_m(tp, m, d)
  d = coll.collision(tp, m, d)
  d = smooth.com_vel(tp, m, d)
  d = constraint.make_constraint(tp, m, d)
  return sensors.sensor_pos(tp, m, d)


def fwd_velocity(tp: Topology, m: Model, d: Data) -> Data:
  d = smooth.rne(tp, m, d)
  d = smooth.passive(tp, m, d)
  d = sensors.sensor_vel(tp, m, d)
  return d


def forward(tp: Topology, m: Model, d: Data) -> Data:
  d = fwd_position(tp, m, d)
  d = fwd_velocity(tp, m, d)
  d = smooth.fwd_actuation(tp, m, d)
  d = smooth.fwd_acceleration(tp, m, d)
  d = solver.solve(tp, m, d)
  d = sensors.sensor_acc(tp, m, d)
  return d


def _implicit_matrix(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """M − h·∂f/∂v: dof damping plus, under implicitfast, the actuators'
  affine velocity gain (−b2 = kd for PD actuators) on the dof diagonal, and
  the tendon dampers' JᵀcJ masked to M's tree sparsity (mjd_passive_vel)."""
  h = m.opt.timestep
  diag = h * m.dof_damping
  implicitfast = m.opt.integrator == Integrator.IMPLICITFAST
  if implicitfast and tp.nu > 0:
    _, moment = smooth.transmission(tp, m, d)
    dfdv = -m.actuator_biasprm[..., 2]  # (nu,) or, per env, (B, nu)
    diag = diag + h * torch.sum(dfdv[..., None] * moment * moment, dim=-2)
  mat = d.qM + torch.diag_embed(diag)
  if implicitfast and tp.ntendon > 0:
    JtcJ = (d.ten_J.transpose(-1, -2) * m.tendon_damping) @ d.ten_J
    mat = mat + h * tp.dev.smooth.tree_sparsity * JtcJ
  return mat


def integrate(tp: Topology, m: Model, d: Data) -> Data:
  """Implicitfast velocity update, then positions (mj_implicit)."""
  h = m.opt.timestep
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  qacc_int = chol.chol_factor_solve(_implicit_matrix(tp, m, d), qfrc)
  qvel = d.qvel + h * qacc_int
  qpos = kinematics.integrate_pos(tp, m, d.qpos, qvel, h)
  return d.replace(qpos=qpos, qvel=qvel, time=d.time + h)


def _rk4(tp: Topology, m: Model, d: Data) -> Data:
  """Classic 4th-order Runge-Kutta over (qpos, qvel), mj_RungeKutta: stage
  states from the Butcher tableau, one full forward per stage, positions
  integrated from the initial qpos; qacc is used directly (no implicit
  damping). Activation dynamics are refused at put_model (na = 0)."""
  h = m.opt.timestep
  A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
  Bw = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
  qpos0, qvel0 = d.qpos, d.qvel
  F = [(d.qvel, d.qacc)]
  for i in range(3):
    dvel = sum(A[i][j] * F[j][0] for j in range(i + 1) if A[i][j])
    dacc = sum(A[i][j] * F[j][1] for j in range(i + 1) if A[i][j])
    d = forward(tp, m, d.replace(
      qpos=kinematics.integrate_pos(tp, m, qpos0, dvel, h), qvel=qvel0 + h * dacc))
    F.append((d.qvel, d.qacc))
  dvel = sum(Bw[j] * F[j][0] for j in range(4))
  dacc = sum(Bw[j] * F[j][1] for j in range(4))
  return d.replace(qpos=kinematics.integrate_pos(tp, m, qpos0, dvel, h),
                   qvel=qvel0 + h * dacc, time=d.time + h)


def step(tp: Topology, m: Model, d: Data) -> Data:
  d = forward(tp, m, d)
  if m.opt.integrator == Integrator.RK4:
    return _rk4(tp, m, d)
  return integrate(tp, m, d)
