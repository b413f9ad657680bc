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
  velocity derivative momentᵀ diag(−∂force/∂v) moment (MuJoCo's
  mjd_actuator_vel: the affine bias's b2 and a muscle gain's
  force-velocity slope, `smooth.actuator_force_vel`; a joint actuator's on
  the dof diagonal, a tendon actuator's masked to M's tree sparsity;
  the JAX package adds every actuator's −biasprm[2], on the diagonal only,
  ROADMAP Queue C), the tendon dampers' JᵀcJ and the fluid drag's velocity
  derivative, both masked to M's tree sparsity (mjd_passive_vel)."""
  h = m.opt.timestep
  t = tp.dev.smooth
  diag = h * m.dof_damping
  implicitfast = m.opt.integrator == Integrator.IMPLICITFAST
  full = None
  if implicitfast and tp.nu > 0:
    _, moment = smooth.transmission(tp, m, d)
    dfdv = -smooth.actuator_force_vel(tp, m, d)  # (1, nu) or, per env, (B, nu)
    zero = torch.zeros_like(dfdv)
    if t.tendon_actuators is not None:  # a tendon's row spans dofs: momentᵀ diag moment
      full = (moment.mT * torch.where(t.tendon_actuators, dfdv, zero)[..., None, :]) @ moment
      dfdv = torch.where(t.tendon_actuators, zero, dfdv)
    diag = diag + h * torch.sum(dfdv[..., None] * moment * moment, dim=-2)
  mat = d.qM + torch.diag_embed(diag)
  if full is not None:
    mat = mat + h * t.tree_sparsity * full
  if implicitfast and tp.ntendon > 0:
    JtcJ = (d.ten_J.transpose(-1, -2) * m.tendon_damping) @ d.ten_J
    mat = mat + h * t.tree_sparsity * JtcJ
  if implicitfast and tp.has_fluid:
    mat = mat - h * t.tree_sparsity * smooth.fluid_box_qvel_derivative(tp, m, d)
  return mat


def _clamp_act(tp: Topology, m: Model, act: torch.Tensor) -> torch.Tensor:
  """Each act slot's value clamped to its actuator's actrange where
  actlimited."""
  a = tp.dev.smooth.act
  rng = m.actuator_actrange[a.actuator]
  return torch.where(a.limited_act, torch.clamp(act, rng[:, 0], rng[:, 1]), act)


def _advance_act(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """mj_advance's activation update: explicit Euler for integrator, filter
  and muscle, the exact exponential for filterexact, then the actrange
  clamp."""
  a = tp.dev.smooth.act
  h = m.opt.timestep
  tau = torch.clamp_min(m.actuator_dynprm[a.actuator, 0], 1e-15)
  # act_dot = (ctrl − act)/τ, so act + act_dot·τ·(1 − e^{−h/τ}) solves the
  # first-order filter exactly over one step.
  act = torch.where(a.exact_act, d.act + d.act_dot * tau * -torch.expm1(-h / tau),
                    d.act + h * d.act_dot)
  return _clamp_act(tp, m, act)


def integrate(tp: Topology, m: Model, d: Data) -> Data:
  """Implicitfast velocity update, then positions (mj_implicit), and the
  activations."""
  h = m.opt.timestep
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  qacc_int = chol.chol_factor_solve(_implicit_matrix(tp, m, d), qfrc)
  qvel = d.qvel + h * qacc_int
  qpos = kinematics.integrate_pos(tp, m, d.qpos, qvel, h)
  act = _advance_act(tp, m, d) if tp.na else d.act
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def _rk4(tp: Topology, m: Model, d: Data) -> Data:
  """Classic 4th-order Runge-Kutta over (qpos, qvel, act), mj_RungeKutta:
  stage states from the Butcher tableau, one full forward per stage,
  positions integrated from the initial qpos; qacc is used directly (no
  implicit damping); the activations are clamped to their actrange at the
  end, as in the JAX package."""
  h = m.opt.timestep
  A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
  Bw = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
  qpos0, qvel0, act0 = d.qpos, d.qvel, d.act
  F = [(d.qvel, d.qacc, d.act_dot)]
  for i in range(3):
    def stage(k):
      return sum(A[i][j] * F[j][k] for j in range(i + 1) if A[i][j])

    d = d.replace(qpos=kinematics.integrate_pos(tp, m, qpos0, stage(0), h),
                  qvel=qvel0 + h * stage(1))
    if tp.na:
      d = d.replace(act=act0 + h * stage(2))
    d = forward(tp, m, d)
    F.append((d.qvel, d.qacc, d.act_dot))

  def total(k):
    return sum(Bw[j] * F[j][k] for j in range(4))

  act = _clamp_act(tp, m, act0 + h * total(2)) if tp.na else act0
  return d.replace(qpos=kinematics.integrate_pos(tp, m, qpos0, total(0), h),
                   qvel=qvel0 + h * total(1), act=act, time=d.time + h)


def step(tp: Topology, m: Model, d: Data) -> Data:
  d = forward(tp, m, d)
  if m.opt.integrator == Integrator.RK4:
    return _rk4(tp, m, d)
  return integrate(tp, m, d)
