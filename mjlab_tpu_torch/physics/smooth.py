"""Smooth dynamics: CoM quantities, CRB mass matrix and its factor, RNE bias
forces, passive forces, actuation and the smooth acceleration (port of
mjlab_tpu/physics/smooth.py).

Tree sums are (nbody, nbody) / (nbody, nv) mask products, as in the JAX
package, with the env axis in front. `factor_m` and `solve_m` go through
the Cholesky kernel wrapper (kernels/chol.py).

Spatial vectors are [angular(3); linear(3)] about the per-tree origin (the
root subtree CoM), matching MuJoCo's cdof/cvel conventions.

`body_mass`, `body_inertia`, `dof_armature`, `jnt_stiffness`,
`dof_damping` and the actuators' `gainprm`/`biasprm` may carry a leading
env axis (domain randomization, sim.PER_ENV_FIELDS).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.kernels import chol
from mjlab_tpu_torch.physics.types import (
  Data,
  Model,
  Topology,
  float_tensor,
  index_tensor,
  mjtJoint,
  per_env,
)

_FREE = mjtJoint.mjJNT_FREE
_HINGE = mjtJoint.mjJNT_HINGE
_SLIDE = mjtJoint.mjJNT_SLIDE


# ---------------------------------------------------------------------------
# Spatial algebra. cinert packing: [Ixx, Iyy, Izz, Ixy, Ixz, Iyz, hx, hy, hz,
# m] — inertia about the tree origin, h = m * (com - origin).
# ---------------------------------------------------------------------------


def inert_mul(ci: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """Spatial inertia × motion vector → force vector [torque; force]."""
  ixx, iyy, izz, ixy, ixz, iyz = ci[..., :6].unbind(-1)
  h, mass = ci[..., 6:9], ci[..., 9]
  w, v = u[..., :3], u[..., 3:]
  wx, wy, wz = w.unbind(-1)
  iw = torch.stack(
    [
      ixx * wx + ixy * wy + ixz * wz,
      ixy * wx + iyy * wy + iyz * wz,
      ixz * wx + iyz * wy + izz * wz,
    ],
    dim=-1,
  )
  ang = iw + mt.cross(h, v)
  lin = mass[..., None] * v - mt.cross(h, w)
  return torch.cat([ang, lin], dim=-1)


def cross_motion(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of motion vectors, [ang; lin]."""
  wu, vu = u[..., :3], u[..., 3:]
  wv, vv = v[..., :3], v[..., 3:]
  return torch.cat(
    [mt.cross(wu, wv), mt.cross(wu, vv) + mt.cross(vu, wv)], dim=-1
  )


def cross_force(u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Motion-vector cross force-vector: u ×* f."""
  w, v = u[..., :3], u[..., 3:]
  t, fl = f[..., :3], f[..., 3:]
  return torch.cat([mt.cross(w, t) + mt.cross(v, fl), mt.cross(w, fl)], dim=-1)


# ---------------------------------------------------------------------------
# Static tables (host → device once, at put_model).
# ---------------------------------------------------------------------------


def _dof_tables(tp: Topology) -> dict[str, np.ndarray]:
  """Per-dof joint-type masks and the mj_comVel "preceding dof" mask."""
  nv = tp.nv
  dof_jnt = tp.dof_jntid
  jnt_type = tp.jnt_type[dof_jnt]
  dof_in_jnt = np.arange(nv) - tp.jnt_dofadr[dof_jnt]
  is_free_trans = (jnt_type == _FREE) & (dof_in_jnt < 3)
  is_free_rot = (jnt_type == _FREE) & (dof_in_jnt >= 3)
  prec = np.zeros((nv, nv), dtype=bool)
  for j in range(nv):
    for k in range(nv):
      if tp.dof_bodyid[j] != tp.dof_bodyid[k]:
        continue
      if dof_jnt[k] < dof_jnt[j]:
        prec[j, k] = True
      elif dof_jnt[k] == dof_jnt[j] and is_free_rot[j] and is_free_trans[k]:
        prec[j, k] = True
  direct = np.zeros((tp.nbody, nv), dtype=bool)
  direct[tp.dof_bodyid, np.arange(nv)] = True
  return {
    "is_free_trans": is_free_trans,
    "is_free_rot": is_free_rot,
    "is_hinge": jnt_type == _HINGE,
    "is_slide": jnt_type == _SLIDE,
    "axis_col": np.where(is_free_rot, dof_in_jnt - 3, dof_in_jnt),
    "prec_mask": prec,
    "direct_mask": direct,
  }


def device_tables(tp: Topology, dtype, device) -> SimpleNamespace:
  """Tables of the smooth stages; the sensors read them too."""
  t = _dof_tables(tp)

  def f(x):
    return float_tensor(x, dtype, device)

  def ix(x):
    return index_tensor(x, device)

  def b(x):
    return torch.as_tensor(np.asarray(x, dtype=bool), device=device)

  spring = np.nonzero(np.isin(tp.jnt_type, [_HINGE, _SLIDE]))[0]
  return SimpleNamespace(
    subtree=f(tp.body_subtree_mask),
    body_dof=f(tp.body_dof_mask),
    ancestor=f(tp.dof_ancestor_mask),
    tree_sparsity=f(tp.dof_ancestor_mask | tp.dof_ancestor_mask.T),
    direct=f(t["direct_mask"]),
    prec=f(t["prec_mask"]),
    is_free_trans=b(t["is_free_trans"])[:, None],
    is_free_rot=b(t["is_free_rot"])[:, None],
    is_hinge=b(t["is_hinge"])[:, None],
    is_slide=b(t["is_slide"])[:, None],
    axis_col=ix(t["axis_col"]),
    trans_axis=f(np.eye(3)[t["axis_col"] % 3]),
    body_rootid=ix(tp.body_rootid),
    dof_bodyid=ix(tp.dof_bodyid),
    dof_jntid=ix(tp.dof_jntid),
    dof_parent_body=ix(tp.body_parentid[tp.dof_bodyid]),
    dof_origin_body=ix(tp.body_rootid[tp.dof_bodyid]),
    levels=[(ix(ids), ix(tp.body_parentid[ids])) for ids in tp.body_levels],
    spring_jnt=ix(spring),
    spring_q=ix(tp.jnt_qposadr[spring]),
    spring_v=ix(tp.jnt_dofadr[spring]),
    trn_qmat=f(tp.trn_qmat),
    trn_vmat=f(tp.trn_vmat),
    tendon_qmat=f(tp.tendon_qmat),
    tendon_vmat=f(tp.tendon_vmat),
    ctrllimited=b(tp.actuator_ctrllimited),
    forcelimited=b(tp.actuator_forcelimited),
  )


# ---------------------------------------------------------------------------
# CoM-based quantities.
# ---------------------------------------------------------------------------


def com_pos(tp: Topology, m: Model, d: Data) -> Data:
  """subtree_com, cinert, cdof (mj_comPos)."""
  t = tp.dev.smooth
  mass = per_env(m.body_mass, 1)  # (B or 1, nbody)
  wsum = t.subtree @ (mass[..., None] * d.xipos)
  msum = mass @ t.subtree.T
  subtree_com = wsum / torch.clamp_min(msum, 1e-12)[..., None]
  origin = subtree_com[:, t.body_rootid]  # (B, nbody, 3)

  R = d.ximat
  i_world = (R * per_env(m.body_inertia, 2)[..., None, :]) @ R.transpose(-1, -2)
  r = d.xipos - origin
  rr = r[..., :, None] * r[..., None, :]
  r2 = torch.sum(r * r, dim=-1)[..., None, None]
  eye = torch.eye(3, dtype=r.dtype, device=r.device)
  i_o = i_world + mass[..., None, None] * (r2 * eye - rr)
  h = mass[..., None] * r
  cinert = torch.cat(
    [
      i_o[..., 0, 0:1], i_o[..., 1, 1:2], i_o[..., 2, 2:3],
      i_o[..., 0, 1:2], i_o[..., 0, 2:3], i_o[..., 1, 2:3],
      h, mass[..., None].expand(h.shape[:-1] + (1,)),
    ],
    dim=-1,
  )

  # cdof, vectorized over all dofs.
  o = origin[:, t.dof_bodyid]  # (B, nv, 3)
  anchor = d.xanchor[:, t.dof_jntid]
  jaxis = d.xaxis[:, t.dof_jntid]
  col = d.xmat[:, t.dof_bodyid, :, t.axis_col]  # (nv, B, 3): column per dof
  col = col.transpose(0, 1)
  zeros3 = torch.zeros_like(jaxis)
  rot_axis = torch.where(t.is_hinge, jaxis, col)
  rot_anchor = torch.where(t.is_free_rot, d.xpos[:, t.dof_bodyid], anchor)
  ang = torch.where(t.is_free_trans | t.is_slide, zeros3, rot_axis)
  lin_rot = mt.cross(rot_axis, o - rot_anchor)
  lin = torch.where(
    t.is_free_trans, t.trans_axis, torch.where(t.is_slide, jaxis, lin_rot)
  )
  cdof = torch.cat([ang, lin], dim=-1)
  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(tp: Topology, m: Model, d: Data) -> Data:
  """cvel, cdof_dot (mj_comVel) via mask products."""
  t = tp.dev.smooth
  contrib = d.cdof * d.qvel[..., None]  # (B, nv, 6)
  cvel = t.body_dof @ contrib  # (B, nbody, 6)
  pv = cvel[:, t.dof_parent_body] + t.prec @ contrib
  cdof_dot = cross_motion(pv, d.cdof)
  cdof_dot = torch.where(t.is_free_trans, torch.zeros_like(cdof_dot), cdof_dot)
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)


def point_jac(tp: Topology, d: Data, body: int, p: torch.Tensor) -> torch.Tensor:
  """(B, 3, nv) translational Jacobian of the world point p (B, 3) fixed
  on `body` (the JAX package's constraint._point_jac)."""
  t = tp.dev.smooth
  origins = d.subtree_com[:, t.dof_origin_body]  # (B, nv, 3)
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  jac = lin + mt.cross(ang, p[:, None] - origins)
  return (jac * t.body_dof[body][:, None]).transpose(-1, -2)


def body_bias(tp: Topology, d: Data, body: int) -> torch.Tensor:
  """(B, 6) [ang, lin] Σ_i q̇_i ċdof_i over `body`'s ancestor dofs: the
  velocity-product (bias) spatial acceleration of the body (constraint.
  _body_bias)."""
  mask = tp.dev.smooth.body_dof[body]
  return torch.sum(d.cdof_dot * (d.qvel * mask)[..., None], dim=-2)


def point_jdot_qdot(tp: Topology, d: Data, body: int, p: torch.Tensor) -> torch.Tensor:
  """(B, 3) J̇q̇ of the translational Jacobian of p on `body`, from cvel and
  cdof_dot (constraint._point_jdot_qdot)."""
  off = p - d.subtree_com[:, int(tp.body_rootid[body])]
  w = d.cvel[:, body, :3]
  v_p = d.cvel[:, body, 3:] + mt.cross(w, off)
  bias = body_bias(tp, d, body)
  return bias[:, 3:] + mt.cross(bias[:, :3], off) + mt.cross(w, v_p)


# ---------------------------------------------------------------------------
# Mass matrix (CRB) and its factor.
# ---------------------------------------------------------------------------


def crb(tp: Topology, m: Model, d: Data) -> Data:
  """Dense joint-space mass matrix via composite rigid bodies."""
  t = tp.dev.smooth
  crb_inert = t.subtree @ d.cinert  # (B, nbody, 10)
  f = inert_mul(crb_inert[:, t.dof_bodyid], d.cdof)  # (B, nv, 6)
  lower = (f @ d.cdof.transpose(-1, -2)) * t.ancestor
  diag = torch.diagonal(lower, dim1=-2, dim2=-1)
  qm = lower + lower.transpose(-1, -2) - torch.diag_embed(diag)
  qm = qm + torch.diag_embed(per_env(m.dof_armature, 1))
  return d.replace(qM=qm)


def factor_m(tp: Topology, m: Model, d: Data) -> Data:
  """qLD = cholesky(qM) (smooth.py:232-233) through the kernel wrapper."""
  return d.replace(qLD=chol.chol_factor(d.qM))


def solve_m(d: Data, rhs: torch.Tensor) -> torch.Tensor:
  """M⁻¹ rhs with the cached factor (smooth.py:236-239)."""
  return chol.chol_solve(d.qLD, rhs)


# ---------------------------------------------------------------------------
# Bias forces (RNE with zero acceleration).
# ---------------------------------------------------------------------------


def rne(tp: Topology, m: Model, d: Data) -> Data:
  """qfrc_bias = C(qpos, qvel): level-by-level RNE with qacc = 0."""
  t = tp.dev.smooth
  grav = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
  contrib = t.direct @ (d.cdof_dot * d.qvel[..., None])  # (B, nbody, 6)
  cacc = grav.expand(contrib.shape).clone()
  for ids, pid in t.levels:
    cacc[:, ids] = cacc[:, pid] + contrib[:, ids]
  cfrc = inert_mul(d.cinert, cacc) + cross_force(d.cvel, inert_mul(d.cinert, d.cvel))
  cfrc_total = t.subtree @ cfrc
  qfrc_bias = torch.sum(d.cdof * cfrc_total[:, t.dof_bodyid], dim=-1)
  return d.replace(qfrc_bias=qfrc_bias)


def xfrc_projection(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """Project per-body world wrenches (xfrc_applied) into joint space."""
  t = tp.dev.smooth
  origin = d.subtree_com[:, t.body_rootid]
  force, torque = d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:]
  t_o = torque + mt.cross(d.xipos - origin, force)
  fs = torch.cat([t_o, force], dim=-1)  # (B, nbody, 6)
  contrib = fs @ d.cdof.transpose(-1, -2)  # (B, nbody, nv)
  return torch.sum(contrib * t.body_dof, dim=-2)


# ---------------------------------------------------------------------------
# Passive forces and actuation.
# ---------------------------------------------------------------------------


def _Jt_mul(J: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Jᵀ x, batched: (B, n, nv), (B, n) → (B, nv)."""
  return (J.transpose(-1, -2) @ x[..., None])[..., 0]


def passive(tp: Topology, m: Model, d: Data) -> Data:
  """Joint springs, dof dampers, and tendon springs (with their deadband)
  and dampers through ten_J (no gravcomp or fluid: refused at put_model)."""
  t = tp.dev.smooth
  qfrc_spring = torch.zeros_like(d.qvel)
  frc = -per_env(m.jnt_stiffness, 1)[:, t.spring_jnt] * (
    d.qpos[:, t.spring_q] - m.qpos_spring[t.spring_q]
  )
  qfrc_spring[:, t.spring_v] = frc
  qfrc_damper = -m.dof_damping * d.qvel
  if tp.ntendon:
    L = d.ten_length
    lo, up = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
    disp = torch.where(L > up, up - L, torch.where(L < lo, lo - L, torch.zeros_like(L)))
    qfrc_spring = qfrc_spring + _Jt_mul(d.ten_J, m.tendon_stiffness * disp)
    qfrc_damper = qfrc_damper - _Jt_mul(d.ten_J, m.tendon_damping * d.ten_velocity)
  return d.replace(
    qfrc_spring=qfrc_spring,
    qfrc_damper=qfrc_damper,
    qfrc_passive=qfrc_spring + qfrc_damper,
  )


def tendon(tp: Topology, m: Model, d: Data) -> Data:
  """Tendon lengths, Jacobians and velocities (mj_tendon) of fixed tendons:
  the static joint-coefficient maps (spatial tendons are refused)."""
  if tp.ntendon == 0:
    return d
  t = tp.dev.smooth
  B = d.qpos.shape[0]
  return d.replace(
    ten_length=d.qpos @ t.tendon_qmat.T,
    ten_J=t.tendon_vmat.expand(B, tp.ntendon, tp.nv),
    ten_velocity=d.qvel @ t.tendon_vmat.T,
  )


def transmission(tp: Topology, m: Model, d: Data) -> tuple[torch.Tensor, torch.Tensor]:
  """actuator_length (B, nu) and the static (nu, nv) moment matrix: joint
  and fixed-tendon transmissions share its form (io._transmission_matrices),
  so a tendon actuator's length is gear · ten_length and its moment gear ·
  ten_J."""
  t = tp.dev.smooth
  gear0 = m.actuator_gear[:, 0]
  length = gear0 * (d.qpos @ t.trn_qmat.T)
  moment = gear0[:, None] * t.trn_vmat
  return length, moment


def fwd_actuation(tp: Topology, m: Model, d: Data) -> Data:
  """Actuator forces: fixed gain + affine bias (PD position actuators)."""
  t = tp.dev.smooth
  if tp.nu == 0:
    return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))
  length, moment = transmission(tp, m, d)
  velocity = d.qvel @ moment.T
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  ctrl = torch.where(t.ctrllimited, torch.clamp(d.ctrl, lo, hi), d.ctrl)
  # (nu, 10), or (B, nu, 10) randomized per env.
  gain = m.actuator_gainprm[..., 0]
  bias = (
    m.actuator_biasprm[..., 0]
    + m.actuator_biasprm[..., 1] * length
    + m.actuator_biasprm[..., 2] * velocity
  )
  force = gain * ctrl + bias
  flo, fhi = m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]
  force = torch.where(t.forcelimited, torch.clamp(force, flo, fhi), force)
  return d.replace(
    actuator_length=length,
    actuator_velocity=velocity,
    actuator_force=force,
    qfrc_actuator=force @ moment,
  )


def fwd_acceleration(tp: Topology, m: Model, d: Data) -> Data:
  qfrc_smooth = (
    d.qfrc_passive
    - d.qfrc_bias
    + d.qfrc_actuator
    + d.qfrc_applied
    + xfrc_projection(tp, m, d)
  )
  return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=solve_m(d, qfrc_smooth))
