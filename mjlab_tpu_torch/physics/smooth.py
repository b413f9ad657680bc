"""Smooth dynamics: CoM quantities, CRB mass matrix and its factor, RNE bias
forces, passive forces, actuation and the smooth acceleration (port of
mjlab_tpu/physics/smooth.py).

Tree sums are (nbody, nbody) / (nbody, nv) mask products, as in the JAX
package, with the env axis in front. `factor_m` and `solve_m` go through
the Cholesky kernel wrapper (kernels/chol.py).

Spatial vectors are [angular(3); linear(3)] about the per-tree origin (the
root subtree CoM), matching MuJoCo's cdof/cvel conventions.

`body_mass`, `body_inertia`, `body_gravcomp`, `dof_armature`,
`jnt_stiffness`, `dof_damping` and the actuators' `gainprm`/`biasprm` may
carry a leading env axis (domain randomization, sim.PER_ENV_FIELDS).

The actuator moment matrix is static, (nu, nv), unless an actuator pulls
through a spatial tendon: then it is this forward's, (B, nu, nv)
(`transmission`; `moment_mv` and `moment_tmv` take either).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.kernels import chol
from mjlab_tpu_torch.physics import muscle
from mjlab_tpu_torch.physics.types import (
  Data,
  Model,
  Topology,
  float_tensor,
  index_tensor,
  mjtBias,
  mjtDyn,
  mjtGain,
  mjtGeom,
  mjtJoint,
  mjtTrn,
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
  """Per-dof joint-type masks and the mj_comVel "preceding dof" mask. A
  ball's three dofs and a free joint's rotational ones rotate about the
  columns of the body's frame (`axis_col`), a ball's about its joint's
  anchor, a free joint's about the body's origin."""
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
  # Gravity compensation acts on the bodies whose compiled gravcomp is
  # positive (the JAX package's static selection).
  gravcomp = np.nonzero(np.asarray(tp.body_gravcomp_host) > 0)[0]
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
    gravcomp=ix(gravcomp) if len(gravcomp) else None,
    gravcomp_dof=f(tp.body_dof_mask[gravcomp]),
    trn_qmat=f(tp.trn_qmat),
    trn_vmat=f(tp.trn_vmat),
    tendon_qmat=f(tp.tendon_qmat),
    tendon_vmat=f(tp.tendon_vmat),
    ctrllimited=b(tp.actuator_ctrllimited),
    forcelimited=b(tp.actuator_forcelimited),
    affine_bias=b(tp.actuator_biastype == mjtBias.mjBIAS_AFFINE),
    bias_none=(b(tp.actuator_biastype == mjtBias.mjBIAS_NONE)
               if np.any(tp.actuator_biastype == mjtBias.mjBIAS_NONE) else None),
    tendon_actuators=(b(tp.actuator_trntype == mjtTrn.mjTRN_TENDON)
                      if np.any(tp.actuator_trntype == mjtTrn.mjTRN_TENDON) else None),
    dyn_tendon_u=ix(np.nonzero(tp.actuator_dyn_tendon >= 0)[0]),
    dyn_tendon_t=ix(tp.actuator_dyn_tendon[tp.actuator_dyn_tendon >= 0]),
    act=_act_tables(tp, b, ix) if tp.na else None,
    muscle_gain=b(tp.actuator_gaintype == mjtGain.mjGAIN_MUSCLE),
    muscle_bias=b(tp.actuator_biastype == mjtBias.mjBIAS_MUSCLE),
    any_muscle=bool(np.any(tp.actuator_gaintype == mjtGain.mjGAIN_MUSCLE)
                    | np.any(tp.actuator_biastype == mjtBias.mjBIAS_MUSCLE)),
    not_world=b(np.arange(tp.nbody) > 0),
  )


def _act_tables(tp: Topology, b, ix) -> SimpleNamespace:
  """The activation state's tables: per actuator its dynamics' masks and
  its act slot (0 for a stateless one), and the actuator of each act slot
  with its actrange mask."""
  dyn = tp.actuator_dyntype
  stateful = dyn != mjtDyn.mjDYN_NONE
  src = tp.act_actuator
  return SimpleNamespace(
    stateful=b(stateful),
    slot=ix(np.where(stateful, tp.actuator_actadr, 0)),
    integrator=b(dyn == mjtDyn.mjDYN_INTEGRATOR),
    exact=b(dyn == mjtDyn.mjDYN_FILTEREXACT),
    muscle=b(dyn == mjtDyn.mjDYN_MUSCLE),
    any_muscle=bool(np.any(dyn == mjtDyn.mjDYN_MUSCLE)),
    early=b(tp.actuator_actearly),
    actuator=ix(src),
    exact_act=b(dyn[src] == mjtDyn.mjDYN_FILTEREXACT),
    limited_act=b(tp.actuator_actlimited[src]),
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
  """Joint springs, dof dampers, tendon springs (with their deadband) and
  dampers through ten_J, and gravity compensation (mj_gravcomp: the force
  gravcomp·mass·(−g) at each compensated body's com). Fluid forces are
  refused at put_model."""
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
  qfrc_passive = qfrc_spring + qfrc_damper
  if t.gravcomp is not None:
    gc = t.gravcomp
    force = -(per_env(m.body_gravcomp, 1)[:, gc] * per_env(m.body_mass, 1)[:, gc])[
      ..., None] * m.opt.gravity  # (B or 1, G, 3)
    origins = d.subtree_com[:, t.dof_origin_body]  # (B, nv, 3)
    ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
    jac = lin[:, None] + mt.cross(ang[:, None], d.xipos[:, gc, None] - origins[:, None])
    qfrc_passive = qfrc_passive + torch.einsum(
      "bgvj,bgj->bv", jac * t.gravcomp_dof[..., None], force.expand(jac.shape[0], -1, -1))
  if tp.has_fluid:
    qfrc_passive = qfrc_passive + fluid_box(tp, m, d)
  return d.replace(
    qfrc_spring=qfrc_spring,
    qfrc_damper=qfrc_damper,
    qfrc_passive=qfrc_passive,
  )


def _box_sizes(m: Model) -> tuple[torch.Tensor, torch.Tensor]:
  """Each body's equivalent inertia box (B or 1, nbody, 3) and its mass
  floored at 1e-15 (mj_inertiaBoxFluidModel)."""
  mass = torch.clamp_min(per_env(m.body_mass, 1), 1e-15)
  inertia = per_env(m.body_inertia, 2)
  box = torch.stack([
    torch.sqrt(torch.clamp_min(
      inertia[..., (j + 1) % 3] + inertia[..., (j + 2) % 3] - inertia[..., j], 1e-15)
      / mass * 6.0)
    for j in range(3)], dim=-1)
  return box, mass


def _fluid_coefficients(m: Model, box: torch.Tensor):
  """The box model's per-body coefficients: linear (viscous) torque and
  force gains and quadratic (density) torque and force gains, each
  (B or 1, nbody, 3), so that torque = −(lin_t + quad_t |ω|) ω and force =
  −(lin_f + quad_f |v|) v in the inertial frame."""
  diam = torch.mean(box, dim=-1, keepdim=True)
  visc, dens = m.opt.viscosity, m.opt.density
  lin_t = (torch.pi * diam ** 3 * visc).expand_as(box)
  lin_f = (3.0 * torch.pi * diam * visc).expand_as(box)
  area = torch.stack([box[..., 1] * box[..., 2], box[..., 0] * box[..., 2],
                      box[..., 0] * box[..., 1]], dim=-1)
  b4 = box ** 4
  tscale = torch.stack([box[..., 0] * (b4[..., 1] + b4[..., 2]),
                        box[..., 1] * (b4[..., 0] + b4[..., 2]),
                        box[..., 2] * (b4[..., 0] + b4[..., 1])], dim=-1)
  return lin_t, lin_f, dens * tscale / 64.0, 0.5 * dens * area


def _fluid_frame(tp: Topology, m: Model, d: Data):
  """Per body: the inertial frame R (B, nbody, 3, 3), the CoM offset from
  its tree's origin r, the wind-relative 6-D velocity at the CoM in the
  inertial frame (lω, lv), and the mask of bodies the model pushes (not the
  world, mass at least 1e-15)."""
  t = tp.dev.smooth
  r = d.xipos - d.subtree_com[:, t.body_rootid]
  w = d.cvel[..., :3]
  v = d.cvel[..., 3:] + mt.cross(w, r)
  R = d.ximat
  lw = torch.einsum("bnji,bnj->bni", R, w)
  lv = torch.einsum("bnji,bnj->bni", R, v - m.opt.wind)
  alive = (t.not_world & (per_env(m.body_mass, 1) >= 1e-15))[..., None]
  return R, r, lw, lv, alive


def fluid_box(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """The inertia-box fluid model (mj_inertiaBoxFluidModel, the JAX
  package's _fluid_box): per body, a box of the body's inertia gets viscous
  drag linear in, and density drag quadratic in, its CoM velocity
  relative to the wind, in the inertial frame, applied at xipos; (B, nv)."""
  box, _ = _box_sizes(m)
  lin_t, lin_f, quad_t, quad_f = _fluid_coefficients(m, box)
  R, r, lw, lv, alive = _fluid_frame(tp, m, d)
  zero = torch.zeros_like(lw)
  lt = torch.where(alive, -(lin_t + quad_t * torch.abs(lw)) * lw, zero)
  lf = torch.where(alive, -(lin_f + quad_f * torch.abs(lv)) * lv, zero)
  torque = torch.einsum("bnij,bnj->bni", R, lt)
  force = torch.einsum("bnij,bnj->bni", R, lf)
  fs = torch.cat([torque + mt.cross(r, force), force], dim=-1)  # (B, nbody, 6)
  contrib = fs @ d.cdof.transpose(-1, -2)  # (B, nbody, nv)
  return torch.sum(contrib * tp.dev.smooth.body_dof, dim=-2)


def fluid_box_qvel_derivative(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """∂ fluid_box / ∂qvel (B, nv, nv), in closed form. A body's wrench
  depends only on its own 6-D velocity at the CoM, x = T J q̇ with J its
  masked cdof rows and T the map to the inertial frame; the drag is
  diagonal in x with slopes −(lin + 2 quad |x|), so the derivative is
  Σ_b (T J)ᵀ diag(slope) (T J). The JAX package takes it with jax.jacfwd
  through com_vel ∘ _fluid_box (forward.py:79-90)."""
  box, _ = _box_sizes(m)
  lin_t, lin_f, quad_t, quad_f = _fluid_coefficients(m, box)
  R, r, lw, lv, alive = _fluid_frame(tp, m, d)
  slope = -torch.cat([lin_t + 2.0 * quad_t * torch.abs(lw),
                      lin_f + 2.0 * quad_f * torch.abs(lv)], dim=-1)
  slope = torch.where(alive, slope, torch.zeros_like(slope))
  jac = d.cdof[:, None] * tp.dev.smooth.body_dof[..., None]  # (B, nbody, nv, 6)
  ang = jac[..., :3]
  lin = jac[..., 3:] - mt.cross(r[:, :, None], ang)
  Rt = R.transpose(-1, -2)[:, :, None]  # (B, nbody, 1, 3, 3)
  x = torch.cat([(Rt @ ang[..., None])[..., 0], (Rt @ lin[..., None])[..., 0]], dim=-1)
  return torch.einsum("bnvi,bni,bnwi->bvw", x, slope, x)


def _circle_tangent(p: torch.Tensor, r, s: torch.Tensor) -> torch.Tensor:
  """The 2-D tangent point on the origin circle of radius r from the
  outside point p (B, 2), on side s (+1 or −1 of the perpendicular)."""
  sq = torch.clamp_min(torch.sum(p * p, dim=-1), r * r + 1e-15)[..., None]
  perp = torch.stack([-p[..., 1], p[..., 0]], dim=-1)
  return (r * r / sq) * p + s[..., None] * (r * torch.sqrt(sq - r * r) / sq) * perp


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _wrap_circle(p0, p1, r, sidept):
  """The 2-D circle wrap (mju_wrap's core, the JAX package's _wrap_circle)
  of the segment p0 → p1 (B, 2) around the origin circle of radius r:
  (wrapped, arc length, tangent points t0 and t1). `sidept` (B, 2), or
  None, picks the side; else the side the straight segment passes. A
  segment that misses the circle on its own side gives a negative arc and
  stays straight; a sidesite forces the wrap; an intersecting segment
  always wraps, its arcs past π through +2π."""
  dseg = p1 - p0
  tt = torch.clamp(-torch.sum(p0 * dseg, dim=-1)
                   / torch.clamp_min(torch.sum(dseg * dseg, dim=-1), 1e-15), 0.0, 1.0)
  closest = p0 + tt[..., None] * dseg
  r2 = r * r
  intersects = torch.sum(closest * closest, dim=-1) < r2
  toward = closest if sidept is None else sidept
  one = torch.ones_like(tt)
  s = torch.where(_cross2(dseg, toward) >= 0, one, -one)
  t0 = _circle_tangent(p0, r, -s)
  t1 = _circle_tangent(p1, r, s)
  arc_ang = -s * torch.atan2(_cross2(t0, t1), torch.sum(t0 * t1, dim=-1))
  arc_ang = torch.where((arc_ang <= 0) & intersects, arc_ang + 2 * torch.pi, arc_ang)
  outside = (torch.sum(p0 * p0, dim=-1) > r2) & (torch.sum(p1 * p1, dim=-1) > r2)
  return (arc_ang > 0) & outside, r * arc_ang, t0, t1


def _norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


def _unit(x: torch.Tensor) -> torch.Tensor:
  return x / torch.clamp_min(_norm(x), 1e-15)[..., None]


def _proj(direction: torch.Tensor, jac: torch.Tensor) -> torch.Tensor:
  """directionᵀ J: (B, 3), (B, 3, nv) → (B, nv)."""
  return torch.einsum("bi,biv->bv", direction, jac)


def _wrapped_segment(tp, m, d, pa, pb, Ja, Jb, g: int, side: int):
  """A segment pa → pb routed around wrap geom g (a sphere or a cylinder),
  with sidesite `side` or -1: (wrapped, length, Jacobian row)."""
  R, gp = d.geom_xmat[:, g], d.geom_xpos[:, g]
  r = m.geom_size[g, 0]

  def local(p):
    return torch.einsum("bji,bj->bi", R, p - gp)

  la, lb = local(pa), local(pb)
  ls = local(d.site_xpos[:, side]) if side >= 0 else None
  if int(tp.geom_type[g]) == mjtGeom.mjGEOM_CYLINDER:
    # The wrap in the cross-section; z runs linearly along the 2-D path.
    wrapped, arc, t0, t1 = _wrap_circle(la[:, :2], lb[:, :2], r,
                                        ls[:, :2] if ls is not None else None)
    a2 = _norm(t0 - la[:, :2])
    b2 = _norm(lb[:, :2] - t1)
    tot = torch.clamp_min(a2 + arc + b2, 1e-15)
    dz = lb[:, 2] - la[:, 2]
    z0 = la[:, 2] + dz * a2 / tot
    z1 = la[:, 2] + dz * (a2 + arc) / tot
    w0l = torch.cat([t0, z0[:, None]], dim=-1)
    w1l = torch.cat([t1, z1[:, None]], dim=-1)
    wlen = torch.sqrt(arc * arc + (z1 - z0) ** 2)
  else:  # a sphere: the wrap in the plane through both points and the centre
    n = mt.cross(la, lb)
    if ls is not None:  # parallel points: the sidesite's plane
      n = torch.where((_norm(n) < 1e-9)[:, None], mt.cross(la - lb, ls), n)
    e0 = _unit(la)
    e1 = mt.cross(_unit(n), e0)

    def flat(v):
      return torch.stack([torch.sum(v * e0, -1), torch.sum(v * e1, -1)], dim=-1)

    wrapped, arc, t0, t1 = _wrap_circle(flat(la), flat(lb), r,
                                        flat(ls) if ls is not None else None)
    w0l = t0[:, :1] * e0 + t0[:, 1:] * e1
    w1l = t1[:, :1] * e0 + t1[:, 1:] * e1
    wlen = arc
  w0 = gp + torch.einsum("bij,bj->bi", R, w0l)
  w1 = gp + torch.einsum("bij,bj->bi", R, w1l)
  gb = int(tp.geom_bodyid[g])
  length = _norm(w0 - pa) + wlen + _norm(pb - w1)
  row = (_proj(_unit(w0 - pa), point_jac(tp, d, gb, w0) - Ja)
         + _proj(_unit(pb - w1), Jb - point_jac(tp, d, gb, w1)))
  return wrapped, length, row


def _spatial_tendon(tp: Topology, m: Model, d: Data, t: int):
  """A spatial tendon's length (B,) and Jacobian row (B, nv): its segments'
  scaled sum, each straight or wrapped, with the Jacobian from the point
  Jacobians along each piece's direction (a wrap's tangent points are
  material points of the geom's body: the taut path's envelope makes that
  exact to first order)."""
  length, row = 0.0, 0.0
  for k in range(tp.tendon_seg_sites.shape[1]):
    sa, sb = (int(x) for x in tp.tendon_seg_sites[t, k])
    if sa < 0:
      continue
    pa, pb = d.site_xpos[:, sa], d.site_xpos[:, sb]
    Ja = point_jac(tp, d, int(tp.site_bodyid[sa]), pa)
    Jb = point_jac(tp, d, int(tp.site_bodyid[sb]), pb)
    seg_len = _norm(pb - pa)
    seg_row = _proj(_unit(pb - pa), Jb - Ja)
    g = int(tp.tendon_seg_geom[t, k])
    if g >= 0:
      wrapped, w_len, w_row = _wrapped_segment(
        tp, m, d, pa, pb, Ja, Jb, g, int(tp.tendon_seg_side[t, k]))
      seg_len = torch.where(wrapped, w_len, seg_len)
      seg_row = torch.where(wrapped[:, None], w_row, seg_row)
    scale = float(tp.tendon_seg_scale[t, k])
    length = length + scale * seg_len
    row = row + scale * seg_row
  return length, row


def tendon(tp: Topology, m: Model, d: Data) -> Data:
  """Tendon lengths, Jacobians and velocities (mj_tendon): fixed tendons
  ride their static joint-coefficient maps, spatial tendons sum their
  segments (`_spatial_tendon`), batched over the worlds."""
  if tp.ntendon == 0:
    return d
  t = tp.dev.smooth
  B = d.qpos.shape[0]
  length = d.qpos @ t.tendon_qmat.T
  J = t.tendon_vmat.expand(B, tp.ntendon, tp.nv)
  spatial = np.nonzero(tp.tendon_kind == 1)[0]
  if len(spatial):
    J = J.clone()
    for k in spatial:
      length[:, k], J[:, k] = _spatial_tendon(tp, m, d, int(k))
    velocity = (J @ d.qvel[..., None])[..., 0]
  else:
    velocity = d.qvel @ t.tendon_vmat.T
  return d.replace(ten_length=length, ten_J=J, ten_velocity=velocity)


def transmission(tp: Topology, m: Model, d: Data) -> tuple[torch.Tensor, torch.Tensor]:
  """actuator_length (B, nu) and the moment matrix: joint and
  fixed-tendon transmissions share a static (nu, nv) form
  (io._transmission_matrices), so a tendon actuator's length is gear ·
  ten_length and its moment gear · ten_J; an actuator on a spatial tendon
  reads this forward's ten_length and ten_J, and the moment is then
  (B, nu, nv)."""
  t = tp.dev.smooth
  gear0 = m.actuator_gear[:, 0]
  length = gear0 * (d.qpos @ t.trn_qmat.T)
  moment = gear0[:, None] * t.trn_vmat
  if len(t.dyn_tendon_u):
    u, k = t.dyn_tendon_u, t.dyn_tendon_t
    length = length.index_copy(1, u, gear0[u] * d.ten_length[:, k])
    moment = moment.expand(d.qpos.shape[0], -1, -1).index_copy(
      1, u, gear0[u, None] * d.ten_J[:, k])
  return length, moment


def moment_mv(moment: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """moment · v per world, (B, nv) → (B, nu), for either moment shape."""
  return v @ moment.T if moment.dim() == 2 else (moment @ v[..., None])[..., 0]


def moment_tmv(moment: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """momentᵀ f per world, (B, nu) → (B, nv), for either moment shape."""
  return f @ moment if moment.dim() == 2 else (f[:, None] @ moment)[:, 0]


def _activation(tp: Topology, m: Model, d: Data, ctrl: torch.Tensor):
  """The actuators' force input and act_dot (mj_fwdActuation): a stateful
  actuator (integrator, filter, filterexact, muscle) drives its gain by its
  activation, or with actearly by the next one (mj_nextActivation, not
  clamped, as in the JAX package), and emits act_dot."""
  a = tp.dev.smooth.act
  act_u = d.act[:, a.slot]
  dynprm = m.actuator_dynprm
  tau = torch.clamp_min(dynprm[..., 0], 1e-15)
  act_dot_u = torch.where(a.integrator, ctrl, (ctrl - act_u) / tau)
  if a.any_muscle:
    act_dot_u = torch.where(
      a.muscle, muscle.muscle_dynamics(ctrl, act_u, dynprm[..., :3]), act_dot_u)
  act_dot_u = torch.where(a.stateful, act_dot_u, torch.zeros_like(act_dot_u))
  h = m.opt.timestep
  nxt = torch.where(a.exact, act_u + act_dot_u * tau * -torch.expm1(-h / tau),
                    act_u + h * act_dot_u)
  act_in = torch.where(a.early, nxt, act_u)
  return torch.where(a.stateful, act_in, ctrl), act_dot_u[:, a.actuator]


def fwd_actuation(tp: Topology, m: Model, d: Data) -> Data:
  """Actuator forces: gain · input + bias, with fixed or muscle gain and
  none (0, as in MuJoCo; the JAX package takes biasprm's affine form for
  it), affine or muscle bias; the input is ctrl, or the activation of a
  stateful actuator."""
  t = tp.dev.smooth
  if tp.nu == 0:
    return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))
  length, moment = transmission(tp, m, d)
  velocity = moment_mv(moment, d.qvel)
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  ctrl = torch.where(t.ctrllimited, torch.clamp(d.ctrl, lo, hi), d.ctrl)
  inp, act_dot = _activation(tp, m, d, ctrl) if tp.na else (ctrl, d.act_dot)
  # (nu, 10), or (B, nu, 10) randomized per env.
  gain = m.actuator_gainprm[..., 0]
  bias = (
    m.actuator_biasprm[..., 0]
    + m.actuator_biasprm[..., 1] * length
    + m.actuator_biasprm[..., 2] * velocity
  )
  if t.bias_none is not None:  # MuJoCo's none is 0 whatever biasprm holds (ROADMAP Queue C)
    bias = torch.where(t.bias_none, torch.zeros_like(bias), bias)
  if t.any_muscle:
    lr, acc0 = m.actuator_lengthrange, m.actuator_acc0
    gain = torch.where(t.muscle_gain, muscle.muscle_gain(
      length, velocity, lr, acc0, m.actuator_gainprm[..., :9]), gain)
    bias = torch.where(t.muscle_bias, muscle.muscle_bias(
      length, lr, acc0, m.actuator_biasprm[..., :9]), bias)
  force = gain * inp + bias
  flo, fhi = m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]
  force = torch.where(t.forcelimited, torch.clamp(force, flo, fhi), force)
  return d.replace(
    actuator_length=length,
    actuator_velocity=velocity,
    actuator_force=force,
    act_dot=act_dot,
    qfrc_actuator=moment_tmv(moment, force),
  )


def actuator_force_vel(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """∂ actuator_force / ∂ actuator_velocity, (B or 1, nu), as MuJoCo's
  mjd_actuator_vel takes it: the affine bias's biasprm[2], and a muscle
  gain's force-velocity slope times its input; a muscle's or a
  biastype-none actuator's biasprm[2] adds nothing. Reads this forward's
  actuator_length and actuator_velocity."""
  t = tp.dev.smooth
  b2 = per_env(m.actuator_biasprm, 2)[..., 2]
  dfdv = torch.where(t.affine_bias, b2, torch.zeros_like(b2))
  if t.any_muscle:
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    ctrl = torch.where(t.ctrllimited, torch.clamp(d.ctrl, lo, hi), d.ctrl)
    inp = _activation(tp, m, d, ctrl)[0] if tp.na else ctrl
    gain_vel = muscle.muscle_gain_vel(d.actuator_length, d.actuator_velocity,
                                      m.actuator_lengthrange, m.actuator_acc0,
                                      m.actuator_gainprm[..., :9])
    dfdv = dfdv + torch.where(t.muscle_gain, gain_vel * inp, torch.zeros_like(gain_vel))
  return dfdv


def fwd_acceleration(tp: Topology, m: Model, d: Data) -> Data:
  qfrc_smooth = (
    d.qfrc_passive
    - d.qfrc_bias
    + d.qfrc_actuator
    + d.qfrc_applied
    + xfrc_projection(tp, m, d)
  )
  return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=solve_m(d, qfrc_smooth))
