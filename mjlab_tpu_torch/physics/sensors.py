"""Builtin sensors (port of mjlab_tpu/physics/sensors.py): the JAX package's
whole catalog. IMU (gyro, velocimeter, accelerometer, magnetometer), frame
position, orientation, axes, velocities and accelerations, joint, tendon and
actuator state, the joint-limit rows, subtree com and momenta, the
energies, the clock, and the interaction sensors: force and torque (the
cfrc_int backward pass over the post-constraint accelerations), touch
(contact normal forces inside the site's zone), rangefinder (analytic ray
casts against every primitive geom) and tendon actuator force.

Two sensors differ from the JAX package's, each giving MuJoCo's value where
the JAX package does not (ROADMAP Queue C): a frame sensor with a reference
frame (`sensor_refid` >= 0) is expressed in that frame, where the JAX
package reads no reference frame; and actuatorpos and actuatorvel read this
forward's transmission (mj_transmission precedes the sensors in MuJoCo),
where the JAX package reads the previous forward's actuator_length and
actuator_velocity. io.put_model refuses any other sensor type. The tree tables come from smooth's (`tp.dev.smooth`).
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.physics import constraint, smooth
from mjlab_tpu_torch.physics.types import (
  Data,
  Model,
  Topology,
  mjtGeom,
  mjtObj,
  mjtSensor,
  mjtTrn,
  per_env,
)

_S = mjtSensor
_OBJ = mjtObj
_G = mjtGeom

_POS_STAGE = {
  _S.mjSENS_FRAMEPOS, _S.mjSENS_FRAMEQUAT, _S.mjSENS_FRAMEXAXIS,
  _S.mjSENS_FRAMEYAXIS, _S.mjSENS_FRAMEZAXIS, _S.mjSENS_JOINTPOS,
  _S.mjSENS_SUBTREECOM, _S.mjSENS_ACTUATORPOS, _S.mjSENS_MAGNETOMETER,
  _S.mjSENS_CLOCK, _S.mjSENS_TENDONPOS, _S.mjSENS_JOINTLIMITPOS,
  _S.mjSENS_E_POTENTIAL, _S.mjSENS_RANGEFINDER,
}
_VEL_STAGE = {
  _S.mjSENS_GYRO, _S.mjSENS_VELOCIMETER, _S.mjSENS_FRAMELINVEL,
  _S.mjSENS_FRAMEANGVEL, _S.mjSENS_JOINTVEL, _S.mjSENS_SUBTREELINVEL,
  _S.mjSENS_SUBTREEANGMOM, _S.mjSENS_ACTUATORVEL, _S.mjSENS_TENDONVEL,
  _S.mjSENS_JOINTLIMITVEL, _S.mjSENS_E_KINETIC,
}
_ACC_STAGE = {
  _S.mjSENS_ACCELEROMETER, _S.mjSENS_ACTUATORFRC, _S.mjSENS_FRAMELINACC,
  _S.mjSENS_FRAMEANGACC, _S.mjSENS_JOINTLIMITFRC, _S.mjSENS_JOINTACTFRC,
  _S.mjSENS_FORCE, _S.mjSENS_TORQUE, _S.mjSENS_TOUCH,
  _S.mjSENS_TENDONACTFRC,
}
_AXIS_COL = {_S.mjSENS_FRAMEXAXIS: 0, _S.mjSENS_FRAMEYAXIS: 1, _S.mjSENS_FRAMEZAXIS: 2}
_LIMIT = (_S.mjSENS_JOINTLIMITPOS, _S.mjSENS_JOINTLIMITVEL, _S.mjSENS_JOINTLIMITFRC)
_RAY_MISS = 1e10


def _mT_v(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """matᵀ @ v, batched."""
  return (mat.transpose(-1, -2) @ v[..., None])[..., 0]


def _limit_row(tp: Topology, joint_id: int) -> int | None:
  """efc row of a joint's limit: the limit block follows the equality and
  dof-friction rows, hinge and slide limits first, then the balls'."""
  base = tp.neq_rows + len(tp.friction_dof_ids)
  pos = np.nonzero(tp.limited_joint_ids == joint_id)[0]
  if len(pos):
    return base + int(pos[0])
  pos = np.nonzero(tp.limited_ball_joint_ids == joint_id)[0]
  if len(pos):
    return base + len(tp.limited_joint_ids) + int(pos[0])
  return None


def _obj_frame(tp: Topology, d: Data, objtype: int, objid: int):
  if objtype == _OBJ.mjOBJ_SITE:
    return d.site_xpos[:, objid], d.site_xmat[:, objid], int(tp.site_bodyid[objid])
  if objtype == _OBJ.mjOBJ_BODY:
    return d.xipos[:, objid], d.ximat[:, objid], objid
  if objtype == _OBJ.mjOBJ_XBODY:
    return d.xpos[:, objid], d.xmat[:, objid], objid
  if objtype == _OBJ.mjOBJ_GEOM:
    return d.geom_xpos[:, objid], d.geom_xmat[:, objid], int(tp.geom_bodyid[objid])
  raise NotImplementedError(f"sensor objtype {objtype}")


def _obj_quat(tp: Topology, m: Model, d: Data, objtype: int, objid: int) -> torch.Tensor:
  """An object's orientation as MuJoCo composes it for frame sensors: its
  body's xquat times the element's local quaternion."""
  if objtype == _OBJ.mjOBJ_XBODY:
    return d.xquat[:, objid]
  if objtype == _OBJ.mjOBJ_BODY:
    body, local = objid, m.body_iquat
  elif objtype == _OBJ.mjOBJ_GEOM:
    body, local = int(tp.geom_bodyid[objid]), m.geom_quat
  else:
    body, local = int(tp.site_bodyid[objid]), m.site_quat
  q = d.xquat[:, body]
  return mt.quat_mul(q, per_env(local, 2)[:, objid].expand(q.shape))


def _point_vel(tp: Topology, d: Data, body: int, point: torch.Tensor) -> torch.Tensor:
  """World-frame linear velocity of a point attached to `body`."""
  origin = d.subtree_com[:, int(tp.body_rootid[body])]
  return d.cvel[:, body, 3:] + mt.cross(d.cvel[:, body, :3], point - origin)


def _subtree_dynamics(tp: Topology, m: Model, d: Data) -> Data:
  """subtree_linvel and subtree_angmom (mj_subtreeVel)."""
  t = tp.dev.smooth
  mass = per_env(m.body_mass, 1)  # (B or 1, nbody)
  origin = d.subtree_com[:, t.body_rootid]
  w = d.cvel[..., :3]
  v_com = d.cvel[..., 3:] + mt.cross(w, d.xipos - origin)
  iw = (d.ximat * per_env(m.body_inertia, 2)[..., None, :]) @ d.ximat.transpose(-1, -2)
  L_own = (iw @ w[..., None])[..., 0]
  P = mass[..., None] * v_com

  sub = t.subtree
  msum = torch.clamp_min(mass @ sub.T, 1e-12)
  com_sub = (sub @ (mass[..., None] * d.xipos)) / msum[..., None]
  linvel = (sub @ P) / msum[..., None]
  # Angular momentum about the subtree com: Σ L_i + (c_i − C) × P_i.
  rel = d.xipos[:, None, :, :] - com_sub[:, :, None, :]  # (B, nsub, nbody, 3)
  angmom = sub[:, :, None] * (L_own[:, None] + mt.cross(rel, P[:, None]))
  return d.replace(subtree_linvel=linvel, subtree_angmom=angmom.sum(dim=2))


def _rne_postconstraint_cacc(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """Body spatial accelerations including qacc (accelerometers)."""
  t = tp.dev.smooth
  grav = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
  contrib = t.direct @ (d.cdof_dot * d.qvel[..., None] + d.cdof * d.qacc[..., None])
  cacc = grav.expand(contrib.shape).clone()
  for ids, pid in t.levels:
    cacc[:, ids] = cacc[:, pid] + contrib[:, ids]
  return cacc


def _point_acc(tp: Topology, d: Data, cacc: torch.Tensor, body: int, pos: torch.Tensor):
  """World-frame linear acceleration of a point attached to `body`."""
  origin = d.subtree_com[:, int(tp.body_rootid[body])]
  return (cacc[:, body, 3:] + mt.cross(cacc[:, body, :3], pos - origin)
          + mt.cross(d.cvel[:, body, :3], _point_vel(tp, d, body, pos)))


def _cfrc_int(tp: Topology, m: Model, d: Data, cacc: torch.Tensor) -> torch.Tensor:
  """(B, nbody, 6) interaction wrench [torque, force] each body exerts
  through its parent joint, about its tree's com-based origin, world axes
  (mj_rnePostConstraint's cfrc_int, which force and torque sensors read):
  each subtree's momentum rate less its applied and contact wrenches."""
  t = tp.dev.smooth
  roots = d.subtree_com[:, t.body_rootid]  # (B, nbody, 3)
  f_app, t_app = d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:]
  cfrc_ext = torch.cat([t_app + mt.cross(d.xipos - roots, f_app), f_app], dim=-1)
  con = tp.dev.con
  if con.ncon:
    cf = constraint.contact_forces(tp, m, d)  # (B, C, 6) in the contact frame
    active = (d.contact.dist < d.contact.includemargin).to(cf.dtype)[..., None]
    # contact.frame's rows are its axes in world coordinates.
    f_w = torch.einsum("bck,bcki->bci", cf[..., :3], d.contact.frame) * active
    t_w = torch.einsum("bck,bcki->bci", cf[..., 3:], d.contact.frame) * active
    # The wrench acts on body2 along +normal; body1 gets its negation.
    for sign, bodies in ((1.0, con.b2), (-1.0, con.b1)):
      t_at = t_w + mt.cross(d.contact.pos - roots[:, bodies], f_w)
      cfrc_ext = cfrc_ext.index_add(1, bodies, sign * torch.cat([t_at, f_w], dim=-1))
  Iv = smooth.inert_mul(d.cinert, d.cvel)
  cfrc_com = smooth.inert_mul(d.cinert, cacc) + smooth.cross_force(d.cvel, Iv)
  return t.subtree @ (cfrc_com - cfrc_ext)


def _inside_site(tp: Topology, site_id: int, local: torch.Tensor) -> torch.Tensor:
  """Whether points `local` (..., 3) in the site's frame lie inside its
  volume (the touch sensor's zone; mju_insideGeom for the site types)."""
  stype = int(tp.site_type[site_id])
  size = [float(v) for v in tp.site_size[site_id]]
  x, y, z = local.unbind(-1)
  if stype == _G.mjGEOM_SPHERE:
    return torch.sum(local * local, -1) <= size[0] ** 2
  if stype == _G.mjGEOM_ELLIPSOID:
    s = local / local.new_tensor(np.maximum(size, 1e-12))
    return torch.sum(s * s, -1) <= 1.0
  if stype == _G.mjGEOM_CAPSULE:
    zc = torch.clamp(z, -size[1], size[1])
    return x * x + y * y + (z - zc) ** 2 <= size[0] ** 2
  if stype == _G.mjGEOM_CYLINDER:
    return (x * x + y * y <= size[0] ** 2) & (torch.abs(z) <= size[1])
  if stype == _G.mjGEOM_BOX:
    return torch.all(torch.abs(local) <= local.new_tensor(size), dim=-1)
  raise NotImplementedError(f"touch-sensor site type {stype}")


def _ray_quadratic(a, b, c):
  """Smallest non-negative root of a t² + 2b t + c = 0, else a miss."""
  det = b * b - a * c
  sq = torch.sqrt(torch.clamp_min(det, 0.0))
  t0 = (-b - sq) / a
  t1 = (-b + sq) / a
  miss = torch.full_like(t0, _RAY_MISS)
  t = torch.where(t0 >= 0, t0, torch.where(t1 >= 0, t1, miss))
  return torch.where(det >= 0, t, miss)


def _dot(a, b):
  return torch.sum(a * b, dim=-1)


def _ray_geom(gtype: int, size: torch.Tensor, gpos, gmat, o, v) -> torch.Tensor | None:
  """Ray (o, v) against one geom → distance along v, _RAY_MISS where it
  misses; None for a height field or a mesh (no analytic cast, skipped as
  the JAX package skips them). Batched over the leading axis."""
  lo = _mT_v(gmat, o - gpos)
  lv = _mT_v(gmat, v)
  miss = torch.full_like(lo[..., 0], _RAY_MISS)
  if gtype == _G.mjGEOM_PLANE:
    denom = lv[..., 2]
    t = torch.where(torch.abs(denom) > 1e-12, -lo[..., 2] / denom, miss)
    x = lo + t[..., None] * lv
    ok = (t >= 0) & (denom < 0)
    ok = ok & ((size[..., 0] <= 0) | (torch.abs(x[..., 0]) <= size[..., 0]))
    ok = ok & ((size[..., 1] <= 0) | (torch.abs(x[..., 1]) <= size[..., 1]))
    return torch.where(ok, t, miss)
  if gtype == _G.mjGEOM_SPHERE:
    return _ray_quadratic(_dot(lv, lv), _dot(lo, lv), _dot(lo, lo) - size[..., 0] ** 2)
  if gtype == _G.mjGEOM_ELLIPSOID:
    s = 1.0 / torch.clamp_min(size, 1e-12)
    eo, ev = lo * s, lv * s
    return _ray_quadratic(_dot(ev, ev), _dot(eo, ev), _dot(eo, eo) - 1.0)
  if gtype in (_G.mjGEOM_CAPSULE, _G.mjGEOM_CYLINDER):
    r, h = size[..., 0], size[..., 1]
    # The infinite cylinder about z, clipped to |z| <= h.
    a = lv[..., 0] ** 2 + lv[..., 1] ** 2
    b = lo[..., 0] * lv[..., 0] + lo[..., 1] * lv[..., 1]
    c = lo[..., 0] ** 2 + lo[..., 1] ** 2 - r * r
    t_side = _ray_quadratic(torch.clamp_min(a, 1e-12), b, c)
    z = lo[..., 2] + t_side * lv[..., 2]
    best = torch.where(torch.abs(z) <= h, t_side, miss)
    for sgn in (-1.0, 1.0):
      zc = sgn * h
      if gtype == _G.mjGEOM_CAPSULE:  # the hemispherical caps
        co = lo - torch.stack([torch.zeros_like(zc), torch.zeros_like(zc), zc], dim=-1)
        t_cap = _ray_quadratic(_dot(lv, lv), _dot(co, lv), _dot(co, co) - r * r)
        zcap = lo[..., 2] + t_cap * lv[..., 2]
        t_end = torch.where((zcap - zc) * sgn >= 0, t_cap, miss)
      else:  # the flat discs
        t_disc = torch.where(torch.abs(lv[..., 2]) > 1e-12, (zc - lo[..., 2]) / lv[..., 2], miss)
        x = lo[..., 0] + t_disc * lv[..., 0]
        y = lo[..., 1] + t_disc * lv[..., 1]
        t_end = torch.where((t_disc >= 0) & (x * x + y * y <= r * r), t_disc, miss)
      best = torch.minimum(best, t_end)
    return best
  if gtype == _G.mjGEOM_BOX:  # the slab method
    safe = torch.where(torch.abs(lv) > 1e-12, lv, torch.full_like(lv, 1e-12))
    t1 = (-size - lo) / safe
    t2 = (size - lo) / safe
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = tmax >= torch.clamp_min(tmin, 0.0)
    t = torch.where(tmin >= 0, tmin, tmax)
    return torch.where(hit & (t >= 0), t, miss)
  return None


def sensor_pos(tp: Topology, m: Model, d: Data) -> Data:
  return _eval_stage(tp, m, d, _POS_STAGE)


def sensor_vel(tp: Topology, m: Model, d: Data) -> Data:
  if any(int(t) in (_S.mjSENS_SUBTREELINVEL, _S.mjSENS_SUBTREEANGMOM)
         for t in tp.sensor_type):
    d = _subtree_dynamics(tp, m, d)
  return _eval_stage(tp, m, d, _VEL_STAGE)


def sensor_acc(tp: Topology, m: Model, d: Data) -> Data:
  return _eval_stage(tp, m, d, _ACC_STAGE)


def _in_ref(tp: Topology, m: Model, d: Data, s: int, stype: int, objtype: int, objid: int,
            val: torch.Tensor) -> torch.Tensor:
  """A frame sensor's world value expressed in its reference frame, as
  MuJoCo's mj_sensorPos/mj_sensorVel express it."""
  reftype, refid = int(tp.sensor_reftype[s]), int(tp.sensor_refid[s])
  rpos, rmat, rbody = _obj_frame(tp, d, reftype, refid)
  if stype == _S.mjSENS_FRAMEPOS:
    return _mT_v(rmat, val - rpos)
  if stype == _S.mjSENS_FRAMEQUAT:
    return mt.quat_mul(mt.quat_conjugate(_obj_quat(tp, m, d, reftype, refid)),
                       _obj_quat(tp, m, d, objtype, objid))
  if stype in _AXIS_COL:
    return _mT_v(rmat, val)
  if stype == _S.mjSENS_FRAMEANGVEL:
    return _mT_v(rmat, val - d.cvel[:, rbody, :3])
  # FRAMELINVEL: the velocity relative to the reference point, less the
  # reference frame's rotation carrying the object along.
  pos, _, _ = _obj_frame(tp, d, objtype, objid)
  w_ref = d.cvel[:, rbody, :3]
  rel = val - _point_vel(tp, d, rbody, rpos) - mt.cross(w_ref, pos - rpos)
  return _mT_v(rmat, rel)


def _eval_stage(tp: Topology, m: Model, d: Data, stage: set) -> Data:
  todo = [s for s in range(tp.nsensor) if int(tp.sensor_type[s]) in stage]
  if not todo:
    return d
  sensordata = d.sensordata.clone()
  B, dtype, device = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  cacc = cfrc = cforce = trn = None

  def zero():
    return torch.zeros((B, 1), dtype=dtype, device=device)

  for s in todo:
    stype = int(tp.sensor_type[s])
    adr, dim = int(tp.sensor_adr[s]), int(tp.sensor_dim[s])
    objtype, objid = int(tp.sensor_objtype[s]), int(tp.sensor_objid[s])
    if stype in (_S.mjSENS_ACCELEROMETER, _S.mjSENS_FRAMELINACC, _S.mjSENS_FRAMEANGACC,
                 _S.mjSENS_FORCE, _S.mjSENS_TORQUE) and cacc is None:
      cacc = _rne_postconstraint_cacc(tp, m, d)
    if stype == _S.mjSENS_GYRO:
      _, mat, body = _obj_frame(tp, d, objtype, objid)
      val = _mT_v(mat, d.cvel[:, body, :3])
    elif stype == _S.mjSENS_VELOCIMETER:
      pos, mat, body = _obj_frame(tp, d, objtype, objid)
      val = _mT_v(mat, _point_vel(tp, d, body, pos))
    elif stype == _S.mjSENS_ACCELEROMETER:
      pos, mat, body = _obj_frame(tp, d, objtype, objid)
      val = _mT_v(mat, _point_acc(tp, d, cacc, body, pos))
    elif stype == _S.mjSENS_FRAMEPOS:
      val, _, _ = _obj_frame(tp, d, objtype, objid)
    elif stype == _S.mjSENS_FRAMEQUAT:
      _, mat, _ = _obj_frame(tp, d, objtype, objid)
      val = mt.mat_to_quat(mat)
    elif stype in _AXIS_COL:
      _, mat, _ = _obj_frame(tp, d, objtype, objid)
      val = mat[..., _AXIS_COL[stype]]
    elif stype == _S.mjSENS_FRAMELINVEL:
      pos, _, body = _obj_frame(tp, d, objtype, objid)
      val = _point_vel(tp, d, body, pos)
    elif stype == _S.mjSENS_FRAMEANGVEL:
      _, _, body = _obj_frame(tp, d, objtype, objid)
      val = d.cvel[:, body, :3]
    elif stype == _S.mjSENS_FRAMELINACC:
      pos, _, body = _obj_frame(tp, d, objtype, objid)
      val = _point_acc(tp, d, cacc, body, pos)
    elif stype == _S.mjSENS_FRAMEANGACC:
      _, _, body = _obj_frame(tp, d, objtype, objid)
      val = cacc[:, body, :3]
    elif stype == _S.mjSENS_JOINTPOS:
      val = d.qpos[:, int(tp.jnt_qposadr[objid])]
    elif stype == _S.mjSENS_JOINTVEL:
      val = d.qvel[:, int(tp.jnt_dofadr[objid])]
    elif stype == _S.mjSENS_JOINTACTFRC:
      val = d.qfrc_actuator[:, int(tp.jnt_dofadr[objid])]
    elif stype == _S.mjSENS_SUBTREECOM:
      val = d.subtree_com[:, objid]
    elif stype == _S.mjSENS_SUBTREELINVEL:
      val = d.subtree_linvel[:, objid]
    elif stype == _S.mjSENS_SUBTREEANGMOM:
      val = d.subtree_angmom[:, objid]
    elif stype in (_S.mjSENS_ACTUATORPOS, _S.mjSENS_ACTUATORVEL):
      if trn is None:
        trn = smooth.transmission(tp, m, d)
      length, moment = trn
      val = (length if stype == _S.mjSENS_ACTUATORPOS
             else smooth.moment_mv(moment, d.qvel))[:, objid]
    elif stype == _S.mjSENS_ACTUATORFRC:
      val = d.actuator_force[:, objid]
    elif stype == _S.mjSENS_MAGNETOMETER:
      _, mat, _ = _obj_frame(tp, d, objtype, objid)
      val = _mT_v(mat, m.opt.magnetic.expand(B, 3))
    elif stype == _S.mjSENS_CLOCK:
      val = d.time
    elif stype == _S.mjSENS_TENDONPOS:
      val = d.ten_length[:, objid]
    elif stype == _S.mjSENS_TENDONVEL:
      val = d.ten_velocity[:, objid]
    elif stype in _LIMIT:
      row = _limit_row(tp, objid)
      if row is None:
        val = zero()
      else:
        if stype == _S.mjSENS_JOINTLIMITPOS:
          v = d.efc_pos[:, row] - d.efc_margin[:, row]
        elif stype == _S.mjSENS_JOINTLIMITVEL:
          v = _dot(d.efc_J[:, row], d.qvel)
        else:
          v = d.efc_force[:, row]
        val = torch.where(d.efc_pos[:, row] < d.efc_margin[:, row], v, torch.zeros_like(v))
    elif stype == _S.mjSENS_E_POTENTIAL:
      # mj_energyPos: gravitational plus hinge and slide spring potential.
      mass = per_env(m.body_mass, 1)
      val = -torch.sum(mass * (d.xipos @ m.opt.gravity), dim=-1)
      t = tp.dev.smooth
      if t.spring_jnt.numel():
        dq = d.qpos[:, t.spring_q] - m.qpos_spring[t.spring_q]
        k = per_env(m.jnt_stiffness, 1)[:, t.spring_jnt]
        val = val + 0.5 * torch.sum(k * dq * dq, dim=-1)
    elif stype == _S.mjSENS_E_KINETIC:
      val = 0.5 * _dot(d.qvel, (d.qM @ d.qvel[..., None])[..., 0])
    elif stype in (_S.mjSENS_FORCE, _S.mjSENS_TORQUE):
      if cfrc is None:
        cfrc = _cfrc_int(tp, m, d, cacc)
      body = int(tp.site_bodyid[objid])
      c = d.subtree_com[:, int(tp.body_rootid[body])]
      pos, mat = d.site_xpos[:, objid], d.site_xmat[:, objid]
      tq, f = cfrc[:, body, :3], cfrc[:, body, 3:]
      val = _mT_v(mat, f if stype == _S.mjSENS_FORCE else tq - mt.cross(pos - c, f))
    elif stype == _S.mjSENS_TOUCH:
      st = constraint.slot_tables(tp, m.opt.cone)
      body = int(tp.site_bodyid[objid])
      own = (st.b1 == body) | (st.b2 == body)
      if not own.any():
        val = zero()
      else:
        if cforce is None:
          cforce = constraint.contact_forces(tp, m, d)
        active = d.contact.dist < d.contact.includemargin
        fn = torch.clamp_min(cforce[..., 0], 0.0) * active
        local = torch.einsum("bji,bcj->bci", d.site_xmat[:, objid],
                             d.contact.pos - d.site_xpos[:, objid, None])
        inside = _inside_site(tp, objid, local)
        val = torch.sum(fn * inside * torch.as_tensor(own, dtype=dtype, device=device), dim=-1)
    elif stype == _S.mjSENS_RANGEFINDER:
      pos, mat, body = _obj_frame(tp, d, objtype, objid)
      v = mat[..., 2]
      best = torch.full((B,), _RAY_MISS, dtype=dtype, device=device)
      for gid in range(tp.ngeom):
        if int(tp.geom_bodyid[gid]) == body:
          continue  # mj_ray's bodyexclude: the sensor's own body
        t = _ray_geom(int(tp.geom_type[gid]), per_env(m.geom_size, 2)[:, gid],
                      d.geom_xpos[:, gid], d.geom_xmat[:, gid], pos, v)
        if t is not None:
          best = torch.minimum(best, t)
      val = torch.where(best >= _RAY_MISS, torch.full_like(best, -1.0), best)
    elif stype == _S.mjSENS_TENDONACTFRC:
      us = np.nonzero((tp.actuator_trntype == mjtTrn.mjTRN_TENDON)
                      & (tp.actuator_trnid[:, 0] == objid))[0]
      # The raw actuator force, not gear-scaled (MuJoCo's).
      val = d.actuator_force[:, us].sum(-1) if len(us) else zero()
    else:
      raise NotImplementedError(f"sensor type {stype}")
    if int(tp.sensor_refid[s]) >= 0:
      val = _in_ref(tp, m, d, s, stype, objtype, objid, val)
    sensordata[:, adr : adr + dim] = val.reshape(B, dim)
  return d.replace(sensordata=sensordata)
