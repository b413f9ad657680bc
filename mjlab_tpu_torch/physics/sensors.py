"""Builtin sensors of the velocity tasks (port of the matching part of
mjlab_tpu/physics/sensors.py): gyro, velocimeter, accelerometer, the frame
sensors (position, orientation, axes, linear and angular velocity, in the
world frame) and subtree angular momentum. io.put_model refuses every other
sensor type and any reference frame. The tree tables come from smooth's
(`tp.dev.smooth`).
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.physics.types import (
  Data,
  Model,
  Topology,
  mjtObj,
  mjtSensor,
  per_env,
)

_S = mjtSensor
_OBJ = mjtObj

_POS_STAGE = {
  _S.mjSENS_FRAMEPOS, _S.mjSENS_FRAMEQUAT, _S.mjSENS_FRAMEXAXIS,
  _S.mjSENS_FRAMEYAXIS, _S.mjSENS_FRAMEZAXIS,
}
_VEL_STAGE = {
  _S.mjSENS_GYRO, _S.mjSENS_VELOCIMETER, _S.mjSENS_FRAMELINVEL,
  _S.mjSENS_FRAMEANGVEL, _S.mjSENS_SUBTREEANGMOM,
}
_AXIS_COL = {_S.mjSENS_FRAMEXAXIS: 0, _S.mjSENS_FRAMEYAXIS: 1, _S.mjSENS_FRAMEZAXIS: 2}
_ACC_STAGE = {_S.mjSENS_ACCELEROMETER}


def _mT_v(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """matᵀ @ v, batched."""
  return (mat.transpose(-1, -2) @ v[..., None])[..., 0]


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


def sensor_pos(tp: Topology, m: Model, d: Data) -> Data:
  return _eval_stage(tp, m, d, _POS_STAGE)


def sensor_vel(tp: Topology, m: Model, d: Data) -> Data:
  if any(int(t) == _S.mjSENS_SUBTREEANGMOM for t in tp.sensor_type):
    d = _subtree_dynamics(tp, m, d)
  return _eval_stage(tp, m, d, _VEL_STAGE)


def sensor_acc(tp: Topology, m: Model, d: Data) -> Data:
  return _eval_stage(tp, m, d, _ACC_STAGE)


def _eval_stage(tp: Topology, m: Model, d: Data, stage: set) -> Data:
  todo = [s for s in range(tp.nsensor) if int(tp.sensor_type[s]) in stage]
  if not todo:
    return d
  sensordata = d.sensordata.clone()
  cacc = None
  for s in todo:
    stype = int(tp.sensor_type[s])
    adr, dim = int(tp.sensor_adr[s]), int(tp.sensor_dim[s])
    objtype, objid = int(tp.sensor_objtype[s]), int(tp.sensor_objid[s])
    if stype == _S.mjSENS_GYRO:
      _, mat, body = _obj_frame(tp, d, objtype, objid)
      val = _mT_v(mat, d.cvel[:, body, :3])
    elif stype == _S.mjSENS_VELOCIMETER:
      pos, mat, body = _obj_frame(tp, d, objtype, objid)
      val = _mT_v(mat, _point_vel(tp, d, body, pos))
    elif stype == _S.mjSENS_ACCELEROMETER:
      if cacc is None:
        cacc = _rne_postconstraint_cacc(tp, m, d)
      pos, mat, body = _obj_frame(tp, d, objtype, objid)
      origin = d.subtree_com[:, int(tp.body_rootid[body])]
      w = d.cvel[:, body, :3]
      a_lin = (
        cacc[:, body, 3:]
        + mt.cross(cacc[:, body, :3], pos - origin)
        + mt.cross(w, _point_vel(tp, d, body, pos))
      )
      val = _mT_v(mat, a_lin)
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
    elif stype == _S.mjSENS_SUBTREEANGMOM:
      val = d.subtree_angmom[:, objid]
    else:
      raise NotImplementedError(f"sensor type {stype}")
    sensordata[:, adr : adr + dim] = val.reshape(-1, dim)
  return d.replace(sensordata=sensordata)
