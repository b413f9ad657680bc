"""Forward kinematics: generalized coordinates → Cartesian frames (port of
mjlab_tpu/physics/kinematics.py).

Tree passes go level by level: the bodies at one tree depth are grouped by
joint signature and each group is one batched gather/compute/scatter over
(env, body). A body with several joints (hinge, slide, ball) is walked
joint by joint, each joint batched over the group's bodies, as MuJoCo's
mj_kinematics walks them; a mocap body takes its frame from `mocap_pos`
and `mocap_quat`, and its children follow it.

`qpos0` and the body, geom and site offsets (`body_pos`, `body_quat`,
`body_ipos`, `body_iquat`, `geom_pos`, `geom_quat`, `site_pos`,
`site_quat`) may carry a leading env axis for domain randomization
(sim.PER_ENV_FIELDS); the JAX package reads them the same way under its
vmap.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.physics.types import (
  Data,
  Model,
  Topology,
  index_tensor,
  mjtJoint,
  per_env,
)

_FREE = mjtJoint.mjJNT_FREE
_BALL = mjtJoint.mjJNT_BALL
_HINGE = mjtJoint.mjJNT_HINGE
_SLIDE = mjtJoint.mjJNT_SLIDE


def level_groups(tp: Topology) -> tuple[tuple[tuple[tuple[int, ...], np.ndarray], ...], ...]:
  """Per tree level: [(joint_signature, body_ids)] partitions (host)."""
  out = []
  for ids in tp.body_levels:
    groups: dict[tuple[int, ...], list[int]] = {}
    for i in ids:
      jadr, jnum = int(tp.body_jntadr[i]), int(tp.body_jntnum[i])
      sig = tuple(int(tp.jnt_type[jadr + k]) for k in range(jnum))
      groups.setdefault(sig, []).append(int(i))
    out.append(tuple((sig, np.asarray(b)) for sig, b in groups.items()))
  return tuple(out)


def _q_window(qadr: np.ndarray, width: int, offset: int = 0) -> np.ndarray:
  """(n, width) qpos (or qvel) addresses from each joint's address."""
  return qadr[:, None] + offset + np.arange(width)[None]


def device_tables(tp: Topology, dtype, device) -> SimpleNamespace:
  groups = []
  for level in level_groups(tp):
    for sig, ids in level:
      g = SimpleNamespace(sig=sig, ids=index_tensor(ids, device),
                          pid=index_tensor(tp.body_parentid[ids], device))
      # The group's joints, k-th joint of every body at once.
      g.joints = []
      for k, jtype in enumerate(sig):
        j = tp.body_jntadr[ids] + k
        qadr = tp.jnt_qposadr[j]
        width = {_FREE: 7, _BALL: 4}.get(jtype, 1)
        g.joints.append(SimpleNamespace(
          type=jtype, jnt=index_tensor(j, device), qadr=index_tensor(qadr, device),
          q=index_tensor(_q_window(qadr, width), device),
        ))
      mocap = np.nonzero(tp.body_mocapid[ids] >= 0)[0]
      g.mocap = (index_tensor(mocap, device), index_tensor(tp.body_mocapid[ids[mocap]], device)
                 ) if len(mocap) else None
      groups.append(g)

  def by_type(types):
    ids = np.nonzero(np.isin(tp.jnt_type, types))[0]
    return ids, tp.jnt_qposadr[ids], tp.jnt_dofadr[ids]

  _, sq, sv = by_type([_HINGE, _SLIDE])
  _, fq, fv = by_type([_FREE])
  _, bq, bv = by_type([_BALL])
  return SimpleNamespace(
    groups=groups,
    geom_bodyid=index_tensor(tp.geom_bodyid, device),
    site_bodyid=index_tensor(tp.site_bodyid, device),
    scalar_q=index_tensor(sq, device),
    scalar_v=index_tensor(sv, device),
    free_q3=index_tensor(_q_window(fq, 3), device),
    free_q4=index_tensor(_q_window(fq, 4, 3), device),
    free_v3=index_tensor(_q_window(fv, 3), device),
    free_v4=index_tensor(_q_window(fv, 3, 3), device),
    ball_q4=index_tensor(_q_window(bq, 4), device),
    ball_v3=index_tensor(_q_window(bv, 3), device),
  )


def kinematics(tp: Topology, m: Model, d: Data) -> Data:
  """Compute body/geom/site frames from qpos."""
  t = tp.dev.kin
  B = d.qpos.shape[0]
  dtype, device = d.qpos.dtype, d.qpos.device
  xpos = torch.zeros((B, tp.nbody, 3), dtype=dtype, device=device)
  xquat = torch.zeros((B, tp.nbody, 4), dtype=dtype, device=device)
  xquat[..., 0] = 1.0
  xanchor = torch.zeros((B, tp.njnt, 3), dtype=dtype, device=device)
  xaxis = torch.zeros((B, tp.njnt, 3), dtype=dtype, device=device)
  xaxis[..., 2] = 1.0
  qpos0 = per_env(m.qpos0, 1)  # (B or 1, nq)
  body_pos, body_quat = per_env(m.body_pos, 2), per_env(m.body_quat, 2)

  for g in t.groups:
    ppos, pquat = xpos[:, g.pid], xquat[:, g.pid]
    pos = ppos + mt.quat_apply(pquat, body_pos[:, g.ids])
    quat = mt.quat_mul(pquat, body_quat[:, g.ids])
    for jt in g.joints:
      if jt.type == _FREE:
        qp = d.qpos[:, jt.q]  # (B, n, 7)
        pos = qp[..., :3]
        quat = mt.normalize(qp[..., 3:7])
        xanchor[:, jt.jnt] = pos
        continue
      jpos, jaxis = m.jnt_pos[jt.jnt], m.jnt_axis[jt.jnt]
      anchor = pos + mt.quat_apply(quat, jpos)
      axis = mt.quat_apply(quat, jaxis)
      xanchor[:, jt.jnt] = anchor
      xaxis[:, jt.jnt] = axis
      if jt.type == _SLIDE:
        pos = pos + axis * (d.qpos[:, jt.qadr] - qpos0[:, jt.qadr])[..., None]
        continue
      if jt.type == _BALL:
        qloc = mt.normalize(d.qpos[:, jt.q])
      else:
        qloc = mt.axis_angle_to_quat(jaxis, d.qpos[:, jt.qadr] - qpos0[:, jt.qadr])
      quat = mt.quat_mul(quat, qloc)
      pos = anchor - mt.quat_apply(quat, jpos)
    if g.mocap is not None:
      local, mid = g.mocap
      pos[:, local] = d.mocap_pos[:, mid]
      quat[:, local] = mt.normalize(d.mocap_quat[:, mid])
    xpos[:, g.ids] = pos
    xquat[:, g.ids] = quat
  xmat = mt.quat_to_mat(xquat)
  bid, sid = t.geom_bodyid, t.site_bodyid
  # Each offset is (n, k) or, randomized per env, (B, n, k).
  xipos = xpos + mt.quat_apply(xquat, m.body_ipos)
  ximat = mt.quat_to_mat(mt.quat_mul(xquat, m.body_iquat))
  geom_xpos = xpos[:, bid] + mt.quat_apply(xquat[:, bid], m.geom_pos)
  geom_xmat = mt.quat_to_mat(mt.quat_mul(xquat[:, bid], m.geom_quat))
  site_xpos = xpos[:, sid] + mt.quat_apply(xquat[:, sid], m.site_pos)
  site_xmat = mt.quat_to_mat(mt.quat_mul(xquat[:, sid], m.site_quat))
  return d.replace(
    xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
    geom_xpos=geom_xpos, geom_xmat=geom_xmat,
    site_xpos=site_xpos, site_xmat=site_xmat,
    xanchor=xanchor, xaxis=xaxis,
  )


def integrate_pos(
  tp: Topology, m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt
) -> torch.Tensor:
  """Integrate positions by velocity (mj_integratePos), per joint type."""
  t = tp.dev.kin
  out = qpos.clone()
  out[:, t.scalar_q] = qpos[:, t.scalar_q] + dt * qvel[:, t.scalar_v]
  if t.free_q3.numel():
    out[:, t.free_q3] = qpos[:, t.free_q3] + dt * qvel[:, t.free_v3]
    out[:, t.free_q4] = mt.quat_integrate(
      qpos[:, t.free_q4], qvel[:, t.free_v4], dt
    )
  if t.ball_q4.numel():
    out[:, t.ball_q4] = mt.quat_integrate(qpos[:, t.ball_q4], qvel[:, t.ball_v3], dt)
  return out
