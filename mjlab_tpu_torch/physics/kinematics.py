"""Forward kinematics: generalized coordinates → Cartesian frames (port of
mjlab_tpu/physics/kinematics.py).

Tree passes go level by level: the bodies at one tree depth are grouped by
joint signature and each group is one batched gather/compute/scatter over
(env, body). The port supports bodies with no joint, one free, one hinge or
one slide joint (io.put_model refuses the rest).

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


def device_tables(tp: Topology, dtype, device) -> SimpleNamespace:
  groups = []
  for level in level_groups(tp):
    for sig, ids in level:
      j = tp.body_jntadr[ids]
      qadr = tp.jnt_qposadr[j] if len(sig) else np.zeros(0, dtype=np.int64)
      g = SimpleNamespace(sig=sig, ids=index_tensor(ids, device),
                          pid=index_tensor(tp.body_parentid[ids], device))
      if sig:
        g.jnt = index_tensor(j, device)
        g.qadr = index_tensor(qadr, device)
      if sig == (_FREE,):
        g.gq7 = index_tensor(qadr[:, None] + np.arange(7)[None], device)
      groups.append(g)

  def by_type(types):
    ids = np.nonzero(np.isin(tp.jnt_type, types))[0]
    return ids, tp.jnt_qposadr[ids], tp.jnt_dofadr[ids]

  _, sq, sv = by_type([_HINGE, _SLIDE])
  _, fq, fv = by_type([_FREE])
  return SimpleNamespace(
    groups=groups,
    geom_bodyid=index_tensor(tp.geom_bodyid, device),
    site_bodyid=index_tensor(tp.site_bodyid, device),
    scalar_q=index_tensor(sq, device),
    scalar_v=index_tensor(sv, device),
    free_q3=index_tensor(fq[:, None] + np.arange(3)[None], device),
    free_q4=index_tensor(fq[:, None] + 3 + np.arange(4)[None], device),
    free_v3=index_tensor(fv[:, None] + np.arange(3)[None], device),
    free_v4=index_tensor(fv[:, None] + 3 + np.arange(3)[None], device),
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
    if g.sig == (_FREE,):
      qp = d.qpos[:, g.gq7]  # (B, n, 7)
      pos = qp[..., :3]
      quat = mt.normalize(qp[..., 3:7])
      xanchor[:, g.jnt] = pos
    elif g.sig in ((_HINGE,), (_SLIDE,)):
      jpos, jaxis = m.jnt_pos[g.jnt], m.jnt_axis[g.jnt]
      anchor = pos + mt.quat_apply(quat, jpos)
      axis = mt.quat_apply(quat, jaxis)
      xanchor[:, g.jnt] = anchor
      xaxis[:, g.jnt] = axis
      dq = d.qpos[:, g.qadr] - qpos0[:, g.qadr]
      if g.sig == (_SLIDE,):
        pos = pos + axis * dq[..., None]
      else:
        quat = mt.quat_mul(quat, mt.axis_angle_to_quat(jaxis, dq))
        pos = anchor - mt.quat_apply(quat, jpos)
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
  return out
