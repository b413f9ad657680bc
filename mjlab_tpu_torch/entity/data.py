"""EntityData: per-entity batched state accessor (port of
mjlab_tpu/entity/data.py).

A view over the env's state context: reads are functions of the current
batched physics Data; writes build an updated Data and hand it back to the
context. `env_mask` is a boolean (B,) tensor selecting the envs a write
affects (None = all); masked writes merge with `torch.where`, never with
`nonzero`, so no write synchronizes with the host. Every constant and index
table is built on the env's device here, once.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.core.strings import resolve_expr

if TYPE_CHECKING:
  from mjlab_tpu_torch.entity.entity import Entity


def compute_velocity_from_cvel(pos, subtree_com, cvel):
  """Convert com-based cvel to world-frame [lin, ang] velocity at `pos`."""
  lin_c = cvel[..., 3:6]
  ang_c = cvel[..., 0:3]
  offset = subtree_com - pos
  lin_w = lin_c - mt.cross(ang_c, offset)
  return torch.cat([lin_w, ang_c], dim=-1)


def device_index(ids, device):
  """A slice for a contiguous ascending run of indices, else an int64 device
  tensor: either indexes without a host-to-device copy per use."""
  ids = np.asarray(ids, dtype=np.int64)
  if len(ids) and np.array_equal(ids, np.arange(ids[0], ids[0] + len(ids))):
    return slice(int(ids[0]), int(ids[0]) + len(ids))
  return torch.as_tensor(ids, device=device)


def _merge(old, new, mask):
  if mask is None:
    return torch.broadcast_to(new, old.shape)
  m = mask.reshape(mask.shape + (1,) * (old.dim() - 1))
  return torch.where(m, new, old)


def _compose(base, sub):
  """base[sub] for index tables that are slices or tensors (sub None = all)."""
  if sub is None or (isinstance(sub, slice) and sub == slice(None)):
    return base
  if isinstance(base, slice):
    if isinstance(sub, slice):  # a run of a run stays a slice
      r = range(base.start, base.stop)[sub]
      if r.step == 1:
        return slice(r.start, r.stop)
    base = torch.arange(base.start, base.stop,
                        device=sub.device if torch.is_tensor(sub) else None)
  return base[sub]


class EntityData:
  """The state surface the MDP terms read: root pose and velocities,
  heading, projected gravity, joint positions and velocities with their
  defaults and soft limits, and body, site and geom poses."""

  def __init__(self, entity: "Entity", ctx) -> None:
    self._ctx = ctx
    self.indexing = idx = entity.indexing
    B, dtype, dev = ctx.num_envs, ctx.dtype, ctx.device

    def const(x, shape):
      return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                             device=dev).expand(shape)

    self._body = device_index(idx.body_ids, dev)
    self._geom = device_index(idx.geom_ids, dev)
    self._site = device_index(idx.site_ids, dev)
    self._ctrl = device_index(idx.ctrl_ids, dev)
    self._q = device_index(idx.joint_q_adr, dev)
    self._v = device_index(idx.joint_v_adr, dev)
    self._free_q = device_index(idx.free_joint_q_adr, dev)
    self._free_v = device_index(idx.free_joint_v_adr, dev)
    self._root_quat = device_index(idx.free_joint_q_adr[3:7], dev)
    self._site_body = device_index(ctx.tp.site_bodyid[idx.site_ids], dev)

    cfg = entity.cfg.init_state
    root_state = list(cfg.pos) + list(cfg.rot)
    if not entity.is_fixed_base:
      root_state += list(cfg.lin_vel) + list(cfg.ang_vel)
    self.default_root_state = const(root_state, (B, len(root_state)))

    mjm = ctx.sim.mj_model
    if entity.is_articulated:
      jp = resolve_expr(cfg.joint_pos, entity.joint_names)
      jv = resolve_expr(cfg.joint_vel, entity.joint_names)
      nj = len(jp)
      self.default_joint_pos = const(jp, (B, nj))
      self.default_joint_vel = const(jv, (B, nj))
      if entity.is_actuated:
        gain = np.asarray(mjm.actuator_gainprm)[idx.ctrl_ids, 0]
        damp = -np.asarray(mjm.actuator_biasprm)[idx.ctrl_ids, 2]
        self.default_joint_stiffness = const(gain, (B, len(gain)))
        self.default_joint_damping = const(damp, (B, len(damp)))
      else:
        self.default_joint_stiffness = const(np.zeros(0), (B, 0))
        self.default_joint_damping = const(np.zeros(0), (B, 0))
      limits = np.asarray(mjm.jnt_range)[idx.joint_ids]  # (nj, 2)
      self.default_joint_pos_limits = const(limits, (B, nj, 2))
      mean = (limits[:, 0] + limits[:, 1]) / 2
      rng = limits[:, 1] - limits[:, 0]
      art = entity.cfg.articulation
      factor = art.soft_joint_pos_limit_factor if art else 1.0
      soft = np.stack([mean - 0.5 * rng * factor, mean + 0.5 * rng * factor], axis=-1)
      self.soft_joint_pos_limits = const(soft, (B, nj, 2))
    else:
      z = const(np.zeros(0), (B, 0))
      self.default_joint_pos = self.default_joint_vel = z
      self.default_joint_stiffness = self.default_joint_damping = z
      self.default_joint_pos_limits = const(np.zeros((0, 2)), (B, 0, 2))
      self.soft_joint_pos_limits = self.default_joint_pos_limits

    self.gravity_vec_w = const([0.0, 0.0, -1.0], (B, 3))
    self.forward_vec_b = const([1.0, 0.0, 0.0], (B, 3))
    self.is_fixed_base = entity.is_fixed_base
    self.is_articulated = entity.is_articulated
    self.is_actuated = entity.is_actuated

  @property
  def data(self):
    return self._ctx.data

  # -- writes -----------------------------------------------------------------

  def _write(self, field: str, index, value, env_mask) -> None:
    d = self.data
    t = getattr(d, field).clone()
    t[:, index] = _merge(t[:, index], value, env_mask)
    self._ctx.data = d.replace(**{field: t})

  def write_root_state(self, root_state, env_mask=None):
    if self.is_fixed_base:
      raise ValueError("Cannot write root state for fixed-base entity.")
    self.write_root_pose(root_state[:, :7], env_mask)
    self.write_root_velocity(root_state[:, 7:], env_mask)

  def write_root_pose(self, pose, env_mask=None):
    if self.is_fixed_base:
      raise ValueError("Cannot write root pose for fixed-base entity.")
    self._write("qpos", self._free_q, pose, env_mask)

  def write_root_velocity(self, velocity, env_mask=None):
    if self.is_fixed_base:
      raise ValueError("Cannot write root velocity for fixed-base entity.")
    quat_w = self.data.qpos[:, self._root_quat]
    # MuJoCo free-joint qvel: linear world-frame, angular body-frame.
    ang_b = mt.quat_apply_inverse(quat_w, velocity[:, 3:])
    self._write("qvel", self._free_v, torch.cat([velocity[:, :3], ang_b], -1), env_mask)

  def write_joint_state(self, position, velocity, joint_ids=None, env_mask=None):
    self.write_joint_position(position, joint_ids, env_mask)
    self.write_joint_velocity(velocity, joint_ids, env_mask)

  def write_joint_position(self, position, joint_ids=None, env_mask=None):
    self._write("qpos", _compose(self._q, joint_ids), position, env_mask)

  def write_joint_velocity(self, velocity, joint_ids=None, env_mask=None):
    self._write("qvel", _compose(self._v, joint_ids), velocity, env_mask)

  def write_ctrl(self, ctrl, ctrl_ids=None, env_mask=None):
    if not self.is_actuated:
      raise ValueError("Cannot write control for non-actuated entity.")
    self._write("ctrl", _compose(self._ctrl, ctrl_ids), ctrl, env_mask)

  def write_mocap_pose(self, pose, env_mask=None):
    """Set a mocap entity's pose (B, 7) [pos, quat wxyz] in mocap_pos and
    mocap_quat."""
    mid = self.indexing.mocap_id
    if mid is None:
      raise ValueError("Cannot write mocap pose for non-mocap entity.")
    self._write("mocap_pos", mid, pose[:, :3], env_mask)
    self._write("mocap_quat", mid, pose[:, 3:7], env_mask)

  def write_external_wrench(self, force, torque, body_ids=None, env_mask=None):
    """Set the selected bodies' world-frame external force and torque
    (`xfrc_applied`); a None half keeps its value."""
    ids = _compose(self._body, body_ids)
    xfrc = self.data.xfrc_applied.clone()
    for part, value in ((slice(0, 3), force), (slice(3, 6), torque)):
      if value is not None:
        xfrc[:, ids, part] = _merge(xfrc[:, ids, part], value, env_mask)
    self._ctx.data = self.data.replace(xfrc_applied=xfrc)

  def clear_state(self, env_mask=None):
    d = self.data
    if len(self.indexing.free_joint_v_adr):
      self._write("qfrc_applied", self._free_v, torch.zeros((), dtype=d.qvel.dtype,
                                                            device=d.qvel.device),
                  env_mask)
    self._write("xfrc_applied", self._body,
                torch.zeros((), dtype=d.qvel.dtype, device=d.qvel.device), env_mask)
    if self.is_actuated:
      self._write("ctrl", self._ctrl,
                  torch.zeros((), dtype=d.qvel.dtype, device=d.qvel.device), env_mask)

  # -- root reads ---------------------------------------------------------------

  @property
  def root_link_pose_w(self):
    rid = self.indexing.root_body_id
    return torch.cat([self.data.xpos[:, rid], self.data.xquat[:, rid]], -1)

  @property
  def root_link_vel_w(self):
    rid = self.indexing.root_body_id
    return compute_velocity_from_cvel(
      self.data.xpos[:, rid], self.data.subtree_com[:, rid], self.data.cvel[:, rid]
    )

  # -- body reads ---------------------------------------------------------------

  @property
  def body_link_pose_w(self):
    ids = self._body
    return torch.cat([self.data.xpos[:, ids], self.data.xquat[:, ids]], -1)

  @property
  def body_link_vel_w(self):
    rid = self.indexing.root_body_id
    return compute_velocity_from_cvel(
      self.data.xpos[:, self._body],
      self.data.subtree_com[:, rid][:, None],
      self.data.cvel[:, self._body],
    )

  # -- geom / site reads ----------------------------------------------------------

  @property
  def geom_pose_w(self):
    quat = mt.mat_to_quat(self.data.geom_xmat[:, self._geom])
    return torch.cat([self.data.geom_xpos[:, self._geom], quat], -1)

  @property
  def site_pose_w(self):
    quat = mt.mat_to_quat(self.data.site_xmat[:, self._site])
    return torch.cat([self.data.site_xpos[:, self._site], quat], -1)

  @property
  def site_vel_w(self):
    rid = self.indexing.root_body_id
    return compute_velocity_from_cvel(
      self.data.site_xpos[:, self._site],
      self.data.subtree_com[:, rid][:, None],
      self.data.cvel[:, self._site_body],
    )

  # -- joint reads ----------------------------------------------------------------

  @property
  def joint_pos(self):
    return self.data.qpos[:, self._q]

  @property
  def joint_vel(self):
    return self.data.qvel[:, self._v]

  @property
  def joint_acc(self):
    return self.data.qacc[:, self._v]

  @property
  def actuator_force(self):
    return self.data.actuator_force[:, self._ctrl]

  # -- component accessors (reference naming) ---------------------------------------

  @property
  def root_link_pos_w(self):
    return self.root_link_pose_w[:, 0:3]

  @property
  def root_link_quat_w(self):
    return self.root_link_pose_w[:, 3:7]

  @property
  def root_link_lin_vel_w(self):
    return self.root_link_vel_w[:, 0:3]

  @property
  def root_link_ang_vel_w(self):
    return self.root_link_vel_w[:, 3:6]

  @property
  def body_link_pos_w(self):
    return self.body_link_pose_w[..., 0:3]

  @property
  def body_link_quat_w(self):
    return self.body_link_pose_w[..., 3:7]

  @property
  def body_link_lin_vel_w(self):
    return self.body_link_vel_w[..., 0:3]

  @property
  def body_link_ang_vel_w(self):
    return self.body_link_vel_w[..., 3:6]

  @property
  def site_pos_w(self):
    return self.site_pose_w[..., 0:3]

  @property
  def site_lin_vel_w(self):
    return self.site_vel_w[..., 0:3]

  # -- derived frames -----------------------------------------------------------

  @property
  def projected_gravity_b(self):
    return mt.quat_apply_inverse(self.root_link_quat_w, self.gravity_vec_w)

  @property
  def heading_w(self):
    fwd_w = mt.quat_apply(self.root_link_quat_w, self.forward_vec_b)
    return torch.atan2(fwd_w[:, 1], fwd_w[:, 0])

  @property
  def root_link_lin_vel_b(self):
    return mt.quat_apply_inverse(self.root_link_quat_w, self.root_link_lin_vel_w)

  @property
  def root_link_ang_vel_b(self):
    return mt.quat_apply_inverse(self.root_link_quat_w, self.root_link_ang_vel_w)
