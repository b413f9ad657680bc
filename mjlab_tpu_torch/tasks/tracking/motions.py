"""Motion-file helpers for the tracking task (port of
mjlab_tpu/tasks/tracking/motions.py), without `mujoco`.

A motion npz holds fps, joint_pos and joint_vel (T, nj), and
body_{pos,quat,lin_vel,ang_vel}_w (T, nbody, ·) over the entity's bodies in
the entity's order (the world body, and any other entity's or the
terrain's, left out). Its body frames come from the port's own kinematics
on a compiled scene, one world per frame (`replay_body_frames`), which
`make_standing_motion` and `scripts/csv_to_npz.py` share. Motions are local
files: the reference's artifact-registry download is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import get_g1_robot_cfg
from mjlab_tpu_torch.assets import G1_VELOCITY_FLAT, load_model_npz
from mjlab_tpu_torch.core.strings import resolve_expr
from mjlab_tpu_torch.entity import Entity, EntityCfg
from mjlab_tpu_torch.entity.data import compute_velocity_from_cvel
from mjlab_tpu_torch.physics import io as physics_io
from mjlab_tpu_torch.physics import kinematics, smooth


def replay_body_frames(model, qpos: np.ndarray, qvel: np.ndarray,
                       device=None) -> dict[str, np.ndarray]:
  """World-frame poses and velocities at the body origins of the robot
  entity's bodies for each row of the scene's (T, nq) `qpos` and (T, nv) `qvel`
  (free-joint angular velocity in the body frame, as MuJoCo's qvel holds
  it): kinematics, then the com-based velocities shifted from the subtree
  COM to each body's origin. float64, on `device` (CUDA unless asked)."""
  device = torch.device(device) if device is not None else physics_io.default_device()
  tp, m = physics_io.put_model(model, dtype=torch.float64, device=device)
  ids = Entity(EntityCfg(), "robot", model).indexing.body_ids
  d = physics_io.make_data(tp, m, qpos.shape[0])
  d = d.replace(qpos=torch.as_tensor(qpos, dtype=torch.float64, device=device),
                qvel=torch.as_tensor(qvel, dtype=torch.float64, device=device))
  d = kinematics.kinematics(tp, m, d)
  d = smooth.com_pos(tp, m, d)
  d = smooth.com_vel(tp, m, d)
  root = torch.as_tensor(np.asarray(model.body_rootid)[ids], device=device)
  vel = compute_velocity_from_cvel(d.xpos[:, ids], d.subtree_com[:, root], d.cvel[:, ids])
  out = {"body_pos_w": d.xpos[:, ids], "body_quat_w": d.xquat[:, ids],
         "body_lin_vel_w": vel[..., 0:3], "body_ang_vel_w": vel[..., 3:6]}
  return {k: v.cpu().numpy() for k, v in out.items()}


def make_standing_motion(path, T: int = 60, dt: float = 0.02, device=None) -> str:
  """Write a standing G1 motion npz: the body frames of the robot's init
  keyframe (`get_g1_robot_cfg().init_state`) on the committed G1 scene,
  held for T frames, every velocity zero. Returns str(path)."""
  robot_cfg = get_g1_robot_cfg()
  model = load_model_npz(G1_VELOCITY_FLAT)
  entity = Entity(robot_cfg, "robot", model)
  init = robot_cfg.init_state
  joints = np.asarray(resolve_expr(init.joint_pos, entity.joint_names), dtype=np.float64)
  qpos = np.array(model.qpos0, dtype=np.float64)
  qpos[entity.indexing.free_joint_q_adr] = list(init.pos) + list(init.rot)
  qpos[entity.indexing.joint_q_adr] = joints
  frames = replay_body_frames(model, qpos[None], np.zeros((1, model.nv)), device=device)
  nb = frames["body_pos_w"].shape[1]
  np.savez(
    path,
    fps=np.asarray(1.0 / dt),
    joint_pos=np.tile(joints, (T, 1)),
    joint_vel=np.zeros((T, len(joints))),
    body_pos_w=np.tile(frames["body_pos_w"], (T, 1, 1)),
    body_quat_w=np.tile(frames["body_quat_w"], (T, 1, 1)),
    body_lin_vel_w=np.zeros((T, nb, 3)),
    body_ang_vel_w=np.zeros((T, nb, 3)),
  )
  return str(path)
