"""Motion preprocessing: CSV mocap → tracking-ready npz (port of
mjlab_tpu/scripts/csv_to_npz.py), without `mujoco`.

Pipeline: load CSV rows [base_pos(3), base_quat wxyz(4), joint_pos(nj)] at
input_fps → lerp/slerp resample to output_fps → finite-difference
velocities (SO(3) log for the angular one), all in numpy → replay every
frame through the port's kinematics and com-velocity stages on the compiled
G1 scene, frames as worlds (tasks.tracking.motions.replay_body_frames) →
save the npz that the tracking MotionLoader reads: the entity's bodies in
the entity's order, the world body excluded.

The finite-difference angular velocity is a world-frame one; MuJoCo's
free-joint qvel holds it in the body frame, so it is rotated there before
the replay. The JAX package writes the world-frame vector as is, which
agrees while the base only yaws (ROADMAP, declared divergences).

Usage:
  python -m mjlab_tpu_torch.scripts.csv_to_npz input.csv --output motion.npz \
      [--input_fps 30] [--output_fps 50] [--robot g1] [--device cuda]

Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import sys

import numpy as np


def _slerp_batch(q0: np.ndarray, q1: np.ndarray, t: np.ndarray) -> np.ndarray:
  """Vectorized quaternion slerp (wxyz)."""
  dot = np.sum(q0 * q1, axis=-1, keepdims=True)
  q1 = np.where(dot < 0, -q1, q1)
  dot = np.abs(dot)
  theta = np.arccos(np.clip(dot, -1.0, 1.0))
  sin_theta = np.sin(theta)
  near = sin_theta < 1e-6
  w0 = np.where(near, 1.0 - t, np.sin((1.0 - t) * theta) / np.maximum(sin_theta, 1e-12))
  w1 = np.where(near, t, np.sin(t * theta) / np.maximum(sin_theta, 1e-12))
  out = w0 * q0 + w1 * q1
  return out / np.linalg.norm(out, axis=-1, keepdims=True)


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
  w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
  w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
  return np.stack(
    [
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ],
    axis=-1,
  )


def _quat_rotate_inverse(q: np.ndarray, v: np.ndarray) -> np.ndarray:
  """v rotated by q⁻¹ (world → body for a body rotation q)."""
  conj = q * np.array([1.0, -1.0, -1.0, -1.0])
  vq = np.concatenate([np.zeros_like(v[..., :1]), v], axis=-1)
  return _quat_mul(_quat_mul(conj, vq), q)[..., 1:]


def _so3_finite_diff(quats: np.ndarray, dt: float) -> np.ndarray:
  """Angular velocity by SO(3) log of q_{t+1} q_t⁻¹ (world frame)."""
  q0 = quats[:-1]
  q1 = quats[1:]
  conj = q0 * np.array([1, -1, -1, -1])
  dq = _quat_mul(q1, conj)
  dq = np.where(dq[..., :1] < 0, -dq, dq)
  angle = 2.0 * np.arccos(np.clip(dq[..., 0:1], -1.0, 1.0))
  axis = dq[..., 1:]
  norm = np.linalg.norm(axis, axis=-1, keepdims=True)
  axis = axis / np.maximum(norm, 1e-12)
  w = angle * axis / dt
  return np.concatenate([w, w[-1:]], axis=0)


def resample(base_pos, base_quat, joint_pos, input_fps, output_fps):
  t_in = np.arange(base_pos.shape[0]) / input_fps
  duration = t_in[-1]
  t_out = np.arange(0.0, duration, 1.0 / output_fps)
  idx = np.minimum(np.searchsorted(t_in, t_out, side="right") - 1, len(t_in) - 2)
  blend = ((t_out - t_in[idx]) * input_fps)[:, None]
  pos = base_pos[idx] * (1 - blend) + base_pos[idx + 1] * blend
  joints = joint_pos[idx] * (1 - blend) + joint_pos[idx + 1] * blend
  quat = _slerp_batch(base_quat[idx], base_quat[idx + 1], blend)
  return pos, quat, joints


def process(
  csv_path: str,
  robot: str = "g1",
  input_fps: float = 30.0,
  output_fps: float = 50.0,
  device=None,
  dtype=np.float32,
) -> dict[str, np.ndarray]:
  """The motion npz's arrays: fps, then joint and body arrays in `dtype`
  (float32, as the JAX script writes them; computed in float64)."""
  from mjlab_tpu_torch.assets import G1_VELOCITY_FLAT, load_model_npz
  from mjlab_tpu_torch.entity import Entity, EntityCfg
  from mjlab_tpu_torch.tasks.tracking.motions import replay_body_frames

  if robot != "g1":
    raise ValueError(f"Unsupported robot {robot}")
  model = load_model_npz(G1_VELOCITY_FLAT)
  idx = Entity(EntityCfg(), "robot", model).indexing

  raw = np.loadtxt(csv_path, delimiter=",")
  base_pos, base_quat, joint_pos = raw[:, :3], raw[:, 3:7], raw[:, 7:]
  base_quat = base_quat / np.linalg.norm(base_quat, axis=-1, keepdims=True)

  pos, quat, joints = resample(base_pos, base_quat, joint_pos, input_fps, output_fps)
  dt = 1.0 / output_fps
  lin_vel = np.gradient(pos, dt, axis=0)
  ang_vel = _so3_finite_diff(quat, dt)
  joint_vel = np.gradient(joints, dt, axis=0)

  # The frames as worlds of one batched replay through the port's kinematics.
  T = pos.shape[0]
  qpos = np.tile(np.asarray(model.qpos0, dtype=np.float64), (T, 1))
  qvel = np.zeros((T, model.nv))
  qpos[:, idx.free_joint_q_adr] = np.concatenate([pos, quat], axis=-1)
  qpos[:, idx.joint_q_adr] = joints
  qvel[:, idx.free_joint_v_adr] = np.concatenate(
    [lin_vel, _quat_rotate_inverse(quat, ang_vel)], axis=-1)
  qvel[:, idx.joint_v_adr] = joint_vel
  frames = replay_body_frames(model, qpos, qvel, device=device)

  return {
    "fps": np.asarray(output_fps),
    "joint_pos": joints.astype(dtype),
    "joint_vel": joint_vel.astype(dtype),
    **{k: v.astype(dtype) for k, v in frames.items()},
  }


def main() -> None:
  from mjlab_tpu_torch.scripts.cli import parse_args

  positionals, overrides = parse_args(sys.argv[1:])
  if not positionals:
    print("usage: csv_to_npz input.csv --output motion.npz "
          "[--input_fps 30] [--output_fps 50] [--robot g1] [--device cuda]")
    sys.exit(1)
  out = overrides.get("output", positionals[0].rsplit(".", 1)[0] + ".npz")
  arrays = process(
    positionals[0],
    robot=overrides.get("robot", "g1"),
    input_fps=float(overrides.get("input_fps", "30")),
    output_fps=float(overrides.get("output_fps", "50")),
    device=overrides.get("device"),
  )
  np.savez(out, **arrays)
  print(f"Wrote {out}: {arrays['joint_pos'].shape[0]} frames at "
        f"{float(arrays['fps'])} fps")


if __name__ == "__main__":
  main()
