"""Uniform velocity command with heading control and standing envs (port of
mjlab_tpu/tasks/velocity/mdp/velocity_command.py): per-env (vx, vy, wz)
commands resampled on a clock; a fraction of envs track a heading target
(wz from a P-controller on the heading error); a fraction stand still; with
`init_velocity_prob`, a share of the resampled envs starts at its command. The
sampling ranges live in the term's state so that the commands_vel
curriculum can stage them."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.distributed.sharding import env_rows
from mjlab_tpu_torch.managers.command_manager import CommandTerm
from mjlab_tpu_torch.managers.manager_term_config import CommandTermCfg


class UniformVelocityCommand(CommandTerm):
  cfg: "UniformVelocityCommandCfg"

  def __init__(self, cfg: "UniformVelocityCommandCfg", env):
    super().__init__(cfg, env)
    if cfg.heading_command and cfg.ranges.heading is None:
      raise ValueError("heading_command=True but ranges.heading is None.")
    if cfg.ranges.heading and not cfg.heading_command:
      raise ValueError("ranges.heading is set but heading_command=False.")
    self.robot = env.scene[cfg.asset_name]

  @property
  def command(self) -> torch.Tensor:
    return self.state["vel_command_b"]

  def _init_term_state(self) -> dict:
    env, B, r = self._env, self.num_envs, self.cfg.ranges

    def t(x):
      return torch.as_tensor(x, dtype=env.dtype, device=env.device)

    return {
      "vel_command_b": torch.zeros((B, 3), dtype=env.dtype, device=env.device),
      "heading_target": torch.zeros(B, dtype=env.dtype, device=env.device),
      "is_heading_env": torch.zeros(B, dtype=torch.bool, device=env.device),
      "is_standing_env": torch.zeros(B, dtype=torch.bool, device=env.device),
      "ranges": {"lin_vel_x": t(r.lin_vel_x), "lin_vel_y": t(r.lin_vel_y),
                 "ang_vel_z": t(r.ang_vel_z)},
    }

  def _init_metrics(self) -> dict:
    env = self._env
    return {
      "error_vel_xy": torch.zeros(self.num_envs, dtype=env.dtype, device=env.device),
      "error_vel_yaw": torch.zeros(self.num_envs, dtype=env.dtype, device=env.device),
    }

  def _rand(self) -> torch.Tensor:
    env = self._env
    return env_rows(torch.rand, (self.num_envs,), generator=env.generator,
                    dtype=env.dtype, device=env.device)

  def _resample_command(self, env_mask: torch.Tensor) -> None:
    st = self.state
    ranges = st["ranges"]
    cmd = torch.stack(
      [r[0] + (r[1] - r[0]) * self._rand()
       for r in (ranges["lin_vel_x"], ranges["lin_vel_y"], ranges["ang_vel_z"])],
      dim=-1,
    )
    st["vel_command_b"] = torch.where(env_mask[:, None], cmd, st["vel_command_b"])
    if self.cfg.heading_command:
      lo, hi = self.cfg.ranges.heading
      heading = lo + (hi - lo) * self._rand()
      st["heading_target"] = torch.where(env_mask, heading, st["heading_target"])
      is_heading = self._rand() <= self.cfg.rel_heading_envs
      st["is_heading_env"] = torch.where(env_mask, is_heading, st["is_heading_env"])
    is_standing = self._rand() <= self.cfg.rel_standing_envs
    st["is_standing_env"] = torch.where(env_mask, is_standing, st["is_standing_env"])

    if self.cfg.init_velocity_prob > 0.0:
      # Start a share of the resampled envs at their commanded velocity. As
      # in the JAX package (and the reference), the yaw rate is set in the
      # body frame and written where the root state holds the world frame's.
      inject = env_mask & (self._rand() < self.cfg.init_velocity_prob)
      data = self.robot.data
      lin_vel_b = data.root_link_lin_vel_b.clone()
      lin_vel_b[:, :2] = st["vel_command_b"][:, :2]
      ang_vel_b = data.root_link_ang_vel_b.clone()
      ang_vel_b[:, 2] = st["vel_command_b"][:, 2]
      quat_w = data.root_link_quat_w
      root_state = torch.cat(
        [data.root_link_pos_w, quat_w, mt.quat_apply(quat_w, lin_vel_b), ang_vel_b], dim=-1
      )
      self.robot.write_root_state_to_sim(root_state, env_mask=inject)

  def _update_command(self) -> None:
    st = self.state
    cmd = st["vel_command_b"]
    if self.cfg.heading_command:
      heading_error = mt.wrap_to_pi(st["heading_target"] - self.robot.data.heading_w)
      lo, hi = self.cfg.ranges.ang_vel_z
      wz = torch.clamp(self.cfg.heading_control_stiffness * heading_error, lo, hi)
      cmd_z = torch.where(st["is_heading_env"], wz, cmd[:, 2])
      cmd = torch.cat([cmd[:, :2], cmd_z[:, None]], dim=-1)
    st["vel_command_b"] = torch.where(st["is_standing_env"][:, None], 0.0, cmd)

  def _update_metrics(self) -> None:
    st = self.state
    max_command_step = self.cfg.resampling_time_range[1] / self._env.step_dt
    data = self.robot.data
    st["metrics"]["error_vel_xy"] = st["metrics"]["error_vel_xy"] + (
      torch.linalg.vector_norm(
        st["vel_command_b"][:, :2] - data.root_link_lin_vel_b[:, :2], dim=-1
      ) / max_command_step
    )
    st["metrics"]["error_vel_yaw"] = st["metrics"]["error_vel_yaw"] + (
      torch.abs(st["vel_command_b"][:, 2] - data.root_link_ang_vel_b[:, 2])
      / max_command_step
    )


@dataclass(kw_only=True)
class UniformVelocityCommandCfg(CommandTermCfg):
  asset_name: str = "robot"
  heading_command: bool = False
  heading_control_stiffness: float = 1.0
  rel_standing_envs: float = 0.0
  rel_heading_envs: float = 1.0
  init_velocity_prob: float = 0.0
  class_type: type = UniformVelocityCommand

  @dataclass
  class Ranges:
    lin_vel_x: tuple[float, float]
    lin_vel_y: tuple[float, float]
    ang_vel_z: tuple[float, float]
    heading: tuple[float, float] | None = None

  ranges: Ranges = None  # type: ignore[assignment]

  def __post_init__(self):
    if self.heading_command and self.ranges.heading is None:
      raise ValueError("heading_command=True requires ranges.heading to be set.")
