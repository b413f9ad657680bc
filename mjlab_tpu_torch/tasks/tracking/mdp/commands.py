"""Motion-imitation command (port of mjlab_tpu/tasks/tracking/mdp/commands.py,
BeyondMimic-style reference-motion tracking): per-env motion clocks indexing
an npz motion, anchor-relative retargeting of the desired body poses,
reference-state initialization (RSI) with pose, velocity and joint
perturbations, and adaptive failure-bin sampling (per-bin failure counts,
averaged over time and convolved with a decaying kernel).

Nothing here synchronizes with the host inside a step: the "anything
failed" test is a `torch.where` on a 0-d device bool, and the categorical
draw of a bin is an inverse CDF on the device (`cumsum` and `searchsorted`).
The adaptive sampler is split into its deterministic part
(`adaptive_sampling_probs`, `sampling_metrics`) and its draws
(`MotionCommand.draw_bins`, `MotionCommand.draw_rsi`), so that tests can
hand the JAX package's draws across. The viewer hook (`debug_vis`) is not
ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Literal

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.managers.command_manager import CommandTerm
from mjlab_tpu_torch.managers.manager_term_config import CommandTermCfg

_POSE_KEYS = ("x", "y", "z", "roll", "pitch", "yaw")


class MotionLoader:
  """A motion npz on the env's device: joint_pos and joint_vel (T, nj) and
  body_{pos,quat,lin_vel,ang_vel}_w (T, nbody, ·), the body arrays gathered
  to the tracked bodies (`body_indexes` into the file's body axis, which
  holds the entity's bodies in the entity's order)."""

  def __init__(self, motion_file: str, body_indexes: np.ndarray, dtype, device) -> None:
    with np.load(motion_file) as data:
      def load(key, bodies=False):
        a = np.asarray(data[key])
        return torch.as_tensor(a[:, body_indexes] if bodies else a).to(dtype=dtype,
                                                                      device=device)

      self.joint_pos = load("joint_pos")
      self.joint_vel = load("joint_vel")
      self.body_pos_w = load("body_pos_w", True)
      self.body_quat_w = load("body_quat_w", True)
      self.body_lin_vel_w = load("body_lin_vel_w", True)
      self.body_ang_vel_w = load("body_ang_vel_w", True)
    self.time_step_total = int(self.joint_pos.shape[0])


def adaptive_sampling_probs(
  bin_failed_count: torch.Tensor, uniform_ratio: float, kernel: torch.Tensor
) -> torch.Tensor:
  """Bin probabilities from the averaged failure counts: a uniform floor,
  a non-causal decaying kernel with replicate padding at the end, then
  normalization."""
  bin_count = bin_failed_count.shape[0]
  probs = bin_failed_count + uniform_ratio / float(bin_count)
  k = kernel.shape[0]
  if k > 1:
    padded = torch.cat([probs, probs[-1:].expand(k - 1)])
    windows = torch.stack([padded[i : i + bin_count] for i in range(k)])
    probs = torch.einsum("k,kb->b", kernel, windows)
  return probs / probs.sum()


def sampling_metrics(probs: torch.Tensor):
  """(normalized entropy, top-1 probability, top-1 bin / bin_count), 0-d."""
  bin_count = probs.shape[0]
  entropy = -torch.sum(probs * torch.log(probs + 1e-12)) / math.log(bin_count)
  top1_bin = torch.argmax(probs).to(probs.dtype) / bin_count
  return entropy, probs.max(), top1_bin


def time_steps_from_draws(bins, frac, bin_count: int, total: int) -> torch.Tensor:
  """Motion frames from sampled bins and in-bin fractions in [0, 1)."""
  return ((bins.to(frac.dtype) + frac) / bin_count * (total - 1)).to(torch.int32)


class MotionCommand(CommandTerm):
  cfg: "MotionCommandCfg"

  def __init__(self, cfg: "MotionCommandCfg", env):
    super().__init__(cfg, env)
    if not cfg.motion_file:
      raise ValueError(
        "MotionCommandCfg.motion_file is empty — pass a local motion npz via "
        "`train <Task> --motion-file <path.npz>` (produce one with "
        "mjlab_tpu_torch.scripts.csv_to_npz, or tasks.tracking.motions."
        "make_standing_motion for a synthetic test motion)."
      )
    self.robot = env.scene[cfg.asset_name]
    self.robot_anchor_body_index = self.robot.body_names.index(cfg.anchor_body_name)
    self.motion_anchor_body_index = cfg.body_names.index(cfg.anchor_body_name)
    body_ids, _ = self.robot.find_bodies(cfg.body_names, preserve_order=True)
    self.body_indexes = torch.as_tensor(np.asarray(body_ids), device=env.device)

    self.motion = MotionLoader(cfg.motion_file, np.asarray(body_ids), env.dtype, env.device)
    self.bin_count = int(self.motion.time_step_total // (1 / env.step_dt)) + 1
    kernel = np.array([cfg.adaptive_lambda**i for i in range(cfg.adaptive_kernel_size)])
    self.kernel = torch.as_tensor(kernel / kernel.sum(), dtype=env.dtype, device=env.device)

    def bounds(ranges: dict):
      lohi = np.array([ranges.get(k, (0.0, 0.0)) for k in _POSE_KEYS], dtype=np.float64)
      return tuple(torch.as_tensor(lohi[:, i], dtype=env.dtype, device=env.device)
                   for i in (0, 1))

    self._pose_bounds = bounds(cfg.pose_range)
    self._velocity_bounds = bounds(cfg.velocity_range)
    # The body subsets that reward and termination terms select by name,
    # indexed on the device from here on: built inside a step, an index
    # would be a copy from the host.
    self._subsets: dict = {}
    for terms in (env.cfg.rewards, env.cfg.terminations):
      for term in terms.values():
        if term is not None and term.params.get("body_names") is not None:
          self.body_subset(term.params["body_names"])

  def body_subset(self, body_names: tuple[str, ...] | None):
    """Index of the tracked bodies named in `body_names` (all when None):
    a slice, or an index tensor on the device built once per selection
    (at construction for the selections the env's cfg names)."""
    key = None if body_names is None else tuple(body_names)
    if key not in self._subsets:
      idx = [i for i, n in enumerate(self.cfg.body_names) if key is None or n in key]
      self._subsets[key] = (slice(None) if idx == list(range(len(self.cfg.body_names)))
                            else torch.as_tensor(idx, device=self._env.device))
    return self._subsets[key]

  # -- state ------------------------------------------------------------------

  def _init_term_state(self) -> dict:
    env, B = self._env, self.num_envs
    nb = len(self.cfg.body_names)
    quat0 = torch.zeros((B, nb, 4), dtype=env.dtype, device=env.device)
    quat0[..., 0] = 1.0
    return {
      "time_steps": torch.zeros(B, dtype=torch.int32, device=env.device),
      "body_pos_relative_w": torch.zeros((B, nb, 3), dtype=env.dtype, device=env.device),
      "body_quat_relative_w": quat0,
      "bin_failed_count": torch.zeros(self.bin_count, dtype=env.dtype, device=env.device),
      "current_bin_failed": torch.zeros(self.bin_count, dtype=env.dtype, device=env.device),
    }

  def _init_metrics(self) -> dict:
    env = self._env
    names = (
      "error_anchor_pos", "error_anchor_rot", "error_anchor_lin_vel",
      "error_anchor_ang_vel", "error_body_pos", "error_body_rot",
      "error_body_lin_vel", "error_body_ang_vel", "error_joint_pos",
      "error_joint_vel", "sampling_entropy", "sampling_top1_prob",
      "sampling_top1_bin",
    )
    return {n: torch.zeros(self.num_envs, dtype=env.dtype, device=env.device) for n in names}

  # -- motion-indexed getters ---------------------------------------------------

  @property
  def time_steps(self) -> torch.Tensor:
    return self.state["time_steps"]

  @property
  def _frame(self) -> torch.Tensor:
    return self.state["time_steps"].long()

  @property
  def command(self) -> torch.Tensor:
    return torch.cat([self.joint_pos, self.joint_vel], dim=1)

  @property
  def joint_pos(self):
    return self.motion.joint_pos[self._frame]

  @property
  def joint_vel(self):
    return self.motion.joint_vel[self._frame]

  @property
  def body_pos_w(self):
    return self.motion.body_pos_w[self._frame] + self._env.scene.env_origins[:, None, :]

  @property
  def body_quat_w(self):
    return self.motion.body_quat_w[self._frame]

  @property
  def body_lin_vel_w(self):
    return self.motion.body_lin_vel_w[self._frame]

  @property
  def body_ang_vel_w(self):
    return self.motion.body_ang_vel_w[self._frame]

  @property
  def anchor_pos_w(self):
    return (self.motion.body_pos_w[self._frame, self.motion_anchor_body_index]
            + self._env.scene.env_origins)

  @property
  def anchor_quat_w(self):
    return self.motion.body_quat_w[self._frame, self.motion_anchor_body_index]

  @property
  def anchor_lin_vel_w(self):
    return self.motion.body_lin_vel_w[self._frame, self.motion_anchor_body_index]

  @property
  def anchor_ang_vel_w(self):
    return self.motion.body_ang_vel_w[self._frame, self.motion_anchor_body_index]

  @property
  def body_pos_relative_w(self):
    return self.state["body_pos_relative_w"]

  @property
  def body_quat_relative_w(self):
    return self.state["body_quat_relative_w"]

  # -- robot-side getters ---------------------------------------------------------

  @property
  def robot_joint_pos(self):
    return self.robot.data.joint_pos

  @property
  def robot_joint_vel(self):
    return self.robot.data.joint_vel

  @property
  def robot_body_pos_w(self):
    return self.robot.data.body_link_pos_w[:, self.body_indexes]

  @property
  def robot_body_quat_w(self):
    return self.robot.data.body_link_quat_w[:, self.body_indexes]

  @property
  def robot_body_lin_vel_w(self):
    return self.robot.data.body_link_lin_vel_w[:, self.body_indexes]

  @property
  def robot_body_ang_vel_w(self):
    return self.robot.data.body_link_ang_vel_w[:, self.body_indexes]

  @property
  def robot_anchor_pos_w(self):
    return self.robot.data.body_link_pos_w[:, self.robot_anchor_body_index]

  @property
  def robot_anchor_quat_w(self):
    return self.robot.data.body_link_quat_w[:, self.robot_anchor_body_index]

  @property
  def robot_anchor_lin_vel_w(self):
    return self.robot.data.body_link_lin_vel_w[:, self.robot_anchor_body_index]

  @property
  def robot_anchor_ang_vel_w(self):
    return self.robot.data.body_link_ang_vel_w[:, self.robot_anchor_body_index]

  # -- draws --------------------------------------------------------------------

  def _rand(self, *shape) -> torch.Tensor:
    env = self._env
    return torch.rand(shape, generator=env.generator, dtype=env.dtype, device=env.device)

  def draw_bins(self, probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A bin per env from `probs` (the JAX package's categorical over
    log(probs + 1e-12), as an inverse CDF) and a fraction in [0, 1)."""
    cdf = torch.cumsum(probs + 1e-12, 0)
    u = self._rand(self.num_envs) * cdf[-1]
    bins = torch.clamp(torch.searchsorted(cdf, u, right=True), max=self.bin_count - 1)
    return bins, self._rand(self.num_envs)

  def draw_rsi(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit uniforms of reference-state initialization: pose (B, 6),
    velocity (B, 6) and joint positions (B, nj)."""
    return (self._rand(self.num_envs, 6), self._rand(self.num_envs, 6),
            self._rand(self.num_envs, self.motion.joint_pos.shape[1]))

  # -- lifecycle hooks ---------------------------------------------------------

  def _update_metrics(self) -> None:
    m = self.state["metrics"]

    def norm(x):
      return torch.linalg.vector_norm(x, dim=-1)

    m["error_anchor_pos"] = norm(self.anchor_pos_w - self.robot_anchor_pos_w)
    m["error_anchor_rot"] = mt.quat_error_magnitude(self.anchor_quat_w,
                                                    self.robot_anchor_quat_w)
    m["error_anchor_lin_vel"] = norm(self.anchor_lin_vel_w - self.robot_anchor_lin_vel_w)
    m["error_anchor_ang_vel"] = norm(self.anchor_ang_vel_w - self.robot_anchor_ang_vel_w)
    m["error_body_pos"] = norm(self.body_pos_relative_w - self.robot_body_pos_w).mean(-1)
    m["error_body_rot"] = mt.quat_error_magnitude(
      self.body_quat_relative_w, self.robot_body_quat_w).mean(-1)
    m["error_body_lin_vel"] = norm(self.body_lin_vel_w - self.robot_body_lin_vel_w).mean(-1)
    m["error_body_ang_vel"] = norm(self.body_ang_vel_w - self.robot_body_ang_vel_w).mean(-1)
    m["error_joint_pos"] = norm(self.joint_pos - self.robot_joint_pos)
    m["error_joint_vel"] = norm(self.joint_vel - self.robot_joint_vel)

  def _sample_time_steps(self, env_mask: torch.Tensor) -> torch.Tensor:
    """New per-env motion frames for the masked envs (mode-dependent)."""
    st, env = self.state, self._env
    m = st["metrics"]
    total = self.motion.time_step_total
    if self.cfg.sampling_mode == "start":
      return torch.zeros(self.num_envs, dtype=torch.int32, device=env.device)
    if self.cfg.sampling_mode == "uniform":
      m["sampling_entropy"] = torch.ones_like(m["sampling_entropy"])
      m["sampling_top1_prob"] = torch.full_like(m["sampling_top1_prob"], 1.0 / self.bin_count)
      m["sampling_top1_bin"] = torch.full_like(m["sampling_top1_bin"], 0.5)
      return torch.randint(0, total, (self.num_envs,), generator=env.generator,
                           device=env.device).to(torch.int32)

    # Adaptive: record the failure bins, only when something failed (the
    # reference overwrites on failure).
    failed = env.termination_manager.terminated & env_mask
    bin_idx = torch.clamp((st["time_steps"] * self.bin_count) // max(total, 1),
                          0, self.bin_count - 1)
    new_counts = torch.zeros(self.bin_count, dtype=env.dtype, device=env.device).scatter_add(
      0, bin_idx.long(), failed.to(env.dtype))
    st["current_bin_failed"] = torch.where(torch.any(failed), new_counts,
                                           st["current_bin_failed"])

    probs = adaptive_sampling_probs(st["bin_failed_count"], self.cfg.adaptive_uniform_ratio,
                                    self.kernel)
    bins, frac = self.draw_bins(probs)
    entropy, top1_prob, top1_bin = sampling_metrics(probs)
    zero = torch.zeros_like(m["sampling_entropy"])
    m["sampling_entropy"] = zero + entropy
    m["sampling_top1_prob"] = zero + top1_prob
    m["sampling_top1_bin"] = zero + top1_bin
    return time_steps_from_draws(bins, frac, self.bin_count, total)

  def _resample_command(self, env_mask: torch.Tensor) -> None:
    st = self.state
    new_steps = self._sample_time_steps(env_mask)
    st["time_steps"] = torch.where(env_mask, new_steps, st["time_steps"])

    # Reference-state initialization with perturbations.
    pose_u, vel_u, joint_u = self.draw_rsi()
    lo, hi = self._pose_bounds
    pose = lo + (hi - lo) * pose_u
    root_pos = self.body_pos_w[:, 0] + pose[:, 0:3]
    ori_delta = mt.quat_from_euler_xyz(pose[:, 3], pose[:, 4], pose[:, 5])
    root_ori = mt.quat_mul(ori_delta, self.body_quat_w[:, 0])
    lo, hi = self._velocity_bounds
    vel = lo + (hi - lo) * vel_u
    root_lin_vel = self.body_lin_vel_w[:, 0] + vel[:, :3]
    root_ang_vel = self.body_ang_vel_w[:, 0] + vel[:, 3:]

    lo, hi = self.cfg.joint_position_range
    joint_pos = self.joint_pos + (lo + (hi - lo) * joint_u)
    soft = self.robot.data.soft_joint_pos_limits
    joint_pos = torch.clamp(joint_pos, soft[..., 0], soft[..., 1])
    self.robot.write_joint_state_to_sim(joint_pos, self.joint_vel, env_mask=env_mask)
    root_state = torch.cat([root_pos, root_ori, root_lin_vel, root_ang_vel], dim=-1)
    self.robot.write_root_state_to_sim(root_state, env_mask=env_mask)
    self.robot.clear_state(env_mask=env_mask)

  def _update_command(self) -> None:
    st = self.state
    st["time_steps"] = st["time_steps"] + 1
    finished = st["time_steps"] >= self.motion.time_step_total
    self._resample_command(finished)

    # Anchor-relative retargeting: the desired body poses at the robot's
    # anchor xy and yaw and the motion's anchor z.
    anchor_pos, anchor_quat = self.anchor_pos_w, self.anchor_quat_w
    r_anchor_pos, r_anchor_quat = self.robot_anchor_pos_w, self.robot_anchor_quat_w
    delta_pos = torch.cat([r_anchor_pos[:, :2], anchor_pos[:, 2:3]], dim=-1)[:, None, :]
    delta_ori = mt.yaw_quat(mt.quat_mul(r_anchor_quat, mt.quat_inv(anchor_quat)))
    delta_ori = delta_ori[:, None, :].expand(-1, len(self.cfg.body_names), -1)
    st["body_quat_relative_w"] = mt.quat_mul(delta_ori, self.body_quat_w)
    st["body_pos_relative_w"] = delta_pos + mt.quat_apply(
      delta_ori, self.body_pos_w - anchor_pos[:, None, :]
    )

    if self.cfg.sampling_mode == "adaptive":
      a = self.cfg.adaptive_alpha
      st["bin_failed_count"] = a * st["current_bin_failed"] + (1 - a) * st["bin_failed_count"]
      st["current_bin_failed"] = torch.zeros_like(st["current_bin_failed"])


@dataclass(kw_only=True)
class MotionCommandCfg(CommandTermCfg):
  motion_file: str = ""
  anchor_body_name: str = ""
  body_names: tuple[str, ...] = ()
  asset_name: str = "robot"
  class_type: type = MotionCommand
  pose_range: dict[str, tuple[float, float]] = field(default_factory=dict)
  velocity_range: dict[str, tuple[float, float]] = field(default_factory=dict)
  joint_position_range: tuple[float, float] = (-0.52, 0.52)
  adaptive_kernel_size: int = 1
  adaptive_lambda: float = 0.8
  adaptive_uniform_ratio: float = 0.1
  adaptive_alpha: float = 0.001
  sampling_mode: Literal["adaptive", "uniform", "start"] = "adaptive"
