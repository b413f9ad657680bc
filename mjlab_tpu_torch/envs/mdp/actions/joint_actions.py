"""Joint-space action terms (port of mjlab_tpu/envs/mdp/actions/
joint_actions.py). JointPositionAction: action → scale·action + offset →
PD position targets (ctrl), clipped to `cfg.clip` = (lo, hi) when set. The
scale may be a per-actuator regex dict."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mjlab_tpu_torch.core.strings import resolve_matching_names_values
from mjlab_tpu_torch.entity.data import device_index
from mjlab_tpu_torch.managers.action_manager import ActionTerm
from mjlab_tpu_torch.managers.manager_term_config import ActionTermCfg


@dataclass
class JointActionCfg(ActionTermCfg):
  actuator_names: tuple[str, ...] = (".*",)
  scale: float | dict[str, float] = 1.0
  offset: float | dict[str, float] = 0.0
  preserve_order: bool = False


@dataclass
class JointPositionActionCfg(JointActionCfg):
  use_default_offset: bool = True

  def __post_init__(self):
    self.class_type = JointPositionAction


class JointAction(ActionTerm):
  cfg: JointActionCfg

  def __init__(self, cfg: JointActionCfg, env):
    super().__init__(cfg, env)
    ids, self._actuator_names = self._asset.find_actuators(
      cfg.actuator_names, preserve_order=cfg.preserve_order
    )
    self._actuator_ids = np.asarray(ids, dtype=np.int64)
    self._ids = device_index(self._actuator_ids, env.device)
    n = len(self._actuator_ids)

    def resolve(value):
      if isinstance(value, dict):
        _, _, vals = resolve_matching_names_values(value, self._actuator_names)
      else:
        vals = [float(value)] * n
      return torch.as_tensor(np.asarray(vals, dtype=np.float64), dtype=env.dtype,
                             device=env.device)

    self._scale = resolve(cfg.scale)
    self._offset = resolve(cfg.offset)

  @property
  def action_dim(self) -> int:
    return len(self._actuator_ids)

  def init_state(self) -> dict:
    z = torch.zeros((self.num_envs, self.action_dim), dtype=self._env.dtype,
                    device=self._env.device)
    return {"raw": z, "processed": z}

  def process_actions(self, actions: torch.Tensor) -> None:
    processed = actions * self._scale + self._offset
    if self.cfg.clip is not None:
      processed = torch.clamp(processed, *self.cfg.clip)
    self.state = {"raw": actions, "processed": processed}

  @property
  def processed_actions(self) -> torch.Tensor:
    return self.state["processed"]

  def apply_actions(self) -> None:
    raise NotImplementedError

  def reset(self, env_mask=None) -> None:
    st = self.state
    if env_mask is None:
      self.state = {k: torch.zeros_like(v) for k, v in st.items()}
    else:
      m = env_mask[:, None]
      self.state = {k: torch.where(m, 0.0, v) for k, v in st.items()}


class JointPositionAction(JointAction):
  cfg: JointPositionActionCfg

  def __init__(self, cfg: JointPositionActionCfg, env):
    super().__init__(cfg, env)
    if cfg.use_default_offset:
      # Actuators are named after their joints, so the default joint
      # positions indexed by actuator order give the offsets.
      asset = self._asset
      joint_idx = [asset.joint_names.index(n) for n in self._actuator_names]
      self._offset = asset.data.default_joint_pos[0, joint_idx].clone()
    every = isinstance(self._ids, slice) and self._ids == slice(0, self._asset.num_actuators)
    self._ctrl_ids = None if every else self._ids

  def apply_actions(self) -> None:
    self._asset.write_joint_position_target_to_sim(
      self.state["processed"], joint_ids=self._ctrl_ids
    )
