"""Parallel-ankle pitch/roll → A/B tendon action term (port of
mjlab_tpu/envs/mdp/actions/ankle_ab_action.py).

The Asimov-Toe robot's ankles are driven by two tendon position actuators
per foot. Policy actions are [left_pitch, left_roll, right_pitch,
right_roll]; the linearized linkage maps them to tendon length targets

  left_A  = -L·θL - d·φL    left_B  = -L·θL + d·φL
  right_A = +L·θR - d·φR    right_B = +L·θR + d·φR

(the right pitch's sign flips: its joint axis is mirrored in the XML).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mjlab_tpu_torch.core.strings import resolve_matching_names_values
from mjlab_tpu_torch.entity.data import device_index
from mjlab_tpu_torch.managers.action_manager import ActionTerm
from mjlab_tpu_torch.managers.manager_term_config import ActionTermCfg


class AnklePrToTendonAction(ActionTerm):
  cfg: "AnklePrToTendonActionCfg"

  def __init__(self, cfg: "AnklePrToTendonActionCfg", env):
    super().__init__(cfg, env)
    asset = self._asset
    joint_names = [
      cfg.left_pitch_joint,
      cfg.left_roll_joint,
      cfg.right_pitch_joint,
      cfg.right_roll_joint,
    ]
    joint_ids, _ = asset.find_joints(joint_names, preserve_order=True)
    actuator_ids, _ = asset.find_actuators(
      [cfg.left_tendon_A, cfg.left_tendon_B, cfg.right_tendon_A,
       cfg.right_tendon_B],
      preserve_order=True,
    )
    self._ctrl_ids = device_index(actuator_ids, env.device)

    def resolve(value, default):
      if isinstance(value, dict):
        idx, _, vals = resolve_matching_names_values(
          value, joint_names, preserve_order=True
        )
        out = np.full((4,), default, dtype=np.float64)
        out[idx] = vals
      else:
        out = np.full((4,), float(value), dtype=np.float64)
      return torch.as_tensor(out, dtype=env.dtype, device=env.device)

    self._scale = resolve(cfg.scale, 1.0)
    self._offset = resolve(cfg.offset, 0.0)
    if cfg.use_default_offset:
      self._offset = asset.data.default_joint_pos[0, list(joint_ids)].clone()

  @property
  def action_dim(self) -> int:
    return 4

  def init_state(self) -> dict:
    z = torch.zeros((self.num_envs, 4), dtype=self._env.dtype, device=self._env.device)
    return {"raw": z, "processed": z}

  @property
  def processed_actions(self) -> torch.Tensor:
    return self.state["processed"]

  def process_actions(self, actions: torch.Tensor) -> None:
    processed = actions * self._scale + self._offset
    if self.cfg.clip is not None:
      processed = torch.clamp(processed, *self.cfg.clip)
    self.state = {"raw": actions, "processed": processed}

  def apply_actions(self) -> None:
    pr = self.state["processed"]
    theta_l, phi_l, theta_r, phi_r = pr.unbind(-1)
    L, d = float(self.cfg.L), float(self.cfg.d)
    targets = torch.stack(
      [
        -L * theta_l - d * phi_l,
        -L * theta_l + d * phi_l,
        +L * theta_r - d * phi_r,
        +L * theta_r + d * phi_r,
      ],
      dim=1,
    )
    self._asset.write_ctrl_to_sim(targets, ctrl_ids=self._ctrl_ids)

  def reset(self, env_mask=None) -> None:
    st = self.state
    if env_mask is None:
      self.state = {k: torch.zeros_like(v) for k, v in st.items()}
    else:
      m = env_mask[:, None]
      self.state = {k: torch.where(m, 0.0, v) for k, v in st.items()}


@dataclass
class AnklePrToTendonActionCfg(ActionTermCfg):
  """Inputs [left_pitch, left_roll, right_pitch, right_roll] → tendon
  targets [left_A, left_B, right_A, right_B]."""

  left_pitch_joint: str = "left_ankle_pitch_joint"
  left_roll_joint: str = "left_ankle_roll_joint"
  right_pitch_joint: str = "right_ankle_pitch_joint"
  right_roll_joint: str = "right_ankle_roll_joint"

  left_tendon_A: str = "left_ankle_A"
  left_tendon_B: str = "left_ankle_B"
  right_tendon_A: str = "right_ankle_A"
  right_tendon_B: str = "right_ankle_B"

  scale: float | dict[str, float] = 1.0
  offset: float | dict[str, float] = 0.0
  use_default_offset: bool = False

  L: float = 1.0
  d: float = 1.0

  def __post_init__(self):
    self.class_type = AnklePrToTendonAction
