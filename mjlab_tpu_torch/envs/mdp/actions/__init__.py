from mjlab_tpu_torch.envs.mdp.actions.ankle_ab_action import (
  AnklePrToTendonAction,
  AnklePrToTendonActionCfg,
)
from mjlab_tpu_torch.envs.mdp.actions.joint_actions import (
  JointAction,
  JointActionCfg,
  JointPositionAction,
  JointPositionActionCfg,
)

__all__ = [
  "AnklePrToTendonAction",
  "AnklePrToTendonActionCfg",
  "JointAction",
  "JointActionCfg",
  "JointPositionAction",
  "JointPositionActionCfg",
]
