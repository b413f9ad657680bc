from mjlab_tpu_torch.envs.mdp.actions.joint_actions import (
  JointAction,
  JointActionCfg,
  JointPositionAction,
  JointPositionActionCfg,
)

__all__ = [
  "JointAction",
  "JointActionCfg",
  "JointPositionAction",
  "JointPositionActionCfg",
]
