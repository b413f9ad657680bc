from mjlab_tpu_torch.managers.manager_term_config import (
  ActionTermCfg,
  CommandTermCfg,
  CurriculumTermCfg,
  EventTermCfg,
  ObservationGroupCfg,
  ObservationTermCfg,
  RewardTermCfg,
  TerminationTermCfg,
  term,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.managers.manager_base import ManagerBase, ManagerTermBase
from mjlab_tpu_torch.managers.action_manager import ActionManager, ActionTerm
from mjlab_tpu_torch.managers.observation_manager import ObservationManager
from mjlab_tpu_torch.managers.event_manager import EventManager
from mjlab_tpu_torch.managers.reward_manager import RewardManager
from mjlab_tpu_torch.managers.termination_manager import TerminationManager
from mjlab_tpu_torch.managers.command_manager import (
  CommandManager,
  CommandTerm,
  NullCommandManager,
)
from mjlab_tpu_torch.managers.curriculum_manager import (
  CurriculumManager,
  NullCurriculumManager,
)

__all__ = [
  "ActionManager",
  "ActionTerm",
  "ActionTermCfg",
  "CommandManager",
  "CommandTerm",
  "CommandTermCfg",
  "CurriculumManager",
  "CurriculumTermCfg",
  "EventManager",
  "EventTermCfg",
  "ManagerBase",
  "ManagerTermBase",
  "NullCommandManager",
  "NullCurriculumManager",
  "ObservationGroupCfg",
  "ObservationManager",
  "ObservationTermCfg",
  "RewardManager",
  "RewardTermCfg",
  "SceneEntityCfg",
  "TerminationManager",
  "TerminationTermCfg",
  "term",
]
