from mjlab_tpu_torch.envs.mdp import *  # noqa: F401, F403

from mjlab_tpu_torch.tasks.velocity.mdp.curriculums import *  # noqa: F401, F403
from mjlab_tpu_torch.tasks.velocity.mdp.observations import *  # noqa: F401, F403
from mjlab_tpu_torch.tasks.velocity.mdp.rewards import *  # noqa: F401, F403
from mjlab_tpu_torch.tasks.velocity.mdp.terminations import *  # noqa: F401, F403
from mjlab_tpu_torch.tasks.velocity.mdp.velocity_command import (  # noqa: F401
  UniformVelocityCommand,
  UniformVelocityCommandCfg,
)
