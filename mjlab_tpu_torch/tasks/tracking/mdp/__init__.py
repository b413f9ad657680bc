from mjlab_tpu_torch.envs.mdp import *  # noqa: F401, F403

from mjlab_tpu_torch.tasks.tracking.mdp.commands import (  # noqa: F401
  MotionCommand,
  MotionCommandCfg,
  MotionLoader,
)
from mjlab_tpu_torch.tasks.tracking.mdp.observations import *  # noqa: F401, F403
from mjlab_tpu_torch.tasks.tracking.mdp.rewards import *  # noqa: F401, F403
from mjlab_tpu_torch.tasks.tracking.mdp.terminations import *  # noqa: F401, F403

# The velocity task's self-collision cost is shared.
from mjlab_tpu_torch.tasks.velocity.mdp.rewards import self_collision_cost  # noqa: F401
