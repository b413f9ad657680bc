from mjlab_tpu_torch.envs.mdp.observations import *  # noqa: F401,F403
from mjlab_tpu_torch.envs.mdp.rewards import *  # noqa: F401,F403
from mjlab_tpu_torch.envs.mdp.terminations import *  # noqa: F401,F403
from mjlab_tpu_torch.envs.mdp.events import *  # noqa: F401,F403
from mjlab_tpu_torch.envs.mdp.actions import *  # noqa: F401,F403
