from mjlab_tpu_torch.envs.manager_based_env import (
  EnvState,
  ManagerBasedEnv,
  ManagerBasedEnvCfg,
  env_state_from_arrays,
  env_state_to_arrays,
)
from mjlab_tpu_torch.envs.manager_based_rl_env import (
  ManagerBasedRlEnv,
  ManagerBasedRlEnvCfg,
)

__all__ = [
  "EnvState",
  "ManagerBasedEnv",
  "ManagerBasedEnvCfg",
  "ManagerBasedRlEnv",
  "ManagerBasedRlEnvCfg",
  "env_state_from_arrays",
  "env_state_to_arrays",
]
