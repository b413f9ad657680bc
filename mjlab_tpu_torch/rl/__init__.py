"""PPO learner of the port (mjlab_tpu/rl/ in PyTorch): config, networks,
PPO, the vec-env wrapper, the on-policy runner and the policy exporter."""

from mjlab_tpu_torch.rl.config import (  # noqa: F401
  PpoActorCriticCfg,
  PpoAlgorithmCfg,
  RlOnPolicyRunnerCfg,
  RslRlOnPolicyRunnerCfg,
  RslRlPpoActorCriticCfg,
  RslRlPpoAlgorithmCfg,
)
