"""Go1 velocity PPO hyperparameters (port of
mjlab_tpu/tasks/velocity/config/go1/rl_cfg.py; reference
tasks/velocity/config/go1/rl_cfg.py)."""

from dataclasses import dataclass, field

from mjlab_tpu_torch.rl import PpoActorCriticCfg, PpoAlgorithmCfg, RlOnPolicyRunnerCfg


@dataclass
class UnitreeGo1PPORunnerCfg(RlOnPolicyRunnerCfg):
  policy: PpoActorCriticCfg = field(
    default_factory=lambda: PpoActorCriticCfg(
      init_noise_std=1.0,
      actor_obs_normalization=False,
      critic_obs_normalization=False,
      actor_hidden_dims=(512, 256, 128),
      critic_hidden_dims=(512, 256, 128),
      activation="elu",
    )
  )
  algorithm: PpoAlgorithmCfg = field(
    default_factory=lambda: PpoAlgorithmCfg(
      value_loss_coef=1.0,
      use_clipped_value_loss=True,
      clip_param=0.2,
      entropy_coef=0.01,
      num_learning_epochs=5,
      num_mini_batches=4,
      learning_rate=1.0e-3,
      schedule="adaptive",
      gamma=0.99,
      lam=0.95,
      desired_kl=0.01,
      max_grad_norm=1.0,
    )
  )
  experiment_name: str = "go1_velocity"
  save_interval: int = 50
  num_steps_per_env: int = 24
  max_iterations: int = 30_000
