"""RL configuration dataclasses (port of mjlab_tpu/rl/config.py).

The same typed surface over rsl_rl's names: actor-critic architecture, PPO
hyperparameters and on-policy runner settings. The JAX package's rollout
execution modes (`fused_rollout`, `rollout_chunk`, `epoch_chunk`,
`packed_hostloop`) exist only for its TPU relay and are not carried over:
the port's runner is one host loop of device work. Nor are the fields that
nothing in the port reads (the `class_name`s, `empirical_normalization`,
`run_name`, `logger`, `wandb_project`, `load_run`, `load_checkpoint`): the
port has no TensorBoard or wandb sink, and `--agent.resume` takes the newest
checkpoint of the log dir, as the JAX package's train script does, so
setting one would do nothing. An unknown field is rejected by the CLI's
`apply_overrides`. `save_interval` is read by `OnPolicyRunner.learn`: a
checkpoint every `save_interval` iterations (0: none before the end).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal


@dataclass
class PpoActorCriticCfg:
  init_noise_std: float = 1.0
  noise_std_type: Literal["scalar", "log"] = "scalar"
  actor_obs_normalization: bool = False
  critic_obs_normalization: bool = False
  actor_hidden_dims: tuple[int, ...] = (256, 256, 128)
  critic_hidden_dims: tuple[int, ...] = (256, 256, 128)
  activation: str = "elu"


@dataclass
class PpoAlgorithmCfg:
  num_learning_epochs: int = 5
  num_mini_batches: int = 4
  learning_rate: float = 1e-3
  schedule: Literal["adaptive", "fixed"] = "adaptive"
  gamma: float = 0.99
  lam: float = 0.95
  entropy_coef: float = 0.01
  desired_kl: float = 0.01
  max_grad_norm: float = 1.0
  value_loss_coef: float = 1.0
  use_clipped_value_loss: bool = True
  clip_param: float = 0.2
  normalize_advantage_per_mini_batch: bool = False


@dataclass
class RlOnPolicyRunnerCfg:
  seed: int = 42
  device: str = "cuda"
  num_steps_per_env: int = 24
  max_iterations: int = 30_000
  policy: PpoActorCriticCfg = field(default_factory=PpoActorCriticCfg)
  algorithm: PpoAlgorithmCfg = field(default_factory=PpoAlgorithmCfg)
  save_interval: int = 50
  experiment_name: str = "experiment"
  resume: bool = False
  clip_actions: float | None = None


# Reference-parity aliases (reference rl/config.py names).
RslRlPpoActorCriticCfg = PpoActorCriticCfg
RslRlPpoAlgorithmCfg = PpoAlgorithmCfg
RslRlOnPolicyRunnerCfg = RlOnPolicyRunnerCfg
