"""Term-configuration dataclasses for all managers (port of
mjlab_tpu/managers/manager_term_config.py). Terms are functions
`func(env, **params) -> torch.Tensor` or ManagerTermBase subclasses for
stateful terms. The observation pipeline is compute → noise → clip →
scale → delay → history (observation_manager.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from mjlab_tpu_torch.utils.noise import NoiseCfg, NoiseModelCfg


def term(cls, /, **changes):
  """Field helper: `x: TermCfg = term(TermCfg, func=..., params=...)`."""
  return field(default_factory=lambda: cls(**changes))


@dataclass
class ManagerTermBaseCfg:
  func: Callable = None  # type: ignore[assignment]
  params: dict[str, Any] = field(default_factory=dict)


@dataclass
class ActionTermCfg:
  class_type: type | None = None
  asset_name: str = ""
  clip: dict[str, tuple] | None = None


@dataclass
class ObservationTermCfg(ManagerTermBaseCfg):
  noise: NoiseCfg | NoiseModelCfg | None = None
  clip: tuple[float, float] | None = None
  scale: float | tuple[float, ...] | None = None
  # Stochastic sensor delay (utils/buffers.DelayBuffer).
  delay_min_lag: int = 0
  delay_max_lag: int = 0
  delay_per_env: bool = True
  delay_hold_prob: float = 0.0
  delay_update_period: int = 0
  delay_per_env_phase: bool = True
  # History (utils/buffers.CircularBuffer).
  history_length: int = 0
  flatten_history_dim: bool = True


@dataclass
class ObservationGroupCfg:
  terms: dict[str, ObservationTermCfg] = field(default_factory=dict)
  concatenate_terms: bool = True
  enable_corruption: bool = False
  # When set, overrides every term's history_length and flatten_history_dim.
  history_length: int | None = None
  flatten_history_dim: bool = True


@dataclass
class EventTermCfg(ManagerTermBaseCfg):
  mode: str = "reset"  # "startup" | "reset" | "interval"
  interval_range_s: tuple[float, float] | None = None
  min_step_count_between_reset: int = 0
  domain_randomization: bool = False


@dataclass
class RewardTermCfg(ManagerTermBaseCfg):
  weight: float = 0.0


@dataclass
class TerminationTermCfg(ManagerTermBaseCfg):
  time_out: bool = False


@dataclass
class CurriculumTermCfg(ManagerTermBaseCfg):
  pass


@dataclass
class CommandTermCfg:
  class_type: type | None = None
  resampling_time_range: tuple[float, float] = (10.0, 10.0)
