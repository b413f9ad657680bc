"""Manager-based environment (port of mjlab_tpu/envs/manager_based_env.py).

The env holds its state as tensors on one device: the batched physics
`Data`, the Model (whose domain-randomized leaves carry an env axis), the
episode counters and one namespace dict per manager (`ns(name)`). Managers,
terms, entities and sensors read and write that state through the env.
`EnvState` names the state as the JAX package's EnvState does (`data`,
`model`, `episode_length`, `common_step_counter`, `ms/<manager>/...`), and
`env_state_to_arrays` / `env_state_from_arrays` carry it across by name.

Every random draw comes from one `torch.Generator` on the env's device,
seeded from `cfg.seed` (42 when unset) or `reset(seed=...)`. An env given a
`shard` (distributed.EnvShard) is one rank's share of a sharded run: its
per-env draws are the global batch's rows (sharding.env_rows), its env
origins the unsharded run's, and the reductions over envs that its state
depends on are taken over ranks.

The build order is the JAX package's: scene, simulation, forward, scene
initialize, managers, per-env model leaves for domain randomization,
startup events, forward.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from mjlab_tpu_torch import physics
from mjlab_tpu_torch.distributed.sharding import shard_generator
from mjlab_tpu_torch.managers.action_manager import ActionManager
from mjlab_tpu_torch.managers.event_manager import EventManager
from mjlab_tpu_torch.managers.manager_term_config import (
  ActionTermCfg,
  EventTermCfg,
  ObservationGroupCfg,
)
from mjlab_tpu_torch.managers.observation_manager import ObservationManager
from mjlab_tpu_torch.physics import constraint
from mjlab_tpu_torch.physics import io as physics_io
from mjlab_tpu_torch.scene import Scene, SceneCfg
from mjlab_tpu_torch.scene.scene import load_compiled_model
from mjlab_tpu_torch.sim import Simulation, SimulationCfg


@dataclass
class EnvState:
  """The env's state, named as the JAX package's EnvState (its PRNG key
  aside: the port's draws come from the env's torch.Generator)."""

  data: physics.Data  # batched (B, ...)
  model: dict  # the per-env Model leaves only ({} without domain randomization)
  episode_length: torch.Tensor  # (B,) int32
  common_step_counter: torch.Tensor  # () int32
  ms: dict  # manager namespaces (nested dicts of tensors)


@dataclass(kw_only=True)
class ManagerBasedEnvCfg:
  decimation: int
  scene: SceneCfg
  observations: dict[str, ObservationGroupCfg]
  actions: dict[str, ActionTermCfg]
  events: dict[str, EventTermCfg] = field(default_factory=dict)
  sim: SimulationCfg = field(default_factory=SimulationCfg)
  seed: int | None = None


class ManagerBasedEnv:
  cfg: ManagerBasedEnvCfg

  def __init__(self, cfg: ManagerBasedEnvCfg, device=None, model=None, shard=None):
    """Build on `device` (CUDA unless the caller asks for another) from the
    compiled `model` (a live MjModel or an npz namespace), or from the npz
    that `cfg.scene.model_file` names; with `shard`, as that rank's share of
    a sharded run (cfg.scene.num_envs is the rank's)."""
    self.cfg = cfg
    self.device = (
      torch.device(device) if device is not None else physics_io.default_device()
    )
    if shard is not None and shard.num_envs != cfg.scene.num_envs:
      raise ValueError(f"shard of {shard.num_envs} envs for an env of {cfg.scene.num_envs}")
    self.shard = shard
    self.step_log: dict = {}
    if model is None:
      model = load_compiled_model(cfg.scene)

    self.scene = Scene(cfg.scene, model, shard)
    self.sim = Simulation(cfg.scene.num_envs, cfg.sim, model, self.device)
    self.tp = self.sim.tp
    self.dtype = self.sim.model.qpos0.dtype

    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(cfg.seed if cfg.seed is not None else 42)
    if shard is not None:
      shard_generator(self.generator, shard)
    self._model = self.sim.model
    self._data = self.sim.make_data()
    self._ms: dict[str, dict] = {}
    self._episode_length = torch.zeros(self.num_envs, dtype=torch.int32, device=self.device)
    self._common_step_counter = torch.zeros((), dtype=torch.int32, device=self.device)

    # Derived quantities once, so that managers can infer shapes.
    self._data = self.forward_physics(self._data)

    self.scene.initialize(self)
    self._ms["scene"] = self.scene.init_state()

    self.load_managers()

    dr_fields = tuple(sorted(self.event_manager.domain_randomization_fields))
    if dr_fields:
      self.sim.expand_model_fields(dr_fields)
      self._model = self.sim.model
    if "startup" in self.event_manager.available_modes:
      self.event_manager.apply(mode="startup")
      self._data = self.forward_physics(self._data)

  # -- context protocol (used by managers, terms, entities, sensors) ----------

  @property
  def num_envs(self) -> int:
    return self.cfg.scene.num_envs

  @property
  def physics_dt(self) -> float:
    return float(self.cfg.sim.mujoco.timestep)

  @property
  def step_dt(self) -> float:
    return float(self.cfg.sim.mujoco.timestep * self.cfg.decimation)

  @property
  def data(self) -> physics.Data:
    return self._data

  @data.setter
  def data(self, value: physics.Data) -> None:
    self._data = value

  @property
  def model(self) -> physics.Model:
    return self._model

  @model.setter
  def model(self, value: physics.Model) -> None:
    self._model = value

  @property
  def unbatched_model(self) -> physics.Model:
    if not self.sim.batched_fields:
      return self._model
    return dataclasses.replace(
      self._model, **{f: getattr(self._model, f)[0] for f in self.sim.batched_fields}
    )

  def ns(self, name: str) -> dict:
    return self._ms.setdefault(name, {})

  def contact_forces(self) -> torch.Tensor:
    """(B, C, 6) contact-frame wrenches (force + torque) for all slots."""
    return constraint.contact_forces(self.tp, self._model, self._data)

  @property
  def episode_length_buf(self) -> torch.Tensor:
    return self._episode_length

  @property
  def common_step_counter(self) -> torch.Tensor:
    return self._common_step_counter

  # -- physics -----------------------------------------------------------------

  def step_physics(self, d: physics.Data) -> physics.Data:
    return physics.step(self.tp, self._model, d)

  def forward_physics(self, d: physics.Data) -> physics.Data:
    return physics.forward(self.tp, self._model, d)

  # -- managers ----------------------------------------------------------------

  def load_managers(self) -> None:
    self.event_manager = EventManager(self.cfg.events, self)
    self.action_manager = ActionManager(self.cfg.actions, self)
    self.observation_manager = ObservationManager(self.cfg.observations, self)

  def close(self) -> None:
    pass

  # -- state -------------------------------------------------------------------

  @property
  def state(self) -> EnvState:
    return EnvState(
      data=self._data,
      model={f: getattr(self._model, f) for f in sorted(self.sim.batched_fields)},
      episode_length=self._episode_length,
      common_step_counter=self._common_step_counter,
      ms=self._ms,
    )


# ---------------------------------------------------------------------------
# Carrying state across: flat {name: numpy array} dicts ⇄ the env's state.
# ---------------------------------------------------------------------------


def _flatten(prefix: str, tree: dict, out: dict) -> None:
  for k, v in tree.items():
    key = f"{prefix}/{k}"
    if isinstance(v, dict):
      _flatten(key, v, out)
    else:
      out[key] = v


def env_state_to_arrays(env: ManagerBasedEnv) -> dict[str, np.ndarray]:
  """The env's state by name: `data.<field>` (`data.contact.<field>`),
  `model.<field>` for the per-env leaves, `episode_length`,
  `common_step_counter` and `ms/<manager>/<key>/...`."""
  st = env.state
  leaves: dict[str, Any] = {
    f"data.{k}": v for k, v in physics_io._data_leaves(st.data).items()
  }
  leaves.update({f"model.{k}": v for k, v in st.model.items()})
  leaves["episode_length"] = st.episode_length
  leaves["common_step_counter"] = st.common_step_counter
  _flatten("ms", st.ms, leaves)
  return {k: v.detach().cpu().numpy() for k, v in leaves.items()}


def env_state_from_arrays(env: ManagerBasedEnv, arrays: dict[str, np.ndarray]) -> None:
  """Set the env's state from arrays named as `env_state_to_arrays` names
  them. Data fields missing from `arrays` keep their values (the JAX
  package's EnvState carries no derived fields; the next physics call
  writes them before any read). Every per-env model leaf, counter and
  manager leaf must be present."""

  def like(ref: torch.Tensor, x) -> torch.Tensor:
    return torch.tensor(np.array(x)).to(dtype=ref.dtype, device=ref.device)

  d = env.data
  contact = d.contact
  kw = {}
  for f in dataclasses.fields(d):
    if f.name == "contact":
      ckw = {g.name: like(getattr(contact, g.name), arrays[f"data.contact.{g.name}"])
             for g in dataclasses.fields(contact) if f"data.contact.{g.name}" in arrays}
      kw["contact"] = dataclasses.replace(contact, **ckw)
    elif f"data.{f.name}" in arrays:
      kw[f.name] = like(getattr(d, f.name), arrays[f"data.{f.name}"])
  env.data = d.replace(**kw)
  env.model = dataclasses.replace(env.model, **{
    f: like(getattr(env.model, f), arrays[f"model.{f}"]) for f in env.sim.batched_fields
  })
  env._episode_length = like(env._episode_length, arrays["episode_length"])
  env._common_step_counter = like(env._common_step_counter, arrays["common_step_counter"])

  def fill(prefix: str, tree: dict) -> None:
    for k, v in tree.items():
      key = f"{prefix}/{k}"
      if isinstance(v, dict):
        fill(key, v)
      else:
        tree[k] = like(v, arrays[key])

  fill("ms", env._ms)
