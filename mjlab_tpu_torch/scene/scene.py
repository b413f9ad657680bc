"""Scene: binds a scene configuration to an already-compiled model (port of
mjlab_tpu/scene/scene.py).

The JAX package composes the terrain, entity and sensor MjSpecs into one
spec and compiles it. The port composes nothing: the model arrives
compiled — a live `mujoco.MjModel`, or on a host without `mujoco` the
namespace `assets.load_model_npz` reads from a committed npz
(`SceneCfg.model_file`). The Scene binds each configured entity to the
model's elements under its name prefix, builds the configured sensors,
wraps every sensor of the compiled model as a BuiltinSensor, keeps the grid
env origins, and fans out initialize/reset/update to its elements. Only the
plane terrain is supported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Literal

import numpy as np
import torch

from mjlab_tpu_torch.entity import Entity, EntityCfg
from mjlab_tpu_torch.entity.entity import element_name
from mjlab_tpu_torch.sensors import BuiltinSensor, Sensor, SensorCfg


@dataclass
class TerrainImporterCfg:
  """Terrain (the JAX package's terrains/terrain_importer.py); the port has
  the plane only, which the compiled model already holds."""

  terrain_type: Literal["plane", "generator"] = "plane"


@dataclass(kw_only=True)
class SceneCfg:
  num_envs: int = 1
  env_spacing: float = 2.0
  terrain: TerrainImporterCfg | None = None
  entities: dict[str, EntityCfg] = field(default_factory=dict)
  sensors: tuple[SensorCfg, ...] = field(default_factory=tuple)
  # The compiled scene as an npz (assets.save_model_npz), used when the env
  # is not handed a compiled model.
  model_file: str | Path | None = None


def load_compiled_model(cfg: SceneCfg):
  from mjlab_tpu_torch.assets import load_model_npz

  if cfg.model_file is None:
    raise ValueError("SceneCfg.model_file is not set and no compiled model was given.")
  return load_model_npz(cfg.model_file)


class Scene:
  def __init__(self, scene_cfg: SceneCfg, model) -> None:
    terrain = scene_cfg.terrain
    if terrain is not None and terrain.terrain_type != "plane":
      raise NotImplementedError(
        f"terrain_type '{terrain.terrain_type}' is not supported by mjlab_tpu_torch "
        "(plane only)"
      )
    self._cfg = scene_cfg
    self._model = model
    self._entities: dict[str, Entity] = {
      name: Entity(cfg, name, model) for name, cfg in scene_cfg.entities.items()
    }
    self._sensors: dict[str, Sensor] = {}
    for sensor_cfg in scene_cfg.sensors:
      self._sensors[sensor_cfg.name] = sensor_cfg.build()
    for i in range(model.nsensor):
      name = element_name(model, model.name_sensoradr, i)
      if name not in self._sensors:
        self._sensors[name] = BuiltinSensor.from_existing(name)
    self._env_origins: torch.Tensor | None = None
    self.device: torch.device | None = None

  # -- attributes -----------------------------------------------------------

  @property
  def env_origins(self) -> torch.Tensor:
    assert self._env_origins is not None, "Scene not initialized."
    return self._env_origins

  @property
  def entities(self) -> dict[str, Entity]:
    return self._entities

  @property
  def sensors(self) -> dict[str, Sensor]:
    return self._sensors

  def __getitem__(self, key: str) -> Any:
    if key in self._sensors:
      return self._sensors[key]
    if key in self._entities:
      return self._entities[key]
    available = list(self._entities) + list(self._sensors)
    raise KeyError(f"Scene element '{key}' not found. Available: {available}")

  # -- lifecycle -------------------------------------------------------------

  def initialize(self, ctx) -> None:
    # Grid origins from spacing (the JAX package's terrain importer for a
    # plane, terrain_importer.py:80-86).
    n = self._cfg.num_envs
    side = int(np.ceil(np.sqrt(n)))
    ii, jj = np.unravel_index(np.arange(n), (side, side))
    origins = np.zeros((n, 3))
    origins[:, 0] = (ii - (side - 1) / 2) * self._cfg.env_spacing
    origins[:, 1] = (jj - (side - 1) / 2) * self._cfg.env_spacing
    self._env_origins = torch.as_tensor(origins, dtype=ctx.dtype, device=ctx.device)
    self.device = ctx.device
    for ent in self._entities.values():
      ent.initialize(ctx)
    for sensor in self._sensors.values():
      sensor.initialize(self._model, ctx)

  def init_state(self) -> dict:
    return {
      "sensors": {name: s.init_state() for name, s in self._sensors.items()},
      "terrain": {},
    }

  def reset(self, env_mask=None) -> None:
    for ent in self._entities.values():
      ent.reset(env_mask)
    for sensor in self._sensors.values():
      sensor.reset(env_mask)

  def update(self, dt: float) -> None:
    for ent in self._entities.values():
      ent.update(dt)
    for sensor in self._sensors.values():
      sensor.update(dt)

  def write_data_to_sim(self) -> None:
    for ent in self._entities.values():
      ent.write_data_to_sim()
