"""Scene: binds a scene configuration to an already-compiled model (port of
mjlab_tpu/scene/scene.py).

The JAX package composes the terrain, entity and sensor MjSpecs into one
spec and compiles it. The port composes nothing: the model arrives
compiled — a live `mujoco.MjModel`, or on a host without `mujoco` the
namespace `assets.load_model_npz` reads from a committed npz
(`SceneCfg.model_file`). The Scene binds each configured entity to the
model's elements under its name prefix, builds the configured sensors,
wraps every sensor of the compiled model as a BuiltinSensor, takes the env
origins from its terrain importer, and fans out initialize/reset/update to
its elements. A generator terrain arrives generated in the npz, with its
tiles' origins (`terrain_origins`); its levels and types are the scene's
"terrain" state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mjlab_tpu_torch.entity import Entity, EntityCfg
from mjlab_tpu_torch.entity.entity import element_name
from mjlab_tpu_torch.sensors import BuiltinSensor, Sensor, SensorCfg
from mjlab_tpu_torch.terrains import TerrainImporter, TerrainImporterCfg


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


def _terrain_origins(cfg: TerrainImporterCfg, model):
  """The tiles' origins of a generator terrain, from the compiled scene,
  checked against the generator's grid; None for the plane."""
  if cfg.terrain_type == "plane":
    return None
  if cfg.terrain_type != "generator":
    raise ValueError(f"Unknown terrain type {cfg.terrain_type}")
  # The port cannot generate a terrain: the compiled scene must hold it,
  # generated on the configured grid.
  origins = getattr(model, "terrain_origins", None)
  if origins is None:
    raise NotImplementedError(
      "terrain generation (terrain_type 'generator') is not supported by "
      "mjlab_tpu_torch: the compiled scene holds no generated terrain "
      "(terrain_origins; see assets.save_model_npz)"
    )
  gen = cfg.terrain_generator
  grid = (gen.num_rows, gen.num_cols) if gen is not None else None
  if grid != tuple(origins.shape[:2]):
    raise NotImplementedError(
      f"terrain generation is not supported by mjlab_tpu_torch: the generator's "
      f"grid {grid} is not the compiled scene's {tuple(origins.shape[:2])}"
    )
  return np.asarray(origins, dtype=np.float64)


class Scene:
  def __init__(self, scene_cfg: SceneCfg, model) -> None:
    self._cfg = scene_cfg
    terrain = scene_cfg.terrain or TerrainImporterCfg()
    self._terrain = TerrainImporter(
      terrain, scene_cfg.num_envs, scene_cfg.env_spacing, _terrain_origins(terrain, model)
    )
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
    self.device: torch.device | None = None

  # -- attributes -----------------------------------------------------------

  @property
  def env_origins(self) -> torch.Tensor:
    """Each env's origin, static (the JAX package's; ROADMAP Queue C)."""
    assert self._terrain.env_origins is not None, "Scene not initialized."
    return self._terrain.env_origins

  @property
  def terrain(self) -> TerrainImporter:
    return self._terrain

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
    self._terrain.initialize(ctx)
    self.device = ctx.device
    for ent in self._entities.values():
      ent.initialize(ctx)
    for sensor in self._sensors.values():
      sensor.initialize(self._model, ctx)

  def init_state(self) -> dict:
    return {
      "sensors": {name: s.init_state() for name, s in self._sensors.items()},
      "terrain": self._terrain.init_state(),
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
