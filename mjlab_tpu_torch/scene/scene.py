"""Scene: binds a scene configuration to a compiled model (port of
mjlab_tpu/scene/scene.py).

The JAX package composes the terrain, entity and sensor MjSpecs into one
spec and compiles it. The port compiles nothing: the model arrives
compiled — a live `mujoco.MjModel`, or on a host without `mujoco` the
namespace `assets.load_model_npz` reads from a committed npz
(`SceneCfg.model_file`). A generator terrain is generated by the port
(terrains/terrain_generator.py) and put into the model file's scene, which
holds the robot on the plane terrain (`compose.compose_terrain`). The
Scene binds each configured entity to the model's elements under its name
prefix, builds the configured sensors, wraps every sensor of the compiled
model as a BuiltinSensor, takes the env origins from its terrain importer,
and fans out initialize/reset/update to its elements. A generator
terrain's levels and types are the scene's "terrain" state.
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
from mjlab_tpu_torch.terrains import TerrainGenerator, TerrainImporter, TerrainImporterCfg


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
  """The compiled scene of `cfg.model_file`; with a generator terrain, that
  scene (compiled with the plane terrain) with the generated terrain in
  place of the plane, and the tiles' origins."""
  from mjlab_tpu_torch.assets import load_model_arrays, model_namespace
  from mjlab_tpu_torch.scene.compose import compose_terrain

  if cfg.model_file is None:
    raise ValueError("SceneCfg.model_file is not set and no compiled model was given.")
  arrays = load_model_arrays(cfg.model_file)
  terrain = cfg.terrain
  if terrain is not None and terrain.terrain_type == "generator":
    return compose_terrain(arrays, _generate(terrain))
  return model_namespace(arrays)


def _generate(cfg: TerrainImporterCfg):
  if cfg.terrain_generator is None:
    raise ValueError("terrain_type 'generator' needs a terrain_generator cfg")
  return TerrainGenerator(cfg.terrain_generator).generate()


def _terrain_origins(cfg: TerrainImporterCfg, model):
  """The tiles' origins of a generator terrain (those the compiled scene
  carries, or else the generator's); None for the plane."""
  if cfg.terrain_type == "plane":
    return None
  if cfg.terrain_type != "generator":
    raise ValueError(f"Unknown terrain type {cfg.terrain_type}")
  origins = getattr(model, "terrain_origins", None)
  if origins is None:
    origins = _generate(cfg).terrain_origins
  gen = cfg.terrain_generator
  if gen is not None and (gen.num_rows, gen.num_cols) != tuple(origins.shape[:2]):
    raise ValueError(
      f"the generator's grid {(gen.num_rows, gen.num_cols)} is not the compiled "
      f"scene's {tuple(origins.shape[:2])}"
    )
  return np.asarray(origins, dtype=np.float64)


class Scene:
  def __init__(self, scene_cfg: SceneCfg, model, shard=None) -> None:
    """`shard` (sharding.EnvShard): a rank's share of a sharded run's envs,
    whose env origins are the unsharded run's rows."""
    self._cfg = scene_cfg
    terrain = scene_cfg.terrain or TerrainImporterCfg()
    self._terrain = TerrainImporter(
      terrain, scene_cfg.num_envs, scene_cfg.env_spacing, _terrain_origins(terrain, model),
      *((slice(shard.offset, shard.offset + shard.num_envs), shard.total) if shard else ()),
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
