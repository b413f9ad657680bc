"""Compiled scenes as data files, for hosts without `mujoco`.

The GPU host has no `mujoco`, so the port cannot compile MJCF there. A scene
is compiled once with MuJoCo (through the JAX package's scene layer) and its
arrays are committed as an npz: the ndarray fields of the MjModel that the
port reads, its `n*` sizes, `names`, and the numeric `opt` fields.
`load_model_npz` returns a namespace with MjModel's attribute names, which
`physics.put_model` and `sim.Simulation` accept like a live MjModel.

The mesh arrays (`mesh_*`: vertices, faces, normals, texture coordinates,
polygons, the qhull graph) and the bounding-volume hierarchy (`bvh_*`) are
left out: they are most of a mesh scene's bytes and the port reads none of
them. In their place each mesh geom that collides (in a collision pair or
against a terrain pool) keeps the vertices of its convex hull (`geom_hull_vert`, addressed per geom by
`geom_hull_vertadr` / `geom_hull_vertnum`, -1 / 0 for other geoms), from
which `physics.put_model` builds the hull.

A scene with a generated terrain holds one more array, `terrain_origins`
(num_rows, num_cols, 3): the tiles' spawn origins, which the terrain
generator records beside the geoms (`save_model_npz(m, path,
terrain_origins=...)`).

The scenes, each a velocity task's with the task's solver options applied
(tests/test_torch_model_io.py, tests/test_torch_asimov_model.py,
tests/test_torch_terrain_model.py, tests/test_torch_go1_model.py and
tests/test_torch_rough_models.py check that each is fresh, and say how to
regenerate it): the flat scenes `g1_velocity_flat.npz`
(Mjlab-Velocity-Flat-Unitree-G1), `go1_velocity_flat.npz`,
`asimov_velocity_flat.npz` and `asimov_toe_velocity_flat.npz`, which the
rough tasks also load: the port generates their terrain and composes it
into the flat scene (scene/compose.py). The JAX package's compiles of the
rough scenes are kept beside them as the oracle of that composition on a
host without `mujoco`: `<robot>_velocity_rough.npz` (the default 10 x 20
tiles) and `<robot>_velocity_rough_play.npz` (the play overrides' 3 x 3
tiles, no curriculum), for g1, go1, asimov and asimov_toe.
`cartpole.npz` is the CartPole tutorial's scene
(docs/CREATE_NEW_TASK_TORCH.md; tests/test_torch_cartpole.py checks it).
The small scenes of the solver surface and of a user's own robot are in
`solver/` and `surface/` (solver_scenes.py, surface_scenes.py).
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np

G1_VELOCITY_FLAT = Path(__file__).parent / "g1_velocity_flat.npz"
G1_VELOCITY_ROUGH = Path(__file__).parent / "g1_velocity_rough.npz"
G1_VELOCITY_ROUGH_PLAY = Path(__file__).parent / "g1_velocity_rough_play.npz"
GO1_VELOCITY_FLAT = Path(__file__).parent / "go1_velocity_flat.npz"
GO1_VELOCITY_ROUGH = Path(__file__).parent / "go1_velocity_rough.npz"
GO1_VELOCITY_ROUGH_PLAY = Path(__file__).parent / "go1_velocity_rough_play.npz"
ASIMOV_VELOCITY_FLAT = Path(__file__).parent / "asimov_velocity_flat.npz"
ASIMOV_VELOCITY_ROUGH = Path(__file__).parent / "asimov_velocity_rough.npz"
ASIMOV_VELOCITY_ROUGH_PLAY = Path(__file__).parent / "asimov_velocity_rough_play.npz"
ASIMOV_TOE_VELOCITY_FLAT = Path(__file__).parent / "asimov_toe_velocity_flat.npz"
ASIMOV_TOE_VELOCITY_ROUGH = Path(__file__).parent / "asimov_toe_velocity_rough.npz"
ASIMOV_TOE_VELOCITY_ROUGH_PLAY = Path(__file__).parent / "asimov_toe_velocity_rough_play.npz"
CARTPOLE = Path(__file__).parent / "cartpole.npz"

# Array families the port never reads (see the module docstring).
_DROPPED_PREFIXES = ("mesh_", "bvh_")


def _numeric(v) -> bool:
  return isinstance(v, (int, float, np.ndarray)) and not isinstance(v, bool)


def _hull_arrays(m) -> dict[str, np.ndarray]:
  """The hull vertices of each mesh geom that collides through its hull (in
  a collision pair or a terrain group), packed."""
  from mjlab_tpu_torch.physics import io

  adr = np.full(m.ngeom, -1, dtype=np.int32)
  num = np.zeros(m.ngeom, dtype=np.int32)
  verts = [np.zeros((0, 3))]
  total = 0
  for g in io.hull_geoms(m):
    if int(m.geom_type[g]) != io.mjtGeom.mjGEOM_MESH:
      continue  # a tessellated cylinder or ellipsoid: built from its size
    v = io._hull_vertices(m, g)
    adr[g], num[g] = total, len(v)
    verts.append(v)
    total += len(v)
  return {
    "geom_hull_vert": np.concatenate(verts),
    "geom_hull_vertadr": adr,
    "geom_hull_vertnum": num,
  }


def model_arrays(m) -> dict[str, np.ndarray]:
  """The npz content of a compiled model (reads attributes only): a live
  MjModel, or a namespace `load_model_npz` read, which gives the same
  arrays back."""
  out: dict[str, np.ndarray] = {}
  for name in dir(m):
    if name.startswith("_") or name in ("names", "opt", "stat", "vis"):
      continue
    v = getattr(m, name)
    if isinstance(v, np.ndarray) and name.startswith(_DROPPED_PREFIXES):
      continue
    if isinstance(v, np.ndarray) or (isinstance(v, int) and name.startswith("n")):
      out[name] = np.asarray(v)
  if "geom_hull_vert" not in out:
    out.update(_hull_arrays(m))
  out["names"] = np.frombuffer(bytes(m.names), dtype=np.uint8)
  for name in dir(m.opt):
    if not name.startswith("_") and _numeric(getattr(m.opt, name)):
      out[f"opt.{name}"] = np.asarray(getattr(m.opt, name))
  return out


def save_model_npz(m, path, terrain_origins: np.ndarray | None = None) -> None:
  """Write a compiled model's arrays (see model_arrays) to `path`, and a
  generated terrain's tile origins beside them."""
  arrays = model_arrays(m)
  if terrain_origins is not None:
    arrays["terrain_origins"] = np.asarray(terrain_origins, dtype=np.float64)
  np.savez_compressed(path, **arrays)


def model_namespace(arrays: dict[str, np.ndarray]) -> SimpleNamespace:
  """A namespace with MjModel's attribute names from `model_arrays`-style
  arrays."""
  model = SimpleNamespace(opt=SimpleNamespace())
  for key, v in arrays.items():
    if key == "names":
      v = v.tobytes()
    elif v.ndim == 0:
      v = v.item()
    if key.startswith("opt."):
      setattr(model.opt, key[4:], v)
    else:
      setattr(model, key, v)
  return model


def load_model_arrays(path=G1_VELOCITY_FLAT) -> dict[str, np.ndarray]:
  """The arrays of the npz at `path` (model_arrays' keys)."""
  with np.load(path) as npz:
    return {key: npz[key] for key in npz.files}


def load_model_npz(path=G1_VELOCITY_FLAT) -> SimpleNamespace:
  """A namespace with MjModel's attribute names, read from `path`."""
  return model_namespace(load_model_arrays(path))


def g1_velocity_sim_cfg():
  """The velocity task's SimulationCfg (mjlab_tpu/tasks/velocity/
  velocity_env_cfg.py SIM_CFG): 5 ms steps, Newton with 10 iterations and
  20 linesearch iterations."""
  from mjlab_tpu_torch.sim import MujocoCfg, SimulationCfg

  return SimulationCfg(
    mujoco=MujocoCfg(timestep=0.005, iterations=10, ls_iterations=20),
  )
