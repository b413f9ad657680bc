"""Compiled scenes as data files, for hosts without `mujoco`.

The GPU host has no `mujoco`, so the port cannot compile MJCF there. A scene
is compiled once with MuJoCo (through the JAX package's scene layer) and its
arrays are committed as an npz: every ndarray field of the MjModel, its
`n*` sizes, `names`, and the numeric `opt` fields. `load_model_npz` returns a
namespace with MjModel's attribute names, which `physics.put_model` and
`sim.Simulation` accept like a live MjModel.

`g1_velocity_flat.npz` is the G1 velocity-flat task's scene
(Mjlab-Velocity-Flat-Unitree-G1) with the task's solver options applied;
tests/test_torch_model_io.py checks it is fresh and says how to regenerate it.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np

G1_VELOCITY_FLAT = Path(__file__).parent / "g1_velocity_flat.npz"


def _numeric(v) -> bool:
  return isinstance(v, (int, float, np.ndarray)) and not isinstance(v, bool)


def model_arrays(m) -> dict[str, np.ndarray]:
  """The npz content of a compiled model (reads attributes only)."""
  out: dict[str, np.ndarray] = {}
  for name in dir(m):
    if name.startswith("_") or name in ("names", "opt", "stat", "vis"):
      continue
    v = getattr(m, name)
    if isinstance(v, np.ndarray) or (isinstance(v, int) and name.startswith("n")):
      out[name] = np.asarray(v)
  out["names"] = np.frombuffer(bytes(m.names), dtype=np.uint8)
  for name in dir(m.opt):
    if not name.startswith("_") and _numeric(getattr(m.opt, name)):
      out[f"opt.{name}"] = np.asarray(getattr(m.opt, name))
  return out


def save_model_npz(m, path) -> None:
  """Write a compiled model's arrays (see model_arrays) to `path`."""
  np.savez_compressed(path, **model_arrays(m))


def load_model_npz(path=G1_VELOCITY_FLAT) -> SimpleNamespace:
  """A namespace with MjModel's attribute names, read from `path`."""
  model = SimpleNamespace(opt=SimpleNamespace())
  with np.load(path) as npz:
    for key in npz.files:
      v = npz[key]
      if key == "names":
        v = v.tobytes()
      elif v.ndim == 0:
        v = v.item()
      if key.startswith("opt."):
        setattr(model.opt, key[4:], v)
      else:
        setattr(model, key, v)
  return model


def g1_velocity_sim_cfg():
  """The velocity task's SimulationCfg (mjlab_tpu/tasks/velocity/
  velocity_env_cfg.py SIM_CFG): 5 ms steps, Newton with 10 iterations and
  20 linesearch iterations."""
  from mjlab_tpu_torch.sim import MujocoCfg, SimulationCfg

  return SimulationCfg(
    mujoco=MujocoCfg(timestep=0.005, iterations=10, ls_iterations=20),
  )
