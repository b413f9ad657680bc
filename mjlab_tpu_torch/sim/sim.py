"""Simulation facade (port of mjlab_tpu/sim/sim.py): owns the compiled
model's host arrays and the batched physics state's device tensors.

The model may be a live `mujoco.MjModel` or the namespace that
`mjlab_tpu_torch.assets.load_model_npz` returns; `mujoco` is never imported
(the GPU host has none). `step_fn()` / `forward_fn()` return batched
(model, data) → data callables, the counterparts of the JAX package's
vmapped closures.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from mjlab_tpu_torch import physics
from mjlab_tpu_torch.physics.types import mjtCone, mjtIntegrator, mjtSolver


@dataclass
class MujocoCfg:
  """MuJoCo solver options (mirrors the JAX package's). The port has one
  integrator (implicitfast), one solver (Newton) and one cone (pyramidal);
  `apply` selects them, and `physics.put_model` rejects a model that asks
  for another."""

  timestep: float = 0.002
  impratio: float = 1.0
  iterations: int = 100
  tolerance: float = 1e-8
  ls_iterations: int = 50
  ls_tolerance: float = 0.01
  gravity: tuple[float, float, float] = (0, 0, -9.81)

  def apply(self, model) -> None:
    model.opt.cone = mjtCone.mjCONE_PYRAMIDAL
    model.opt.integrator = mjtIntegrator.mjINT_IMPLICITFAST
    model.opt.solver = mjtSolver.mjSOL_NEWTON
    model.opt.timestep = self.timestep
    model.opt.impratio = self.impratio
    model.opt.gravity[:] = self.gravity
    model.opt.iterations = self.iterations
    model.opt.tolerance = self.tolerance
    model.opt.ls_iterations = self.ls_iterations
    model.opt.ls_tolerance = self.ls_tolerance


@dataclass(kw_only=True)
class SimulationCfg:
  """Simulation configuration. Contact capacity needs no setting: the
  static pair table bounds contacts exactly."""

  dtype: str = "float32"
  mujoco: MujocoCfg = field(default_factory=MujocoCfg)


class Simulation:
  """Batched physics simulation on one device (CUDA unless `device` says
  otherwise)."""

  def __init__(
    self,
    num_envs: int,
    cfg: SimulationCfg,
    model,
    device: torch.device | str | None = None,
  ):
    self.cfg = cfg
    self.num_envs = num_envs
    self.device = (
      torch.device(device) if device is not None else physics.io.default_device()
    )
    # Full-precision float32 products on the card (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    self._mj_model = model
    cfg.mujoco.apply(self._mj_model)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    self.tp, self.model = physics.put_model(
      self._mj_model, dtype=dtype, device=self.device
    )

  @property
  def mj_model(self):
    return self._mj_model

  def make_data(self) -> physics.Data:
    """Fresh batched Data at qpos0 (leading axis num_envs)."""
    return physics.make_data(self.tp, self.model, self.num_envs)

  def step_fn(self):
    """Batched (model, data) → data physics substep."""
    tp = self.tp
    return lambda m_, d_: physics.step(tp, m_, d_)

  def forward_fn(self):
    tp = self.tp
    return lambda m_, d_: physics.forward(tp, m_, d_)
