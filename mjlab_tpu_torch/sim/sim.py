"""Simulation facade (port of mjlab_tpu/sim/sim.py): owns the compiled
model's host arrays and the batched physics state's device tensors.

The model may be a live `mujoco.MjModel` or the namespace that
`mjlab_tpu_torch.assets.load_model_npz` returns; `mujoco` is never imported
(the GPU host has none). `step_fn()` / `forward_fn()` return batched
(model, data) → data callables, the counterparts of the JAX package's
vmapped closures.

Model leaves are shared by all envs, except those `expand_model_fields`
gives a leading env axis for domain randomization. The physics step reads
a per-env leaf only where it supports one (`PER_ENV_FIELDS`); any other
field raises `NotImplementedError` naming itself.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

import torch

from mjlab_tpu_torch import physics
from mjlab_tpu_torch.physics.types import mjtCone, mjtIntegrator, mjtSolver

# Model leaves the physics step can read with a per-env axis: every field of
# the JAX package's domain-randomization table (envs/mdp/events.FIELD_SPECS).
# Kinematics reads the body, geom and site offsets and qpos0; smooth the
# masses, inertias, armature, stiffness, damping and actuator parameters;
# collision geom_friction; constraint jnt_range, dof_frictionloss and the
# weld's site_quat. As in the JAX package, nothing derived from them at
# compile time is recomputed: the constants MuJoCo derives at qpos0
# (dof_invweight0, actuator_length0, ...), the friction rows (one per dof
# whose compiled frictionloss is not 0) and the terrain broadphase's boxes.
PER_ENV_FIELDS = (
  "dof_armature", "dof_frictionloss", "dof_damping", "jnt_range", "jnt_stiffness",
  "body_mass", "body_ipos", "body_iquat", "body_inertia", "body_pos", "body_quat",
  "geom_friction", "geom_pos", "geom_quat", "site_pos", "site_quat", "qpos0",
  "actuator_gainprm", "actuator_biasprm",
)


_CONE_MAP = {
  "pyramidal": mjtCone.mjCONE_PYRAMIDAL,
  "elliptic": mjtCone.mjCONE_ELLIPTIC,
}
_INTEGRATOR_MAP = {
  "euler": mjtIntegrator.mjINT_EULER,
  "implicitfast": mjtIntegrator.mjINT_IMPLICITFAST,
}
_SOLVER_MAP = {
  "pgs": mjtSolver.mjSOL_PGS,
  "cg": mjtSolver.mjSOL_CG,
  "newton": mjtSolver.mjSOL_NEWTON,
}


@dataclass
class MujocoCfg:
  """MuJoCo solver and integrator options, the JAX package's fields,
  defaults and choices. `jacobian` is kept for the config surface: the
  engine's Jacobians are dense. `solver="pgs"` reaches `physics.put_model`,
  which refuses it (the port has no PGS)."""

  timestep: float = 0.002
  integrator: Literal["euler", "implicitfast"] = "implicitfast"
  impratio: float = 1.0
  cone: Literal["pyramidal", "elliptic"] = "pyramidal"
  jacobian: Literal["auto", "dense", "sparse"] = "auto"
  solver: Literal["newton", "cg", "pgs"] = "newton"
  iterations: int = 100
  tolerance: float = 1e-8
  ls_iterations: int = 50
  ls_tolerance: float = 0.01
  gravity: tuple[float, float, float] = (0, 0, -9.81)

  def apply(self, model) -> None:
    model.opt.cone = _CONE_MAP[self.cone]
    model.opt.integrator = _INTEGRATOR_MAP[self.integrator]
    model.opt.solver = _SOLVER_MAP[self.solver]
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
  static pair table bounds contacts exactly.

  `capsule_terrain_from_above` is a declared divergence from the JAX
  package, set by the Asimov-Toe rough task only: a capsule meets a
  terrain box at the segment point nearest the box's centre and at its
  deeper end, where the JAX package takes the end beside that point (the
  higher one, over a large stair slab, so a small capsule sinks unseen);
  and a sphere of it inside a box leaves through the nearest face that
  does not face down, where the JAX package takes the nearest face (the
  bottom, past a thin slab's mid-plane, which pulls the foot through).
  ROADMAP Queue C."""

  dtype: str = "float32"
  mujoco: MujocoCfg = field(default_factory=MujocoCfg)
  capsule_terrain_from_above: bool = False


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
      self._mj_model, dtype=dtype, device=self.device,
      capsule_terrain_from_above=cfg.capsule_terrain_from_above,
    )
    self._batched_fields: set[str] = set()

  @property
  def mj_model(self):
    return self._mj_model

  @property
  def batched_fields(self) -> set[str]:
    """Model leaves carrying a per-env axis (domain randomization)."""
    return set(self._batched_fields)

  def expand_model_fields(self, fields: tuple[str, ...]) -> None:
    """Give the named Model leaves a leading env axis (a copy per env).
    Idempotent per field."""
    updates = {}
    for f in fields:
      if not hasattr(self.model, f):
        raise ValueError(f"Field not found in model: {f}")
      if f not in PER_ENV_FIELDS:
        raise NotImplementedError(
          f"per-env model field {f} is not supported by mjlab_tpu_torch "
          f"(supported: {', '.join(PER_ENV_FIELDS)})"
        )
      if f in self._batched_fields:
        continue
      leaf = getattr(self.model, f)
      updates[f] = leaf.expand((self.num_envs,) + leaf.shape).clone()
    if updates:
      self.model = dataclasses.replace(self.model, **updates)
      self._batched_fields |= set(updates)

  @property
  def unbatched_model(self) -> physics.Model:
    """Model with the per-env axes stripped (env 0)."""
    if not self._batched_fields:
      return self.model
    return dataclasses.replace(
      self.model, **{f: getattr(self.model, f)[0] for f in self._batched_fields}
    )

  def make_data(self) -> physics.Data:
    """Fresh batched Data at qpos0 (leading axis num_envs)."""
    return physics.make_data(self.tp, self.unbatched_model, self.num_envs)

  def step_fn(self):
    """Batched (model, data) → data physics substep."""
    tp = self.tp
    return lambda m_, d_: physics.step(tp, m_, d_)

  def forward_fn(self):
    tp = self.tp
    return lambda m_, d_: physics.forward(tp, m_, d_)
