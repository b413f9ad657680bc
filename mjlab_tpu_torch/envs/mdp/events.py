"""Stock event terms (port of mjlab_tpu/envs/mdp/events.py).

Every event term takes `env_mask`, a boolean (B,) tensor, instead of env
ids. Draws are made for all envs on every call, from the env's generator,
and merged by the mask, so that shapes never depend on data and nothing
reads a device value on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Tuple, Union

import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")
_POSE_KEYS = ["x", "y", "z", "roll", "pitch", "yaw"]


def _uniform6(env, ranges_dict, batch: int) -> torch.Tensor:
  """(batch, 6) draws lo + u (hi − lo) over x, y, z, roll, pitch, yaw; a
  missing key is (0, 0). Bounds stay Python numbers: no host-to-device
  copy."""
  u = torch.rand((batch, 6), generator=env.generator, dtype=env.dtype, device=env.device)
  cols = []
  for i, k in enumerate(_POSE_KEYS):
    lo, hi = ranges_dict.get(k, (0.0, 0.0))
    cols.append(lo + u[:, i] * (hi - lo))
  return torch.stack(cols, dim=-1)


def reset_scene_to_default(env, env_mask) -> None:
  for entity in env.scene.entities.values():
    if not entity.is_fixed_base:
      root_state = entity.data.default_root_state.clone()
      root_state[:, 0:3] += env.scene.env_origins
      entity.write_root_state_to_sim(root_state, env_mask=env_mask)
    if entity.is_articulated:
      entity.write_joint_state_to_sim(
        entity.data.default_joint_pos, entity.data.default_joint_vel, env_mask=env_mask,
      )


def reset_root_state_uniform(
  env,
  env_mask,
  pose_range: dict[str, tuple[float, float]],
  velocity_range: dict[str, tuple[float, float]] | None = None,
  asset_cfg: SceneEntityCfg = _DEFAULT,
) -> None:
  asset = env.scene[asset_cfg.name]
  if asset.is_fixed_base:
    raise NotImplementedError(
      "reset_root_state_uniform of a fixed-base (mocap) entity is not supported by "
      "mjlab_tpu_torch"
    )
  B = env.num_envs
  pose_samples = _uniform6(env, pose_range, B)
  root_states = asset.data.default_root_state
  positions = root_states[:, 0:3] + pose_samples[:, 0:3] + env.scene.env_origins
  delta = mt.quat_from_euler_xyz(
    pose_samples[:, 3], pose_samples[:, 4], pose_samples[:, 5]
  )
  orientations = mt.quat_mul(root_states[:, 3:7], delta)
  vel_samples = _uniform6(env, velocity_range or {}, B)
  velocities = root_states[:, 7:13] + vel_samples
  asset.write_root_link_pose_to_sim(
    torch.cat([positions, orientations], dim=-1), env_mask=env_mask
  )
  asset.write_root_link_velocity_to_sim(velocities, env_mask=env_mask)


def reset_joints_by_offset(
  env,
  env_mask,
  position_range: tuple[float, float],
  velocity_range: tuple[float, float],
  asset_cfg: SceneEntityCfg = _DEFAULT,
) -> None:
  asset = env.scene[asset_cfg.name]
  jp = asset.data.default_joint_pos[:, asset_cfg.joint_ids]
  jv = asset.data.default_joint_vel[:, asset_cfg.joint_ids]
  kw = dict(generator=env.generator, dtype=env.dtype, device=env.device)
  jp = jp + mt.sample_uniform(*position_range, jp.shape, **kw)
  limits = asset.data.soft_joint_pos_limits[:, asset_cfg.joint_ids]
  jp = torch.clamp(jp, limits[..., 0], limits[..., 1])
  jv = jv + mt.sample_uniform(*velocity_range, jv.shape, **kw)
  ids = asset_cfg.joint_ids
  asset.write_joint_state_to_sim(
    jp, jv, joint_ids=None if isinstance(ids, slice) else ids, env_mask=env_mask,
  )


def push_by_setting_velocity(
  env,
  env_mask,
  velocity_range: dict[str, tuple[float, float]],
  asset_cfg: SceneEntityCfg = _DEFAULT,
) -> None:
  asset = env.scene[asset_cfg.name]
  vel_w = asset.data.root_link_vel_w + _uniform6(env, velocity_range, env.num_envs)
  asset.write_root_link_velocity_to_sim(vel_w, env_mask=env_mask)


def apply_external_force_torque(
  env,
  env_mask,
  force_range: tuple[float, float],
  torque_range: tuple[float, float],
  asset_cfg: SceneEntityCfg = _DEFAULT,
) -> None:
  """Draw a world-frame force and torque per env and selected body and set
  them as the bodies' `xfrc_applied` in the masked envs (the others keep
  theirs)."""
  asset = env.scene[asset_cfg.name]
  ids = asset_cfg.body_ids
  num_bodies = asset.num_bodies if isinstance(ids, slice) else len(ids)
  size = (env.num_envs, num_bodies, 3)
  kw = dict(generator=env.generator, dtype=env.dtype, device=env.device)
  forces = mt.sample_uniform(*force_range, size, **kw)
  torques = mt.sample_uniform(*torque_range, size, **kw)
  asset.write_external_wrench_to_sim(
    forces, torques, env_mask=env_mask, body_ids=None if isinstance(ids, slice) else ids,
  )


# ---------------------------------------------------------------------------
# Domain randomization of a Model field. The field must carry an env axis:
# the env expands the fields of events marked domain_randomization=True
# (sim.Simulation.expand_model_fields), and the physics reads each of them
# per env.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FieldSpec:
  """How a Model field's elements map to an entity's (the JAX package's
  FieldSpec): the entity element type, whether the field is indexed by the
  element's address (dofs by their dof address, qpos0 by the joint's qpos
  address), the axes randomized by default and the axes that may be."""

  entity_type: Literal["dof", "joint", "body", "geom", "site", "actuator"]
  use_address: bool = False
  default_axes: tuple[int, ...] | None = None


FIELD_SPECS = {
  "dof_armature": FieldSpec("dof", use_address=True),
  "dof_frictionloss": FieldSpec("dof", use_address=True),
  "dof_damping": FieldSpec("dof", use_address=True),
  "jnt_range": FieldSpec("joint"),
  "jnt_stiffness": FieldSpec("joint"),
  "body_mass": FieldSpec("body"),
  "body_ipos": FieldSpec("body", default_axes=(0, 1, 2)),
  "body_iquat": FieldSpec("body", default_axes=(0, 1, 2, 3)),
  "body_inertia": FieldSpec("body"),
  "body_pos": FieldSpec("body", default_axes=(0, 1, 2)),
  "body_quat": FieldSpec("body", default_axes=(0, 1, 2, 3)),
  "geom_friction": FieldSpec("geom", default_axes=(0,)),
  "geom_pos": FieldSpec("geom", default_axes=(0, 1, 2)),
  "geom_quat": FieldSpec("geom", default_axes=(0, 1, 2, 3)),
  "site_pos": FieldSpec("site", default_axes=(0, 1, 2)),
  "site_quat": FieldSpec("site", default_axes=(0, 1, 2, 3)),
  "qpos0": FieldSpec("joint", use_address=True),
  "actuator_gainprm": FieldSpec("actuator", default_axes=(0,)),
  "actuator_biasprm": FieldSpec("actuator", default_axes=(1, 2)),
}


def _entity_indices(asset, asset_cfg: SceneEntityCfg, spec: FieldSpec) -> torch.Tensor:
  """The field's element indices for the entity's selected elements, from
  the entity's device index tables and the selection's device ids."""
  kind, table = spec.entity_type, asset.device_indexing
  if kind == "dof":
    ids, base = asset_cfg.joint_ids, table["joint_v_adr"]
  elif kind == "joint":
    ids = asset_cfg.joint_ids
    base = table["joint_q_adr" if spec.use_address else "joint_ids"]
  elif kind == "actuator":
    ids, base = asset_cfg.actuator_ids, table["ctrl_ids"]
  else:
    ids, base = getattr(asset_cfg, f"{kind}_ids"), table[f"{kind}_ids"]
  return base if isinstance(ids, slice) else base[ids]


def randomize_field(
  env,
  env_mask,
  field: str,
  ranges: Union[Tuple[float, float], Dict[int, Tuple[float, float]]],
  distribution: Literal["uniform", "log_uniform", "gaussian"] = "uniform",
  operation: Literal["add", "scale", "abs"] = "abs",
  asset_cfg: SceneEntityCfg | None = None,
  axes: list[int] | None = None,
) -> None:
  """Randomize a Model field per env: draw for every env and selected
  element (and axis), combine with the current value and keep the result in
  the masked envs. A "gaussian" distribution reads `ranges` as (mean, std)."""
  if field not in FIELD_SPECS:
    raise ValueError(f"Unknown field '{field}'. Supported: {list(FIELD_SPECS)}")
  spec = FIELD_SPECS[field]
  asset_cfg = asset_cfg or _DEFAULT
  asset = env.scene[asset_cfg.name]
  model_field = getattr(env.model, field)
  if field not in env.sim.batched_fields:
    raise RuntimeError(
      f"Model field '{field}' is not env-batched; mark the event with "
      f"domain_randomization=True so the env expands it."
    )
  ent_idx = _entity_indices(asset, asset_cfg, spec)
  sub = model_field[:, ent_idx]  # (B, n) or (B, n, k)

  if sub.dim() == 2:
    target_axes = [None]
  elif axes is not None:
    target_axes = list(axes)
  elif isinstance(ranges, dict):
    target_axes = sorted(ranges.keys())
  elif spec.default_axes is not None:
    target_axes = list(spec.default_axes)
  else:
    target_axes = list(range(sub.shape[-1]))

  samplers = {"uniform": mt.sample_uniform, "log_uniform": mt.sample_log_uniform,
              "gaussian": mt.sample_gaussian}
  if distribution not in samplers:
    raise ValueError(distribution)

  def combine(old, rand):
    if operation == "add":
      return old + rand
    if operation == "scale":
      return old * rand
    if operation == "abs":
      return rand
    raise ValueError(operation)

  new_sub = sub.clone()
  for ax in target_axes:
    lo, hi = ranges[ax if ax is not None else 0] if isinstance(ranges, dict) else ranges
    rand = samplers[distribution](lo, hi, sub.shape[:2], generator=env.generator,
                                  dtype=env.dtype, device=env.device)
    if ax is None:
      new_sub = combine(new_sub, rand)
    else:
      new_sub[..., ax] = combine(new_sub[..., ax], rand)

  mask = env_mask.reshape((-1,) + (1,) * (sub.dim() - 1))
  updated = model_field.clone()
  updated[:, ent_idx] = torch.where(mask, new_sub, sub)
  env.model = dataclasses.replace(env.model, **{field: updated})
