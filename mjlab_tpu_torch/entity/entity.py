"""Entity: a physical object of a compiled scene (port of
mjlab_tpu/entity/entity.py).

The JAX package's Entity wraps an MjSpec and takes its index maps from the
spec's element ids. The port composes no spec: it binds an `EntityCfg`
(init state, articulation) to the compiled model's elements whose names
carry the entity's prefix (`robot/...`), reading only `names`,
`name_*adr`, `jnt_*`, `body_*`, `geom_bodyid`, `site_bodyid`,
`actuator_trntype`/`actuator_trnid` and the tendons' wrap joints, which a
live MjModel and the committed npz both carry. A joint takes its type's
width of qpos and qvel (free 7/6, ball 4/3, hinge and slide 1/1), and a
body may have several; a fixed-base entity whose root body is a mocap body
is moved through `write_mocap_pose_to_sim`. A tendon, and an actuator
that drives one, belongs to the entity whose joints the tendon spans.
Element order is the compiled model's, which is the spec's order.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from mjlab_tpu_torch.core.strings import resolve_matching_names
from mjlab_tpu_torch.physics.types import mjtJoint, mjtTrn, mjtWrap
from mjlab_tpu_torch.utils.spec_config import ActuatorCfg

_QPOS_WIDTH = {0: 7, 1: 4, 2: 1, 3: 1}  # free, ball, slide, hinge
_DOF_WIDTH = {0: 6, 1: 3, 2: 1, 3: 1}


@dataclass(frozen=True)
class EntityIndexing:
  """Maps entity elements to global indices/addresses (all numpy, static)."""

  body_ids: np.ndarray
  geom_ids: np.ndarray
  site_ids: np.ndarray
  ctrl_ids: np.ndarray
  joint_ids: np.ndarray
  mocap_id: int | None
  joint_q_adr: np.ndarray
  joint_v_adr: np.ndarray
  free_joint_q_adr: np.ndarray
  free_joint_v_adr: np.ndarray

  @property
  def root_body_id(self) -> int:
    return int(self.body_ids[0])


@dataclass
class EntityArticulationInfoCfg:
  actuators: tuple[ActuatorCfg, ...] = field(default_factory=tuple)
  soft_joint_pos_limit_factor: float = 1.0


@dataclass
class EntityCfg:
  @dataclass
  class InitialStateCfg:
    pos: tuple[float, float, float] = (0.0, 0.0, 0.0)
    rot: tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    lin_vel: tuple[float, float, float] = (0.0, 0.0, 0.0)
    ang_vel: tuple[float, float, float] = (0.0, 0.0, 0.0)
    joint_pos: dict[str, float] = field(default_factory=lambda: {".*": 0.0})
    joint_vel: dict[str, float] = field(default_factory=lambda: {".*": 0.0})

  init_state: InitialStateCfg = field(default_factory=InitialStateCfg)
  articulation: EntityArticulationInfoCfg | None = None


def element_name(m, adr: np.ndarray, i: int) -> str:
  """The full name of element i from MjModel.names ("" when unnamed)."""
  names = bytes(m.names)
  start = int(adr[i])
  return names[start : names.index(b"\0", start)].decode()


class Entity:
  """A physical object: fixed/floating × articulated/actuated, bound to the
  compiled model's elements named `<name>/...`."""

  def __init__(self, cfg: EntityCfg, name: str, model) -> None:
    self.cfg = cfg
    self.name = name
    prefix = f"{name}/"
    body_names = [element_name(model, model.name_bodyadr, b) for b in range(model.nbody)]
    roots = {b for b in range(1, model.nbody) if body_names[b].startswith(prefix)}
    if not roots:
      raise ValueError(f"Entity '{name}': no body named '{prefix}...' in the model.")
    # The entity's bodies: the prefixed ones and everything below them.
    bodies = []
    for b in range(1, model.nbody):
      a = b
      while a != 0 and a not in roots:
        a = int(model.body_parentid[a])
      if a != 0:
        bodies.append(b)
    body_set = set(bodies)
    joints = [j for j in range(model.njnt) if int(model.jnt_bodyid[j]) in body_set]
    geoms = [g for g in range(model.ngeom) if int(model.geom_bodyid[g]) in body_set]
    sites = [s for s in range(model.nsite) if int(model.site_bodyid[s]) in body_set]
    joint_set = set(joints)

    def owns_tendon(t: int) -> bool:
      """A fixed tendon through one of the entity's joints, or a spatial
      one through a site on one of its bodies."""
      adr, num = int(model.tendon_adr[t]), int(model.tendon_num[t])
      for w in range(adr, adr + num):
        wt, obj = int(model.wrap_type[w]), int(model.wrap_objid[w])
        if wt == mjtWrap.mjWRAP_JOINT and obj in joint_set:
          return True
        if wt == mjtWrap.mjWRAP_SITE and int(model.site_bodyid[obj]) in body_set:
          return True
      return False

    tendons = [t for t in range(model.ntendon) if owns_tendon(t)]
    tendon_set = set(tendons)

    def owns(u: int) -> bool:
      target = int(model.actuator_trnid[u, 0])
      if int(model.actuator_trntype[u]) == mjtTrn.mjTRN_TENDON:
        return target in tendon_set
      return target in joint_set

    actuators = [u for u in range(model.nu) if owns(u)]

    self._free_joint = None
    self._non_free_joints = joints
    if joints and int(model.jnt_type[joints[0]]) == mjtJoint.mjJNT_FREE:
      self._free_joint = joints[0]
      self._non_free_joints = joints[1:]

    def short(adr, ids):
      return tuple(element_name(model, adr, i).split("/")[-1] for i in ids)

    self.joint_names = short(model.name_jntadr, self._non_free_joints)
    self.body_names = tuple(body_names[b].split("/")[-1] for b in bodies)
    self.geom_names = short(model.name_geomadr, geoms)
    self.site_names = short(model.name_siteadr, sites)
    self.tendon_names = short(model.name_tendonadr, tendons)
    self.actuator_names = short(model.name_actuatoradr, actuators)
    self.is_mocap = bool(
      self.is_fixed_base and int(model.body_mocapid[bodies[0]]) >= 0
    )
    self.indexing = self._compute_indexing(model, bodies, geoms, sites, joints, actuators)
    self._data = None

  # -- attributes -------------------------------------------------------------

  @property
  def is_fixed_base(self) -> bool:
    return self._free_joint is None

  @property
  def is_articulated(self) -> bool:
    return len(self._non_free_joints) > 0

  @property
  def is_actuated(self) -> bool:
    return self.num_actuators > 0

  @property
  def data(self):
    assert self._data is not None, "Entity not initialized."
    return self._data

  @property
  def num_actuators(self) -> int:
    return len(self.actuator_names)

  @property
  def num_bodies(self) -> int:
    return len(self.body_names)

  # -- regex find -------------------------------------------------------------

  def find_bodies(self, name_keys, preserve_order=False):
    return resolve_matching_names(name_keys, self.body_names, preserve_order)

  def find_joints(self, name_keys, joint_subset=None, preserve_order=False):
    subset = self.joint_names if joint_subset is None else joint_subset
    return resolve_matching_names(name_keys, subset, preserve_order)

  def find_tendons(self, name_keys, tendon_subset=None, preserve_order=False):
    subset = self.tendon_names if tendon_subset is None else tendon_subset
    return resolve_matching_names(name_keys, subset, preserve_order)

  def find_actuators(self, name_keys, actuator_subset=None, preserve_order=False):
    subset = self.actuator_names if actuator_subset is None else actuator_subset
    return resolve_matching_names(name_keys, subset, preserve_order)

  def find_geoms(self, name_keys, geom_subset=None, preserve_order=False):
    subset = self.geom_names if geom_subset is None else geom_subset
    return resolve_matching_names(name_keys, subset, preserve_order)

  def find_sites(self, name_keys, site_subset=None, preserve_order=False):
    subset = self.site_names if site_subset is None else site_subset
    return resolve_matching_names(name_keys, subset, preserve_order)

  # -- initialization -----------------------------------------------------------

  def initialize(self, ctx) -> None:
    """Bind to the env's state context (batched Data, device, dtype), and
    copy the index arrays of `indexing` to its device once
    (`device_indexing`, by field name)."""
    from mjlab_tpu_torch.entity.data import EntityData

    self._data = EntityData(self, ctx)
    self.device_indexing = {
      f.name: torch.as_tensor(getattr(self.indexing, f.name).astype(np.int64), device=ctx.device)
      for f in fields(self.indexing)
      if isinstance(getattr(self.indexing, f.name), np.ndarray)
    }

  def update(self, dt: float) -> None:
    del dt

  def reset(self, env_mask=None) -> None:
    self._data.clear_state(env_mask)

  def write_data_to_sim(self) -> None:
    pass

  # Write-through API (delegates to EntityData; env_mask is a boolean (B,)
  # mask or None = all envs).

  def write_root_state_to_sim(self, root_state, env_mask=None):
    self._data.write_root_state(root_state, env_mask)

  def write_root_link_pose_to_sim(self, root_pose, env_mask=None):
    self._data.write_root_pose(root_pose, env_mask)

  def write_root_link_velocity_to_sim(self, root_velocity, env_mask=None):
    self._data.write_root_velocity(root_velocity, env_mask)

  def write_joint_state_to_sim(self, position, velocity, joint_ids=None,
                               env_mask=None):
    self._data.write_joint_state(position, velocity, joint_ids, env_mask)

  def write_joint_position_target_to_sim(self, position_target, joint_ids=None,
                                         env_mask=None):
    self._data.write_ctrl(position_target, joint_ids, env_mask)

  def write_mocap_pose_to_sim(self, mocap_pose, env_mask=None):
    self._data.write_mocap_pose(mocap_pose, env_mask)

  def write_external_wrench_to_sim(self, forces, torques, env_mask=None, body_ids=None):
    self._data.write_external_wrench(forces, torques, body_ids, env_mask)

  def write_ctrl_to_sim(self, ctrl, ctrl_ids=None, env_mask=None):
    self._data.write_ctrl(ctrl, ctrl_ids, env_mask)

  def clear_state(self, env_mask=None) -> None:
    self._data.clear_state(env_mask)

  # -- indexing ---------------------------------------------------------------

  def _compute_indexing(self, model, bodies, geoms, sites, joints, actuators):
    joint_q_adr, joint_v_adr = [], []
    free_joint_q_adr, free_joint_v_adr = [], []
    for jid in joints:
      jnt_type = int(model.jnt_type[jid])
      vadr, qadr = int(model.jnt_dofadr[jid]), int(model.jnt_qposadr[jid])
      if jnt_type == mjtJoint.mjJNT_FREE:
        free_joint_v_adr.extend(range(vadr, vadr + 6))
        free_joint_q_adr.extend(range(qadr, qadr + 7))
      else:
        joint_v_adr.extend(range(vadr, vadr + _DOF_WIDTH[jnt_type]))
        joint_q_adr.extend(range(qadr, qadr + _QPOS_WIDTH[jnt_type]))
    mocap_id = int(model.body_mocapid[bodies[0]]) if self.is_mocap else None
    ints = lambda x: np.asarray(x, dtype=int)  # noqa: E731
    return EntityIndexing(
      body_ids=ints(bodies),
      geom_ids=ints(geoms),
      site_ids=ints(sites),
      ctrl_ids=ints(actuators if actuators else []),
      joint_ids=ints(self._non_free_joints),
      mocap_id=mocap_id,
      joint_q_adr=ints(joint_q_adr),
      joint_v_adr=ints(joint_v_adr),
      free_joint_q_adr=ints(free_joint_q_adr),
      free_joint_v_adr=ints(free_joint_v_adr),
    )
