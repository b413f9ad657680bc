"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both engines are built from the same compiled MjModel and run in float64 on
the CPU; inputs are made with numpy from fixed seeds and handed to both as
numpy arrays. Contact-rich states come from a JAX rollout from the
keyframe with seeded controls, so that contacts and joint limits are active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch.physics import io as tio

# A capsule chain with hinge/slide limits on a free base, a free sphere and a
# free capsule over a plane, PD position actuators and the four sensor types
# of the G1 velocity task. Condim 1 and 3 geoms and a higher-priority floor
# exercise the contact-parameter mixing.
TOY_XML = """
<mujoco>
  <option timestep="0.004" iterations="10" ls_iterations="20"
          integrator="implicitfast"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" priority="1"
          friction="0.8 0.01 0.001"/>
    <body name="base" pos="0 0 0.45">
      <freejoint/>
      <geom type="capsule" size="0.06" fromto="-0.15 0 0 0.15 0 0" mass="2"/>
      <site name="imu" pos="0.05 0.02 0.03" quat="0.9 0.1 0.3 0"/>
      <body name="link1" pos="0.2 0 0">
        <joint name="j1" type="hinge" axis="0 1 0" range="-0.4 0.4"
               damping="0.2" armature="0.01" stiffness="2"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0.25 0 -0.1" mass="0.6"/>
        <body name="link2" pos="0.25 0 -0.1">
          <joint name="j2" type="hinge" axis="0 0.6 0.8" range="-0.3 0.3"
                 armature="0.02"/>
          <geom type="capsule" size="0.035" fromto="0 0 0 0.2 0 0" mass="0.4"
                condim="1"/>
          <body name="link3" pos="0.2 0 0">
            <joint name="j3" type="slide" axis="1 0 0" range="-0.05 0.05"
                   damping="1"/>
            <geom type="sphere" size="0.05" mass="0.3"/>
          </body>
        </body>
      </body>
      <body name="leg" pos="-0.2 0 0">
        <joint name="j4" type="hinge" axis="1 0 0" range="-0.6 0.6"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0 0 -0.35" mass="0.5"/>
      </body>
    </body>
    <body name="ball" pos="0.3 0.25 0.3">
      <freejoint/>
      <geom type="sphere" size="0.07" mass="0.5" condim="1"/>
    </body>
    <body name="rod" pos="-0.1 -0.3 0.25" euler="0.3 0.2 0">
      <freejoint/>
      <geom type="capsule" size="0.05" fromto="-0.1 0 0 0.1 0 0" mass="0.7"/>
    </body>
  </worldbody>
  <actuator>
    <position joint="j1" kp="40" kv="1.5" ctrlrange="-0.5 0.5"/>
    <position joint="j2" kp="25" kv="1" forcerange="-3 3"/>
    <position joint="j3" kp="100" kv="4"/>
    <position joint="j4" kp="30"/>
  </actuator>
  <sensor>
    <accelerometer site="imu"/>
    <velocimeter site="imu"/>
    <gyro site="imu"/>
    <subtreeangmom body="base"/>
  </sensor>
  <keyframe>
    <key qpos="0 0 0.45 1 0 0 0  0.1 -0.1 0.01 0.2
               0.3 0.25 0.3 1 0 0 0
               -0.1 -0.3 0.25 0.98 0.15 0.1 0"/>
  </keyframe>
</mujoco>
"""


def toy_mj_model() -> mujoco.MjModel:
  return mujoco.MjModel.from_xml_string(TOY_XML)


def g1_mj_model() -> mujoco.MjModel:
  """The G1 velocity-flat scene with the task's solver options applied."""
  from mjlab_tpu.tasks.velocity.config.g1.env_cfgs import unitree_g1_flat_env_cfg

  return _compiled(unitree_g1_flat_env_cfg())


def _asimov_flat_cfg(toe: bool):
  """A fresh Asimov (or Asimov-Toe) velocity-flat cfg of the JAX package
  (its env_cfgs bind module-level cfg objects, so each call copies one)."""
  import copy

  if toe:
    from mjlab_tpu.tasks.velocity.config.asimov_toe.env_cfgs import (
      ASIMOV_TOE_FLAT_ENV_CFG as cfg,
    )
  else:
    from mjlab_tpu.tasks.velocity.config.asimov.env_cfgs import (
      ASIMOV_FLAT_ENV_CFG as cfg,
    )
  return copy.deepcopy(cfg)


def _compiled(cfg) -> mujoco.MjModel:
  """The JAX package's compile of a task cfg's scene, its solver options
  applied."""
  from mjlab_tpu.scene import Scene

  m = Scene(cfg.scene).compile()
  cfg.sim.mujoco.apply(m)
  return m


def asimov_mj_model() -> mujoco.MjModel:
  """The Asimov velocity-flat scene with the task's solver options."""
  return _compiled(_asimov_flat_cfg(toe=False))


def asimov_toe_mj_model() -> mujoco.MjModel:
  """The Asimov-Toe velocity-flat scene with the task's solver options."""
  return _compiled(_asimov_flat_cfg(toe=True))


SCENES = {
  "toy": toy_mj_model, "g1": g1_mj_model, "asimov": asimov_mj_model,
  "asimov_toe": asimov_toe_mj_model,
}


# ---------------------------------------------------------------------------
# Carrying leaves across.
# ---------------------------------------------------------------------------


def jax_model_arrays(jm) -> dict[str, np.ndarray]:
  """The JAX Model's leaves by name, option fields as `opt.<field>`."""
  out = {
    f.name: np.asarray(getattr(jm, f.name))
    for f in dataclasses.fields(jm) if f.name != "opt"
  }
  for f in dataclasses.fields(jm.opt):
    out[f"opt.{f.name}"] = np.asarray(getattr(jm.opt, f.name))
  return out


def jax_data_arrays(jd) -> dict[str, np.ndarray]:
  """A (batched) JAX Data's leaves by name, contact fields as
  `contact.<field>` — the names io.data_to_arrays writes."""
  out = {}
  for f in dataclasses.fields(jd):
    v = getattr(jd, f.name)
    if f.name == "contact":
      for g in dataclasses.fields(v):
        out[f"contact.{g.name}"] = np.asarray(getattr(v, g.name))
    else:
      out[f.name] = np.asarray(v)
  return out


def jax_data_from_arrays(arrays: dict[str, np.ndarray]):
  contact = jphysics.Contact(
    **{f.name: jnp.asarray(arrays[f"contact.{f.name}"])
       for f in dataclasses.fields(jphysics.Contact)}
  )
  return jphysics.Data(
    contact=contact,
    **{f.name: jnp.asarray(arrays[f.name])
       for f in dataclasses.fields(jphysics.Data) if f.name != "contact"},
  )


def to_torch(arrays: dict[str, np.ndarray]):
  return tio.data_from_arrays(arrays, dtype=torch.float64, device="cpu")


# ---------------------------------------------------------------------------
# Scenes and states.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scene:
  mj: mujoco.MjModel
  jtp: object
  jm: object
  ttp: object
  tm: object
  states: dict[str, np.ndarray]  # 8 contact-rich states, batched
  ctrl_ref: np.ndarray  # (nu,) keyframe joint targets


def _ctrl_ref(mj: mujoco.MjModel) -> np.ndarray:
  """Each actuator's length at the keyframe: its joint's position, or its
  fixed tendon's length."""
  key = mj.key_qpos[0]

  def length(u: int) -> float:
    target = int(mj.actuator_trnid[u, 0])
    if int(mj.actuator_trntype[u]) == int(mujoco.mjtTrn.mjTRN_TENDON):
      adr, num = mj.tendon_adr[target], mj.tendon_num[target]
      return sum(float(mj.wrap_prm[w]) * key[mj.jnt_qposadr[mj.wrap_objid[w]]]
                 for w in range(adr, adr + num))
    return key[mj.jnt_qposadr[target]]

  return np.asarray([length(u) for u in range(mj.nu)])


@functools.lru_cache(maxsize=None)
def jax_step(name: str):
  sc = scene(name)
  return jax.jit(jax.vmap(lambda d: jphysics.step(sc.jtp, sc.jm, d)))


def rollout_states(mj, jtp, jm, n_worlds: int, n_steps: int, seed: int):
  """JAX rollout from the keyframe with seeded joint perturbations and
  controls (keyframe targets + noise); returns the final batched state."""
  rng = np.random.default_rng(seed)
  d0 = jphysics.make_data(jtp, jm)
  qpos = np.tile(mj.key_qpos[0], (n_worlds, 1))
  hinge = np.nonzero(mj.jnt_type == mujoco.mjtJoint.mjJNT_HINGE)[0]
  qa = mj.jnt_qposadr[hinge]
  qpos[:, qa] += rng.normal(0.0, 0.05, (n_worlds, len(qa)))
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n_worlds,) + x.shape), d0)
  d = d.replace(qpos=jnp.asarray(qpos))
  step = jax.jit(jax.vmap(lambda d: jphysics.step(jtp, jm, d)))
  ref = _ctrl_ref(mj)
  for _ in range(n_steps):
    ctrl = ref + rng.normal(0.0, 0.3, (n_worlds, mj.nu))
    d = step(d.replace(ctrl=jnp.asarray(ctrl)))
  return jax_data_arrays(d)


@functools.lru_cache(maxsize=None)
def scene(name: str) -> Scene:
  mj = SCENES[name]()
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  n_steps = {"toy": 60, "g1": 30, "asimov": 30, "asimov_toe": 30}[name]
  states = rollout_states(mj, jtp, jm, n_worlds=8, n_steps=n_steps, seed=7)
  return Scene(mj, jtp, jm, ttp, tm, states, _ctrl_ref(mj))


def assert_close(got, want, tol: float, what: str = "") -> float:
  """max |got − want| <= tol · max(1, max |want|); returns that error."""
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  assert np.array_equal(np.isnan(got), np.isnan(want)), what
  ok = ~np.isnan(want)
  err = float(np.max(np.abs(got[ok] - want[ok]), initial=0.0))
  scale = max(1.0, float(np.max(np.abs(want[ok]), initial=0.0)))
  assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:.0e} x {scale:.3e}"
  log = os.environ.get("TORCH_PARITY_LOG")
  if log:  # one line per comparison: test, quantity, relative error, tolerance
    test = os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0]
    with open(log, "a") as f:
      f.write(json.dumps([test, what, err / scale, tol]) + "\n")
  return err


# ---------------------------------------------------------------------------
# Env-level parity: the G1 velocity-flat task in both packages.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def torch_threads(n: int):
  """A few-env CPU env step is thousands of tiny ops, which extra threads
  only slow down (one thread measured 7x faster than eight on an 8-core
  host); the env tests run with one."""
  old = torch.get_num_threads()
  torch.set_num_threads(n)
  try:
    yield
  finally:
    torch.set_num_threads(old)


def g1_flat_cfgs(num_envs: int, edit=None):
  """(JAX cfg, port cfg) of the G1 flat task at `num_envs`, float64; `edit`
  is applied to both (their field names agree)."""
  from mjlab_tpu.tasks.velocity.config.g1.env_cfgs import unitree_g1_flat_env_cfg
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfgs = (unitree_g1_flat_env_cfg(), load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1"))
  for cfg in cfgs:
    cfg.scene.num_envs = num_envs
    cfg.sim.dtype = "float64"
    if edit is not None:
      edit(cfg)
  return cfgs


def jax_cfg_modules() -> SimpleNamespace:
  """The JAX package's counterparts of `chip_smoke.port_cfg_modules`, so
  that `chip_smoke.sim_to_real_edit` builds the same cfg for it."""
  from mjlab_tpu import sensors
  from mjlab_tpu.envs import mdp
  from mjlab_tpu.managers.manager_term_config import EventTermCfg
  from mjlab_tpu.managers.scene_entity_config import SceneEntityCfg
  from mjlab_tpu.utils import noise

  return SimpleNamespace(mdp=mdp, EventTermCfg=EventTermCfg, SceneEntityCfg=SceneEntityCfg,
                         noise=noise, sensors=sensors)


def g1_flat_envs(num_envs: int, edit=None):
  """(JAX env, port env on the CPU), the port bound to the JAX env's
  compiled model."""
  return _envs(g1_flat_cfgs(num_envs, edit))


def _envs(cfgs):
  from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  jcfg, tcfg = cfgs
  jenv = JaxEnv(jcfg)
  return jenv, ManagerBasedRlEnv(tcfg, device="cpu", model=jenv.sim.mj_model)


ASIMOV_TASKS = {"asimov": "Mjlab-Velocity-Flat-Asimov",
                "asimov_toe": "Mjlab-Velocity-Flat-Asimov-Toe"}


def asimov_flat_cfgs(name: str, num_envs: int, edit=None):
  """(JAX cfg, port cfg) of the Asimov ("asimov") or Asimov-Toe
  ("asimov_toe") flat task at `num_envs`, float64; `edit` is applied to
  both. The JAX cfg takes the port's Newton iteration count (30, where the
  JAX package's is 10: a declared divergence, see the port's
  tasks/velocity/config/asimov/env_cfgs.py)."""
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfgs = (_asimov_flat_cfg(toe=name == "asimov_toe"), load_env_cfg(ASIMOV_TASKS[name]))
  cfgs[0].sim.mujoco.iterations = cfgs[1].sim.mujoco.iterations
  for cfg in cfgs:
    cfg.scene.num_envs = num_envs
    cfg.sim.dtype = "float64"
    if edit is not None:
      edit(cfg)
  return cfgs


def asimov_flat_envs(name: str, num_envs: int, edit=None):
  """(JAX env, port env on the CPU) of an Asimov flat task, the port bound
  to the JAX env's compiled model."""
  return _envs(asimov_flat_cfgs(name, num_envs, edit))


def _flatten(prefix: str, tree: dict, out: dict) -> None:
  for k, v in tree.items():
    if isinstance(v, dict):
      _flatten(f"{prefix}/{k}", v, out)
    else:
      out[f"{prefix}/{k}"] = np.asarray(v)


def jax_env_arrays(jenv) -> dict[str, np.ndarray]:
  """The JAX env's current state by the names env_state_to_arrays writes;
  Data fields the (slim) state leaves None are left out."""
  out = {f"data.{k}": v for k, v in jax_data_arrays(jenv.data).items()
         if v.dtype != object}
  for f in jenv._dyn_model_fields:
    out[f"model.{f}"] = np.asarray(getattr(jenv.model, f))
  out["episode_length"] = np.asarray(jenv._episode_length)
  out["common_step_counter"] = np.asarray(jenv._common_step_counter)
  _flatten("ms", jenv._ms, out)
  return out


def carry(jenv, env, full: bool = False) -> dict[str, np.ndarray]:
  """Set the port env's state from the JAX env's; with `full`, first give
  the JAX env its derived Data fields (one forward), so both hold the same
  complete Data. Returns the arrays carried."""
  from mjlab_tpu_torch.envs import env_state_from_arrays

  if full:
    jenv._begin(jenv.state)
    jenv.ensure_derived()
  arrays = jax_env_arrays(jenv)
  env_state_from_arrays(env, arrays)
  return arrays


def certain_variant(cfg):
  """The G1 task with every draw certain (zero-width command, reset, push,
  friction and clock ranges; no standing envs; all heading envs; no
  observation noise; 0.3 s episodes), so that two generators give the same
  rollout."""
  twist = cfg.commands["twist"]
  twist.ranges.lin_vel_x = (0.5, 0.5)
  twist.ranges.lin_vel_y = (0.1, 0.1)
  twist.ranges.ang_vel_z = (0.2, 0.2)
  twist.ranges.heading = (0.3, 0.3)
  twist.rel_standing_envs = 0.0
  twist.rel_heading_envs = 1.0
  twist.resampling_time_range = (0.5, 0.5)
  cfg.curriculum["command_vel"].params["velocity_stages"] = [
    {"step": 0, "lin_vel_x": (0.5, 0.5), "ang_vel_z": (0.2, 0.2)},
  ]
  cfg.events["reset_base"].params["pose_range"] = {"x": (0.1, 0.1), "yaw": (0.5, 0.5)}
  push = cfg.events["push_robot"]
  push.interval_range_s = (0.4, 0.4)
  push.params["velocity_range"] = {"x": (0.3, 0.3), "y": (-0.2, -0.2)}
  cfg.events["foot_friction"].params["ranges"] = (0.7, 0.7)
  cfg.observations["policy"].enable_corruption = False
  cfg.episode_length_s = 0.3


def actions(seed: int, n_steps: int, num_envs: int, dim: int, scale: float = 0.5):
  rng = np.random.default_rng(seed)
  return [rng.normal(0.0, scale, (num_envs, dim)) for _ in range(n_steps)]


def numpy_tree(x):
  """Step outputs of either package as numpy (dicts kept)."""
  if isinstance(x, dict):
    return {k: numpy_tree(v) for k, v in x.items()}
  if isinstance(x, (tuple, list)):
    return type(x)(numpy_tree(v) for v in x)
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


# ---------------------------------------------------------------------------
# Learner state: the JAX RunnerState's leaves by name.
# ---------------------------------------------------------------------------


def jax_adam_state(opt_state):
  """The ScaleByAdamState inside mjlab_tpu.rl.ppo.make_optimizer's chain
  (clip_by_global_norm, inject_hyperparams(adam))."""
  return opt_state[1].inner_state[0]


def jax_learner_arrays(params, opt_state) -> dict[str, np.ndarray]:
  """flax params and the optimizer's Adam state by the names
  mjlab_tpu_torch.rl.runner.runner_state_to_arrays writes."""
  out: dict[str, np.ndarray] = {}
  _flatten("params", params["params"], out)
  adam = jax_adam_state(opt_state)
  _flatten("opt/mu", adam.mu["params"], out)
  _flatten("opt/nu", adam.nu["params"], out)
  out["opt/count"] = np.asarray(adam.count)
  return out


def jax_runner_arrays(state) -> dict[str, np.ndarray]:
  """A JAX RunnerState's learner leaves by the names
  mjlab_tpu_torch.rl.runner.runner_state_to_arrays writes."""
  out = jax_learner_arrays(state.train.params, state.train.opt_state)
  for which in ("actor_norm", "critic_norm"):
    norm = getattr(state, which)
    for f in ("mean", "var", "count"):
      out[f"{which}/{f}"] = np.asarray(getattr(norm, f))
  out["lr"] = np.asarray(state.train.lr)
  return out


def f64_tree(tree):
  """Every floating leaf of a JAX pytree in float64."""
  return jax.tree_util.tree_map(
    lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree
  )


def jax_learner_f64(state):
  """The RunnerState with its params, optimizer state, normalizers and lr
  in float64 (the JAX package keeps them float32 even under x64)."""
  train = state.train
  return state.replace(
    train=train.replace(params=f64_tree(train.params), opt_state=f64_tree(train.opt_state),
                        lr=f64_tree(train.lr)),
    actor_norm=f64_tree(state.actor_norm),
    critic_norm=f64_tree(state.critic_norm),
  )


# ---------------------------------------------------------------------------
# The G1 motion-tracking task in both packages.
# ---------------------------------------------------------------------------


def synthetic_motion_csv(path, n_frames: int = 61, input_fps: float = 30.0, nj: int = 29,
                         pitch: float = 0.0) -> str:
  """A smooth synthetic G1 trajectory as mocap CSV rows [base_pos, base_quat
  wxyz, joint_pos] (the JAX package's tests/test_csv_to_npz.py one): walk
  forward, yaw slowly, swing the joints; `pitch` adds a base pitch
  oscillation of that amplitude (rad)."""
  t = np.arange(n_frames) / input_fps
  base_pos = np.stack([0.4 * t, 0.05 * np.sin(t), 0.78 + 0.02 * np.cos(t)], -1)
  half_yaw, half_pitch = 0.15 * t, 0.5 * pitch * np.sin(1.5 * t)
  z = np.zeros_like(t)
  yaw_q = np.stack([np.cos(half_yaw), z, z, np.sin(half_yaw)], -1)
  pitch_q = np.stack([np.cos(half_pitch), z, np.sin(half_pitch), z], -1)
  w1, x1, y1, z1 = yaw_q.T
  w2, x2, y2, z2 = pitch_q.T
  base_quat = np.stack([
    w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
    w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
    w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ], -1)
  joint_pos = 0.3 * np.sin(2.0 * t[:, None] + np.linspace(0, np.pi, nj)[None, :])
  np.savetxt(path, np.concatenate([base_pos, base_quat, joint_pos], axis=-1), delimiter=",")
  return str(path)


def g1_motion_npz(directory, n_frames: int = 61) -> str:
  """A synthetic motion converted by the port's csv_to_npz (CPU)."""
  from mjlab_tpu_torch.scripts.csv_to_npz import process

  csv = synthetic_motion_csv(os.path.join(directory, f"motion{n_frames}.csv"), n_frames)
  path = os.path.join(directory, f"motion{n_frames}.npz")
  np.savez(path, **process(csv, device="cpu"))
  return path


def g1_tracking_cfgs(num_envs: int, motion_file: str, edit=None):
  """(JAX cfg, port cfg) of the G1 flat tracking task at `num_envs`,
  float64, on `motion_file`; `edit` is applied to both."""
  import copy

  from mjlab_tpu.tasks.tracking.config.g1.env_cfgs import G1_FLAT_TRACKING_ENV_CFG
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfgs = (copy.deepcopy(G1_FLAT_TRACKING_ENV_CFG),
          load_env_cfg("Mjlab-Tracking-Flat-Unitree-G1"))
  for cfg in cfgs:
    cfg.scene.num_envs = num_envs
    cfg.sim.dtype = "float64"
    cfg.commands["motion"].motion_file = motion_file
    if edit is not None:
      edit(cfg)
  return cfgs


def g1_tracking_envs(num_envs: int, motion_file: str, edit=None):
  """(JAX env, port env on the CPU) of the G1 tracking task, the port bound
  to the JAX env's compiled model."""
  from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  jcfg, tcfg = g1_tracking_cfgs(num_envs, motion_file, edit)
  jenv = JaxEnv(jcfg)
  return jenv, ManagerBasedRlEnv(tcfg, device="cpu", model=jenv.sim.mj_model)


def tracking_certain_variant(cfg):
  """The G1 tracking task with every draw certain: motions start at frame
  0, zero-width RSI offsets, push velocities and push clock (every 0.1 s),
  fixed base-COM, default-joint and foot-friction offsets, no observation
  noise; so that two generators give the same rollout."""
  motion = cfg.commands["motion"]
  motion.sampling_mode = "start"
  motion.pose_range = {"x": (0.02, 0.02), "y": (-0.01, -0.01), "yaw": (0.1, 0.1)}
  motion.velocity_range = {"x": (0.1, 0.1), "roll": (0.05, 0.05)}
  motion.joint_position_range = (0.03, 0.03)
  push = cfg.events["push_robot"]
  push.interval_range_s = (0.1, 0.1)
  push.params["velocity_range"] = {"x": (0.2, 0.2), "y": (-0.1, -0.1)}
  cfg.events["base_com"].params["ranges"] = {0: (0.01, 0.01), 1: (-0.02, -0.02),
                                             2: (0.03, 0.03)}
  cfg.events["add_joint_default_pos"].params["ranges"] = (0.005, 0.005)
  cfg.events["foot_friction"].params["ranges"] = (0.7, 0.7)
  cfg.observations["policy"].enable_corruption = False


def carry_to_jax(env, jenv) -> None:
  """Set the JAX env's state from the port env's (the reverse of `carry`):
  Data, the per-env Model leaves, the counters and every manager leaf."""
  from mjlab_tpu_torch.envs import env_state_to_arrays

  arrays = env_state_to_arrays(env)

  def like(ref, x):
    return jnp.asarray(x, dtype=jnp.asarray(ref).dtype)

  d = jenv._data
  contact = d.contact.replace(**{
    f.name: like(getattr(d.contact, f.name), arrays[f"data.contact.{f.name}"])
    for f in dataclasses.fields(d.contact)
  })
  jenv._data = d.replace(contact=contact, **{
    f.name: like(getattr(d, f.name), arrays[f"data.{f.name}"])
    for f in dataclasses.fields(d)
    if f.name != "contact" and f"data.{f.name}" in arrays and getattr(d, f.name) is not None
  })
  jenv._model = jenv._model.replace(**{
    f: like(getattr(jenv._model, f), arrays[f"model.{f}"]) for f in jenv._dyn_model_fields
  })
  jenv._episode_length = like(jenv._episode_length, arrays["episode_length"])
  jenv._common_step_counter = like(jenv._common_step_counter, arrays["common_step_counter"])

  def fill(prefix, tree):
    for k, v in tree.items():
      if isinstance(v, dict):
        fill(f"{prefix}/{k}", v)
      else:
        tree[k] = like(v, arrays[f"{prefix}/{k}"])

  fill("ms", jenv._ms)


# ---------------------------------------------------------------------------
# Env-level checks of the Asimov tasks, shared by tests/test_torch_asimov_env.py
# (Asimov) and tests/test_torch_asimov_toe_env.py (Asimov-Toe): the port's
# velocity-flat env against the JAX package's (float64, CPU), 2 envs. Each
# test file builds its task's pair of envs once (`asimov_checked_envs`).
# ---------------------------------------------------------------------------

ASIMOV_NUM_ENVS = 2
ASIMOV_STEP_TOL = 1e-8
ASIMOV_ACTION_TOL = 1e-12


def _asimov_no_corruption(cfg):
  cfg.observations["policy"].enable_corruption = False


def asimov_checked_envs(name: str):
  """(name, JAX env, port env) of an Asimov task, the JAX env reset."""
  jenv, env = asimov_flat_envs(name, ASIMOV_NUM_ENVS, _asimov_no_corruption)
  jenv.reset(seed=3)
  return name, jenv, env


def check_asimov_entity_indexing_equal(envs):
  """Asimov-Toe's 4 tendon actuators come first, as in the JAX entity (the
  port used to drop them: their trnid is a tendon's id, not a joint's)."""
  name, jenv, env = envs
  jr, tr = jenv.scene["robot"], env.scene["robot"]
  for f in dataclasses.fields(jr.indexing):
    a, b = getattr(tr.indexing, f.name), getattr(jr.indexing, f.name)
    if isinstance(b, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=f.name)
    else:
      assert a == b, f.name
  for kind in ("joint", "body", "geom", "site", "actuator", "tendon"):
    assert getattr(tr, f"{kind}_names") == getattr(jr, f"{kind}_names"), kind
  if name == "asimov_toe":
    assert tr.find_tendons(".*_A")[1] == jr.find_tendons(".*_A")[1]
    assert tr.actuator_names[:4] == ("left_ankle_A", "left_ankle_B", "right_ankle_A",
                                     "right_ankle_B")
    assert len(tr.indexing.ctrl_ids) == 14


def check_asimov_constants_and_defaults_equal(envs):
  from mjlab_tpu.asset_zoo.robots.asimov import asimov_constants as ja
  from mjlab_tpu.asset_zoo.robots.asimov import asimov_toe_constants as jt
  from mjlab_tpu_torch.asset_zoo.robots.asimov import asimov_constants as ta
  from mjlab_tpu_torch.asset_zoo.robots.asimov import asimov_toe_constants as tt

  name, jenv, env = envs
  jc, tc = (jt, tt) if name == "asimov_toe" else (ja, ta)
  assert tc.ASIMOV_ACTION_SCALE == jc.ASIMOV_ACTION_SCALE
  assert (dataclasses.asdict(tc.get_asimov_robot_cfg().init_state)
          == dataclasses.asdict(jc.get_asimov_robot_cfg().init_state))
  assert (tc.ASIMOV_ARTICULATION.soft_joint_pos_limit_factor
          == jc.ASIMOV_ARTICULATION.soft_joint_pos_limit_factor)
  for t, j in zip(tc.ASIMOV_ARTICULATION.actuators, jc.ASIMOV_ARTICULATION.actuators,
                  strict=True):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
  jd, td = jenv.scene["robot"].data, env.scene["robot"].data
  for f in ("default_root_state", "default_joint_pos", "default_joint_vel",
            "default_joint_stiffness", "default_joint_damping",
            "default_joint_pos_limits", "soft_joint_pos_limits"):
    np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                  err_msg=f)


def check_asimov_observation_and_action_layout_equal(envs):
  """The widths chip_smoke.py checks on the card are the JAX env's; the
  term order and action terms are the JAX cfg's."""
  import chip_smoke

  name, jenv, env = envs
  want = {g: tuple(int(x) for x in d) for g, d in
          jenv.observation_manager.group_obs_dim.items()}
  assert env.group_obs_dim == want
  assert (want["policy"][0], want["critic"][0]) == chip_smoke.ASIMOV_OBS_DIMS[
    ASIMOV_TASKS[name]]
  assert env.total_action_dim == jenv.action_manager.total_action_dim == 12
  for g in ("policy", "critic"):
    assert list(env.cfg.observations[g].terms) == list(jenv.cfg.observations[g].terms)
  assert list(env.cfg.actions) == list(jenv.cfg.actions)


def check_asimov_self_collision_finds_nothing(envs):
  """The feet-only collision preset gives the robot no self pair: the
  self_collision sensor's slot table matches nothing, and its `found` is
  all zero after a step in both packages."""
  _, jenv, env = envs
  jenv.step(jnp.zeros((ASIMOV_NUM_ENVS, env.total_action_dim)))
  env.step(torch.zeros((ASIMOV_NUM_ENVS, env.total_action_dim), dtype=env.dtype))
  got = env.scene["self_collision"].data.found.numpy()
  want = np.asarray(jenv.scene["self_collision"].data.found)
  assert got.shape == want.shape == (ASIMOV_NUM_ENVS, 1)
  assert not got.any() and not want.any()
  assert not env.scene["self_collision"]._slot_valid.any()


def check_asimov_ankle_action_term_matches_jax(envs):
  """AnklePrToTendonAction against the JAX term: processed actions (scale
  and the default offset of the 4 ankle joints) and the ctrl it writes —
  the A/B targets on the 4 tendon actuators, nothing elsewhere — at 1e-12;
  and a masked reset."""
  _, jenv, env = envs
  carry(jenv, env, full=True)
  jterm = jenv.action_manager.get_term("ankle_ab")
  tterm = env.action_manager.get_term("ankle_ab")
  a = np.random.default_rng(4).normal(0.0, 1.0, (ASIMOV_NUM_ENVS, 4))
  before = env.data.ctrl.clone()
  jterm.process_actions(jnp.asarray(a))
  tterm.process_actions(torch.as_tensor(a))
  assert_close(tterm.processed_actions.numpy(), jterm.processed_actions, ASIMOV_ACTION_TOL,
                  "processed")
  jterm.apply_actions()
  tterm.apply_actions()
  ctrl = env.data.ctrl.numpy()
  assert_close(ctrl, np.asarray(jenv.data.ctrl), ASIMOV_ACTION_TOL, "ctrl")
  # The targets land on the 4 tendon actuators (ctrl 0-3) only.
  np.testing.assert_array_equal(ctrl[:, 4:], before[:, 4:].numpy())
  pr = tterm.processed_actions.numpy()
  L, d = 0.04, 0.02
  want = np.stack([-L * pr[:, 0] - d * pr[:, 1], -L * pr[:, 0] + d * pr[:, 1],
                   L * pr[:, 2] - d * pr[:, 3], L * pr[:, 2] + d * pr[:, 3]], 1)
  np.testing.assert_allclose(ctrl[:, :4], want, rtol=0, atol=1e-15)
  mask = np.array([True, False])
  jterm.reset(jnp.asarray(mask))
  tterm.reset(torch.as_tensor(mask))
  assert_close(tterm.processed_actions.numpy(), jterm.processed_actions, 0.0, "reset")
  assert (tterm.processed_actions[0] == 0).all() and (tterm.processed_actions[1] != 0).all()


def check_asimov_env_steps_from_a_carried_state(envs):
  """3 consecutive env steps, each from the JAX env's state carried into
  the port: observations, rewards and every logged term, terminations, and
  the physics state, at 1e-8, or within twice the port's own spread where
  that is larger. The spread is the largest distance of 8 runs of the same
  step from the carried state with qpos moved by 1e-13 (relative, seeded).
  At the Asimov tasks' 30 Newton iterations the contact solve converges,
  and the solver's accept test then takes one of two branches by rounding:
  on Asimov's second step about half of such nudged runs land 1.2e-8 (in
  qvel, relative) from the others, which is the gap between the packages
  there (1.17e-8, the same at 100 iterations); 8 runs all on one branch
  would happen about once in 128."""
  from mjlab_tpu_torch.envs import env_state_from_arrays

  name, jenv, env = envs
  rng = np.random.default_rng(100)
  fields = ("qpos", "qvel", "sensordata", "ctrl")
  for a in actions(0, 3, ASIMOV_NUM_ENVS, env.total_action_dim):
    carried = carry(jenv, env)
    jout = numpy_tree(jenv.step(jnp.asarray(a)))
    tout = numpy_tree(env.step(torch.as_tensor(a)))
    state = {f: getattr(env.data, f).numpy().copy() for f in fields}
    spread = {k: 0.0 for k in ("policy", "critic", "reward", *fields)}
    for _ in range(8):
      nudged = dict(carried)
      q = carried["data.qpos"]
      nudged["data.qpos"] = q * (1 + 1e-13 * rng.standard_normal(q.shape))
      env_state_from_arrays(env, nudged)
      obs, rew, *_ = numpy_tree(env.step(torch.as_tensor(a)))
      for k, v in (("policy", obs["policy"]), ("critic", obs["critic"]), ("reward", rew),
                   *((f, getattr(env.data, f).numpy()) for f in fields)):
        ref = {"policy": tout[0]["policy"], "critic": tout[0]["critic"],
               "reward": tout[1]}.get(k, state.get(k))
        spread[k] = max(spread[k], float(np.abs(v - ref).max()) / max(1.0, float(np.abs(ref).max())))

    def tol(k):
      return max(ASIMOV_STEP_TOL, 2 * spread[k])

    (jobs, jrew, jterm, jto, jext), (tobs, trew, tterm, tto, text) = jout, tout
    for g in ("policy", "critic"):
      assert_close(tobs[g], jobs[g], tol(g), f"{name}:{g}")
    assert_close(trew, jrew, tol("reward"), f"{name}:reward")
    np.testing.assert_array_equal(tterm, jterm)
    np.testing.assert_array_equal(tto, jto)
    assert sorted(text["log"]) == sorted(jext["log"])
    for k, v in jext["log"].items():
      assert_close(text["log"][k], v, ASIMOV_STEP_TOL, f"{name}:{k}")
    for f in fields:
      assert_close(state[f], np.asarray(getattr(jenv.data, f)), tol(f),
                      f"{name}:{f} (port spread {spread[f]:.1e})")


# ---------------------------------------------------------------------------
# G1 on rough terrain and Go1 on flat ground: the scenes and the env pairs.
# The port takes a generated terrain's tile origins from its scene npz; an
# env bound to a live JAX model gets them beside its arrays
# (`with_terrain_origins`).
# ---------------------------------------------------------------------------


# The rough velocity tasks: the JAX package's env cfg (module, name), the
# port's task id and its committed scene (an attribute of the port's assets).
ROUGH = {
  "g1": ("mjlab_tpu.tasks.velocity.config.g1.env_cfgs", "UNITREE_G1_ROUGH_ENV_CFG",
         "Mjlab-Velocity-Rough-Unitree-G1", "G1_VELOCITY_ROUGH"),
  "go1": ("mjlab_tpu.tasks.velocity.config.go1.env_cfgs", "UNITREE_GO1_ROUGH_ENV_CFG",
          "Mjlab-Velocity-Rough-Unitree-Go1", "GO1_VELOCITY_ROUGH"),
  "asimov": ("mjlab_tpu.tasks.velocity.config.asimov.env_cfgs", "ASIMOV_ROUGH_ENV_CFG",
             "Mjlab-Velocity-Rough-Asimov", "ASIMOV_VELOCITY_ROUGH"),
  "asimov_toe": ("mjlab_tpu.tasks.velocity.config.asimov_toe.env_cfgs",
                 "ASIMOV_TOE_ROUGH_ENV_CFG", "Mjlab-Velocity-Rough-Asimov-Toe",
                 "ASIMOV_TOE_VELOCITY_ROUGH"),
}


def rough_jax_cfg(name: str, play: bool = False):
  """A fresh JAX rough cfg of `name` (a ROUGH key), with the play
  overrides when `play`. The Asimov cfgs keep the JAX package's 10 Newton
  iterations here: the npz records them, and the port's cfgs set 30 when
  they load it."""
  import copy
  import importlib

  module, attr, *_ = ROUGH[name]
  cfg = copy.deepcopy(getattr(importlib.import_module(module), attr))
  if play:
    from mjlab_tpu.scripts.play import apply_play_overrides

    apply_play_overrides(cfg)
  return cfg


@functools.lru_cache(maxsize=None)
def rough_scene(name: str, play: bool = False):
  """(compiled rough scene of `name` with the task's solver options, its
  tiles' origins (rows, cols, 3)) as the JAX package's scene layer builds
  them."""
  from mjlab_tpu.scene import Scene

  cfg = rough_jax_cfg(name, play)
  sc = Scene(cfg.scene)
  m = sc.compile()
  cfg.sim.mujoco.apply(m)
  return m, np.asarray(sc.terrain.terrain_origins)


def rough_npz(name: str, play: bool = False):
  """The committed rough (or play) scene of `name`."""
  from mjlab_tpu_torch import assets

  path = getattr(assets, ROUGH[name][3])
  return assets.play_scene(path) if play else path


def save_rough_npz(name: str, play: bool = False) -> None:
  """Regenerate a committed rough (or play) scene from a fresh compile."""
  from mjlab_tpu_torch import assets

  m, origins = rough_scene(name, play)
  assets.save_model_npz(m, rough_npz(name, play), terrain_origins=origins)



def go1_flat_jax_cfg():
  import copy

  from mjlab_tpu.tasks.velocity.config.go1.env_cfgs import UNITREE_GO1_FLAT_ENV_CFG

  return copy.deepcopy(UNITREE_GO1_FLAT_ENV_CFG)


def go1_mj_model() -> mujoco.MjModel:
  """The Go1 velocity-flat scene with the task's solver options."""
  return _compiled(go1_flat_jax_cfg())


def with_terrain_origins(mj, origins):
  """The port's namespace of a live model's arrays, with a generated
  terrain's tile origins."""
  from mjlab_tpu_torch.assets import model_arrays, model_namespace

  return model_namespace({**model_arrays(mj), "terrain_origins": np.asarray(origins)})


def _task_cfgs(jcfg, task: str, num_envs: int, edit=None):
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfgs = (jcfg, load_env_cfg(task))
  for cfg in cfgs:
    cfg.scene.num_envs = num_envs
    cfg.sim.dtype = "float64"
    if edit is not None:
      edit(cfg)
  return cfgs


def rough_envs(name: str, num_envs: int, edit=None):
  """(JAX env, port env on the CPU) of a rough task (a ROUGH key), float64;
  the port bound to the JAX env's compiled model and terrain origins. The
  JAX cfg takes the port's Newton iteration count (the Asimov tasks' 30,
  a declared divergence)."""
  from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  jcfg, tcfg = _task_cfgs(rough_jax_cfg(name), ROUGH[name][2], num_envs, edit)
  jcfg.sim.mujoco.iterations = tcfg.sim.mujoco.iterations
  jenv = JaxEnv(jcfg)
  model = with_terrain_origins(jenv.sim.mj_model, jenv.scene.terrain.terrain_origins)
  return jenv, ManagerBasedRlEnv(tcfg, device="cpu", model=model)



def go1_flat_envs(num_envs: int, edit=None):
  """(JAX env, port env on the CPU) of the Go1 flat task, float64."""
  return _envs(_task_cfgs(go1_flat_jax_cfg(), "Mjlab-Velocity-Flat-Unitree-Go1",
                          num_envs, edit))


def iteration_pair(jenv, env, jax_rl_cfg, rl_cfg, T: int, epochs: int = 2) -> dict:
  """One PPO iteration of the JAX package's runner and of the port's from
  one state: the JAX runner's env state, observations and learner (in
  float64, with normalizers of nonzero count), carried into the port, and
  JAX's draws (its rollout noise and epoch permutations, rebuilt from its
  keys as runner.py:192-193,161 and ppo.py:208-209 draw them). Returns both
  runners, their rollouts, advantages, returns and metrics."""
  from mjlab_tpu.rl import ppo as jppo
  from mjlab_tpu.rl.networks import ActorCritic as JaxActorCritic
  from mjlab_tpu.rl.networks import RunningNorm as JaxRunningNorm
  from mjlab_tpu.rl.runner import OnPolicyRunner as JaxRunner
  from mjlab_tpu_torch.rl import ppo as tppo
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner, runner_state_from_arrays

  num_envs = env.num_envs
  jr = JaxRunner(jenv, jax_rl_cfg)
  tr = OnPolicyRunner(env, rl_cfg)

  # The JAX runner's state, learner in float64, normalizers with history.
  rng = np.random.default_rng(0)

  def norm(dim):
    return JaxRunningNorm(mean=jnp.asarray(rng.normal(0, 0.5, dim)),
                          var=jnp.asarray(rng.uniform(0.5, 2.0, dim)),
                          count=jnp.asarray(200.0))

  state = jax_learner_f64(jr.state).replace(
    actor_norm=norm(tr.num_actor_obs), critic_norm=norm(tr.num_critic_obs)
  )
  carry(jenv, env)
  runner_state_from_arrays(tr, jax_runner_arrays(state))
  tr.obs = {k: torch.as_tensor(np.asarray(v)) for k, v in state.obs.items()}
  old = {"actor": state.actor_norm, "critic": state.critic_norm}

  # JAX's draws.
  rng_next, scan_key = jax.random.split(state.rng)
  keys = jax.random.split(scan_key, T)
  noise = np.stack([np.asarray(jax.random.normal(k, (num_envs, tr.num_actions), jnp.float64))
                    for k in keys])
  perms = []
  train_rng = state.train.rng
  for _ in range(epochs):
    train_rng, key = jax.random.split(train_rng)
    perms.append(np.asarray(jax.random.permutation(key, T * num_envs)))

  # The JAX iteration as _train_iteration runs it, keeping its rollout.
  c = (state.env_state, state.obs, state.train.params, state.actor_norm, state.critic_norm)
  c, (jbatch, extras) = jax.jit(lambda c, k: jax.lax.scan(jr._rollout_step, c, k))(c, keys)
  jstate, jmet = jax.jit(jr._post_rollout)(state, c, jbatch, extras, rng_next)
  last_c_obs = state.critic_norm(c[1]["critic"].astype(jnp.float32))
  jlast = jr.ac.apply(state.train.params, last_c_obs, method=JaxActorCritic.value)
  _, jadv, jret = jppo.prepare_update(jr.cfg.algorithm, jbatch, jlast)

  # The port's, in its two halves so that its advantages can be read.
  tbatch, logs = tr.rollout(torch.as_tensor(noise))
  with torch.no_grad():
    tlast = tr.ac.value(tr.critic_norm(tr.obs["critic"].to(torch.float32)))
  _, tadv, tret = tppo.prepare_update(tr.cfg.algorithm, tbatch, tlast)
  tmet = tr.update(tbatch, logs, torch.as_tensor(np.stack(perms)))
  return dict(jenv=jenv, jr=jr, tr=tr, jstate=jstate, jmet=jmet, jbatch=jbatch,
              tbatch=tbatch, tmet=tmet, adv=(jadv, tadv), ret=(jret, tret), old=old)


# ---------------------------------------------------------------------------
# The train entry point at a tiny size on the CPU, in a subprocess (the
# train-CLI tests of the Asimov, Go1 and G1 rough tasks).
# ---------------------------------------------------------------------------

TINY_CLI = {"env.scene.num_envs": "2", "agent.num_steps_per_env": "2",
            "agent.max_iterations": "1", "agent.device": "cpu"}


def train_cli(task: str, log_dir) -> str:
  """`python -m mjlab_tpu_torch.scripts.train <task>` with TINY_CLI into
  `log_dir`; returns its standard output."""
  import subprocess
  import sys
  from pathlib import Path

  root = Path(__file__).resolve().parents[1]
  args = [a for k, v in TINY_CLI.items() for a in (f"--{k}", v)]
  env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
  out = subprocess.run(
    [sys.executable, "-m", "mjlab_tpu_torch.scripts.train", task, *args,
     "--log_dir", str(log_dir)],
    cwd=root, env=env, capture_output=True, text=True, timeout=300,
  )
  assert out.returncode == 0, out.stderr[-3000:]
  return out.stdout


def check_trained(log_dir, stdout: str, obs_dim: int, num_actions: int) -> dict:
  """One iteration ran: finite final metrics and a TorchScript policy of
  the task's widths. Returns the final metrics."""
  import math
  from pathlib import Path

  log_dir = Path(log_dir)
  assert "[runner] 1 iterations" in stdout
  final = json.loads((log_dir / "final_metrics.json").read_text())
  assert final["iteration"] == 1
  for k in ("Loss/loss", "Loss/kl", "Loss/value_loss", "Loss/lr", "Train/mean_step_reward"):
    assert math.isfinite(final[k]), k
  policy = torch.jit.load(str(log_dir / "model_1_policy.pt"))
  act = policy(torch.zeros(3, obs_dim))
  assert act.shape == (3, num_actions) and torch.isfinite(act).all()
  return final


# ---------------------------------------------------------------------------
# Contact slots against the JAX package's: elementwise, and the terrain
# groups' (tests/test_torch_convex.py, tests/test_torch_rough_models.py).
# ---------------------------------------------------------------------------


def close_elementwise(got, want, what: str, tol: float = 1e-9) -> None:
  """|got − want| <= tol · max(1, |want|) elementwise."""
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
  assert np.all(err <= tol), f"{what}: largest relative error {err.max():.3e} > {tol:.0e}"


def contact_parts(c) -> list[np.ndarray]:
  """(dist, pos, frame, friction, solref, solimp, includemargin) of a
  Contact of either package, as numpy."""
  return [np.asarray(getattr(c, f)) for f in ("dist", "pos", "frame", "friction", "solref",
                                                 "solimp", "includemargin")]


def check_terrain_slots(got, want, what: str) -> int:
  """A terrain group's or the whole collision's slots against the JAX
  package's: the active set, every field at 1e-9 on every slot but the
  positions, which hold at 1e-9 on the active slots (the ones the
  constraint rows weigh). An inactive slot's position may be the SAT's
  midpoint of tied supports on a separated candidate, which each package's
  rounding picks (tests/test_torch_convex.py), and it moves nothing: its
  rows have D = 0. Returns the number of inactive slots whose positions
  differ."""
  (gd, gp, gf, *gparams), (wd, wp, wf, *wparams) = got, want
  wm = np.asarray(wparams[3])
  active = np.asarray(wd) < wm
  np.testing.assert_array_equal(np.asarray(gd) < np.asarray(gparams[3]), active)
  close_elementwise(gd, wd, f"{what} dist")
  close_elementwise(gf, wf, f"{what} frame")
  for name, g, w in zip(("friction", "solref", "solimp", "includemargin"), gparams, wparams):
    close_elementwise(g, w, f"{what} {name}")
  gp, wp = np.asarray(gp), np.asarray(wp)
  close_elementwise(gp[active], wp[active], f"{what} active pos")
  return int((np.abs(gp - wp) > 1e-9 * np.maximum(1.0, np.abs(wp))).any(-1).sum())


# ---------------------------------------------------------------------------
# The solver surface's scenes (mjlab_tpu_torch/assets/solver_scenes.py):
# MuJoCo, the JAX package and the port on one world each.
# ---------------------------------------------------------------------------

# The budget the port and the JAX package run the scenes at: 10 Newton
# iterations of 20 linesearch steps converge them to MuJoCo's optimum within
# the JAX tests' tolerances (CG keeps its scene's own 50 x 25), and run ~20x
# faster in eager torch than the compiled defaults of 100 x 50.
SCENE_BUDGET = {"iterations": 10, "ls_iterations": 20}


def solver_scene_model(name: str, cone=None, xml=None, budget=True):
  """The scene's MjModel with its test's option edits (and `cone`); with
  `budget`, SCENE_BUDGET too (not for a CG scene)."""
  from mjlab_tpu_torch.assets.solver_scenes import SCENES

  sc = SCENES[name]
  mj = mujoco.MjModel.from_xml_string(xml or sc.xml)
  for k, v in sc.opt.items():
    setattr(mj.opt, k, v)
  if cone is not None:
    mj.opt.cone = cone
  if budget and mj.opt.solver != mujoco.mjtSolver.mjSOL_CG:
    for k, v in SCENE_BUDGET.items():
      setattr(mj.opt, k, v)
  return mj


def solver_scene_run(name: str, steps: int, cone=None, xml=None, qvel=None,
                     ctrl_fn=None, checks=(0,), qpos=None):
  """`steps` substeps of a scene from its velocity in MuJoCo (its own
  converged solver: the scene's option edits, no budget), the JAX package
  and the port (float64, the budget), side by side. Returns the three
  final (qpos, qvel), the port's and JAX's models, and, for each step in
  `checks`, the JAX state before and after it (`jax_data_arrays`, one
  world)."""
  from mjlab_tpu_torch.assets.solver_scenes import SCENES

  mj_ref = solver_scene_model(name, cone, xml, budget=False)
  mj = solver_scene_model(name, cone, xml)
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  mjd = mujoco.MjData(mj_ref)
  qv = SCENES[name].qvel if qvel is None else qvel
  mjd.qvel[: len(qv)] = qv
  if qpos is not None:
    mjd.qpos[:] = qpos
  d = jphysics.make_data(jtp, jm).replace(
    qpos=jnp.asarray(mjd.qpos.copy()), qvel=jnp.asarray(mjd.qvel.copy()))
  td = to_torch(jax_data_arrays(jax.tree_util.tree_map(lambda x: x[None], d)))
  step = jax.jit(lambda dd: jphysics.step(jtp, jm, dd))
  from mjlab_tpu_torch import physics as tphysics

  stages = []
  for i in range(steps):
    if ctrl_fn is not None:
      c = ctrl_fn(i)
      mjd.ctrl[:] = c
      d = d.replace(ctrl=jnp.asarray(c))
      td = td.replace(ctrl=torch.tensor(c[None], dtype=torch.float64))
    pre = d
    d = step(d)
    if i in checks:
      stages.append(tuple(jax_data_arrays(jax.tree_util.tree_map(lambda x: x[None], x))
                          for x in (pre, d)))
    mujoco.mj_step(mj_ref, mjd)
    td = tphysics.step(ttp, tm, td)
  return SimpleNamespace(
    mujoco=(mjd.qpos.copy(), mjd.qvel.copy()),
    jax=(np.asarray(d.qpos)[None], np.asarray(d.qvel)[None]),
    port=(td.qpos.numpy(), td.qvel.numpy()),
    ttp=ttp, tm=tm, jtp=jtp, jm=jm, stages=stages,
  )
