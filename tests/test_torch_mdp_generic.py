"""The generic MDP terms of the PyTorch port against the JAX package (float64,
CPU), on the CartPole tutorial's env in both packages (4 envs) at a seeded
state carried from the JAX env (its base is fixed and level, so the base
velocities and flat_orientation_l2 read zeros in both): the observations
base_lin_vel,
base_ang_vel, root_pos_w, root_quat_w, joint_pos and joint_vel; the
terminations root_height_below_minimum and nan_detection (on a poisoned
qvel); the rewards is_terminated, joint_torques_l2, joint_acc_l2,
joint_vel_l2, posture, electrical_power_cost and flat_orientation_l2, each
to 1e-9; the curriculum reward_weight across its stages' steps; and
reset_root_state_uniform of a mocap entity (surface/mocap_entity.npz)
against the JAX function given the same draws."""

from __future__ import annotations

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu.envs import mdp as jmdp
from mjlab_tpu.managers.manager_term_config import RewardTermCfg as JRewardTermCfg
from mjlab_tpu.managers.scene_entity_config import SceneEntityCfg as JSceneEntityCfg
from mjlab_tpu.tasks.velocity.mdp import curriculums as jcurriculums
from mjlab_tpu_torch import tasks
from mjlab_tpu_torch.envs import ManagerBasedRlEnv
from mjlab_tpu_torch.envs import mdp as tmdp
from mjlab_tpu_torch.managers.manager_term_config import RewardTermCfg
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.tasks.velocity.mdp import curriculums as tcurriculums

NUM_ENVS = 4
TOL = 1e-9
POSTURE_STD = {"slide": 0.5, "hin.*": 0.2}


@pytest.fixture(scope="module")
def envs():
  """The JAX tutorial env and the port guide's, at one seeded state (qpos,
  qvel and ctrl) with complete Data in both."""
  had = tp.CARTPOLE_ID in tasks._REGISTRY
  jenv, _ = tp.cartpole_jax_env(NUM_ENVS, "float64")
  ns = tp.run_doc("CREATE_NEW_TASK_TORCH.md")
  if not had:
    tasks._REGISTRY.pop(tp.CARTPOLE_ID, None)
  cfg = copy.deepcopy(ns["create_cartpole_env_cfg"](num_envs=NUM_ENVS))
  cfg.sim.dtype = "float64"
  with tp.torch_threads(1):
    env = ManagerBasedRlEnv(cfg, device="cpu", model=jenv.sim.mj_model)
  rng = np.random.default_rng(11)
  jenv._begin(jenv.state)  # the slim Data: the forward below fills it
  d = jenv._data
  jenv._data = d.replace(
    qpos=jnp.asarray(rng.uniform(-0.8, 0.8, d.qpos.shape)),
    qvel=jnp.asarray(rng.uniform(-2.0, 2.0, d.qvel.shape)),
    ctrl=jnp.asarray(rng.uniform(-1.0, 1.0, d.ctrl.shape)),
  )
  jenv.ensure_derived()
  tp.carry(jenv, env)
  return jenv, env


def _cfgs(jenv, env, **kw):
  jcfg, tcfg = JSceneEntityCfg("robot", **kw), SceneEntityCfg("robot", **kw)
  jcfg.resolve(jenv.scene)
  tcfg.resolve(env.scene)
  return jcfg, tcfg


def _close(got, want, what):
  tp.assert_close(got.numpy(), np.asarray(want), TOL, what)


@pytest.mark.parametrize("name", ["base_lin_vel", "base_ang_vel", "root_pos_w", "root_quat_w",
                                  "joint_pos", "joint_vel"])
def test_observation_terms_equal_jax(envs, name):
  jenv, env = envs
  jcfg, tcfg = _cfgs(jenv, env)
  _close(getattr(tmdp, name)(env, tcfg), getattr(jmdp, name)(jenv, jcfg), name)


@pytest.mark.parametrize("name", ["is_terminated", "joint_torques_l2", "joint_acc_l2",
                                  "joint_vel_l2", "electrical_power_cost",
                                  "flat_orientation_l2"])
def test_reward_terms_equal_jax(envs, name):
  jenv, env = envs
  jcfg, tcfg = _cfgs(jenv, env)
  if name == "is_terminated":
    want, got = jmdp.is_terminated(jenv), tmdp.is_terminated(env)
  else:
    want, got = getattr(jmdp, name)(jenv, jcfg), getattr(tmdp, name)(env, tcfg)
  _close(got, want, name)
  if name not in ("is_terminated", "flat_orientation_l2"):  # CartPole's base is fixed, level
    assert np.abs(np.asarray(want)).max() > 0, name


def test_posture_resolves_its_std_and_equals_jax(envs):
  jenv, env = envs
  jcfg, tcfg = _cfgs(jenv, env, joint_names=(".*",))
  jterm = jmdp.posture(JRewardTermCfg(func=jmdp.posture, weight=1.0, params={
    "asset_cfg": jcfg, "std": POSTURE_STD}), jenv)
  tterm = tmdp.posture(RewardTermCfg(func=tmdp.posture, weight=1.0, params={
    "asset_cfg": tcfg, "std": POSTURE_STD}), env)
  np.testing.assert_array_equal(tterm.std.numpy(), np.asarray(jterm.std))
  _close(tterm(env, POSTURE_STD, tcfg), jterm(jenv, POSTURE_STD, jcfg), "posture")


def test_termination_terms_equal_jax(envs):
  """root_height_below_minimum at a height between the envs' roots; and
  nan_detection flags exactly the env whose qvel was poisoned."""
  jenv, env = envs
  jcfg, tcfg = _cfgs(jenv, env)
  height = float(np.median(np.asarray(jenv.scene["robot"].data.root_link_pos_w)[:, 2])) + 1e-3
  want = jmdp.root_height_below_minimum(jenv, height, jcfg)
  np.testing.assert_array_equal(tmdp.root_height_below_minimum(env, height, tcfg).numpy(),
                                np.asarray(want))
  jdata, tdata = jenv._data, env.data
  try:
    jenv._data = jdata.replace(qvel=jdata.qvel.at[2, 1].set(jnp.nan))
    qvel = tdata.qvel.clone()
    qvel[2, 1] = float("nan")
    env.data = tdata.replace(qvel=qvel)
    got, want = tmdp.nan_detection(env).numpy(), np.asarray(jmdp.nan_detection(jenv))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [False, False, True, False])
  finally:
    jenv._data, env.data = jdata, tdata


def test_reward_weight_stages_the_weight_in_the_reward_managers_state(envs):
  """Before, at and after each stage's step the staged weight is the JAX
  package's, in the reward manager's state, where compute reads it."""
  jenv, env = envs
  name = env.reward_manager.active_terms[0]
  stages = [{"step": 10, "weight": 2.5}, {"step": 20, "weight": -1.0}]
  jterm = jcurriculums.reward_weight(types.SimpleNamespace(params={}), jenv)
  tterm = tcurriculums.reward_weight(types.SimpleNamespace(params={}), env)
  jw, tw = jenv.ns("reward")["weights"], env.ns("reward")["weights"]
  old_j, old_t = jw[name], tw[name]
  mask = torch.ones(NUM_ENVS, dtype=torch.bool)
  try:
    seen = []
    for step in (5, 10, 11, 20, 21):
      jenv._common_step_counter = jnp.asarray(step, jnp.int32)
      env._common_step_counter = torch.tensor(step, dtype=torch.int32)
      want = jterm(jenv, jnp.asarray(mask.numpy()), name, stages)["weight"]
      got = tterm(env, mask, name, stages)["weight"]
      assert float(got) == float(want) == float(tw[name]) == float(jw[name]), step
      seen.append(float(got))
    assert seen == [float(old_t), float(old_t), 2.5, 2.5, -1.0], seen
  finally:
    jw[name], tw[name] = old_j, old_t


def _mocap_env(num_envs: int):
  """A float64 port env of the mocap scene whose target body is an entity
  of its own."""
  from mjlab_tpu_torch.assets.surface_scenes import SCENES
  from mjlab_tpu_torch.entity.entity import EntityCfg
  from mjlab_tpu_torch.envs.manager_based_env import ManagerBasedEnv, ManagerBasedEnvCfg
  from mjlab_tpu_torch.scene import SceneCfg
  from mjlab_tpu_torch.sim import SimulationCfg

  target = EntityCfg(init_state=EntityCfg.InitialStateCfg(pos=(0.5, 0.0, 0.6)))
  cfg = ManagerBasedEnvCfg(
    decimation=1, observations={}, actions={}, sim=SimulationCfg(dtype="float64"),
    scene=SceneCfg(num_envs=num_envs, entities={"target": target, "ball": EntityCfg()},
                   model_file=SCENES["mocap_entity"].path("mocap_entity")),
  )
  return ManagerBasedEnv(cfg, device="cpu")


def test_mocap_reset_equals_jax(monkeypatch):
  """The port's reset of a mocap entity writes the JAX function's pose
  (given the JAX function's draws) into the masked envs' mocap_pos and
  mocap_quat and leaves the others; a fixed-base entity that is not mocap
  raises the JAX package's ValueError."""
  from mjlab_tpu.envs.mdp import events as jevents
  from mjlab_tpu_torch.envs.mdp import events as tevents

  env = _mocap_env(6)
  asset = env.scene["target"]
  assert asset.is_fixed_base and asset.is_mocap
  pose_range = {"x": (-0.2, 0.3), "y": (-0.1, 0.1), "z": (0.0, 0.05), "yaw": (-1.0, 1.0),
                "roll": (-0.1, 0.2)}
  mask = torch.tensor([True, False, True, True, False, True])
  written = {}
  jasset = types.SimpleNamespace(
    data=types.SimpleNamespace(default_root_state=jnp.asarray(asset.data.default_root_state)),
    is_fixed_base=True, is_mocap=True,
    write_mocap_pose_to_sim=lambda pose, env_mask: written.update(pose=pose, mask=env_mask))
  keys = iter(jax.random.split(jax.random.PRNGKey(4), 4))
  jenv = types.SimpleNamespace(num_envs=6, dtype=jnp.float64, next_key=lambda: next(keys),
                               scene=_Scene(jnp.asarray(env.scene.env_origins),
                                            {"target": jasset}))
  draws = []
  jdraw = jevents._uniform6
  monkeypatch.setattr(jevents, "_uniform6", lambda *a: draws.append(jdraw(*a)) or draws[-1])
  jevents.reset_root_state_uniform(jenv, jnp.asarray(mask.numpy()), pose_range,
                                   asset_cfg=JSceneEntityCfg("target"))
  monkeypatch.setattr(tevents, "_uniform6",
                      lambda *a: torch.tensor(np.asarray(draws.pop(0))))
  before = (env.data.mocap_pos.clone(), env.data.mocap_quat.clone())
  tevents.reset_root_state_uniform(env, mask, pose_range, asset_cfg=SceneEntityCfg("target"))
  pose = np.asarray(written["pose"])
  mid = asset.indexing.mocap_id
  got_pos, got_quat = env.data.mocap_pos[:, mid], env.data.mocap_quat[:, mid]
  tp.assert_close(got_pos[mask].numpy(), pose[mask.numpy(), :3], TOL, "mocap_pos")
  tp.assert_close(got_quat[mask].numpy(), pose[mask.numpy(), 3:], TOL, "mocap_quat")
  assert torch.equal(got_pos[~mask], before[0][~mask, mid])
  assert torch.equal(got_quat[~mask], before[1][~mask, mid])
  assert not torch.equal(got_pos[mask], before[0][mask, mid])

  monkeypatch.undo()
  fixed = types.SimpleNamespace(is_fixed_base=True, is_mocap=False, data=asset.data)
  other = types.SimpleNamespace(scene=_Scene(env.scene.env_origins, {"robot": fixed}),
                                num_envs=6, generator=env.generator, dtype=env.dtype,
                                device=env.device)
  with pytest.raises(ValueError, match="fixed-base non-mocap entity 'robot'"):
    tevents.reset_root_state_uniform(other, mask, pose_range)


class _Scene(dict):
  """A scene's lookup by name and its env origins."""

  def __init__(self, env_origins, entities):
    super().__init__(entities)
    self.env_origins = env_origins
