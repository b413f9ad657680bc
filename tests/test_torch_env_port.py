"""The PyTorch port's G1 velocity-flat env on its own (CPU): its draws
(seeded, per env, in range), the features outside the port that raise
`NotImplementedError` naming themselves, the env-layer features that run,
and the entry points' default device."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu_torch.envs import ManagerBasedRlEnv, env_state_to_arrays
from mjlab_tpu_torch.tasks import list_tasks, load_env_cfg, make_env

TASK = "Mjlab-Velocity-Flat-Unitree-G1"
NUM_ENVS = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


def _env(seed: int | None = None, edit=None, num_envs: int = NUM_ENVS) -> ManagerBasedRlEnv:
  cfg = load_env_cfg(TASK)
  cfg.scene.num_envs = num_envs
  cfg.seed = seed
  if edit is not None:
    edit(cfg)
  return ManagerBasedRlEnv(cfg, device="cpu")


def _reset_state(seed: int, reset_seed: int):
  env = _env(seed)
  obs, _ = env.reset(seed=reset_seed)
  return env, obs, env_state_to_arrays(env)


@pytest.fixture(scope="module")
def reset_env():
  return _reset_state(0, 7)


def test_same_seed_same_draws(reset_env):
  _, obs, st = reset_env
  _, obs2, st2 = _reset_state(0, 7)
  for g in obs:
    np.testing.assert_array_equal(obs[g].numpy(), obs2[g].numpy())
  assert st.keys() == st2.keys()
  for k in st:
    np.testing.assert_array_equal(st[k], st2[k], err_msg=k)


def test_other_seed_other_draws(reset_env):
  _, obs, st = reset_env
  _, obs2, st2 = _reset_state(0, 8)
  assert not np.array_equal(st["ms/command/twist/vel_command_b"],
                            st2["ms/command/twist/vel_command_b"])
  assert not np.array_equal(obs["policy"].numpy(), obs2["policy"].numpy())
  _, _, st3 = _reset_state(1, 7)  # the build seed draws the startup friction
  assert not np.array_equal(st["model.geom_friction"], st3["model.geom_friction"])


def test_envs_draw_apart_and_in_range(reset_env):
  env, _, st = reset_env
  robot = env.scene["robot"]
  foot = np.asarray([robot.indexing.geom_ids[i]
                     for i in robot.find_geoms(r".*_foot[1-7]_collision")[0]])
  assert len(foot) == 14
  fric = st["model.geom_friction"]
  nominal = env.sim.unbatched_model.geom_friction.numpy()
  others = np.setdiff1d(np.arange(fric.shape[1]), foot)
  assert np.all((fric[:, foot, 0] >= 0.3) & (fric[:, foot, 0] <= 1.2))
  assert np.unique(fric[:, foot, 0]).size == NUM_ENVS * 14
  np.testing.assert_array_equal(fric[:, foot, 1:], np.broadcast_to(
    nominal[foot, 1:], fric[:, foot, 1:].shape))
  np.testing.assert_array_equal(fric[:, others], np.broadcast_to(
    nominal[others], fric[:, others].shape))
  cmd = st["ms/command/twist/vel_command_b"]
  standing = st["ms/command/twist/is_standing_env"]
  assert np.all(cmd[standing] == 0.0)
  assert np.all(np.abs(cmd[~standing, :2]) <= 1.0) and np.unique(cmd[:, 0]).size > 8
  heading = st["ms/command/twist/heading_target"]
  assert np.all(np.abs(heading) <= math.pi) and np.unique(heading).size == NUM_ENVS
  t = st["ms/command/twist/time_left"] + env.step_dt  # one compute after the draw
  assert np.all((t >= 3.0) & (t <= 8.0))
  push = st["ms/event/interval_time_left/push_robot"]
  assert np.all((push >= 1.0) & (push <= 3.0)) and np.unique(push).size == NUM_ENVS
  root = env.data.qpos[:, :3].numpy() - env.scene.env_origins.numpy()
  assert np.all(np.abs(root[:, :2]) <= 0.5) and np.unique(root[:, 0]).size == NUM_ENVS
  np.testing.assert_allclose(root[:, 2], 0.76)


def test_step_runs_every_term(reset_env):
  env, _, _ = reset_env
  assert env.group_obs_dim == {"policy": (99,), "critic": (111,)}
  assert env.total_action_dim == 29
  assert len(env.reward_manager.active_terms) == 13
  assert env.event_manager.active_terms == {
    "reset": ["reset_base", "reset_robot_joints"], "interval": ["push_robot"],
    "startup": ["foot_friction"],
  }
  gen = torch.Generator().manual_seed(0)
  for _ in range(2):
    a = torch.randn(NUM_ENVS, 29, generator=gen)
    obs, rew, term, tout, extras = env.step(a)
  assert obs["policy"].shape == (NUM_ENVS, 99) and obs["critic"].shape == (NUM_ENVS, 111)
  assert torch.isfinite(obs["policy"]).all() and torch.isfinite(rew).all()
  assert term.dtype == torch.bool and tout.dtype == torch.bool
  assert "Metrics/angular_momentum_mean" in extras["log"]


def test_make_env_from_the_registry():
  assert TASK in list_tasks()
  env = make_env(TASK, num_envs=2, device="cpu", seed=3, episode_length_s=1.0)
  assert env.num_envs == 2 and env.max_episode_length == 50
  with pytest.raises(KeyError, match="Unknown task"):
    load_env_cfg("Mjlab-Velocity-Rough-Unitree-H1")  # registered in neither package


def test_default_device_is_cuda():
  """No device asks for CUDA; where there is none it raises and never
  falls back to the CPU."""
  cfg = load_env_cfg(TASK)
  cfg.scene.num_envs = 2
  if torch.cuda.is_available():
    assert ManagerBasedRlEnv(cfg).device.type == "cuda"
    return
  with pytest.raises((RuntimeError, AssertionError)):
    ManagerBasedRlEnv(cfg)


def _edit_generator(cfg):
  """A generator terrain over a scene compiled with a generated terrain:
  the port composes a generator terrain only onto a scene compiled with
  the plane (its terrain body one plane geom)."""
  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.scene import TerrainImporterCfg
  from mjlab_tpu_torch.terrains.config import ROUGH_TERRAINS_CFG

  cfg.scene.terrain = TerrainImporterCfg(
    terrain_type="generator", terrain_generator=ROUGH_TERRAINS_CFG
  )
  cfg.scene.model_file = assets.G1_VELOCITY_ROUGH


def _edit_history(cfg):
  cfg.observations["policy"].terms["joint_pos"].history_length = 3


def _edit_group_history(cfg):
  """On the policy group: the critic shares its term cfgs, so they carry
  the override into it (a group history on the critic alone raises in
  both packages: tests/test_torch_observation_pipeline.py)."""
  cfg.observations["policy"].history_length = 2


def _edit_delay(cfg):
  cfg.observations["policy"].terms["joint_vel"].delay_max_lag = 2


def _edit_noise_model(cfg):
  from mjlab_tpu_torch.utils.noise import NoiseModelCfg

  cfg.observations["policy"].terms["joint_vel"].noise = NoiseModelCfg()


def _edit_reduce(cfg):
  cfg.scene.sensors[0].reduce = "maxforce"


def _edit_field(cfg):
  cfg.scene.sensors[0].fields = ("found", "force", "pos")


def _edit_dr_field(cfg):
  """A per-env field outside the JAX package's FIELD_SPECS, which the
  physics does not read per env."""
  ev = cfg.events["foot_friction"]
  ev.params["field"] = "geom_size"


def _edit_init_velocity(cfg):
  cfg.commands["twist"].init_velocity_prob = 0.5


def _edit_action_clip(cfg):
  cfg.actions["joint_pos"].clip = (-1.0, 1.0)


@pytest.mark.parametrize("edit,name", [
  (_edit_generator, "generator"),
  (_edit_dr_field, "geom_size"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_features_outside_the_port_raise(edit, name):
  with pytest.raises(NotImplementedError, match=name):
    _env(0, edit)


FEATURES = [
  (_edit_history, "history"),
  (_edit_group_history, "group history"),
  (_edit_delay, "delay"),
  (_edit_noise_model, "noise models"),
  (_edit_reduce, "maxforce"),
  (_edit_field, "pos"),
  (_edit_init_velocity, "init_velocity_prob"),
  (_edit_action_clip, "clip"),
]


@pytest.fixture(scope="module")
def feature_envs():
  """Two 2-env builds, each reset and stepped once at an action beyond the
  clip: the policy group's history alone (it overrides the terms'), and
  every other feature of FEATURES together. {group history?: (env, obs,
  reward)}."""
  out = {}
  for group in (False, True):
    edits = [e for e, n in FEATURES if (n == "group history") == group]
    env = _env(0, lambda cfg, edits=edits: [e(cfg) for e in edits], num_envs=2)
    env.reset(seed=0)
    obs, rew, *_ = env.step(torch.full((2, env.total_action_dim), 20.0))
    out[group] = (env, obs, rew)
  return out


@pytest.mark.parametrize("edit,name", FEATURES,
                         ids=lambda x: x if isinstance(x, str) else None)
def test_env_layer_features_run(feature_envs, edit, name):
  """The env-layer features that raised until the port had them build,
  reset and step with finite outputs, each live in its build (their parity
  with the JAX package: tests/test_torch_observation_pipeline.py,
  test_torch_contact_sensor.py and test_torch_env_surface.py)."""
  env, obs, rew = feature_envs[name == "group history"]
  # The groups share their term cfgs, and with them a term's history.
  widths = (2 * 99, 2 * 99 + 12) if name == "group history" else (99 + 2 * 29, 111 + 2 * 29)
  assert (obs["policy"].shape[1], obs["critic"].shape[1]) == widths
  assert torch.isfinite(rew).all() and all(torch.isfinite(v).all() for v in obs.values())
  state = env.ns("observation")
  sensor = env.scene[env.cfg.scene.sensors[0].name]
  live = {
    "history": lambda: "policy/joint_pos" in state["history"],
    "group history": lambda: all(f"policy/{t}" in state["history"]
                                 for t in env.cfg.observations["policy"].terms),
    "delay": lambda: "policy/joint_vel" in state["delay"],
    "noise models": lambda: "policy/joint_vel" in state["noise"],
    "maxforce": lambda: sensor.cfg.reduce == "maxforce" and torch.isfinite(sensor.data.force).all(),
    "pos": lambda: sensor.data.pos is not None and torch.isfinite(sensor.data.pos).all(),
    "init_velocity_prob": lambda: env.command_manager.get_term("twist").cfg.init_velocity_prob
    == 0.5,
    "clip": lambda: env.action_manager.get_term("joint_pos").processed_actions.abs().max()
    == 1.0,
  }[name]
  assert live()


def test_terrain_curriculum_raises():
  """The terrain-level curriculum needs a generator terrain: on the plane
  it raises (its parity with the JAX package on a generator terrain:
  tests/test_torch_terrain_curriculum.py)."""
  from mjlab_tpu_torch.tasks.velocity.mdp import terrain_levels_vel

  env = _env(0)
  mask = torch.ones(NUM_ENVS, dtype=torch.bool)
  with pytest.raises(ValueError, match="terrain_levels_vel"):
    terrain_levels_vel(env, mask, "twist")


@pytest.mark.parametrize("kind", ["constant", "uniform", "gaussian"])
def test_observation_noise(kind):
  from mjlab_tpu_torch.utils import noise

  cfg = {"constant": noise.ConstantNoiseCfg(bias=0.25),
         "uniform": noise.UniformNoiseCfg(n_min=-0.5, n_max=0.3),
         "gaussian": noise.GaussianNoiseCfg(mean=0.1, std=0.2)}[kind]
  data = torch.linspace(-1.0, 1.0, 20000, dtype=torch.float64).reshape(4, 5000)
  draw = [cfg.apply(torch.Generator().manual_seed(s), data) - data for s in (0, 0, 1)]
  torch.testing.assert_close(draw[0], draw[1], rtol=0, atol=0)  # seeded
  n = draw[0]
  if kind == "constant":
    torch.testing.assert_close(n, torch.full_like(n, 0.25), rtol=0, atol=1e-15)
    return
  assert not torch.equal(draw[0], draw[2])
  if kind == "uniform":
    assert n.min() >= -0.5 and n.max() <= 0.3 and abs(n.mean().item() + 0.1) < 0.01
  else:
    assert abs(n.mean().item() - 0.1) < 0.01 and abs(n.std().item() - 0.2) < 0.01
