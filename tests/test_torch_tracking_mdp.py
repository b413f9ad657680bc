"""The G1 tracking task's MDP in the PyTorch port against the JAX package
(float64, CPU), on one state: the port env resets and takes 5 env steps on
a synthetic motion, then its whole state (Data, the per-env Model leaves,
counters and every manager leaf) is carried into the JAX env. Then:

- the observation widths, 160 and 286, and every observation, reward
  (weighted) and termination term, within 1e-9;
- `randomize_field` on body_ipos and qpos0, within 1e-12 on certain
  draws, and the port's own draws inside their ranges on the selected
  elements only;
- the adaptive sampler's bin probabilities, entropy and top-1 metrics and
  failure counts, with adaptive_kernel_size 1 and 3, within 1e-12;
- reference-state initialization and the anchor-relative retargeting,
  with JAX's draws handed to the port, within 1e-9.

JAX's draws are read by wrapping `jax.random.categorical` and
`jax.random.uniform` while its command runs eagerly; the port's
`MotionCommand.draw_bins` and `draw_rsi` are replaced by the same draws."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

NUM_ENVS = 4
TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
  motion = tp.g1_motion_npz(str(tmp_path_factory.mktemp("motion")))
  jenv, env = tp.g1_tracking_envs(NUM_ENVS, motion)
  env.reset(seed=5)
  for a in tp.actions(1, 5, NUM_ENVS, env.total_action_dim):
    env.step(torch.as_tensor(a))
  return jenv, env


@pytest.fixture()
def carried(envs):
  """Both envs on the port env's state."""
  jenv, env = envs
  tp.carry_to_jax(env, jenv)
  jenv.step_log, env.step_log = {}, {}
  return jenv, env


def _terms(cfg_dict):
  return [(n, c) for n, c in cfg_dict.items() if c is not None]


def test_observation_widths(envs):
  jenv, env = envs
  assert env.group_obs_dim == {"policy": (160,), "critic": (286,)}
  assert dict(jenv.observation_manager.group_obs_dim) == env.group_obs_dim


@pytest.mark.parametrize("group", ["policy", "critic"])
def test_observation_terms(carried, group):
  jenv, env = carried
  jg, tg = jenv.cfg.observations[group], env.cfg.observations[group]
  assert [n for n, _ in _terms(jg.terms)] == [n for n, _ in _terms(tg.terms)]
  for (name, jc), (_, tc) in zip(_terms(jg.terms), _terms(tg.terms)):
    tp.assert_close(tc.func(env, **tc.params).numpy(), jc.func(jenv, **jc.params), TOL,
                    f"{group}/{name}")


def test_reward_terms(carried):
  jenv, env = carried
  names = [n for n, _ in _terms(jenv.cfg.rewards)]
  assert names == [n for n, _ in _terms(env.cfg.rewards)] and len(names) == 9
  for name in names:
    jc, tc = jenv.cfg.rewards[name], env.cfg.rewards[name]
    want = np.asarray(jc.func(jenv, **jc.params)) * jc.weight
    got = tc.func(env, **tc.params).numpy() * tc.weight
    tp.assert_close(got, want, TOL, name)
  assert np.asarray(jenv.cfg.rewards["motion_body_pos"].func(
    jenv, **jenv.cfg.rewards["motion_body_pos"].params)).min() < 1.0


def test_termination_terms(carried):
  from mjlab_tpu.tasks.tracking import mdp as jmdp
  from mjlab_tpu_torch.tasks.tracking import mdp as tmdp

  jenv, env = carried
  for name, jc in _terms(jenv.cfg.terminations):
    tc = env.cfg.terminations[name]
    np.testing.assert_array_equal(tc.func(env, **tc.params).numpy(),
                                  np.asarray(jc.func(jenv, **jc.params)), err_msg=name)
  # The two terms no G1 cfg names, at thresholds that split the envs.
  motion = {"command_name": "motion"}
  err = np.linalg.norm(np.asarray(jenv.command_manager.get_term("motion").anchor_pos_w
                                  - jenv.command_manager.get_term("motion").robot_anchor_pos_w),
                       axis=-1)
  for fn, params in (("bad_anchor_pos", {**motion, "threshold": float(np.median(err))}),
                     ("bad_motion_body_pos", {**motion, "threshold": 0.05,
                                              "body_names": ("pelvis", "torso_link")}),
                     ("bad_motion_body_pos_z_only", {**motion, "threshold": 0.0})):
    want = np.asarray(getattr(jmdp, fn)(jenv, **params))
    np.testing.assert_array_equal(getattr(tmdp, fn)(env, **params).numpy(), want, err_msg=fn)



def test_mdp_namespace_matches_jax():
  """The tracking mdp namespace holds the JAX one's 4 observations, 6
  rewards and 5 terminations, and the shared terms the task names."""
  import inspect

  from mjlab_tpu.tasks.tracking import mdp as jmdp
  from mjlab_tpu.tasks.tracking.mdp import observations, rewards, terminations
  from mjlab_tpu_torch.tasks.tracking import mdp as tmdp

  counts = []
  for module in (observations, rewards, terminations):
    names = [n for n, f in vars(module).items() if inspect.isfunction(f)
             and f.__module__ == module.__name__ and not n.startswith("_")]
    counts.append(len(names))
    for n in names:
      assert callable(getattr(tmdp, n)), n
  assert counts == [4, 6, 5]
  for n in ("generated_commands", "builtin_sensor", "joint_pos_rel", "joint_vel_rel",
            "last_action", "action_rate_l2", "joint_pos_limits", "self_collision_cost",
            "time_out", "push_by_setting_velocity", "randomize_field", "MotionCommandCfg"):
    assert hasattr(jmdp, n) and hasattr(tmdp, n), n


def test_motion_metrics(carried):
  jenv, env = carried
  jcmd, cmd = (e.command_manager.get_term("motion") for e in (jenv, env))
  jcmd._update_metrics()
  cmd._update_metrics()
  for k, v in jcmd.state["metrics"].items():
    if k.startswith("error_"):
      tp.assert_close(cmd.state["metrics"][k].numpy(), v, TOL, k)


def test_randomize_field_body_ipos_and_qpos0(carried):
  from mjlab_tpu.envs.mdp import events as jev
  from mjlab_tpu_torch.envs.mdp import events as tev

  jenv, env = carried
  mask = np.array([True, False, True, True])
  saved = (jenv._model, env.model)
  try:
    for name, ranges in (("base_com", {0: (0.01, 0.01), 2: (-0.03, -0.03)}),
                         ("add_joint_default_pos", (0.004, 0.004))):
      jp, tpar = jenv.cfg.events[name].params, env.cfg.events[name].params
      jev.randomize_field(jenv, jnp.asarray(mask), **{**jp, "ranges": ranges})
      tev.randomize_field(env, torch.as_tensor(mask), **{**tpar, "ranges": ranges})
      field = jp["field"]
      tp.assert_close(getattr(env.model, field).numpy(),
                      np.asarray(getattr(jenv.model, field)), 1e-12, field)
  finally:
    jenv._model, env.model = saved

  # The port's own draws: inside the ranges, on the selected elements only.
  robot = env.scene["robot"]
  before = {f: getattr(env.model, f).clone() for f in ("body_ipos", "qpos0")}
  try:
    for name in ("base_com", "add_joint_default_pos"):
      tev.randomize_field(env, torch.as_tensor(mask), **env.cfg.events[name].params)
    torso = int(robot.indexing.body_ids[robot.body_names.index("torso_link")])
    d_ipos = (env.model.body_ipos - before["body_ipos"]).numpy()
    d_q = (env.model.qpos0 - before["qpos0"]).numpy()
    lim = np.array([0.025, 0.05, 0.05])
    assert (np.abs(d_ipos[mask, torso]) <= lim).all() and (d_ipos[mask, torso] != 0).all()
    assert np.count_nonzero(d_ipos) == 3 * mask.sum() and not d_ipos[~mask].any()
    qa = robot.indexing.joint_q_adr
    assert (np.abs(d_q[mask][:, qa]) <= 0.01).all() and (d_q[mask][:, qa] != 0).all()
    assert np.count_nonzero(d_q) == len(qa) * mask.sum()
  finally:
    env.model = dataclasses.replace(env.model, **before)


class JaxDraws:
  """Records the draws of JAX code run eagerly: each categorical's logits
  and result, each uniform's unit draw (before minval/maxval)."""

  def __init__(self, monkeypatch):
    self.calls = []
    self.monkeypatch = monkeypatch
    categorical, uniform = jax.random.categorical, jax.random.uniform

    def record_categorical(key, logits, axis=-1, shape=None, **kw):
      out = categorical(key, logits, axis=axis, shape=shape, **kw)
      self.calls.append(("categorical", np.asarray(logits), np.asarray(out)))
      return out

    def record_uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
      self.calls.append(("uniform", np.asarray(uniform(key, shape, dtype))))
      return uniform(key, shape, dtype, minval, maxval)

    monkeypatch.setattr(jax.random, "categorical", record_categorical)
    monkeypatch.setattr(jax.random, "uniform", record_uniform)

  def hand_to(self, cmd) -> None:
    """Replace the port command's draws by the recorded ones, in order: a
    categorical and a uniform make one draw_bins, three uniforms one
    draw_rsi."""
    bins, rsi = [], []
    calls = list(self.calls)
    while calls:
      if calls[0][0] == "categorical":
        bins.append((torch.tensor(calls[0][2]), torch.tensor(calls[1][1])))
        calls = calls[2:]
      else:
        rsi.append(tuple(torch.tensor(c[1]) for c in calls[:3]))
        calls = calls[3:]
    self.monkeypatch.setattr(cmd, "draw_bins", lambda probs: bins.pop(0), raising=False)
    self.monkeypatch.setattr(cmd, "draw_rsi", lambda: rsi.pop(0), raising=False)
    self.left = (bins, rsi)


def _set_command_state(jenv, env, time_steps, terminated, bin_failed_count):
  for e, arr in ((jenv, jnp.asarray), (env, torch.as_tensor)):
    st = e.command_manager.get_term("motion").state
    st["time_steps"] = arr(time_steps.astype(np.int32))
    st["bin_failed_count"] = arr(bin_failed_count)
    e.ns("termination")["terminated"] = arr(terminated)


@pytest.mark.parametrize("kernel_size", [1, 3])
def test_adaptive_sampler(carried, monkeypatch, kernel_size):
  jenv, env = carried
  jcmd, cmd = (e.command_manager.get_term("motion") for e in (jenv, env))
  assert cmd.bin_count == jcmd.bin_count == 3  # 100 frames at 50 fps
  k = np.array([0.8**i for i in range(kernel_size)])
  for c in (jcmd, cmd):
    c.cfg.adaptive_kernel_size = kernel_size
  jcmd.kernel = k / k.sum()
  cmd.kernel = torch.as_tensor(k / k.sum())
  rng = np.random.default_rng(kernel_size)
  _set_command_state(jenv, env, time_steps=np.array([10, 40, 70, 95]),
                     terminated=np.array([True, False, True, True]),
                     bin_failed_count=rng.uniform(0.0, 0.3, 3))
  mask = np.array([True, True, False, True])
  draws = JaxDraws(monkeypatch)
  want_steps = np.asarray(jcmd._sample_time_steps(jnp.asarray(mask)))
  draws.hand_to(cmd)
  got_steps = cmd._sample_time_steps(torch.as_tensor(mask))
  np.testing.assert_array_equal(got_steps.numpy(), want_steps)
  logits = draws.calls[0][1]
  from mjlab_tpu_torch.tasks.tracking.mdp.commands import adaptive_sampling_probs

  probs = adaptive_sampling_probs(cmd.state["bin_failed_count"], 0.1, cmd.kernel)
  tp.assert_close(probs.numpy(), np.exp(logits) - 1e-12, 1e-12, "probs")
  assert abs(float(probs.sum()) - 1.0) < 1e-14
  # Failures of the masked, terminated envs 0 and 3 in bins 0 and 2.
  np.testing.assert_array_equal(cmd.state["current_bin_failed"].numpy(), [1.0, 0.0, 1.0])
  for k_, v in jcmd.state.items():
    if k_ in ("current_bin_failed", "bin_failed_count"):
      tp.assert_close(cmd.state[k_].numpy(), v, 1e-12, k_)
  for k_ in ("sampling_entropy", "sampling_top1_prob", "sampling_top1_bin"):
    tp.assert_close(cmd.state["metrics"][k_].numpy(), jcmd.state["metrics"][k_], 1e-12, k_)


def test_adaptive_draws_follow_the_probabilities(envs):
  """The port's inverse-CDF draw of bins on the device: frequencies over
  many draws match the probabilities."""
  from mjlab_tpu_torch.tasks.tracking.mdp.commands import time_steps_from_draws

  _, env = envs
  cmd = env.command_manager.get_term("motion")
  probs = torch.tensor([0.5, 0.1, 0.4], dtype=torch.float64)
  counts = torch.zeros(3, dtype=torch.float64)
  for _ in range(500):
    bins, frac = cmd.draw_bins(probs)
    counts += torch.bincount(bins, minlength=3)
    assert ((frac >= 0) & (frac < 1)).all()
  np.testing.assert_allclose((counts / counts.sum()).numpy(), probs.numpy(), atol=0.02)
  steps = time_steps_from_draws(torch.tensor([0, 2, 2]), torch.tensor([0.0, 0.0, 0.999]), 3, 100)
  np.testing.assert_array_equal(steps.numpy(), [0, 66, 98])


def test_rsi_and_retargeting_with_handed_draws(carried, monkeypatch):
  """_resample_command on a mask (reference-state initialization: motion
  frames, root pose and velocity offsets, joint offsets clipped to the soft
  limits, written into the robot's state), then _update_command (the clock,
  the in-step resample of the envs whose motion ended, the anchor-relative
  retargeting, the failure averages), with JAX's draws."""
  jenv, env = carried
  jcmd, cmd = (e.command_manager.get_term("motion") for e in (jenv, env))
  total = cmd.motion.time_step_total
  _set_command_state(jenv, env, time_steps=np.array([3, total - 1, 50, total - 2]),
                     terminated=np.array([False, True, True, False]),
                     bin_failed_count=np.array([0.2, 0.05, 0.1]))
  mask = np.array([True, False, True, False])
  draws = JaxDraws(monkeypatch)
  jcmd._resample_command(jnp.asarray(mask))
  jcmd._update_command()
  assert [c[0] for c in draws.calls].count("categorical") == 2
  draws.hand_to(cmd)
  cmd._resample_command(torch.as_tensor(mask))
  cmd._update_command()
  assert draws.left == ([], [])
  st, jst = cmd.state, jcmd.state
  np.testing.assert_array_equal(st["time_steps"].numpy(), jst["time_steps"])
  for k in ("body_pos_relative_w", "body_quat_relative_w", "bin_failed_count",
            "current_bin_failed"):
    tp.assert_close(st[k].numpy(), jst[k], TOL, k)
  for f in ("qpos", "qvel", "qfrc_applied", "xfrc_applied", "ctrl"):
    tp.assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(jenv.data, f)), TOL, f)
