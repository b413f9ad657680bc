"""The env-layer surface users set in their own cfgs, through the G1
velocity-flat env of both packages (float64, CPU, 3 envs): the sim-to-real
cfg of chip_smoke.py's phase 15 (`chip_smoke.sim_to_real_edit`: per-env
mass, inertia, armature, damping and actuator-gain randomization, pushes as
an external wrench, a 3-step policy history, a delayed joint_vel, a
joint_pos noise model with a per-env bias, clipped actions,
init_velocity_prob, the feet sensor by maxforce with torque and dist, and a
world-frame sensor of every field).

The JAX package's `init_velocity_prob` calls `Entity.write_root_state`,
which its Entity lacks (ROADMAP Queue C); the JAX env here gets that method
as `write_root_state_to_sim`, the port's call.

The env steps run the cfg with its per-step draws made certain
(`chip_smoke.certain_surface_variant`: zero-width noise, push and clock
ranges, held delay lags, the task's certain variant); the startup draws
(the randomized leaves, the delay lags, the biases) are JAX's, carried into
the port. The eager checks hand JAX's draws across."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity as tp
from mjlab_tpu.entity.entity import Entity as JaxEntity

NUM_ENVS = 3
# One substep per env step: the JAX env step unrolls its decimation loop,
# and a compile of 4 substeps took twice as long on the CPU. The env layer
# runs once per env step, so 8 steps of 1 substep run it twice as often as
# 4 of the task's 4 (the decimation loop: tests/test_torch_env.py).
DECIMATION = 1
STEPS = 8
TOL = 1e-8
# Read before any fixture gives the JAX Entity the method.
JAX_ENTITY_HAS_WRITE_ROOT_STATE = hasattr(JaxEntity, "write_root_state")


def surface_cfgs():
  """(JAX cfg, port cfg): the G1 flat task at NUM_ENVS, float64, with
  `sim_to_real_edit` and `certain_surface_variant`, at DECIMATION with the
  push every 2 env steps."""
  jcfg, tcfg = tp.g1_flat_cfgs(NUM_ENVS)
  chip_smoke.sim_to_real_edit(jcfg, tp.jax_cfg_modules())
  chip_smoke.sim_to_real_edit(tcfg)
  for cfg in (jcfg, tcfg):
    chip_smoke.certain_surface_variant(cfg)
    cfg.decimation = DECIMATION
    dt = cfg.sim.mujoco.timestep * DECIMATION
    cfg.events["push_wrench"].interval_range_s = (2 * dt, 2 * dt)
  return jcfg, tcfg


@pytest.fixture(scope="module")
def envs():
  """(JAX env, port env) of the certain surface cfg, the port holding the
  JAX env's post-build state (its startup leaves, delay lags, and per-env
  joint_pos biases set from a seed), and the port env's own startup leaves
  before the carry."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  with pytest.MonkeyPatch.context() as m, tp.torch_threads(1):
    m.setattr(JaxEntity, "write_root_state", JaxEntity.write_root_state_to_sim, raising=False)
    jcfg, tcfg = surface_cfgs()
    from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv

    jenv = JaxEnv(jcfg)
    env = ManagerBasedRlEnv(tcfg, device="cpu", model=jenv.sim.mj_model)
    own = chip_smoke.surface_leaf_checks(env, rel=1e-12)
    bias = jenv._ms["observation"]["noise"]["policy/joint_pos"]
    bias["bias"] = jnp.asarray(np.random.default_rng(4).uniform(-0.02, 0.02, (NUM_ENVS, 29)))
    # A fresh buffer per leaf: the built state shares zeros between leaves,
    # which the jitted step (it donates its state) refuses; no reset runs.
    jenv.state = jax.tree_util.tree_map(jnp.copy, jenv._pack_state())
    tp.carry(jenv, env, full=True)
    yield jenv, env, own


def test_jax_init_velocity_prob_needs_write_root_state():
  """The fault the fixture works around: the JAX package's velocity command
  calls a method its Entity does not have."""
  assert not JAX_ENTITY_HAS_WRITE_ROOT_STATE


def test_surface_cfg_shapes_and_own_startup(envs):
  jenv, env, own = envs
  assert env.group_obs_dim == {"policy": (3 * 99,), "critic": (111,)}
  assert jenv.observation_manager.group_obs_dim == env.group_obs_dim
  assert sorted(env.sim.batched_fields) == sorted(jenv._dyn_model_fields) == sorted(
    {f for f, *_ in chip_smoke.SURFACE_DR.values()} | {"geom_friction"})
  assert all(v > 0 for v in own.values()), own  # each leaf differs across envs


def test_env_steps_match_jax(envs):
  jenv, env, _ = envs
  with tp.torch_threads(1):
    for i, a in enumerate(tp.actions(5, STEPS, NUM_ENVS, env.total_action_dim)):
      (jo, jr, jt, jto, _) = tp.numpy_tree(jenv.step(jnp.asarray(a)))
      (to, tr, tt, tto, _) = tp.numpy_tree(env.step(torch.as_tensor(a)))
      for g in ("policy", "critic"):
        tp.assert_close(to[g], jo[g], TOL, f"{g}, step {i}")
      tp.assert_close(tr, jr, TOL, f"reward, step {i}")
      np.testing.assert_array_equal(tt, jt)
      np.testing.assert_array_equal(tto, jto)
  tp.assert_close(env.data.xfrc_applied.numpy(), np.asarray(jenv.data.xfrc_applied), 0.0,
                  "xfrc_applied")
  assert np.abs(np.asarray(jenv.data.xfrc_applied)).max() == 30.0  # the push fired
  lags = env.ns("observation")["delay"]["policy/joint_vel"]["lags"]
  assert len(lags.unique()) > 1 or NUM_ENVS == 1
  # Outside its jitted step the JAX env reads sensors on a fresh forward at
  # the current state (`ensure_derived`); the port's data is the last
  # substep's. Read both on the JAX env's full state.
  tp.carry(jenv, env, full=True)
  for name in ("feet_ground_contact", "feet_ground_world"):
    jd, td = jenv.scene[name].data, env.scene[name].data
    for f in ("found", "force", "torque", "dist", "pos", "normal", "tangent"):
      if getattr(jd, f) is not None:
        tp.assert_close(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), TOL, f"{name} {f}")


class _Record:
  """Wraps a JAX sampler (`mt.sample_*`) and keeps its outputs, so that the
  port's sampler can return them in order."""

  def __init__(self, fn):
    self.fn, self.out = fn, []

  def __call__(self, *args, **kw):
    x = self.fn(*args, **kw)
    self.out.append(np.array(x))
    return x

  def replay(self, *args, **kw):
    return torch.as_tensor(self.out.pop(0))


def _jax_context(jenv):
  jenv._begin(jenv.state)
  jenv.ensure_derived()


def test_apply_external_force_torque_matches_jax(envs, monkeypatch):
  """The push event on a mask, JAX's draws handed across: xfrc_applied on
  the torso of the masked envs, the rest kept."""
  import mjlab_tpu.core.math as jmt
  import mjlab_tpu_torch.core.math as tmt
  from mjlab_tpu.envs import mdp as jmdp
  from mjlab_tpu_torch.envs import mdp as tmdp

  jenv, env, _ = envs
  _jax_context(jenv)
  tp.carry(jenv, env)
  rec = _Record(jmt.sample_uniform)
  monkeypatch.setattr(jmt, "sample_uniform", rec)
  monkeypatch.setattr(tmt, "sample_uniform", rec.replay)
  mask = np.array([True, False, True])
  params = dict(force_range=(-50.0, 50.0), torque_range=(-5.0, 5.0))
  jcfg, tcfg = (env_.cfg.events["push_wrench"].params["asset_cfg"] for env_ in (jenv, env))
  jmdp.apply_external_force_torque(jenv, jnp.asarray(mask), asset_cfg=jcfg, **params)
  tmdp.apply_external_force_torque(env, torch.as_tensor(mask), asset_cfg=tcfg, **params)
  assert not rec.out
  want = np.asarray(jenv._data.xfrc_applied)
  tp.assert_close(env.data.xfrc_applied.numpy(), want, 1e-12, "xfrc_applied")
  assert np.abs(want[mask]).max() > 1.0


def test_action_clip_matches_jax(envs):
  jenv, env, _ = envs
  _jax_context(jenv)
  a = np.random.default_rng(0).normal(0.0, 40.0, (NUM_ENVS, env.total_action_dim))
  jenv.action_manager.process_action(jnp.asarray(a))
  env.action_manager.process_action(torch.as_tensor(a))
  want = np.asarray(jenv.action_manager.get_term("joint_pos").processed_actions)
  got = env.action_manager.get_term("joint_pos").processed_actions.numpy()
  tp.assert_close(got, want, 1e-12, "processed actions")
  assert np.abs(got).max() == 10.0 and (np.abs(got) == 10.0).sum() > 10


def test_init_velocity_prob_matches_jax(envs, monkeypatch):
  """A resample of every env at init_velocity_prob 0.5 with JAX's uniforms
  handed across: the commands, and the root velocities of the envs drawn
  to start at their command."""
  jenv, env, _ = envs
  _jax_context(jenv)
  tp.carry(jenv, env)
  jcmd, cmd = (e.command_manager.get_term("twist") for e in (jenv, env))
  jcmd.cfg.init_velocity_prob = cmd.cfg.init_velocity_prob = 0.5
  keys = []
  next_key = jenv.next_key

  def recording():
    keys.append(next_key())
    return keys[-1]

  monkeypatch.setattr(jenv, "next_key", recording)
  mask = np.ones(NUM_ENVS, dtype=bool)
  with monkeypatch.context() as m:
    m.setattr(JaxEntity, "write_root_state", JaxEntity.write_root_state_to_sim, raising=False)
    jcmd._resample_command(jnp.asarray(mask))
  assert len(keys) == 2
  u = [jax.random.uniform(k, (NUM_ENVS,), jnp.float64) for k in jax.random.split(keys[0], 6)]
  draws = [torch.as_tensor(np.array(x)) for x in u + [jax.random.uniform(
    keys[1], (NUM_ENVS,), jnp.float64)]]
  monkeypatch.setattr(cmd, "_rand", lambda: draws.pop(0))
  qvel = env.data.qvel.clone()
  cmd._resample_command(torch.as_tensor(mask))
  assert not draws
  for k in ("vel_command_b", "heading_target", "is_heading_env", "is_standing_env"):
    tp.assert_close(cmd.state[k].numpy().astype(np.float64),
                    np.asarray(jcmd.state[k]).astype(np.float64), 1e-12, k)
  for f in ("qpos", "qvel"):
    tp.assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(jenv._data, f)), 1e-12, f)
  inject = (env.data.qvel != qvel).any(dim=1)
  assert 0 < inject.sum() < NUM_ENVS  # the seed draws some envs, not all


def test_randomize_field_matches_jax(envs, monkeypatch):
  """Each startup event of the surface cfg run again on both envs with
  JAX's draws handed across (every sampler it calls): equal leaves."""
  import mjlab_tpu.core.math as jmt
  import mjlab_tpu_torch.core.math as tmt
  from mjlab_tpu.envs import mdp as jmdp
  from mjlab_tpu_torch.envs import mdp as tmdp

  jenv, env, _ = envs
  _jax_context(jenv)
  tp.carry(jenv, env)
  recs = []
  for name in ("uniform", "log_uniform", "gaussian"):
    recs.append(_Record(getattr(jmt, f"sample_{name}")))
    monkeypatch.setattr(jmt, f"sample_{name}", recs[-1])
    monkeypatch.setattr(tmt, f"sample_{name}", recs[-1].replay)
  mask = np.array([True, True, False])
  for name in list(chip_smoke.SURFACE_DR) + ["foot_friction"]:
    jparams, tparams = (e.cfg.events[name].params for e in (jenv, env))
    jmdp.randomize_field(jenv, jnp.asarray(mask), **jparams)
    tmdp.randomize_field(env, torch.as_tensor(mask), **tparams)
    field = tparams["field"]
    tp.assert_close(getattr(env.model, field).numpy(), np.asarray(getattr(jenv.model, field)),
                    1e-12, field)
  assert all(not r.out for r in recs)  # every JAX draw was handed across
