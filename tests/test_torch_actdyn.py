"""Activation dynamics in the port (integrator, filter and filterexact, with
actearly and actrange), float64 on the CPU: the JAX test's actuator sets
(mjlab_tpu_torch/assets/muscle_scenes.py `actdyn_*`) under Euler and
implicitfast against mujoco.mj_step, as that test holds the JAX package,
and under RK4 (the filterexact set against the JAX package, stepped side
by side); and the filter-actuated hopper env, whose activations move
toward their targets, follow the JAX package's physics, and are zeroed for
the envs a time-out resets."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.assets import muscle_scenes
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics.types import mjtIntegrator
from tests.torch_parity import (
  assert_close,
  jax_data_from_arrays,
  muscle_rollout,
  torch_threads,
)

_SETS = ("filter", "filterexact", "integrator", "mixed_early")
_INTEGRATORS = {"Euler": mjtIntegrator.mjINT_EULER,
                "implicitfast": mjtIntegrator.mjINT_IMPLICITFAST,
                "RK4": mjtIntegrator.mjINT_RK4}
# The JAX package's own test holds each set to mujoco.mj_step under Euler
# and implicitfast; the port is held there too, and to the JAX package where
# MuJoCo cannot judge it (a JAX comparison costs one JAX compile per case):
# the filterexact set under RK4, where the JAX package advances a
# filterexact activation by Euler with the combined slope and MuJoCo does
# not (its qpos is 2.6e-4 from MuJoCo's after 30 substeps, ROADMAP Queue C).
# The early-activation set runs under RK4 against MuJoCo. Activation runs
# against JAX also in tests/test_torch_solvers.py (a filter under RK4),
# tests/test_torch_ball_joints.py (a filter under Euler) and the arm and
# muscles of tests/test_torch_muscle.py (filterexact, integrator and muscle
# dynamics under Euler).
_JAX_CASES = [("filterexact", "RK4")]
_MUJOCO_CASES = [(s, i) for s in _SETS for i in ("Euler", "implicitfast")
                 if (s, i) not in _JAX_CASES] + [("mixed_early", "RK4")]


def _check_actrange(run):
  limited = run.mj.actuator_actlimited[run.ttp.act_actuator].astype(bool)
  hi = run.mj.actuator_actrange[run.ttp.act_actuator][:, 1]
  assert np.all(run.port["act"][0][limited] <= hi[limited] + 1e-15)


@pytest.mark.parametrize("actuators, integrator", _JAX_CASES)
def test_activation_equals_jax(actuators, integrator):
  """30 substeps from the JAX test's seeded state under its sine controls:
  qpos, qvel and act within 1e-10 of JAX's at every step, act_dot and the
  actuator forces at the end; an actrange clamps where one is set."""
  with torch_threads(1):
    run = muscle_rollout(f"actdyn_{actuators}", 30, _INTEGRATORS[integrator],
                         record=("act_dot", "actuator_force"))
  assert run.ttp.na == run.mj.na > 0
  assert run.gaps.max() <= 1e-10, run.gaps
  for f in ("act_dot", "actuator_force"):
    assert_close(run.port[f], run.jax[f], 1e-10, f)
  _check_actrange(run)


@pytest.mark.parametrize("actuators, integrator", _MUJOCO_CASES)
def test_activation_equals_mujoco(actuators, integrator):
  """The same 30 substeps against mujoco.mj_step, at the JAX test's
  tolerances (act 1e-10, qpos 1e-8, qvel 1e-7) and act_dot and the
  actuator forces within 1e-9."""
  with torch_threads(1):
    run = muscle_rollout(f"actdyn_{actuators}", 30, _INTEGRATORS[integrator], mjc=True,
                         with_jax=False, record=("act_dot", "actuator_force"))
  for i, (f, tol) in enumerate((("qpos", 1e-8), ("qvel", 1e-7), ("act", 1e-10))):
    np.testing.assert_allclose(run.port[f][0], run.mujoco[i], rtol=0, atol=tol, err_msg=f)
  for f in ("act_dot", "actuator_force"):
    np.testing.assert_allclose(run.port[f][0], getattr(run.mjd, f), rtol=0, atol=1e-9,
                               err_msg=f)
  _check_actrange(run)


def test_muscle_dyntype_equals_mujoco():
  """The JAX test's muscle-dyntype hinge (timeconst 0.01/0.04) under its
  sine control, 50 substeps against mujoco.mj_step at that test's
  tolerances (act 1e-10, qpos 1e-9, qvel 1e-8); the joint muscle of
  tests/test_torch_muscle.py runs the same dynamics against JAX."""
  with torch_threads(1):
    run = muscle_rollout("actdyn_muscle", 50, budget=True, mjc=True, with_jax=False)
  for i, (f, tol) in enumerate((("qpos", 1e-9), ("qvel", 1e-8), ("act", 1e-10))):
    np.testing.assert_allclose(run.port[f][0], run.mujoco[i], rtol=0, atol=tol, err_msg=f)
  assert np.abs(run.port["act"]).max() > 0.1


@pytest.fixture(scope="module")
def hopper():
  """The port's hopper env (float64, 4 envs, reset) and the JAX package's
  physics step on the same compiled scene."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  with torch_threads(1):
    env = ManagerBasedRlEnv(muscle_scenes.hopper_filter_env_cfg(4), device="cpu")
    env.reset(seed=0)
  # The committed scene under the env's solver options (its cfg's MujocoCfg).
  # Its <general> actuators leave biastype at MuJoCo's default, none, with
  # biasprm "0 -40 -2": MuJoCo and the port give them no bias, the JAX
  # package the affine form (ROADMAP Queue C); JAX gets biasprm 0.
  mj = assets.load_model_npz(muscle_scenes.HOPPER_FILTER)
  env.cfg.sim.mujoco.apply(mj)
  assert (mj.actuator_biastype == 0).all() and mj.actuator_biasprm[:, 1].min() == -40
  mj.actuator_biasprm[:] = 0.0
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  return env, jtp, jm, jax.jit(jax.vmap(lambda d: jphysics.step(jtp, jm, d)))


def test_hopper_act_follows_jax_and_moves_toward_the_targets(hopper):
  """Five env steps (20 substeps) of a constant action: the port env's act,
  qpos and qvel equal the JAX package's physics stepped from the env's
  post-reset state under the env's ctrl, within 1e-10; each filter has
  moved toward its target."""
  env, jtp, jm, step = hopper
  assert env.sim.tp.na == 2
  start = tio.data_to_arrays(env.data)
  action = torch.full((4, 2), 0.4, dtype=torch.float64)
  with torch_threads(1):
    for _ in range(5):
      env.step(action)
  ctrl = env.data.ctrl.numpy()
  d = jax_data_from_arrays(start | {"ctrl": ctrl})
  for _ in range(20):
    d = step(d)
  for f in ("act", "qpos", "qvel"):
    assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(d, f)), 1e-10, f)
  act = env.data.act.numpy()
  assert (np.abs(act) > 1e-3).all()
  assert np.all(np.sign(act) == np.sign(ctrl))


def test_hopper_reset_zeroes_act(hopper):
  """Run to the 0.2 s time-out: every env resets at once and its act is
  exactly 0 (mj_resetData), before the next step's filters move it."""
  env, *_ = hopper
  action = torch.full((4, 2), 0.4, dtype=torch.float64)
  with torch_threads(1):
    for _ in range(12):
      _, _, _, time_outs, extras = env.step(action)
      if int(extras["log"]["reset_count"]):
        break
  assert bool(time_outs.all())
  assert torch.equal(env.data.act, torch.zeros_like(env.data.act))
