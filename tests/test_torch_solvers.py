"""The CG solver and the Euler and RK4 integrators of the port against the
JAX package and MuJoCo, float64, CPU, and `MujocoCfg` against the JAX
package's.

* CG (tests/test_physics_contacts.py:112's settling box, 50 iterations of
  25 linesearch steps): one substep from JAX's state within 1e-8, 150
  substeps within 1e-6 of JAX's, and, as the JAX test holds its own, within
  2e-3 of MuJoCo's pose and settled.
* Euler and implicitfast (tests/test_physics_smooth.py:176's humanoid from a
  seeded random state, 20 substeps) and RK4 (its pendulum and free fall
  onto a plane, 150 substeps): within 1e-6 of JAX's and within the JAX
  test's 1e-8 (qpos) and 1e-7 (qvel) of MuJoCo's; one substep within 1e-8
  of JAX's. RK4's activation-dynamics scene stays refused.
* MujocoCfg: the JAX class's fields, defaults and choices, and `apply`
  writes the same options for every choice.
"""

from __future__ import annotations

import dataclasses

import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets.solver_scenes import SCENES
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics.types import Integrator
from tests.torch_parity import assert_close, solver_scene_run, to_torch, torch_threads


def _one_substep(run, what):
  for pre, post in run.stages:
    one = tio.data_to_arrays(tphysics.step(run.ttp, run.tm, to_torch(pre)))
    for f in ("qpos", "qvel", "qacc"):
      assert_close(one[f], post[f], 1e-8, f"{what}: one substep's {f}")


def test_cg_trajectory():
  with torch_threads(1):
    run = solver_scene_run("cg_box", 150, checks=(0, 75))
  assert run.tm.opt.solver == 1 and run.tm.opt.iterations == 50
  _one_substep(run, "cg")
  for i, what in enumerate(("qpos", "qvel")):
    assert_close(run.port[i], run.jax[i], 1e-6, f"cg: {what} after 150 substeps")
  np.testing.assert_allclose(run.port[0][0], run.mujoco[0], atol=2e-3)
  assert np.linalg.norm(run.port[1]) < 0.05


def _humanoid_state(xml):
  """tests/test_physics_smooth.py's seeded random state (rng 7)."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  rng = np.random.default_rng(7)
  qpos = mjm.qpos0 + 0.3 * rng.standard_normal(mjm.nq)
  qpos[3:7] /= np.linalg.norm(qpos[3:7])
  return qpos, 0.5 * rng.standard_normal(mjm.nv)


@pytest.mark.parametrize("integrator", ["Euler", "implicitfast"])
def test_euler_and_implicitfast_trajectory(integrator):
  xml = SCENES["humanoidish_euler"].xml.replace('integrator="Euler"',
                                                f'integrator="{integrator}"')
  qpos, qvel = _humanoid_state(xml)
  with torch_threads(1):
    run = solver_scene_run("humanoidish_euler", 20, xml=xml, qpos=qpos, qvel=qvel,
                           checks=(0, 10))
  want = Integrator.EULER if integrator == "Euler" else Integrator.IMPLICITFAST
  assert run.tm.opt.integrator == run.jm.opt.integrator == want
  _one_substep(run, integrator)
  for i, what in enumerate(("qpos", "qvel")):
    assert_close(run.port[i], run.jax[i], 1e-6, f"{integrator}: {what}")
  np.testing.assert_allclose(run.port[0][0], run.mujoco[0], atol=1e-8)
  np.testing.assert_allclose(run.port[1][0], run.mujoco[1], atol=1e-7)


@pytest.mark.parametrize("name", ["pendulum_rk4", "freefall_rk4"])
def test_rk4_trajectory(name):
  with torch_threads(1):
    run = solver_scene_run(name, 150, checks=(0, 75))
  assert run.tm.opt.integrator == run.jm.opt.integrator == Integrator.RK4
  _one_substep(run, name)
  for i, what in enumerate(("qpos", "qvel")):
    assert_close(run.port[i], run.jax[i], 1e-6, f"{name}: {what}")
  np.testing.assert_allclose(run.port[0][0], run.mujoco[0], atol=1e-8)
  np.testing.assert_allclose(run.port[1][0], run.mujoco[1], atol=1e-7)


def test_rk4_with_activation_dynamics_equals_jax():
  """RK4 over (qpos, qvel, act) with a filter actuator (refused until PR
  14): 20 substeps of a sine control equal the JAX package's within 1e-10
  relative at every step."""
  import jax
  import jax.numpy as jnp

  from mjlab_tpu import physics as jphysics
  from tests.torch_parity import one_world

  xml = """
<mujoco><option timestep="0.004" integrator="RK4"/>
  <worldbody>
    <body pos="0 0 1"><joint name="j" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
            contype="0" conaffinity="0"/></body>
  </worldbody>
  <actuator>
    <general joint="j" dyntype="filter" dynprm="0.05" gainprm="2.0" biasprm="0 0 0"/>
  </actuator></mujoco>"""
  mj = mujoco.MjModel.from_xml_string(xml)
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  tp, m = tio.put_model(mj, dtype=torch.float64, device="cpu")
  assert tp.na == 1 and m.opt.integrator == Integrator.RK4
  d = jphysics.make_data(jtp, jm)
  td = to_torch(one_world(d))
  step = jax.jit(lambda dd: jphysics.step(jtp, jm, dd))
  with torch_threads(1):
    for k in range(20):
      c = np.array([np.sin(0.3 * k)])
      d = step(d.replace(ctrl=jnp.asarray(c)))
      td = tphysics.step(tp, m, td.replace(ctrl=torch.tensor(c[None])))
      for f in ("qpos", "qvel", "act"):
        assert_close(getattr(td, f).numpy(), np.asarray(getattr(d, f))[None], 1e-10, f)
  assert abs(float(d.act[0])) > 0.1


def test_mujoco_cfg_fields_match_jax():
  from mjlab_tpu.sim.sim import MujocoCfg as JaxCfg
  from mjlab_tpu_torch.sim import MujocoCfg

  ours = {f.name: (f.default, str(f.type)) for f in dataclasses.fields(MujocoCfg)}
  theirs = {f.name: (f.default, str(f.type)) for f in dataclasses.fields(JaxCfg)}
  assert ours == theirs


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
@pytest.mark.parametrize("integrator", ["euler", "implicitfast"])
@pytest.mark.parametrize("solver", ["newton", "cg", "pgs"])
def test_mujoco_cfg_apply_matches_jax(cone, integrator, solver):
  from mjlab_tpu.sim.sim import MujocoCfg as JaxCfg
  from mjlab_tpu_torch.sim import MujocoCfg

  kw = dict(cone=cone, integrator=integrator, solver=solver, timestep=0.004,
            impratio=2.5, iterations=7, ls_iterations=9, tolerance=1e-6,
            ls_tolerance=0.02, gravity=(0.1, 0.0, -9.0))
  models = [mujoco.MjModel.from_xml_string(SCENES["puck"].xml) for _ in range(2)]
  MujocoCfg(**kw).apply(models[0])
  JaxCfg(**kw).apply(models[1])
  for f in ("cone", "integrator", "solver", "timestep", "impratio", "iterations",
            "ls_iterations", "tolerance", "ls_tolerance", "gravity"):
    assert np.array_equal(getattr(models[0].opt, f), getattr(models[1].opt, f)), f


def test_cli_override_selects_the_cone_and_solver():
  """`--env.sim.mujoco.cone elliptic` / `--env.sim.mujoco.solver cg` reach
  the model through the CLI's dotted overrides."""
  from mjlab_tpu_torch.scripts.cli import apply_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfg = load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1")
  apply_overrides(cfg, {"sim.mujoco.cone": "elliptic", "sim.mujoco.solver": "cg",
                        "sim.mujoco.integrator": "euler"})
  assert (cfg.sim.mujoco.cone, cfg.sim.mujoco.solver, cfg.sim.mujoco.integrator) == (
    "elliptic", "cg", "euler")


def test_g1_trains_under_the_elliptic_cone_on_the_cpu():
  """`--env.sim.mujoco.cone elliptic` builds G1 velocity-flat with nefc
  1320 (29 limit rows, 154 condim-1 rows, 379 cone slots of 3 rows) and one
  PPO iteration of 2 envs finishes with finite losses."""
  from mjlab_tpu_torch.scripts.train import build_runner

  with torch_threads(1):
    runner = build_runner("Mjlab-Velocity-Flat-Unitree-G1", {
      "env.scene.num_envs": "2", "env.sim.mujoco.cone": "elliptic",
      "agent.num_steps_per_env": "2", "agent.algorithm.num_mini_batches": "1",
      "agent.algorithm.num_learning_epochs": "1",
      "agent.policy.actor_hidden_dims": "(16,)", "agent.policy.critic_hidden_dims": "(16,)",
    }, device="cpu")
    tp = runner.env.tp
    assert tp.nefc == 1320 and runner.env.model.opt.cone == 1
    assert tp.dev.con.cone_kernel_layout.groups == ((3, 0, 379),)
    metrics = runner.train_iteration()
  for k in ("Loss/loss", "Loss/value_loss", "Loss/surrogate"):
    assert np.isfinite(float(metrics[k])), k
