"""The scene layer of the PyTorch port against the JAX package (float64,
CPU): the G1 entity's index maps and defaults, the contact sensors' slot
tables and outputs, contact_forces, and a physics step with a per-env
geom_friction."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu import physics as jphysics
from mjlab_tpu.physics.constraint import contact_forces as jax_contact_forces
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.physics import constraint as tconstraint

NUM_ENVS = 8  # the 8 rollout states of tp.scene("g1")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs():
  return tp.g1_flat_envs(NUM_ENVS)


@pytest.fixture(scope="module")
def g1():
  return tp.scene("g1")


def test_entity_indexing_equal(envs):
  jenv, env = envs
  want, got = jenv.scene["robot"].indexing, env.scene["robot"].indexing
  for f in dataclasses.fields(want):
    a, b = getattr(got, f.name), getattr(want, f.name)
    if isinstance(b, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=f.name)
    else:
      assert a == b, f.name
  for kind in ("joint", "body", "geom", "site", "actuator"):
    assert (getattr(env.scene["robot"], f"{kind}_names")
            == getattr(jenv.scene["robot"], f"{kind}_names")), kind


@pytest.mark.parametrize("sensor", ["feet_ground_contact", "self_collision"])
def test_contact_sensor_slot_tables_equal(envs, sensor):
  jenv, env = envs
  want, got = jenv.scene[sensor], env.scene[sensor]
  assert got.item_names == want.item_names
  np.testing.assert_array_equal(got._slot_idx, want._slot_idx)
  np.testing.assert_array_equal(got._slot_valid, want._slot_valid)
  np.testing.assert_array_equal(got._slot_sign, want._slot_sign)


def test_builtin_sensors_bound_alike(envs):
  jenv, env = envs
  names = [n for n, s in jenv.scene.sensors.items() if hasattr(s, "_adr")]
  assert names and names == [n for n, s in env.scene.sensors.items() if hasattr(s, "_adr")]
  for n in names:
    assert (env.scene[n]._adr, env.scene[n]._dim) == (jenv.scene[n]._adr, jenv.scene[n]._dim)


def test_g1_constants_and_defaults_equal(envs):
  from mjlab_tpu.asset_zoo.robots.unitree_g1 import g1_constants as jg1
  from mjlab_tpu_torch.asset_zoo.robots.unitree_g1 import g1_constants as tg1

  assert tg1.G1_ACTION_SCALE == jg1.G1_ACTION_SCALE
  assert (dataclasses.asdict(tg1.get_g1_robot_cfg().init_state)
          == dataclasses.asdict(jg1.get_g1_robot_cfg().init_state))
  for t, j in zip(tg1.G1_ARTICULATION.actuators, jg1.G1_ARTICULATION.actuators):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
  jenv, env = envs
  jd, td = jenv.scene["robot"].data, env.scene["robot"].data
  for f in ("default_root_state", "default_joint_pos", "default_joint_vel",
            "default_joint_stiffness", "default_joint_damping",
            "default_joint_pos_limits", "soft_joint_pos_limits"):
    np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                  err_msg=f)
  np.testing.assert_array_equal(env.scene.env_origins.numpy(), jenv.scene.env_origins)


def test_contact_forces_match(g1):
  want = jax.jit(jax.vmap(lambda d: jax_contact_forces(g1.jtp, g1.jm, d)))(
    tp.jax_data_from_arrays(g1.states)
  )
  got = tconstraint.contact_forces(g1.ttp, g1.tm, tp.to_torch(g1.states))
  assert np.abs(np.asarray(want)).max() > 1.0  # contacts carry force
  tp.assert_close(got.numpy(), want, 1e-9, "contact_forces")


def _ground_sensors(jenv, env, reduce: str):
  """A feet-on-ground sensor in both packages whose secondary names the
  compiled terrain body, "/terrain" (the task's own sensor asks for
  "terrain", which matches no body of the compiled scene in either
  package, so its contacts are never found)."""
  from mjlab_tpu import sensors as js
  from mjlab_tpu_torch import sensors as ts

  out = []
  for pkg, env_ in ((js, jenv), (ts, env)):
    cfg = pkg.ContactSensorCfg(
      name="ground", fields=("found", "force"), reduce=reduce,
      primary=pkg.ContactMatch(mode="subtree", entity="robot",
                               pattern=r"^(left_ankle_roll_link|right_ankle_roll_link)$"),
      secondary=pkg.ContactMatch(mode="body", pattern="/terrain"),
    )
    sensor = cfg.build()
    if pkg is js:
      sensor.edit_spec(None, {})
      sensor.initialize(jenv.sim.mj_model, jenv)
    else:
      sensor.initialize(env.sim.mj_model, env)
    out.append(sensor)
  return out


@pytest.mark.parametrize("sensor", ["feet_ground_contact", "self_collision",
                                    "ground/netforce", "ground/none"])
def test_contact_sensor_outputs_match(envs, g1, sensor):
  jenv, env = envs
  jenv._data = tp.jax_data_from_arrays(g1.states)
  env.data = tp.to_torch(g1.states)
  if sensor.startswith("ground/"):
    js, ts = _ground_sensors(jenv, env, sensor.split("/")[1])
    np.testing.assert_array_equal(ts._slot_idx, js._slot_idx)
    np.testing.assert_array_equal(ts._slot_sign, js._slot_sign)
  else:
    js, ts = jenv.scene[sensor], env.scene[sensor]
  want, got = js.data, ts.data
  for f in ts.cfg.fields:
    tp.assert_close(getattr(got, f).numpy(), getattr(want, f), 1e-9, f"{sensor}.{f}")
  if sensor.startswith("ground/"):
    assert np.sum(np.asarray(want.found)) > 0
    assert np.abs(np.asarray(want.force)).max() > 1.0


def test_air_time_update_matches(envs, g1):
  jenv, env = envs
  jenv._data = tp.jax_data_from_arrays(g1.states)
  env.data = tp.to_torch(g1.states)
  js, ts = jenv.scene["feet_ground_contact"], env.scene["feet_ground_contact"]
  rng = np.random.default_rng(4)
  init = {k: np.abs(rng.normal(0.0, 0.2, (NUM_ENVS, 2))) for k in js.state}
  init["current_air_time"][::2] = 0.0  # both branches of the state machine
  for k, v in init.items():
    js.state[k] = jnp.asarray(v)
    ts.state[k] = torch.as_tensor(v)
  js.update(0.005)
  ts.update(0.005)
  for k in init:
    tp.assert_close(ts.state[k].numpy(), js.state[k], 1e-12, k)
  for fn in ("compute_first_contact", "compute_first_air"):
    np.testing.assert_array_equal(getattr(ts, fn)(0.02).numpy(),
                                  np.asarray(getattr(js, fn)(0.02)), err_msg=fn)


def test_step_with_per_env_friction(g1):
  rng = np.random.default_rng(11)
  fric = np.tile(np.asarray(g1.jm.geom_friction), (NUM_ENVS, 1, 1))
  fric[..., 0] = rng.uniform(0.3, 1.2, fric.shape[:2])
  jstep = jax.jit(jax.vmap(
    lambda f, d: jphysics.step(g1.jtp, g1.jm.replace(geom_friction=f), d)
  ))
  want = tp.jax_data_arrays(jstep(jnp.asarray(fric), tp.jax_data_from_arrays(g1.states)))
  tm = dataclasses.replace(g1.tm, geom_friction=torch.as_tensor(fric))
  got = tphysics.step(g1.ttp, tm, tp.to_torch(g1.states))
  tp.assert_close(got.contact.friction.numpy(), want["contact.friction"], 0.0, "friction")
  # The per-env friction reaches the contacts: slots differ across envs.
  assert np.ptp(want["contact.friction"][..., 0], axis=0).max() > 0.1
  for f in ("qpos", "qvel", "sensordata"):
    tp.assert_close(getattr(got, f).numpy(), want[f], 1e-8, f)


def test_per_env_fields_other_than_friction_raise(envs):
  """A field outside the JAX package's FIELD_SPECS (every row of which the
  port reads per env) raises."""
  _, env = envs
  with pytest.raises(NotImplementedError, match="geom_size"):
    env.sim.expand_model_fields(("geom_size",))
