"""The whole slice against the JAX package: `Simulation.step_fn()` of the
port on the G1 velocity-flat scene at 4 worlds, float64 on the CPU.

* One step from each of the 8 contact-rich states (two batches of 4):
  qpos, qvel, act, sensordata and qacc_warmstart within 1e-8 (relative to
  max(1, max|jax|), as in tests/torch_parity.assert_close).
* `Simulation.forward_fn()` from the same states: qacc, qfrc_constraint
  and sensordata within 1e-8, efc_force within 1e-7 (a Newton step at a
  cost tie; see the test).
* A 40-substep rollout from the keyframe with seeded controls fed to both
  engines: qpos, qvel and sensordata within 1e-6 at every substep.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch.assets import g1_velocity_sim_cfg
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.sim import Simulation
from tests.torch_parity import (
  assert_close,
  jax_data_arrays,
  jax_data_from_arrays,
  jax_step,
  scene,
  to_torch,
)

STEP_TOL = 1e-8
COST_TIE_TOL = 1e-7
ROLLOUT_TOL = 1e-6
NUM_WORLDS = 4


def _simulation() -> Simulation:
  cfg = g1_velocity_sim_cfg()
  cfg.dtype = "float64"
  return Simulation(NUM_WORLDS, cfg, scene("g1").mj, device="cpu")


@pytest.mark.parametrize("batch", [0, 1])
def test_one_step_from_states(batch):
  sc = scene("g1")
  sel = slice(batch * NUM_WORLDS, (batch + 1) * NUM_WORLDS)
  arrays = {k: v[sel] for k, v in sc.states.items()}
  want = jax_data_arrays(jax_step("g1")(jax_data_from_arrays(arrays)))
  sim = _simulation()
  got = tio.data_to_arrays(sim.step_fn()(sim.model, to_torch(arrays)))
  for f in ("qpos", "qvel", "act", "sensordata", "qacc_warmstart"):
    assert_close(got[f], want[f], STEP_TOL, f)


@pytest.mark.parametrize("batch", [0, 1])
def test_forward_from_states(batch):
  sc = scene("g1")
  sel = slice(batch * NUM_WORLDS, (batch + 1) * NUM_WORLDS)
  arrays = {k: v[sel] for k, v in sc.states.items()}
  jforward = jax.jit(jax.vmap(lambda d: jphysics.forward(sc.jtp, sc.jm, d)))
  want = jax_data_arrays(jforward(jax_data_from_arrays(arrays)))
  sim = _simulation()
  got = tio.data_to_arrays(sim.forward_fn()(sim.model, to_torch(arrays)))
  for f in ("qacc", "qfrc_constraint", "sensordata"):
    assert_close(got[f], want[f], STEP_TOL, f)
  # In world 3 of batch 0 the third Newton step lowers the cost by less than
  # its rounding: one engine accepts it and the other rejects it. qacc then
  # differs by 7.4e-9 and efc_force by 1.07e-8 of their scales.
  assert_close(got["efc_force"], want["efc_force"], COST_TIE_TOL, "efc_force")


def test_rollout_40_substeps():
  sc = scene("g1")
  rng = np.random.default_rng(11)
  d0 = jphysics.make_data(sc.jtp, sc.jm)
  jd = jax.tree_util.tree_map(
    lambda x: jnp.broadcast_to(x, (NUM_WORLDS,) + x.shape), d0
  )
  qpos = np.tile(sc.mj.key_qpos[0], (NUM_WORLDS, 1))
  qpos[:, 7:] += rng.normal(0.0, 0.03, (NUM_WORLDS, sc.mj.nq - 7))
  jd = jd.replace(qpos=jnp.asarray(qpos))
  sim = _simulation()
  step = sim.step_fn()
  td = to_torch(jax_data_arrays(jd))
  jstep = jax_step("g1")
  for i in range(40):
    ctrl = sc.ctrl_ref + rng.normal(0.0, 0.3, (NUM_WORLDS, sc.mj.nu))
    jd = jstep(jd.replace(ctrl=jnp.asarray(ctrl)))
    td = step(sim.model, td.replace(ctrl=torch.tensor(ctrl, dtype=torch.float64)))
    want, got = jax_data_arrays(jd), tio.data_to_arrays(td)
    for f in ("qpos", "qvel", "sensordata"):
      assert_close(got[f], want[f], ROLLOUT_TOL, f"substep {i}: {f}")
  active = want["contact.dist"] < want["contact.includemargin"]
  assert active.sum() > 0
