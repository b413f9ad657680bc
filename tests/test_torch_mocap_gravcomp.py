"""Mocap bodies and gravity compensation, the port against the JAX package
(float64, CPU) and MuJoCo, on the JAX package's scenes
(tests/test_physics_mocap.py, test_physics_gravcomp.py): a ball welded to a
moving mocap target; a mocap quaternion turning the body's frame; the
mocap state's reset pose (MuJoCo's, where the JAX package starts at the
origin: ROADMAP Queue C); a mocap entity's pose written through
`write_mocap_pose_to_sim`; a two-link arm fully and half compensated; a
fully compensated free body that hovers; and `body_gravcomp` read per env.

Tolerances (PERF.md §2): 1e-9 per stage, 1e-6 over a rollout.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets.surface_scenes import SCENES
from mjlab_tpu_torch.physics import io as tio
from tests.torch_parity import (
  assert_close,
  surface_data,
  surface_models,
  surface_rollout,
  torch_threads,
)

STAGE_TOL, ROLLOUT_TOL = 1e-9, 1e-6


def test_mocap_weld_tracking():
  """The JAX test's moving target (+1 mm per step in x), 120 steps: the
  welded ball follows it in all three engines."""
  def move(i, mjd, d, td):
    mp = np.array([0.5 + 0.001 * i, 0.0, 0.6])
    mjd.mocap_pos[0] = mp
    return (d.replace(mocap_pos=jnp.asarray(mp)[None]),
            td.replace(mocap_pos=torch.tensor(mp)[None, None]))

  with torch_threads(1):
    r = surface_rollout("mocap_weld", 120, on_step=move)
  for i, f in enumerate(("qpos", "qvel")):
    assert_close(r.port[i], r.jax[i], ROLLOUT_TOL, f)
  np.testing.assert_allclose(r.port[0][0], r.mujoco[0], atol=1e-9)
  assert r.port[0][0, 0] > 0.1


def test_mocap_quat_turns_the_frame():
  mj, (jtp, jm), (ttp, tm) = surface_models("mocap_weld")
  quat = np.asarray([np.cos(0.4), 0.0, 0.0, np.sin(0.4)])
  d, td = surface_data("mocap_weld", jtp, jm)
  want = jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d.replace(
    mocap_quat=jnp.asarray(quat)[None]))
  with torch_threads(1):
    got = tphysics.forward(ttp, tm, td.replace(mocap_quat=torch.tensor(quat)[None, None]))
  body = int(np.nonzero(ttp.body_mocapid >= 0)[0][0])
  np.testing.assert_allclose(got.xquat[0, body].numpy(), quat, atol=1e-12)
  for f in ("xpos", "xquat", "geom_xpos", "efc_pos", "efc_aref"):
    assert_close(getattr(got, f).numpy(), np.asarray(getattr(want, f))[None], STAGE_TOL, f)


def test_mocap_resets_to_the_body_pose():
  """make_data puts a mocap body at its model pose, as mj_resetData does;
  the JAX package's make_data puts it at the origin."""
  mj, (jtp, jm), (ttp, tm) = surface_models("mocap_weld")
  d = tio.make_data(ttp, tm, 3)
  mjd = mujoco.MjData(mj)
  np.testing.assert_array_equal(d.mocap_pos.numpy(), np.broadcast_to(mjd.mocap_pos, (3, 1, 3)))
  np.testing.assert_array_equal(d.mocap_quat.numpy(), np.broadcast_to(mjd.mocap_quat, (3, 1, 4)))
  assert not np.asarray(jphysics.make_data(jtp, jm).mocap_pos).any()


def test_mocap_entity_pose_write():
  """A fixed-base entity rooted at the mocap body: write_mocap_pose_to_sim
  writes mocap_pos and mocap_quat of the masked envs only, and the next
  forward moves the body there."""
  from mjlab_tpu_torch.entity import Entity, EntityCfg

  xml = SCENES["mocap_weld"].xml.replace('name="target"', 'name="target/root"').replace(
    'body1="target"', 'body1="target/root"')
  mj = mujoco.MjModel.from_xml_string(xml)
  tp, m = tio.put_model(mj, dtype=torch.float64, device="cpu")
  ctx = SimpleNamespace(num_envs=2, dtype=torch.float64, device=torch.device("cpu"), tp=tp,
                        sim=SimpleNamespace(mj_model=mj), data=tio.make_data(tp, m, 2))
  ent = Entity(EntityCfg(), "target", mj)
  ent.initialize(ctx)
  assert ent.is_mocap and ent.indexing.mocap_id == 0
  pose = torch.tensor([[0.1, 0.2, 0.3, 0.0, 1.0, 0.0, 0.0]] * 2, dtype=torch.float64)
  ent.write_mocap_pose_to_sim(pose, env_mask=torch.tensor([False, True]))
  np.testing.assert_array_equal(ctx.data.mocap_pos[:, 0].numpy(), [[0.5, 0.0, 0.6], [0.1, 0.2, 0.3]])
  with torch_threads(1):
    d = tphysics.forward(tp, m, ctx.data)
  body = int(ent.indexing.root_body_id)
  np.testing.assert_array_equal(d.xpos[1, body].numpy(), [0.1, 0.2, 0.3])
  np.testing.assert_array_equal(d.xquat[1, body].numpy(), [0.0, 1.0, 0.0, 0.0])


def test_gravcomp_arm_trajectory():
  """The arm (gravcomp 1 and 0.5) swinging, 150 steps (the JAX test's 300,
  cut to keep the file fast)."""
  with torch_threads(1):
    r = surface_rollout("gravcomp_arm", 150)
  for i, f in enumerate(("qpos", "qvel")):
    assert_close(r.port[i], r.jax[i], ROLLOUT_TOL, f)
  np.testing.assert_allclose(r.port[0][0], r.mujoco[0], atol=1e-8)
  np.testing.assert_allclose(r.port[1][0], r.mujoco[1], atol=1e-7)


_HOVER = """
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1" gravcomp="1.0"><freejoint/>
      <geom type="sphere" size="0.1" density="500"/></body>
  </worldbody></mujoco>"""


def test_full_gravcomp_hovers_and_reads_per_env():
  """The fully compensated free body stays put over 100 steps; with a
  per-env `body_gravcomp` (1 in env 0, 0.5 in env 1) each env follows the
  run of its own compiled value, in the port and the JAX package."""
  mj = mujoco.MjModel.from_xml_string(_HOVER)
  tp, m = tio.put_model(mj, dtype=torch.float64, device="cpu")
  per_env = m.body_gravcomp.expand(2, -1).clone()
  per_env[1, 1] = 0.5
  d = tio.make_data(tp, m, 2)
  m2 = dataclasses.replace(m, body_gravcomp=per_env)
  with torch_threads(1):
    for _ in range(100):
      d = tphysics.step(tp, m2, d)
  np.testing.assert_allclose(d.qpos[0, 2].item(), 1.0, atol=1e-9)
  assert d.qvel[0].norm().item() < 1e-9
  mj.body_gravcomp[1] = 0.5
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  jd = jphysics.make_data(jtp, jm)
  step = jax.jit(lambda dd: jphysics.step(jtp, jm, dd))
  for _ in range(100):
    jd = step(jd)
  assert_close(d.qpos[1:].numpy(), np.asarray(jd.qpos)[None], ROLLOUT_TOL, "qpos")
  assert 0.7 < d.qpos[1, 2].item() < 0.99
