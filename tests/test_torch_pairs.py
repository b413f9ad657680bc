"""Explicit `<pair>`s, the port against the JAX package (float64, CPU) and
MuJoCo, on the JAX package's pair scenes (tests/test_physics_contacts.py):
the pair's friction, solref, solimp, margin and condim reach the contact
verbatim; a pair collides unfiltered (its geoms' contype and conaffinity
are 0); it takes the place of the dynamic pair of the same two geoms; a
pair into a terrain pool is refused, as in the JAX package; solreffriction
damps the elliptic cone's friction rows (and the pyramid ignores it). The
candidate pairs, their order included, are the JAX package's.

Tolerances (PERF.md §2): 1e-9 per stage, 1e-6 over a rollout.
"""

from __future__ import annotations

import dataclasses

import jax
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.physics import io as tio
from tests.torch_parity import (
  assert_close,
  one_world,
  surface_data,
  surface_models,
  surface_rollout,
  torch_threads,
)

STAGE_TOL, ROLLOUT_TOL = 1e-9, 1e-6


@pytest.mark.parametrize("name", ["pair_only", "pair_precedence", "pair_solreffriction",
                                  "ft_rig"])
def test_candidate_pairs_equal_jax(name):
  mj, (jtp, _), (ttp, _) = surface_models(name)
  assert [dataclasses.astuple(p) for p in ttp.pairs] == [
    dataclasses.astuple(p) for p in jtp.pairs]
  assert any(p.pair_id >= 0 for p in ttp.pairs) and ttp.nefc == jtp.nefc
  _, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  for f in ("pair_friction", "pair_solref", "pair_solreffriction", "pair_solimp", "pair_margin"):
    np.testing.assert_array_equal(getattr(tm, f).numpy(), getattr(mj, f))


def test_pair_params_verbatim():
  """The penetrating slot carries pair_* verbatim (includemargin = the
  pair's margin; its gap is ignored as in MuJoCo >= 3.10) and condim 6
  from pair_dim; MuJoCo's own contact agrees; the JAX package's collision
  stage equals the port's."""
  mj, (jtp, jm), (ttp, tm) = surface_models("pair_only")
  d, td = surface_data("pair_only", jtp, jm)
  want = one_world(jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d))
  with torch_threads(1):
    got = tio.data_to_arrays(tphysics.forward(ttp, tm, td))
  for f in ("dist", "pos", "frame", "friction", "solref", "solimp", "includemargin",
            "solreffriction"):
    assert_close(got[f"contact.{f}"], want[f"contact.{f}"], STAGE_TOL, f)
  i = int(np.argmin(got["contact.dist"][0]))
  np.testing.assert_array_equal(got["contact.friction"][0, i], mj.pair_friction[0])
  np.testing.assert_array_equal(got["contact.solref"][0, i], mj.pair_solref[0])
  np.testing.assert_array_equal(got["contact.solimp"][0, i], mj.pair_solimp[0])
  assert got["contact.includemargin"][0, i] == mj.pair_margin[0]
  (pair,) = [p for p in ttp.pairs if p.pair_id == 0]
  assert pair.condim == int(mj.pair_dim[0]) == 6
  mjd = mujoco.MjData(mj)
  mujoco.mj_forward(mj, mjd)
  assert mjd.ncon == 1 and int(mjd.contact.dim[0]) == 6
  np.testing.assert_allclose(got["contact.friction"][0, i], mjd.contact.friction[0])
  np.testing.assert_allclose(got["contact.solimp"][0, i], mjd.contact.solimp[0])
  assert got["contact.includemargin"][0, i] == mjd.contact.includemargin[0]


def test_pair_only_trajectory():
  """Only the unfiltered pair collides; the condim-6 rolling trajectory
  tells the pair's parameters from geom-mixed ones: 60 steps (the JAX
  test's 100, cut to keep the file fast)."""
  with torch_threads(1):
    r = surface_rollout("pair_only", 60)
  for i, f in enumerate(("qpos", "qvel")):
    assert_close(r.port[i], r.jax[i], ROLLOUT_TOL, f)
  np.testing.assert_allclose(r.port[0][0], r.mujoco[0], atol=1e-8)
  np.testing.assert_allclose(r.port[1][0], r.mujoco[1], atol=1e-7)


def test_pair_precedence_over_dynamic():
  """The frictionless condim-1 pair replaces the dynamic pair of the same
  geoms (friction 0.8): one topology pair, and the ball keeps sliding
  (80 steps, the JAX test's 150 cut)."""
  with torch_threads(1):
    r = surface_rollout("pair_precedence", 80)
  assert len([p for p in r.ttp.pairs if {p.geom1, p.geom2} == {0, 1}]) == 1
  for i, f in enumerate(("qpos", "qvel")):
    assert_close(r.port[i], r.jax[i], ROLLOUT_TOL, f)
  np.testing.assert_allclose(r.port[0][0], r.mujoco[0], atol=1e-8)
  assert r.port[1][0, 0] > 0.95


def test_pair_into_terrain_pool_refused():
  """A pair naming a geom of a box pool (81 world boxes > TERRAIN_POOL_MIN)
  would be counted again by the pool's broadphase: both packages refuse."""
  n = 9
  boxes = "\n".join(
    f'<geom name="t{i}_{j}" type="box" size="0.5 0.5 0.05" pos="{i - n / 2} {j - n / 2} 0"/>'
    for i in range(n) for j in range(n))
  xml = f"""
<mujoco><worldbody>
    {boxes}
    <body pos="0 0 0.3"><freejoint/><geom name="ball" type="sphere" size="0.1"/></body>
  </worldbody>
  <contact><pair geom1="t0_0" geom2="ball" friction="2 2 0.01 0 0"/></contact>
</mujoco>"""
  mj = mujoco.MjModel.from_xml_string(xml)
  with pytest.raises(NotImplementedError, match="terrain-pool"):
    tio.put_model(mj, dtype=torch.float64, device="cpu")
  with pytest.raises(NotImplementedError, match="terrain-pool"):
    jphysics.put_model(mj)


@pytest.mark.parametrize("cone", ["elliptic", "pyramidal"])
def test_pair_solreffriction(cone):
  """solreffriction damps the elliptic friction rows (the pyramid ignores
  it): a sliding ball, 80 steps under each cone (the JAX test's 150
  cut)."""
  c = {"elliptic": mujoco.mjtCone.mjCONE_ELLIPTIC, "pyramidal": mujoco.mjtCone.mjCONE_PYRAMIDAL}
  with torch_threads(1):
    r = surface_rollout("pair_solreffriction", 80, cone=c[cone])
  for i, f in enumerate(("qpos", "qvel")):
    assert_close(r.port[i], r.jax[i], ROLLOUT_TOL, f)
  np.testing.assert_allclose(r.port[0][0], r.mujoco[0], atol=1e-8)
  np.testing.assert_allclose(r.port[1][0], r.mujoco[1], atol=1e-7)
