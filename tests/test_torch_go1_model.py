"""The Go1 velocity-flat scene (Mjlab-Velocity-Flat-Unitree-Go1) in the
PyTorch port: put_model against the JAX package's (the plane–capsule,
plane–sphere and plane–box pairs, 57 contact slots, 240 Newton rows), the
committed npz's freshness, the env built from it on the CPU, and the
default device."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics.types import mjtGeom

TASK = "Mjlab-Velocity-Flat-Unitree-Go1"


@pytest.fixture(scope="module")
def models():
  mj = tp.go1_mj_model()
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(assets.load_model_npz(assets.GO1_VELOCITY_FLAT),
                          dtype=torch.float64, device="cpu")
  return mj, jtp, jm, ttp, tm


def test_topology_equal(models):
  _, jtp, _, ttp, _ = models
  assert [dataclasses.astuple(p) for p in ttp.pairs] == [
    dataclasses.astuple(p) for p in jtp.pairs
  ]
  kinds = [(p.type1, p.type2) for p in ttp.pairs]
  G = mjtGeom
  assert (kinds.count((G.mjGEOM_PLANE, G.mjGEOM_SPHERE)),
          kinds.count((G.mjGEOM_PLANE, G.mjGEOM_CAPSULE)),
          kinds.count((G.mjGEOM_PLANE, G.mjGEOM_BOX))) == (5, 24, 1)
  assert (ttp.nv, ttp.nu, ttp.ncon_max, ttp.nefc) == (jtp.nv, jtp.nu, jtp.ncon_max, jtp.nefc)
  assert (ttp.nv, ttp.nu, ttp.ncon_max, ttp.nefc) == (18, 12, 57, 240)
  assert ttp.terrain_groups == ()
  for f in ("body_parentid", "jnt_qposadr", "geom_type", "geom_condim", "geom_priority",
            "limited_joint_ids", "trn_vmat"):
    np.testing.assert_array_equal(getattr(ttp, f), getattr(jtp, f), err_msg=f)


def test_model_leaves_equal(models):
  _, _, jm, _, tm = models
  want = tp.jax_model_arrays(jm)
  for f in tio.model_fields():
    np.testing.assert_array_equal(getattr(tm, f).numpy(), want[f], err_msg=f)


def test_npz_is_fresh(tmp_path):
  """The committed npz equals save_model_npz of a fresh Go1 compile.

  Regenerate it with:
  PYTHONPATH=.:tests JAX_PLATFORMS=cpu python -c "import torch_parity as tp; from mjlab_tpu_torch import assets; assets.save_model_npz(tp.go1_mj_model(), assets.GO1_VELOCITY_FLAT)"
  """
  fresh = tmp_path / "go1.npz"
  assets.save_model_npz(tp.go1_mj_model(), fresh)
  with np.load(fresh) as a, np.load(assets.GO1_VELOCITY_FLAT) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
  assert assets.GO1_VELOCITY_FLAT.stat().st_size < 200_000


@pytest.mark.parametrize("task,dims", [
  (TASK, (48, 72, 12)),
  ("Mjlab-Velocity-Rough-Unitree-G1", (99, 111, 29)),
])
def test_make_env_builds_from_the_npz_and_steps(task, dims):
  from mjlab_tpu_torch.tasks import make_env

  with tp.torch_threads(1):
    env = make_env(task, num_envs=2, device="cpu")
    obs, _ = env.reset(seed=0)
    assert (obs["policy"].shape[1], obs["critic"].shape[1], env.total_action_dim) == dims
    for _ in range(3):
      obs, rew, term, tout, extras = env.step(torch.zeros(2, dims[2]))
  assert torch.isfinite(obs["policy"]).all() and torch.isfinite(rew).all()
  assert float(extras["log"]["Metrics/physics/terrain_slots_dropped"]) == 0.0


@pytest.mark.parametrize("task", [TASK, "Mjlab-Velocity-Rough-Unitree-G1"])
def test_default_device_is_cuda(task):
  from mjlab_tpu_torch.tasks import make_env

  if torch.cuda.is_available():
    assert make_env(task, num_envs=2).device.type == "cuda"
    return
  with pytest.raises((RuntimeError, AssertionError)):
    make_env(task, num_envs=2)
