"""The committed scenes of the actuation and tendon surface
(mjlab_tpu_torch/assets/muscle/*.npz, mjlab_tpu_torch/assets/
muscle_scenes.py, and the hopper env's assets/hopper_filter.npz): each is
fresh, and put_model on it gives the JAX package's Topology (row counts,
activations, tendon segment tables, the fluid flag) and the live model's
Model.

Regenerate the files with:
PYTHONPATH=.:tests JAX_PLATFORMS=cpu python -c "import mujoco; from mjlab_tpu_torch.assets import save_model_npz; from mjlab_tpu_torch.assets.muscle_scenes import SCENES; [save_model_npz(mujoco.MjModel.from_xml_string(s.xml), s.path(n)) for n, s in SCENES.items()]; import torch_parity as tp; tp.save_hopper_filter_npz()"
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.assets import muscle_scenes
from mjlab_tpu_torch.physics import io as tio


@functools.cache
def _committed(path) -> dict[str, np.ndarray]:
  """The committed file's arrays, read once."""
  with np.load(path) as b:
    return {k: b[k] for k in b.files}


@functools.cache
def _live(name: str) -> mujoco.MjModel:
  return mujoco.MjModel.from_xml_string(muscle_scenes.SCENES[name].xml)


def _same_arrays(model, committed) -> None:
  """The arrays save_model_npz would write for `model` equal the committed
  file's (compared in memory: no compressed write)."""
  fresh = assets.model_arrays(model)
  b = _committed(committed)
  assert sorted(fresh) == sorted(b)
  for k, a in fresh.items():
    assert a.dtype == b[k].dtype, k
    assert np.array_equal(a, b[k], equal_nan=a.dtype.kind == "f"), k


@pytest.mark.parametrize("name", sorted(muscle_scenes.SCENES))
def test_npz_is_fresh(name):
  _same_arrays(_live(name), muscle_scenes.SCENES[name].path(name))


def test_hopper_npz_is_fresh():
  """The JAX test env's compile (tests/test_physics_actdyn.py
  `_make_filter_env`): its scene spec alone, without the env's jitted
  steps."""
  from tests.torch_parity import hopper_filter_mj_model

  _same_arrays(hopper_filter_mj_model(), muscle_scenes.HOPPER_FILTER)


_TOPOLOGY = ("nefc", "neq_rows", "na", "ntendon", "has_fluid")
_TABLES = ("tendon_kind", "tendon_seg_sites", "tendon_seg_scale", "tendon_seg_geom",
           "tendon_seg_side", "actuator_dyn_tendon", "act_actuator", "trn_qmat", "trn_vmat",
           "tendon_qmat", "tendon_vmat", "limited_tendon_ids", "friction_dof_ids")


@pytest.mark.parametrize("name", sorted(muscle_scenes.SCENES))
def test_npz_topology_equals_jax(name):
  live = _live(name)
  jtp, _ = jphysics.put_model(live, dtype=jnp.float64)
  committed = assets.model_namespace(_committed(muscle_scenes.SCENES[name].path(name)))
  tp, m = tio.put_model(committed, dtype=torch.float64, device="cpu")
  _, m_live = tio.put_model(live, dtype=torch.float64, device="cpu")
  for f in _TOPOLOGY:
    assert getattr(tp, f) == getattr(jtp, f), f
  for f in _TABLES:
    assert np.array_equal(getattr(tp, f), getattr(jtp, f)), f
  for f in tio.model_fields():
    assert torch.equal(getattr(m, f), getattr(m_live, f)), f
