"""The G1 tracking task's configuration and the physics it adds, in the
PyTorch port against the JAX package (float64, CPU), without an env:

- the tracking scene compiles to the committed velocity-flat npz, which the
  port's tracking cfg loads;
- both registered tracking tasks, every term, its function, parameters and
  noise, the motion command's fields and the PPO cfg equal the JAX ones;
- the math helpers the task adds, within 1e-12;
- kinematics with per-env `qpos0` (B, nq) and `body_ipos` (B, nbody, 3),
  as the JAX package reads them under its vmap, within 1e-9."""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu.core import math as jmt
from mjlab_tpu_torch.core import math as tmt

TASK = "Mjlab-Tracking-Flat-Unitree-G1"
NO_SE = "Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation"


def _jax_cfg(task):
  from mjlab_tpu.tasks.tracking.config.g1 import env_cfgs

  return copy.deepcopy(env_cfgs.G1_FLAT_TRACKING_ENV_CFG if task == TASK
                       else env_cfgs.G1_FLAT_TRACKING_NO_STATE_ESTIMATION_ENV_CFG)


def test_tracking_scene_is_the_committed_velocity_npz(tmp_path):
  """The tracking cfg's scene compiles, with its solver options, to the
  same model as the velocity-flat one, so the port's tracking cfg points at
  assets/g1_velocity_flat.npz. Fails when the two scenes part."""
  from mjlab_tpu.scene import Scene
  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfg = _jax_cfg(TASK)
  m = Scene(cfg.scene).compile()
  cfg.sim.mujoco.apply(m)
  fresh = tmp_path / "tracking.npz"
  assets.save_model_npz(m, fresh)
  with np.load(fresh) as a, np.load(assets.G1_VELOCITY_FLAT) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
  for task in (TASK, NO_SE):
    assert load_env_cfg(task).scene.model_file == assets.G1_VELOCITY_FLAT


def _value(v):
  """A cfg value in comparable form: terms and entity selections by their
  fields, functions by name."""
  if callable(v) and hasattr(v, "__name__"):
    return v.__name__
  if dataclasses.is_dataclass(v):
    return type(v).__name__, {f.name: _value(getattr(v, f.name)) for f in dataclasses.fields(v)
                              if f.name not in ("preserve_order",)}
  if isinstance(v, dict):
    return {k: _value(x) for k, x in v.items()}
  if isinstance(v, (list, tuple)):
    return [_value(x) for x in v]
  return v


def _terms(group: dict) -> dict:
  return {name: {f.name: _value(getattr(c, f.name)) for f in dataclasses.fields(c)
                 if f.name not in ("class_type",)}
          for name, c in group.items() if c is not None}


@pytest.mark.parametrize("task", [TASK, NO_SE])
def test_tracking_cfg_matches_jax(task):
  from mjlab_tpu_torch.tasks import list_tasks, load_env_cfg

  assert task in list_tasks()
  want, got = _jax_cfg(task), load_env_cfg(task)
  for group in ("policy", "critic"):
    w, g = want.observations[group], got.observations[group]
    assert list(g.terms) == list(w.terms)
    assert g.enable_corruption == w.enable_corruption
    tw, tg = _terms(w.terms), _terms(g.terms)
    for name in tw:
      assert tg[name] == {k: v for k, v in tw[name].items() if k in tg[name]}, (group, name)
  for kind in ("rewards", "terminations", "events", "actions"):
    tw, tg = _terms(getattr(want, kind)), _terms(getattr(got, kind))
    assert list(tg) == list(tw), kind
    for name in tw:
      assert tg[name] == {k: v for k, v in tw[name].items() if k in tg[name]}, (kind, name)
  # The motion command, but for the viewer fields the port does not have.
  cw = {f.name: getattr(want.commands["motion"], f.name)
        for f in dataclasses.fields(want.commands["motion"])}
  cg = {f.name: getattr(got.commands["motion"], f.name)
        for f in dataclasses.fields(got.commands["motion"])}
  for k in ("debug_vis", "viz", "class_type"):
    cw.pop(k)
  cg.pop("class_type")
  assert cg == cw
  assert (got.decimation, got.episode_length_s) == (want.decimation, want.episode_length_s) == (4, 10.0)
  ow, og = want.sim.mujoco, got.sim.mujoco
  for f in ("timestep", "iterations", "ls_iterations", "tolerance", "ls_tolerance", "impratio"):
    assert getattr(og, f) == getattr(ow, f), f
  assert [s.name for s in got.scene.sensors] == [s.name for s in want.scene.sensors]


def test_tracking_cfg_is_fresh_per_call():
  from mjlab_tpu_torch.tasks import load_env_cfg

  a = load_env_cfg(TASK)
  a.commands["motion"].motion_file = "x.npz"
  a.observations["policy"].terms.pop("base_lin_vel")
  b = load_env_cfg(TASK)
  assert b.commands["motion"].motion_file == ""
  assert "base_lin_vel" in b.observations["policy"].terms
  ns = load_env_cfg(NO_SE).observations["policy"].terms
  assert "motion_anchor_pos_b" not in ns and "base_lin_vel" not in ns


def test_g1_tracking_rl_cfg_matches_jax():
  """The G1 tracking PPO cfg is the JAX package's, but for the device, the
  TPU relay's rollout modes and the fields that nothing in the port reads."""
  from mjlab_tpu.tasks.tracking.config.g1.rl_cfg import G1FlatPPORunnerCfg
  from mjlab_tpu_torch.tasks import load_rl_cfg

  want = dataclasses.asdict(G1FlatPPORunnerCfg())
  for task in (TASK, NO_SE):
    got = dataclasses.asdict(load_rl_cfg(task))
    assert got.pop("device") == "cuda"
    w = dict(want)
    assert w.pop("device") == "tpu"
    for k in ("fused_rollout", "rollout_chunk", "epoch_chunk", "packed_hostloop",
              "empirical_normalization", "run_name", "logger",
              "wandb_project", "load_run", "load_checkpoint"):
      w.pop(k)
    w = copy.deepcopy(w)
    for group in ("policy", "algorithm"):
      w[group].pop("class_name")
    assert got == w
    assert got["algorithm"]["entropy_coef"] == 0.005 and got["save_interval"] == 500


def test_tracking_math_helpers_match_jax():
  rng = np.random.default_rng(0)
  q1, q2 = (rng.normal(size=(64, 4)) for _ in range(2))
  q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
  q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
  t1, t2 = rng.normal(size=(64, 3)), rng.normal(size=(64, 3))
  T = torch.as_tensor
  tp.assert_close(tmt.quat_inv(T(q1)).numpy(), jmt.quat_inv(jnp.asarray(q1)), 1e-15, "quat_inv")
  tp.assert_close(tmt.quat_error_magnitude(T(q1), T(q2)).numpy(),
                  jmt.quat_error_magnitude(jnp.asarray(q1), jnp.asarray(q2)), 1e-12,
                  "quat_error_magnitude")
  tp.assert_close(tmt.yaw_quat(T(q1)).numpy(), jmt.yaw_quat(jnp.asarray(q1)), 1e-12, "yaw_quat")
  got = tmt.subtract_frame_transforms(T(t1), T(q1), T(t2), T(q2))
  want = jmt.subtract_frame_transforms(*map(jnp.asarray, (t1, q1, t2, q2)))
  for g, w, what in zip(got, want, ("pos", "quat")):
    tp.assert_close(g.numpy(), w, 1e-12, f"subtract_frame_transforms {what}")


def test_kinematics_with_per_env_qpos0_and_body_ipos():
  """Per-env qpos0 and body_ipos change the frames as the JAX package's
  vmapped kinematics computes them."""
  from mjlab_tpu import physics as jphysics
  from mjlab_tpu.physics import kinematics as jkin
  from mjlab_tpu_torch.physics import io as tio
  from mjlab_tpu_torch.physics import kinematics as tkin

  mj = tp.g1_mj_model()
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  B = 6
  rng = np.random.default_rng(3)
  qpos = np.tile(mj.key_qpos[0], (B, 1))
  qpos[:, 7:] += rng.normal(0.0, 0.1, (B, mj.nq - 7))
  qpos0 = np.tile(mj.qpos0, (B, 1)) + rng.uniform(-0.05, 0.05, (B, mj.nq))
  body_ipos = np.tile(mj.body_ipos, (B, 1, 1)) + rng.uniform(-0.05, 0.05, (B, mj.nbody, 3))

  jd = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                              jphysics.make_data(jtp, jm)).replace(qpos=jnp.asarray(qpos))
  jm_b = jm.replace(qpos0=jnp.asarray(qpos0), body_ipos=jnp.asarray(body_ipos))
  axes = jm_b.axes({"qpos0", "body_ipos"})
  want = jax.vmap(lambda m, d: jkin.kinematics(jtp, m, d), in_axes=(axes, 0))(jm_b, jd)

  td = tio.make_data(ttp, tm, B).replace(qpos=torch.as_tensor(qpos))
  tm_b = dataclasses.replace(tm, qpos0=torch.as_tensor(qpos0),
                             body_ipos=torch.as_tensor(body_ipos))
  got = tkin.kinematics(ttp, tm_b, td)
  shared = tkin.kinematics(ttp, tm, td)
  for f in ("xpos", "xquat", "xipos", "ximat", "geom_xpos", "site_xpos", "xanchor"):
    tp.assert_close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), 1e-9, f)
  # The per-env leaves matter: with the shared ones the frames differ.
  assert np.abs((got.xipos - shared.xipos).numpy()).max() > 1e-2
  assert np.abs((got.xpos - shared.xpos).numpy()).max() > 1e-2


def test_only_the_fields_the_physics_reads_per_env_expand():
  from mjlab_tpu_torch.assets import g1_velocity_sim_cfg, load_model_npz
  from mjlab_tpu_torch.sim import Simulation
  from mjlab_tpu_torch.sim.sim import PER_ENV_FIELDS

  sim = Simulation(3, g1_velocity_sim_cfg(), load_model_npz(), device="cpu")
  sim.expand_model_fields(("qpos0", "body_ipos"))
  assert sim.batched_fields == {"qpos0", "body_ipos"}
  assert sim.model.qpos0.shape == (3, 36) and sim.model.body_ipos.shape == (3, 32, 3)
  assert sim.unbatched_model.qpos0.shape == (36,)
  assert sim.make_data().qpos.shape == (3, 36)
  from mjlab_tpu_torch.envs.mdp.events import FIELD_SPECS

  assert set(PER_ENV_FIELDS) == set(FIELD_SPECS) and len(PER_ENV_FIELDS) == 19
  with pytest.raises(NotImplementedError, match="geom_size"):
    sim.expand_model_fields(("geom_size",))
