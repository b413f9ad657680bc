"""The port's motion pipeline against the JAX package's (float64, CPU):
`scripts/csv_to_npz.py` on a synthetic CSV, whose body frames come from the
port's kinematics on the compiled scene (frames as worlds) instead of
MuJoCo's C forward kinematics, and `tasks/tracking/motions.py`
`make_standing_motion`. Both write the entity's bodies, world excluded.

The JAX script casts its arrays to float32 at the end; the comparison at
1e-9 reads both pipelines before that cast (the port's `dtype` argument,
and the JAX module's `np.float32` read as float64)."""

from __future__ import annotations

import numpy as np
import pytest

import torch_parity as tp
from mjlab_tpu.scripts import csv_to_npz as jcsv
from mjlab_tpu_torch.scripts import csv_to_npz as tcsv

TOL = 1e-9
KEYS = ("joint_pos", "joint_vel", "body_pos_w", "body_quat_w", "body_lin_vel_w",
        "body_ang_vel_w")


class _Float64Numpy:
  """numpy, but with float32 meaning float64."""

  def __getattr__(self, name):
    return np.float64 if name == "float32" else getattr(np, name)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
  return tp.synthetic_motion_csv(tmp_path_factory.mktemp("csv") / "motion.csv")


def _jax_process_f64(path, monkeypatch):
  monkeypatch.setattr(jcsv, "np", _Float64Numpy())
  out = jcsv.process(path, robot="g1", input_fps=30.0, output_fps=50.0)
  monkeypatch.undo()
  return out


def test_csv_to_npz_matches_jax(csv_path, monkeypatch):
  want = _jax_process_f64(csv_path, monkeypatch)
  got = tcsv.process(csv_path, robot="g1", input_fps=30.0, output_fps=50.0, device="cpu",
                     dtype=np.float64)
  assert sorted(got) == sorted(want)
  assert got["body_pos_w"].shape == (100, 30, 3)  # 2 s at 50 fps, 30 G1 bodies
  assert float(got["fps"]) == 50.0
  for k in KEYS:
    assert got[k].dtype == np.float64
    tp.assert_close(got[k], want[k], TOL, k)
  # The velocities are not all trivial.
  assert np.abs(got["body_ang_vel_w"]).max() > 0.5 and np.abs(got["body_lin_vel_w"]).max() > 0.3


def test_csv_to_npz_writes_float32_like_jax(csv_path):
  want = jcsv.process(csv_path)
  got = tcsv.process(csv_path, device="cpu")
  assert sorted(got) == sorted(want)
  for k in KEYS:
    assert got[k].dtype == want[k].dtype == np.float32, k
    # float64 pipelines 1e-15 apart may round to neighbouring float32s.
    tp.assert_close(got[k], want[k], 2e-7, k)


def test_body_velocities_are_the_frames_time_derivatives(csv_path):
  """Each body's world linear velocity at its origin is the derivative of
  its position; its angular velocity is the derivative of its orientation
  (central differences over 20 ms, so to a few 1e-2)."""
  out = tcsv.process(csv_path, device="cpu", dtype=np.float64)
  dt = 1.0 / 50.0
  num_lin = np.gradient(out["body_pos_w"], dt, axis=0)
  q = out["body_quat_w"]
  num_ang = np.stack([tcsv._so3_finite_diff(q[:, b], dt) for b in range(q.shape[1])], 1)
  for got, num, what in ((out["body_lin_vel_w"], num_lin, "lin"),
                         (out["body_ang_vel_w"], num_ang, "ang")):
    err = np.abs(got[2:-2] - num[2:-2]).max()
    assert err < 0.05 * max(1.0, np.abs(num).max()), (what, err)


def test_pitching_base_diverges_from_jax_where_jax_mixes_frames(tmp_path, monkeypatch):
  """A base that pitches: the port rotates the world-frame finite-difference
  angular velocity into the free joint's body frame before the replay, so
  the root body's harvested angular velocity is that world-frame one. The
  JAX script writes the world-frame vector into the body-frame slot
  (mjlab_tpu/scripts/csv_to_npz.py:123), so its root angular velocity is
  the same vector rotated once more by the base orientation: a fault of the
  reference that the port does not mirror (ROADMAP, declared divergences).
  With a base that only yaws the two agree (test_csv_to_npz_matches_jax)."""
  path = tp.synthetic_motion_csv(tmp_path / "pitch.csv", pitch=0.4)
  raw = np.loadtxt(path, delimiter=",")
  pos, quat, _ = tcsv.resample(raw[:, :3], raw[:, 3:7], raw[:, 7:], 30.0, 50.0)
  fd = tcsv._so3_finite_diff(quat, 1.0 / 50.0)
  got = tcsv.process(path, device="cpu", dtype=np.float64)
  want = _jax_process_f64(path, monkeypatch)
  tp.assert_close(got["body_ang_vel_w"][:, 0], fd, TOL, "port root angular velocity")
  tp.assert_close(got["body_pos_w"], want["body_pos_w"], TOL, "body_pos_w")
  gap = np.abs(want["body_ang_vel_w"][:, 0] - fd).max()
  assert gap > 0.05, gap
  # JAX's root angular velocity is R(q) applied to the world-frame one.
  w = np.concatenate([np.zeros_like(fd[:, :1]), fd], -1)
  conj = quat * np.array([1.0, -1.0, -1.0, -1.0])
  rotated = tcsv._quat_mul(tcsv._quat_mul(quat, w), conj)[:, 1:]
  tp.assert_close(want["body_ang_vel_w"][:, 0], rotated, TOL, "JAX root angular velocity")


def test_resample_endpoints_and_rate():
  pos = np.linspace([0, 0, 0], [1, 2, 3], 31)
  quat = np.tile([1.0, 0, 0, 0], (31, 1))
  joints = np.linspace([0.0, -1.0], [1.0, 1.0], 31)
  p, q, j = tcsv.resample(pos, quat, joints, 30.0, 60.0)
  jp, jq, jj = jcsv.resample(pos, quat, joints, 30.0, 60.0)
  assert p.shape[0] == 60
  np.testing.assert_array_equal(p, jp)
  np.testing.assert_array_equal(q, jq)
  np.testing.assert_array_equal(j, jj)
  np.testing.assert_allclose(p[30], pos[15], atol=1e-9)


def test_standing_motion_matches_jax(tmp_path):
  from mjlab_tpu.asset_zoo.robots.unitree_g1.g1_constants import get_g1_robot_cfg
  from mjlab_tpu.tasks.tracking.motions import make_standing_motion as jax_standing
  from mjlab_tpu_torch.tasks.tracking.motions import make_standing_motion

  want = np.load(jax_standing(get_g1_robot_cfg(), tmp_path / "jax.npz", T=7, dt=0.025))
  got = np.load(make_standing_motion(tmp_path / "port.npz", T=7, dt=0.025, device="cpu"))
  assert sorted(got.files) == sorted(want.files)
  assert float(got["fps"]) == float(want["fps"]) == 40.0
  for k in KEYS:
    assert got[k].shape == want[k].shape, k
    tp.assert_close(got[k], want[k], TOL, k)


def test_motion_loader_reads_the_tracked_bodies(csv_path, tmp_path):
  """The port's MotionLoader gathers the same bodies as the JAX one."""
  import torch

  from mjlab_tpu.tasks.tracking.mdp.commands import MotionLoader as JaxLoader
  from mjlab_tpu_torch.tasks.tracking.mdp.commands import MotionLoader

  path = tmp_path / "m.npz"
  np.savez(path, **tcsv.process(csv_path, device="cpu"))
  ids = np.asarray([0, 3, 16, 29])
  want = JaxLoader(str(path), ids, np.float64)
  got = MotionLoader(str(path), ids, torch.float64, "cpu")
  assert got.time_step_total == want.time_step_total == 100
  for k in KEYS:
    np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k), err_msg=k)
