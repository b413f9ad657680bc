"""The port's NaN guard against the JAX package's (tests/test_nan_guard.py's
stand-in env, the same states for both): a disabled guard never fires; on
NaN or inf in envs 1 and 3 of 4 both dump the same rings, with the same
keys and length, and point `latest` at the dump; the port writes the env's
compiled model as model.npz, which `load_model_npz` reads back equal; and
`train --enable_nan_guard` trains through healthy iterations and stops with
a dump at the first NaN."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

TASK = "Mjlab-Velocity-Flat-Unitree-G1"
TINY = {
  "env.scene.num_envs": "2",
  "agent.num_steps_per_env": "2",
  "agent.max_iterations": "2",
  "agent.policy.actor_hidden_dims": "(16,)",
  "agent.policy.critic_hidden_dims": "(16,)",
  "agent.algorithm.num_learning_epochs": "1",
  "agent.algorithm.num_mini_batches": "2",
  "agent.device": "cpu",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _envs(num_envs: int = 4):
  """The JAX test's stand-in env (numpy state, a compiled sphere model) and
  the port's on the same model (torch state; the port's guard reads
  `env.data`)."""
  import mujoco

  from mjlab_tpu_torch.assets import load_model_npz, save_model_npz

  model = mujoco.MjSpec.from_string(
    """<mujoco><worldbody><body name="b" pos="0 0 1">
      <freejoint/><geom type="sphere" size="0.1"/></body></worldbody></mujoco>"""
  ).compile()
  nq, nv = model.nq, model.nv
  shapes = {"qpos": (num_envs, nq), "qvel": (num_envs, nv), "qacc": (num_envs, nv),
            "ctrl": (num_envs, 0), "time": (num_envs,)}
  jdata = types.SimpleNamespace(**{k: np.zeros(s) for k, s in shapes.items()})
  tdata = types.SimpleNamespace(**{k: torch.zeros(s, dtype=torch.float64)
                                   for k, s in shapes.items()})
  jenv = types.SimpleNamespace(state=types.SimpleNamespace(data=jdata),
                               sim=types.SimpleNamespace(mj_model=model))
  import tempfile

  with tempfile.TemporaryDirectory() as d:
    save_model_npz(model, f"{d}/m.npz")
    ns = load_model_npz(f"{d}/m.npz")
  tenv = types.SimpleNamespace(data=tdata, sim=types.SimpleNamespace(mj_model=ns))
  return jenv, tenv


def _set(jenv, tenv, key, idx, value):
  getattr(jenv.state.data, key)[idx] = value
  getattr(tenv.data, key)[idx] = torch.as_tensor(np.asarray(value, dtype=np.float64))


def test_disabled_guard_never_fires(tmp_path):
  from mjlab_tpu_torch.utils.nan_guard import NanGuard, NanGuardCfg

  _, env = _envs()
  guard = NanGuard(NanGuardCfg(enabled=False, output_dir=str(tmp_path)), env)
  env.data.qpos[0, 0] = float("nan")
  assert guard.watch() is False
  assert not any(tmp_path.iterdir())


def test_dump_on_nan_matches_jax(tmp_path):
  from mjlab_tpu.utils.nan_guard import NanGuard as JaxGuard
  from mjlab_tpu.utils.nan_guard import NanGuardCfg as JaxCfg
  from mjlab_tpu_torch.utils.nan_guard import NanGuard, NanGuardCfg

  jenv, tenv = _envs(4)
  kw = dict(enabled=True, buffer_size=5, max_envs_to_dump=2)
  jguard = JaxGuard(JaxCfg(**kw, output_dir=str(tmp_path / "jax")), jenv)
  guard = NanGuard(NanGuardCfg(**kw, output_dir=str(tmp_path / "torch")), tenv)
  rng = np.random.default_rng(0)
  for i in range(7):  # healthy steps fill the ring
    for key in ("qpos", "qvel", "qacc"):
      _set(jenv, tenv, key, slice(None), rng.normal(size=getattr(jenv.state.data, key).shape))
    _set(jenv, tenv, "time", slice(None), 0.02 * i)
    assert jguard.watch() is False and guard.watch() is False
  _set(jenv, tenv, "qpos", (1, 0), np.nan)
  _set(jenv, tenv, "qvel", (3, 0), np.inf)
  assert jguard.watch() is True and guard.watch() is True
  assert guard.watch() is False  # fires once
  dumps = {}
  for pkg in ("jax", "torch"):
    out = tmp_path / pkg
    run_dirs = [p for p in out.iterdir() if p.is_dir() and p.name != "latest"]
    assert len(run_dirs) == 1 and (out / "latest").is_symlink()
    assert (out / "latest").resolve() == run_dirs[0].resolve()
    dumps[pkg] = run_dirs[0]
  names = sorted(p.name for p in dumps["torch"].glob("env_*.npz"))
  assert names == sorted(p.name for p in dumps["jax"].glob("env_*.npz")) == [
    "env_1.npz", "env_3.npz"]
  for name in names:
    want, got = np.load(dumps["jax"] / name), np.load(dumps["torch"] / name)
    assert sorted(got.files) == sorted(want.files) == ["ctrl", "qacc", "qpos", "qvel", "time"]
    for k in want.files:
      assert got[k].shape == want[k].shape and want[k].shape[0] == 5, k
      np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
  assert np.isnan(np.load(dumps["torch"] / "env_1.npz")["qpos"][-1, 0])
  assert (dumps["jax"] / "model.mjb").is_file() and (dumps["torch"] / "model.npz").is_file()


def test_snapshots_do_not_alias_the_live_state(tmp_path):
  from mjlab_tpu_torch.utils.nan_guard import NanGuard, NanGuardCfg

  _, env = _envs(2)
  guard = NanGuard(NanGuardCfg(enabled=True, output_dir=str(tmp_path)), env)
  guard.watch()
  env.data.qpos.fill_(7.0)
  assert not np.any(guard._ring[0]["qpos"] == 7.0)


def test_model_npz_reloads_equal_to_the_envs_model(tmp_path):
  from mjlab_tpu_torch.assets import load_model_npz, model_arrays
  from mjlab_tpu_torch.tasks import make_env
  from mjlab_tpu_torch.utils.nan_guard import NanGuard, NanGuardCfg

  env = make_env(TASK, num_envs=4, device="cpu")
  env.reset(seed=0)
  env.step(torch.zeros(4, env.total_action_dim))
  guard = NanGuard(NanGuardCfg(enabled=True, output_dir=str(tmp_path)), env)
  assert guard.watch() is False
  env.data.qpos[[1, 3], 2] = float("nan")
  assert guard.watch() is True
  dump = (tmp_path / "latest").resolve()
  assert sorted(p.name for p in dump.glob("env_*.npz")) == ["env_1.npz", "env_3.npz"]
  ring = np.load(dump / "env_1.npz")
  assert ring["qpos"].shape == (2, 36) and ring["qvel"].shape == (2, 35)
  want = model_arrays(env.sim.mj_model)
  got = model_arrays(load_model_npz(dump / "model.npz"))
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  assert load_model_npz(dump / "model.npz").opt.iterations == env.sim.mj_model.opt.iterations


def test_train_with_the_guard(tmp_path, monkeypatch):
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner
  from mjlab_tpu_torch.scripts.train import run_train

  runner = run_train(TASK, {**TINY, "enable_nan_guard": "true", "log_dir": str(tmp_path / "ok")})
  assert runner.iteration == 2 and not (tmp_path / "ok" / "nan_dumps").exists()

  iterate = OnPolicyRunner.train_iteration

  def poisoned(self, *args, **kwargs):
    metrics = iterate(self, *args, **kwargs)
    if self.iteration == 1:
      self.env.data.qvel[1, 0] = float("nan")
    return metrics

  monkeypatch.setattr(OnPolicyRunner, "train_iteration", poisoned)
  with pytest.raises(RuntimeError, match="NaN detected"):
    run_train(TASK, {**TINY, "enable-nan-guard": "true", "log_dir": str(tmp_path / "nan")})
  dump = (tmp_path / "nan" / "nan_dumps" / "latest").resolve()
  assert sorted(p.name for p in dump.glob("*.npz")) == ["env_1.npz", "model.npz"]
  assert np.load(dump / "env_1.npz")["qvel"].shape[0] == 2  # iterations 0 and 1
