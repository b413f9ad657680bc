"""The port's observation manager (mjlab_tpu_torch/managers/
observation_manager.py) against the JAX package's, on the cases of
tests/test_observation_pipeline.py, with a mock env each (the managers need
no physics). Both managers get the same term values, computes and masked
resets; every observation agrees within 1e-12.

The pipeline's draws are handed across as state: after construction the
JAX manager's "observation" namespace (delay lags and phases, history, the
noise models' biases) is carried into the port's (`carry`), and after every
reset, once the delay and history state are found equal, the biases the
reset drew; the per-step noise is certain (constant or zero-width). The
draws themselves are held against JAX's in test_torch_buffers.py and
test_torch_noise_models.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.managers import manager_term_config as jcfg
from mjlab_tpu.managers.observation_manager import ObservationManager as JaxManager
from mjlab_tpu.utils import noise as jnoise
from mjlab_tpu_torch.managers import manager_term_config as tcfg
from mjlab_tpu_torch.managers.observation_manager import ObservationManager
from mjlab_tpu_torch.utils import noise as tnoise
from tests.torch_parity import assert_close

B = 5
TOL = 1e-12


class JaxMock:
  """The context the JAX managers read: num_envs, dtype, ns, next_key."""

  def __init__(self):
    self.num_envs, self.dtype = B, jnp.float64
    self._ms: dict = {}
    self._rng = jax.random.key(0)
    self.values = np.zeros((B, 2))

  def ns(self, name):
    return self._ms.setdefault(name, {})

  def next_key(self):
    self._rng, key = jax.random.split(self._rng)
    return key

  def obs(self, offset):
    return jnp.asarray(self.values + offset)


class TorchMock:
  """The port's context: num_envs, dtype, device, generator, ns."""

  def __init__(self):
    self.num_envs, self.dtype, self.device = B, torch.float64, torch.device("cpu")
    self._ms: dict = {}
    self.generator = torch.Generator().manual_seed(0)
    self.values = np.zeros((B, 2))

  def ns(self, name):
    return self._ms.setdefault(name, {})

  def obs(self, offset):
    return torch.as_tensor(self.values + offset)


def value(env, offset: float = 0.0):
  return env.obs(offset)


def carry(jenv: JaxMock, env: TorchMock, parts=("delay", "history", "noise")) -> None:
  """The JAX manager's observation state (its `parts`) into the port's,
  leaf by leaf."""

  def fill(src, dst):
    assert sorted(src) == sorted(dst)
    for k, v in src.items():
      if isinstance(v, dict):
        fill(v, dst[k])
      else:
        dst[k] = torch.as_tensor(np.array(v)).to(dst[k].dtype)

  for part in parts:
    fill(jenv.ns("observation")[part], env.ns("observation")[part])


def _state_equal(jenv: JaxMock, env: TorchMock, part: str, what: str) -> None:
  def walk(src, dst, path):
    for k, v in src.items():
      if isinstance(v, dict):
        walk(v, dst[k], f"{path}/{k}")
      else:
        np.testing.assert_array_equal(dst[k].numpy(), np.asarray(v), err_msg=f"{path}/{k}")

  walk(jenv.ns("observation")[part], env.ns("observation")[part], f"{what} {part}")


def _bias_model(mod):
  return mod.NoiseModelWithAdditiveBiasCfg(
    noise_cfg=mod.UniformNoiseCfg(n_min=0.25, n_max=0.25),
    bias_noise_cfg=mod.UniformNoiseCfg(n_min=-0.5, n_max=0.5),
  )


# Each case: the groups' cfgs from one package's (term cfg module, noise module).
CASES = {
  # noise → clip → scale: a large constant noise is clipped before the scale.
  "pipeline_order": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "a": c.ObservationTermCfg(func=value, noise=n.ConstantNoiseCfg(bias=100.0),
                              clip=(-1.0, 1.0), scale=10.0),
    "b": c.ObservationTermCfg(func=value, params={"offset": 2.0}, clip=(-3.0, 3.0),
                              scale=(0.5, -2.0)),
  }, enable_corruption=True)},
  "corruption_disabled": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "a": c.ObservationTermCfg(func=value, noise=n.ConstantNoiseCfg(bias=5.0)),
  }, enable_corruption=False)},
  "term_history_flat": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "a": c.ObservationTermCfg(func=value, history_length=3),
    "b": c.ObservationTermCfg(func=value, params={"offset": 1.0}),
  })},
  "term_history_unflat": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "a": c.ObservationTermCfg(func=value, history_length=3, flatten_history_dim=False),
    "b": c.ObservationTermCfg(func=value, history_length=2, scale=3.0),
  }, concatenate_terms=False)},
  "group_history": lambda c, n: {
    "policy": c.ObservationGroupCfg(terms={
      "a": c.ObservationTermCfg(func=value, history_length=5),
      "b": c.ObservationTermCfg(func=value, params={"offset": -1.0}),
    }, history_length=2),
    "critic": c.ObservationGroupCfg(terms={
      "a": c.ObservationTermCfg(func=value, history_length=4),
    }, history_length=3, flatten_history_dim=False, concatenate_terms=False),
  },
  "delay": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "fixed": c.ObservationTermCfg(func=value, delay_min_lag=1, delay_max_lag=1),
    "per_env": c.ObservationTermCfg(func=value, params={"offset": 3.0}, delay_min_lag=0,
                                    delay_max_lag=3, delay_hold_prob=1.0),
    "shared": c.ObservationTermCfg(func=value, delay_min_lag=0, delay_max_lag=2,
                                   delay_per_env=False, delay_hold_prob=1.0),
  })},
  "delay_then_history": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "a": c.ObservationTermCfg(func=value, scale=2.0, delay_min_lag=0, delay_max_lag=2,
                              delay_hold_prob=1.0, history_length=3),
  })},
  "noise_model": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "a": c.ObservationTermCfg(func=value, noise=_bias_model(n), clip=(-2.0, 2.0)),
    "b": c.ObservationTermCfg(func=value, noise=n.NoiseModelCfg(
      noise_cfg=n.ConstantNoiseCfg(bias=0.5, operation="scale"))),
  }, enable_corruption=True)},
  "sim_to_real": lambda c, n: {"policy": c.ObservationGroupCfg(terms={
    "pos": c.ObservationTermCfg(func=value, noise=_bias_model(n)),
    "vel": c.ObservationTermCfg(func=value, params={"offset": 1.0}, scale=0.05,
                                noise=n.UniformNoiseCfg(n_min=0.1, n_max=0.1),
                                delay_min_lag=0, delay_max_lag=2, delay_hold_prob=1.0),
  }, enable_corruption=True, history_length=3)},
}

# (what, arg): set new values and compute (arg: update_history), or reset
# the masked envs.
SCHEDULE = [
  ("compute", True), ("compute", True), ("compute", True),
  ("reset", [True, False, False, True, False]),
  ("compute", True), ("compute", False), ("compute", True),
  ("reset", [False, True, True, False, False]),
  ("compute", True), ("compute", True),
]


def _out(x):
  return {k: _out(v) for k, v in x.items()} if isinstance(x, dict) else np.asarray(x)


def _close(got, want, what):
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), what
    for k in want:
      _close(got[k], want[k], f"{what}/{k}")
  else:
    assert_close(got, want, TOL, what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_observation_manager_matches_jax(case):
  jenv, env = JaxMock(), TorchMock()
  jmgr = JaxManager(CASES[case](jcfg, jnoise), jenv)
  mgr = ObservationManager(CASES[case](tcfg, tnoise), env)
  assert mgr.group_obs_dim == jmgr.group_obs_dim
  assert mgr.active_terms == jmgr.active_terms
  carry(jenv, env)
  rng = np.random.default_rng(3)
  for i, (what, arg) in enumerate(SCHEDULE):
    if what == "reset":
      jmgr.reset(jnp.asarray(arg))
      mgr.reset(torch.as_tensor(arg))
      for part in ("delay", "history"):
        _state_equal(jenv, env, part, f"{case} reset {i}")
      carry(jenv, env, parts=("noise",))  # the biases drawn by the reset
      continue
    jenv.values = env.values = rng.normal(size=(B, 2))
    want = _out(jmgr.compute(update_history=arg))
    got = _out({g: _out(v) if isinstance(v, dict) else v.numpy()
                for g, v in mgr.compute(update_history=arg).items()})
    _close(got, want, f"{case} step {i}")
    for g, dims in mgr.group_obs_dim.items():
      shapes = ([v.shape[1:] for v in got[g].values()] if isinstance(got[g], dict)
                else [got[g].shape[1:]])
      assert [tuple(s) for s in shapes] == [tuple(d) for d in
                                            (dims if isinstance(dims, list) else [dims])]


def test_history_and_delay_semantics():
  """The port's own behaviour, as tests/test_observation_pipeline.py states
  it: backfill, oldest-first flattening, update_history=False reads without
  appending, a masked reset backfills its rows, a fixed lag of 1 returns
  the previous value, and reset redraws the noise model's bias inside its
  range on the masked envs only."""
  env = TorchMock()
  mgr = ObservationManager({"policy": tcfg.ObservationGroupCfg(terms={
    "h": tcfg.ObservationTermCfg(func=value, history_length=3),
    "d": tcfg.ObservationTermCfg(func=value, delay_min_lag=1, delay_max_lag=1),
    "n": tcfg.ObservationTermCfg(func=value, noise=_bias_model(tnoise)),
  }, enable_corruption=True)}, env)
  rows = []
  for v, update in ((1.0, True), (2.0, True), (9.0, False)):
    env.values = np.full((B, 2), v)
    rows.append(mgr.compute(update_history=update)["policy"])
  assert rows[0].shape == (B, 6 + 2 + 2)
  assert torch.equal(rows[0][:, :6], torch.ones(B, 6, dtype=torch.float64))
  assert rows[1][0, :6].tolist() == [1, 1, 1, 1, 2, 2]
  assert rows[2][0, :6].tolist() == [1, 1, 1, 1, 2, 2]
  assert rows[1][0, 6:8].tolist() == [1, 1] and rows[2][0, 6:8].tolist() == [2, 2]
  assert torch.equal(rows[2][:, 8:], torch.full((B, 2), 9.25, dtype=torch.float64))
  mask = torch.tensor([True, False, False, True, False])
  mgr.reset(mask)
  env.values = np.full((B, 2), 7.0)
  out = mgr.compute(update_history=True)["policy"]
  assert out[0, :6].tolist() == [7.0] * 6 and out[1, :6].tolist() == [1, 1, 2, 2, 7, 7]
  bias = env.ns("observation")["noise"]["policy/n"]["bias"]
  assert bias[mask].abs().max() <= 0.5 and (bias[mask] != 0).all()
  assert torch.equal(bias[~mask], torch.zeros(3, 2, dtype=torch.float64))


def _shared(c, n, critic_history):
  """Two groups sharing one term cfg (the velocity tasks' critic terms are
  the policy's cfg objects): noise on the policy, none on the critic."""
  t = c.ObservationTermCfg(func=value, noise=n.ConstantNoiseCfg(bias=1.0))
  return {"policy": c.ObservationGroupCfg(terms={"a": t}, enable_corruption=True),
          "critic": c.ObservationGroupCfg(terms={"a": t}, history_length=critic_history)}


def test_groups_sharing_term_cfgs_behave_as_in_jax():
  """A reference fault both packages keep (ROADMAP Queue C): the managers
  write into the term cfg, so a later group's settings reach an earlier
  group's terms. The critic's enable_corruption=False strips the policy's
  noise (the policy reads 0, not 1), and a history on the critic alone
  makes the policy's compute raise KeyError."""
  for mods, Mgr, Env in (((jcfg, jnoise), JaxManager, JaxMock),
                         ((tcfg, tnoise), ObservationManager, TorchMock)):
    env = Env()
    out = Mgr(_shared(*mods, None), env).compute(update_history=True)
    assert float(np.asarray(out["policy"]).max()) == 0.0
    with pytest.raises(KeyError, match="policy"):
      Mgr(_shared(*mods, 2), Env()).compute(update_history=True)
