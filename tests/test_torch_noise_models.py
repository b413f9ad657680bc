"""The port's noise cfgs and noise models (mjlab_tpu_torch/utils/noise.py)
against the JAX package's (mjlab_tpu/utils/noise.py), on the cases of
tests/test_noise.py. JAX's draws are handed across: `torch.rand` and
`torch.randn` return the standard uniforms and normals that
`jax.random.uniform` / `jax.random.normal` draw under the JAX call's key.
Tolerance 1e-12."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.utils import noise as jnoise
from mjlab_tpu_torch.utils import noise as tnoise
from tests.torch_parity import assert_close

TOL = 1e-12
B = 8


def _data(rng=None):
  if rng is None:
    return np.full((B, 4), 2.0)
  return rng.normal(size=(B, 4))


@contextlib.contextmanager
def jax_draws(monkeypatch, key):
  """torch.rand / torch.randn return the standard draws JAX makes under
  `key` (the keys a noise cfg's `apply` uses)."""

  def rand(shape, generator=None, dtype=None, device=None):
    return torch.as_tensor(np.array(jax.random.uniform(key, tuple(shape), jnp.float64)),
                           dtype=dtype)

  def randn(shape, generator=None, dtype=None, device=None):
    return torch.as_tensor(np.array(jax.random.normal(key, tuple(shape), jnp.float64)),
                           dtype=dtype)

  with monkeypatch.context() as m:
    m.setattr(torch, "rand", rand)
    m.setattr(torch, "randn", randn)
    yield


CFGS = [
  ("ConstantNoiseCfg", dict(bias=0.5, operation="add")),
  ("ConstantNoiseCfg", dict(bias=0.5, operation="scale")),
  ("ConstantNoiseCfg", dict(bias=0.5, operation="abs")),
  ("UniformNoiseCfg", dict(n_min=-0.1, n_max=0.1)),
  ("UniformNoiseCfg", dict(n_min=0.5, n_max=1.5, operation="scale")),
  ("UniformNoiseCfg", dict(n_min=-0.3, n_max=0.2, operation="abs")),
  ("GaussianNoiseCfg", dict(mean=1.0, std=0.5)),
  ("GaussianNoiseCfg", dict(mean=0.0, std=0.2, operation="scale")),
]


@pytest.mark.parametrize("name,kw", CFGS)
def test_noise_cfg_matches_jax(monkeypatch, name, kw):
  data = _data(np.random.default_rng(0))
  key = jax.random.PRNGKey(3)
  want = getattr(jnoise, name)(**kw).apply(key, jnp.asarray(data))
  with jax_draws(monkeypatch, key):
    got = getattr(tnoise, name)(**kw).apply(torch.Generator(), torch.as_tensor(data))
  assert_close(got.numpy(), want, TOL, name)


@pytest.mark.parametrize("noise_cfg", [None, ("UniformNoiseCfg", dict(n_min=-1.0, n_max=1.0))])
def test_stateless_noise_model_matches_jax(monkeypatch, noise_cfg):
  make = (lambda mod: None) if noise_cfg is None else (
    lambda mod: getattr(mod, noise_cfg[0])(**noise_cfg[1]))
  jm = jnoise.NoiseModel(jnoise.NoiseModelCfg(noise_cfg=make(jnoise)), num_envs=B)
  tm = tnoise.NoiseModel(tnoise.NoiseModelCfg(noise_cfg=make(tnoise)), num_envs=B)
  data = _data()
  assert jm.init_state(jnp.asarray(data)) == tm.init_state(torch.as_tensor(data)) == {}
  key = jax.random.PRNGKey(0)
  want = jm.apply({}, key, jnp.asarray(data))
  with jax_draws(monkeypatch, key):
    got = tm.apply({}, torch.Generator(), torch.as_tensor(data))
  assert_close(got.numpy(), want, TOL, "stateless model")


def _bias_models(noise_cfg, bias_cfg):
  def cfg(mod):
    return mod.NoiseModelWithAdditiveBiasCfg(
      noise_cfg=None if noise_cfg is None else getattr(mod, noise_cfg[0])(**noise_cfg[1]),
      bias_noise_cfg=getattr(mod, bias_cfg[0])(**bias_cfg[1]),
    )

  jcfg, tcfg = cfg(jnoise), cfg(tnoise)
  assert jcfg.class_type is jnoise.NoiseModelWithAdditiveBias
  assert tcfg.class_type is tnoise.NoiseModelWithAdditiveBias
  return jcfg.class_type(jcfg, num_envs=B), tcfg.class_type(tcfg, num_envs=B)


@pytest.mark.parametrize("noise_cfg,bias_cfg", [
  (None, ("UniformNoiseCfg", dict(n_min=-1.0, n_max=1.0))),
  (("ConstantNoiseCfg", dict(bias=1.0)), ("ConstantNoiseCfg", dict(bias=0.25, operation="abs"))),
  (("UniformNoiseCfg", dict(n_min=-0.01, n_max=0.01)),
   ("UniformNoiseCfg", dict(n_min=-0.02, n_max=0.02))),
  (("GaussianNoiseCfg", dict(std=0.1)), ("GaussianNoiseCfg", dict(mean=0.1, std=0.05))),
])
def test_additive_bias_model_matches_jax(monkeypatch, noise_cfg, bias_cfg):
  """Zero bias at init; masked resets redraw the bias of the masked rows
  only; apply adds it (and the per-step noise) without changing it."""
  jm, tm = _bias_models(noise_cfg, bias_cfg)
  data = _data(np.random.default_rng(1))
  jst, st = jm.init_state(jnp.asarray(data)), tm.init_state(torch.as_tensor(data))
  assert_close(st["bias"].numpy(), jst["bias"], TOL, "initial bias")
  for i, mask in enumerate((np.arange(B) < 4, np.arange(B) >= 6, np.ones(B, bool))):
    key = jax.random.PRNGKey(10 + i)
    jst = jm.reset(jst, key, jnp.asarray(mask))
    with jax_draws(monkeypatch, key):
      st = tm.reset(st, torch.Generator(), torch.as_tensor(mask))
    assert_close(st["bias"].numpy(), jst["bias"], TOL, f"bias after reset {i}")
    key = jax.random.PRNGKey(20 + i)
    want = jm.apply(jst, key, jnp.asarray(data))
    with jax_draws(monkeypatch, key):
      got = tm.apply(st, torch.Generator(), torch.as_tensor(data))
    assert_close(got.numpy(), want, TOL, f"apply after reset {i}")
  if noise_cfg is None:  # the bias is episode-constant: apply twice, same output
    again = tm.apply(st, torch.Generator(), torch.as_tensor(data))
    assert torch.equal(again, got)


def test_additive_bias_draws_from_the_generator():
  """The port's own draws: the masked rows' bias inside the bias range and
  different across envs, the other rows untouched; a reset of every env
  (env_mask None) redraws every row."""
  _, tm = _bias_models(None, ("UniformNoiseCfg", dict(n_min=-0.02, n_max=0.02)))
  gen = torch.Generator().manual_seed(0)
  st = tm.reset(tm.init_state(torch.zeros(B, 3)), gen, torch.arange(B) < 5)
  bias = st["bias"]
  assert bias[:5].abs().max() <= 0.02 and len(bias[:5].unique()) == 15
  assert torch.equal(bias[5:], torch.zeros(3, 3))
  st = tm.reset(st, gen, None)
  assert (st["bias"] != 0).all() and not torch.equal(st["bias"][:5], bias[:5])
