"""The port's ring and delay buffers (mjlab_tpu_torch/utils/buffers.py)
against the JAX package's (mjlab_tpu/utils/buffers.py), on the cases of
tests/test_buffers.py: both get the same appends, resets and masks, and the
JAX buffer's draws (its initial lags and phases, each append's lags and
hold uniforms) are handed to the port's. Exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.utils.buffers import CircularBuffer as JaxCircular
from mjlab_tpu.utils.buffers import DelayBuffer as JaxDelay
from mjlab_tpu_torch.utils.buffers import CircularBuffer, DelayBuffer


def _equal(got: torch.Tensor, want, what: str) -> None:
  np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def _ring_pair(max_len: int, batch: int, width: int = 3):
  return (JaxCircular(max_len, batch), CircularBuffer(max_len, batch),
          np.zeros((batch, width)))


@pytest.mark.parametrize("max_len,batch,masks", [
  (4, 2, [None, None]),  # backfill on the first append
  (3, 1, [None] * 4),  # the ring wraps: oldest to newest
  (3, 2, [None, None, [True, False], None, None]),  # a masked reset backfills its row
  (5, 3, [None, [False, True, True], None, [True, False, False], None]),
])
def test_circular_buffer_matches_jax(max_len, batch, masks):
  """Append, reset where a mask is given, and read the ordered view and
  `latest` at every lag after each call."""
  jcb, cb, zero = _ring_pair(max_len, batch)
  jst, st = jcb.init_state(jnp.asarray(zero)), cb.init_state(torch.as_tensor(zero))
  rng = np.random.default_rng(0)
  for i, mask in enumerate(masks):
    if mask is not None:
      jst = jcb.reset(jst, env_mask=jnp.asarray(mask))
      st = cb.reset(st, env_mask=torch.as_tensor(mask))
    x = rng.normal(size=zero.shape)
    jst, st = jcb.append(jst, jnp.asarray(x)), cb.append(st, torch.as_tensor(x))
    _equal(cb.buffer(st), jcb.buffer(jst), f"buffer after append {i}")
    _equal(st["count"], jst["count"], f"count after append {i}")
    for lag in (0, max_len - 1, max_len + 1):  # the newest, the oldest, clamped
      lags = np.full(batch, lag)
      _equal(cb.latest(st, torch.as_tensor(lags)), jcb.latest(jst, jnp.asarray(lags)),
             f"latest({lag}) after append {i}")
  jst, st = jcb.reset(jst), cb.reset(st)
  _equal(st["count"], jst["count"], "count after an unmasked reset")


def _handed(jdb: JaxDelay, db: DelayBuffer, key):
  """The JAX buffer's draws of one append under `key`, as the port's."""
  lags = torch.as_tensor(np.array(jdb._sample_lags(key)), dtype=torch.int32)
  hold = None
  if jdb.hold_prob > 0:
    hold = torch.as_tensor(np.array(
      jax.random.uniform(jax.random.fold_in(key, 7), (jdb.batch_size,))))
  return lambda generator, device: (lags, hold)


@pytest.mark.parametrize("kw,resets", [
  (dict(min_lag=2, max_lag=2, per_env=False), {}),  # a fixed lag delays by 2
  (dict(min_lag=1, max_lag=5, per_env=False), {}),  # one lag shared by every env
  (dict(min_lag=0, max_lag=5), {}),  # per-env lags, redrawn at every append
  (dict(min_lag=0, max_lag=10, hold_prob=1.0), {}),  # hold_prob 1 freezes the lags
  (dict(min_lag=0, max_lag=4, hold_prob=0.5), {3: [True, False, True, False, True, False]}),
  (dict(min_lag=0, max_lag=3, update_period=3), {4: [False, True] * 3}),  # per-env phase
  (dict(min_lag=1, max_lag=3, update_period=2, per_env_phase=False), {2: None}),
])
def test_delay_buffer_matches_jax(kw, resets):
  """Six envs, seven appends of random rows; a reset (masked, or of every
  env) before the appends `resets` names. Lags, phases, steps, ring and the
  delayed output agree exactly after each append."""
  B = 6
  jdb, db = JaxDelay(batch_size=B, **kw), DelayBuffer(batch_size=B, **kw)
  key = jax.random.key(5)
  zero = np.zeros((B, 2))
  jst = jdb.init_state(jnp.asarray(zero), key)
  st = db.init_state(torch.as_tensor(zero), torch.Generator().manual_seed(0))
  st["lags"] = torch.as_tensor(np.array(jst["lags"]), dtype=torch.int32)
  st["phase"] = torch.as_tensor(np.array(jst["phase"]), dtype=torch.int32)
  rng = np.random.default_rng(1)
  for i in range(7):
    if i in resets:
      mask = resets[i]
      jst = jdb.reset(jst, None if mask is None else jnp.asarray(mask))
      st = db.reset(st, None if mask is None else torch.as_tensor(mask))
    x = rng.normal(size=zero.shape)
    k = jax.random.fold_in(key, i)
    db.draws = _handed(jdb, db, k)
    jst, st = jdb.append(jst, jnp.asarray(x), k), db.append(st, torch.as_tensor(x), None)
    for f in ("lags", "phase", "steps"):
      _equal(st[f], jst[f], f"{f} after append {i}")
    _equal(st["ring"]["buffer"], jst["ring"]["buffer"], f"ring after append {i}")
    _equal(db.compute(st), jdb.compute(jst), f"output after append {i}")
  if kw.get("hold_prob") == 1.0:
    _equal(st["lags"], jdb.init_state(jnp.asarray(zero), key)["lags"], "held lags")


def test_delay_buffer_draws_from_the_generator():
  """The port's own draws: per-env lags inside [min_lag, max_lag] and
  diverse, one shared lag when per_env is off, phases inside the period;
  the same seed gives the same draws."""

  def init(seed, **kw):
    db = DelayBuffer(batch_size=64, **kw)
    return db.init_state(torch.zeros(64, 1), torch.Generator().manual_seed(seed))

  st = init(0, min_lag=1, max_lag=4, update_period=5)
  assert st["lags"].min() >= 1 and st["lags"].max() <= 4 and len(st["lags"].unique()) > 1
  assert st["phase"].min() >= 0 and st["phase"].max() < 5 and len(st["phase"].unique()) > 1
  assert len(init(0, min_lag=1, max_lag=4, per_env=False)["lags"].unique()) == 1
  assert torch.equal(init(3, min_lag=0, max_lag=9)["lags"], init(3, min_lag=0, max_lag=9)["lags"])
