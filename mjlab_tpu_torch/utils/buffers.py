"""Ring and delay buffers for observation history and sensor latency (port of
mjlab_tpu/utils/buffers.py).

State is a dict of tensors that the observation manager keeps in the env's
"observation" namespace, named as the JAX package's:

- `CircularBuffer`: a batched ring buffer. The first append after a reset
  fills every slot with that value (backfill).
- `DelayBuffer`: a per-env (or shared) integer lag in [min_lag, max_lag]
  over a ring of max_lag + 1 slots, redrawn on every append, or every
  `update_period` appends with a per-env phase; `hold_prob` keeps an env's
  lag with that probability instead.

Every draw comes from the torch.Generator the caller passes; `draws` makes
one append's draws, so that a test can hand another stream's across.
"""

from __future__ import annotations

import torch


class CircularBuffer:
  """A max_len ring buffer over (B, ...) features; `buffer` is oldest first."""

  def __init__(self, max_len: int, batch_size: int):
    assert max_len > 0
    self.max_len = max_len
    self.batch_size = batch_size

  def init_state(self, example: torch.Tensor) -> dict:
    buf = example.new_zeros((self.batch_size, self.max_len) + tuple(example.shape[1:]))
    count = torch.zeros(self.batch_size, dtype=torch.int32, device=example.device)
    return {"buffer": buf, "count": count}

  def append(self, state: dict, x: torch.Tensor) -> dict:
    buf, count = state["buffer"], state["count"]
    b = torch.arange(self.batch_size, device=buf.device)
    updated = buf.clone()
    updated[b, (count % self.max_len).long()] = x
    fresh = (count == 0).reshape((-1,) + (1,) * (buf.dim() - 1))
    return {
      "buffer": torch.where(fresh, x[:, None].expand(buf.shape), updated),
      "count": count + 1,
    }

  def buffer(self, state: dict) -> torch.Tensor:
    """The ordered view (B, L, ...), oldest to newest."""
    buf, count = state["buffer"], state["count"]
    idx = (count[:, None].long() + torch.arange(self.max_len, device=buf.device)) % self.max_len
    idx = idx.reshape(idx.shape + (1,) * (buf.dim() - 2)).expand(buf.shape)
    return torch.gather(buf, 1, idx)

  def latest(self, state: dict, lag: torch.Tensor) -> torch.Tensor:
    """The value `lag` appends back, clamped to the history there is."""
    buf, count = state["buffer"], state["count"]
    lag = torch.minimum(lag, torch.clamp_min(count - 1, 0))
    pos = ((count - 1 - lag) % self.max_len).long()
    return buf[torch.arange(self.batch_size, device=buf.device), pos]

  def reset(self, state: dict, env_mask=None) -> dict:
    count = state["count"]
    if env_mask is None:
      return {"buffer": state["buffer"], "count": torch.zeros_like(count)}
    return {"buffer": state["buffer"], "count": torch.where(env_mask, 0, count)}


class DelayBuffer:
  """A stochastic integer-lag delay line over a CircularBuffer."""

  def __init__(
    self,
    min_lag: int,
    max_lag: int,
    batch_size: int,
    per_env: bool = True,
    hold_prob: float = 0.0,
    update_period: int = 0,
    per_env_phase: bool = True,
  ):
    assert 0 <= min_lag <= max_lag
    self.min_lag = min_lag
    self.max_lag = max_lag
    self.batch_size = batch_size
    self.per_env = per_env
    self.hold_prob = hold_prob
    self.update_period = update_period
    self.per_env_phase = per_env_phase
    self.ring = CircularBuffer(max_lag + 1, batch_size)

  def _sample_lags(self, generator: torch.Generator, device) -> torch.Tensor:
    n = self.batch_size if self.per_env else 1
    lags = torch.randint(self.min_lag, self.max_lag + 1, (n,), generator=generator,
                         device=device, dtype=torch.int32)
    return lags.expand(self.batch_size).clone() if n == 1 else lags

  def init_state(self, example: torch.Tensor, generator: torch.Generator) -> dict:
    device = example.device
    lags = self._sample_lags(generator, device)
    if self.update_period > 0 and self.per_env_phase:
      phase = torch.randint(0, self.update_period, (self.batch_size,), generator=generator,
                            device=device, dtype=torch.int32)
    else:
      phase = torch.zeros(self.batch_size, dtype=torch.int32, device=device)
    return {
      "ring": self.ring.init_state(example),
      "lags": lags,
      "phase": phase,
      "steps": torch.zeros(self.batch_size, dtype=torch.int32, device=device),
    }

  def draws(self, generator: torch.Generator, device) -> tuple:
    """One append's draws: fresh lags (B,) and, with hold_prob, the hold
    uniforms (B,) (else None)."""
    lags = self._sample_lags(generator, device)
    hold = None
    if self.hold_prob > 0:
      hold = torch.rand(self.batch_size, generator=generator, device=device)
    return lags, hold

  def append(self, state: dict, x: torch.Tensor, generator: torch.Generator) -> dict:
    ring = self.ring.append(state["ring"], x)
    steps = state["steps"] + 1
    lags = state["lags"]
    new_lags, hold = self.draws(generator, x.device)
    if hold is not None:
      new_lags = torch.where(hold < self.hold_prob, lags, new_lags)
    if self.update_period > 0:
      due = (steps + state["phase"]) % self.update_period == 0
      lags = torch.where(due, new_lags, lags)
    else:
      lags = new_lags
    return {"ring": ring, "lags": lags, "phase": state["phase"], "steps": steps}

  def compute(self, state: dict) -> torch.Tensor:
    return self.ring.latest(state["ring"], state["lags"])

  def reset(self, state: dict, env_mask=None) -> dict:
    out = dict(state)
    out["ring"] = self.ring.reset(state["ring"], env_mask)
    if env_mask is None:
      out["steps"] = torch.zeros_like(state["steps"])
    else:
      out["steps"] = torch.where(env_mask, 0, state["steps"])
    return out
