"""Actor-critic networks and empirical observation normalization (port of
mjlab_tpu/rl/networks.py).

The actor and critic are MLPs of `nn.Linear` layers initialised as flax's
`nn.Dense` is (weights from `lecun_normal`: a normal truncated to ±2
standard deviations, scaled by fan-in; biases zero), with a learned
state-independent action std ("scalar": the std itself, clipped at 1e-6;
"log": its log). Parameters and normalizer statistics are float32, as in
the JAX package; a flax kernel (in, out) is a Linear weight transposed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
  "elu": F.elu,
  "relu": F.relu,
  "tanh": torch.tanh,
  # flax's nn.gelu is the tanh approximation.
  "gelu": lambda x: F.gelu(x, approximate="tanh"),
  "selu": F.selu,
  "swish": F.silu,
}

_LOG_2PI = math.log(2 * math.pi)


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
  """flax's lecun_normal for a (out, in) weight: N(0, 1) truncated to
  [-2, 2] by inverse CDF, times sqrt(1 / fan_in) / 0.8796... (the std of
  that truncated normal)."""
  std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
  lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
  u = lo + (hi - lo) * torch.rand(weight.shape, generator=generator, dtype=torch.float64)
  z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
  with torch.no_grad():
    weight.copy_(z.clamp(-2.0, 2.0) * std)


class MLP(nn.Module):
  def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
               activation: str, generator: torch.Generator):
    super().__init__()
    dims = [in_dim, *hidden_dims, out_dim]
    self.activation = activation
    self.layers = nn.ModuleList(
      nn.utils.skip_init(nn.Linear, a, b) for a, b in zip(dims, dims[1:])
    )
    for layer in self.layers:
      _lecun_normal_(layer.weight, generator)
      nn.init.zeros_(layer.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    act = _ACTIVATIONS[self.activation]
    for layer in self.layers[:-1]:
      x = act(layer(x))
    return self.layers[-1](x)


class ActorCritic(nn.Module):
  """MLP actor + MLP critic with a learned state-independent std. Built on
  the CPU from `seed` (float32), then moved where the caller wants it."""

  def __init__(
    self,
    num_actor_obs: int,
    num_critic_obs: int,
    num_actions: int,
    actor_hidden_dims: Sequence[int] = (256, 256, 128),
    critic_hidden_dims: Sequence[int] = (256, 256, 128),
    activation: str = "elu",
    init_noise_std: float = 1.0,
    noise_std_type: str = "scalar",
    seed: int = 0,
  ):
    super().__init__()
    gen = torch.Generator().manual_seed(seed)
    self.actor = MLP(num_actor_obs, actor_hidden_dims, num_actions, activation, gen)
    self.critic = MLP(num_critic_obs, critic_hidden_dims, 1, activation, gen)
    self.noise_std_type = noise_std_type
    init = torch.full((num_actions,), init_noise_std, dtype=torch.float32)
    if noise_std_type == "scalar":
      self.std = nn.Parameter(init)
    elif noise_std_type == "log":
      self.log_std = nn.Parameter(torch.log(init))
    else:
      raise ValueError(f"noise_std_type must be 'scalar' or 'log', got {noise_std_type!r}")

  def action_std(self) -> torch.Tensor:
    if self.noise_std_type == "scalar":
      return torch.clamp(self.std, min=1e-6)
    return torch.exp(self.log_std)

  def mean_noise_std(self) -> torch.Tensor:
    """Mean policy std, for logging (the JAX runner's _mean_noise_std)."""
    if self.noise_std_type == "scalar":
      return torch.mean(self.std)
    return torch.mean(torch.exp(self.log_std))

  def forward(self, actor_obs, critic_obs):
    """(mean (B, A), std (A,), value (B,))."""
    return self.actor(actor_obs), self.action_std(), self.value(critic_obs)

  def act_mean(self, actor_obs):
    return self.actor(actor_obs)

  def value(self, critic_obs):
    return self.critic(critic_obs).squeeze(-1)


def gaussian_log_prob(mean, std, action):
  """Diagonal Gaussian log-density, summed over action dims."""
  var = torch.square(std)
  lp = -0.5 * (torch.square(action - mean) / var + torch.log(2 * math.pi * var))
  return torch.sum(lp, dim=-1)


def gaussian_entropy(std):
  return torch.sum(0.5 * (1.0 + _LOG_2PI) + torch.log(std), dim=-1)


@dataclasses.dataclass(frozen=True)
class RunningNorm:
  """Empirical mean/var normalizer (rsl_rl EmpiricalNormalization
  semantics: batch-averaged running statistics, updated only in training).
  `update` returns a new normalizer, as the JAX package's does."""

  mean: torch.Tensor
  var: torch.Tensor
  count: torch.Tensor

  @classmethod
  def create(cls, dim: int, device=None) -> "RunningNorm":
    """Identity statistics (mean 0, var 1, count 0), float32."""
    f32 = dict(dtype=torch.float32, device=device)
    return cls(mean=torch.zeros(dim, **f32), var=torch.ones(dim, **f32),
               count=torch.zeros((), **f32))

  def update(self, batch: torch.Tensor) -> "RunningNorm":
    """Welford-style batched update over all leading axes."""
    x = batch.reshape(-1, batch.shape[-1])
    n = float(x.shape[0])
    new_count = self.count + n
    delta = torch.mean(x, dim=0) - self.mean
    new_mean = self.mean + delta * n / new_count
    m_a = self.var * self.count
    m_b = torch.var(x, dim=0, correction=0) * n
    m2 = m_a + m_b + torch.square(delta) * self.count * n / new_count
    return RunningNorm(mean=new_mean, var=m2 / new_count, count=new_count)

  def __call__(self, x: torch.Tensor) -> torch.Tensor:
    return (x - self.mean) / torch.sqrt(self.var + 1e-8)
