"""PPO learner (port of mjlab_tpu/rl/ppo.py).

The same semantics as the JAX package (rsl_rl's surface):

- GAE(γ, λ) with bootstrap-on-timeout (rewards += γ·V·timeout);
- clipped surrogate + (optionally clipped) value loss + entropy bonus;
- adaptive-KL learning rate, set per minibatch before the optimizer step:
  lr /= 1.5 when KL > 2·desired, lr *= 1.5 when KL < desired/2, clamped
  to [1e-5, 1e-2];
- num_learning_epochs × num_mini_batches sweeps over the flattened rollout,
  in the order of the permutations the caller hands in;
- the optimizer of `optax.chain(clip_by_global_norm, inject_hyperparams(
  adam))`, written as plain functions on tensors with optax's formulas.

Gradients come from `torch.autograd`. Nothing here synchronizes with the
host: the lr, the KL and the metrics stay 0-d device tensors, minibatches
are `index_select`s with device indices, and every branch on a device
value is a `torch.where`. The spans `ppo_update/prepare` (GAE and the
flattening) and `ppo_update/minibatch_steps` name the update's two parts in
a torch.profiler trace.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from mjlab_tpu_torch.rl.config import PpoAlgorithmCfg
from mjlab_tpu_torch.rl.networks import ActorCritic, gaussian_entropy, gaussian_log_prob

# optax.adam's defaults. inject_hyperparams stores them as float32 arrays
# and casts them to the gradients' dtype, so they act as float32 values.
ADAM_B1 = float(np.float32(0.9))
ADAM_B2 = float(np.float32(0.999))
ADAM_EPS = float(np.float32(1e-8))

METRICS = ("kl", "surrogate", "value_loss", "entropy", "loss", "lr")


@dataclasses.dataclass
class Transition:
  actor_obs: torch.Tensor  # (T, B, O)
  critic_obs: torch.Tensor  # (T, B, Oc)
  action: torch.Tensor  # (T, B, A)
  reward: torch.Tensor  # (T, B)
  done: torch.Tensor  # (T, B) terminated | truncated
  time_out: torch.Tensor  # (T, B)
  value: torch.Tensor  # (T, B)
  log_prob: torch.Tensor  # (T, B)
  mean: torch.Tensor  # (T, B, A)
  std: torch.Tensor  # (T, B, A)

  @classmethod
  def stack(cls, steps: list["Transition"]) -> "Transition":
    """(B, ...) transitions of T steps → one of (T, B, ...) buffers."""
    return cls(**{
      f.name: torch.stack([getattr(s, f.name) for s in steps])
      for f in dataclasses.fields(cls)
    })


@dataclasses.dataclass
class AdamState:
  """optax ScaleByAdamState: the step count and both moments, keyed by
  parameter name."""

  count: torch.Tensor  # () int32
  mu: dict[str, torch.Tensor]
  nu: dict[str, torch.Tensor]


def adam_init(ac: ActorCritic) -> AdamState:
  params = dict(ac.named_parameters())
  return AdamState(
    count=torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device),
    mu={k: torch.zeros_like(p) for k, p in params.items()},
    nu={k: torch.zeros_like(p) for k, p in params.items()},
  )


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
  """optax.clip_by_global_norm: scale by max_norm / norm only when
  norm ≥ max_norm."""
  g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
  keep = g_norm < max_norm
  return [torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm) for g in grads]


def adam_step(ac: ActorCritic, grads: list[torch.Tensor], state: AdamState,
              lr: torch.Tensor) -> AdamState:
  """optax.adam (eps outside the square root, eps_root 0) with the learning
  rate `lr`, applied to `ac`'s parameters in place."""
  count = torch.where(state.count < torch.iinfo(torch.int32).max,
                      state.count + 1, state.count)
  c = count.to(grads[0].dtype)
  bias1, bias2 = 1 - ADAM_B1 ** c, 1 - ADAM_B2 ** c
  step = -lr.to(grads[0].dtype)
  mu, nu = {}, {}
  with torch.no_grad():
    for (name, p), g in zip(ac.named_parameters(), grads):
      mu[name] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[name]
      nu[name] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[name]
      p.add_((mu[name] / bias1 / (torch.sqrt(nu[name] / bias2) + ADAM_EPS)) * step)
  return AdamState(count=count, mu=mu, nu=nu)


def compute_gae(t: Transition, last_value: torch.Tensor, gamma: float, lam: float):
  """Returns (advantages, returns), both (T, B).

  Timeout bootstrap: rsl_rl adds γ·V(s) to rewards where the episode was
  truncated rather than terminated, so value targets see the tail."""
  rewards = t.reward + gamma * t.value * t.time_out
  not_done = 1.0 - t.done.to(rewards.dtype)
  next_values = torch.cat([t.value[1:], last_value[None]], dim=0)
  adv = torch.zeros_like(last_value)
  advantages = [None] * t.reward.shape[0]
  for i in reversed(range(t.reward.shape[0])):
    delta = rewards[i] + gamma * next_values[i] * not_done[i] - t.value[i]
    adv = delta + gamma * lam * not_done[i] * adv
    advantages[i] = adv
  advantages = torch.stack(advantages)
  return advantages, advantages + t.value


def prepare_update(cfg: PpoAlgorithmCfg, batch: Transition, last_value: torch.Tensor):
  """GAE + advantage normalization + (T·B)-flattening."""
  advantages, returns = compute_gae(batch, last_value, cfg.gamma, cfg.lam)
  if not cfg.normalize_advantage_per_mini_batch:
    advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
  T, B = batch.reward.shape
  flat = Transition(**{
    f.name: getattr(batch, f.name).reshape((T * B,) + getattr(batch, f.name).shape[2:])
    for f in dataclasses.fields(Transition)
  })
  return flat, advantages.reshape(-1), returns.reshape(-1)


def make_minibatch_step(cfg: PpoAlgorithmCfg, ac: ActorCritic):
  """The single-minibatch SGD step
  (opt_state, lr, flat, adv_flat, ret_flat, idx) → (opt_state, lr, metrics),
  which updates `ac`'s parameters in place."""

  def loss_fn(mb):
    mean, std, value = ac(mb["actor_obs"], mb["critic_obs"])
    log_prob = gaussian_log_prob(mean, std, mb["action"])
    ratio = torch.exp(log_prob - mb["old_log_prob"])

    adv = mb["adv"]
    if cfg.normalize_advantage_per_mini_batch:
      adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

    surr1 = -adv * ratio
    surr2 = -adv * torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
    surrogate_loss = torch.mean(torch.maximum(surr1, surr2))

    if cfg.use_clipped_value_loss:
      value_clipped = mb["old_value"] + torch.clamp(
        value - mb["old_value"], -cfg.clip_param, cfg.clip_param
      )
      v_loss = torch.maximum(
        torch.square(value - mb["ret"]), torch.square(value_clipped - mb["ret"])
      ).mean()
    else:
      v_loss = torch.square(value - mb["ret"]).mean()

    entropy = torch.mean(gaussian_entropy(std))
    total = surrogate_loss + cfg.value_loss_coef * v_loss - cfg.entropy_coef * entropy

    # KL(old ‖ new) for the adaptive-lr schedule (rsl_rl form).
    old_std, old_mean = mb["old_std"], mb["old_mean"]
    kl = torch.sum(
      torch.log(std / old_std + 1e-5)
      + (torch.square(old_std) + torch.square(old_mean - mean)) / (2.0 * torch.square(std))
      - 0.5,
      dim=-1,
    )
    aux = {
      "kl": torch.mean(kl),
      "surrogate": surrogate_loss,
      "value_loss": v_loss,
      "entropy": entropy,
    }
    return total, aux

  def minibatch_step(opt_state, lr, flat, adv_flat, ret_flat, idx):
    take = lambda x: torch.index_select(x, 0, idx)
    mb = {
      "actor_obs": take(flat.actor_obs),
      "critic_obs": take(flat.critic_obs),
      "action": take(flat.action),
      "old_log_prob": take(flat.log_prob),
      "old_value": take(flat.value),
      "old_mean": take(flat.mean),
      "old_std": take(flat.std),
      "adv": take(adv_flat),
      "ret": take(ret_flat),
    }
    loss, aux = loss_fn(mb)
    grads = torch.autograd.grad(loss, list(ac.parameters()))
    aux = {k: v.detach() for k, v in aux.items()}

    # Adaptive-KL lr (applied before the optimizer step, per minibatch).
    if cfg.schedule == "adaptive" and cfg.desired_kl is not None:
      lr = torch.where(aux["kl"] > cfg.desired_kl * 2.0, lr / 1.5, lr)
      lr = torch.where(aux["kl"] < cfg.desired_kl / 2.0, lr * 1.5, lr)
      lr = torch.clamp(lr, 1e-5, 1e-2)
    grads = clip_by_global_norm(list(grads), cfg.max_grad_norm)
    opt_state = adam_step(ac, grads, opt_state, lr)
    return opt_state, lr, {**aux, "loss": loss.detach(), "lr": lr}

  return minibatch_step


def ppo_update(
  cfg: PpoAlgorithmCfg,
  ac: ActorCritic,
  opt_state: AdamState,
  lr: torch.Tensor,
  batch: Transition,
  last_value: torch.Tensor,
  perms: torch.Tensor,
):
  """One PPO update over a rollout batch. `perms` (epochs, T·B) holds each
  epoch's permutation of the flattened rollout; minibatch k of an epoch
  takes entries [k·mb, (k+1)·mb). Updates `ac` in place and returns
  (opt_state, lr, metrics averaged over every minibatch)."""
  with record_function("ppo_update/prepare"):
    flat, adv_flat, ret_flat = prepare_update(cfg, batch, last_value)
  n = adv_flat.shape[0]
  mb_size = n // cfg.num_mini_batches
  if tuple(perms.shape) != (cfg.num_learning_epochs, n):
    raise ValueError(f"perms must be ({cfg.num_learning_epochs}, {n}), got {tuple(perms.shape)}")
  step = make_minibatch_step(cfg, ac)
  history = []
  with record_function("ppo_update/minibatch_steps"):
    for e in range(cfg.num_learning_epochs):
      for k in range(cfg.num_mini_batches):
        idx = perms[e, k * mb_size:(k + 1) * mb_size]
        opt_state, lr, metrics = step(opt_state, lr, flat, adv_flat, ret_flat, idx)
        history.append(metrics)
  means = {k: torch.mean(torch.stack([m[k] for m in history])) for k in METRICS}
  return opt_state, lr, means
