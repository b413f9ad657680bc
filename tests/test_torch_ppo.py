"""The PPO learner of the PyTorch port (mjlab_tpu_torch.rl) against the JAX
package's (mjlab_tpu.rl), float64 on the CPU, on synthetic batches at the
G1 task's real widths: policy obs 99, critic obs 111, 29 actions, hidden
512/256/128; T = 6 steps of B = 8 envs. No env is built.

The JAX learner keeps its params, Adam state and normalizers in float32
even under x64; as the runner tests do, both sides carry them in float64
here. The optimizer's state is made from float32 params, as the JAX runner
makes it, so its injected Adam constants are float32 values on both sides.
Tolerance: 1e-10 relative to max(1, max |JAX|)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu.rl import networks as jnet
from mjlab_tpu.rl import ppo as jppo
from mjlab_tpu.rl.config import PpoAlgorithmCfg as JaxAlgorithmCfg
from mjlab_tpu_torch.rl import networks as tnet
from mjlab_tpu_torch.rl import ppo as tppo
from mjlab_tpu_torch.rl.config import PpoAlgorithmCfg
from mjlab_tpu_torch.rl.runner import flax_layout, flax_path

OBS, COBS, ACT = 99, 111, 29
HIDDEN = (512, 256, 128)
T, B = 6, 8
TOL = 1e-10


def jax_ac(std_type: str):
  return jnet.ActorCritic(num_actions=ACT, actor_hidden_dims=HIDDEN,
                          critic_hidden_dims=HIDDEN, noise_std_type=std_type)


def jax_params(std_type: str, seed: int = 0):
  """flax's init (float32), with a std that differs by action dim."""
  p = jax_ac(std_type).init(jax.random.key(seed), jnp.zeros((1, OBS), jnp.float32),
                            jnp.zeros((1, COBS), jnp.float32))
  std = np.random.default_rng(seed).uniform(0.5, 1.2, ACT).astype(np.float32)
  name = "std" if std_type == "scalar" else "log_std"
  value = std if std_type == "scalar" else np.log(std)
  return {"params": {**p["params"], name: jnp.asarray(value)}}


def port_ac(jp, std_type: str) -> tnet.ActorCritic:
  """The port's ActorCritic holding the JAX params (by the runner's names)."""
  flat: dict = {}
  tp._flatten("params", jp["params"], flat)
  ac = tnet.ActorCritic(OBS, COBS, ACT, HIDDEN, HIDDEN, noise_std_type=std_type)
  with torch.no_grad():
    for name, p in ac.named_parameters():
      p.data = flax_layout(name, torch.as_tensor(flat[f"params/{flax_path(name)}"])).contiguous()
  return ac


def port_arrays(ac, opt_state: tppo.AdamState) -> dict[str, np.ndarray]:
  out = {}
  for name, p in ac.named_parameters():
    path = flax_path(name)
    out[f"params/{path}"] = flax_layout(name, p).detach().numpy()
    out[f"opt/mu/{path}"] = flax_layout(name, opt_state.mu[name]).numpy()
    out[f"opt/nu/{path}"] = flax_layout(name, opt_state.nu[name]).numpy()
  out["opt/count"] = opt_state.count.numpy()
  return out


def optimizers(cfg_kw: dict, jp32, std_type: str, seed: int):
  """Both optimizer states in the middle of training: count 3 and the same
  random moments, made from the float32 params and carried in float64."""
  optimizer = jppo.make_optimizer(JaxAlgorithmCfg(**cfg_kw))
  opt = tp.f64_tree(optimizer.init(jp32))
  rng = np.random.default_rng(seed)
  adam = tp.jax_adam_state(opt)
  mu = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.normal(0, 1e-2, x.shape)), adam.mu)
  nu = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.uniform(1e-6, 1e-3, x.shape)), adam.nu)
  adam = adam._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu)
  inject = opt[1]._replace(inner_state=(adam,) + tuple(opt[1].inner_state[1:]))
  opt = (opt[0], inject)
  ac = port_ac(tp.f64_tree(jp32), std_type)
  arr = tp.jax_learner_arrays(tp.f64_tree(jp32), opt)
  names = dict(ac.named_parameters())
  tstate = tppo.AdamState(
    count=torch.tensor(3, dtype=torch.int32),
    mu={n: flax_layout(n, torch.as_tensor(arr[f"opt/mu/{flax_path(n)}"])).contiguous()
        for n in names},
    nu={n: flax_layout(n, torch.as_tensor(arr[f"opt/nu/{flax_path(n)}"])).contiguous()
        for n in names},
  )
  return optimizer, opt, ac, tstate


def synthetic_batch(jp, std_type: str, seed: int, kl_scale: float):
  """A rollout batch whose stored policy quantities come from a policy
  `kl_scale` away from the current one (so that ratio clipping, value
  clipping and the adaptive lr's branches are reached), with dones and
  timeouts. Returns (numpy fields, last_value)."""
  rng = np.random.default_rng(seed)
  a_obs = rng.normal(0, 1, (T, B, OBS))
  c_obs = rng.normal(0, 1, (T, B, COBS))
  mean, std, value = jax_ac(std_type).apply(jp, jnp.asarray(a_obs), jnp.asarray(c_obs))
  mean, std, value = np.asarray(mean), np.asarray(std), np.asarray(value)
  old_mean = mean + kl_scale * rng.normal(0, 1, mean.shape)
  old_std = np.broadcast_to(std * (1 + kl_scale * rng.uniform(-1, 1, ACT)), mean.shape)
  action = old_mean + old_std * rng.normal(0, 1, mean.shape)
  var = old_std**2
  log_prob = np.sum(-0.5 * ((action - old_mean) ** 2 / var + np.log(2 * np.pi * var)), -1)
  done = rng.uniform(size=(T, B)) < 0.25
  fields = dict(
    actor_obs=a_obs, critic_obs=c_obs, action=action,
    reward=rng.normal(0.1, 0.5, (T, B)), done=done,
    time_out=(done & (rng.uniform(size=(T, B)) < 0.5)).astype(np.float64),
    value=value + 0.5 * rng.normal(0, 1, value.shape), log_prob=log_prob,
    mean=old_mean, std=np.ascontiguousarray(old_std),
  )
  return fields, rng.normal(0, 1, B)


def jax_batch(fields):
  return jppo.Transition(**{k: jnp.asarray(v) for k, v in fields.items()})


def port_batch(fields):
  return tppo.Transition(**{k: torch.as_tensor(np.asarray(v)) for k, v in fields.items()})


def jax_perms(rng, n: int, epochs: int):
  """The JAX ppo_update's permutations: one split of the train rng per
  epoch (ppo.py:208-209)."""
  out = []
  for _ in range(epochs):
    rng, key = jax.random.split(rng)
    out.append(np.asarray(jax.random.permutation(key, n)))
  return np.stack(out)


@pytest.mark.parametrize("std_type", ["scalar", "log"])
def test_actor_critic_forward(std_type):
  jp = tp.f64_tree(jax_params(std_type))
  ac = port_ac(jp, std_type)
  rng = np.random.default_rng(1)
  a_obs, c_obs = rng.normal(0, 1, (B, OBS)), rng.normal(0, 1, (B, COBS))
  jm, js, jv = jax_ac(std_type).apply(jp, jnp.asarray(a_obs), jnp.asarray(c_obs))
  with torch.no_grad():
    tm, ts, tv = ac(torch.as_tensor(a_obs), torch.as_tensor(c_obs))
    tmean = ac.act_mean(torch.as_tensor(a_obs))
  tp.assert_close(tm.numpy(), jm, TOL, "mean")
  tp.assert_close(ts.numpy(), js, TOL, "std")
  tp.assert_close(tv.numpy(), jv, TOL, "value")
  tp.assert_close(tmean.numpy(), jm, TOL, "act_mean")


def test_actor_critic_init_is_flax_lecun_normal():
  """Weights are lecun-normal draws (truncated at 2 std), biases zero, and
  the std is init_noise_std: the distribution flax's init draws from."""
  ac = tnet.ActorCritic(OBS, COBS, ACT, HIDDEN, HIDDEN, init_noise_std=0.7, seed=3)
  for name, p in ac.named_parameters():
    if name.endswith(".bias"):
      assert torch.count_nonzero(p) == 0, name
    elif name.endswith(".weight"):
      sigma = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
      assert p.abs().max() <= 2 * sigma * (1 + 1e-6), name
      if p.numel() > 10_000:
        assert abs(p.std().item() / (1.0 / p.shape[1]) ** 0.5 - 1) < 0.03, name
    else:
      np.testing.assert_array_equal(p.detach().numpy(), np.full(ACT, 0.7, np.float32))
      assert p.dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm(max_norm):
  """optax's form: scaled by max_norm / norm only when norm ≥ max_norm (the
  gradients' norm here is about 9)."""
  import optax

  rng = np.random.default_rng(12)
  grads = {"a": rng.normal(0, 1, (20, 3)), "b": rng.normal(0, 1, 21)}
  want, _ = optax.clip_by_global_norm(max_norm).update(
    {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
  got = tppo.clip_by_global_norm([torch.as_tensor(grads[k]) for k in ("a", "b")], max_norm)
  for k, g in zip(("a", "b"), got):
    tp.assert_close(g.numpy(), want[k], TOL, k)
  assert np.array_equal(got[0].numpy(), grads["a"]) == (max_norm > 9.5)


def test_log_prob_and_entropy():
  rng = np.random.default_rng(2)
  mean, action = rng.normal(0, 1, (B, ACT)), rng.normal(0, 1, (B, ACT))
  std = rng.uniform(0.2, 1.5, ACT)
  tp.assert_close(
    tnet.gaussian_log_prob(*map(torch.as_tensor, (mean, std, action))).numpy(),
    jnet.gaussian_log_prob(*map(jnp.asarray, (mean, std, action))), TOL, "log_prob",
  )
  tp.assert_close(tnet.gaussian_entropy(torch.as_tensor(std)).numpy(),
                  jnet.gaussian_entropy(jnp.asarray(std)), TOL, "entropy")


def test_running_norm_update_and_apply():
  rng = np.random.default_rng(3)
  stats = dict(mean=rng.normal(0, 1, OBS), var=rng.uniform(0.1, 3, OBS), count=np.float64(50.0))
  jn = jnet.RunningNorm(**{k: jnp.asarray(v) for k, v in stats.items()})
  tn = tnet.RunningNorm(**{k: torch.as_tensor(v) for k, v in stats.items()})
  batch = rng.normal(0.5, 2.0, (T, B, OBS))
  jn, tn = jn.update(jnp.asarray(batch)), tn.update(torch.as_tensor(batch))
  for f in ("mean", "var", "count"):
    tp.assert_close(getattr(tn, f).numpy(), getattr(jn, f), TOL, f)
  x = rng.normal(0, 1, (B, OBS))
  tp.assert_close(tn(torch.as_tensor(x)).numpy(), jn(jnp.asarray(x)), TOL, "apply")


def test_compute_gae_with_dones_and_timeouts():
  fields, last_value = synthetic_batch(tp.f64_tree(jax_params("scalar")), "scalar", 4, 0.1)
  assert fields["done"].any() and fields["time_out"].any()
  assert (fields["done"] & (fields["time_out"] == 0)).any()
  ja, jr = jppo.compute_gae(jax_batch(fields), jnp.asarray(last_value), 0.99, 0.95)
  ta, tr = tppo.compute_gae(port_batch(fields), torch.as_tensor(last_value), 0.99, 0.95)
  tp.assert_close(ta.numpy(), ja, TOL, "advantages")
  tp.assert_close(tr.numpy(), jr, TOL, "returns")


@pytest.mark.parametrize("per_mini_batch", [False, True])
def test_prepare_update(per_mini_batch):
  fields, last_value = synthetic_batch(tp.f64_tree(jax_params("scalar")), "scalar", 5, 0.1)
  kw = dict(normalize_advantage_per_mini_batch=per_mini_batch)
  jflat, jadv, jret = jppo.prepare_update(JaxAlgorithmCfg(**kw), jax_batch(fields),
                                          jnp.asarray(last_value))
  tflat, tadv, tret = tppo.prepare_update(PpoAlgorithmCfg(**kw), port_batch(fields),
                                          torch.as_tensor(last_value))
  tp.assert_close(tadv.numpy(), jadv, TOL, "advantages")
  tp.assert_close(tret.numpy(), jret, TOL, "returns")
  for f in dataclasses.fields(tppo.Transition):
    np.testing.assert_array_equal(getattr(tflat, f.name).numpy(),
                                  np.asarray(getattr(jflat, f.name)))


# (grad clipping active, clipped value loss, schedule, KL scale, per-minibatch
# advantage normalization). KL scale 0.1 puts the KL above 2·desired, 0.003
# below desired/2.
MINIBATCH_CASES = {
  "clip-valueclip-adaptive-highkl": (True, True, "adaptive", 0.1, False),
  "noclip-valueclip-adaptive-lowkl": (False, True, "adaptive", 0.003, False),
  "clip-novalueclip-fixed-highkl": (True, False, "fixed", 0.1, False),
  "noclip-novalueclip-adaptive-highkl-permb": (False, False, "adaptive", 0.1, True),
  "clip-valueclip-fixed-lowkl-permb": (True, True, "fixed", 0.003, True),
}


@pytest.mark.parametrize("case", list(MINIBATCH_CASES))
def test_minibatch_step(case):
  clip, value_clip, schedule, kl_scale, per_mb = MINIBATCH_CASES[case]
  std_type = "log" if per_mb else "scalar"
  kw = dict(max_grad_norm=1e-3 if clip else 1e3, use_clipped_value_loss=value_clip,
            schedule=schedule, normalize_advantage_per_mini_batch=per_mb)
  jp32 = jax_params(std_type, seed=6)
  optimizer, jopt, ac, topt = optimizers(kw, jp32, std_type, seed=6)
  jp = tp.f64_tree(jp32)
  fields, last_value = synthetic_batch(jp, std_type, 7, kl_scale)
  idx = np.random.default_rng(8).permutation(T * B)[:16]
  lr = 2e-3

  jflat, jadv, jret = jppo.prepare_update(JaxAlgorithmCfg(**kw), jax_batch(fields),
                                          jnp.asarray(last_value))
  jstep = jax.jit(jppo.make_minibatch_step(
    JaxAlgorithmCfg(**kw), lambda p, a, c: jax_ac(std_type).apply(p, a, c), optimizer))
  jp_new, jopt, jlr, jmet = jstep(jp, jopt, jnp.asarray(lr, jnp.float64), jflat, jadv, jret,
                                  jnp.asarray(idx))

  tcfg = PpoAlgorithmCfg(**kw)
  tflat, tadv, tret = tppo.prepare_update(tcfg, port_batch(fields), torch.as_tensor(last_value))
  topt, tlr, tmet = tppo.make_minibatch_step(tcfg, ac)(
    topt, torch.tensor(lr, dtype=torch.float64), tflat, tadv, tret, torch.as_tensor(idx))

  kl = float(jmet["kl"])
  assert (kl > 0.02) if kl_scale > 0.01 else (kl < 0.005), kl
  if clip:  # the bound changed the step: the gradient's norm exceeds it
    _, _, ac_free, topt_free = optimizers({**kw, "max_grad_norm": 1e3}, jp32, std_type, seed=6)
    tppo.make_minibatch_step(PpoAlgorithmCfg(**{**kw, "max_grad_norm": 1e3}), ac_free)(
      topt_free, torch.tensor(lr, dtype=torch.float64), tflat, tadv, tret, torch.as_tensor(idx))
    assert not torch.equal(ac_free.actor.layers[0].weight, ac.actor.layers[0].weight)
  for k, v in jmet.items():
    tp.assert_close(tmet[k].numpy(), v, TOL, k)
  tp.assert_close(tlr.numpy(), jlr, TOL, "lr")
  got, want = port_arrays(ac, topt), tp.jax_learner_arrays(jp_new, jopt)
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    tp.assert_close(got[k], v, TOL, k)


def test_ppo_update_with_jax_permutations():
  kw = dict(num_learning_epochs=2, num_mini_batches=3)
  jp32 = jax_params("scalar", seed=9)
  optimizer, jopt, ac, topt = optimizers(kw, jp32, "scalar", seed=9)
  fields, last_value = synthetic_batch(tp.f64_tree(jp32), "scalar", 10, 0.05)
  rng = jax.random.key(11)
  train = jppo.PpoTrainState(params=tp.f64_tree(jp32), opt_state=jopt,
                             lr=jnp.asarray(1e-3, jnp.float64), rng=rng)
  jtrain, jmet = jax.jit(
    lambda tr, b, lv: jppo.ppo_update(
      JaxAlgorithmCfg(**kw), lambda p, a, c: jax_ac("scalar").apply(p, a, c), optimizer,
      tr, b, lv,
    )
  )(train, jax_batch(fields), jnp.asarray(last_value))
  perms = jax_perms(rng, T * B, 2)
  topt, tlr, tmet = tppo.ppo_update(
    PpoAlgorithmCfg(**kw), ac, topt, torch.tensor(1e-3, dtype=torch.float64),
    port_batch(fields), torch.as_tensor(last_value), torch.as_tensor(perms),
  )
  assert sorted(tmet) == sorted(jmet)
  for k, v in jmet.items():
    tp.assert_close(tmet[k].numpy(), v, TOL, k)
  tp.assert_close(tlr.numpy(), jtrain.lr, TOL, "lr")
  got, want = port_arrays(ac, topt), tp.jax_learner_arrays(jtrain.params, jtrain.opt_state)
  for k, v in want.items():
    tp.assert_close(got[k], v, TOL, k)
  assert int(topt.count) == 3 + 2 * 3
