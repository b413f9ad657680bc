"""Env-sharded data parallelism of the port (mjlab_tpu_torch/distributed/) on
the CPU: the multihost helpers under torch.distributed.run's variables (the
JAX package's tests/test_distributed.py::test_multihost_helpers, on
torch.distributed's names); `--mesh` and its refusals; and a run of the
CartPole tutorial's task (docs/CREATE_NEW_TASK_TORCH.md) on 2 gloo ranks x
4 envs (`python -m torch.distributed.run`), float64, which after 2 PPO
iterations of 4 env steps (its episodes 5 steps long, so that envs reset)
equals one process with 8 envs within 1e-12: parameters, Adam state,
normalizers and every env's state, the learner equal on both ranks bit for
bit, and only rank 0 writing its log dir. The same launch sums the motion
tracker's failure bins over the ranks (`failure_bin_counts`), and logs a
ratio of sums over the envs (feet_air_time's Metrics/air_time_mean) as the
unsharded run does (`ratio_metrics`)."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parity as tp
from mjlab_tpu_torch import tasks
from mjlab_tpu_torch.distributed import multihost
from mjlab_tpu_torch.scripts.train import mesh_shards

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-12
NUM_ENVS = 8
CLI = {
  "env.scene.num_envs": str(NUM_ENVS),
  "env.episode_length_s": "0.1",
  "env.sim.dtype": "float64",
  "agent.num_steps_per_env": "4",
  "agent.max_iterations": "2",
  "agent.algorithm.num_learning_epochs": "2",
  "agent.algorithm.num_mini_batches": "2",
  "agent.device": "cpu",
}
BINS, FAILED_ENVS = 10, 16

# One rank of the launch (or, without torch.distributed.run's variables, the
# single process): train CartPole through scripts.train.run_train, then dump
# the learner, the env's state and the tracker's bin counts of its rows.
WORKER = r'''
import os, re, sys
from types import SimpleNamespace
import numpy as np, torch
torch.set_num_threads(1)
from pathlib import Path
text = (Path(sys.argv[1]) / "docs" / "CREATE_NEW_TASK_TORCH.md").read_text()
ns = {}
for block in re.findall(r"```python\n(.*?)```", text, flags=re.DOTALL):
  if "OnPolicyRunner(env" not in block:
    exec(block, ns)
from mjlab_tpu_torch.envs.manager_based_env import env_state_to_arrays
from mjlab_tpu_torch.rl.runner import ratio_metrics, runner_state_to_arrays
from mjlab_tpu_torch.scripts.train import run_train
from mjlab_tpu_torch.tasks.tracking.mdp.commands import failure_bin_counts
from mjlab_tpu_torch.tasks.velocity.mdp.rewards import feet_air_time
out, rank = Path(sys.argv[2]), os.environ.get("RANK", "single")
overrides = dict(arg.split("=", 1) for arg in sys.argv[4:])
runner = run_train("Mjlab-Cartpole", {**overrides, "log_dir": str(out / f"log_{rank}")})
rng = np.random.default_rng(3)
bins, failed = rng.integers(0, {bins}, {n}), rng.random({n}) < 0.4
sharded = runner.env.shard is not None
r = int(os.environ["RANK"]) if sharded else 0
rows = slice(r * {n} // 2, (r + 1) * {n} // 2) if sharded else slice(0, {n})
counts = failure_bin_counts(torch.as_tensor(bins[rows]), torch.as_tensor(failed[rows]), {bins},
                            torch.float64, sharded)
# 3 steps of feet_air_time over the rank's rows of 16 envs x 2 feet, logged
# as the runner logs them: the steps' ratios averaged, or ratio_metrics'.
air = rng.random((3, {n}, 2)) * (rng.random((3, {n}, 2)) < 0.5)
logs = []
for t in range(3):
  env = SimpleNamespace(dtype=torch.float64, shard=runner.env.shard, step_log={}, scene={
    "feet": SimpleNamespace(data=SimpleNamespace(current_air_time=torch.as_tensor(air[t, rows])))})
  feet_air_time(env, "feet")
  logs.append(env.step_log)
key = "Metrics/air_time_mean"
air_time = ratio_metrics(logs).get(key, torch.mean(torch.stack([log[key] for log in logs])))
air_time_single = np.mean([a.sum() / max((a > 0).sum(), 1) for a in air])
np.savez(out / f"state_{rank}.npz", **env_state_to_arrays(runner.env),
         **{f"learner/{k}": v for k, v in runner_state_to_arrays(runner).items()},
         bin_counts=counts.numpy(), air_time=air_time.numpy(),
         air_time_single=air_time_single,
         bin_counts_single=np.bincount(bins[failed], minlength={bins}).astype(np.float64))
'''.replace("{bins}", str(BINS)).replace("{n}", str(FAILED_ENVS))


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _run(tmp_path, ranks: int) -> subprocess.CompletedProcess:
  script = tmp_path / "worker.py"
  script.write_text(WORKER)
  launch = ["-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
            "--master_addr", "127.0.0.1", "--master_port", str(_free_port())]
  env = {k: v for k, v in os.environ.items()
         if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
  env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
  out = subprocess.run(
    [sys.executable, *launch, str(script), str(ROOT), str(tmp_path), "--",
     *[f"{k}={v}" for k, v in CLI.items()]],
    cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
  )
  assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
  return out


def _run_here(tmp_path) -> None:
  """The worker's single process, run in this one (without
  torch.distributed.run's variables; it saves an interpreter's start)."""
  argv, threads = sys.argv, torch.get_num_threads()
  had = tp.CARTPOLE_ID in tasks._REGISTRY
  sys.argv = ["worker", str(ROOT), str(tmp_path), "--", *[f"{k}={v}" for k, v in CLI.items()]]
  try:
    exec(compile(WORKER, "worker", "exec"), {})
  finally:
    sys.argv = argv
    torch.set_num_threads(threads)
    if not had:
      tasks._REGISTRY.pop(tp.CARTPOLE_ID, None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """The 2-rank launch and the single process, each in a directory of its
  own: (its stdout, {rank: its dumped arrays}, the directory)."""
  sharded_dir = tmp_path_factory.mktemp("sharded")
  single_dir = tmp_path_factory.mktemp("single")
  sharded = _run(sharded_dir, 2)
  _run_here(single_dir)
  load = lambda p: dict(np.load(p))  # noqa: E731
  return (
    (sharded.stdout, {r: load(sharded_dir / f"state_{r}.npz") for r in (0, 1)}, sharded_dir),
    (None, {"single": load(single_dir / "state_single.npz")}, single_dir),
  )


def test_multihost_helpers(monkeypatch):
  """No torch.distributed.run variables: a no-op (False), rank 0 of 1,
  the primary, offset 0. A configuration that names a rank but fails
  raises, never degrading to one process; an incomplete one raises; a
  process already in a group answers True."""
  for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
    monkeypatch.delenv(var, raising=False)
  assert not dist.is_initialized()
  assert multihost.initialize_multihost() is False
  assert multihost.process_index() == 0
  assert multihost.process_count() == 1
  assert multihost.is_primary_host() is True
  assert multihost.global_env_offset(512) == 0

  calls = {}

  def fake_init(backend, init_method=None, world_size=None, rank=None):
    calls["args"] = (backend, init_method, world_size, rank)
    raise RuntimeError("connection failed")

  monkeypatch.setattr(dist, "init_process_group", fake_init)
  for var, value in (("RANK", "2"), ("WORLD_SIZE", "4"), ("MASTER_ADDR", "10.0.0.1")):
    monkeypatch.setenv(var, value)
  with pytest.raises(ValueError, match="MASTER_PORT"):
    multihost.initialize_multihost(device="cpu")
  monkeypatch.setenv("MASTER_PORT", "1234")
  with pytest.raises(RuntimeError, match="connection failed"):
    multihost.initialize_multihost(device="cpu")
  assert calls["args"] == ("gloo", "env://", 4, 2)

  monkeypatch.setattr(dist, "is_initialized", lambda: True)
  assert multihost.initialize_multihost() is True


def test_backend_and_device_per_local_rank(monkeypatch):
  """NCCL where each local rank has a card, gloo where ranks share one (as
  two ranks on one H100 do) or run on the CPU; a rank's card is
  LOCAL_RANK, round robin over the cards."""
  monkeypatch.setenv("WORLD_SIZE", "2")
  monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  for cards, backend in ((2, "nccl"), (1, "gloo")):
    monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
    assert multihost._choose_backend("cuda") == backend
  assert multihost._choose_backend("cpu") == "gloo"
  monkeypatch.setenv("LOCAL_RANK", "1")
  assert multihost.local_device("cuda") == torch.device("cuda", 0)
  assert multihost.local_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("mesh, num_envs, world, want", [
  (None, 8, 1, 1), ("auto", 8, 2, 2), ("2", 8, 2, 2), ("off", 8, 1, None),
  ("off", 8, 2, "--mesh off under 2 ranks"), ("4", 8, 2, "does not match the world size 2"),
  ("auto", 9, 2, "not divisible by --mesh 2"),
])
def test_mesh_and_its_refusals(mesh, num_envs, world, want):
  """`--mesh` auto is the world size, off is unsharded and refused under
  more than one rank, a number must equal the world size; the shards must
  divide the envs (the JAX runner's ValueError)."""
  if isinstance(want, str):
    with pytest.raises(ValueError, match=want):
      mesh_shards(mesh, num_envs, world)
  else:
    assert mesh_shards(mesh, num_envs, world) == want


def test_two_ranks_equal_one_process(runs):
  (out, ranks, _), (_, single, _) = runs
  one = single["single"]
  assert "backend gloo" in out and f"{NUM_ENVS} envs over 2 ranks" in out, out
  learner = [k for k in one if k.startswith("learner/")]
  assert any("opt/mu/" in k for k in learner) and any("actor_norm/" in k for k in learner)
  for k in learner:
    np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    tp.assert_close(ranks[0][k], one[k], TOL, k)
  per_env = 0
  for k, want in one.items():
    if k.startswith(("learner/", "bin_counts", "air_time")):
      continue
    if want.ndim and want.shape[0] == NUM_ENVS:
      got, per_env = np.concatenate([ranks[0][k], ranks[1][k]]), per_env + 1
    else:
      got = ranks[0][k]
      np.testing.assert_array_equal(ranks[1][k], got, err_msg=k)
    if want.dtype.kind in "biu":
      np.testing.assert_array_equal(got, want, err_msg=k)
    else:
      tp.assert_close(got, want, TOL, k)
  assert per_env > 20, per_env
  # Episodes of at most 5 steps in 8: every env was reset.
  assert (one["episode_length"] < 8).all(), one["episode_length"]


def test_only_rank_zero_writes_the_log_dir(runs):
  (out, _, sharded_dir), (_, _, single_dir) = runs
  assert not (sharded_dir / "log_1").exists()
  assert "rank 0: saved" in out and "rank 1: saved" not in out, out
  digests = {line.split("rank ")[1][0]: line.split("sha256 ")[1]
             for line in out.splitlines() if "learner sha256" in line}
  assert len(digests) == 2 and digests["0"] == digests["1"], digests
  files = sorted(os.listdir(sharded_dir / "log_0"))
  assert files == sorted(os.listdir(single_dir / "log_single")), files
  assert {"model_0.pt", "model_2.pt", "metrics.jsonl", "final_metrics.json"} <= set(files)
  rows = [json.loads(line) for line in (sharded_dir / "log_0" / "metrics.jsonl").open()]
  want = [json.loads(line) for line in (single_dir / "log_single" / "metrics.jsonl").open()]
  assert [r["iteration"] for r in rows] == [r["iteration"] for r in want]
  for got, ref in zip(rows, want):
    for k in ("Loss/loss", "Train/resets", "Train/mean_episode_length",
              "Train/mean_step_reward"):
      np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)


def test_failure_bins_are_summed_over_ranks(runs):
  """Each rank counts the failures of its half of 16 seeded envs; summed
  over the ranks the counts are the unsharded count of all 16."""
  (_, ranks, _), _ = runs
  for r in (0, 1):
    np.testing.assert_array_equal(ranks[r]["bin_counts"], ranks[r]["bin_counts_single"])
  assert ranks[0]["bin_counts"].sum() > 0


def test_ratio_metrics_are_sums_over_ranks(runs):
  """Each rank logs feet_air_time's Metrics/air_time_mean over its half of
  16 seeded envs; the runner's value on each rank, and in the single
  process over all 16, is the unsharded ratio of sums, not a mean of the
  ranks' ratios."""
  (_, ranks, _), (_, single, _) = runs
  for arrays in (ranks[0], ranks[1], single["single"]):
    tp.assert_close(arrays["air_time"], arrays["air_time_single"], TOL, "air_time_mean")
  halves = [ranks[0]["air_time"], ranks[1]["air_time"]]
  np.testing.assert_array_equal(halves[0], halves[1])
