#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (mjlab_tpu_torch) runs on the GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package and needs no network.
Phases, each printing its own lines:
  1. build every CUDA kernel from csrc/ (nvcc, in parallel) into build/kernels;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (float32): the Cholesky entry points on random SPD matrices
     (4096 × 35 × 35), the Newton direction on random qM, dense weights and
     J (4096 × 1699 × 35, 0.97 GB); time kernel, plain version and the
     PyTorch call (or, for the Newton direction, the torch path it
     replaces) over distinct batches that exceed L2, and the kernel on one
     L2-resident batch (the Cholesky entry points only: one Newton input,
     J alone, is 0.97 GB, 20 times the L2); print the Newton kernel's
     launch (warps per block, resident worlds per SM, shared bytes per
     warp, registers and local bytes per thread, ptxas' lines for it);
  3. drive the main path — `Simulation.step_fn()` on the G1 velocity-flat
     scene at 4096 worlds, 30 env steps (cut from 50) of 4 substeps, ctrl = keyframe
     targets + a seeded small action — with the kernels' launch counters
     set to 0 just before and read just after; check the state is finite,
     plausible and in contact and that every substep made 12
     factorizations, 10 of them Newton directions; then hold the kernels
     against their plain versions on that run's mass matrices, Newton
     matrices and (qM, J, w) at its qacc, and time the Newton direction
     there, with its launch at these shapes (f32, and f64 for phase 4);
  4. check the card's float64 kernel path against the CPU's plain path on a
     small input (4 worlds, 4 substeps);
  5. time each stage of one substep with CUDA events, and the solve split
     into its Newton directions, its linesearches and the rest;
  6. profile one more env step (device time by kernel, each kernel's time
     per launch on the main path, the device's busy share of phase 3's
     steady wall time) and fail if the batched JᵀWJ product still runs;
  7. the env path — `tasks.make_env("Mjlab-Velocity-Flat-Unitree-G1")` at
     4096 envs (float32, from the committed scene), `reset(seed=0)`, then 40
     (cut from 60) `env.step`s of N(0, 1) actions with 0.4 s episodes (20 env steps, so
     that every env resets in-step at least twice), all under
     `torch.cuda.set_sync_debug_mode("error")`; the kernels' counters set
     to 0 just before the steps and read just after: 59 factorizations and
     5 `chol_solve` per env step (4 substeps and the post-reset forward).
     Checks observation shapes, finite values, resets, the per-env foot
     friction; times the steady env step; prints the env state's weighted
     Newton rows and contacts and phase 5's stage times on it; splits one
     env step by part with CUDA events, profiles one; then holds the card's
     float64 env (kernels)
     against the CPU's (plain versions) on a variant whose draws are all
     certain, 4 envs x 8 env steps;
  8. the training path — `scripts.train.build_runner(TASK,
     {"env.scene.num_envs": "4096"})`, the real G1 PPO cfg (MLPs 512/256/128,
     empirical normalization, 24 steps per env, 5 epochs x 4 minibatches of
     24576, adaptive-KL lr) and the task's real 20 s episodes; 2
     `train_iteration`s (3 until PR 7) under `set_sync_debug_mode("error")` with the
     kernels' counters set to 0 just before and read just after: 1416
     factorizations and 120 `chol_solve` per iteration. Checks the rollout
     buffers' shapes, finite losses, the lr inside [1e-5, 1e-2] and that the
     params moved; times each iteration with CUDA events (training
     env-steps/s) and one iteration's three calls (draws, rollout, update);
     profiles one rollout step and one update (an iteration's launches and
     busy share are 24 of the one and one of the other), and splits each
     by the runner's profiler spans (policy act and env step; GAE and prep,
     and the minibatch steps); reads the peak memory; saves, reloads into a
     fresh 4-env runner and checks equal state; exports the TorchScript
     policy and holds it against `get_inference_policy`; then holds the
     card's float64 iteration (kernels) against the CPU's (plain versions)
     on the certain-draw variant, 4 envs, T = 4, 1 epoch x 2 minibatches,
     from one warm learner (Adam's moments and the normalizers' statistics
     drawn from the seed) and the same draws on both, for each of the
     seed 3 (cut from 3, 4 and 5; another list with `--f64-seeds 3,4,...`);
  9. the tracking path — a seeded synthetic motion CSV (10 s at 30 fps)
     converted on the card by `scripts.csv_to_npz` (500 frames at 50 fps,
     11 adaptive bins), then `build_runner("Mjlab-Tracking-Flat-Unitree-G1",
     {"env.scene.num_envs": "4096", "motion_file": ...})` with the G1
     tracking PPO cfg; checks the observation widths (160, 286) and the
     per-env body_ipos, qpos0 and foot friction (each different across envs,
     inside its range, on its elements only); then phase 8's 2 iterations,
     checks, split and profiles (device-only: no split by span, cut to keep
     the script inside its limit) on it, plus the motion frames inside
     [0, 500) and a failure counted in the adaptive bins; holds the kernels
     against their plain versions on the tracking run's matrices; and the
     card's float64 iteration against the CPU's on the tracking task's
     certain-draw variant, as phase 8 does;
 10. a run's lifecycle on G1 velocity-flat at 4096 envs in
     build/chip_smoke/run, through the entry points: `run_train` for 2
     iterations with a save after each (the files, the labels, ms per save,
     the metric pulls and `learn`'s ms per iteration against phase 8's
     steady iteration), `run_train --agent.resume true` for 1 iteration
     that neither logs nor saves, run under set_sync_debug_mode("error")
     (the checkpoint loaded, the learner equal to it before its update, the
     label it went on from), `run_play --policy trained` on the final
     checkpoint for 6 steps (cut from 24; ms per step, mean reward; the card's actions
     against the exported TorchScript policy on the CPU, 1e-5 relative; the
     kernels against their plain versions on the play env's matrices), the
     NaN guard on that env (ms per watch, a dump of exactly the 2 poisoned
     envs and the model), `run_joint_deltas` for 3 steps (cut from 10) and
     `export_policy_as_onnx`; the kernels' counters set to 0 before the
     phase and read after it, less the comparisons' launches.
 11. the Asimov family on flat ground: for Mjlab-Velocity-Flat-Asimov (foot
     meshes as convex hulls, frame sensors; nv 18, 44 Newton rows) and
     Mjlab-Velocity-Flat-Asimov-Toe (fixed tendons driven by the
     parallel-ankle action; nv 20, 174 rows), `build_runner` at 4096 envs
     with the task's PPO cfg; the observation widths; the feet's hulls built
     on this host against the CPU host's digest; 1 iteration of 8 env steps
     (2 of 24, with a device-only profile and the stage times, before the
     cuts of PRs 9 and 11: the robots train on rough terrain in phase 13)
     under set_sync_debug_mode("error") with
     its counts, checks and split; the four kernels against their plain
     versions on each run's matrices, and their times there; the card's
     float64 env against the CPU's, 4 envs x 2 env steps (cut from 3),
     each from the CPU env's state and held to 1e-8 or twice the CPU's own spread under 6
     qpos nudges of 1e-13, for Asimov-Toe with the ankle targets checked in
     ctrl on the 4 tendon actuators only.
 12. G1 on rough terrain and Go1 on flat ground, 1 iteration of 8 env
     steps each (cut from G1 rough's 2 of 24 with a device-only profile of a
     rollout step and an update and the stage times), each as a task of
     phase 11:
     Mjlab-Velocity-Rough-Unitree-G1 (3564 terrain boxes pooled behind the
     cell-hash broadphase, 667 contact slots, nv 35, 2235 Newton rows; the
     pool and the 10 x 20 tile grid checked after the build; the
     iterations' dropped terrain contacts and mean terrain level) and
     Mjlab-Velocity-Flat-Unitree-Go1 (the trunk box on the plane; nv 18,
     240 rows); then a headless `run_play` of the rough task, 6 steps (cut from 24) of
     the random policy at 4096 envs, which must load the committed play
     scene (3 x 3 tiles), with the kernels' counters set to 0 just before
     and read just after.
 13. Go1, Asimov and Asimov-Toe on rough terrain, 1 iteration of 8 env
     steps each (cut from 2 of 24 with a profile and the stage times), each
     as G1 rough in phase
     12: Mjlab-Velocity-Rough-Unitree-Go1 (the trunk box against the 3564
     pooled boxes through the plain hull SAT; 180 slots, nv 18, 732 rows),
     -Rough-Asimov (the feet's hulls through the SAT, checked against the
     CPU host's digest; 12 slots, 60 rows) and -Rough-Asimov-Toe (capsules
     only, their terrain contacts taken from above; nv 20, 494 rows); each
     iteration's dropped terrain contacts and mean level; the SAT's
     launches and device time per `collision` call on each run's last
     state, for the box and the mesh group; then a headless `run_play` of
     Go1 rough, 6 steps (cut from 24) of the random policy at 4096 envs
     on its committed play scene.
 14. the solver surface: (a) G1 velocity-flat under
     `--env.sim.mujoco.cone elliptic` (nefc 1320: 29 limit rows, 154
     condim-1 rows, 379 cone slots of 3 rows) through `build_runner` at
     4096 envs, 1 iteration (cut from 2) with phase 8's checks, a
     device-only profile, every Newton direction through
     `newton_direction_cone` (1200 launches per iteration, none of
     `newton_direction`), the kernel against its
     plain version on the run's last matrices in f32 (KernelCheck's rule)
     and f64 (1e-10 relative), its times beside its bound, the plain
     version and the library path (einsum + cholesky_ex + cholesky_solve),
     the cone slots by zone and the active ones per world, the kernel's
     launch (f32 and f64), and the card's float64 env against the CPU's
     as phases 11-13 (2 env steps, cut from 3; 2 nudges); (b) G1 under
     `--env.sim.mujoco.solver cg`, 10 env
     steps at 4096 envs under set_sync_debug_mode("error"), ms per env step,
     the Cholesky launches per env step against the code's count, and the
     float64 env check (2 env steps, 2 nudges); (c) each scene of
     mjlab_tpu_torch/assets/solver_scenes.py (equality connect/weld on
     bodies and sites, joint, tendon; friction loss; a limited tendon; CG;
     condim 4 and 6 under both cones; the elliptic puck; Euler; RK4) for 30
     (cut from 50) float64 substeps at 4096 worlds, ms per substep, its first 16 worlds
     against the CPU (1e-8, or twice the CPU's spread under 2 nudges).
 15. the user surface: the G1 velocity-flat cfg as a user edits it for
     sim-to-real training (`sim_to_real_edit`: startup randomization of the
     torso's mass (add +-5 kg, Isaac Lab's `add_base_mass`), every body's
     inertia, the armature (log-uniform), the passive damping and the PD
     actuators' gains, beside the task's foot friction; pushes as an
     external force and torque on the torso every 1-3 s; the policy group
     with a flattened 3-step history, joint_vel delayed 0-2 steps per env,
     joint_pos with a per-env bias of +-0.02 drawn at each reset; actions
     clipped to (-10, 10); init_velocity_prob 0.1; the feet sensor by
     maxforce with torque and dist, and a world-frame sensor of every
     field), registered with `tasks.register` and trained through
     `build_runner` at 4096 envs with the G1 PPO cfg: 2 iterations with
     phase 8's checks (every env's push clock started so that it is pushed
     in the second), policy obs 297 wide, each randomized leaf different
     across envs, inside its range and on its elements only, the launches
     equal to phase 8's, the iteration against phase 8's in this call, a
     device-only profile; the kernels against their plain versions on the
     run's per-env matrices (qM, the Newton matrix and direction, the
     implicitfast matrix); and the card's float64 env against the CPU's
     with all 19 FIELD_SPECS rows randomized (each env different, the
     CPU's leaves handed to the card), 4 envs x 8 env steps, 1e-8 or twice
     the CPU's spread under 2 nudges.
Any failed check raises. The line before the last is the kernel table as
JSON (`launches` from the env path of phase 7, `launches_training_path`
from phase 8's 2 iterations, `launches_tracking_path` from phase 9's,
`launches_lifecycle_path` from phase 10, `launches_asimov_path` from phase
11's iteration of each task, `launches_rough_go1_path` from phase 12's
and its play, `launches_rough_path` from phase 13's and its play,
`ms_asimov_run_matrices_by_nv`, `ms_rough_go1_run_matrices_by_nv` and
`ms_rough_run_matrices_by_nv` each kernel's time on phase 11's, 12's and
13's matrices by nv (phase 13's by task and nv), `launches_elliptic_path`,
`launches_cg_path` and `launches_scenes_path` phase 14's,
`launches_surface_path` phase 15's; the fifth entry,
`newton_direction_cone`, has phase 14's elliptic run's launches and its
times on that run's matrices); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

NUM_WORLDS = 4096
ENV_STEPS = 30  # cut from 50 to keep the script inside its limit
DECIMATION = 4
N = 35  # G1 nv
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
HBM_SETS = 6  # distinct timing batches, 6 x 20 MB > the H100's 50 MB L2
NEFC = 1699  # G1's constraint rows
J_SETS = 3  # distinct Newton inputs, 3 x 0.97 GB
KERNELS = ("chol_factor", "chol_solve", "chol_factor_solve", "newton_direction")
# The elliptic cone's Newton kernel (phase 14); the pyramidal paths launch
# KERNELS only.
CONE_KERNEL = "newton_direction_cone"
ALL_KERNELS = KERNELS + (CONE_KERNEL,)
OUT = Path("chiprun_out")
TASK = "Mjlab-Velocity-Flat-Unitree-G1"
RL_EPISODE_S = 0.4  # cut from 20 s: 20 env steps, every env resets in-step
RL_STEPS = 40  # cut from 60: still 2 episodes of 20 env steps per env
RL_STEADY_FROM = 10
RL_SOLVES_PER_STEP = 5


def fact_per_env_step(newton_iters: int = 10) -> int:
  """Factorizations per env step: 4 substeps of factor_m, the Newton
  directions and the integrator's factor-solve, and the post-reset
  forward's factor_m and Newton directions (59 at 10 Newton iterations)."""
  return DECIMATION * (newton_iters + 2) + newton_iters + 1


RL_FACT_PER_STEP = fact_per_env_step()
TRAIN_ITERS = 2  # 3 until PR 7; 2 keeps the script with phase 11 inside its limit
# Phases 11-13's tasks run one iteration (phases 12-13's cut from 2 with a
# profile and the stage times), so that the script stays inside its limit
# with phase 14.
CUT_ITERS = 1
TRAIN_STEPS = 24  # the G1 PPO cfg's num_steps_per_env
# Env steps per iteration of the cut tasks of phases 11-13 (cut from their
# cfgs' 24), and the card-vs-CPU env steps of their checks and of phase
# 14's G1 ones (cut from 3): cuts that keep the script under 1000 s.
CUT_STEPS = 8
CUT_F64_STEPS = 2
# The runner's torch.profiler spans: a rollout step's two, then the update's.
TRAIN_SPANS = ("rollout_step/act", "rollout_step/env_step",
               "ppo_update/prepare", "ppo_update/minibatch_steps")
F64_SEEDS = (3,)  # draws of the card-vs-CPU float64 training iteration (cut from 3, 4, 5)
TRACK_TASK = "Mjlab-Tracking-Flat-Unitree-G1"
TRACK_CSV_ROWS = 301  # 10 s of motion at 30 fps
TRACK_FRAMES = 500  # the same 10 s at 50 fps
TRACK_BINS = 11  # adaptive-sampling bins: 500 frames // 50 steps per s + 1
# Steps of the earlier paths' play (phases 10, 12, 13) and of joint_deltas
# (phase 10), cut from 24 and 10.
EARLY_PLAY_STEPS = 6
JOINT_DELTA_STEPS = 3


# The Asimov feet's convex hulls as put_model builds them from the committed
# scene with scipy's qhull, hashed (`hull_digest`) on the CPU host where the
# JAX package's hulls are held equal to them (tests/test_torch_asimov_model.py).
# Phase 11 rebuilds them on the card's host and fails on another digest.
ASIMOV_HULL_DIGEST = "a3c43b16dedf640866f11394fa382334e00c95c986122268f60baa66830a7b87"


# Phase 11's tasks and their (policy, critic) observation widths, the JAX
# package's (tests/test_torch_asimov_env.py).
ASIMOV_OBS_DIMS = {"Mjlab-Velocity-Flat-Asimov": (48, 60),
                   "Mjlab-Velocity-Flat-Asimov-Toe": (45, 57)}


# Phase 12's tasks and their (policy, critic) observation widths, the JAX
# package's (tests/test_torch_terrain_env.py, tests/test_torch_go1_env.py).
ROUGH_TASK = "Mjlab-Velocity-Rough-Unitree-G1"
ROUGH_GO1_OBS_DIMS = {ROUGH_TASK: (99, 111), "Mjlab-Velocity-Flat-Unitree-Go1": (48, 72)}


# Phase 13's tasks and their (policy, critic) observation widths, the JAX
# package's (tests/test_torch_rough_env.py; Asimov-Toe's are its flat
# variant's, tests/test_torch_asimov_toe_env.py).
ROUGH13_OBS_DIMS = {"Mjlab-Velocity-Rough-Unitree-Go1": (48, 72),
                    "Mjlab-Velocity-Rough-Asimov": (48, 60),
                    "Mjlab-Velocity-Rough-Asimov-Toe": (45, 57)}


def hull_digest(tp) -> str:
  """sha256 of every hull of a Topology (geom order; verts, faces, face
  normals, edge directions)."""
  import dataclasses
  import hashlib

  import numpy as np

  h = hashlib.sha256()
  for g in sorted(tp.geom_hulls):
    for f in dataclasses.fields(tp.geom_hulls[g]):
      h.update(np.ascontiguousarray(getattr(tp.geom_hulls[g], f.name)).tobytes())
  return h.hexdigest()


class PhaseClock:
  """Prints each phase's wall time and the time since the script began."""

  def __init__(self):
    self.start = self.last = time.perf_counter()

  def done(self, phase: int) -> None:
    now = time.perf_counter()
    print(f"phase {phase} done in {now - self.last:.1f} s, {now - self.start:.1f} s since the "
          "start")
    self.last = now


def card_line() -> str:
  out = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60, check=True,
  )
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, inputs: list, iters: int = 20, warmup: int = 3) -> float:
  """Mean ms of fn(*inputs[i % len(inputs)]) over `iters` calls. With one
  input set it stays in L2 after the first call; with several whose total
  exceeds L2 every call reads from HBM."""
  for i in range(warmup):
    fn(*inputs[i % len(inputs)])
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for i in range(iters):
    fn(*inputs[i % len(inputs)])
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def spd_batch(gen, batch: int, n: int, dtype):
  X = torch.randn(batch, n, n, generator=gen, device="cuda", dtype=torch.float64)
  A = X @ X.transpose(-1, -2) / n + 0.1 * torch.eye(n, device="cuda", dtype=torch.float64)
  return A.to(dtype).contiguous()


class KernelCheck:
  """Kernel-vs-plain comparisons. Tolerance: the kernel may differ from the
  plain version by at most max(1e-5 · max|plain|, 4 × the plain float32
  version's own error against the plain float64 version) — i.e. it must be
  as accurate as the plain version, up to a factor of 4. NaN patterns must
  agree exactly."""

  def __init__(self):
    self.max_abs_err: dict[str, float] = {}

  def check(self, name: str, what: str, got, plain, plain64) -> None:
    nan_k, nan_p = torch.isnan(got), torch.isnan(plain)
    if not torch.equal(nan_k, nan_p):
      raise AssertionError(f"{name} on {what}: NaN pattern differs from plain")
    ok = ~nan_p
    err = (got - plain)[ok].abs().max().item() if ok.any() else 0.0
    ref_err = (plain.double() - plain64)[ok].abs().max().item() if ok.any() else 0.0
    scale = plain[ok].abs().max().item() if ok.any() else 0.0
    tol = max(1e-5 * scale, 4.0 * ref_err)
    print(f"  {name:18s} {what:14s} max_abs_err={err:.3e} tol={tol:.3e} "
          f"(plain f32 vs f64 {ref_err:.3e}, scale {scale:.3e}, "
          f"nan matrices {int(nan_p.flatten(1).any(1).sum())})")
    if not err <= tol:
      raise AssertionError(f"{name} on {what}: {err:.3e} > tol {tol:.3e}")
    self.max_abs_err[name] = max(self.max_abs_err.get(name, 0.0), err)

  def newton(self, what: str, qM, J, w, grad) -> None:
    from mjlab_tpu_torch.kernels import chol

    x64 = chol.newton_direction_plain(qM.double(), J.double(), w.double(), grad.double())
    self.check("newton_direction", what, chol.newton_direction(qM, J, w, grad),
               chol.newton_direction_plain(qM, J, w, grad), x64)
    torch.cuda.synchronize()

  def all_three(self, what: str, A, b) -> None:
    from mjlab_tpu_torch.kernels import chol

    A64, b64 = A.double(), b.double()
    Lp = chol.chol_factor_plain(A)
    L64 = chol.chol_factor_plain(A64)
    self.check("chol_factor", what, chol.chol_factor(A), Lp, L64)
    x64 = chol.chol_solve_plain(L64, b64)
    self.check("chol_solve", what, chol.chol_solve(Lp, b),
               chol.chol_solve_plain(Lp, b), chol.chol_solve_plain(Lp.double(), b64))
    self.check("chol_factor_solve", what, chol.chol_factor_solve(A, b),
               chol.chol_factor_solve_plain(A, b), x64)
    torch.cuda.synchronize()


def bounds(batch: int, n: int, rows: float, elem: int = 4,
           nefc: int = NEFC) -> dict[str, tuple[float, str]]:
  """Least time (ms) per kernel at these shapes: the larger of bytes moved
  (each input read once, each output written once) over HBM rate and FLOP
  over the float32 rate. A factor or a solve needs only the lower triangle
  of A or L (n(n+1)/2 elements); L is written whole, zeros included. The
  Newton direction needs w (`nefc` per world, G1's NEFC by default), qM's
  lower triangle, grad, x and the `rows` rows of J (in all worlds) whose
  weight is not 0: all 4096 × nefc of them for dense weights. It does 2 FLOP per row and lower
  entry of H, then the factor and solves."""
  tri, full, vec = (batch * k * elem for k in (n * (n + 1) // 2, n * n, n))
  fac_flop, sol_flop = batch * n**3 / 3, batch * 2 * n * n
  work = {
    "chol_factor": (tri + full, fac_flop),
    "chol_solve": (tri + 2 * vec, sol_flop),
    "chol_factor_solve": (tri + 2 * vec, fac_flop + sol_flop),
    "newton_direction": (
      rows * n * elem + batch * nefc * elem + tri + 2 * vec,
      rows * n * (n + 1) + fac_flop + sol_flop,
    ),
  }
  out = {}
  for k, (byt, flop) in work.items():
    tb, tf = byt / PEAK_BYTES * 1e3, flop / PEAK_F32 * 1e3
    out[k] = (max(tb, tf), "bytes" if tb >= tf else "operations")
  return out


def stage_times(tp, m, d, reps: int = 3) -> dict[str, float]:
  """Mean ms of each stage of one physics substep, in the order of
  physics.forward.step, each fed the previous stage's output."""
  from mjlab_tpu_torch.physics import (
    collision, constraint, kinematics, sensors, smooth, solver,
  )
  from mjlab_tpu_torch.physics.forward import integrate

  stages = [
    ("kinematics", kinematics.kinematics), ("com_pos", smooth.com_pos),
    ("crb", smooth.crb), ("factor_m", smooth.factor_m),
    ("collision", collision.collision), ("com_vel", smooth.com_vel),
    ("make_constraint", constraint.make_constraint), ("rne", smooth.rne),
    ("passive", smooth.passive), ("sensor_vel", sensors.sensor_vel),
    ("fwd_actuation", smooth.fwd_actuation),
    ("fwd_acceleration", smooth.fwd_acceleration), ("solve", solver.solve),
    ("sensor_acc", sensors.sensor_acc), ("integrate", integrate),
  ]
  marks = []
  for _ in range(reps):
    x = d
    for name, fn in stages:
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      x = fn(tp, m, x)
      end.record()
      marks.append((name, start, end))
  torch.cuda.synchronize()
  out = {name: 0.0 for name, _ in stages}
  for name, start, end in marks:
    out[name] += start.elapsed_time(end) / reps
  return out


def solve_split(m, d, reps: int = 3) -> dict[str, float]:
  """Mean ms of solver.solve's parts on one substep's data, run as
  solver.solve runs them: the Newton directions (H and its factor and
  solves), the linesearches (with the step's acceptance test), and the
  rest (warm start, residuals, gradients, the final forces)."""
  from mjlab_tpu_torch.physics import solver

  marks = []

  def timed(part, fn, *args):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    marks.append((part, start, end))
    return out

  for _ in range(reps):
    a0 = d.qacc_smooth
    x = timed("rest", solver._warm_start, d, a0)
    for _ in range(m.opt.iterations):
      r, grad = timed("rest", solver._gradient, d, a0, x)
      p = timed("H + direction", solver._direction, d, r, grad)
      x = timed("linesearch", solver._linesearch, m, d, a0, x, r, p)
    timed("rest", solver._forces, d, x)
  torch.cuda.synchronize()
  out = {"H + direction": 0.0, "linesearch": 0.0, "rest": 0.0}
  for part, start, end in marks:
    out[part] += start.elapsed_time(end) / reps
  return out


def certain_variant(cfg) -> None:
  """The G1 task with every draw certain (zero-width command, reset, push,
  friction and clock ranges; no standing envs; all heading envs; no
  observation noise; 0.3 s episodes), so that two generators give the same
  rollout. tests/test_torch_env_certain.py holds it against the JAX env."""
  twist = cfg.commands["twist"]
  twist.ranges.lin_vel_x = (0.5, 0.5)
  twist.ranges.lin_vel_y = (0.1, 0.1)
  twist.ranges.ang_vel_z = (0.2, 0.2)
  twist.ranges.heading = (0.3, 0.3)
  twist.rel_standing_envs = 0.0
  twist.rel_heading_envs = 1.0
  twist.resampling_time_range = (0.5, 0.5)
  cfg.curriculum["command_vel"].params["velocity_stages"] = [
    {"step": 0, "lin_vel_x": (0.5, 0.5), "ang_vel_z": (0.2, 0.2)},
  ]
  cfg.events["reset_base"].params["pose_range"] = {"x": (0.1, 0.1), "yaw": (0.5, 0.5)}
  push = cfg.events["push_robot"]
  push.interval_range_s = (0.4, 0.4)
  push.params["velocity_range"] = {"x": (0.3, 0.3), "y": (-0.2, -0.2)}
  cfg.events["foot_friction"].params["ranges"] = (0.7, 0.7)
  cfg.observations["policy"].enable_corruption = False
  cfg.episode_length_s = 0.3


SURFACE_TASK = "Chip-Smoke-Sim-To-Real-Unitree-G1"
SURFACE_HISTORY = 3
# Each startup event of the sim-to-real cfg: field, ranges, operation, the
# robot's selection and extra randomize_field params.
SURFACE_DR = {
  # Isaac Lab's velocity env `add_base_mass`: mass_distribution_params
  # (-5, 5), operation "add", on the torso.
  "base_mass": ("body_mass", (-5.0, 5.0), "add", {"body_names": ("torso_link",)}, {}),
  "body_inertia": ("body_inertia", (0.8, 1.2), "scale", {}, {}),
  "dof_armature": ("dof_armature", (0.5, 2.0), "scale", {},
                   {"distribution": "log_uniform"}),
  # G1's compiled dof_damping is 0 (its damping is the actuators' kv, in
  # actuator_biasprm), so a scale would leave it 0: add passive damping.
  "dof_damping": ("dof_damping", (0.0, 0.3), "add", {}, {}),
  "actuator_gain": ("actuator_gainprm", (0.8, 1.2), "scale", {}, {"axes": [0]}),
  "actuator_bias": ("actuator_biasprm", (0.8, 1.2), "scale", {}, {"axes": [1, 2]}),
}


def port_cfg_modules() -> SimpleNamespace:
  """The port's cfg classes and terms that `sim_to_real_edit` builds with."""
  from mjlab_tpu_torch import sensors
  from mjlab_tpu_torch.envs import mdp
  from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg
  from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
  from mjlab_tpu_torch.utils import noise

  return SimpleNamespace(mdp=mdp, EventTermCfg=EventTermCfg, SceneEntityCfg=SceneEntityCfg,
                         noise=noise, sensors=sensors)


def sim_to_real_edit(cfg, mods: SimpleNamespace | None = None) -> None:
  """The env-layer surface a user sets for sim-to-real training, on a G1
  velocity cfg: per-env startup randomization of SURFACE_DR (beside the
  task's foot friction), pushes as an external wrench on the torso every
  1-3 s, a flattened 3-step history of the policy group, joint_vel delayed
  0-2 steps per env, joint_pos with an additive bias of +-0.02 drawn at
  each reset, actions clipped to (-10, 10), init_velocity_prob 0.1, the
  feet sensor reducing by maxforce with torque and dist, and one more
  sensor of every field in the world frame. The critic group gets its own
  copies of the shared term cfgs first: the managers write into them
  (ROADMAP Queue C). `mods` holds the cfg classes and terms to build with,
  as `port_cfg_modules` gives them (the default); the parity tests hand in
  another package's of the same names."""
  import dataclasses

  m = mods or port_cfg_modules()
  mdp, EventTermCfg, SceneEntityCfg = m.mdp, m.EventTermCfg, m.SceneEntityCfg
  noise, sensors = m.noise, m.sensors
  for name, (field, ranges, op, select, extra) in SURFACE_DR.items():
    cfg.events[name] = EventTermCfg(
      mode="startup", func=mdp.randomize_field, domain_randomization=True,
      params={"field": field, "ranges": ranges, "operation": op,
              "asset_cfg": SceneEntityCfg("robot", **select), **extra},
    )
  cfg.events["push_wrench"] = EventTermCfg(
    mode="interval", func=mdp.apply_external_force_torque, interval_range_s=(1.0, 3.0),
    params={"force_range": (-50.0, 50.0), "torque_range": (-5.0, 5.0),
            "asset_cfg": SceneEntityCfg("robot", body_names=("torso_link",))},
  )
  critic = cfg.observations["critic"]
  critic.terms = {k: dataclasses.replace(t) for k, t in critic.terms.items()}
  policy = cfg.observations["policy"]
  policy.history_length = SURFACE_HISTORY
  policy.flatten_history_dim = True
  joint_vel = policy.terms["joint_vel"]
  joint_vel.delay_min_lag, joint_vel.delay_max_lag = 0, 2
  joint_pos = policy.terms["joint_pos"]
  joint_pos.noise = noise.NoiseModelWithAdditiveBiasCfg(
    noise_cfg=joint_pos.noise,
    bias_noise_cfg=noise.UniformNoiseCfg(n_min=-0.02, n_max=0.02),
  )
  cfg.actions["joint_pos"].clip = (-10.0, 10.0)
  cfg.commands["twist"].init_velocity_prob = 0.1
  feet = next(c for c in cfg.scene.sensors if c.name == "feet_ground_contact")
  feet.reduce = "maxforce"
  feet.fields = ("found", "force", "torque", "dist")
  cfg.scene.sensors = tuple(cfg.scene.sensors) + (sensors.ContactSensorCfg(
    name="feet_ground_world",
    primary=dataclasses.replace(feet.primary),
    secondary=sensors.ContactMatch(mode="body", pattern="/terrain"),
    fields=("found", "force", "torque", "dist", "pos", "normal", "tangent"),
    reduce="maxforce",
    global_frame=True,
  ),)


def certain_surface_variant(cfg) -> None:
  """`certain_variant` of the sim-to-real cfg, its per-step draws certain
  too: each policy noise a zero-width uniform, the joint_pos bias drawn at
  a reset as well, the joint_vel lags held, every resampled command
  started at its velocity (init_velocity_prob 1), the push a fixed wrench
  every 0.04 s. The startup draws stay random: a check carries them.
  tests/test_torch_env_surface.py holds it against the JAX env."""
  certain_variant(cfg)
  policy = cfg.observations["policy"]
  policy.enable_corruption = True
  for i, term in enumerate(policy.terms.values()):
    noise = getattr(term.noise, "noise_cfg", term.noise)
    if noise is not None:
      noise.n_min = noise.n_max = 0.01 * (1 + i)
  bias = policy.terms["joint_pos"].noise.bias_noise_cfg
  bias.n_min = bias.n_max = 0.015
  policy.terms["joint_vel"].delay_hold_prob = 1.0
  cfg.commands["twist"].init_velocity_prob = 1.0
  push = cfg.events["push_wrench"]
  push.interval_range_s = (0.04, 0.04)
  push.params["force_range"] = (30.0, 30.0)
  push.params["torque_range"] = (-2.0, -2.0)


# Phase 15's card-vs-CPU check randomizes every row of FIELD_SPECS: the
# events of SURFACE_DR and the task's foot friction, and one event more per
# other field: (the robot's selection, operation, ranges).
OTHER_FIELDS_DR = {
  "dof_frictionloss": ({"joint_names": (".*ankle.*",)}, "abs", (0.0, 0.2)),
  "jnt_range": ({"joint_names": (".*hip_pitch.*",)}, "scale", (0.9, 1.1)),
  "jnt_stiffness": ({"joint_names": (".*wrist.*",)}, "add", (0.0, 2.0)),
  "body_ipos": ({"body_names": ("pelvis",)}, "add", (-0.01, 0.01)),
  "body_iquat": ({"body_names": ("pelvis",)}, "add", (-0.02, 0.02)),
  "body_pos": ({"body_names": (".*elbow.*",)}, "add", (-0.005, 0.005)),
  "body_quat": ({"body_names": (".*elbow.*",)}, "add", (-0.01, 0.01)),
  "geom_pos": ({"geom_names": (r".*_foot[1-7]_collision",)}, "add", (-0.003, 0.003)),
  "geom_quat": ({"geom_names": (r".*_foot[1-7]_collision",)}, "add", (-0.01, 0.01)),
  "site_pos": ({}, "add", (-0.01, 0.01)),
  "site_quat": ({}, "add", (-0.02, 0.02)),
  "qpos0": ({"joint_names": (".*knee.*",)}, "add", (-0.05, 0.05)),
}


def all_fields_variant(cfg) -> None:
  """The certain sim-to-real cfg with every FIELD_SPECS row randomized at
  startup, each env different (the foot friction drawn again)."""
  from mjlab_tpu_torch.envs import mdp
  from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg
  from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

  certain_surface_variant(cfg)
  cfg.events["foot_friction"].params["ranges"] = (0.3, 1.2)
  for field, (select, op, ranges) in OTHER_FIELDS_DR.items():
    cfg.events[f"dr_{field}"] = EventTermCfg(
      mode="startup", func=mdp.randomize_field, domain_randomization=True,
      params={"field": field, "ranges": ranges, "operation": op,
              "asset_cfg": SceneEntityCfg("robot", **select)},
    )


def surface_leaf_checks(env, rel: float = 1e-5) -> dict[str, float]:
  """The startup randomization of SURFACE_DR on a built env: each leaf is
  changed on its event's elements (and axes) only, inside its range (of the
  value, the change or the ratio to the compiled value, by the operation;
  `rel` of slack for float32), and differs across envs on every selected
  element whose compiled value it does not scale from 0. Returns each
  field's least spread across envs. Raises on a failed check."""
  from mjlab_tpu_torch.envs.mdp.events import FIELD_SPECS, _entity_indices

  robot = env.scene["robot"]
  spreads = {}
  for name, (field, (lo, hi), op, _, extra) in SURFACE_DR.items():
    spec = FIELD_SPECS[field]
    idx = _entity_indices(robot, env.cfg.events[name].params["asset_cfg"], spec)
    leaf, nominal = getattr(env.model, field), getattr(env.sim.model, field)[0]
    mask = torch.zeros(leaf.shape[1:], dtype=torch.bool, device=leaf.device)
    if leaf.dim() == 2:
      mask[idx] = True
    else:
      axes = extra.get("axes") or spec.default_axes or range(leaf.shape[-1])
      for ax in axes:
        mask[idx, ax] = True
    if not torch.equal(leaf[:, ~mask], nominal[~mask].expand(leaf.shape[0], -1)):
      raise AssertionError(f"{field}: changed outside its event's elements")
    sel, nom = leaf[:, mask], nominal[mask]
    if op == "scale":
      keep = nom != 0
      sel, value = sel[:, keep], sel[:, keep] / nom[keep]
    else:
      value = sel - nom
    slack = rel * max(1.0, abs(lo), abs(hi))
    if not (value.min() >= lo - slack and value.max() <= hi + slack):
      raise AssertionError(f"{field}: {op} outside {(lo, hi)}: [{value.min().item()}, "
                           f"{value.max().item()}]")
    spreads[field] = (sel.amax(0) - sel.amin(0)).min().item()
    if not spreads[field] > 0:
      raise AssertionError(f"{field}: an element is the same in every env")
  return spreads


def split_env_step(env, action, reps: int = 2) -> dict[str, float]:
  """Mean ms of each part of ManagerBasedRlEnv.step, run in its order with
  the env's own methods, CUDA events between the parts."""
  from mjlab_tpu_torch.envs.manager_based_rl_env import select_data

  marks = []

  def mark(part):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    marks.append((part, e))

  for _ in range(reps):
    mark("start")
    env.step_log = {}
    env.action_manager.process_action(action)
    for _ in range(env.cfg.decimation):
      env.action_manager.apply_action()
      env.scene.write_data_to_sim()
      env.data = env.step_physics(env.data)
      env.scene.update(dt=env.physics_dt)
    mark("physics substeps")
    env._episode_length = env._episode_length + 1
    env._common_step_counter = env._common_step_counter + 1
    reset_buf = env.termination_manager.compute()
    env.reward_manager.compute(dt=env.step_dt)
    mark("terminations + rewards")
    env._reset_masked(reset_buf)
    mark("reset")
    env.data = select_data(torch.any(reset_buf), env.forward_physics(env.data), env.data)
    mark("post-reset forward")
    env.command_manager.compute(dt=env.step_dt)
    env.event_manager.apply(mode="interval", dt=env.step_dt)
    mark("commands + events")
    env.observation_manager.compute()
    mark("observations")
  torch.cuda.synchronize()
  out: dict[str, float] = {}
  for (_, a), (part, b) in zip(marks, marks[1:]):
    if part != "start":
      out[part] = out.get(part, 0.0) + a.elapsed_time(b) / reps
  return out


def timed_iteration(runner):
  """One `train_iteration` as its three calls, with CUDA events between
  them: the draws, the rollout (24 policy acts and env steps) and the
  update (bootstrap value, GAE and prep, the minibatch steps, the
  normalizers). No host sync: read the events with `parts_ms` after a
  synchronize. Returns the update's metrics, the events, the device memory
  allocated (GB) at the start and its peak in the rollout and in the
  update, and the iteration's (batch, logs, perms), for a profile of
  another update."""
  marks = []

  def mark(part):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    marks.append((part, e))

  mem = {"at the start": torch.cuda.memory_allocated() / 1e9}
  torch.cuda.reset_peak_memory_stats()
  mark("start")
  noise, perms = runner.draw()
  mark("draws")
  batch, logs = runner.rollout(noise)
  mark("rollout (policy acts + env steps)")
  mem["rollout peak"] = torch.cuda.max_memory_allocated() / 1e9
  torch.cuda.reset_peak_memory_stats()
  metrics = runner.update(batch, logs, perms)
  mark("update")
  mem["update peak"] = torch.cuda.max_memory_allocated() / 1e9
  return metrics, marks, mem, (batch, logs, perms)


def parts_ms(marks) -> dict[str, float]:
  return {part: a.elapsed_time(b) for (_, a), (part, b) in zip(marks, marks[1:])}


def span_busy_ms(prof) -> tuple[dict[str, tuple[float, float]], set[str]]:
  """(busy ms, range ms) of each TRAIN_SPANS span on the device timeline:
  the range is the span's GPU-side annotation, busy the time of the
  kernels that start inside it. Kernels are placed by time, not by the op
  that launched them, so that the backward pass, which autograd runs on its
  own device thread outside the span, counts in the minibatch steps.

  The profiler does not always record a span's GPU-side annotation (the
  tracking path's `rollout_step/act` lacked it on the card, and its CPU
  row carried no kernels); such a span is left out. Returns the measured
  spans and the names of every span the CPU side recorded."""
  events = prof.events()
  kernels = sorted(
    (e.time_range.start, e.time_range.elapsed_us()) for e in events
    if str(e.device_type).endswith("CUDA") and e.name not in TRAIN_SPANS
    and not getattr(e, "is_user_annotation", False)
  )
  starts = [k[0] for k in kernels]
  out: dict[str, tuple[float, float]] = {}
  for e in events:
    if e.name in TRAIN_SPANS and str(e.device_type).endswith("CUDA"):
      a, b = e.time_range.start, e.time_range.end
      busy = sum(d for _, d in kernels[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)])
      prev = out.get(e.name, (0.0, 0.0))
      out[e.name] = (prev[0] + busy / 1e3, prev[1] + (b - a) / 1e3)
  return out, {e.name for e in events if e.name in TRAIN_SPANS
               and str(e.device_type).endswith("CPU")}


def train_iterations(runner, card: str, phase: str, obs_dims: tuple[int, int],
                     iters: int = TRAIN_ITERS, expect: tuple[str, ...] = KERNELS,
                     steps: int = TRAIN_STEPS):
  """`iters` `train_iteration`s under set_sync_debug_mode("error") with
  the kernels' counters set to 0 just before and read just after. Checks
  1416 factorizations and 120 `chol_solve` per iteration (at 10 Newton
  iterations), finite losses, the lr inside [1e-5, 1e-2], the rollout
  buffers' shapes and that every parameter moved. Each iteration runs as
  `timed_iteration`. Returns the launches, the steady ms per iteration
  (CUDA events; with one iteration, that iteration's, its warm-up
  included), each iteration's metrics and the last iteration's split (its
  parts' ms, memory, and (batch, logs, perms)). Each kernel of `expect` must
  have launched. The runner takes `steps` env steps per iteration (the PPO
  cfgs' TRAIN_STEPS, or CUT_STEPS where a phase overrides it)."""
  import numpy as np

  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays

  if runner.cfg.num_steps_per_env != steps:
    raise AssertionError(f"the runner takes {runner.cfg.num_steps_per_env} steps per env, "
                         f"not {steps}")
  before = runner_state_to_arrays(runner)
  metrics, marks, mems = [], [], []
  chol.reset_counts()
  torch.cuda.set_sync_debug_mode("error")
  t0 = time.perf_counter()
  for _ in range(iters):
    m, mk, mem, last = timed_iteration(runner)
    metrics.append(m)
    marks.append(mk)
    mems.append(mem)
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  t_train = time.perf_counter() - t0
  launches = dict(chol.LAUNCHES)
  fact = chol.factorizations()
  peak_gb = max(max(mem.values()) for mem in mems)
  iter_ms = [mk[0][1].elapsed_time(mk[-1][1]) for mk in marks]
  steady_iter_ms = sum(iter_ms[1:]) / (iters - 1) if iters > 1 else iter_ms[0]
  host = [{k: float(v) for k, v in m.items()} for m in metrics]
  print(f"  {iters} iterations under set_sync_debug_mode('error'): no host-device "
        f"synchronization; wall {t_train:.3f} s")
  print(f"  ms per iteration (CUDA events) {', '.join(f'{x:.2f}' for x in iter_ms)}; "
        + (f"steady (iterations 2-{iters})" if iters > 1 else "one iteration, its warm-up in")
        + f" {steady_iter_ms:.2f} ms, "
        f"{NUM_WORLDS * steps / steady_iter_ms * 1e3:.1f} training env-steps/s [{card}]")
  print(f"  peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated) [{card}]")
  print(f"  launches {launches}; factorizations {fact} = {fact / iters:.1f}/iteration, "
        f"chol_solve {launches['chol_solve'] / iters:.1f}/iteration")
  for i, m in enumerate(host):
    print(f"  it {i}: loss {m['Loss/loss']:.5f} surrogate {m['Loss/surrogate']:.5f} value "
          f"{m['Loss/value_loss']:.5f} kl {m['Loss/kl']:.5f} entropy {m['Loss/entropy']:.3f} "
          f"lr {m['Loss/lr']:.3e} reward {m['Train/mean_step_reward']:.5f} resets "
          f"{m['Train/resets']:.0f} noise_std {m['Policy/noise_std']:.4f}")
  per_step = fact_per_env_step(runner.env.sim.model.opt.iterations)
  if (fact != steps * per_step * iters
      or launches["chol_solve"] != steps * RL_SOLVES_PER_STEP * iters
      or any(launches[k] == 0 for k in expect)):
    raise AssertionError(f"{phase}: expected {steps * per_step} factorizations "
                         f"and {steps * RL_SOLVES_PER_STEP} solves per iteration, got "
                         f"{launches}")
  for m in host:
    if not all(np.isfinite(m[k]) for k in ("Loss/loss", "Loss/kl", "Loss/value_loss")):
      raise AssertionError(f"{phase}: non-finite loss, KL or value loss: {m}")
    if not 1e-5 <= m["Loss/lr"] <= 1e-2:
      raise AssertionError(f"{phase}: lr {m['Loss/lr']} outside [1e-5, 1e-2]")
  shapes = {f: tuple(getattr(runner.batch, f).shape) for f in ("actor_obs", "critic_obs", "action")}
  print(f"  rollout buffers {shapes}")
  if shapes != {"actor_obs": (steps, NUM_WORLDS, obs_dims[0]),
                "critic_obs": (steps, NUM_WORLDS, obs_dims[1]),
                "action": (steps, NUM_WORLDS, runner.num_actions)}:
    raise AssertionError(f"{phase}: rollout buffer shapes")
  after = runner_state_to_arrays(runner)
  moved = {k: float(np.abs(after[k] - before[k]).max()) for k in after if k.startswith("params/")}
  print(f"  params moved: least max |change| over the {len(moved)} tensors "
        f"{min(moved.values()):.3e}")
  if not min(moved.values()) > 0:
    raise AssertionError(f"{phase}: a parameter tensor did not change")
  return launches, steady_iter_ms, host, (parts_ms(marks[-1]), mems[-1], last)


def span_split(by_span, recorded, profiled, parts, n_mb: int, card: str) -> None:
  """Print (and check) the rollout step's and the update's kernel time by
  the runner's spans (`span_busy_ms`)."""
  if sorted(recorded) != sorted(TRAIN_SPANS):
    raise AssertionError(f"the profiles lack spans: got {sorted(recorded)}")

  def span_ms(k, n=1):
    return (f"{n * by_span[k][0]:.3f}" if k in by_span
            else "not measured (the profiler recorded no GPU-side annotation)")

  for part, names in (("rollout step", TRAIN_SPANS[:2]), ("update", TRAIN_SPANS[2:])):
    rest = profiled[part][0] - sum(by_span[k][0] for k in names if k in by_span)
    print(f"  the {part} by span, kernel ms on the device (the span's range on the device "
          "timeline, stretched by the profiler): "
          + ", ".join(f"{k} {span_ms(k)}" + (f" ({by_span[k][1]:.3f})" if k in by_span else "")
                      for k in names)
          + f", outside the measured spans {rest:.3f} [{card}]")
    if rest < -1e-3 * profiled[part][0]:
      raise AssertionError(f"the {part}'s spans hold more kernel time than the {part}")
  print(f"  kernel time of {TRAIN_STEPS} policy acts {span_ms('rollout_step/act', TRAIN_STEPS)} "
        f"ms; of one minibatch step {span_ms('ppo_update/minibatch_steps', 1 / n_mb)} ms; "
        f"the update's wall time is {parts['update'] / profiled['update'][0]:.2f} x its "
        f"kernel time [{card}]")


def profile_iteration(runner, card: str, attr: str, tag: str, steady_iter_ms: float,
                      split, spans: bool = True) -> None:
  """The last training iteration's split by the runner's three calls
  (`split`, from `train_iterations`), then profiles of one rollout step and
  of one more update on that iteration's batch, split by the runner's
  spans; an iteration is T of the one and one of the other, which gives
  its launches and the device's busy share. With `spans` False the
  profiler traces the device only (no host ops, no split by span), which
  parses several times faster. Tables go to
  OUT/chip_smoke_<tag>_<part>_profile.txt."""
  from torch.profiler import ProfilerActivity, profile

  alg = runner.cfg.algorithm
  n_mb = alg.num_learning_epochs * alg.num_mini_batches
  parts, mem, (batch, logs, perms) = split
  print(f"  the last iteration by call (CUDA events) [{card}]:")
  for part, ms in parts.items():
    print(f"    {part:34s} {ms:10.3f} ms  {100 * ms / sum(parts.values()):5.1f}%")
  print(f"    {'sum':34s} {sum(parts.values()):10.3f} ms")
  print("  device memory allocated in that iteration (GB): "
        + ", ".join(f"{k} {v:.2f}" for k, v in mem.items()) + f" [{card}]")
  # A profile of a whole iteration (~0.94M kernel launches and more host
  # ops) would take the profiler minutes to parse, so one rollout step and
  # one update are profiled; an iteration is T of the one and one of the
  # other. The runner's spans split each (`span_busy_ms`).
  noise = runner.draw()[0]
  activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if spans else [])
  profiled, by_span, recorded = {}, {}, set()
  for part, fn in (("rollout step", lambda: runner.rollout_step(noise[0])),
                   ("update", lambda: runner.update(batch, logs, perms))):
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
      fn()
      torch.cuda.synchronize()
    averages = prof.key_averages()
    name = part.replace(" ", "_")
    table = OUT / f"chip_smoke_{tag}_{name}_profile.txt"
    table.write_text(averages.table(sort_by=attr, row_limit=40))
    events = [e for e in averages if str(e.device_type).endswith("CUDA")
              and e.key not in TRAIN_SPANS and not getattr(e, "is_user_annotation", False)]
    profiled[part] = (sum(getattr(e, attr) for e in events) / 1e3, sum(e.count for e in events))
    if spans:
      got, seen = span_busy_ms(prof)
      by_span.update(got)
      recorded |= seen
    print(f"  profile of one {part}: device time {profiled[part][0]:.2f} ms in "
          f"{profiled[part][1]} kernel launches ({time.perf_counter() - t0:.1f} s with the "
          f"profiler) [{card}]; table in {table}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:5]:
      print(f"    {getattr(e, attr) / 1e3:8.3f} ms  x{e.count:6d}  {e.key[:90]}")
  if spans:
    span_split(by_span, recorded, profiled, parts, n_mb, card)
  dev_ms = TRAIN_STEPS * profiled["rollout step"][0] + profiled["update"][0]
  kernel_launches = TRAIN_STEPS * profiled["rollout step"][1] + profiled["update"][1]
  print(f"  one iteration = {TRAIN_STEPS} rollout steps + one update: device time "
        f"{dev_ms:.2f} ms in {kernel_launches} kernel launches; busy share "
        f"{dev_ms / steady_iter_ms:.3f} of the steady {steady_iter_ms:.2f} ms/iteration "
        f"[{card}]")


def f64_iteration_check(task: str, variant, f64_seeds, overrides=None) -> None:
  """The card's float64 training iteration (kernels) against the CPU's
  (plain versions) on a variant of `task` whose draws are all certain, 4
  envs, T = 4, 1 epoch x 2 minibatches, for each seed: one warm learner
  (Adam's moments and step count and the normalizers' statistics drawn
  from the seed, as tests/test_torch_runner.py draws the normalizers) and
  the same action noise and permutations on both. From a fresh learner the
  comparison measures two amplifiers rather than the card: Adam's first
  steps scale a gradient near 0 by lr / eps = 1e5, and a normalizer of count
  0 takes a batch's mean whole, so an observation that the float32 cast
  rounds one ulp apart on the two paths (the float64 physics differ in the
  last bits) moved the result by up to 1.3e-6 (PERF.md). Fails above 1e-8
  relative to max(1, max |CPU|)."""
  import numpy as np

  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.rl.runner import (
    OnPolicyRunner, runner_state_from_arrays, runner_state_to_arrays,
  )
  from mjlab_tpu_torch.scripts.cli import apply_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg, load_rl_cfg

  worst_by_seed = {}
  for seed in f64_seeds:
    runners = {}
    for dv in ("cuda", "cpu"):
      cfg = load_env_cfg(task)
      apply_overrides(cfg, overrides or {})
      cfg.scene.num_envs = 4
      cfg.sim.dtype = "float64"
      variant(cfg)
      rl = load_rl_cfg(task)
      rl.num_steps_per_env = 4
      rl.algorithm.num_learning_epochs = 1
      rl.algorithm.num_mini_batches = 2
      runners[dv] = OnPolicyRunner(ManagerBasedRlEnv(cfg, device=dv), rl)
    draw = np.random.default_rng(seed)
    warm = {}
    for k, v in runner_state_to_arrays(runners["cpu"]).items():
      if k.startswith("opt/mu/"):
        v = draw.normal(0.0, 1e-3, v.shape)
      elif k.startswith("opt/nu/"):
        v = draw.uniform(1e-6, 1e-4, v.shape)
      elif k == "opt/count":
        v = np.asarray(100, v.dtype)
      elif k.endswith("_norm/mean"):
        v = draw.normal(0.0, 0.5, v.shape)
      elif k.endswith("_norm/var"):
        v = draw.uniform(0.5, 2.0, v.shape)
      elif k.endswith("_norm/count"):
        v = np.asarray(200.0)
      warm[k] = v.astype(np.float64) if v.dtype.kind == "f" else v
    for r in runners.values():
      runner_state_from_arrays(r, warm)
    rng = torch.Generator().manual_seed(seed)
    noise = torch.randn(4, 4, runners["cpu"].num_actions, generator=rng, dtype=torch.float64)
    perms = torch.randperm(16, generator=rng)[None]
    f64_metrics = {dv: r.train_iteration(noise.to(r.device), perms.to(r.device))
                   for dv, r in runners.items()}
    states = {dv: runner_state_to_arrays(r) for dv, r in runners.items()}
    worst = {}
    for name, got_, want_ in (
      *((k, states["cuda"][k], states["cpu"][k]) for k in states["cpu"]),
      *((k, f64_metrics["cuda"][k].cpu().numpy(), f64_metrics["cpu"][k].numpy())
        for k in f64_metrics["cpu"]),
    ):
      got_, want_ = np.asarray(got_, np.float64), np.asarray(want_, np.float64)
      worst[name] = np.abs(got_ - want_).max() / max(1.0, np.abs(want_).max())
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    # The stored (float32-cast, then normalized) observations: a rounding
    # flip shows as an element apart by far more than float64 rounding.
    obs_gap = torch.cat([
      (getattr(runners["cuda"].batch, f).cpu() - getattr(runners["cpu"].batch, f)).abs().flatten()
      for f in ("actor_obs", "critic_obs")
    ])
    print(f"  card (kernels, f64) vs CPU (plain, f64), one iteration from a warm learner, "
          f"certain-draw variant, 4 envs, T 4, 1 epoch x 2 minibatches, the same draws and "
          f"state (seed {seed}): largest "
          "relative errors " + ", ".join(f"{k} {v:.3e}" for k, v in top)
          + f" over {len(worst)} arrays (tol 1e-8); stored observations apart by at most "
          f"{obs_gap.max().item():.3e}, {int((obs_gap > 1e-10).sum())} of {obs_gap.numel()} "
          "by more than 1e-10")
    worst_by_seed[seed] = max(worst.values())
    del runners
  print(f"  card vs CPU float64 iteration: largest relative error over seeds "
        f"{list(worst_by_seed)}: {max(worst_by_seed.values()):.3e} (tol 1e-8)")
  if not max(worst_by_seed.values()) <= 1e-8:
    raise AssertionError(f"card vs CPU training iteration mismatch: {worst_by_seed}")


def f64_env_check(task: str, n_steps: int = 8, on_step=None, nudges: int = 0,
                  overrides: dict[str, str] | None = None, variant=None) -> float:
  """The card's float64 env (kernels) against the CPU's (plain versions) on
  `task`'s certain-draw variant, 4 envs x `n_steps` env steps of N(0, 1)
  actions: observations, rewards and qpos within 1e-8 relative to
  max(1, max |CPU|). With `nudges` > 0, each step starts from the CPU env's
  state (the card env takes it whole), and the tolerance is 1e-8 or twice
  the CPU env's own spread, whichever is larger: the largest distance of
  `nudges` reruns of the CPU step with qpos moved by 1e-13 (relative). The
  Asimov tasks need it: at their 30 Newton iterations the contact solve
  converges, its accept test takes one of two branches by rounding (about
  half of nudged runs land ~1e-8 away on an Asimov step, PERF.md PR 7),
  and later steps compound such differences; 6 nudges all on one branch
  happen about once in 32. `on_step(env,
  action)` runs after each card step; the largest value it returns is
  returned; `overrides` edit the env cfg as the CLI's `--env.*` flags do;
  `variant` replaces `certain_variant` (the card then takes the CPU env's
  per-env model leaves with its state: pass `nudges`). A 4-env CPU step is
  thousands of tiny ops: one thread runs it fastest."""
  from mjlab_tpu_torch.envs import (
    ManagerBasedRlEnv, env_state_from_arrays, env_state_to_arrays,
  )
  from mjlab_tpu_torch.scripts.cli import apply_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg

  torch.set_num_threads(1)  # and so it stays for the later CPU checks
  envs = {}
  for dv in ("cuda", "cpu"):
    cfg = load_env_cfg(task)
    apply_overrides(cfg, overrides or {})
    cfg.scene.num_envs = 4
    cfg.sim.dtype = "float64"
    (variant or certain_variant)(cfg)
    envs[dv] = ManagerBasedRlEnv(cfg, device=dv)
  outs = {dv: [e.reset(seed=0)[0]] for dv, e in envs.items()}
  rng = torch.Generator().manual_seed(2)
  n_act = envs["cpu"].total_action_dim
  keys = ("policy", "critic", "reward", "qpos")
  spread = dict.fromkeys(keys, 0.0)
  on_step_max = 0.0
  for _ in range(n_steps):
    a = torch.randn(4, n_act, generator=rng, dtype=torch.float64)
    if nudges:
      pre = env_state_to_arrays(envs["cpu"])
      env_state_from_arrays(envs["cuda"], pre)
    for dv, e in envs.items():
      o, r, *_ = e.step(a.to(dv))
      outs[dv].append({**o, "reward": r, "qpos": e.data.qpos})
    if on_step is not None:
      on_step_max = max(on_step_max, on_step(envs["cuda"], a))
    if nudges:
      post, want = env_state_to_arrays(envs["cpu"]), outs["cpu"][-1]
      for _ in range(nudges):
        q = pre["data.qpos"]
        noise = torch.randn(q.shape, generator=rng, dtype=torch.float64).numpy()
        env_state_from_arrays(envs["cpu"], {**pre, "data.qpos": q * (1 + 1e-13 * noise)})
        o, r, *_ = envs["cpu"].step(a)
        for key, v in {**o, "reward": r, "qpos": envs["cpu"].data.qpos}.items():
          if key in spread:
            spread[key] = max(spread[key], (v - want[key]).abs().max().item()
                              / max(1.0, want[key].abs().max().item()))
      env_state_from_arrays(envs["cpu"], post)
  print(f"  card (kernels, f64) vs CPU (plain, f64), {task} certain-draw variant, 4 envs x "
        f"{n_steps} env steps" + (f", each from the CPU env's state, tolerance max(1e-8, 2 x "
                                  f"the CPU's spread over {nudges} qpos nudges of 1e-13):"
                                  if nudges else ":"))
  for key in keys:
    got = torch.stack([o[key].cpu() for o in outs["cuda"][1:]])
    want = torch.stack([o[key] for o in outs["cpu"][1:]])
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    tol = max(1e-8, 2 * spread[key])
    print(f"    {key:8s} max_abs_err {err:.3e} relative {err / scale:.3e} (tol {tol:.3e}"
          + (f", CPU spread {spread[key]:.3e}" if nudges else "") + ")")
    if not err <= tol * scale:
      raise AssertionError(f"card vs CPU env mismatch on {key} ({task})")
  return on_step_max


def ankle_ctrl_check(env, action) -> float:
  """After an Asimov-Toe env step: ctrl holds the ankle term's A/B tendon
  targets on the 4 tendon actuators, the joint term's targets on its 8 hip
  and knee actuators, and 0 on the 2 passive toes. Returns the largest
  error."""
  robot = env.scene["robot"]
  ankle = env.action_manager.get_term("ankle_ab")
  joint = env.action_manager.get_term("joint_pos")
  pr, L, dd = ankle.processed_actions, ankle.cfg.L, ankle.cfg.d
  targets = torch.stack([-L * pr[:, 0] - dd * pr[:, 1], -L * pr[:, 0] + dd * pr[:, 1],
                         L * pr[:, 2] - dd * pr[:, 3], L * pr[:, 2] + dd * pr[:, 3]], 1)
  ctrl = env.data.ctrl[:, list(robot.indexing.ctrl_ids)]
  names = list(robot.actuator_names)
  tendon = [names.index(n) for n in ("left_ankle_A", "left_ankle_B", "right_ankle_A",
                                     "right_ankle_B")]
  joints = list(robot.find_actuators(joint.cfg.actuator_names, preserve_order=True)[0])
  toes = [i for i in range(len(names)) if i not in tendon + joints]
  errs = ((ctrl[:, tendon] - targets).abs().max().item(),
          (ctrl[:, joints] - joint.processed_actions).abs().max().item(),
          ctrl[:, toes].abs().max().item())
  if not (max(errs) <= 1e-12 and len(joints) == 8 and len(toes) == 2
          and targets.abs().max().item() > 0):
    raise AssertionError(f"Asimov-Toe ctrl: tendon, joint, toe errors {errs}")
  return max(errs)


def task_path(phase: str, task: str, tag: str, obs_dims: tuple[int, int], card: str,
              attr: str, checks: KernelCheck, launches: dict, path_ms: dict,
              after_build=None, on_step=None, after_train=None, ms_key=None,
              iters: int = TRAIN_ITERS, steps: int = TRAIN_STEPS) -> dict:
  """One task of phases 11-13: `build_runner` at NUM_WORLDS envs with the
  task's PPO cfg at `steps` env steps per iteration; the observation
  widths; `after_build(runner)`; phase 8's checks and split over `iters`
  iterations, and (unless `iters` is cut below TRAIN_ITERS) a device-only
  profile and one substep's stage times on the run's last state (phase 5's
  split);
  `after_train(runner)`; the four kernels against their plain versions on
  the run's matrices (n = nv, J of nefc rows), timed there beside their
  plain versions, the library calls and their bounds at these shapes; and
  the card's float64 env against the CPU's, 4 envs x CUT_F64_STEPS env
  steps each from the CPU's state (`f64_env_check` with nudges, `on_step`
  after each card step). Adds the iterations' launches to `launches` and each kernel's ms
  on the run's matrices to `path_ms` (keyed by `ms_key`, default nv);
  returns the iterations' metrics."""
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.physics import solver
  from mjlab_tpu_torch.scripts.train import build_runner

  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  runner = build_runner(task, {"env.scene.num_envs": str(NUM_WORLDS),
                               "agent.num_steps_per_env": str(steps)})
  torch.cuda.synchronize()
  env, alg, tp = runner.env, runner.cfg.algorithm, runner.env.tp
  print(f"{phase} {task}: {NUM_WORLDS} envs, nq {tp.nq}, nv {tp.nv}, nu {tp.nu}, tendons "
        f"{tp.ntendon}, contact slots {tp.ncon_max} in {len(tp.pairs)} pairs"
        + "".join(f" + {g.slots} x {len(g.robot_geoms)} terrain slots (geom type "
                  f"{g.robot_type})" for g in tp.terrain_groups)
        + f", Newton rows {tp.nefc}, obs {env.group_obs_dim}, actions {runner.num_actions}, "
        f"episodes {env.cfg.episode_length_s} s, T {runner.cfg.num_steps_per_env}, "
        f"{alg.num_learning_epochs} epochs x {alg.num_mini_batches} minibatches, hidden "
        f"{runner.cfg.policy.actor_hidden_dims}, entropy {alg.entropy_coef}, lr "
        f"{alg.schedule} from {alg.learning_rate}; build_runner "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
  if env.group_obs_dim != {"policy": (obs_dims[0],), "critic": (obs_dims[1],)}:
    raise AssertionError(f"{task}: observation widths {env.group_obs_dim}")
  if after_build is not None:
    after_build(runner)
  it = env.sim.model.opt.iterations
  print(f"  expected per iteration (independent of nv): {steps} env steps x "
        f"({DECIMATION} substeps x (factor_m + {it} Newton directions + the integrator's "
        f"factor-solve) + {it + 1} in the post-reset forward) = "
        f"{steps * fact_per_env_step(it)} factorizations; {steps} x "
        f"{RL_SOLVES_PER_STEP} = {steps * RL_SOLVES_PER_STEP} chol_solve")
  got, steady_iter_ms, host, split = train_iterations(runner, card, f"{phase} {tag}", obs_dims,
                                                      iters, steps=steps)
  for k in KERNELS:
    launches[k] += got[k]
  if iters < TRAIN_ITERS:
    print("  a cut run: no profile and no stage times (cut to keep the script inside its "
          "limit)")
  else:
    profile_iteration(runner, card, attr, tag, steady_iter_ms, split, spans=False)
    per_stage = stage_times(tp, env.model, env.data)
    print(f"  one substep by stage on the run's last state (CUDA events, mean of 3): "
          + ", ".join(f"{k} {v:.3f}"
                      for k, v in sorted(per_stage.items(), key=lambda kv: -kv[1])[:6])
          + f" ms; sum {sum(per_stage.values()):.3f} ms [{card}]")
  del split
  if after_train is not None:
    after_train(runner)

  d, n = env.data, tp.nv
  print(f"  kernels vs plain on the {tag} run's matrices, f32, n = {n}, J "
        f"({NUM_WORLDS}, {tp.nefc}, {n}):")
  grad = torch.randn(NUM_WORLDS, n, generator=torch.Generator(device="cuda").manual_seed(11),
                     device="cuda")
  qM, H = d.qM.contiguous(), solver.hessian(d, d.qacc).contiguous()
  w = solver.newton_weights(d, d.qacc)
  checks.all_three(f"{tag} qM", qM, d.qfrc_smooth.contiguous())
  checks.all_three(f"{tag} H", H, grad)
  checks.newton(f"{tag} qM,J,w", d.qM, d.efc_J, w, grad)
  active_rows = int((w != 0).sum().item())
  L = chol.chol_factor(qM)
  J = d.efc_J.contiguous()
  timing = {
    "chol_factor": (lambda: chol.chol_factor(qM), lambda: chol.chol_factor_plain(qM),
                    lambda: torch.linalg.cholesky_ex(qM)),
    "chol_solve": (lambda: chol.chol_solve(L, grad), lambda: chol.chol_solve_plain(L, grad),
                   lambda: torch.cholesky_solve(grad[..., None], L)),
    "chol_factor_solve": (
      lambda: chol.chol_factor_solve(H, grad), lambda: chol.chol_factor_solve_plain(H, grad),
      lambda: torch.cholesky_solve(grad[..., None], torch.linalg.cholesky_ex(H)[0])),
    "newton_direction": (
      lambda: chol.newton_direction(qM, J, w, grad),
      lambda: chol.newton_direction_plain(qM, J, w, grad),
      lambda: torch.cholesky_solve(
        grad[..., None], torch.linalg.cholesky_ex(chol.newton_matrix(qM, J, w))[0])),
  }
  bnd = bounds(NUM_WORLDS, n, rows=active_rows, nefc=tp.nefc)
  print(f"  times on the run's matrices (mean of 20 calls; active Newton rows "
        f"{active_rows / (NUM_WORLDS * tp.nefc):.4f} of {NUM_WORLDS * tp.nefc}) [{card}]:")
  for k, (kern, plain, lib) in timing.items():
    ms = [time_ms(f, [()], iters=iters) for f, iters in ((kern, 20), (plain, 5), (lib, 20))]
    path_ms[k][ms_key or str(n)] = ms[0]
    print(f"    {k:18s} kernel {ms[0]:.4f} ms  plain {ms[1]:.4f} ms  library "
          f"{ms[2]:.4f} ms  bound {bnd[k][0]:.6f} ms ({bnd[k][1]})")
  del runner, env, d, qM, H, L, J, w, grad
  gc.collect()
  torch.cuda.empty_cache()
  on_step_max = f64_env_check(task, n_steps=CUT_F64_STEPS, nudges=6, on_step=on_step)
  if on_step is not None:
    print(f"  the per-step check after each card step: largest error {on_step_max:.3e}")
  return host


def asimov_path(card: str, attr: str, checks: KernelCheck):
  """Phase 11: the Asimov family (ASIMOV_OBS_DIMS' two tasks) trains on flat
  ground, each through `task_path` for CUT_ITERS iteration; for Asimov,
  the feet's hulls built on this host against the CPU host's digest; for
  Asimov-Toe, the ankle targets checked in ctrl after every card step of
  the float64 env check (tol 1e-12). Returns the kernels' launches over
  both tasks' iterations and each kernel's ms on each run's matrices
  (keyed by nv)."""
  t_phase = time.perf_counter()
  launches = {k: 0 for k in KERNELS}
  path_ms: dict[str, dict[str, float]] = {k: {} for k in KERNELS}

  def hulls(runner):
    tp = runner.env.tp
    digest = hull_digest(tp)
    print(f"  feet hulls built here from the npz: {sorted(tp.geom_hulls)}, vertices "
          f"{[tp.geom_hulls[g].verts.shape[0] for g in sorted(tp.geom_hulls)]}; digest "
          f"{digest[:16]}... equals the CPU host's: {digest == ASIMOV_HULL_DIGEST}")
    if digest != ASIMOV_HULL_DIGEST:
      raise AssertionError("the Asimov feet's hulls differ from the CPU host's")

  for task, obs_dims in ASIMOV_OBS_DIMS.items():
    toe = task.endswith("Toe")
    task_path("phase 11", task, "asimov_toe" if toe else "asimov", obs_dims, card, attr,
              checks, launches, path_ms, after_build=None if toe else hulls,
              on_step=ankle_ctrl_check if toe else None, iters=CUT_ITERS,
              steps=CUT_STEPS)
  print(f"phase 11: {time.perf_counter() - t_phase:.1f} s; launches over both tasks' "
        f"{CUT_ITERS} iteration {launches}")
  return launches, path_ms


def rough_go1_path(card: str, attr: str, checks: KernelCheck):
  """Phase 12: G1 trains on rough terrain and Go1 on flat ground (the
  ROUGH_GO1_OBS_DIMS tasks), CUT_ITERS iteration each, each through
  `task_path`. For G1 rough, the
  box-terrain pool's groups and the generated grid are printed after the
  build, and the iterations' mean of the dropped terrain contacts and of
  the terrain-level curriculum; then a headless `run_play` of the rough
  task for EARLY_PLAY_STEPS steps on NUM_WORLDS envs, which loads the committed play
  scene (3 x 3 tiles), with the kernels' counters set to 0 just before and
  read just after. Returns the kernels' launches over both tasks'
  iterations and the play, and each kernel's ms on each run's matrices
  (keyed by nv)."""
  import numpy as np

  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.scripts.play import run_play

  t_phase = time.perf_counter()
  launches = {k: 0 for k in KERNELS}
  path_ms: dict[str, dict[str, float]] = {k: {} for k in KERNELS}
  for task, obs_dims in ROUGH_GO1_OBS_DIMS.items():
    rough = "Rough" in task
    t0 = time.perf_counter()
    host = task_path("phase 12", task, "g1_rough" if rough else "go1", obs_dims, card, attr,
                     checks, launches, path_ms,
                     after_build=(lambda r: print_terrain(r.env, ROUGH_TASK)) if rough else None,
                     iters=CUT_ITERS, steps=CUT_STEPS)
    if rough:
      terrain_metrics(task, host)
    print(f"  {task} in {time.perf_counter() - t0:.1f} s")

  gc.collect()
  torch.cuda.empty_cache()
  chol.reset_counts()
  t0 = time.perf_counter()
  res = run_play(ROUGH_TASK, {"num_envs": str(NUM_WORLDS), "steps": str(EARLY_PLAY_STEPS),
                              "policy": "random"})
  play_launches = dict(chol.LAUNCHES)
  env = res.env
  print(f"  run_play {ROUGH_TASK} --policy random: {NUM_WORLDS} envs x {EARLY_PLAY_STEPS} steps in "
        f"{res.seconds:.2f} s ({time.perf_counter() - t0:.2f} s with the build), mean reward "
        f"per step {res.mean_reward:.5f}, scene {Path(env.cfg.scene.model_file).name}, tiles "
        f"{env.scene.terrain.terrain_origins.shape[:2]}, {len(env.tp.terrain_groups[0].pool_geoms)} "
        f"boxes; launches {play_launches} [{card}]")
  if (Path(env.cfg.scene.model_file) != assets.G1_VELOCITY_ROUGH_PLAY
      or env.scene.terrain.terrain_origins.shape[:2] != (3, 3)
      or not np.isfinite(res.mean_reward) or not np.isfinite(res.base_z).all()
      or any(play_launches[k] == 0 for k in KERNELS)):
    raise AssertionError("phase 12: the rough task's play")
  for k in KERNELS:
    launches[k] += play_launches[k]
  del res, env
  print(f"phase 12: {time.perf_counter() - t_phase:.1f} s; launches over G1 rough's and "
        f"Go1's {CUT_ITERS} iteration and the play {launches}")
  return launches, path_ms


def terrain_metrics(task: str, host: list) -> None:
  """Each iteration's dropped terrain contacts (per env step) and mean
  terrain level (the curriculum), which must be finite and in range."""
  import numpy as np

  dropped = [m["Metrics/physics/terrain_slots_dropped"] for m in host]
  levels = [m["Curriculum/terrain_levels"] for m in host]
  print(f"  terrain over the {len(host)} iterations (f32): dropped contacts per env step "
        f"{', '.join(f'{x:.4f}' for x in dropped)}, mean {np.mean(dropped):.4f}; mean terrain "
        f"level {', '.join(f'{x:.4f}' for x in levels)}, mean {np.mean(levels):.4f}")
  if not all(np.isfinite(dropped + levels)) or not 0 <= min(levels) <= max(levels) <= 9:
    raise AssertionError(f"{task}: the terrain metrics")


def print_terrain(env, name: str) -> None:
  """A generated-terrain env's pool, cell hash, tiles, groups and initial
  levels; fails unless the pool is one and the grid 10 x 20 tiles."""
  import numpy as np

  origins = env.scene.terrain.terrain_origins
  g = env.tp.terrain_groups[0]
  levels = env.scene.terrain.terrain_levels.cpu().numpy()
  print(f"  terrain: {len(g.pool_geoms)} boxes pooled, cell hash {g.cells.shape}, tiles "
        f"{origins.shape[:2]} of {env.cfg.scene.terrain.terrain_generator.size} m, groups "
        + ", ".join(f"type {t.robot_type} x {len(t.robot_geoms)} ({t.slots} slots)"
                    for t in env.tp.terrain_groups)
        + f"; initial levels {np.bincount(levels, minlength=10).tolist()}")
  if len(g.pool_geoms) <= 64 or origins.shape[:2] != (10, 20):
    raise AssertionError(f"{name}: the terrain pool or the tile grid")


def sat_launches(env, card: str) -> dict:
  """The plain SAT's cost in one `collision` call on the env's state:
  device-only profiles of the whole call, of each box or mesh terrain
  group's `_terrain_group_contacts`, and of its `convex.convex_convex`
  alone on the inputs that group gave it (caught on the way). Returns
  {group: (launches, device ms) of the SAT alone} (the input of the fused
  SAT kernel, ROADMAP Queue B)."""
  from torch.profiler import ProfilerActivity, profile

  from mjlab_tpu_torch.physics import collision, convex

  tp, m, d = env.tp, env.model, env.data

  def launches_ms(fn) -> tuple[int, float]:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total if hasattr(e, "self_device_time_total")
                else e.self_cuda_time_total for e in events) / 1e3)

  whole = launches_ms(lambda: collision.collision(tp, m, d))
  print(f"  one collision call on the run's state: {whole[0]} kernel launches, "
        f"{whole[1]:.3f} ms on the device [{card}]")
  out = {}
  real = convex.convex_convex
  for t in tp.dev.coll.terrain:
    if t.tg.robot_type not in (6, 7):  # box, mesh
      continue
    caught = []

    def spy(*args, **kwargs):
      caught.append((args, kwargs))
      return real(*args, **kwargs)

    convex.convex_convex = spy
    try:
      group = launches_ms(lambda: collision._terrain_group_contacts(m, d, t))
    finally:
      convex.convex_convex = real
    args, kwargs = caught[0]
    sat = launches_ms(lambda: real(*args, **kwargs))
    name = {6: "box", 7: "mesh"}[t.tg.robot_type]
    out[name] = sat
    print(f"  the {name} terrain group ({len(t.tg.robot_geoms)} geoms x {t.tg.ncand} boxes, "
          f"{t.flags['clip_mode']} clipping, edge axes {t.flags['use_edge_axes']}): "
          f"{group[0]} launches, {group[1]:.3f} ms; of them the plain SAT "
          f"(convex_convex) {sat[0]} launches, {sat[1]:.3f} ms per collision call [{card}]")
  return out


def rough13_path(card: str, attr: str, checks: KernelCheck):
  """Phase 13: Go1, Asimov and Asimov-Toe train on rough terrain (the
  ROUGH13_OBS_DIMS tasks: Go1's trunk box and Asimov's feet hulls against
  the terrain pool through the plain SAT), each through `task_path`; the
  terrain printed after each build; for Asimov the feet's hulls built here
  from the rough npz against the CPU host's digest; each iteration's
  dropped terrain contacts and mean terrain level; the SAT's launches and
  device time per `collision` call on each run's last state
  (`sat_launches`); then a headless `run_play` of Go1 rough for
  EARLY_PLAY_STEPS steps of the random policy on NUM_WORLDS envs, which must
  load its committed
  play scene (3 x 3 tiles), with the kernels' counters set to 0 just
  before and read just after. Returns the kernels' launches over the
  tasks' iterations and the play, each kernel's ms on each run's matrices
  (keyed by nv and task) and the SAT's launches by group."""
  import numpy as np

  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.scripts.play import run_play

  t_phase = time.perf_counter()
  launches = {k: 0 for k in KERNELS}
  path_ms: dict[str, dict[str, float]] = {k: {} for k in KERNELS}
  sat: dict[str, tuple[int, float]] = {}
  for task, obs_dims in ROUGH13_OBS_DIMS.items():
    tag = {"Mjlab-Velocity-Rough-Unitree-Go1": "go1_rough",
           "Mjlab-Velocity-Rough-Asimov": "asimov_rough",
           "Mjlab-Velocity-Rough-Asimov-Toe": "asimov_toe_rough"}[task]

    def after_build(runner, task=task, tag=tag):
      print_terrain(runner.env, task)
      if tag == "asimov_rough":
        tp = runner.env.tp
        digest = hull_digest(tp)
        print(f"  feet hulls built here from the rough npz: {sorted(tp.geom_hulls)}, vertices "
              f"{[tp.geom_hulls[g].verts.shape[0] for g in sorted(tp.geom_hulls)]}; digest "
              f"{digest[:16]}... equals the CPU host's: {digest == ASIMOV_HULL_DIGEST}")
        if digest != ASIMOV_HULL_DIGEST:
          raise AssertionError("the Asimov feet's hulls from the rough npz differ")

    def after_train(runner):
      sat.update(sat_launches(runner.env, card))

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    host = task_path("phase 13", task, tag, obs_dims, card, attr, checks, launches, path_ms,
                     after_build=after_build, after_train=after_train,
                     ms_key=f"{tag} (n {18 if 'Toe' not in task else 20})", iters=CUT_ITERS,
                     steps=CUT_STEPS)
    terrain_metrics(task, host)
    print(f"  {task} in {time.perf_counter() - t0:.1f} s; peak memory over the task "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
  if set(sat) != {"box", "mesh"}:
    raise AssertionError(f"phase 13: the SAT ran in groups {sorted(sat)}, not box and mesh")

  gc.collect()
  torch.cuda.empty_cache()
  go1 = "Mjlab-Velocity-Rough-Unitree-Go1"
  chol.reset_counts()
  t0 = time.perf_counter()
  res = run_play(go1, {"num_envs": str(NUM_WORLDS), "steps": str(EARLY_PLAY_STEPS),
                       "policy": "random"})
  play_launches = dict(chol.LAUNCHES)
  env = res.env
  print(f"  run_play {go1} --policy random: {NUM_WORLDS} envs x {EARLY_PLAY_STEPS} steps in "
        f"{res.seconds:.2f} s ({time.perf_counter() - t0:.2f} s with the build), mean reward "
        f"per step {res.mean_reward:.5f}, scene {Path(env.cfg.scene.model_file).name}, tiles "
        f"{env.scene.terrain.terrain_origins.shape[:2]}, "
        f"{len(env.tp.terrain_groups[0].pool_geoms)} boxes; launches {play_launches} [{card}]")
  if (Path(env.cfg.scene.model_file) != assets.GO1_VELOCITY_ROUGH_PLAY
      or env.scene.terrain.terrain_origins.shape[:2] != (3, 3)
      or not np.isfinite(res.mean_reward) or not np.isfinite(res.base_z).all()
      or any(play_launches[k] == 0 for k in KERNELS)):
    raise AssertionError("phase 13: Go1 rough's play")
  for k in KERNELS:
    launches[k] += play_launches[k]
  del res, env
  print(f"phase 13: {time.perf_counter() - t_phase:.1f} s; launches over the three tasks' "
        f"{CUT_ITERS} iteration and the play {launches}; the plain SAT per collision call "
        + ", ".join(f"{g} group {n} launches, {ms:.3f} ms" for g, (n, ms) in sorted(sat.items())))
  return launches, path_ms, sat


def training_path(card: str, attr: str, f64_seeds=F64_SEEDS) -> tuple[dict[str, int], float]:
  """Phase 8: PPO training iterations through `build_runner` at NUM_WORLDS
  envs, then the card's float64 iteration against the CPU's. Returns the
  kernels' launches in the TRAIN_ITERS iterations and the steady ms per
  iteration. `attr` names the profiler's device-time field."""
  import numpy as np

  from mjlab_tpu_torch.rl.exporter import export_policy_as_torchscript
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays
  from mjlab_tpu_torch.scripts.train import build_runner

  # Phase 7's env sits in reference cycles (env <-> managers): collect it,
  # so that this phase's memory is its own.
  gc.collect()
  torch.cuda.empty_cache()
  print(f"phase 8: device memory allocated before build_runner "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
  t0 = time.perf_counter()
  runner = build_runner(TASK, {"env.scene.num_envs": str(NUM_WORLDS)})
  torch.cuda.synchronize()
  alg = runner.cfg.algorithm
  print(f"phase 8 training path: {TASK}, {NUM_WORLDS} envs, episodes "
        f"{runner.env.cfg.episode_length_s} s, T {runner.cfg.num_steps_per_env}, "
        f"{alg.num_learning_epochs} epochs x {alg.num_mini_batches} minibatches of "
        f"{NUM_WORLDS * TRAIN_STEPS // alg.num_mini_batches}, hidden "
        f"{runner.cfg.policy.actor_hidden_dims}, lr {alg.schedule}; build_runner "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
  train_launches, steady_iter_ms, _, split = train_iterations(runner, card, "phase 8",
                                                              (99, 111))
  profile_iteration(runner, card, attr, "train", steady_iter_ms, split)
  del split

  # Save, reload into a fresh runner; export the TorchScript policy.
  ckpt_dir = Path("build") / "chip_smoke"
  ckpt = ckpt_dir / "model.pt"
  runner.save(str(ckpt))
  saved = runner_state_to_arrays(runner)
  # The learner's shapes do not depend on the number of envs.
  fresh = build_runner(TASK, {"env.scene.num_envs": "4"})
  fresh.load(str(ckpt))
  loaded = runner_state_to_arrays(fresh)
  same = sorted(saved) == sorted(loaded) and all(np.array_equal(saved[k], loaded[k])
                                                 for k in saved)
  print(f"  save/load: {len(saved)} arrays, fresh runner equal: {same}, iteration "
        f"{fresh.iteration}")
  if not same or fresh.iteration != runner.iteration:
    raise AssertionError("the reloaded runner differs from the saved one")
  del fresh
  policy_path = export_policy_as_torchscript(runner, runner.env,
                                             str(ckpt_dir / "policy.pt"))
  scripted = torch.jit.load(policy_path)
  want = runner.get_inference_policy()(runner.obs).cpu()
  with torch.no_grad():
    got = scripted(runner.obs["policy"].to(torch.float32).cpu())
  err = (got - want).abs().max().item()
  scale = max(1.0, want.abs().max().item())
  # The export runs on the CPU, the inference policy on the card, both float32.
  print(f"  TorchScript policy (CPU) vs get_inference_policy (card), {tuple(got.shape)}: "
        f"max_abs_err {err:.3e} (tol 1e-5 x {scale:.3e})")
  if not err <= 1e-5 * scale:
    raise AssertionError("the TorchScript policy disagrees with the inference policy")
  del runner, scripted
  gc.collect()
  torch.cuda.empty_cache()

  f64_iteration_check(TASK, certain_variant, f64_seeds)
  return train_launches, steady_iter_ms


def tracking_motion_csv(path: Path, seed: int = 0) -> None:
  """A seeded synthetic motion CSV, 10 s at 30 fps (301 rows of root
  position, root quaternion wxyz and the 29 joint positions): the root at
  the keyframe height, drifting forward at 0.3 m/s and yawing at 0.2 rad/s;
  the joints at the keyframe plus sinusoids of seeded amplitude (at most
  0.3 rad), frequency and phase."""
  import numpy as np

  from mjlab_tpu_torch.assets import load_model_npz

  key = load_model_npz().key_qpos[0]
  rng = np.random.default_rng(seed)
  t = np.arange(TRACK_CSV_ROWS)[:, None] / 30.0
  yaw = 0.2 * t
  root = np.concatenate([key[0] + 0.3 * t, key[1] + 0.0 * t, key[2] + 0.0 * t], axis=-1)
  quat = np.concatenate([np.cos(yaw / 2), 0.0 * t, 0.0 * t, np.sin(yaw / 2)], axis=-1)
  amp, freq, phase = (rng.uniform(lo, hi, 29) for lo, hi in ((0.05, 0.3), (0.2, 1.0),
                                                              (0.0, 2 * np.pi)))
  joints = key[7:] + amp * np.sin(2 * np.pi * freq * t + phase)
  np.savetxt(path, np.concatenate([root, quat, joints], axis=-1), delimiter=",")


def tracking_certain_variant(cfg) -> None:
  """The G1 tracking task with every draw certain (motions start at frame
  0; zero-width RSI offsets, push velocities and push clock; fixed
  base-COM, default-joint and foot-friction offsets; no observation noise),
  so that two generators give the same rollout.
  tests/test_torch_tracking_env.py holds it against the JAX env."""
  motion = cfg.commands["motion"]
  motion.sampling_mode = "start"
  motion.pose_range = {"x": (0.02, 0.02), "y": (-0.01, -0.01), "yaw": (0.1, 0.1)}
  motion.velocity_range = {"x": (0.1, 0.1), "roll": (0.05, 0.05)}
  motion.joint_position_range = (0.03, 0.03)
  push = cfg.events["push_robot"]
  push.interval_range_s = (0.1, 0.1)
  push.params["velocity_range"] = {"x": (0.2, 0.2), "y": (-0.1, -0.1)}
  cfg.events["base_com"].params["ranges"] = {0: (0.01, 0.01), 1: (-0.02, -0.02),
                                             2: (0.03, 0.03)}
  cfg.events["add_joint_default_pos"].params["ranges"] = (0.005, 0.005)
  cfg.events["foot_friction"].params["ranges"] = (0.7, 0.7)
  cfg.observations["policy"].enable_corruption = False


def tracking_path(card: str, attr: str, checks: KernelCheck, f64_seeds=F64_SEEDS) -> dict[str, int]:
  """Phase 9: the motion-tracking task. A seeded synthetic motion CSV
  converted on the card by the port's csv_to_npz; `build_runner` of
  TRACK_TASK at NUM_WORLDS envs with that motion; the per-env body_ipos,
  qpos0 and foot friction; TRAIN_ITERS training iterations with the
  tracking checks; the iteration's split and profile; the kernels against
  their plain versions on the run's matrices; then the card's float64
  iteration against the CPU's. Returns the kernels' launches in the
  TRAIN_ITERS iterations."""
  import numpy as np

  from mjlab_tpu_torch.physics import solver
  from mjlab_tpu_torch.scripts import csv_to_npz
  from mjlab_tpu_torch.scripts.train import build_runner

  motion_dir = Path("build") / "chip_smoke"
  motion_dir.mkdir(parents=True, exist_ok=True)
  csv, npz = motion_dir / "motion.csv", motion_dir / "motion.npz"
  tracking_motion_csv(csv)
  t0 = time.perf_counter()
  arrays = csv_to_npz.process(str(csv), input_fps=30.0, output_fps=50.0, device="cuda")
  torch.cuda.synchronize()
  t_convert = time.perf_counter() - t0
  np.savez(npz, **arrays)
  frames = arrays["joint_pos"].shape[0]
  finite = all(np.isfinite(v).all() for v in arrays.values())
  root_gap = np.abs(arrays["body_pos_w"][:, 0, 2] - np.loadtxt(csv, delimiter=",")[0, 2]).max()
  print(f"phase 9 motion: {TRACK_CSV_ROWS} CSV rows at 30 fps -> {frames} frames at 50 fps "
        f"by csv_to_npz on the card in {t_convert:.2f} s; body arrays "
        f"{arrays['body_pos_w'].shape}, finite {finite}; pelvis height off the CSV's by at "
        f"most {root_gap:.2e} m [{card}]")
  if frames != TRACK_FRAMES or not finite or arrays["body_pos_w"].shape[1] != 30 or root_gap > 1e-5:
    raise AssertionError("the converted motion")

  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  runner = build_runner(TRACK_TASK, {"env.scene.num_envs": str(NUM_WORLDS),
                                     "motion_file": str(npz)})
  torch.cuda.synchronize()
  env, alg = runner.env, runner.cfg.algorithm
  cmd = env.command_manager.get_term("motion")
  print(f"phase 9 tracking path: {TRACK_TASK}, {NUM_WORLDS} envs, episodes "
        f"{env.cfg.episode_length_s} s, motion {cmd.motion.time_step_total} frames in "
        f"{cmd.bin_count} bins, obs {env.group_obs_dim}, T {runner.cfg.num_steps_per_env}, "
        f"{alg.num_learning_epochs} epochs x {alg.num_mini_batches} minibatches, hidden "
        f"{runner.cfg.policy.actor_hidden_dims}, entropy {alg.entropy_coef}; build_runner "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
  if env.group_obs_dim != {"policy": (160,), "critic": (286,)}:
    raise AssertionError(f"observation widths {env.group_obs_dim}")
  if cmd.motion.time_step_total != TRACK_FRAMES or cmd.bin_count != TRACK_BINS:
    raise AssertionError("motion frames or adaptive bins")

  # The startup randomization: per env, inside its range, on its elements only.
  mj, robot = env.sim.mj_model, env.scene["robot"]
  torso = int(robot.indexing.body_ids[robot.body_names.index("torso_link")])
  d_ipos = env.model.body_ipos.double().cpu() - torch.as_tensor(np.asarray(mj.body_ipos))
  d_q = env.model.qpos0.double().cpu() - torch.as_tensor(np.asarray(mj.qpos0))
  qa = torch.as_tensor(robot.indexing.joint_q_adr)
  fric = env.model.geom_friction.cpu()
  foot = robot.indexing.geom_ids[robot.find_geoms(r"^(left|right)_foot[1-7]_collision$")[0]]
  others = [g for g in range(fric.shape[1]) if g not in set(foot.tolist())]
  nominal = torch.as_tensor(np.asarray(mj.geom_friction), dtype=fric.dtype)
  lim = torch.tensor([0.025, 0.05, 0.05], dtype=torch.float64) + 1e-6
  print(f"  per-env body_ipos of torso_link: offset std over envs "
        f"{d_ipos[:, torso].std(0).numpy().round(4).tolist()}, max |offset| "
        f"{d_ipos[:, torso].abs().amax(0).numpy().round(4).tolist()}; qpos0 offsets on "
        f"{len(qa)} joints: std {d_q[:, qa].std().item():.4f}, max |offset| "
        f"{d_q[:, qa].abs().max().item():.4f}; foot friction mu in "
        f"[{fric[:, foot, 0].min():.3f}, {fric[:, foot, 0].max():.3f}]")
  rest = torch.ones(d_ipos.shape[1], dtype=torch.bool)
  rest[torso] = False
  free = torch.ones(d_q.shape[1], dtype=torch.bool)
  free[qa] = False
  failed = [what for what, ok in (
    ("torso body_ipos offsets inside their ranges", (d_ipos[:, torso].abs() <= lim).all()),
    ("torso body_ipos offsets differ across envs", (d_ipos[:, torso].std(0) > 0.005).all()),
    ("other bodies' body_ipos unchanged", (d_ipos[:, rest].abs() < 1e-6).all()),
    ("joint qpos0 offsets inside +-0.01", (d_q[:, qa].abs() <= 0.01 + 1e-6).all()),
    ("joint qpos0 offsets differ across envs", d_q[:, qa].std() > 0.004),
    ("free-joint qpos0 unchanged", (d_q[:, free].abs() < 1e-6).all()),
    ("14 foot geoms, mu inside [0.3, 1.2]", len(foot) == 14 and fric[:, foot, 0].min()
     >= 0.3 - 1e-6 and fric[:, foot, 0].max() <= 1.2 + 1e-6),
    ("foot mu spread across envs > 0.5",
     (fric[:, foot, 0].amax(0) - fric[:, foot, 0].amin(0)).min() > 0.5),
    ("other geoms' friction unchanged",
     torch.equal(fric[:, others], nominal[others].expand_as(fric[:, others]))),
  ) if not ok]
  if failed:
    raise AssertionError(f"per-env randomization: {failed}")

  launches, steady_iter_ms, host, split = train_iterations(runner, card, "phase 9", (160, 286))
  ts = cmd.time_steps
  failed = cmd.state["bin_failed_count"]
  print(f"  motion frames now in [{ts.min().item()}, {ts.max().item()}]; adaptive bins' "
        f"failure averages {failed.double().cpu().numpy().round(5).tolist()}; last iteration: "
        f"resets {host[-1]['Train/resets']:.0f}, sampling entropy "
        f"{host[-1]['Metrics/motion/sampling_entropy']:.4f}, anchor position error "
        f"{host[-1]['Metrics/motion/error_anchor_pos']:.4f} (sums over resetting envs)")
  if not (ts.min() >= 0 and ts.max() < TRACK_FRAMES):
    raise AssertionError("motion frames outside [0, TRACK_FRAMES)")
  if sum(m["Train/resets"] for m in host) > 0 and not failed.sum() > 0:
    raise AssertionError("envs terminated, but no adaptive bin counts a failure")
  if not sum(m["Train/resets"] for m in host) > 0:
    raise AssertionError("no env terminated in the tracking iterations")
  # Device-only (no split by span: phase 8 splits the same runner code).
  profile_iteration(runner, card, attr, "tracking", steady_iter_ms, split, spans=False)
  del split

  print("  kernels vs plain on the tracking run's matrices, f32:")
  d = env.data
  grad = torch.randn(NUM_WORLDS, N, generator=torch.Generator(device="cuda").manual_seed(9),
                     device="cuda")
  checks.all_three("tracking qM", d.qM.contiguous(), d.qfrc_smooth.contiguous())
  checks.all_three("tracking H", solver.hessian(d, d.qacc).contiguous(), grad)
  w = solver.newton_weights(d, d.qacc)
  checks.newton("tracking qM,J,w", d.qM, d.efc_J, w, grad)
  print(f"  active Newton rows share on the tracking state {(w != 0).float().mean().item():.4f}")
  del runner, env, cmd, d, w, grad, robot
  gc.collect()
  torch.cuda.empty_cache()

  f64_iteration_check(TRACK_TASK, tracking_certain_variant, f64_seeds,
                      {"commands.motion.motion_file": str(npz)})
  return launches


def lifecycle_path(card: str, checks: KernelCheck, steady_iter_ms: float) -> dict[str, int]:
  """Phase 10: a training run's lifecycle on G1 velocity-flat at NUM_WORLDS
  envs, f32, in build/chip_smoke/run, through the entry points a user
  calls: `run_train` for 2 iterations with a checkpoint after each, then
  `run_train --agent.resume true` for 1 iteration with no periodic save
  (the iteration neither logs nor saves), `run_play --policy trained` on the
  final checkpoint (EARLY_PLAY_STEPS), `run_joint_deltas` on it (JOINT_DELTA_STEPS), the NaN
  guard on the play env and the ONNX export. Both `learn`s run under
  set_sync_debug_mode("error") but for `_pull_metrics` and `save`, which are
  timed (after a synchronize, so that the device's queued work is not in
  their time). Checks the files and labels, the resumed learner against the
  saved arrays, the card's play actions against the exported TorchScript
  policy on the CPU (1e-5 relative), the kernels against their plain
  versions on the play env's matrices, and that the guard dumps exactly the
  poisoned envs. Returns the kernels' launches over the whole phase."""
  import shutil

  import numpy as np

  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.physics import solver
  from mjlab_tpu_torch.rl.exporter import export_policy_as_onnx
  from mjlab_tpu_torch.rl.onnx_policy import TorchScriptPolicy
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner, runner_state_to_arrays
  from mjlab_tpu_torch.scripts.joint_deltas import run_joint_deltas
  from mjlab_tpu_torch.scripts.play import run_play
  from mjlab_tpu_torch.scripts.train import run_train
  from mjlab_tpu_torch.utils.nan_guard import NanGuard, NanGuardCfg

  gc.collect()
  torch.cuda.empty_cache()
  run_dir = Path("build") / "chip_smoke" / "run"
  shutil.rmtree(run_dir, ignore_errors=True)
  base = {"env.scene.num_envs": str(NUM_WORLDS), "log_dir": str(run_dir)}
  spent: dict[str, list[float]] = {"save": [], "_pull_metrics": [], "learn": []}
  loaded: list[tuple[str, dict, int]] = []
  originals = {k: getattr(OnPolicyRunner, k) for k in ("save", "_pull_metrics", "learn", "load")}

  def lifted(name):
    def call(self, *args, **kwargs):
      mode = torch.cuda.get_sync_debug_mode()
      torch.cuda.set_sync_debug_mode("default")
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = originals[name](self, *args, **kwargs)
      spent[name].append(time.perf_counter() - t0)
      torch.cuda.set_sync_debug_mode(mode)
      return out
    return call

  def strict_learn(self, *args, **kwargs):
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
      originals["learn"](self, *args, **kwargs)
    finally:
      torch.cuda.set_sync_debug_mode("default")
    spent["learn"].append(time.perf_counter() - t0)

  def recording_load(self, path):
    originals["load"](self, path)
    loaded.append((path, runner_state_to_arrays(self), self.iteration))

  chol.reset_counts()
  t_phase = time.perf_counter()
  OnPolicyRunner.save, OnPolicyRunner._pull_metrics = lifted("save"), lifted("_pull_metrics")
  OnPolicyRunner.learn, OnPolicyRunner.load = strict_learn, recording_load
  try:
    t0 = time.perf_counter()
    runner = run_train(TASK, {**base, "agent.max_iterations": "2", "agent.save_interval": "1"})
    t_train = time.perf_counter() - t0
    files = sorted(p.name for p in run_dir.iterdir())
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    learn_ms = 1e3 * spent["learn"][0] / 2
    saves = [1e3 * x for x in spent["save"]]  # model_0, model_1 in learn; model_2 after it
    pull_ms = 1e3 * sum(spent["_pull_metrics"])
    over = (f"{learn_ms / steady_iter_ms - 1:+.4f} over phase 8's steady train_iteration "
            f"{steady_iter_ms:.2f} ms")
    print(f"phase 10 run lifecycle: {TASK}, {NUM_WORLDS} envs, f32, in {run_dir} [{card}]")
    alone_ms = learn_ms - (sum(saves[:2]) + pull_ms) / 2
    print(f"  train: run_train, 2 iterations, save_interval 1, in {t_train:.2f} s; learn "
          f"{learn_ms:.2f} ms per iteration, {over}; without its saves and pulls "
          f"{alone_ms:.2f} ms; saves (checkpoint + TorchScript) "
          f"{', '.join(f'{x:.2f}' for x in saves)} ms; metric pulls {len(spent['_pull_metrics'])} "
          f"in {pull_ms:.3f} ms, {pull_ms / (2 * learn_ms):.6f} of the iterations' time")
    print(f"  files written: {files}")
    print(f"  metrics.jsonl iterations {[x['iteration'] for x in lines]}")
    want = ["agent_cfg.yaml", "final_metrics.json", "metrics.jsonl"] + [
      f"model_{k}{s}.pt" for k in range(3) for s in ("", "_policy")]
    if files != sorted(want) or [x["iteration"] for x in lines] != [0, 1]:
      raise AssertionError("phase 10: the training run's files or labels")
    del runner
    gc.collect()
    torch.cuda.empty_cache()

    n_saves = len(spent["save"])
    t0 = time.perf_counter()
    runner = run_train(TASK, {**base, "agent.max_iterations": "1", "agent.save_interval": "0",
                              "agent.resume": "true"})
    t_resume = time.perf_counter() - t0
    path, state, it = loaded[-1]
    saved = torch.load(path)["state"]
    same = sorted(state) == sorted(saved) and all(np.array_equal(state[k], saved[k].numpy())
                                                  for k in saved)
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    print(f"  resume: run_train --agent.resume true, 1 iteration, save_interval 0, in "
          f"{t_resume:.2f} s: loaded {path} (iteration {it}); learner equal to its {len(saved)} "
          f"saved arrays before the first update: {same}; went on at label "
          f"{lines[-1]['iteration']}, saved model_{runner.iteration}.pt; its iteration neither "
          f"logged nor saved and ran under set_sync_debug_mode('error'): no host sync; learn "
          f"{1e3 * spent['learn'][-1]:.2f} ms")
    if (Path(path).name != "model_2.pt" or it != 2 or not same or lines[-1]["iteration"] != 2
        or runner.iteration != 3 or len(spent["save"]) != n_saves + 1):
      raise AssertionError("phase 10: the resumed run")
    onnx = export_policy_as_onnx(runner, runner.env, str(run_dir / "policy.onnx"))
    del runner
    gc.collect()
    torch.cuda.empty_cache()
  finally:
    for k, v in originals.items():
      setattr(OnPolicyRunner, k, v)
    torch.cuda.set_sync_debug_mode("default")

  ckpt = run_dir / "model_3.pt"
  res = run_play(TASK, {"checkpoint": str(ckpt), "num_envs": str(NUM_WORLDS),
                        "steps": str(EARLY_PLAY_STEPS)})
  env = res.env
  got = res.policy(res.obs).cpu().numpy()
  want = TorchScriptPolicy(str(run_dir / "model_3_policy.pt"))(
    res.obs["policy"].to(torch.float32).cpu().numpy())
  err = float(np.abs(got - want).max())
  scale = max(1.0, float(np.abs(want).max()))
  print(f"  play: run_play --policy trained, {NUM_WORLDS} envs, {EARLY_PLAY_STEPS} steps: "
        f"{1e3 * res.seconds / EARLY_PLAY_STEPS:.2f} ms per play step, mean reward per step "
        f"{res.mean_reward:.6f}, base z in [{res.base_z.min():.3f}, {res.base_z.max():.3f}]; "
        f"the card's actions vs TorchScriptPolicy on the CPU {got.shape}: max_abs_err "
        f"{err:.3e} (tol 1e-5 x {scale:.3e}) [{card}]")
  if not (err <= 1e-5 * scale and np.isfinite(res.mean_reward) and np.isfinite(res.base_z).all()):
    raise AssertionError("phase 10: play")
  print("  kernels vs plain on the play env's matrices, f32:")
  before = dict(chol.LAUNCHES)  # the comparison's launches do not count as the path's
  d = env.data
  dev = d.qM.device
  grad = torch.randn(NUM_WORLDS, N, generator=torch.Generator(device=dev).manual_seed(10),
                     device=dev)
  checks.all_three("play qM", d.qM.contiguous(), d.qfrc_smooth.contiguous())
  checks.newton("play qM,J,w", d.qM, d.efc_J, solver.newton_weights(d, d.qacc), grad)
  compared = {k: chol.LAUNCHES[k] - before[k] for k in before}

  guard = NanGuard(NanGuardCfg(enabled=True, output_dir=str(run_dir / "nan_dumps")), env)
  watch_ms = []
  for _ in range(5):
    t0 = time.perf_counter()
    if guard.watch():
      raise AssertionError("phase 10: the guard fired on a healthy state")
    watch_ms.append(1e3 * (time.perf_counter() - t0))
  poisoned = [NUM_WORLDS // 3, NUM_WORLDS - 1]
  env.data.qpos[poisoned, 0] = float("nan")
  fired = guard.watch()
  dump = (run_dir / "nan_dumps" / "latest").resolve()
  dumped = sorted(p.name for p in dump.glob("env_*.npz")) if fired else []
  model_same = fired and all(
    np.array_equal(a, b) for a, b in zip(
      assets.model_arrays(assets.load_model_npz(dump / "model.npz")).values(),
      assets.model_arrays(env.sim.mj_model).values()))
  print(f"  NaN guard at {NUM_WORLDS} envs: {np.mean(watch_ms[1:]):.3f} ms per watch() "
        f"(calls {', '.join(f'{x:.3f}' for x in watch_ms)}) [{card}]; NaN in envs {poisoned}: "
        f"fired {fired}, dumped {dumped} to {dump}, model.npz equal to the env's: {model_same}")
  if not fired or dumped != [f"env_{i}.npz" for i in poisoned] or not model_same:
    raise AssertionError("phase 10: the NaN guard's dump")
  del res, env, d, guard
  gc.collect()
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  table = run_joint_deltas(TASK, {"checkpoint": str(ckpt), "num_envs": str(NUM_WORLDS),
                                  "steps": str(JOINT_DELTA_STEPS)})
  print(f"  joint_deltas: {NUM_WORLDS} envs, {JOINT_DELTA_STEPS} steps, "
        f"{time.perf_counter() - t0:.2f} s with the "
        f"env's build")
  if len(table.splitlines()) != 4 + 29 + 1:
    raise AssertionError("phase 10: the joint_deltas table")
  print(f"  ONNX: export_policy_as_onnx returned {onnx!r}")
  gc.collect()
  torch.cuda.empty_cache()
  launches = {k: v - compared[k] for k, v in chol.LAUNCHES.items()}
  print(f"  phase 10 in {time.perf_counter() - t_phase:.1f} s; launches {launches}")
  if any(launches[k] == 0 for k in KERNELS):
    raise AssertionError(f"phase 10: a kernel was not launched: {launches}")
  return launches


# Phase 14's cells: G1 under the elliptic cone and under CG, and the solver
# surface's scenes (mjlab_tpu_torch/assets/solver_scenes.py).
ELLIPTIC_NEFC = 1320  # 29 limit rows + 154 condim-1 rows + 379 cone slots x 3
CG_STEPS = 10  # env steps of G1 under CG
SCENE_SUBSTEPS = 30  # cut from 50 to keep the script under 1000 s
SCENE_CPU_WORLDS = 16  # the first worlds of the card's run, rerun on the CPU
# The scenes run a small solver budget on both sides: they are launch-bound
# (the compiled defaults, 100 iterations x 50 linesearch steps, launch ~250x
# more), and the card-vs-CPU check needs no converged solve.
SCENE_ITERATIONS, SCENE_LS_ITERATIONS = 4, 5
# Qpos nudges of phase 14's card-vs-CPU env checks (6 in phases 11-13): a
# CPU elliptic env step takes ~2.5 s, and G1 sits far inside 1e-8 there.
PHASE14_NUDGES = 2


def newton_launch(cone: bool, dtype: torch.dtype, batch: int, n: int, m: int,
                  ncone: int = 0, nb: int = 0) -> dict:
  """The launch csrc/newton_dir.cu makes for these shapes (its
  `newton_direction_config`, which launches nothing): warps per block,
  resident worlds per SM (warps per block × resident blocks), shared bytes
  per warp, registers and local bytes per thread; beside them the ptxas
  lines of that kernel instance from this process's build log."""
  import ctypes

  from mjlab_tpu_torch.kernels import build

  f = build.library("newton_dir").newton_direction_config
  f.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
  f.restype = ctypes.c_int
  out = (ctypes.c_int * 8)()
  elem = torch.empty((), dtype=dtype).element_size()
  rc = f(int(cone), elem, batch, n, m, ncone, nb, ctypes.cast(out, ctypes.c_void_p))
  if rc != 0:
    raise AssertionError(f"newton_direction_config failed with CUDA error {rc}")
  keys = ("warps_per_block", "blocks_per_sm", "sms", "grid_blocks", "smem_bytes_per_warp",
          "registers", "local_bytes", "N")
  cfg = dict(zip(keys, out))
  cfg["resident_worlds_per_sm"] = cfg["warps_per_block"] * cfg["blocks_per_sm"]
  # The instance's mangled name: newton_direction_kernel<T, N, kPad, kCone>.
  tag = (f"newton_direction_kernelI{'f' if elem == 4 else 'd'}Li{cfg['N']}ELb"
         f"{int(cfg['N'] != 35)}ELb{int(cone)}E")
  fn, ptxas = None, []
  for line in build.build_log.get("newton_dir", "").splitlines():
    if "Compiling entry function" in line or "Function properties for" in line:
      fn = line
    elif fn is not None and tag in fn and ("registers" in line or "spill" in line):
      ptxas.append(line.split(":", 1)[-1].strip())
  cfg["ptxas"] = "; ".join(ptxas) or "not in this process's build log"
  return cfg


def print_launch(name: str, what: str, cfg: dict) -> None:
  print(f"  {name} launch ({what}): {cfg['warps_per_block']} warps per block, "
        f"{cfg['blocks_per_sm']} blocks = {cfg['resident_worlds_per_sm']} resident worlds per "
        f"SM on {cfg['sms']} SMs, grid {cfg['grid_blocks']} blocks; "
        f"{cfg['smem_bytes_per_warp']} B shared per warp, {cfg['registers']} registers and "
        f"{cfg['local_bytes']} B local per thread; ptxas: {cfg['ptxas']}")


def cone_bound(batch: int, n: int, nefc: int, rows: int, cone_rows: int, nb: int,
               elem: int = 4) -> tuple[float, str]:
  """Least time (ms) of newton_direction_cone on these inputs: bytes of the
  active regular rows and the active cone slots' rows of J, w and the
  packed blocks (every world), qM's lower triangle, grad and x; operations
  2 per row and lower entry of H (a cone row adds its virtual row, 2 cd
  per element, cd = 3), then the factor and solves."""
  tri, vec = batch * n * (n + 1) // 2 * elem, batch * n * elem
  byt = (rows + cone_rows) * n * elem + batch * (nefc + nb) * elem + tri + 2 * vec
  flop = (rows + cone_rows) * n * (n + 1) + cone_rows * 6 * n + batch * (n**3 / 3 + 2 * n * n)
  tb, tf = byt / PEAK_BYTES * 1e3, flop / PEAK_F32 * 1e3
  return max(tb, tf), ("bytes" if tb >= tf else "operations")


def elliptic_path(card: str, attr: str, checks: KernelCheck) -> dict:
  """Phase 14, part 1: G1 velocity-flat under cone="elliptic" trains
  (CUT_ITERS iteration at 4096 envs through build_runner, the CLI's
  override; cut from 2), with
  phase 8's checks, a device-only profile, nefc 1320 and every Newton
  direction through newton_direction_cone; then the kernel against its
  plain version on the run's last matrices (f32 and f64), its times, and
  the card's float64 env against the CPU's. Returns the launches and the
  kernel's numbers for the JSON line."""
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.physics import solver
  from mjlab_tpu_torch.scripts.train import build_runner

  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  over = {"env.scene.num_envs": str(NUM_WORLDS), "env.sim.mujoco.cone": "elliptic"}
  runner = build_runner(TASK, over)
  torch.cuda.synchronize()
  env, tp = runner.env, runner.env.tp
  layout = tp.dev.con.cone_kernel_layout
  print(f"phase 14 elliptic: {TASK} --env.sim.mujoco.cone elliptic (impratio "
        f"{env.sim.model.opt.impratio.item()}), {NUM_WORLDS} envs, nv {tp.nv}, Newton rows "
        f"{tp.nefc}, cone slots {layout.table.shape[0]} in groups {layout.groups}, obs "
        f"{env.group_obs_dim}; build_runner {time.perf_counter() - t0:.2f} s [{card}]")
  if tp.nefc != ELLIPTIC_NEFC or env.group_obs_dim != {"policy": (99,), "critic": (111,)}:
    raise AssertionError(f"phase 14 elliptic: nefc {tp.nefc}, obs {env.group_obs_dim}")
  got, steady_iter_ms, _, split = train_iterations(
    runner, card, "phase 14 elliptic", (99, 111), iters=CUT_ITERS,
    expect=KERNELS[:3] + (CONE_KERNEL,))
  it = env.sim.model.opt.iterations
  per_iter = TRAIN_STEPS * (DECIMATION * it + it)
  print(f"  {CONE_KERNEL} launches {got[CONE_KERNEL]} = {got[CONE_KERNEL] / CUT_ITERS:.0f} "
        f"per iteration (expected {per_iter}: 24 env steps x (4 substeps + the post-reset "
        f"forward) x {it}); newton_direction {got['newton_direction']}")
  if got[CONE_KERNEL] != per_iter * CUT_ITERS or got["newton_direction"] != 0:
    raise AssertionError(f"phase 14 elliptic: launches {got}")
  profile_iteration(runner, card, attr, "g1_elliptic", steady_iter_ms, split, spans=False)
  del split

  d, n = env.data, tp.nv
  gen = solver.GeneralCost(tp, env.sim.model, d)
  r = gen.residual(d.qacc)
  w, Bc = gen.row_hess(r), gen.cone_blocks(r)
  grad = torch.randn(NUM_WORLDS, n, generator=torch.Generator(device="cuda").manual_seed(14),
                     device="cuda")
  args = (d.qM.contiguous(), d.efc_J.contiguous(), w.contiguous(), grad, Bc.contiguous())
  args64 = tuple(a.double() for a in args)
  x64 = chol.newton_direction_cone_plain(*args64, layout)
  checks.check(CONE_KERNEL, "g1 elliptic", chol.newton_direction_cone(*args, layout),
               chol.newton_direction_cone_plain(*args, layout), x64)
  got64 = chol.newton_direction_cone(*args64, layout)
  err64 = (got64 - x64).abs().max().item()
  scale64 = max(1.0, x64.abs().max().item())
  print(f"  {CONE_KERNEL} f64 on the run's matrices: max_abs_err {err64:.3e} "
        f"(tol 1e-10 x {scale64:.3e})")
  if not err64 <= 1e-10 * scale64:
    raise AssertionError(f"{CONE_KERNEL} f64: {err64:.3e}")
  rows = int((w != 0).sum().item())
  active_slots = (Bc.reshape(NUM_WORLDS, -1, 9) != 0).any(-1)
  cone_rows = 3 * int(active_slots.sum().item())
  zones = {}
  for g in gen.groups:
    N, _, _, top, bottom, _ = gen.zones(g, r[:, g.rows])
    act = g.active
    zones = {"top": int((top & act).sum()), "middle": int((~top & ~bottom & act).sum()),
             "bottom": int((bottom & ~top & act).sum()), "inactive": int((~act).sum())}
  per_world = active_slots.sum(1).float()
  print(f"  the run's last state: active regular rows {rows} "
        f"({rows / (NUM_WORLDS * tp.nefc):.4f} of all rows), cone slots by zone {zones}; "
        f"active cone slots per world mean {per_world.mean().item():.2f}, min "
        f"{int(per_world.min().item())}, max {int(per_world.max().item())}")
  launch = newton_launch(True, torch.float32, NUM_WORLDS, n, tp.nefc, layout.table.shape[0],
                         layout.nb)
  print_launch(CONE_KERNEL, "the run's, f32", launch)
  print_launch(CONE_KERNEL, "the run's, f64",
               newton_launch(True, torch.float64, NUM_WORLDS, n, tp.nefc,
                             layout.table.shape[0], layout.nb))
  qM, J = args[0], args[1]
  ms = time_ms(lambda: chol.newton_direction_cone(*args, layout), [()])
  plain_ms = time_ms(lambda: chol.newton_direction_cone_plain(*args, layout), [()], iters=3)
  lib_ms = time_ms(lambda: torch.cholesky_solve(
    grad[..., None], torch.linalg.cholesky_ex(chol.cone_matrix(*args[:3], Bc, layout))[0]),
    [()], iters=5)
  bnd = cone_bound(NUM_WORLDS, n, tp.nefc, rows, cone_rows, layout.nb)
  print(f"  {CONE_KERNEL} on the run's matrices: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"library (einsum + cholesky_ex + cholesky_solve) {lib_ms:.4f} ms  bound "
        f"{bnd[0]:.6f} ms ({bnd[1]}) [{card}]")
  del runner, env, d, gen, r, w, Bc, args, args64, x64, got64, qM, J
  gc.collect()
  torch.cuda.empty_cache()
  f64_env_check(TASK, n_steps=CUT_F64_STEPS, nudges=PHASE14_NUDGES,
                overrides={"sim.mujoco.cone": "elliptic"})
  return {"launches": got, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound": bnd, "steady_iter_ms": steady_iter_ms, "launch": launch}


def cg_path(card: str) -> dict[str, int]:
  """Phase 14, part 2: G1 velocity-flat under solver="cg", 10 env steps of
  N(0, 1) actions at 4096 envs under set_sync_debug_mode("error"): ms per
  env step, and the Cholesky launches per env step against the code's count
  (per forward, M's factor and CG's factor of M + 1e-12·I, M's solve for
  qacc_smooth and CG's 1 + iterations solves; 4 substeps and the post-reset
  forward, and the integrator's factor-solve per substep); then the card's
  float64 env against the CPU's."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.scripts.cli import apply_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg

  gc.collect()
  torch.cuda.empty_cache()
  cfg = load_env_cfg(TASK)
  apply_overrides(cfg, {"scene.num_envs": str(NUM_WORLDS), "sim.mujoco.solver": "cg"})
  env = ManagerBasedRlEnv(cfg, device="cuda")
  env.reset(seed=0)
  it = env.sim.model.opt.iterations
  forwards = DECIMATION + 1
  want = {"chol_factor": 2 * forwards, "chol_solve": (2 + it) * forwards,
          "chol_factor_solve": DECIMATION, "newton_direction": 0, CONE_KERNEL: 0}
  gen = torch.Generator(device="cuda").manual_seed(3)
  actions = [torch.randn(NUM_WORLDS, env.total_action_dim, generator=gen, device="cuda")
             for _ in range(CG_STEPS)]
  env.step(actions[0])
  torch.cuda.synchronize()
  chol.reset_counts()
  torch.cuda.set_sync_debug_mode("error")
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  start.record()
  for a in actions[1:]:
    obs, rew, *_ = env.step(a)
  end.record()
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  steps = CG_STEPS - 1
  launches = dict(chol.LAUNCHES)
  print(f"phase 14 cg: {TASK} --env.sim.mujoco.solver cg ({it} iterations), {NUM_WORLDS} "
        f"envs, {steps} env steps after one warm-up under set_sync_debug_mode('error'): "
        f"{start.elapsed_time(end) / steps:.2f} ms per env step [{card}]")
  print(f"  launches per env step " + ", ".join(f"{k} {v / steps:g}" for k, v in launches.items())
        + f"; from the code: {want}")
  if any(launches[k] != v * steps for k, v in want.items()):
    raise AssertionError(f"phase 14 cg: launches {launches}, expected {want} per env step")
  for x in (obs["policy"], obs["critic"], rew, env.data.qpos):
    if not torch.isfinite(x).all():
      raise AssertionError("phase 14 cg: non-finite state")
  del env, obs, rew, actions
  gc.collect()
  torch.cuda.empty_cache()
  f64_env_check(TASK, n_steps=CUT_F64_STEPS, nudges=PHASE14_NUDGES,
                overrides={"sim.mujoco.solver": "cg"})
  return launches


def scenes_path(card: str) -> dict[str, int]:
  """Phase 14, part 3: each scene of assets/solver_scenes.py under each of
  its cones, float64, SCENE_SUBSTEPS at 4096 worlds from the scene's velocity
  plus a seeded N(0, 0.05²) per world, through physics.step (ms per
  substep, CUDA events); then the first 16 worlds rerun on the CPU (plain
  versions), qpos and qvel within 1e-8 relative to max(1, max |CPU|), or
  twice the CPU's own spread under 2 qpos nudges of 1e-13 where that is
  larger."""
  from mjlab_tpu_torch import physics
  from mjlab_tpu_torch.assets import solver_scenes
  from mjlab_tpu_torch.kernels import chol

  torch.set_num_threads(1)
  total = {k: 0 for k in ALL_KERNELS}
  print(f"phase 14 scenes: {SCENE_SUBSTEPS} substeps at {NUM_WORLDS} worlds, float64, "
        f"{SCENE_ITERATIONS} iterations x {SCENE_LS_ITERATIONS} linesearch steps; the first "
        f"{SCENE_CPU_WORLDS} worlds against the CPU (tol 1e-8) [{card}]")
  def cpu_run(tp, m, qpos, qvel):
    d = physics.make_data(tp, m, SCENE_CPU_WORLDS).replace(qpos=qpos, qvel=qvel)
    for _ in range(SCENE_SUBSTEPS):
      d = physics.step(tp, m, d)
    return d

  def rel(a, b):
    return max((getattr(a, f) - getattr(b, f)).abs().max().item()
               / max(1.0, getattr(b, f).abs().max().item()) for f in ("qpos", "qvel"))

  for name, sc in solver_scenes.SCENES.items():
    for cone in sc.cones:
      models = {}
      for dv in ("cuda", "cpu"):
        mjm = solver_scenes.load(name, cone)
        mjm.opt.iterations, mjm.opt.ls_iterations = SCENE_ITERATIONS, SCENE_LS_ITERATIONS
        models[dv] = physics.put_model(mjm, dtype=torch.float64, device=dv)
      tp, m = models["cuda"]
      rng = torch.Generator().manual_seed(5)
      qvel = torch.zeros(NUM_WORLDS, tp.nv, dtype=torch.float64)
      qvel[:, :len(sc.qvel)] = torch.tensor(sc.qvel, dtype=torch.float64)
      qvel += 0.05 * torch.randn(NUM_WORLDS, tp.nv, generator=rng, dtype=torch.float64)
      d = physics.make_data(tp, m, NUM_WORLDS).replace(qvel=qvel.cuda())
      chol.reset_counts()
      d = physics.step(tp, m, d)
      torch.cuda.synchronize()
      start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(SCENE_SUBSTEPS - 1):
        d = physics.step(tp, m, d)
      end.record()
      torch.cuda.synchronize()
      launched = {k: v for k, v in chol.LAUNCHES.items() if v}
      for k, v in chol.LAUNCHES.items():
        total[k] += v
      if not (torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()):
        raise AssertionError(f"phase 14 scene {name} (cone {cone}): non-finite state")
      tp_c, m_c = models["cpu"]
      q0 = physics.make_data(tp_c, m_c, SCENE_CPU_WORLDS).qpos
      v0 = qvel[:SCENE_CPU_WORLDS]
      ref = cpu_run(tp_c, m_c, q0, v0)
      card = SimpleNamespace(qpos=d.qpos[:SCENE_CPU_WORLDS].cpu(), qvel=d.qvel[:SCENE_CPU_WORLDS].cpu())
      err, tol, spread = rel(card, ref), 1e-8, None
      if err > tol:
        # A scene whose motion amplifies rounding (CG's unconverged steps on
        # a tumbling box): held to twice the CPU's own spread under 2 qpos
        # nudges of 1e-13 instead, as phases 11-13 hold their env steps.
        spread = max(
          rel(cpu_run(tp_c, m_c, q0 * (1 + 1e-13 * torch.randn(q0.shape, generator=rng,
                                                                 dtype=torch.float64)), v0), ref)
          for _ in range(2))
        tol = max(tol, 2 * spread)
      print(f"  {name:22s} cone {cone} nefc {tp.nefc:3d}: "
            f"{start.elapsed_time(end) / (SCENE_SUBSTEPS - 1):.3f} ms per substep; card vs CPU "
            f"{err:.3e} (tol {tol:.3e}" + (f", CPU spread {spread:.3e}" if spread is not None else "")
            + f"); launches {launched}")
      if not err <= tol:
        raise AssertionError(f"phase 14 scene {name} (cone {cone}): card vs CPU {err:.3e}")
  return total


def surface_path(card: str, attr: str, checks: KernelCheck, train_launches: dict,
                 steady_iter_ms: float) -> dict[str, int]:
  """Phase 15: the env-layer surface a user sets in their own cfg. The
  sim-to-real cfg (`sim_to_real_edit` on the G1 velocity-flat cfg) is
  registered as a task of its own and trained through `build_runner` at
  NUM_WORLDS envs with the G1 PPO cfg: 2 iterations with phase 8's checks,
  the policy obs 3 x 99 wide, each randomized leaf changed per env on its
  elements only and inside its range, the launches equal to phase 8's,
  the iteration's time against phase 8's in this call, a device-only
  profile; the four kernels against their plain versions on this run's
  per-env matrices (qM, the Newton matrix and direction, the implicitfast
  matrix); the card's float64 env against the CPU's with every FIELD_SPECS
  row randomized (`all_fields_variant`), 4 envs x 8 env steps, the CPU's
  leaves handed to the card. Returns the iterations' launches."""
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.envs.mdp.events import FIELD_SPECS
  from mjlab_tpu_torch.physics import solver
  from mjlab_tpu_torch.physics.forward import _implicit_matrix
  from mjlab_tpu_torch.scripts.train import build_runner

  def surface_cfg():
    cfg = tasks.load_env_cfg(TASK)
    sim_to_real_edit(cfg)
    return cfg

  tasks.register(SURFACE_TASK, surface_cfg, lambda: tasks.load_rl_cfg(TASK))
  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  runner = build_runner(SURFACE_TASK, {"env.scene.num_envs": str(NUM_WORLDS)})
  torch.cuda.synchronize()
  env = runner.env
  dims = (SURFACE_HISTORY * 99, 111)
  print(f"phase 15 the user surface: {SURFACE_TASK} (the G1 velocity-flat cfg with "
        f"sim_to_real_edit), {NUM_WORLDS} envs, per-env fields "
        f"{sorted(env.sim.batched_fields)}, obs {env.group_obs_dim}; build_runner "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
  if env.group_obs_dim != {"policy": (dims[0],), "critic": (dims[1],)}:
    raise AssertionError(f"phase 15: observation widths {env.group_obs_dim}")
  spreads = surface_leaf_checks(env)
  print("  randomized leaves on their elements only, inside their ranges; least spread "
        "across envs: " + ", ".join(f"{k} {v:.4g}" for k, v in spreads.items()))
  # The cfg's first push falls after 1-3 s (50 env steps or more), past the
  # run's 2 x TRAIN_STEPS: start every env's push clock so that it fires in
  # the timed second iteration, at its 12th env step.
  clock = env.ns("event")["interval_time_left"]
  clock["push_wrench"] = torch.full_like(clock["push_wrench"],
                                         (1.5 * TRAIN_STEPS - 0.5) * env.step_dt)
  got, iter_ms, _, split = train_iterations(runner, card, "phase 15", dims)
  print(f"  steady ms per iteration {iter_ms:.2f} against phase 8's {steady_iter_ms:.2f} in "
        f"this call: {100 * (iter_ms / steady_iter_ms - 1):+.2f}% [{card}]")
  if any(got[k] != train_launches[k] for k in KERNELS):
    raise AssertionError(f"phase 15: launches {got} differ from phase 8's {train_launches}")
  profile_iteration(runner, card, attr, "surface", iter_ms, split, spans=False)
  del split
  d, tp = env.data, env.tp
  lags = env.ns("observation")["delay"]["policy/joint_vel"]["lags"]
  bias = env.ns("observation")["noise"]["policy/joint_pos"]["bias"]
  world = env.scene["feet_ground_world"].data
  finite = all(torch.isfinite(getattr(world, f)).all() for f in
               ("force", "torque", "dist", "pos", "normal", "tangent"))
  pushed = (d.xfrc_applied.abs().amax((1, 2)) > 0).sum().item()
  print(f"  joint_vel lags per env: {torch.bincount(lags.long(), minlength=3).tolist()} at 0, "
        f"1, 2; joint_pos bias in [{bias.min().item():.4f}, {bias.max().item():.4f}]; "
        f"envs holding a push's wrench after the run {pushed} of {NUM_WORLDS}; world-frame "
        f"foot contacts {world.found.sum().item():.0f}, finite {finite}")
  if not (finite and lags.max() <= 2 and bias.abs().max() <= 0.02 + 1e-6
          and len(lags.unique()) == 3 and pushed > 0):
    raise AssertionError("phase 15: delay lags, bias, the push or the world-frame sensor")
  print(f"  kernels vs plain on the run's per-env matrices, f32 (n = {tp.nv}):")
  grad = torch.randn(NUM_WORLDS, tp.nv, generator=torch.Generator(device="cuda").manual_seed(15),
                     device="cuda")
  checks.all_three("surface qM", d.qM.contiguous(), d.qfrc_smooth.contiguous())
  checks.all_three("surface H", solver.hessian(d, d.qacc).contiguous(), grad)
  checks.all_three("surface implicit",
                   _implicit_matrix(tp, env.model, d).contiguous(), grad)
  checks.newton("surface qM,J,w", d.qM, d.efc_J, solver.newton_weights(d, d.qacc), grad)
  del runner, env, d, world
  gc.collect()
  torch.cuda.empty_cache()
  def every_field_per_env(env_, action) -> float:
    """After each card step: all 19 FIELD_SPECS leaves are per env and each
    env's differs from env 0's."""
    for f in FIELD_SPECS:
      leaf = getattr(env_.model, f)
      if f not in env_.sim.batched_fields or not (leaf[1:] != leaf[:1]).flatten(1).any(1).all():
        raise AssertionError(f"phase 15 f64 check: {f} is not different in every env")
    return 0.0

  f64_env_check(SURFACE_TASK, n_steps=8, nudges=2, variant=all_fields_variant,
                on_step=every_field_per_env)
  print("  every FIELD_SPECS row per env in the f64 check: " + ", ".join(sorted(FIELD_SPECS)))
  return got


def main() -> int:
  parser = argparse.ArgumentParser(description="Drive the PyTorch port on one CUDA card.")
  parser.add_argument("--f64-seeds", default=",".join(map(str, F64_SEEDS)),
                      help="seeds of the draws for phase 8's card-vs-CPU float64 "
                           "iteration, comma-separated (default %(default)s)")
  args = parser.parse_args()
  f64_seeds = [int(x) for x in args.f64_seeds.split(",")]
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; nothing run",
          file=sys.stderr)
    return 2
  from mjlab_tpu_torch.assets import g1_velocity_sim_cfg, load_model_npz
  from mjlab_tpu_torch.kernels import build, chol
  from mjlab_tpu_torch.physics import solver
  from mjlab_tpu_torch.sim import Simulation

  OUT.mkdir(exist_ok=True)
  clock = PhaseClock()
  card = card_line()
  print(card)
  print(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  # -- 1. build ----------------------------------------------------------------
  t0 = time.perf_counter()
  build.build_all()
  print(f"phase 1 build: {time.perf_counter() - t0:.2f} s for {list(build.SOURCES)}")
  for name, log in build.build_log.items():
    for line in log.splitlines():
      if "registers" in line or "spill" in line:
        print(f"  ptxas {name}: {line.strip()}")
  clock.done(1)
  # -- 2. kernels against plain versions, and their times ---------------------
  gen = torch.Generator(device="cuda").manual_seed(0)
  A = spd_batch(gen, NUM_WORLDS, N, torch.float32)
  b = torch.randn(NUM_WORLDS, N, generator=gen, device="cuda")
  checks = KernelCheck()
  print(f"phase 2 kernels vs plain, f32 ({NUM_WORLDS}, {N}, {N}):")
  checks.all_three("random SPD", A, b)
  # Timing inputs: HBM_SETS distinct batches (each A is 20 MB) so that the
  # set exceeds the 50 MB L2 and every call reads from HBM; the L2-resident
  # time (one batch, called again and again) is printed beside it.
  sets = [(A, b, chol.chol_factor(A))]
  for _ in range(HBM_SETS - 1):
    A_ = spd_batch(gen, NUM_WORLDS, N, torch.float32)
    b_ = torch.randn(NUM_WORLDS, N, generator=gen, device="cuda")
    sets.append((A_, b_, chol.chol_factor(A_)))
  timing = {
    "chol_factor": (
      lambda A, b, L: chol.chol_factor(A), lambda A, b, L: chol.chol_factor_plain(A),
      lambda A, b, L: torch.linalg.cholesky_ex(A),
    ),
    "chol_solve": (
      lambda A, b, L: chol.chol_solve(L, b), lambda A, b, L: chol.chol_solve_plain(L, b),
      lambda A, b, L: torch.cholesky_solve(b[..., None], L),
    ),
    "chol_factor_solve": (
      lambda A, b, L: chol.chol_factor_solve(A, b),
      lambda A, b, L: chol.chol_factor_solve_plain(A, b),
      lambda A, b, L: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(A)[0]),
    ),
  }
  times = {}
  print(f"  times from HBM ({HBM_SETS} distinct batches; L2-resident in brackets):")
  for name, (kern, plain, lib) in timing.items():
    times[name] = (
      time_ms(kern, sets, iters=4 * HBM_SETS), time_ms(plain, sets, iters=HBM_SETS),
      time_ms(lib, sets, iters=4 * HBM_SETS), time_ms(kern, sets[:1]),
    )
    print(f"  {name:18s} kernel {times[name][0]:.4f} ms ({times[name][3]:.4f})  plain "
          f"{times[name][1]:.4f} ms  library {times[name][2]:.4f} ms  [{card}]")
  del A, b, sets

  def newton_set(batch: int):
    """Random qM, J at G1's shapes and dense weights: no row is skipped."""
    qM_ = spd_batch(gen, batch, N, torch.float32)
    J_ = torch.randn(batch, NEFC, N, generator=gen, device="cuda") / N**0.5
    w_ = 0.1 + torch.rand(batch, NEFC, generator=gen, device="cuda")
    return qM_, J_, w_, torch.randn(batch, N, generator=gen, device="cuda")

  def replaced(qM_, J_, w_, g_):
    """The torch path newton_direction replaces (timed, never used)."""
    H = chol.newton_matrix(qM_, J_, w_)
    return torch.cholesky_solve(g_[..., None], torch.linalg.cholesky_ex(H)[0])

  nsets = [newton_set(NUM_WORLDS) for _ in range(J_SETS)]
  print(f"  newton_direction, f32 ({NUM_WORLDS}, {NEFC}, {N}), dense weights:")
  checks.newton("random dense", *nsets[0])
  times["newton_direction"] = (
    time_ms(chol.newton_direction, nsets, iters=4 * J_SETS),
    time_ms(chol.newton_direction_plain, nsets, iters=J_SETS),
    time_ms(replaced, nsets, iters=4 * J_SETS),
    None,  # no L2-resident input: J alone is 0.97 GB
  )
  t = times["newton_direction"]
  print(f"  {'newton_direction':18s} kernel {t[0]:.4f} ms  plain {t[1]:.4f} ms  replaced "
        f"torch path {t[2]:.4f} ms  ({J_SETS} distinct J sets) [{card}]")
  print_launch("newton_direction", f"f32, {NUM_WORLDS} x {NEFC} x {N}",
               newton_launch(False, torch.float32, NUM_WORLDS, N, NEFC))
  del nsets
  torch.cuda.empty_cache()

  clock.done(2)
  # -- 3. the main path ---------------------------------------------------------
  model = load_model_npz()
  sim = Simulation(NUM_WORLDS, g1_velocity_sim_cfg(), model)
  dev = sim.device
  key = torch.tensor(model.key_qpos[0], dtype=torch.float32, device=dev)
  qadr = torch.tensor(model.jnt_qposadr[model.actuator_trnid[:, 0]], device=dev)
  ctrl_ref = key[qadr]
  d = sim.make_data()
  qpos = key.expand(NUM_WORLDS, -1).clone()
  qpos[:, 7:] += 0.02 * torch.randn(NUM_WORLDS, model.nq - 7, generator=gen, device=dev)
  d = d.replace(qpos=qpos, ctrl=ctrl_ref.expand(NUM_WORLDS, -1).clone())
  step = sim.step_fn()
  # One warm-up substep in which any host-device synchronization (a
  # host-to-device copy, a .item(), a data-dependent shape) raises.
  torch.cuda.set_sync_debug_mode("error")
  d = step(sim.model, d)
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  print("phase 3 warm-up substep: no host-device synchronization inside the step")
  torch.cuda.reset_peak_memory_stats()
  chol.reset_counts()
  t0 = time.perf_counter()
  for i in range(ENV_STEPS):
    if i == 10:
      torch.cuda.synchronize()
      t10 = time.perf_counter()
    action = 0.1 * torch.randn(NUM_WORLDS, model.nu, generator=gen, device=dev)
    d = d.replace(ctrl=ctrl_ref + action)
    for _ in range(DECIMATION):
      d = step(sim.model, d)
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  launches = dict(chol.LAUNCHES)
  nfact = chol.factorizations()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  substeps = ENV_STEPS * DECIMATION
  dt, dt_steady = t1 - t0, t1 - t10
  print(f"phase 3 main path: G1 velocity-flat, {NUM_WORLDS} worlds, "
        f"{ENV_STEPS} env steps x {DECIMATION} substeps, float32")
  print(f"  wall {dt:.3f} s: {NUM_WORLDS * substeps / dt:.1f} physics-steps/s, "
        f"{NUM_WORLDS * ENV_STEPS / dt:.1f} env-steps/s [{card}]")
  print(f"  steady (env steps 10-{ENV_STEPS - 1}) {dt_steady:.3f} s: "
        f"{NUM_WORLDS * (ENV_STEPS - 10) * DECIMATION / dt_steady:.1f} physics-steps/s, "
        f"{NUM_WORLDS * (ENV_STEPS - 10) / dt_steady:.1f} env-steps/s, "
        f"{dt_steady / ((ENV_STEPS - 10) * DECIMATION) * 1e3:.2f} ms/substep [{card}]")
  print(f"  peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated) [{card}]")
  print(f"  launches {launches}; factorizations {nfact} = "
        f"{nfact / substeps:.2f}/substep")
  for f in ("qpos", "qvel", "sensordata", "efc_force"):
    if not torch.isfinite(getattr(d, f)).all():
      raise AssertionError(f"non-finite {f} after the main path")
  z = d.qpos[:, 2]
  print(f"  root height min {z.min().item():.3f} mean {z.mean().item():.3f} "
        f"max {z.max().item():.3f} m")
  if not (z.min() > 0.05 and z.max() < 1.2):
    raise AssertionError("root height outside the plausible band (0.05, 1.2) m")
  active = (d.contact.dist < d.contact.includemargin).sum(1).float()
  print(f"  active contacts per world: mean {active.mean().item():.2f}, "
        f"min {active.min().item():.0f}")
  if not active.sum() > 0:
    raise AssertionError("no active contacts")
  if (nfact != 12 * substeps or launches["chol_solve"] != substeps
      or launches["newton_direction"] != 10 * substeps):
    raise AssertionError("expected 12 factorizations (10 Newton directions) and 1 "
                         f"solve per substep, got {launches}")

  print("phase 3b kernels vs plain on the run's matrices, f32:")
  grad = torch.randn(NUM_WORLDS, N, generator=gen, device=dev)
  checks.all_three("qM", d.qM.contiguous(), d.qfrc_smooth.contiguous())
  checks.all_three("Newton H", solver.hessian(d, d.qacc).contiguous(), grad)
  w_run = solver.newton_weights(d, d.qacc)
  run_args = [(d.qM, d.efc_J, w_run, grad)]
  checks.newton("run's qM,J,w", *run_args[0])
  active_rows = int((w_run != 0).sum().item())
  share = active_rows / w_run.numel()
  run_ms = time_ms(chol.newton_direction, run_args)
  run_replaced_ms = time_ms(replaced, run_args)
  print(f"  newton_direction on the run's (qM, J, w): {run_ms:.4f} ms, replaced torch "
        f"path {run_replaced_ms:.4f} ms; active rows {active_rows} of {w_run.numel()} "
        f"(share {share:.4f}) [{card}]")
  newton_cfg = newton_launch(False, torch.float32, NUM_WORLDS, N, NEFC)
  print_launch("newton_direction", "the run's, f32", newton_cfg)
  print_launch("newton_direction", "phase 4's, f64, 4 worlds",
               newton_launch(False, torch.float64, 4, N, NEFC))

  clock.done(3)
  # -- 4. the card's kernel path against the CPU's plain path (float64) -------
  cfg64 = g1_velocity_sim_cfg()
  cfg64.dtype = "float64"
  sims = {dv: Simulation(4, cfg64, load_model_npz(), device=dv) for dv in ("cuda", "cpu")}
  ref = {}
  rng = torch.Generator().manual_seed(1)
  q0 = key.double().cpu().expand(4, -1).clone()
  q0[:, 7:] += 0.02 * torch.randn(4, model.nq - 7, generator=rng, dtype=torch.float64)
  ctrls = [ctrl_ref.double().cpu() + 0.1 * torch.randn(4, model.nu, generator=rng,
                                                        dtype=torch.float64)
           for _ in range(4)]
  for dv, s in sims.items():
    dd = s.make_data().replace(qpos=q0.to(dv))
    fn = s.step_fn()
    for c in ctrls:
      dd = fn(s.model, dd.replace(ctrl=c.to(dv)))
    ref[dv] = dd
  print("phase 4 card (kernels, f64) vs CPU (plain, f64), 4 worlds x 4 substeps:")
  for f in ("qpos", "qvel", "sensordata", "qacc"):
    a, b_ = getattr(ref["cuda"], f).cpu(), getattr(ref["cpu"], f)
    err = (a - b_).abs().max().item()
    scale = max(1.0, b_.abs().max().item())
    print(f"  {f:10s} max_abs_err {err:.3e} (tol 1e-8 x {scale:.3e})")
    if not err <= 1e-8 * scale:
      raise AssertionError(f"card vs CPU mismatch on {f}")
  del sims, ref

  clock.done(4)
  # -- 5. where one substep's time goes, stage by stage ---------------------------
  per_stage = stage_times(sim.tp, sim.model, d)
  total = sum(per_stage.values())
  print(f"phase 5 stage times of one substep (CUDA events, mean of 3) [{card}]:")
  for name, ms in per_stage.items():
    print(f"  {name:18s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
  print(f"  {'sum':18s} {total:9.3f} ms")
  split = solve_split(sim.model, d)
  print(f"  solve, run again part by part (CUDA events, mean of 3) [{card}]:")
  for part, ms in split.items():
    print(f"    {part:16s} {ms:9.3f} ms  {100 * ms / sum(split.values()):5.1f}% of solve")

  clock.done(5)
  # -- 6. where one env step's device time goes, by kernel ------------------------
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               record_shapes=True) as prof:
    for _ in range(DECIMATION):
      d = step(sim.model, d)
    torch.cuda.synchronize()
  averages = prof.key_averages()
  # Newer torch names device time "device", older "cuda".
  attr = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
          else "self_cuda_time_total")
  (OUT / "chip_smoke_profile.txt").write_text(
    averages.table(sort_by=attr, row_limit=40)
  )
  events = [e for e in averages if str(e.device_type).endswith("CUDA")]
  dev_ms = sum(getattr(e, attr) for e in events) / 1e3
  steady_env_step_ms = dt_steady / (ENV_STEPS - 10) * 1e3
  print(f"phase 6 profile of 1 env step: device time {dev_ms:.2f} ms in "
        f"{sum(e.count for e in events)} kernel launches; busy share "
        f"{dev_ms / steady_env_step_ms:.3f} of phase 3's steady "
        f"{steady_env_step_ms:.2f} ms/env step [{card}]; "
        f"table in {OUT}/chip_smoke_profile.txt")
  for e in sorted(events, key=lambda e: -getattr(e, attr))[:8]:
    print(f"  {getattr(e, attr) / 1e3:8.3f} ms  x{e.count:5d}  {e.key[:90]}")
  # The batched product Jᵀ diag(w) J, (B, nv, nefc) @ (B, nefc, nv), must
  # be gone from the main path: newton_direction builds H in shared memory.
  jtwj = [e for e in prof.events()
          if e.name in ("aten::bmm", "aten::matmul") and len(e.input_shapes) >= 2
          and list(e.input_shapes[0]) == [NUM_WORLDS, N, NEFC]
          and list(e.input_shapes[1]) == [NUM_WORLDS, NEFC, N]]
  print(f"  batched JᵀWJ products (B, {N}, {NEFC}) @ (B, {NEFC}, {N}) on the main "
        f"path: {len(jtwj)}")
  if jtwj:
    raise AssertionError("the JᵀWJ product still runs on the main path")
  # Each kernel's device time per launch on the main path, from the profile.
  path_ms = {}
  for name in KERNELS:
    hits = [e for e in events if f"{name}_kernel<" in e.key]
    count = sum(e.count for e in hits)
    if not count:
      raise AssertionError(f"{name}: no launch of its kernel in the profile")
    path_ms[name] = sum(getattr(e, attr) for e in hits) / 1e3 / count
    print(f"  {name:18s} on the main path {path_ms[name]:.4f} ms/launch "
          f"(x{count}) [{card}]")

  clock.done(6)
  # -- 7. the env path: ManagerBasedRlEnv.step at 4096 envs ----------------------
  from mjlab_tpu_torch.tasks import make_env

  del d, sim, step, run_args, w_run, grad
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  env = make_env(TASK, num_envs=NUM_WORLDS, episode_length_s=RL_EPISODE_S)
  torch.cuda.synchronize()
  t_build = time.perf_counter() - t0
  t0 = time.perf_counter()
  obs, _ = env.reset(seed=0)
  torch.cuda.synchronize()
  t_reset = time.perf_counter() - t0
  print(f"phase 7 env path: {TASK}, {NUM_WORLDS} envs, float32, episodes "
        f"{RL_EPISODE_S} s ({env.max_episode_length} env steps); build {t_build:.2f} s, "
        f"reset(seed=0) {t_reset:.3f} s [{card}]")
  robot = env.scene["robot"]
  foot = robot.indexing.geom_ids[robot.find_geoms(r".*_foot[1-7]_collision")[0]]
  fric = env.model.geom_friction.cpu()
  nominal = env.sim.unbatched_model.geom_friction.cpu()
  others = [g for g in range(fric.shape[1]) if g not in set(foot.tolist())]
  spread = (fric[:, foot, 0].amax(0) - fric[:, foot, 0].amin(0)).min().item()
  print(f"  per-env foot friction: {len(foot)} geoms, mu in [{fric[:, foot, 0].min():.3f}, "
        f"{fric[:, foot, 0].max():.3f}], least spread across envs {spread:.3f}")
  if not (len(foot) == 14 and spread > 0.5
          and torch.equal(fric[:, others], nominal[others].expand_as(fric[:, others]))
          and torch.equal(fric[:, foot, 1:], nominal[foot, 1:].expand_as(fric[:, foot, 1:]))):
    raise AssertionError("per-env geom_friction is not randomized on the 14 foot geoms "
                         "only")
  agen = torch.Generator(device="cuda").manual_seed(0)
  reset_total = torch.zeros((), dtype=torch.int64, device="cuda")
  finite = torch.ones((), dtype=torch.bool, device="cuda")
  ev_start = torch.cuda.Event(enable_timing=True)
  ev_end = torch.cuda.Event(enable_timing=True)
  chol.reset_counts()
  torch.cuda.set_sync_debug_mode("error")
  t0 = time.perf_counter()
  for i in range(RL_STEPS):
    if i == RL_STEADY_FROM:
      ev_start.record()
    action = torch.randn(NUM_WORLDS, env.total_action_dim, generator=agen, device="cuda")
    obs, rew, terminated, time_outs, extras = env.step(action)
    reset_total += extras["log"]["reset_count"]
    finite &= torch.isfinite(rew).all() & torch.isfinite(obs["policy"]).all()
    finite &= torch.isfinite(obs["critic"]).all()
  ev_end.record()
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  t_loop = time.perf_counter() - t0
  env_launches = dict(chol.LAUNCHES)
  env_fact = chol.factorizations()
  env_peak_gb = torch.cuda.max_memory_allocated() / 1e9
  steady_ms = ev_start.elapsed_time(ev_end) / (RL_STEPS - RL_STEADY_FROM)
  substep_ms = dt_steady / ((ENV_STEPS - 10) * DECIMATION) * 1e3
  print(f"  {RL_STEPS} env steps under set_sync_debug_mode('error'): no host-device "
        f"synchronization; wall {t_loop:.3f} s")
  print(f"  steady (env steps {RL_STEADY_FROM}-{RL_STEPS - 1}, CUDA events) "
        f"{steady_ms:.2f} ms/env step, {NUM_WORLDS / steady_ms * 1e3:.1f} env-steps/s; "
        f"env layer over 4 x phase 3's {substep_ms:.2f} ms substep: "
        f"{steady_ms - 4 * substep_ms:.2f} ms [{card}]")
  print(f"  peak memory {env_peak_gb:.2f} GB (torch.cuda.max_memory_allocated) [{card}]")
  resets = int(reset_total.item())
  print(f"  resets {resets} ({resets / NUM_WORLDS:.2f} per env); launches {env_launches}; "
        f"factorizations {env_fact} = {env_fact / RL_STEPS:.2f}/env step, chol_solve "
        f"{env_launches['chol_solve'] / RL_STEPS:.2f}/env step")
  if obs["policy"].shape != (NUM_WORLDS, 99) or obs["critic"].shape != (NUM_WORLDS, 111):
    raise AssertionError(f"observation shapes {obs['policy'].shape}, {obs['critic'].shape}")
  if not finite.item():
    raise AssertionError("non-finite observation or reward on the env path")
  if resets < 2 * NUM_WORLDS:
    raise AssertionError(f"{resets} resets < 2 per env")
  if (env_fact != RL_FACT_PER_STEP * RL_STEPS
      or env_launches["chol_solve"] != RL_SOLVES_PER_STEP * RL_STEPS
      or any(env_launches[k] == 0 for k in KERNELS)):
    raise AssertionError(f"expected {RL_FACT_PER_STEP} factorizations and "
                         f"{RL_SOLVES_PER_STEP} solves per env step, got {env_launches}")

  # The env's state against phase 3's: the Newton rows with a weight, the
  # active contacts, and one substep's stages on it.
  w_env = solver.newton_weights(env.data, env.data.qacc)
  env_active = (env.data.contact.dist < env.data.contact.includemargin).sum(1).float()
  print(f"  env state: active Newton rows share {(w_env != 0).float().mean().item():.4f} "
        f"(phase 3: {share:.4f}); active contacts per env mean "
        f"{env_active.mean().item():.2f}; root height mean "
        f"{env.data.qpos[:, 2].mean().item():.3f} m")
  del w_env
  env_stages = stage_times(env.tp, env.model, env.data)
  print(f"  one substep's stages on the env's state (CUDA events, mean of 3) [{card}]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in env_stages.items() if v > 0.5)
        + f"; sum {sum(env_stages.values()):.3f} ms (phase 5: {total:.3f} ms)")
  action = torch.randn(NUM_WORLDS, env.total_action_dim, generator=agen, device="cuda")
  parts = split_env_step(env, action)
  print(f"  one env step by part (CUDA events, mean of 2) [{card}]:")
  for part, ms in parts.items():
    print(f"    {part:24s} {ms:9.3f} ms  {100 * ms / sum(parts.values()):5.1f}%")
  print(f"    {'sum':24s} {sum(parts.values()):9.3f} ms; post-reset forward "
        f"{parts['post-reset forward']:.3f} ms = "
        f"{parts['post-reset forward'] / substep_ms:.2f} x phase 3's substep")

  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    env.step(action)
    torch.cuda.synchronize()
  averages = prof.key_averages()
  (OUT / "chip_smoke_env_profile.txt").write_text(averages.table(sort_by=attr, row_limit=40))
  events = [e for e in averages if str(e.device_type).endswith("CUDA")]
  env_dev_ms = sum(getattr(e, attr) for e in events) / 1e3
  env_kernel_launches = sum(e.count for e in events)
  print(f"  profile of 1 env step: device time {env_dev_ms:.2f} ms in "
        f"{env_kernel_launches} kernel launches; busy share "
        f"{env_dev_ms / steady_ms:.3f} of the steady {steady_ms:.2f} ms/env step [{card}]; "
        f"table in {OUT}/chip_smoke_env_profile.txt")
  for e in sorted(events, key=lambda e: -getattr(e, attr))[:6]:
    print(f"    {getattr(e, attr) / 1e3:8.3f} ms  x{e.count:5d}  {e.key[:90]}")
  del env, robot, obs, rew, terminated, time_outs, extras
  torch.cuda.empty_cache()

  # The card's float64 env (kernels) against the CPU's (plain versions).
  f64_env_check(TASK)

  clock.done(7)
  # -- 8. the training path: PPO iterations through OnPolicyRunner ---------------
  train_launches, steady_iter_ms = training_path(card, attr, f64_seeds)

  clock.done(8)
  # -- 9. the tracking path: G1 motion tracking through OnPolicyRunner -----------
  track_launches = tracking_path(card, attr, checks, f64_seeds)

  clock.done(9)
  # -- 10. a run's lifecycle: train, resume, play, joint_deltas, NaN guard, ONNX --
  lifecycle_launches = lifecycle_path(card, checks, steady_iter_ms)

  clock.done(10)
  # -- 11. the Asimov family: Asimov and Asimov-Toe train on flat ground ---------
  asimov_launches, asimov_ms = asimov_path(card, attr, checks)

  clock.done(11)
  # -- 12. G1 on rough terrain and Go1 on flat ground ---------------------------
  rough_launches, rough_ms = rough_go1_path(card, attr, checks)

  clock.done(12)
  # -- 13. Go1, Asimov and Asimov-Toe on rough terrain (the hull SAT) ------------
  rough13_launches, rough13_ms, sat = rough13_path(card, attr, checks)

  clock.done(13)
  # -- 14. the solver surface: G1 under the elliptic cone and CG, and the scenes --
  ell = elliptic_path(card, attr, checks)
  cg_launches = cg_path(card)
  scene_launches = scenes_path(card)
  print(f"phase 14 launches: G1 elliptic's {CUT_ITERS} iteration {ell['launches']}; G1 cg's "
        f"{CG_STEPS - 1} env steps {cg_launches}; the scenes' runs {scene_launches}")
  if any(scene_launches[k] == 0 for k in ALL_KERNELS):
    raise AssertionError(f"phase 14: a kernel did not run in the scenes: {scene_launches}")

  clock.done(14)
  # -- 15. the user surface: a sim-to-real cfg of the user's own -----------------
  surface_launches = surface_path(card, attr, checks, train_launches, steady_iter_ms)

  clock.done(15)
  # -- result lines ---------------------------------------------------------------
  bnd = bounds(NUM_WORLDS, N, rows=NUM_WORLDS * NEFC)
  bnd_run = bounds(NUM_WORLDS, N, rows=active_rows)["newton_direction"]
  print(f"bounds [{card}]: " + ", ".join(f"{k} {v[0]:.5f} ms ({v[1]})" for k, v in bnd.items())
        + f"; newton_direction on the run's w {bnd_run[0]:.5f} ms ({bnd_run[1]}, "
        f"active-row share {share:.4f})")
  replaces = {
    "chol_factor": "mjlab_tpu/physics/smooth.py:233",
    "chol_solve": "mjlab_tpu/physics/smooth.py:238",
    "chol_factor_solve": "mjlab_tpu/physics/forward.py:116",
    "newton_direction": "mjlab_tpu/physics/solver.py:222 (H) and :227-229 (factor, solves)",
  }
  kernels = [
    {
      "name": name,
      "route": "cuda",
      "source": "mjlab_tpu_torch/csrc/"
                + ("newton_dir.cu" if name == "newton_direction" else "chol.cu"),
      "replaces": replaces[name],
      "launches": env_launches[name],
      "launches_physics_path": launches[name],
      "launches_training_path": train_launches[name],
      "launches_tracking_path": track_launches[name],
      "launches_lifecycle_path": lifecycle_launches[name],
      "launches_asimov_path": asimov_launches[name],
      "launches_rough_go1_path": rough_launches[name],
      "launches_rough_path": rough13_launches[name],
      "max_abs_err": checks.max_abs_err[name],
      "ms": times[name][0],
      "ms_l2_resident": times[name][3],
      "ms_main_path": path_ms[name],
      "ms_asimov_run_matrices_by_nv": asimov_ms[name],
      "ms_rough_go1_run_matrices_by_nv": rough_ms[name],
      "ms_rough_run_matrices_by_nv": rough13_ms[name],
      "plain_ms": times[name][1],
      "bound_ms": bnd[name][0],
      "bound_by": bnd[name][1],
      "library_ms": times[name][2],
    }
    for name in KERNELS
  ]
  kernels[-1].update({
    "ms_run_matrices": run_ms, "library_ms_run_matrices": run_replaced_ms,
    "bound_ms_run_matrices": bnd_run[0], "bound_by_run_matrices": bnd_run[1],
    "active_row_share": share, "launch": newton_cfg,
  })
  for k in kernels:
    k["launches_elliptic_path"] = ell["launches"][k["name"]]
    k["launches_cg_path"] = cg_launches[k["name"]]
    k["launches_scenes_path"] = scene_launches[k["name"]]
    k["launches_surface_path"] = surface_launches[k["name"]]
  kernels.append({
    "name": CONE_KERNEL,
    "route": "cuda",
    "source": "mjlab_tpu_torch/csrc/newton_dir.cu",
    "replaces": "mjlab_tpu/physics/solver.py:222-225 (H with the cone blocks) and "
                ":227-229 (factor, solves)",
    "launches": ell["launches"][CONE_KERNEL],
    "launches_elliptic_path": ell["launches"][CONE_KERNEL],
    "launches_cg_path": cg_launches[CONE_KERNEL],
    "launches_scenes_path": scene_launches[CONE_KERNEL],
    "launches_surface_path": surface_launches[CONE_KERNEL],
    "max_abs_err": checks.max_abs_err[CONE_KERNEL],
    "ms": ell["ms"],
    "plain_ms": ell["plain_ms"],
    "bound_ms": ell["bound"][0],
    "bound_by": ell["bound"][1],
    "library_ms": ell["library_ms"],
    "launch": ell["launch"],
  })
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({
    "ok": True,
    "device": {
      "platform": "gpu",
      "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count(),
    },
  }))
  return 0


if __name__ == "__main__":
  sys.exit(main())
