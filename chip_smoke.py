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
     scene at 4096 worlds, 20 env steps (cut from 50 and 30) of 4 substeps, ctrl = keyframe
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
     certain, 4 envs x 4 env steps (cut from 8);
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
     checks and split (no profile since PR 14, device-only before: cut to
     keep the script inside its limit) on it, plus the motion frames inside
     [0, 500) and a failure counted in the adaptive bins; holds the kernels
     against their plain versions on the tracking run's matrices; and the
     card's float64 iteration against the CPU's on the tracking task's
     certain-draw variant, as phase 8 does;
 10. a run's lifecycle on G1 velocity-flat at 4096 envs in
     build/chip_smoke/run, through the entry points: `run_train` for 2
     iterations of 4 env steps (cut from 24 and 8) with a save after each (the
     files, the labels, ms per save, the metric pulls and `learn`'s ms per
     iteration against phase 8's steady iteration scaled to 4 env steps),
     `run_train --agent.resume true` for 1 iteration
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
     on this host against the CPU host's digest; 1 iteration of 4 env steps
     (cut from 8)
     (2 of 24, with a device-only profile and the stage times, before the
     cuts of PRs 9 and 11: the robots train on rough terrain in phase 13)
     under set_sync_debug_mode("error") with
     its counts, checks and split; the four kernels against their plain
     versions on each run's matrices, and their times there; the card's
     float64 env against the CPU's, 4 envs x 2 env steps (cut from 3),
     each from the CPU env's state and held to 1e-8 or twice the CPU's own spread under 6
     qpos nudges of 1e-13, for Asimov-Toe with the ankle targets checked in
     ctrl on the 4 tendon actuators only.
 12. G1 on rough terrain and Go1 on flat ground, 1 iteration of 4 (cut from 8) env
     steps each (cut from G1 rough's 2 of 24 with a device-only profile of a
     rollout step and an update and the stage times), each as a task of
     phase 11:
     Mjlab-Velocity-Rough-Unitree-G1 (3564 terrain boxes pooled behind the
     cell-hash broadphase, 667 contact slots, nv 35, 2235 Newton rows; the
     pool and the 10 x 20 tile grid checked after the build; the
     iterations' dropped terrain contacts and mean terrain level) and
     Mjlab-Velocity-Flat-Unitree-Go1 (the trunk box on the plane; nv 18,
     240 rows); then a headless `run_play` of the rough task, 6 steps (cut from 24) of
     the random policy at 4096 envs, which regenerates its terrain on 3 x 3
     tiles, with the kernels' counters set to 0 just before and read just
     after. The rough tasks generate their terrain and compose
     it into the robot's flat scene (phase 19a holds that to the committed
     compiles).
 13. Go1, Asimov and Asimov-Toe on rough terrain, 1 iteration of 4 (cut from 8) env
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
     on its regenerated 3 x 3 tiles.
 14. the solver surface: (a) G1 velocity-flat under
     `--env.sim.mujoco.cone elliptic` (nefc 1320: 29 limit rows, 154
     condim-1 rows, 379 cone slots of 3 rows) through `build_runner` at
     4096 envs, 1 iteration (cut from 2) with phase 8's checks (its
     device-only profile cut in PR 14), every Newton direction through
     `newton_direction_cone` (1200 launches per iteration, none of
     `newton_direction`), the kernel against its
     plain version on the run's last matrices in f32 (KernelCheck's rule)
     and f64 (1e-10 relative), its times beside its bound, the plain
     version and the library path (einsum + cholesky_ex + cholesky_solve),
     the cone slots by zone and the active ones per world, the kernel's
     launch (f32 and f64), and the card's float64 env against the CPU's
     as phases 11-13 (2 env steps, cut from 3; 2 nudges); (b) G1 under
     `--env.sim.mujoco.solver cg`, 6 env
     steps (cut from 10) at 4096 envs under set_sync_debug_mode("error"), ms per env step,
     the Cholesky launches per env step against the code's count, and the
     float64 env check (2 env steps, 2 nudges); (c) each scene of
     mjlab_tpu_torch/assets/solver_scenes.py (equality connect/weld on
     bodies and sites, joint, tendon; friction loss; a limited tendon; CG;
     condim 4 and 6 under both cones; the elliptic puck; Euler; RK4) for 6
     (cut from 50, 30, 20 and 12) float64 substeps at 4096 worlds, ms per substep, its first 16 worlds
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
     equal to phase 8's, the iteration against phase 8's in this call (its
     profile cut in PR 14); the kernels against their plain versions on the
     run's per-env matrices (qM, the Newton matrix and direction, the
     implicitfast matrix); and the card's float64 env against the CPU's
     with all 19 FIELD_SPECS rows randomized (each env different, the
     CPU's leaves handed to the card), 4 envs x 4 env steps (cut from 8),
     1e-8 or twice the CPU's spread under 2 nudges.
 16. a user's own robot and task: (a) the CartPole tutorial, its guide's
     python blocks (docs/CREATE_NEW_TASK_TORCH.md) run verbatim, which
     register Mjlab-Cartpole: `cartpole_runner` at 4096 envs with the
     guide's default runner cfg, 2 iterations of 4 env steps (cut from 24 and 8)
     with phase 8's checks (35 factorizations and 3 `chol_solve` per env
     step at decimation 2), the kernels against their plain versions on
     the run's matrices (n = 2, f32 and f64) and their times there; a
     learning check in the form of tests/test_doc_cartpole.py's: 24 (cut from 30)
     iterations of 6 env steps, the mean episode length over the last 10
     more than twice that over the first 10 and the noise std annealed
     below 0.8 x; the card's float64 env against the CPU's on a
     certain-draw variant, 4 envs x 8 env steps; (b) each scene of
     mjlab_tpu_torch/assets/surface_scenes.py (a ball chain, a gimbal, a
     humanoid with multi-hinge bodies and limited ball hips, the JAX
     package's sensor, pair, mocap and gravity-compensation scenes) for
     6 (cut from 30, 20 and 12) float64 substeps at 4096 worlds, ms per substep, every sensor
     finite and every sensor type added in PR 13 evaluated, the first 16
     worlds against the CPU (phase 14's rule); the humanoid in float32 at
     10 x 20 Newton iterations for 15 substeps (cut from 30), ms per substep and the kernels' launches,
     the kernels on its matrices (n = 27, f32 and f64), and
     `newton_direction_cone` on its matrices under the elliptic cone.
 17. the actuation and tendon surface, and PGS: (a) G1 velocity-flat under
     `--env.sim.mujoco.solver pgs` at 4096 envs, f32: 10 env steps under
     set_sync_debug_mode("error"), ms per env step, the launches per env
     step against the code's count (one `pgs_solve` per forward: 4
     substeps and the post-reset forward; M's factor and solve per
     forward, the integrator's factor-solve per substep, no Newton
     direction), the active rows per world; `pgs_solve` (csrc/pgs.cu)
     against `pgs_solve_plain` on the run's own rows and factor, f, u and
     qfrc (f32 by KernelCheck's rule; the same rows cast to f64 within
     1e-10 relative), its launch (worlds resident per SM, registers,
     spills), its ms beside the plain version's (which forms A, 512
     worlds a call) and its bound, the most active rows of a world and
     the ns per dependent row update; one PPO iteration of 4 env steps (cut from 8)
     through build_runner with phase 8's checks (9 factorizations, 5
     `chol_solve` and 5 `pgs_solve` per env step); the card's float64
     env against the CPU's (phase 14's rule); (b) each scene of
     mjlab_tpu_torch/assets/muscle_scenes.py (the JAX package's
     activation, muscle, fluid, spatial-tendon, wrap and PGS test scenes
     and a musculoskeletal arm) under each integrator its JAX test runs,
     6 float64 substeps (cut from 30 and 12) at 4096 worlds, ms per substep,
     the first 16 worlds against the CPU (phase 14's rule); and the
     filter-actuated hopper env at 4096 envs, 10 env steps under
     set_sync_debug_mode("error"): act moves toward its targets and is
     exactly 0 after the time-out that resets every env.
 18. the rest of the JAX package's surface: (a) G1 velocity-flat at 4096
     envs with a user's cfg that names every generic MDP term
     (`generic_mdp_edit`: the observations base_lin_vel, base_ang_vel,
     root_pos_w, root_quat_w, joint_pos, joint_vel; the terminations
     root_height_below_minimum and nan_detection; the rewards
     is_terminated, joint_torques_l2, joint_acc_l2, joint_vel_l2, posture,
     electrical_power_cost, flat_orientation_l2; the curriculum
     reward_weight staging one of them), 8 env steps under
     set_sync_debug_mode("error") with the kernels' counters set to 0 just
     before and read just after: every term finite, the staged weight in
     the reward manager's state from the step after its stage, nan_detection
     on exactly the envs whose qvel was poisoned, the kernels against their
     plain versions on the run's matrices; the card's float64 env against
     the CPU's, 4 envs x 2 env steps (1e-8); a mocap entity's reset
     (reset_root_state_uniform, assets/surface/mocap_entity.npz) at 4096
     envs, each pose inside its range and on its own env only; (b) the
     scenes of assets/pair_scenes.py (plane–cylinder, plane–ellipsoid, a
     height field under a sphere, a capsule, a box and a mesh hull) for 6 (cut from 12)
     float64 substeps at 4096 worlds, ms per substep, the first 16 worlds
     against the CPU (phase 14's rule); (c) two ranks on the one card
     (gloo): `python -m torch.distributed.run --nproc_per_node 2 -m
     mjlab_tpu_torch.scripts.train` G1 velocity-flat at 4096 envs (2 x
     2048), one iteration of 8 env steps (each rank's ms per iteration and
     peak memory, finite losses, the learner bitwise equal on both ranks,
     rank 0 alone saving); float64, 2 ranks x 2 envs against this process
     with 4 envs, one iteration of 2 env steps from one warm learner
     (parameters, Adam state, normalizers, losses and the env state within
     1e-8 relative; `--dist-f64 DIR` runs one of its processes); and one
     rank through NCCL, one iteration at 512 envs.
 19. generated terrain: (a) each rough task's scene and play scene (the 3 x
     3 tiles of the play overrides) generated and composed on this host
     from the robot's flat scene and the task's cfg (no `mujoco` here), and
     held against the committed npz, the JAX package's compile: integers
     exactly, floats within 1e-12 of each field's largest magnitude; the ms
     of each generation and composition; (b) Asimov velocity-rough on
     ROUGH_TERRAINS_WITH_HF_CFG under the curriculum (80 height field tiles
     against the 2 foot hulls, 2364 pooled boxes), registered as a user's
     task, at 4096 envs, f32: its reckoned dense efc_J (no cut below 20 GB),
     slots and rows; 8 steady env steps under set_sync_debug_mode("error"),
     ms per env step (CUDA events), peak memory, one substep's stage
     times; then as a task of phase 13:
     one PPO iteration of 8 env steps through `build_runner` with its
     launches, the kernels against their plain versions on its matrices,
     and the card's float64 env against the CPU's for 2 env steps from the
     CPU's state (1e-8 or twice the CPU's spread under 6 nudges).
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
`launches_surface_path` phase 15's, `launches_user_robot_path` phase 16's
(CartPole's 2 iterations, the scenes and the humanoid) and
`ms_user_robot_matrices_by_nv` each kernel's time on CartPole's (n = 2)
and the humanoid's (n = 27) matrices; the fifth entry,
`newton_direction_cone`, has phase 14's elliptic run's launches and its
times on that run's matrices; every entry has `launches_pgs_path` and
`launches_muscle_scenes_path`, phase 17's, and `launches_generic_mdp_path`
and `launches_pair_scenes_path`, phase 18a's env steps and 18b's scenes
(18c's ranks are processes of their own); the sixth, `pgs_solve`, has
phase 17a's env steps' launches, its times on that run's rows and
`library_ms` null: no PyTorch call computes a projected Gauss-Seidel
sweep); every entry has `launches_hf_path`, phase 19b's iteration, and the
four Cholesky and Newton entries `ms_hf_run_matrices`; the seventh to
ninth, `warm_start`, `newton_linesearch` and `newton_gradient`, have every
path's launches (`launches_<path>_path`; PGS's 0; `newton_gradient`'s
`launches` and `launches_zero_iteration_path` from phase 3c, the only
path that launches it), `ms` on phase 2's 2%-active input, `ms_main_path`
per launch in phase 6's profile (null for `newton_gradient`, which the
main path does not launch), `ms_run_rows`, `ms_elliptic_rows` and
`ms_cg_rows` on phases 3b's and 14's rows, the bounds on those inputs and
`library_ms` null: no PyTorch call computes an exact linesearch or this
cost (the torch path each replaces is its plain version, `plain_ms`);
`warm_start`'s times are the solve's first launch with the list's build,
`newton_gradient`'s a launch with the list's build (`ms_list_reused`
without it), and `newton_linesearch`'s a whole launch with the gradient at
x', one Newton iteration's non-direction work
(`bound_ms_iteration_run_rows` its bound by `newton_bounds`' rule); the
last line is {"ok": true, "device": {...}}.

The Newton iteration's kernels add: in phase 2 the three against
their plain versions at the main path's shapes (4096 x 1699 x 35, f32) with
~2% of the rows active, all of them and none, in f32 and f64, their times,
plain times and bounds and their launch (resident worlds per SM, shared
bytes, registers, spills); in phases 3, 7 and 8 (and every path through
`train_iterations`, and phase 14's CG run) their launches per substep, env
step and iteration: per Newton or CG solve of K iterations 1 `warm_start`
(which lists the solve's active rows, picks its first point and ends with
the gradient there) and K `newton_linesearch` (each ending with the next
iteration's gradient, the last with the forces: 11 per G1 substep, 5 / 0 /
50 per env step), no `newton_gradient`, none under PGS; in phase 3c, solves
of 0 iterations, 1 `warm_start` and 1 `newton_gradient` (the forces) per
substep, and in phase 4 their f64 result against the CPU's; in phase 3b and
phase 14's elliptic and CG runs the three against their plain versions on
the run's rows (f32 and f64; the linesearch against
newton_linesearch_plain followed by newton_gradient_plain at the point it
returns, the warm start against warm_start_plain, and their gradients
bitwise against newton_gradient's at their points) and their times there;
in phase 5 the solve split into the directions, the warm start kernel, the
linesearch kernel and the rest; in phase 6 a failure if a product with a
(B, nefc, nv) operand runs inside the solver.solve profiler span.
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
ENV_STEPS = 20  # cut from 50 and 30 to keep the script inside its limit
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
# The rest of the Newton iteration (kernels/newton.py): every Newton or CG
# solve of K >= 1 iterations launches the first two (the pyramidal paths
# KERNELS and these); newton_gradient launches in a solve of 0 iterations
# (its forces), and is held against its plain version and timed beside them.
NEWTON_KERNELS = ("warm_start", "newton_linesearch", "newton_gradient")
PATH_KERNELS = KERNELS + NEWTON_KERNELS[:2]
ALL_KERNELS = PATH_KERNELS + (CONE_KERNEL,)
# Every counter of chol and newton (launch_counts' keys but pgs_solve's).
COUNTED = ALL_KERNELS + NEWTON_KERNELS[2:]
OUT = Path("chiprun_out")
TASK = "Mjlab-Velocity-Flat-Unitree-G1"
RL_EPISODE_S = 0.4  # cut from 20 s: 20 env steps, every env resets in-step
RL_STEPS = 40  # cut from 60: still 2 episodes of 20 env steps per env
RL_STEADY_FROM = 10
RL_SOLVES_PER_STEP = 5


def fact_per_env_step(newton_iters: int = 10, decimation: int = DECIMATION,
                      pgs: bool = False) -> int:
  """Factorizations per env step: `decimation` substeps of factor_m, the
  Newton directions and the integrator's factor-solve, and the post-reset
  forward's factor_m and Newton directions (59 at 4 substeps of 10 Newton
  iterations); under PGS, which takes no Newton direction, factor_m per
  forward and the integrator's factor-solve per substep (9 at 4
  substeps)."""
  if pgs:
    return 2 * decimation + 1
  return decimation * (newton_iters + 2) + newton_iters + 1


RL_FACT_PER_STEP = fact_per_env_step()


def newton_per_solve(iterations: int = 10) -> dict[str, int]:
  """The Newton iteration's kernels per solve: a Newton or CG solve of K ≥ 1
  iterations launches 1 warm_start (listing its active rows, with the
  gradient at the point it picks) and K newton_linesearch (each with the
  gradient at the point it returns, the last with the final forces), no
  newton_gradient; a solve of 0 iterations 1 warm_start and 1
  newton_gradient (the forces)."""
  if iterations == 0:
    return {"warm_start": 1, "newton_gradient": 1, "newton_linesearch": 0}
  return {"warm_start": 1, "newton_gradient": 0, "newton_linesearch": iterations}


def newton_per_env_step(opt, decimation: int = DECIMATION) -> dict[str, int]:
  """The Newton iteration's kernels per env step for the model's solver
  options: one solve per substep and the post-reset forward's (5 solves at
  4 substeps: 5, 5 and 50 for G1's 10 Newton iterations); none under PGS."""
  from mjlab_tpu_torch.physics.types import mjtSolver

  if opt.solver == mjtSolver.mjSOL_PGS:
    return {k: 0 for k in NEWTON_KERNELS}
  per = newton_per_solve(opt.iterations)
  return {k: (decimation + 1) * v for k, v in per.items()}


def reset_counts() -> None:
  """Every kernel's launch counter to 0."""
  from mjlab_tpu_torch.kernels import chol, newton, pgs

  for mod in (chol, newton, pgs):
    mod.reset_counts()


def launch_counts() -> dict[str, int]:
  """Every kernel's launches since `reset_counts`."""
  from mjlab_tpu_torch.kernels import chol, newton, pgs

  return {**chol.LAUNCHES, **pgs.LAUNCHES, **newton.LAUNCHES}
TRAIN_ITERS = 2  # 3 until PR 7; 2 keeps the script with phase 11 inside its limit
# Phases 11-13's tasks run one iteration (phases 12-13's cut from 2 with a
# profile and the stage times), so that the script stays inside its limit
# with phase 14.
CUT_ITERS = 1
TRAIN_STEPS = 24  # the G1 PPO cfg's num_steps_per_env
# Env steps per iteration of the cut tasks of phases 11-13 (cut from their
# cfgs' 24), and the card-vs-CPU env steps of their checks and of phase
# 14's G1 ones (cut from 3): cuts that keep the script under 1000 s.
CUT_STEPS = 4  # cut from 8 to pay for phase 19
CUT_F64_STEPS = 2
# The runner's torch.profiler spans: a rollout step's two, then the update's.
# The solver's profiler span (physics/solver.py); its GPU-side annotation
# row is no kernel.
SOLVE_SPAN = "solver.solve"
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


def rows_as(rows, dtype):
  """A copy of newton.Rows in another float dtype (classes and layout
  kept)."""
  from mjlab_tpu_torch.kernels import newton

  def cast(t):
    return None if t is None else t.to(dtype)

  return newton.Rows(*(cast(t) for t in (rows.qM, rows.J, rows.D, rows.aref, rows.a0)),
                     fl=cast(rows.fl), is_eq=cast(rows.is_eq), is_fric=cast(rows.is_fric),
                     reg=cast(rows.reg), kind=rows.kind, layout=rows.layout,
                     mu0=cast(rows.mu0))


def newton_bounds(rows, iters: int, safeguard: bool = False,
                  solve_iters: int = 10) -> dict[str, tuple[float, str]]:
  """Least time (ms) of each of the Newton iteration's kernels on these
  rows: the larger of the bytes it must move over HBM's rate and its FLOP
  over the float32 rate. One rule for any split of the work: D on every
  row, w on the inactive rows, the inactive slots' blocks and the list's
  entries are once per solve (the list's build: the warm start); each
  iteration then moves the active rows' (D != 0, a cone slot's rows with
  it) J, aref, fl, D and list entry, qM's lower triangle, x and p in, x',
  the gradient and α out, w on the active rows and the active slots' cone
  blocks. FLOP: per active row 2n for each product with J, a few per
  linesearch step; 2n² per quadratic form. "iteration" is one Newton
  iteration's non-direction work (x, p → x', ∇, w, blocks) with the
  once-per-solve bytes spread over `solve_iters` iterations;
  "newton_linesearch" one launch without the once-per-solve bytes;
  "warm_start" the solve's start: the list's build, the active rows' J,
  aref and fl once (their D and entries are the build's), qM's triangle,
  ws and a0 in, x0, the gradient and the two costs out, w on the active
  rows and the active slots' blocks (two residuals, two Jᵀf and two
  quadratic forms); "newton_gradient" the same launch from one point with
  the list's build (as a caller without a warm start runs it)."""
  B, m = rows.D.shape
  n, e = rows.qM.shape[1], rows.D.element_size()
  active = int((rows.D != 0).sum().item())
  row_bytes = (n + 2 + int(rows.fl is not None)) * e + 4
  tri = B * n * (n + 1) // 2 * e
  blocks = inactive_blocks = 0  # cone block elements of the active and the other slots
  if rows.layout is not None:
    tab = rows.layout.table.long()
    on = rows.D[:, tab[:, 0]] > 0
    size = (tab[:, 1] * tab[:, 1])[None, :]
    blocks = int((on * size).sum().item())
    inactive_blocks = int((~on * size).sum().item())
  per_iter = active * row_bytes + tri + 4 * B * n * e + B * (e + 1) + (active + blocks) * e
  once = B * m * e + (B * m - active + inactive_blocks) * e + active * 4
  pts = 6 if safeguard else 1
  ls_flop = (active * (4 * n + 8 * iters + pts * 2 * n + 4 * n)
             + B * (3 + pts + int(safeguard)) * 2 * n * n)
  # A launch that builds the list has read D on every row and wrote the
  # entries itself: of the active rows it still needs J and aref (and fl).
  start = once + active * (n + 1 + int(rows.fl is not None)) * e + tri + (active + blocks) * e
  work = {
    "warm_start": (start + 4 * B * n * e + 2 * B * e, 8 * active * n + 4 * B * n * n),
    "newton_gradient": (start + 2 * B * n * e, 4 * active * n + 2 * B * n * n),
    "newton_linesearch": (per_iter, ls_flop),
    "iteration": (per_iter + once / solve_iters, ls_flop),
  }
  out = {}
  for name, (byt, flop) in work.items():
    tb, tf = byt / PEAK_BYTES * 1e3, flop / PEAK_F32 * 1e3
    out[name] = (max(tb, tf), "bytes" if tb >= tf else "operations")
  return out


def iteration_inputs(rows):
  """(x, p) of a first Newton iteration on these rows: x = a0 (qacc_smooth,
  where the violated rows are active) and p its Newton direction (from the
  warm start at a0)."""
  from mjlab_tpu_torch.kernels import newton
  from mjlab_tpu_torch.physics import solver

  x = rows.a0
  _, _, grad, w, blocks = newton.warm_start(rows, x)
  return x, solver.direction(rows, grad, w, blocks)


def _copies(out):
  """A kernel's outputs, the solve's buffers among them copied."""
  return tuple(None if t is None else t.clone() for t in out)


def iteration_kernels(tag: str, rows, x, p, iters: int, safeguard: bool, checks: "KernelCheck",
                      card: str, time_plain: bool = True) -> dict[str, dict]:
  """The three kernels of the Newton iteration against their plain versions
  on float32 rows (KernelCheck's rule) and, cast to float64, within 1e-10
  relative: the warm start from ws = x + p (against warm_start_plain; its
  choice compared as the acceptance's), newton_gradient at x (and its
  forces mode), newton_linesearch along p with the gradient and with the
  forces at the point it returns (against newton_linesearch_plain followed
  by newton_gradient_plain at the point that returns); the gradient, w and
  blocks (and the forces) the warm start and a linesearch return at their
  point bitwise equal to newton_gradient's there. Each kernel's ms on these
  rows (mean of 20 calls; the warm start's and newton_gradient's with the
  list's build, newton_gradient's also without it), its plain version's
  and its bound (`newton_bounds`); "iteration" is the linesearch's launch
  against one iteration's bound. The comparisons' launches are the
  caller's to leave out of a path's counts."""
  from mjlab_tpu_torch.kernels import newton

  ws = (x + p).contiguous()

  def ws_kern(r, x_, p_):
    return _copies(newton.warm_start(r, (x_ + p_).contiguous()))

  def ws_plain(r, x_, p_):
    return newton.warm_start_plain(r, x_ + p_)

  def ls_kern(r, x_, p_, forces=False):
    xo, alpha, improved, at = newton.newton_linesearch(r, x_, p_, iters, safeguard,
                                                       forces=forces)
    return (xo, alpha, improved, *_copies(at))

  def ls_plain(r, x_, p_, forces=False):
    xo, alpha, improved = newton.newton_linesearch_plain(r, x_, p_, iters, safeguard)
    return (xo, alpha, improved, *newton.newton_gradient_plain(r, xo, forces))

  calls = {
    "warm_start": (ws_kern, ws_plain),
    "newton_gradient": (lambda r, x_, p_: _copies(newton.newton_gradient(r, x_)),
                        lambda r, x_, p_: newton.newton_gradient_plain(r, x_)),
    "newton_forces": (lambda r, x_, p_: newton.newton_gradient(r, x_, forces=True),
                      lambda r, x_, p_: newton.newton_gradient_plain(r, x_, forces=True)),
    "newton_linesearch": (lambda r, x_, p_: ls_kern(r, x_, p_),
                          lambda r, x_, p_: ls_plain(r, x_, p_)),
    "newton_linesearch_forces": (lambda r, x_, p_: ls_kern(r, x_, p_, True),
                                 lambda r, x_, p_: ls_plain(r, x_, p_, True)),
  }

  def chose(out, key):
    """Where the acceptance (or the warm start) took its candidate."""
    return out[2] if key == "newton_linesearch" else out[1][:, 0] < out[1][:, 1]

  rows64 = rows_as(rows, torch.float64)
  a64 = (x.double(), p.double())
  worst64 = 0.0
  for name, (kern, plain) in calls.items():
    got, want = kern(rows, x, p), plain(rows, x, p)
    ref = plain(rows64, *a64)
    got64 = kern(rows64, *a64)
    key = {"newton_forces": "newton_gradient",
           "newton_linesearch_forces": "newton_linesearch"}.get(name, name)
    keep = None
    if key in ("newton_linesearch", "warm_start"):
      # The acceptance (the warm start's choice) may decide a cost tie the
      # other way (the sums over the rows round differently): there the two
      # chosen points' float64 costs agree within 1e-5 relative in float32
      # (1e-12 in float64), and the outputs at the chosen point are compared
      # in the other worlds.
      keep = {}
      for tol, g3, w3, label in ((1e-5, got, want, "f32"), (1e-12, got64, ref, "f64")):
        flips = chose(g3, key) != chose(w3, key)
        if flips.any():
          c_got = rows64.total_cost(g3[0].double())[flips]
          c_plain = rows64.total_cost(w3[0].double())[flips]
          tie = ((c_got - c_plain).abs() <= tol * c_plain.abs().clamp_min(1.0)).all().item()
          print(f"  {tag}: the {label} acceptance decided {int(flips.sum())} cost ties the "
                f"other way (costs agree within {tol:g}: {tie})")
          if not tie:
            raise AssertionError(f"{tag}: an {label} acceptance differs where costs do not tie")
        keep[label] = ~flips
      if key == "newton_linesearch":
        got, want, ref, got64 = (t[:2] + t[3:] for t in (got, want, ref, got64))
    for i, (g, w_, r) in enumerate(zip(got, want, ref)):
      if g is None:
        continue
      r_full, g64 = r, got64[i]
      if keep is not None and i != 1:  # neither alpha nor the costs depend on the choice
        g, w_, r = g[keep["f32"]], w_[keep["f32"]], r[keep["f32"]]
        g64, r_full = g64[keep["f64"]], r_full[keep["f64"]]
      flat = [t.reshape(t.shape[0], -1) for t in (g, w_, r)]
      checks.check(key, f"{tag} {name[7:] if name.startswith('newton_') else name}[{i}]",
                   *flat)
      ok = ~torch.isnan(r_full)
      if ok.any():
        err = ((g64 - r_full)[ok].abs().max().item()
               / max(1.0, r_full[ok].abs().max().item()))
        worst64 = max(worst64, err)
  torch.cuda.synchronize()
  print(f"  the Newton iteration's kernels in float64 on {tag}: largest relative error "
        f"{worst64:.3e} (tol 1e-10)")
  if not worst64 <= 1e-10:
    raise AssertionError(f"{tag}: a float64 Newton-iteration kernel differs by {worst64:.3e}")

  def same_as_gradient(at, xo, r_, forces=False):
    want = newton.newton_gradient(r_, xo, forces=forces)
    return all(a_ is None and b_ is None or newton.same_bits(a_, b_) for a_, b_ in zip(at, want))

  for r_ in (rows, rows64):
    xr, pr = (x, p) if r_ is rows else a64
    res = ws_kern(r_, xr, pr)
    if not same_as_gradient(res[2:], res[0], r_):
      raise AssertionError(f"{tag}: the warm start's output at x0 differs from "
                           f"newton_gradient's there ({r_.qM.dtype})")
    for forces in (False, True):
      res = ls_kern(r_, xr, pr, forces)
      if not same_as_gradient(res[3:], res[0], r_, forces):
        raise AssertionError(f"{tag}: the linesearch's output at x' differs from "
                             f"newton_gradient's there ({r_.qM.dtype}, forces {forces})")
  print(f"  the gradient, w and blocks (and the forces) the warm start and a linesearch return "
        f"at their point are bitwise newton_gradient's there, f32 and f64")
  bnd = newton_bounds(rows, iters, safeguard)

  def first_gradient():
    rows._card.built = False  # as at a solve's first launch: the list is built again
    return newton.newton_gradient(rows, x)

  timed = {
    "warm_start": (lambda: newton.warm_start(rows, ws), lambda: ws_plain(rows, x, p)),
    "newton_linesearch": (lambda: newton.newton_linesearch(rows, x, p, iters, safeguard),
                          lambda: ls_plain(rows, x, p)),
    "newton_gradient": (first_gradient, lambda: newton.newton_gradient_plain(rows, x)),
  }
  out = {}
  for name in NEWTON_KERNELS:
    kern, plain = timed[name]
    ms = time_ms(kern, [()])
    plain_ms = time_ms(plain, [()], iters=3) if time_plain else None
    out[name] = {"ms": ms, "plain_ms": plain_ms, "bound": bnd[name]}
    print(f"  {name:18s} on {tag}: kernel {ms:.4f} ms  plain "
          + (f"{plain_ms:.4f} ms" if plain_ms is not None else "not timed")
          + f"  bound {bnd[name][0]:.6f} ms ({bnd[name][1]}) [{card}]")
  out["newton_gradient"]["ms_list_reused"] = time_ms(lambda: newton.newton_gradient(rows, x),
                                                     [()])
  out["iteration"] = {"ms": out["newton_linesearch"]["ms"], "bound": bnd["iteration"]}
  print(f"  newton_gradient without the list's build {out['newton_gradient']['ms_list_reused']:.4f}"
        f" ms; one iteration's non-direction work (a linesearch launch) "
        f"{out['iteration']['ms']:.4f} ms against its bound {bnd['iteration'][0]:.6f} ms "
        f"({bnd['iteration'][1]}; the once-per-solve bytes over 10 iterations) [{card}]")
  return out


def print_iteration_launch(what: str, dtype, n: int, m: int, ncone: int = 0) -> dict:
  """The Newton-iteration kernels' launch at these shapes (resident worlds
  per SM, shared bytes, registers, local bytes); with cone slots the
  linesearch's with the safeguard too."""
  from mjlab_tpu_torch.kernels import newton

  cfgs = {name: newton.launch_config(name, dtype, n, m, ncone) for name in NEWTON_KERNELS}
  if ncone:
    cfgs["newton_linesearch_safeguard"] = newton.launch_config("newton_linesearch", dtype, n, m,
                                                               ncone, safeguard=True)
  for name, cfg in cfgs.items():
    print(f"  {name} launch ({what}): one-warp blocks, {cfg['worlds_per_sm']} resident worlds "
          f"per SM of {cfg['sms']}, {cfg['shared_bytes']} shared bytes per world, "
          f"{cfg['registers']} registers and {cfg['spill_bytes']} local bytes per thread")
  return cfgs


def zero_iteration(m):
  """The model `m` with the solver's iterations set to 0 (each solve returns
  the warm start's point and the forces there); its tensors shared."""
  import dataclasses

  return dataclasses.replace(m, opt=dataclasses.replace(m.opt, iterations=0))


def zero_iteration_path(tp, m, d, card: str) -> dict[str, int]:
  """Phase 3c: one substep of G1 velocity-flat at NUM_WORLDS worlds, f32,
  from phase 3's last state with the solver's iterations set to 0, under
  set_sync_debug_mode("error") with the counters set to 0 just before: 1
  warm_start and 1 newton_gradient (the forces, on the warm start's list),
  no linesearch and no Newton direction; the state finite. (More substeps
  at 0 iterations leave the physics: G1 leaves the ground within ~6 from
  rest, on the CPU as on the card.) Returns the substep's launches."""
  from mjlab_tpu_torch import physics

  torch.cuda.synchronize()
  reset_counts()
  torch.cuda.set_sync_debug_mode("error")
  d = physics.step(tp, zero_iteration(m), d)
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  launches = launch_counts()
  want = newton_per_solve(0)
  print(f"phase 3c a solve of 0 iterations: {NUM_WORLDS} worlds x 1 substep, f32, no "
        f"host-device synchronization; launches {launches}; expected {want} [{card}]")
  if (any(launches[k] != v for k, v in want.items()) or launches["newton_direction"]
      or not all(torch.isfinite(getattr(d, f)).all() for f in ("qpos", "qvel", "efc_force"))):
    raise AssertionError(f"phase 3c: launches {launches} (expected {want}) or a non-finite state")
  return launches


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


def solve_split(tp, m, d, reps: int = 3) -> dict[str, float]:
  """Mean ms of solver.solve's parts on one substep's data, run as
  solver.solve runs them: the Newton directions (H and its factor and
  solves), the warm start kernel (the list of the solve's active rows, the
  choice of its first point and the gradient there), the linesearch kernel
  (the step's acceptance and the gradient at the accepted point, the last
  launch's with the forces), and the rest (the rows' set-up)."""
  from mjlab_tpu_torch.kernels import newton
  from mjlab_tpu_torch.physics import solver

  marks = []

  def timed(part, fn, *args, **kw):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kw)
    end.record()
    marks.append((part, start, end))
    return out

  cone = tp.dev.con.cone_groups != []
  parts = ("H + direction", "warm start kernel", "linesearch kernel", "rest")
  K = m.opt.iterations
  for _ in range(reps):
    rows = timed("rest", newton.Rows.of, tp, d)
    x, _, grad, w, blocks = timed(parts[1], newton.warm_start, rows,
                                  d.qacc_warmstart.contiguous())
    for k in range(K):
      p = timed(parts[0], solver.direction, rows, grad, w, blocks)
      x, _, _, at = timed(parts[2], newton.newton_linesearch, rows, x, p, m.opt.ls_iterations,
                          cone, forces=k == K - 1)
      if k < K - 1:
        grad, w, blocks = at
  torch.cuda.synchronize()
  out = {part: 0.0 for part in parts}
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
    if str(e.device_type).endswith("CUDA") and e.name not in (*TRAIN_SPANS, SOLVE_SPAN)
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
                     iters: int = TRAIN_ITERS, expect: tuple[str, ...] = PATH_KERNELS,
                     steps: int = TRAIN_STEPS):
  """`iters` `train_iteration`s under set_sync_debug_mode("error") with
  every kernel's counter set to 0 just before and read just after. Checks
  1416 factorizations, 120 `chol_solve` and 120 `warm_start`, 0
  `newton_gradient` and 1200 `newton_linesearch` per iteration (at 10
  Newton iterations; `newton_per_env_step`), finite losses, the lr inside
  [1e-5, 1e-2], the rollout buffers' shapes and that every parameter
  moved. Each iteration runs as
  `timed_iteration`. Returns the launches, the steady ms per iteration
  (CUDA events; with one iteration, that iteration's, its warm-up
  included), each iteration's metrics and the last iteration's split (its
  parts' ms, memory, and (batch, logs, perms)). Each kernel of `expect` must
  have launched. The runner takes `steps` env steps per iteration (the PPO
  cfgs' TRAIN_STEPS, or CUT_STEPS where a phase overrides it); the
  factorizations per env step follow from the env's solver, Newton
  iterations and decimation (`fact_per_env_step`)."""
  import numpy as np

  from mjlab_tpu_torch.kernels import chol, pgs
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays

  if runner.cfg.num_steps_per_env != steps:
    raise AssertionError(f"the runner takes {runner.cfg.num_steps_per_env} steps per env, "
                         f"not {steps}")
  before = runner_state_to_arrays(runner)
  metrics, marks, mems = [], [], []
  reset_counts()
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
  launches = launch_counts()
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
  from mjlab_tpu_torch.physics.types import mjtSolver

  decimation = runner.env.cfg.decimation
  opt = runner.env.sim.model.opt
  per_step = fact_per_env_step(opt.iterations, decimation, opt.solver == mjtSolver.mjSOL_PGS)
  solves = decimation + 1  # each substep's solve_m and the post-reset forward's
  newton_want = {k: steps * v for k, v in newton_per_env_step(opt, decimation).items()}
  print(f"  the Newton iteration's kernels per iteration {newton_want} (newton_per_env_step)")
  if (fact != steps * per_step * iters
      or launches["chol_solve"] != steps * solves * iters
      or any(launches[k] != v * iters for k, v in newton_want.items())
      or any(launches[k] == 0 for k in expect)):
    raise AssertionError(f"{phase}: expected {steps * per_step} factorizations, "
                         f"{steps * solves} solves and {newton_want} per iteration, got "
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
                      split, spans: bool = True, trace: bool = True) -> None:
  """The last training iteration's split by the runner's three calls
  (`split`, from `train_iterations`), then profiles of one rollout step and
  of one more update on that iteration's batch, split by the runner's
  spans; an iteration is T of the one and one of the other, which gives
  its launches and the device's busy share. With `spans` False the
  profiler traces the device only (no host ops, no split by span), which
  parses several times faster; with `trace` False nothing is profiled
  (the split alone). Tables go to OUT/chip_smoke_<tag>_<part>_profile.txt."""
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
  if not trace:
    return
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
              and e.key not in (*TRAIN_SPANS, SOLVE_SPAN)
              and not getattr(e, "is_user_annotation", False)]
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


def warm_learner(arrays: dict, seed: int) -> dict:
  """A warm float64 learner from a runner's arrays: Adam's moments and step
  count and the normalizers' statistics drawn from `seed` (the parameters
  kept), so that a comparison of two iterations does not measure Adam's
  first steps or a fresh normalizer amplifying rounding (f64_iteration_check)."""
  import numpy as np

  draw = np.random.default_rng(seed)
  warm = {}
  for k, v in arrays.items():
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
  return warm


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
    warm = warm_learner(runner_state_to_arrays(runners["cpu"]), seed)
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
  `nudges` reruns of the CPU step with qpos moved by 1e-13 (relative),
  taken only at a step where the card is more than 1e-8 from the CPU
  (relative to that step's max(1, max |CPU|); a spread taken at no other
  step cannot raise the tolerance, so this is the stricter rule). The
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
  nudge_rng = torch.Generator().manual_seed(3)  # the actions stay rng's whether nudged or not
  n_act = envs["cpu"].total_action_dim
  keys = (*envs["cpu"].group_obs_dim, "reward", "qpos")
  spread = dict.fromkeys(keys, 0.0)
  on_step_max, nudged = 0.0, 0
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
    want = outs["cpu"][-1]
    if nudges and any((outs["cuda"][-1][k].cpu() - want[k]).abs().max().item()
                      > 1e-8 * max(1.0, want[k].abs().max().item()) for k in keys):
      nudged += 1
      post = env_state_to_arrays(envs["cpu"])
      for _ in range(nudges):
        q = pre["data.qpos"]
        noise = torch.randn(q.shape, generator=nudge_rng, dtype=torch.float64).numpy()
        env_state_from_arrays(envs["cpu"], {**pre, "data.qpos": q * (1 + 1e-13 * noise)})
        o, r, *_ = envs["cpu"].step(a)
        for key, v in {**o, "reward": r, "qpos": envs["cpu"].data.qpos}.items():
          if key in spread:
            spread[key] = max(spread[key], (v - want[key]).abs().max().item()
                              / max(1.0, want[key].abs().max().item()))
      env_state_from_arrays(envs["cpu"], post)
  print(f"  card (kernels, f64) vs CPU (plain, f64), {task} certain-draw variant, 4 envs x "
        f"{n_steps} env steps" + (f", each from the CPU env's state, tolerance max(1e-8, 2 x "
                                  f"the CPU's spread over {nudges} qpos nudges of 1e-13, "
                                  f"taken at the {nudged} steps more than 1e-8 off):"
                                  if nudges else ":"))
  for key in keys:
    got = torch.stack([o[key].cpu() for o in outs["cuda"][1:]])
    want = torch.stack([o[key] for o in outs["cpu"][1:]])
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    tol = max(1e-8, 2 * spread[key])
    print(f"    {key:8s} max_abs_err {err:.3e} relative {err / scale:.3e} (tol {tol:.3e}"
          + (f", CPU spread {spread[key]:.3e}" if nudged else
             ", CPU spread not needed" if nudges else "") + ")")
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


def run_matrix_kernels(tag: str, tp, d, checks: KernelCheck, path_ms: dict, key: str,
                       card: str) -> None:
  """The four kernels against their plain versions on a run's matrices (n =
  nv, J of nefc rows; f32), timed there beside their plain versions, the
  library calls and their bounds at these shapes; each kernel's ms goes to
  `path_ms[kernel][key]`."""
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.physics import solver

  n = tp.nv
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
    path_ms[k][key] = ms[0]
    print(f"    {k:18s} kernel {ms[0]:.4f} ms  plain {ms[1]:.4f} ms  library "
          f"{ms[2]:.4f} ms  bound {bnd[k][0]:.6f} ms ({bnd[k][1]})")


def task_path(phase: str, task: str, tag: str, obs_dims: tuple[int, int], card: str,
              attr: str, checks: KernelCheck, launches: dict, path_ms: dict,
              after_build=None, on_step=None, after_train=None, ms_key=None,
              iters: int = TRAIN_ITERS, steps: int = TRAIN_STEPS, variant=None) -> dict:
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
  steps each from the CPU's state (`f64_env_check` with nudges and
  `variant`, `on_step` after each card step). Adds the iterations'
  launches to each kernel of `launches` and each kernel's ms on the run's
  matrices to `path_ms` (keyed by `ms_key`, default nv); returns the
  iterations' metrics."""
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
  for k in launches:
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

  run_matrix_kernels(tag, tp, env.data, checks, path_ms, ms_key or str(tp.nv), card)
  del runner, env
  gc.collect()
  torch.cuda.empty_cache()
  on_step_max = f64_env_check(task, n_steps=CUT_F64_STEPS, nudges=6, on_step=on_step,
                              variant=variant)
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
  launches = {k: 0 for k in COUNTED}
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
  task for EARLY_PLAY_STEPS steps on NUM_WORLDS envs, which regenerates
  the terrain on 3 x 3 tiles into the flat scene (phase 19a holds that
  composition to the committed play scene), with the kernels' counters set
  to 0 just before and read just after. Returns the kernels' launches over both tasks'
  iterations and the play, and each kernel's ms on each run's matrices
  (keyed by nv)."""
  import numpy as np

  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.scripts.play import run_play

  t_phase = time.perf_counter()
  launches = {k: 0 for k in COUNTED}
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
  reset_counts()
  t0 = time.perf_counter()
  res = run_play(ROUGH_TASK, {"num_envs": str(NUM_WORLDS), "steps": str(EARLY_PLAY_STEPS),
                              "policy": "random"})
  play_launches = launch_counts()
  env = res.env
  print(f"  run_play {ROUGH_TASK} --policy random: {NUM_WORLDS} envs x {EARLY_PLAY_STEPS} steps in "
        f"{res.seconds:.2f} s ({time.perf_counter() - t0:.2f} s with the build), mean reward "
        f"per step {res.mean_reward:.5f}, scene {Path(env.cfg.scene.model_file).name} + "
        f"the generated terrain, tiles "
        f"{env.scene.terrain.terrain_origins.shape[:2]}, {len(env.tp.terrain_groups[0].pool_geoms)} "
        f"boxes; launches {play_launches} [{card}]")
  if (Path(env.cfg.scene.model_file) != assets.G1_VELOCITY_FLAT
      or env.scene.terrain.terrain_origins.shape[:2] != (3, 3)
      or not np.isfinite(res.mean_reward) or not np.isfinite(res.base_z).all()
      or any(play_launches[k] == 0 for k in PATH_KERNELS)):
    raise AssertionError("phase 12: the rough task's play")
  for k in launches:
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
  from the composed scene against the CPU host's digest; each iteration's
  dropped terrain contacts and mean terrain level; the SAT's launches and
  device time per `collision` call on each run's last state
  (`sat_launches`); then a headless `run_play` of Go1 rough for
  EARLY_PLAY_STEPS steps of the random policy on NUM_WORLDS envs, which
  regenerates the terrain on 3 x 3 tiles, with the kernels' counters set to
  0 just before and read just after. Returns the kernels' launches over the
  tasks' iterations and the play, each kernel's ms on each run's matrices
  (keyed by nv and task) and the SAT's launches by group."""
  import numpy as np

  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.scripts.play import run_play

  t_phase = time.perf_counter()
  launches = {k: 0 for k in COUNTED}
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
        print(f"  feet hulls built here from the composed scene: {sorted(tp.geom_hulls)}, vertices "
              f"{[tp.geom_hulls[g].verts.shape[0] for g in sorted(tp.geom_hulls)]}; digest "
              f"{digest[:16]}... equals the CPU host's: {digest == ASIMOV_HULL_DIGEST}")
        if digest != ASIMOV_HULL_DIGEST:
          raise AssertionError("the Asimov feet's hulls from the composed scene differ")

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
  reset_counts()
  t0 = time.perf_counter()
  res = run_play(go1, {"num_envs": str(NUM_WORLDS), "steps": str(EARLY_PLAY_STEPS),
                       "policy": "random"})
  play_launches = launch_counts()
  env = res.env
  print(f"  run_play {go1} --policy random: {NUM_WORLDS} envs x {EARLY_PLAY_STEPS} steps in "
        f"{res.seconds:.2f} s ({time.perf_counter() - t0:.2f} s with the build), mean reward "
        f"per step {res.mean_reward:.5f}, scene {Path(env.cfg.scene.model_file).name} + "
        f"the generated terrain, tiles "
        f"{env.scene.terrain.terrain_origins.shape[:2]}, "
        f"{len(env.tp.terrain_groups[0].pool_geoms)} boxes; launches {play_launches} [{card}]")
  if (Path(env.cfg.scene.model_file) != assets.GO1_VELOCITY_FLAT
      or env.scene.terrain.terrain_origins.shape[:2] != (3, 3)
      or not np.isfinite(res.mean_reward) or not np.isfinite(res.base_z).all()
      or any(play_launches[k] == 0 for k in PATH_KERNELS)):
    raise AssertionError("phase 13: Go1 rough's play")
  for k in launches:
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
  # No profile (cut in PR 14 to keep the script inside its limit: phase 8
  # profiles the same runner code).
  profile_iteration(runner, card, attr, "tracking", steady_iter_ms, split, trace=False)
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
  calls: `run_train` for 2 iterations of CUT_STEPS env steps with a
  checkpoint after each, then `run_train --agent.resume true` for 1
  iteration with no periodic save
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
  # Iterations of CUT_STEPS env steps (cut from 24): a save, a pull and a
  # resume cost the same after fewer rollout steps.
  base = {"env.scene.num_envs": str(NUM_WORLDS), "log_dir": str(run_dir),
          "agent.num_steps_per_env": str(CUT_STEPS)}
  scaled_ms = steady_iter_ms * CUT_STEPS / TRAIN_STEPS
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

  reset_counts()
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
    over = (f"{learn_ms / scaled_ms - 1:+.4f} over phase 8's steady train_iteration "
            f"{steady_iter_ms:.2f} ms scaled to {CUT_STEPS} env steps, {scaled_ms:.2f} ms")
    print(f"phase 10 run lifecycle: {TASK}, {NUM_WORLDS} envs, f32, in {run_dir} [{card}]")
    alone_ms = learn_ms - (sum(saves[:2]) + pull_ms) / 2
    print(f"  train: run_train, 2 iterations of {CUT_STEPS} env steps, save_interval 1, in "
          f"{t_train:.2f} s; learn "
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
  before = launch_counts()  # the comparison's launches do not count as the path's
  d = env.data
  dev = d.qM.device
  grad = torch.randn(NUM_WORLDS, N, generator=torch.Generator(device=dev).manual_seed(10),
                     device=dev)
  checks.all_three("play qM", d.qM.contiguous(), d.qfrc_smooth.contiguous())
  checks.newton("play qM,J,w", d.qM, d.efc_J, solver.newton_weights(d, d.qacc), grad)
  compared = {k: launch_counts()[k] - before[k] for k in before}

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
  launches = {k: v - compared[k] for k, v in launch_counts().items()}
  print(f"  phase 10 in {time.perf_counter() - t_phase:.1f} s; launches {launches}")
  if any(launches[k] == 0 for k in PATH_KERNELS):
    raise AssertionError(f"phase 10: a kernel was not launched: {launches}")
  return launches


# Phase 14's cells: G1 under the elliptic cone and under CG, and the solver
# surface's scenes (mjlab_tpu_torch/assets/solver_scenes.py).
ELLIPTIC_NEFC = 1320  # 29 limit rows + 154 condim-1 rows + 379 cone slots x 3
CG_STEPS = 6  # env steps of G1 under CG (cut from 10)
SCENE_SUBSTEPS = 6  # cut from 50, 30, 20 and 12 to keep the script in its limit
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
  (CUT_ITERS iteration of CUT_STEPS env steps at 4096 envs through
  build_runner, the CLI's override; cut from 2 of 24, the steps in PR 14),
  with
  phase 8's checks (no profile: cut in PR 14), nefc 1320 and every Newton
  direction through newton_direction_cone; then the kernel against its
  plain version on the run's last matrices (f32 and f64), its times, and
  the card's float64 env against the CPU's. Returns the launches and the
  kernel's numbers for the JSON line."""
  from mjlab_tpu_torch.kernels import chol, newton
  from mjlab_tpu_torch.physics import solver
  from mjlab_tpu_torch.scripts.train import build_runner

  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  over = {"env.scene.num_envs": str(NUM_WORLDS), "env.sim.mujoco.cone": "elliptic",
          "agent.num_steps_per_env": str(CUT_STEPS)}
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
    expect=KERNELS[:3] + NEWTON_KERNELS[:2] + (CONE_KERNEL,), steps=CUT_STEPS)
  it = env.sim.model.opt.iterations
  per_iter = CUT_STEPS * (DECIMATION * it + it)
  print(f"  {CONE_KERNEL} launches {got[CONE_KERNEL]} = {got[CONE_KERNEL] / CUT_ITERS:.0f} "
        f"per iteration (expected {per_iter}: {CUT_STEPS} env steps x (4 substeps + the "
        f"post-reset forward) x {it}); newton_direction {got['newton_direction']}")
  if got[CONE_KERNEL] != per_iter * CUT_ITERS or got["newton_direction"] != 0:
    raise AssertionError(f"phase 14 elliptic: launches {got}")
  # No profile (cut in PR 14: 31 s of the script; PERF.md §5 keeps PR
  # 10-13's busy share and launches).
  profile_iteration(runner, card, attr, "g1_elliptic", steady_iter_ms, split, trace=False)
  del split

  d, n = env.data, tp.nv
  gen = newton.Rows.of(tp, d)
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
  del args, args64, x64, got64, qM, J, w, Bc
  # The Newton iteration's kernels on the run's rows (the elliptic
  # safeguard's acceptance), from a0 along its Newton direction.
  iter_res = iteration_kernels("the G1 elliptic run's rows", gen, *iteration_inputs(gen),
                               env.sim.model.opt.ls_iterations, True, checks, card)
  print_iteration_launch("G1 elliptic, f32", torch.float32, n, tp.nefc, layout.table.shape[0])
  del runner, env, d, gen, r
  gc.collect()
  torch.cuda.empty_cache()
  f64_env_check(TASK, n_steps=CUT_F64_STEPS, nudges=PHASE14_NUDGES,
                overrides={"sim.mujoco.cone": "elliptic"})
  return {"launches": got, "iter": iter_res, "ms": ms, "plain_ms": plain_ms,
          "library_ms": lib_ms,
          "bound": bnd, "steady_iter_ms": steady_iter_ms, "launch": launch}


def cg_path(card: str, checks: KernelCheck) -> tuple[dict[str, int], dict]:
  """Phase 14, part 2: G1 velocity-flat under solver="cg", 10 env steps of
  N(0, 1) actions at 4096 envs under set_sync_debug_mode("error"): ms per
  env step, and the Cholesky launches per env step against the code's count
  (per forward, M's factor and CG's factor of M + 1e-12·I, M's solve for
  qacc_smooth and CG's iterations solves, one per iteration but the last;
  4 substeps and the post-reset
  forward, and the integrator's factor-solve per substep) and the Newton
  iteration's (`newton_per_env_step`); the three kernels against their plain
  versions on the run's last state (`iteration_kernels`); then the card's
  float64 env against the CPU's."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.kernels import newton
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
  want = {"chol_factor": 2 * forwards, "chol_solve": (1 + it) * forwards,
          "chol_factor_solve": DECIMATION, "newton_direction": 0, CONE_KERNEL: 0,
          **newton_per_env_step(env.sim.model.opt)}
  gen = torch.Generator(device="cuda").manual_seed(3)
  actions = [torch.randn(NUM_WORLDS, env.total_action_dim, generator=gen, device="cuda")
             for _ in range(CG_STEPS)]
  env.step(actions[0])
  torch.cuda.synchronize()
  reset_counts()
  torch.cuda.set_sync_debug_mode("error")
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  start.record()
  for a in actions[1:]:
    obs, rew, *_ = env.step(a)
  end.record()
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  steps = CG_STEPS - 1
  launches = launch_counts()
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
  rows = newton.Rows.of(env.tp, env.data)
  iter_res = iteration_kernels("the G1 CG run's rows", rows, *iteration_inputs(rows),
                               env.sim.model.opt.ls_iterations, False, checks, card)
  del env, obs, rew, actions, rows
  gc.collect()
  torch.cuda.empty_cache()
  f64_env_check(TASK, n_steps=CUT_F64_STEPS, nudges=PHASE14_NUDGES,
                overrides={"sim.mujoco.solver": "cg"})
  return launches, iter_res


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
  total = {k: 0 for k in (*COUNTED, PGS_KERNEL)}
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
      reset_counts()
      d = physics.step(tp, m, d)
      torch.cuda.synchronize()
      start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(SCENE_SUBSTEPS - 1):
        d = physics.step(tp, m, d)
      end.record()
      torch.cuda.synchronize()
      launched = {k: v for k, v in launch_counts().items() if v}
      for k, v in launch_counts().items():
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
  NUM_WORLDS envs with the G1 PPO cfg: CUT_ITERS iteration (cut from 2 in
  PR 14) with phase 8's checks, the policy obs 3 x 99 wide, each
  randomized leaf changed per env on its elements only and inside its
  range, the launches per iteration equal to phase 8's, the iteration's
  time (its warm-up in) against phase 8's steady one in this call (no
  profile: cut in PR 14); the four kernels against their plain versions on this run's
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
  # run's TRAIN_STEPS: start every env's push clock so that it fires in the
  # iteration, at its 12th env step.
  clock = env.ns("event")["interval_time_left"]
  clock["push_wrench"] = torch.full_like(clock["push_wrench"],
                                         (0.5 * TRAIN_STEPS - 0.5) * env.step_dt)
  got, iter_ms, _, split = train_iterations(runner, card, "phase 15", dims, iters=CUT_ITERS)
  print(f"  ms of its iteration (warm-up in) {iter_ms:.2f} against phase 8's steady "
        f"{steady_iter_ms:.2f} in this call: {100 * (iter_ms / steady_iter_ms - 1):+.2f}% "
        f"[{card}]")
  if any(got[k] * TRAIN_ITERS != train_launches[k] * CUT_ITERS for k in PATH_KERNELS):
    raise AssertionError(f"phase 15: launches {got} differ from phase 8's {train_launches}")
  profile_iteration(runner, card, attr, "surface", iter_ms, split, trace=False)  # cut, PR 14
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

  f64_env_check(SURFACE_TASK, n_steps=4, nudges=2, variant=all_fields_variant,
                on_step=every_field_per_env)
  print("  every FIELD_SPECS row per env in the f64 check: " + ", ".join(sorted(FIELD_SPECS)))
  return got


# Phase 16: a user's own robot and task.
CARTPOLE_DOC = Path(__file__).resolve().parent / "docs" / "CREATE_NEW_TASK_TORCH.md"
CARTPOLE_TASK = "Mjlab-Cartpole"
# The learning check, in the form of tests/test_doc_cartpole.py's
# test_ppo_learns_cartpole: CARTPOLE_LEARN_ITERS iterations of
# CARTPOLE_LEARN_STEPS env steps at 4096 envs (the guide's runner cfg
# otherwise), the first and last CARTPOLE_WINDOW of them compared. Fixed
# from a measured run that fit about 60 s and passed with margin (PERF.md
# §4: 30 iterations of 6 steps in 67.3 s on an NVIDIA H100 80GB HBM3 at
# 700.00 W, noise std 0.998 -> 0.664; at 4 steps the std fell only to
# 0.897 in 40 iterations). Cut to 24 in PR 14, after 30 took 125.7 s on a
# slower host: 78.66 s on PERF.md §4's host and card, the last 10
# iterations 2.82x the first 10's episode length, the std 0.998 -> 0.736.
CARTPOLE_LEARN_ITERS = 24
CARTPOLE_LEARN_STEPS = 6
CARTPOLE_WINDOW = 10
# The humanoid's f32 run: substeps, and the Newton budget of the velocity
# tasks' cfgs (its compiled 100 x 50 is MuJoCo's default).
HUMANOID_SUBSTEPS = 15  # cut from 30
HUMANOID_BUDGET = (10, 20)
# The sensor types the port's catalog added in PR 13, each of which must be
# evaluated on the card (mjtSensor values).
USER_SENSOR_TYPES = (0, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 20, 21, 22, 33, 34, 35,
                     36, 43, 44, 45)


def run_guide(path: Path) -> dict:
  """Exec a guide's python blocks verbatim, in order, in one namespace,
  leaving out its full-scale training block (`OnPolicyRunner(env`)."""
  import re

  ns: dict = {}
  blocks = re.findall(r"```python\n(.*?)```", path.read_text(), flags=re.DOTALL)
  for i, block in enumerate(blocks):
    if "OnPolicyRunner(env" not in block:
      exec(compile(block, f"{path.name}[block {i}]", "exec"), ns)
  return ns


def cartpole_certain_variant(cfg) -> None:
  """The CartPole task with every draw certain (the reset offsets, the
  push's clock and size), so that two generators give the same rollout;
  the push fires every 0.1 s (5 env steps)."""
  reset, push = cfg.events["reset_joints"], cfg.events["push"]
  reset.params["position_range"] = (0.05, 0.05)
  reset.params["velocity_range"] = (-0.02, -0.02)
  push.interval_range_s = (0.1, 0.1)
  push.params["velocity_range"] = (0.3, 0.3)


def kernels_f64(tag: str, tp, d) -> None:
  """The four kernels in float64 against their plain versions on a run's
  matrices cast to float64 (qM, the Newton matrix at the run's qacc, its
  weights and J): 1e-10 relative to max(1, max |plain|)."""
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.physics import solver

  gen = torch.Generator(device="cuda").manual_seed(16)
  qM, J = d.qM.double().contiguous(), d.efc_J.double().contiguous()
  H = solver.hessian(d, d.qacc).double().contiguous()
  w = solver.newton_weights(d, d.qacc).double().contiguous()
  b = d.qfrc_smooth.double().contiguous()
  grad = torch.randn(qM.shape[:2], generator=gen, device="cuda", dtype=torch.float64)
  Lp = chol.chol_factor_plain(qM)
  pairs = {
    "chol_factor": (chol.chol_factor(qM), Lp),
    "chol_solve": (chol.chol_solve(Lp, b), chol.chol_solve_plain(Lp, b)),
    "chol_factor_solve": (chol.chol_factor_solve(H, grad), chol.chol_factor_solve_plain(H, grad)),
    "newton_direction": (chol.newton_direction(qM, J, w, grad),
                         chol.newton_direction_plain(qM, J, w, grad)),
  }
  errs = {}
  for k, (got, want) in pairs.items():
    errs[k] = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
  print(f"  kernels vs plain on the {tag} run's matrices, f64, n = {tp.nv}: relative "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (tol 1e-10)")
  if not max(errs.values()) <= 1e-10:
    raise AssertionError(f"phase 16 {tag}: a float64 kernel differs from its plain version: {errs}")


def cartpole_learning(ns: dict, card: str) -> dict:
  """CARTPOLE_LEARN_ITERS iterations of a fresh runner of the guide's task
  (seed 1, CARTPOLE_LEARN_STEPS env steps each): the mean episode length
  over the last CARTPOLE_WINDOW iterations more than twice that over the
  first, and the noise std annealed (last < 0.8 x first). A window's mean
  length counts the episodes that ended in it and, at their length so far,
  the episodes still running at its end: a policy that balances ends no
  episode for 500 env steps, which would leave the first of these empty."""
  import numpy as np

  runner = ns["cartpole_runner"](NUM_WORLDS, seed=1,
                                 num_steps_per_env=CARTPOLE_LEARN_STEPS)
  env = runner.env
  metrics, running = [], {}
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(CARTPOLE_LEARN_ITERS):
    metrics.append(runner.train_iteration())
    if i + 1 in (CARTPOLE_WINDOW, CARTPOLE_LEARN_ITERS):
      running[i + 1] = env.episode_length_buf.double().sum().item()
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  keys = ("Train/mean_episode_length", "Train/resets", "Policy/noise_std",
          "Train/mean_step_reward", "Loss/loss")
  host = [{k: float(m[k]) for k in keys} for m in metrics]

  def window(lo: int, hi: int) -> float:
    ended = sum(h["Train/mean_episode_length"] * h["Train/resets"] for h in host[lo:hi])
    count = sum(h["Train/resets"] for h in host[lo:hi])
    return (ended + running[hi]) / (count + NUM_WORLDS)

  early = window(0, CARTPOLE_WINDOW)
  late = window(CARTPOLE_LEARN_ITERS - CARTPOLE_WINDOW, CARTPOLE_LEARN_ITERS)
  std0, std1 = host[0]["Policy/noise_std"], host[-1]["Policy/noise_std"]
  print(f"  learning: {CARTPOLE_LEARN_ITERS} iterations of {CARTPOLE_LEARN_STEPS} env steps at "
        f"{NUM_WORLDS} envs in {secs:.2f} s ({secs / CARTPOLE_LEARN_ITERS * 1e3:.2f} ms per "
        f"iteration) [{card}]")
  print("  curve (iteration: mean episode length of the episodes that ended, resets, noise "
        "std, mean step reward): " + "; ".join(
          f"{i}: {h['Train/mean_episode_length']:.1f}, {h['Train/resets']:.0f}, "
          f"{h['Policy/noise_std']:.3f}, {h['Train/mean_step_reward']:.4f}"
          for i, h in enumerate(host)))
  print(f"  mean episode length over iterations 0-{CARTPOLE_WINDOW - 1} {early:.2f}, over the "
        f"last {CARTPOLE_WINDOW} {late:.2f} (x{late / early:.2f}, must exceed 2); noise std "
        f"{std0:.4f} -> {std1:.4f} (must fall below 0.8 x)")
  if not all(np.isfinite(h["Loss/loss"]) for h in host):
    raise AssertionError("phase 16 learning: a non-finite loss")
  if not (late > 2.0 * early and std1 < 0.8 * std0):
    raise AssertionError(f"phase 16: CartPole did not learn (episode length {early:.2f} -> "
                         f"{late:.2f}, noise std {std0:.4f} -> {std1:.4f})")
  return {"early": early, "late": late, "std": (std0, std1), "seconds": secs}


def cartpole_path(card: str, checks: KernelCheck, path_ms: dict) -> dict[str, int]:
  """Phase 16, part 1: the CartPole tutorial from its guide's blocks, run
  verbatim (they register the task): `cartpole_runner` at NUM_WORLDS envs
  with the guide's default runner cfg at CUT_STEPS env steps per
  iteration (cut from 24), phase 8's checks over 2 iterations (2 substeps
  of 10 Newton directions: 35 factorizations and 3 chol_solve per env
  step), the kernels against their plain versions on the run's
  matrices (n = 2, f32 and f64) and their times there; the learning check;
  the card's float64 env against the CPU's on the certain-draw variant, 4
  envs x 8 env steps (1e-8). Returns the 2 iterations' launches."""
  from mjlab_tpu_torch import tasks

  gc.collect()
  torch.cuda.empty_cache()
  ns = run_guide(CARTPOLE_DOC)
  if CARTPOLE_TASK not in tasks.list_tasks():
    raise AssertionError(f"phase 16: the guide did not register {CARTPOLE_TASK}")
  t0 = time.perf_counter()
  runner = ns["cartpole_runner"](NUM_WORLDS, num_steps_per_env=CUT_STEPS)
  torch.cuda.synchronize()
  env, tp = runner.env, runner.env.tp
  print(f"phase 16a the CartPole tutorial ({CARTPOLE_DOC.name}'s blocks run verbatim): "
        f"{CARTPOLE_TASK}, {NUM_WORLDS} envs, nv {tp.nv}, Newton rows {tp.nefc}, obs "
        f"{env.group_obs_dim}, actions {runner.num_actions}, decimation {env.cfg.decimation}, "
        f"episodes {env.cfg.episode_length_s} s, T {runner.cfg.num_steps_per_env}, hidden "
        f"{runner.cfg.policy.actor_hidden_dims}, Newton {env.sim.model.opt.iterations} x "
        f"{env.sim.model.opt.ls_iterations}; cartpole_runner {time.perf_counter() - t0:.2f} s "
        f"[{card}]")
  if env.group_obs_dim != {"policy": (4,)} or tp.nv != 2 or runner.num_actions != 1:
    raise AssertionError(f"phase 16: CartPole shapes {env.group_obs_dim}, nv {tp.nv}")
  got, _, _, split = train_iterations(runner, card, "phase 16 cartpole", (4, 4),
                                      steps=CUT_STEPS)
  del split
  run_matrix_kernels("cartpole", tp, env.data, checks, path_ms, "2", card)
  kernels_f64("cartpole", tp, env.data)
  del runner, env
  gc.collect()
  torch.cuda.empty_cache()
  cartpole_learning(ns, card)
  gc.collect()
  torch.cuda.empty_cache()
  f64_env_check(CARTPOLE_TASK, n_steps=8, variant=cartpole_certain_variant)
  return got


def scene_state(sc, tp, m, worlds: int, rng: torch.Generator, qvel_std: float = 0.05):
  """A surface scene's state at `worlds` worlds (its JAX test's qpos, ctrl,
  time and mocap target; its velocity plus a seeded N(0, qvel_std²) per
  world), as CPU float64 (qpos, qvel, ctrl, time, mocap_pos)."""
  from mjlab_tpu_torch import physics

  d = physics.make_data(tp, m, worlds)
  qpos = d.qpos.cpu() if sc.qpos is None else torch.tensor(sc.qpos).expand(worlds, -1).clone()
  qvel = torch.zeros(worlds, tp.nv, dtype=torch.float64)
  qvel[:, :len(sc.qvel)] = torch.tensor(sc.qvel, dtype=torch.float64)
  qvel += qvel_std * torch.randn(worlds, tp.nv, generator=rng, dtype=torch.float64)
  ctrl = torch.zeros(worlds, tp.nu, dtype=torch.float64)
  ctrl[:, :len(sc.ctrl)] = torch.tensor(sc.ctrl, dtype=torch.float64)
  mocap = d.mocap_pos.cpu().double()
  if sc.mocap_pos is not None:
    mocap[:] = torch.tensor(sc.mocap_pos, dtype=torch.float64)
  return qpos.double(), qvel, ctrl, torch.full((worlds,), sc.time, dtype=torch.float64), mocap


def user_scenes_path(card: str, checks: KernelCheck, path_ms: dict):
  """Phase 16, part 2: each scene of assets/surface_scenes.py under each of
  its cones, float64, SCENE_SUBSTEPS at NUM_WORLDS worlds from its state
  (`scene_state`), through physics.step: ms per substep (CUDA events),
  every qpos, qvel and sensor finite, the first SCENE_CPU_WORLDS worlds
  against the CPU (1e-8, or twice the CPU's own spread under
  PHASE14_NUDGES qpos nudges of 1e-13, phase 14's rule), every sensor type
  of USER_SENSOR_TYPES evaluated; then the humanoid in float32 at
  HUMANOID_BUDGET Newton iterations for HUMANOID_SUBSTEPS (ms per
  substep, the five kernels' launches: 12 factorizations and 1 chol_solve
  per substep), the kernels against their plain versions on its matrices
  (n = 27, f32 and f64) and their times there, and, under the elliptic
  cone, newton_direction_cone on its matrices (f32 and f64). Returns the
  launches of the scenes' and the humanoid's runs."""
  from mjlab_tpu_torch import physics
  from mjlab_tpu_torch.assets import surface_scenes
  from mjlab_tpu_torch.kernels import chol, newton
  from mjlab_tpu_torch.physics import solver

  torch.set_num_threads(1)
  total = {k: 0 for k in (*COUNTED, PGS_KERNEL)}
  seen: set[int] = set()
  print(f"phase 16b the surface scenes: {SCENE_SUBSTEPS} substeps at {NUM_WORLDS} worlds, "
        f"float64, {SCENE_ITERATIONS} iterations x {SCENE_LS_ITERATIONS} linesearch steps; the "
        f"first {SCENE_CPU_WORLDS} worlds against the CPU (tol 1e-8) [{card}]")

  def run(tp, m, state, steps):
    qpos, qvel, ctrl, t, mocap = state
    dv = m.qpos0.device
    d = physics.make_data(tp, m, qpos.shape[0]).replace(
      qpos=qpos.to(dv), qvel=qvel.to(dv), ctrl=ctrl.to(dv), time=t.to(dv),
      mocap_pos=mocap.to(dv))
    for _ in range(steps):
      d = physics.step(tp, m, d)
    return d

  def rel(a, b):
    return max((getattr(a, f).cpu() - getattr(b, f)).abs().max().item()
               / max(1.0, getattr(b, f).abs().max().item()) for f in ("qpos", "qvel"))

  for name, sc in surface_scenes.SCENES.items():
    for cone in sc.cones:
      models = {}
      for dv in ("cuda", "cpu"):
        mjm = surface_scenes.load(name, cone)
        mjm.opt.iterations, mjm.opt.ls_iterations = SCENE_ITERATIONS, SCENE_LS_ITERATIONS
        models[dv] = physics.put_model(mjm, dtype=torch.float64, device=dv)
      tp, m = models["cuda"]
      rng = torch.Generator().manual_seed(16)
      state = scene_state(sc, tp, m, NUM_WORLDS, rng)
      reset_counts()
      d = run(tp, m, state, 1)
      torch.cuda.synchronize()
      start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(SCENE_SUBSTEPS - 1):
        d = physics.step(tp, m, d)
      end.record()
      torch.cuda.synchronize()
      launched = {k: v for k, v in launch_counts().items() if v}
      for k, v in launch_counts().items():
        total[k] += v
      if not all(torch.isfinite(getattr(d, f)).all() for f in ("qpos", "qvel", "sensordata")):
        raise AssertionError(f"phase 16 scene {name} (cone {cone}): non-finite state or sensor")
      seen |= {int(t) for t in tp.sensor_type}
      tp_c, m_c = models["cpu"]
      cpu_state = tuple(x[:SCENE_CPU_WORLDS] for x in state)
      ref = run(tp_c, m_c, cpu_state, SCENE_SUBSTEPS)
      card_d = SimpleNamespace(qpos=d.qpos[:SCENE_CPU_WORLDS], qvel=d.qvel[:SCENE_CPU_WORLDS])
      err, tol, spread = rel(card_d, ref), 1e-8, None
      if err > tol:
        q0 = cpu_state[0]
        spread = max(
          rel(run(tp_c, m_c, (q0 * (1 + 1e-13 * torch.randn(q0.shape, generator=rng,
                                                             dtype=torch.float64)),
                              *cpu_state[1:]), SCENE_SUBSTEPS), ref)
          for _ in range(PHASE14_NUDGES))
        tol = max(tol, 2 * spread)
      print(f"  {name:20s} cone {cone} nv {tp.nv:2d} nefc {tp.nefc:3d} sensors {tp.nsensor:2d}: "
            f"{start.elapsed_time(end) / (SCENE_SUBSTEPS - 1):.3f} ms per substep; card vs CPU "
            f"{err:.3e} (tol {tol:.3e}" + (f", CPU spread {spread:.3e}" if spread is not None
                                           else "") + f"); launches {launched}")
      if not err <= tol:
        raise AssertionError(f"phase 16 scene {name} (cone {cone}): card vs CPU {err:.3e}")
  missing = sorted(set(USER_SENSOR_TYPES) - seen)
  print(f"  sensor types evaluated on the card: {sorted(seen)}; PR 13's {len(USER_SENSOR_TYPES)} "
        f"all among them: {not missing}")
  if missing:
    raise AssertionError(f"phase 16: sensor types {missing} not evaluated on the card")

  # The humanoid in float32 at the velocity tasks' Newton budget.
  sc = surface_scenes.SCENES["humanoid"]
  mjm = surface_scenes.load("humanoid")
  mjm.opt.iterations, mjm.opt.ls_iterations = HUMANOID_BUDGET
  tp, m = physics.put_model(mjm, dtype=torch.float32, device="cuda")
  rng = torch.Generator().manual_seed(27)
  qpos, qvel, ctrl, t, mocap = scene_state(sc, tp, m, NUM_WORLDS, rng, qvel_std=0.0)
  qvel[:, 6:] = 0.3 * torch.randn(NUM_WORLDS, tp.nv - 6, generator=rng, dtype=torch.float64)
  ctrl = 0.1 * (2 * torch.rand(NUM_WORLDS, tp.nu, generator=rng, dtype=torch.float64) - 1)
  d = physics.make_data(tp, m, NUM_WORLDS).replace(
    qpos=qpos.float().cuda(), qvel=qvel.float().cuda(), ctrl=ctrl.float().cuda())
  d = physics.step(tp, m, d)
  torch.cuda.synchronize()
  reset_counts()
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(HUMANOID_SUBSTEPS):
    d = physics.step(tp, m, d)
  end.record()
  torch.cuda.synchronize()
  hum = launch_counts()
  for k, v in hum.items():
    total[k] += v
  ms = start.elapsed_time(end) / HUMANOID_SUBSTEPS
  active = (d.contact.dist < d.contact.includemargin).sum(1).float()
  print(f"  humanoid f32: {NUM_WORLDS} worlds, nv {tp.nv}, Newton rows {tp.nefc}, "
        f"{HUMANOID_BUDGET[0]} x {HUMANOID_BUDGET[1]} Newton iterations, {HUMANOID_SUBSTEPS} "
        f"substeps: {ms:.3f} ms per substep, {NUM_WORLDS / ms * 1e3:.1f} physics-steps/s; "
        f"active contacts per world mean {active.mean().item():.2f}; root height mean "
        f"{d.qpos[:, 2].mean().item():.3f} m; launches {hum} [{card}]")
  if not all(torch.isfinite(getattr(d, f)).all() for f in ("qpos", "qvel", "sensordata")):
    raise AssertionError("phase 16 humanoid f32: non-finite state or sensor")
  it = HUMANOID_BUDGET[0]
  if (chol.factorizations() != (it + 2) * HUMANOID_SUBSTEPS
      or hum["chol_solve"] != HUMANOID_SUBSTEPS or hum["newton_direction"] != it * HUMANOID_SUBSTEPS
      or not active.sum() > 0):
    raise AssertionError(f"phase 16 humanoid: launches {hum} or no contact")
  run_matrix_kernels("humanoid", tp, d, checks, path_ms, str(tp.nv), card)
  kernels_f64("humanoid", tp, d)

  # Under the elliptic cone: newton_direction_cone on the humanoid's matrices.
  mjm.opt.cone = 1
  tp_e, m_e = physics.put_model(mjm, dtype=torch.float32, device="cuda")
  d_e = physics.make_data(tp_e, m_e, NUM_WORLDS).replace(
    qpos=qpos.float().cuda(), qvel=qvel.float().cuda(), ctrl=ctrl.float().cuda())
  reset_counts()
  for _ in range(3):
    d_e = physics.step(tp_e, m_e, d_e)
  torch.cuda.synchronize()
  ell = launch_counts()
  for k, v in ell.items():
    total[k] += v
  layout = tp_e.dev.con.cone_kernel_layout
  gcost = newton.Rows.of(tp_e, d_e)
  r = gcost.residual(d_e.qacc)
  w, Bc = gcost.row_hess(r), gcost.cone_blocks(r)
  grad = torch.randn(NUM_WORLDS, tp_e.nv, generator=torch.Generator(device="cuda").manual_seed(6),
                     device="cuda")
  args = (d_e.qM.contiguous(), d_e.efc_J.contiguous(), w.contiguous(), grad, Bc.contiguous())
  args64 = tuple(a.double() for a in args)
  x64 = chol.newton_direction_cone_plain(*args64, layout)
  checks.check(CONE_KERNEL, "humanoid ell.", chol.newton_direction_cone(*args, layout),
               chol.newton_direction_cone_plain(*args, layout), x64)
  got64 = chol.newton_direction_cone(*args64, layout)
  err64 = (got64 - x64).abs().max().item() / max(1.0, x64.abs().max().item())
  cone_ms = time_ms(lambda: chol.newton_direction_cone(*args, layout), [()])
  print(f"  humanoid under the elliptic cone: {layout.table.shape[0]} cone slots, 3 substeps, "
        f"launches {ell}; {CONE_KERNEL} on its matrices f64 relative "
        f"{err64:.3e} (tol 1e-10), f32 {cone_ms:.4f} ms [{card}]")
  if not err64 <= 1e-10 or ell[CONE_KERNEL] != 3 * it or ell["newton_direction"]:
    raise AssertionError(f"phase 16 humanoid elliptic: {err64:.3e}, launches {ell}")
  path_ms[CONE_KERNEL][str(tp_e.nv)] = cone_ms
  return total



PGS_KERNEL = "pgs_solve"
PGS_ENV_STEPS = 10  # env steps of G1 under PGS, timed under set_sync_debug_mode("error")
# Worlds per call of the plain PGS: it forms A, 512 x 1699² x 8 B = 11.8 GB in f64.
PGS_PLAIN_CHUNK = 512
# Phase 17b's scenes run phase 14's small Newton budget; a PGS scene keeps
# its own sweeps (100 and 60: the kernel's rows, not its launches).
MUSCLE_SUBSTEPS = 6  # cut from 30 and 12
HOPPER_ENVS = NUM_WORLDS
_INTEGRATOR_NAMES = {0: "Euler", 1: "RK4", 3: "implicitfast"}


def pgs_plain_chunked(args: tuple, iterations: int):
  """pgs_solve_plain over the batch in chunks of PGS_PLAIN_CHUNK worlds (the
  plain version forms A per world)."""
  from mjlab_tpu_torch.kernels import pgs

  out = [pgs.pgs_solve_plain(*(a[s:s + PGS_PLAIN_CHUNK] for a in args), iterations)
         for s in range(0, args[0].shape[0], PGS_PLAIN_CHUNK)]
  return tuple(torch.cat(parts) for parts in zip(*out))


def pgs_args(tp, d) -> tuple:
  """pgs_solve's inputs on a state: (L, J, a0, aref, D, lo, hi), as
  solver._pgs hands them to the kernel."""
  from mjlab_tpu_torch.physics import solver

  D, lo, hi = solver.pgs_inputs(tp, d)
  return tuple(t.contiguous() for t in (d.qLD, d.efc_J, d.qacc_smooth, d.efc_aref, D, lo, hi))


def pgs_bound(args: tuple, iterations: int) -> tuple[float, str]:
  """Least time (ms) of pgs_solve on these inputs (L, J, a0, aref, D, lo,
  hi): bytes of L's lower triangle and a0, D read and f written for every
  row, J, aref, lo and hi read for the active rows only, u and qfrc written
  once; operations per active row 2 nv² (w_i), 2 nv each for b_i, the
  diagonal and its share of qfrc, and 4 nv per sweep (a dot and an axpy
  with u)."""
  L, J, D = args[0], args[1], args[4]
  B, n, m = L.shape[0], L.shape[1], J.shape[1]
  elem = L.element_size()
  active = int((D > 0).sum().item())
  byt = (2 * B * m + active * (n + 3) + B * n * (n + 1) // 2 + 3 * B * n) * elem
  flop = active * (2 * n * n + 6 * n + 4 * n * iterations)
  tb, tf = byt / PEAK_BYTES * 1e3, flop / PEAK_F32 * 1e3
  return max(tb, tf), ("bytes" if tb >= tf else "operations")


def pgs_env():
  """G1 velocity-flat under solver="pgs" (the CLI's override) at NUM_WORLDS
  envs, reset with seed 0, and the seeded actions of phase 17a's warm-up
  step and its PGS_ENV_STEPS env steps."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.scripts.cli import apply_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfg = load_env_cfg(TASK)
  apply_overrides(cfg, {"scene.num_envs": str(NUM_WORLDS), "sim.mujoco.solver": "pgs"})
  env = ManagerBasedRlEnv(cfg, device="cuda")
  env.reset(seed=0)
  gen = torch.Generator(device="cuda").manual_seed(17)
  actions = [torch.randn(NUM_WORLDS, env.total_action_dim, generator=gen, device="cuda")
             for _ in range(PGS_ENV_STEPS + 1)]
  return env, actions


def pgs_path(card: str, checks: KernelCheck) -> dict:
  """Phase 17a: G1 velocity-flat under solver="pgs" (the CLI's override)
  at NUM_WORLDS envs, float32: PGS_ENV_STEPS env steps under
  set_sync_debug_mode("error") with every count set to 0 just before and
  read just after (one pgs_solve per forward: 4 substeps and the post-reset
  forward; M's factor and solve per forward, the integrator's factor-solve
  per substep; no Newton direction), ms per env step, the active rows per
  world; the kernel's launch (worlds resident per SM, registers, spills);
  the kernel against its plain version on the run's own rows, for f, u and
  qfrc (f32: KernelCheck's rule; f64, the same rows and factor cast: 1e-10
  relative), timed beside the plain version and its bound, and its ns per
  dependent row update (ms / (sweeps x the most active rows of a world));
  one PPO iteration of
  CUT_STEPS env steps through build_runner with phase 8's checks; and the
  card's float64 env against the CPU's (phase 14's rule)."""
  from mjlab_tpu_torch.kernels import chol, pgs
  from mjlab_tpu_torch.scripts.train import build_runner

  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  env, actions = pgs_env()
  tp, it = env.tp, env.sim.model.opt.iterations
  forwards = DECIMATION + 1
  want = {"chol_factor": forwards, "chol_solve": forwards, "chol_factor_solve": DECIMATION,
          "newton_direction": 0, CONE_KERNEL: 0, PGS_KERNEL: forwards,
          **newton_per_env_step(env.sim.model.opt)}
  env.step(actions[0])
  torch.cuda.synchronize()
  print(f"phase 17 pgs: {TASK} --env.sim.mujoco.solver pgs ({it} sweeps), {NUM_WORLDS} envs, "
        f"nv {tp.nv}, rows {tp.nefc}; build, reset and a warm-up step "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
  finite = torch.ones((), dtype=torch.bool, device="cuda")
  reset_counts()
  torch.cuda.set_sync_debug_mode("error")
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  start.record()
  for a in actions[1:]:
    obs, rew, *_ = env.step(a)
    finite &= torch.isfinite(rew).all() & torch.isfinite(obs["policy"]).all()
    finite &= torch.isfinite(env.data.qpos).all()
  end.record()
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  launches = launch_counts()
  env_step_ms = start.elapsed_time(end) / PGS_ENV_STEPS
  print(f"  {PGS_ENV_STEPS} env steps under set_sync_debug_mode('error'): no host-device "
        f"synchronization; {env_step_ms:.2f} ms per env step [{card}]")
  print("  launches per env step " + ", ".join(f"{k} {v / PGS_ENV_STEPS:g}"
                                            for k, v in launches.items())
        + f"; from the code: {want}")
  if any(launches[k] != v * PGS_ENV_STEPS for k, v in want.items()):
    raise AssertionError(f"phase 17 pgs: launches {launches}, expected {want} per env step")
  if not finite.item():
    raise AssertionError("phase 17 pgs: non-finite observation, reward or qpos")
  d = env.data
  per_world = (d.efc_D > 0).sum(1).float()
  z = d.qpos[:, 2]
  print(f"  the run's last state: active rows per world mean {per_world.mean().item():.2f}, "
        f"min {int(per_world.min().item())}, max {int(per_world.max().item())} of {tp.nefc} "
        f"(share {per_world.mean().item() / tp.nefc:.4f}); root height mean "
        f"{z.mean().item():.3f} m")

  args = pgs_args(tp, d)
  args64 = tuple(a.double() for a in args)
  del env, d, obs, rew, actions
  gc.collect()
  torch.cuda.empty_cache()
  launch = pgs.launch_config(torch.float32, tp.nv)
  print(f"  {PGS_KERNEL} launch (f32, N {launch['N']}): {launch['worlds_per_sm']} worlds "
        f"resident per SM x {launch['sms']} SMs, {launch['registers']} registers and "
        f"{launch['spill_bytes']} spill bytes per thread, {launch['shared_bytes']} shared bytes "
        f"per world")
  out = pgs.pgs_solve(*args, it)
  t0 = time.perf_counter()
  plain = pgs_plain_chunked(args, it)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t0) * 1e3
  plain64 = pgs_plain_chunked(args64, it)
  for what, got, p, p64 in zip(("f", "u", "qfrc"), out, plain, plain64):
    checks.check(PGS_KERNEL, f"g1 pgs {what}", got, p, p64)
  f = out[0]
  inactive = args[4] <= 0
  if not torch.equal(f[inactive], torch.zeros_like(f[inactive])):
    raise AssertionError("pgs_solve: an inactive row's force is not 0")
  out64 = pgs.pgs_solve(*args64, it)
  for what, got, ref in zip(("f", "u", "qfrc"), out64, plain64):
    err, scale = (got - ref).abs().max().item(), max(1.0, ref.abs().max().item())
    print(f"  {PGS_KERNEL} f64 on the run's rows, {what}: max_abs_err {err:.3e} "
          f"(tol 1e-10 x {scale:.3e})")
    if not err <= 1e-10 * scale:
      raise AssertionError(f"{PGS_KERNEL} f64 {what}: {err:.3e}")
  del out, plain, plain64, out64, args64, f
  torch.cuda.empty_cache()
  ms = time_ms(lambda: pgs.pgs_solve(*args, it), [()], iters=10)
  bnd = pgs_bound(args, it)
  max_rows = int((args[4] > 0).sum(1).max().item())
  print(f"  {PGS_KERNEL} on the run's rows: kernel {ms:.4f} ms  plain {plain_ms:.1f} ms (forms "
        f"A, {PGS_PLAIN_CHUNK} worlds a call)  library none (no PyTorch call computes a "
        f"projected Gauss-Seidel sweep)  bound {bnd[0]:.6f} ms ({bnd[1]}) [{card}]")
  print(f"  {PGS_KERNEL}: max active rows per world {max_rows}; "
        f"{ms * 1e6 / max(1, it * max_rows):.1f} ns per dependent row update (kernel ms / "
        f"({it} sweeps x {max_rows} rows)) [{card}]")
  del args
  gc.collect()
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  runner = build_runner(TASK, {"env.scene.num_envs": str(NUM_WORLDS),
                               "env.sim.mujoco.solver": "pgs",
                               "agent.num_steps_per_env": str(CUT_STEPS)})
  torch.cuda.synchronize()
  print(f"phase 17 pgs training: build_runner {time.perf_counter() - t0:.2f} s, "
        f"{CUT_ITERS} iteration of {CUT_STEPS} env steps [{card}]")
  train, steady_iter_ms, _, _ = train_iterations(
    runner, card, "phase 17 pgs", (99, 111), iters=CUT_ITERS, expect=KERNELS[:3],
    steps=CUT_STEPS)
  per_iter = CUT_STEPS * forwards
  print(f"  {PGS_KERNEL} launches {train[PGS_KERNEL]} (expected {per_iter}: {CUT_STEPS} env "
        f"steps x (4 substeps + the post-reset forward)); newton_direction "
        f"{train['newton_direction']}")
  if train[PGS_KERNEL] != per_iter * CUT_ITERS or train["newton_direction"] != 0:
    raise AssertionError(f"phase 17 pgs training: launches {train}")
  del runner
  gc.collect()
  torch.cuda.empty_cache()
  f64_env_check(TASK, n_steps=CUT_F64_STEPS, nudges=PHASE14_NUDGES,
                overrides={"sim.mujoco.solver": "pgs"})
  return {"launches": launches, "train_launches": train, "ms": ms, "plain_ms": plain_ms,
          "bound": bnd, "env_step_ms": env_step_ms, "launch": launch, "max_rows": max_rows}


def muscle_scenes_path(card: str) -> dict[str, int]:
  """Phase 17b: each scene of assets/muscle_scenes.py (activation dynamics
  and muscles, fluid, spatial tendons with wrapping and pulleys, PGS, the
  musculoskeletal arm) under each integrator its JAX test runs, float64,
  MUSCLE_SUBSTEPS at NUM_WORLDS worlds from its state plus a seeded
  N(0, 0.05²) qvel per world, under its control: ms per substep (CUDA
  events), the first SCENE_CPU_WORLDS worlds against the CPU (phase 14's
  rule); then the filter-actuated hopper env through ManagerBasedRlEnv at
  HOPPER_ENVS envs, its 10 env steps to the time-out under
  set_sync_debug_mode("error"): act moves toward the targets, and is
  exactly 0 after the step whose time-out resets every env."""
  from mjlab_tpu_torch import physics
  from mjlab_tpu_torch.assets import muscle_scenes
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.kernels import chol, pgs

  torch.set_num_threads(1)
  total = {k: 0 for k in (*COUNTED, PGS_KERNEL)}
  print(f"phase 17 muscle scenes: {MUSCLE_SUBSTEPS} substeps at {NUM_WORLDS} worlds, float64, "
        f"{SCENE_ITERATIONS} Newton iterations x {SCENE_LS_ITERATIONS} linesearch steps (PGS "
        f"scenes their own sweeps); the first {SCENE_CPU_WORLDS} worlds against the CPU "
        f"(tol 1e-8) [{card}]")

  def run(tp, m, qpos, qvel, ctrls):
    d = physics.make_data(tp, m, qpos.shape[0]).replace(qpos=qpos, qvel=qvel)
    for c in ctrls:
      d = physics.step(tp, m, d if c is None else d.replace(ctrl=c.expand(qpos.shape[0], -1)))
    return d

  def rel(a, b):
    return max((getattr(a, f) - getattr(b, f)).abs().max().item()
               / max(1.0, getattr(b, f).abs().max().item()) for f in ("qpos", "qvel", "act")
               if getattr(b, f).numel())

  rng = torch.Generator().manual_seed(17)
  for name, sc in muscle_scenes.SCENES.items():
    for integrator in sc.integrators:
      models = {}
      for dv in ("cuda", "cpu"):
        mjm = muscle_scenes.load(name, integrator)
        if mjm.opt.solver != 0:  # Newton: phase 14's budget
          mjm.opt.iterations, mjm.opt.ls_iterations = SCENE_ITERATIONS, SCENE_LS_ITERATIONS
        models[dv] = physics.put_model(mjm, dtype=torch.float64, device=dv)
      tp, m = models["cuda"]
      qpos0, qvel0 = sc.state(mjm)
      qpos = torch.tensor(qpos0, dtype=torch.float64).expand(NUM_WORLDS, -1).clone()
      qvel = torch.tensor(qvel0, dtype=torch.float64).expand(NUM_WORLDS, -1).clone()
      qvel += 0.05 * torch.randn(NUM_WORLDS, tp.nv, generator=rng, dtype=torch.float64)
      ctrls = [None if sc.ctrl is None else
               torch.tensor(sc.ctrl(k, tp.nu), dtype=torch.float64)[None]
               for k in range(MUSCLE_SUBSTEPS)]
      cuda_ctrls = [None if c is None else c.cuda() for c in ctrls]
      reset_counts()
      d = run(tp, m, qpos[:, :].cuda(), qvel.cuda(), cuda_ctrls[:1])
      torch.cuda.synchronize()
      start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
      start.record()
      for c in cuda_ctrls[1:]:
        d = physics.step(tp, m, d if c is None else d.replace(ctrl=c.expand(NUM_WORLDS, -1)))
      end.record()
      torch.cuda.synchronize()
      launched = {k: v for k, v in launch_counts().items() if v}
      for k, v in launch_counts().items():
        total[k] += v
      if not all(torch.isfinite(getattr(d, f)).all() for f in ("qpos", "qvel", "act")):
        raise AssertionError(f"phase 17 scene {name}: non-finite state")
      tp_c, m_c = models["cpu"]
      q0, v0 = qpos[:SCENE_CPU_WORLDS], qvel[:SCENE_CPU_WORLDS]
      ref = run(tp_c, m_c, q0, v0, ctrls)
      got = SimpleNamespace(**{f: getattr(d, f)[:SCENE_CPU_WORLDS].cpu()
                               for f in ("qpos", "qvel", "act")})
      err, tol, spread = rel(got, ref), 1e-8, None
      if err > tol:
        spread = max(rel(run(tp_c, m_c, q0 * (1 + 1e-13 * torch.randn(
          q0.shape, generator=rng, dtype=torch.float64)), v0, ctrls), ref)
          for _ in range(PHASE14_NUDGES))
        tol = max(tol, 2 * spread)
      print(f"  {name:22s} {_INTEGRATOR_NAMES[integrator]:12s} nv {tp.nv} na {tp.na} nefc "
            f"{tp.nefc:2d}: {start.elapsed_time(end) / (MUSCLE_SUBSTEPS - 1):.3f} ms per "
            f"substep; card vs CPU {err:.3e} (tol {tol:.3e}"
            + (f", CPU spread {spread:.3e}" if spread is not None else "")
            + f"); launches {launched}")
      if not err <= tol:
        raise AssertionError(f"phase 17 scene {name} ({integrator}): card vs CPU {err:.3e}")

  cfg = muscle_scenes.hopper_filter_env_cfg(HOPPER_ENVS)
  env = ManagerBasedRlEnv(cfg, device="cuda")
  env.reset(seed=0)
  action = torch.full((HOPPER_ENVS, env.total_action_dim), 0.4, dtype=torch.float64,
                      device="cuda")
  steps = round(cfg.episode_length_s / env.step_dt)  # the time-out's env step
  resets = torch.zeros((), dtype=torch.int64, device="cuda")
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  torch.cuda.set_sync_debug_mode("error")
  start.record()
  for _ in range(steps // 2):
    env.step(action)
  end.record()
  act, ctrl = env.data.act.clone(), env.data.ctrl.clone()
  for _ in range(steps - steps // 2):
    _, _, _, time_outs, extras = env.step(action)
    resets += extras["log"]["reset_count"]
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  moved = bool(((act.abs() > 1e-3) & (act.sign() == ctrl.sign())).all().item())
  zero = bool(torch.equal(env.data.act, torch.zeros_like(env.data.act)))
  print(f"  hopper filter env: {HOPPER_ENVS} envs, float64, {steps} env steps under "
        f"set_sync_debug_mode('error'), "
        f"{start.elapsed_time(end) / (steps // 2) / cfg.decimation:.3f} ms per substep; act "
        f"after {steps // 2} env steps in [{act.min().item():.4f}, {act.max().item():.4f}] "
        f"(moved toward the targets: {moved}); the time-out at env step {steps} reset "
        f"{int(resets.item())} envs, their act exactly 0: {zero} [{card}]")
  if not (moved and int(resets.item()) == HOPPER_ENVS and bool(time_outs.all().item())
          and zero):
    raise AssertionError("phase 17 hopper env: act did not move, or was not zeroed on reset")
  return total

# ---------------------------------------------------------------------------
# Phase 18: the generic MDP terms and a mocap entity's reset (18a), the
# plane–cylinder, plane–ellipsoid and height-field pairs (18b), and
# env-sharded training on two ranks of the one card (18c).
# ---------------------------------------------------------------------------

GENERIC_OBS = ("base_lin_vel", "base_ang_vel", "root_pos_w", "root_quat_w", "joint_pos",
               "joint_vel")
# Each generic reward of envs.mdp, named generic_<term>, at its weight.
GENERIC_REWARDS = {"is_terminated": -1.0, "joint_torques_l2": -1e-5, "joint_acc_l2": -2.5e-7,
                   "joint_vel_l2": -1e-3, "posture": 0.2, "electrical_power_cost": -1e-4,
                   "flat_orientation_l2": -1.0}
GENERIC_POSTURE_STD = {"left_.*": 0.3, "right_.*": 0.3, "waist_.*": 0.2}
GENERIC_STAGED = "generic_joint_vel_l2"
GENERIC_STAGE = {"step": 4, "weight": -2e-3}  # reward_weight: from env step 5 on
GENERIC_ENV_STEPS = 8
GENERIC_POISONED = (3, 1000, 4095)
MOCAP_RANGE = {"x": (-0.2, 0.3), "y": (-0.1, 0.1), "z": (0.0, 0.05), "yaw": (-1.0, 1.0)}
PAIR_SUBSTEPS = 6  # cut from 12
DIST_STEPS = 8  # env steps of 18c's iteration at 2 x 2048 envs
DIST_F64_ENVS, DIST_F64_STEPS = 4, 2
DIST_NCCL_ENVS = 512
DIST_TIMEOUT_S = 420


def generic_mdp_edit(cfg) -> None:
  """A user's G1 velocity cfg that names every generic MDP term of the port:
  a "generic" observation group of the six root and joint reads; the
  terminations root_height_below_minimum (0.2 m) and nan_detection; the
  seven rewards of GENERIC_REWARDS (posture's std per joint group); and the
  curriculum reward_weight staging generic_joint_vel_l2's weight after
  GENERIC_STAGE's step."""
  from mjlab_tpu_torch.envs import mdp
  from mjlab_tpu_torch.managers.manager_term_config import (
    CurriculumTermCfg, ObservationGroupCfg, ObservationTermCfg, RewardTermCfg,
    TerminationTermCfg,
  )
  from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
  from mjlab_tpu_torch.tasks.velocity.mdp import reward_weight

  cfg.observations["generic"] = ObservationGroupCfg(terms={
    name: ObservationTermCfg(func=getattr(mdp, name),
                             params={"asset_cfg": SceneEntityCfg("robot")})
    for name in GENERIC_OBS})
  cfg.terminations["generic_low_root"] = TerminationTermCfg(
    func=mdp.root_height_below_minimum,
    params={"minimum_height": 0.2, "asset_cfg": SceneEntityCfg("robot")})
  cfg.terminations["generic_nan"] = TerminationTermCfg(func=mdp.nan_detection)
  for name, weight in GENERIC_REWARDS.items():
    params = {} if name == "is_terminated" else {"asset_cfg": SceneEntityCfg("robot")}
    if name == "posture":
      params = {"asset_cfg": SceneEntityCfg("robot", joint_names=(".*",)),
                "std": GENERIC_POSTURE_STD}
    cfg.rewards[f"generic_{name}"] = RewardTermCfg(func=getattr(mdp, name), weight=weight,
                                                   params=params)
  cfg.curriculum["generic_weight"] = CurriculumTermCfg(
    func=reward_weight,
    params={"reward_name": GENERIC_STAGED, "weight_stages": [GENERIC_STAGE]})


def generic_mdp_path(card: str, checks: KernelCheck) -> dict:
  """Phase 18a: G1 velocity-flat at NUM_WORLDS envs (f32) with
  `generic_mdp_edit`, GENERIC_ENV_STEPS env steps of N(0, 1) actions under
  set_sync_debug_mode("error") with the kernels' counters set to 0 just
  before and read just after (RL_FACT_PER_STEP factorizations and
  RL_SOLVES_PER_STEP solves per env step). Checks every generic term
  finite, the staged weight in the reward manager's state from the step
  after GENERIC_STAGE's on (and the term's weight before it), nan_detection
  on exactly the envs whose qvel was poisoned, and the kernels against their
  plain versions on the run's matrices; then the card's float64 env against
  the CPU's, 4 envs x 2 env steps (1e-8), and a mocap entity's reset at
  NUM_WORLDS envs (`mocap_reset_check`). Returns the launches and the ms
  per env step."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv, mdp
  from mjlab_tpu_torch.kernels import chol, pgs
  from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
  from mjlab_tpu_torch.tasks import load_env_cfg

  gc.collect()
  torch.cuda.empty_cache()
  cfg = load_env_cfg(TASK)
  cfg.scene.num_envs = NUM_WORLDS
  generic_mdp_edit(cfg)
  env = ManagerBasedRlEnv(cfg, device="cuda")
  obs, _ = env.reset(seed=0)
  weights = env.ns("reward")["weights"]
  initial = float(weights[GENERIC_STAGED])
  agen = torch.Generator(device="cuda").manual_seed(18)
  finite = torch.ones((), dtype=torch.bool, device="cuda")
  staged = []
  start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  reset_counts()
  torch.cuda.set_sync_debug_mode("error")
  for i in range(GENERIC_ENV_STEPS):
    if i == 1:
      start.record()
    action = torch.randn(NUM_WORLDS, env.total_action_dim, generator=agen, device="cuda")
    obs, rew, terminated, time_outs, _ = env.step(action)
    finite &= torch.isfinite(rew).all() & torch.isfinite(obs["generic"]).all()
    staged.append(weights[GENERIC_STAGED].clone())
  end.record()
  torch.cuda.set_sync_debug_mode("default")
  torch.cuda.synchronize()
  launches = launch_counts()
  step_ms = start.elapsed_time(end) / (GENERIC_ENV_STEPS - 1)
  values = {}
  for name in GENERIC_REWARDS:
    term = env.reward_manager.cfg[f"generic_{name}"]
    values[name] = term.func(env, **term.params)
  robot = SceneEntityCfg("robot")
  robot.resolve(env.scene)
  for name in GENERIC_OBS:
    values[name] = getattr(mdp, name)(env, robot)
  values["root_height_below_minimum"] = mdp.root_height_below_minimum(env, 0.2)
  values["nan_detection"] = mdp.nan_detection(env)
  bad = [k for k, v in values.items() if not torch.isfinite(v.to(torch.float64)).all()]
  staged = [float(w) for w in staged]
  stage = float(torch.tensor(GENERIC_STAGE["weight"], dtype=env.dtype))
  want = [initial] * GENERIC_STAGE["step"] + [stage] * (GENERIC_ENV_STEPS - GENERIC_STAGE["step"])
  print(f"phase 18a generic MDP terms: {TASK} with generic_mdp_edit, {NUM_WORLDS} envs, "
        f"float32, obs {env.group_obs_dim}; {GENERIC_ENV_STEPS} env steps under "
        f"set_sync_debug_mode('error'): no host-device synchronization; "
        f"{step_ms:.2f} ms per env step (steps 1-{GENERIC_ENV_STEPS - 1}, CUDA events) [{card}]")
  print(f"  every generic term finite: {not bad and bool(finite.item())}; "
        f"{GENERIC_STAGED}'s weight after each env step {staged} (staged "
        f"{GENERIC_STAGE}); launches {launches}")
  if bad or not finite.item():
    raise AssertionError(f"phase 18a: non-finite generic terms {bad}")
  if staged != want:
    raise AssertionError(f"phase 18a: the staged weight {staged}, expected {want}")
  if (chol.factorizations() != RL_FACT_PER_STEP * GENERIC_ENV_STEPS
      or launches["chol_solve"] != RL_SOLVES_PER_STEP * GENERIC_ENV_STEPS
      or any(launches[k] != v * GENERIC_ENV_STEPS
             for k, v in newton_per_env_step(env.sim.model.opt).items())
      or any(launches[k] == 0 for k in PATH_KERNELS)):
    raise AssertionError(f"phase 18a: launches {launches}")
  poisoned = torch.zeros(NUM_WORLDS, dtype=torch.bool, device="cuda")
  poisoned[list(GENERIC_POISONED)] = True
  data = env.data
  qvel = data.qvel.clone()
  qvel[poisoned, 6] = float("nan")
  env.data = data.replace(qvel=qvel)
  flagged = mdp.nan_detection(env)
  env.data = data
  print(f"  nan_detection with qvel poisoned in envs {GENERIC_POISONED}: flags envs "
        f"{torch.nonzero(flagged).flatten().tolist()}")
  if not torch.equal(flagged, poisoned):
    raise AssertionError("phase 18a: nan_detection flagged other envs than the poisoned ones")
  print("  kernels vs plain on the run's matrices, f32:")
  checks.all_three("generic qM", env.data.qM.contiguous(), env.data.qfrc_smooth.contiguous())
  del env, obs, rew, terminated, time_outs, values, data, qvel
  gc.collect()
  torch.cuda.empty_cache()
  f64_env_check(TASK, n_steps=CUT_F64_STEPS,
                variant=lambda c: (certain_variant(c), generic_mdp_edit(c)))
  mocap_reset_check(card)
  return {"launches": launches, "env_step_ms": step_ms}


def mocap_reset_check(card: str) -> None:
  """Phase 18a, last part: reset_root_state_uniform of the mocap entity of
  assets/surface/mocap_entity.npz (its target body an entity of its own)
  at NUM_WORLDS envs, on a seeded half of them: each reset pose inside
  MOCAP_RANGE about the default pose and the env's origin (yaw from the
  quaternion), every other env's mocap pose unchanged."""
  from mjlab_tpu_torch.assets.surface_scenes import SCENES
  from mjlab_tpu_torch.entity.entity import EntityCfg
  from mjlab_tpu_torch.envs import mdp
  from mjlab_tpu_torch.envs.manager_based_env import ManagerBasedEnv, ManagerBasedEnvCfg
  from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
  from mjlab_tpu_torch.scene import SceneCfg

  target = EntityCfg(init_state=EntityCfg.InitialStateCfg(pos=(0.5, 0.0, 0.6)))
  env = ManagerBasedEnv(ManagerBasedEnvCfg(
    decimation=1, observations={}, actions={},
    scene=SceneCfg(num_envs=NUM_WORLDS, entities={"target": target, "ball": EntityCfg()},
                   model_file=SCENES["mocap_entity"].path("mocap_entity"))), device="cuda")
  asset = env.scene["target"]
  mid = asset.indexing.mocap_id
  mask = torch.rand(NUM_WORLDS, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda") < 0.5
  pos0, quat0 = env.data.mocap_pos[:, mid].clone(), env.data.mocap_quat[:, mid].clone()
  t0 = time.perf_counter()
  mdp.reset_root_state_uniform(env, mask, MOCAP_RANGE, asset_cfg=SceneEntityCfg("target"))
  torch.cuda.synchronize()
  ms = 1e3 * (time.perf_counter() - t0)
  pos, quat = env.data.mocap_pos[:, mid], env.data.mocap_quat[:, mid]
  offset = (pos - asset.data.default_root_state[:, :3] - env.scene.env_origins)[mask]
  yaw = 2 * torch.atan2(quat[mask, 3], quat[mask, 0])
  inside = all(
    bool(((offset[:, i] >= lo - 1e-5) & (offset[:, i] <= hi + 1e-5)).all())
    for i, (lo, hi) in enumerate(MOCAP_RANGE[k] for k in ("x", "y", "z")))
  inside &= bool(((yaw >= MOCAP_RANGE["yaw"][0] - 1e-5)
                  & (yaw <= MOCAP_RANGE["yaw"][1] + 1e-5)).all())
  inside &= bool((quat[mask, 1:3].abs() < 1e-6).all())
  kept = torch.equal(pos[~mask], pos0[~mask]) and torch.equal(quat[~mask], quat0[~mask])
  moved = bool((pos[mask] != pos0[mask]).any(-1).all())
  print(f"  mocap reset: reset_root_state_uniform of entity 'target' (mocap body "
        f"{mid}) on {int(mask.sum())} of {NUM_WORLDS} envs in {ms:.2f} ms: each pose inside "
        f"{MOCAP_RANGE} about its env's origin: {inside}; every reset env moved: {moved}; "
        f"the other envs unchanged: {kept}; yaw in [{yaw.min().item():.3f}, "
        f"{yaw.max().item():.3f}] [{card}]")
  if not (inside and kept and moved):
    raise AssertionError("phase 18a: the mocap reset")


def pair_scenes_path(card: str) -> dict[str, int]:
  """Phase 18b: each scene of assets/pair_scenes.py (plane–cylinder,
  plane–ellipsoid, a height field under a sphere, a capsule, a box and a
  mesh hull, and a second field of another raster), float64, PAIR_SUBSTEPS
  at NUM_WORLDS worlds from the scene's velocity plus a seeded N(0, 0.05²)
  per world: ms per substep (CUDA events), the active contacts, then the
  first SCENE_CPU_WORLDS worlds against the CPU within 1e-8, or twice the
  CPU's spread under PHASE14_NUDGES qpos nudges of 1e-13 where larger."""
  from mjlab_tpu_torch import physics
  from mjlab_tpu_torch.assets import pair_scenes
  from mjlab_tpu_torch.kernels import chol, pgs

  torch.set_num_threads(1)
  total = {k: 0 for k in (*COUNTED, PGS_KERNEL)}
  print(f"phase 18b pair scenes: {PAIR_SUBSTEPS} substeps at {NUM_WORLDS} worlds, float64; the "
        f"first {SCENE_CPU_WORLDS} worlds against the CPU (tol 1e-8) [{card}]")

  def cpu_run(tp, m, qpos, qvel):
    d = physics.make_data(tp, m, SCENE_CPU_WORLDS).replace(qpos=qpos, qvel=qvel)
    for _ in range(PAIR_SUBSTEPS):
      d = physics.step(tp, m, d)
    return d

  def rel(a, b):
    return max((getattr(a, f) - getattr(b, f)).abs().max().item()
               / max(1.0, getattr(b, f).abs().max().item()) for f in ("qpos", "qvel"))

  rng = torch.Generator().manual_seed(18)
  for name, sc in pair_scenes.SCENES.items():
    models = {dv: physics.put_model(pair_scenes.load(name), dtype=torch.float64, device=dv)
              for dv in ("cuda", "cpu")}
    tp, m = models["cuda"]
    qvel = torch.tensor(sc.qvel, dtype=torch.float64).expand(NUM_WORLDS, -1).clone()
    qvel += 0.05 * torch.randn(NUM_WORLDS, tp.nv, generator=rng, dtype=torch.float64)
    d = physics.make_data(tp, m, NUM_WORLDS).replace(qvel=qvel.cuda())
    reset_counts()
    d = physics.step(tp, m, d)
    active0 = (d.contact.dist < d.contact.includemargin).sum(1).double().mean().item()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PAIR_SUBSTEPS - 1):
      d = physics.step(tp, m, d)
    end.record()
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}
    for k, v in launch_counts().items():
      total[k] += v
    if not (torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()):
      raise AssertionError(f"phase 18b scene {name}: non-finite state")
    tp_c, m_c = models["cpu"]
    q0 = physics.make_data(tp_c, m_c, SCENE_CPU_WORLDS).qpos
    v0 = qvel[:SCENE_CPU_WORLDS]
    ref = cpu_run(tp_c, m_c, q0, v0)
    got = SimpleNamespace(qpos=d.qpos[:SCENE_CPU_WORLDS].cpu(),
                          qvel=d.qvel[:SCENE_CPU_WORLDS].cpu())
    err, tol, spread = rel(got, ref), 1e-8, None
    if err > tol:
      spread = max(rel(cpu_run(tp_c, m_c, q0 * (1 + 1e-13 * torch.randn(
        q0.shape, generator=rng, dtype=torch.float64)), v0), ref)
        for _ in range(PHASE14_NUDGES))
      tol = max(tol, 2 * spread)
    pairs = sorted({(p.type1, p.type2) for p in tp.pairs})
    print(f"  {name:16s} pairs {pairs} slots {tp.ncon_max} nefc {tp.nefc:3d}: "
          f"{start.elapsed_time(end) / (PAIR_SUBSTEPS - 1):.3f} ms per substep; active "
          f"contacts per world {active0:.2f} at the first substep; card vs CPU {err:.3e} (tol "
          f"{tol:.3e}" + (f", CPU spread {spread:.3e}" if spread is not None else "")
          + f"); launches {launched} [{card}]")
    if not active0 > 0:
      raise AssertionError(f"phase 18b scene {name}: no active contact")
    if not err <= tol:
      raise AssertionError(f"phase 18b scene {name}: card vs CPU {err:.3e}")
  return total


def dist_f64_worker(out: Path) -> None:
  """One process of 18c's float64 check (`chip_smoke.py --dist-f64 DIR`):
  under torch.distributed.run a rank of a sharded run, else the unsharded
  reference. Builds the G1 runner through build_runner at DIST_F64_ENVS envs
  in float64 on the card, gives it `warm_learner(seed 3)`, trains one
  iteration of DIST_F64_STEPS env steps with the runner's own draws, and
  writes its learner, env state and the iteration's metrics (losses and the
  logged metrics, reduced over the ranks as `learn` reduces them before it
  writes metrics.jsonl) to DIR/<rank | single>.npz."""
  import numpy as np

  from mjlab_tpu_torch.envs import env_state_to_arrays
  from mjlab_tpu_torch.rl.runner import runner_state_from_arrays, runner_state_to_arrays
  from mjlab_tpu_torch.scripts.train import build_runner

  torch.backends.cuda.matmul.allow_tf32 = False
  runner = build_runner(TASK, {
    "env.scene.num_envs": str(DIST_F64_ENVS), "env.sim.dtype": "float64",
    "agent.num_steps_per_env": str(DIST_F64_STEPS),
    "agent.algorithm.num_learning_epochs": "1", "agent.algorithm.num_mini_batches": "2",
    "log_dir": str(out / "log"),
  }, device="cuda")
  runner_state_from_arrays(runner, warm_learner(runner_state_to_arrays(runner), 3))
  metrics = runner.train_iteration()
  keys = list(metrics)
  row = torch.stack([v.to(torch.float64) for v in metrics.values()])[None]
  if runner.shard is not None:  # as the runner reduces them before it logs them
    row = runner._reduce_rows(keys, row)
  name = "single" if runner.shard is None else f"rank{torch.distributed.get_rank()}"
  np.savez(out / f"{name}.npz",
           **{f"learner/{k}": v for k, v in runner_state_to_arrays(runner).items()},
           **{f"env/{k}": v for k, v in env_state_to_arrays(runner.env).items()},
           **{f"metric/{k}": v for k, v in zip(keys, row[0].cpu().numpy())})


def _torchrun(nproc: int, args: list[str]) -> subprocess.CompletedProcess:
  """`python -m torch.distributed.run --nproc_per_node nproc args...` on this
  host (rendezvous on 127.0.0.1, a free port; gloo and NCCL bound to the
  loopback interface), its output captured."""
  import os
  import socket

  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
  env = dict(os.environ)
  env.setdefault("GLOO_SOCKET_IFNAME", "lo")
  env.setdefault("NCCL_SOCKET_IFNAME", "lo")
  cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
         "--master_addr", "127.0.0.1", "--master_port", str(port), *args]
  out = subprocess.run(cmd, capture_output=True, text=True, timeout=DIST_TIMEOUT_S, env=env)
  log = OUT / f"chip_smoke_torchrun_{nproc}_{len(list(OUT.glob('chip_smoke_torchrun_*')))}.log"
  log.write_text(" ".join(cmd) + "\n" + out.stdout + "\n--- stderr\n" + out.stderr)
  if out.returncode != 0:
    print(out.stdout[-3000:])
    print(out.stderr[-3000:], file=sys.stderr)
    raise AssertionError(f"torch.distributed.run exited {out.returncode}: {' '.join(args)}")
  return out


def _rank_lines(stdout: str) -> dict[int, dict]:
  """The `[train] rank r: ...` lines of a sharded run, by rank."""
  import re

  ranks = {}
  for m in re.finditer(r"\[train\] rank (\d+): (\d+) iterations in ([\d.]+) s, ([\d.]+) ms per "
                       r"iteration; peak device memory ([\d.na]+) GB; learner sha256 (\w+)",
                       stdout):
    ranks[int(m[1])] = {"ms": float(m[4]), "gb": float(m[5]), "sha256": m[6]}
  return ranks


def dist_path(card: str, steady_iter_ms: float) -> dict:
  """Phase 18c: env-sharded training on two ranks of the one card, gloo
  (NCCL refuses two ranks on one device). (1) `python -m
  torch.distributed.run --nproc_per_node 2 -m mjlab_tpu_torch.scripts.train`
  G1 velocity-flat at NUM_WORLDS envs (2 x NUM_WORLDS / 2), one PPO
  iteration of DIST_STEPS env steps: each rank's ms per iteration (its
  warm-up in) and peak memory against phase 8's steady iteration scaled to
  DIST_STEPS env steps; finite losses; the learner bitwise equal on both
  ranks (its digest); rank 0 alone saved (each rank is given a log dir of
  its own, g1_<rank>, and rank 1's stays unmade). (2) float64: 2 ranks x
  DIST_F64_ENVS / 2 envs (`dist_f64_worker`) against this process with
  DIST_F64_ENVS envs, one iteration of DIST_F64_STEPS env steps from one warm
  learner: parameters, Adam state, normalizers, every env's state, and the
  iteration's metrics as metrics.jsonl would hold them (losses, episode
  sums, means and ratios of sums over the envs), within 1e-8 relative.
  (3) `--nproc_per_node 1` through NCCL, one iteration at DIST_NCCL_ENVS
  envs: the NCCL path initialises and runs."""
  import re
  import shlex
  import shutil

  import numpy as np

  t_phase = time.perf_counter()
  run_dir = Path("build") / "chip_smoke" / "dist"
  shutil.rmtree(run_dir, ignore_errors=True)
  run_dir.mkdir(parents=True)
  module = ["-m", "mjlab_tpu_torch.scripts.train", TASK]
  # Through sh, so that each rank's --log_dir names its RANK.
  train = shlex.join([sys.executable, *module, "--env.scene.num_envs", str(NUM_WORLDS),
                      "--agent.num_steps_per_env", str(DIST_STEPS),
                      "--agent.max_iterations", "1", "--agent.save_interval", "0",
                      "--log_dir"])
  t0 = time.perf_counter()
  out = _torchrun(2, ["--no-python", "sh", "-c",
                      f"exec {train} {shlex.quote(str(run_dir / 'g1'))}_$RANK"])
  t_run = time.perf_counter() - t0
  ranks = _rank_lines(out.stdout)
  g1 = run_dir / "g1_0"
  rows = [json.loads(x) for x in (g1 / "metrics.jsonl").read_text().splitlines()]
  losses = {k: v for k, v in rows[-1].items() if k.startswith("Loss/")}
  saved_by = sorted({int(x) for x in re.findall(r"\[runner\] rank (\d+): saved", out.stdout)})
  scaled = steady_iter_ms * DIST_STEPS / TRAIN_STEPS
  print(f"phase 18c two ranks on one card: torch.distributed.run --nproc_per_node 2 -m "
        f"mjlab_tpu_torch.scripts.train {TASK}, {NUM_WORLDS} envs (2 x {NUM_WORLDS // 2}), "
        f"backend gloo, 1 iteration of {DIST_STEPS} env steps, in {t_run:.1f} s of command "
        f"[{card}]")
  for r, x in sorted(ranks.items()):
    print(f"  rank {r}: {x['ms']:.2f} ms per iteration (its warm-up in; "
          f"{x['ms'] / scaled:.3f} x phase 8's steady {steady_iter_ms:.2f} ms scaled to "
          f"{DIST_STEPS} env steps, {scaled:.2f} ms); peak memory {x['gb']:.3f} GB; learner "
          f"sha256 {x['sha256'][:16]}... [{card}]")
  print(f"  losses {losses}; saved by ranks {saved_by}; rank 0's files "
        f"{sorted(p.name for p in g1.iterdir())}; rank 1's log dir made: "
        f"{(run_dir / 'g1_1').exists()}")
  if ("backend gloo" not in out.stdout or sorted(ranks) != [0, 1]
      or ranks[0]["sha256"] != ranks[1]["sha256"]):
    raise AssertionError("phase 18c: the two ranks' learners differ, or a rank is missing")
  if not losses or not all(np.isfinite(v) for v in losses.values()):
    raise AssertionError(f"phase 18c: losses {losses}")
  if (saved_by != [0] or not (g1 / "model_1.pt").exists()
      or (run_dir / "g1_1").exists()):
    raise AssertionError(f"phase 18c: the checkpoint was saved by ranks {saved_by}")

  f64_dir = run_dir / "f64"
  f64_dir.mkdir()
  _torchrun(2, [str(Path(__file__).resolve()), "--dist-f64", str(f64_dir)])
  dist_f64_worker(f64_dir)
  one = dict(np.load(f64_dir / "single.npz"))
  two = [dict(np.load(f64_dir / f"rank{r}.npz")) for r in (0, 1)]
  worst, same = {}, True
  for k, want in one.items():
    if k.startswith("env/") and want.ndim and want.shape[0] == DIST_F64_ENVS:
      got = np.concatenate([two[0][k], two[1][k]])
    else:
      got = two[0][k]
      same &= np.array_equal(two[1][k], got)
    worst[k] = (float(not np.array_equal(got, want)) if want.dtype.kind in "biu" else
                float(np.abs(got - want).max(initial=0.0)
                      / max(1.0, float(np.abs(want).max(initial=0.0)))))
  if not {"metric/Loss/loss", "metric/Metrics/landing_force_mean"} <= set(one):
    raise AssertionError("phase 18c: the float64 iteration's metrics lack a loss or a ratio")
  top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
  print(f"  float64 on the card: 2 ranks x {DIST_F64_ENVS // 2} envs against 1 process x "
        f"{DIST_F64_ENVS} envs, one iteration of {DIST_F64_STEPS} env steps from one warm "
        f"learner: largest relative errors " + ", ".join(f"{k} {v:.3e}" for k, v in top)
        + f" over {len(worst)} arrays (tol 1e-8); of the logged metrics " + ", ".join(
          f"{k[len('metric/'):]} {one[k]:.6g} ({v:.3e})" for k, v in worst.items()
          if k.startswith("metric/Metrics/") and k.endswith("_mean"))
        + f"; learner and shared state equal on both ranks: {same}")
  if not (max(worst.values()) <= 1e-8 and same):
    raise AssertionError("phase 18c: the sharded float64 iteration differs from the unsharded")

  t0 = time.perf_counter()
  out = _torchrun(1, [*module, "--env.scene.num_envs", str(DIST_NCCL_ENVS),
                      "--agent.num_steps_per_env", "2", "--agent.max_iterations", "1",
                      "--agent.save_interval", "0", "--log_dir", str(run_dir / "nccl")])
  nccl = _rank_lines(out.stdout)
  print(f"  torch.distributed.run --nproc_per_node 1 (backend nccl): 1 iteration at "
        f"{DIST_NCCL_ENVS} envs in {time.perf_counter() - t0:.1f} s of command; rank 0 "
        f"{nccl.get(0, {}).get('ms', float('nan')):.2f} ms per iteration [{card}]")
  if "backend nccl" not in out.stdout or sorted(nccl) != [0]:
    raise AssertionError("phase 18c: the NCCL launch did not run on backend nccl")
  print(f"  phase 18c in {time.perf_counter() - t_phase:.1f} s")
  return {"ms": {r: x["ms"] for r, x in ranks.items()},
          "gb": {r: x["gb"] for r, x in ranks.items()}, "scaled_phase8_ms": scaled}


# Phase 19a's scenes: each rough task and its committed rough scene (an
# attribute of the port's assets, `<name>_PLAY` its play scene), the JAX
# package's compile, which the port's composition must give back.
COMPOSED = {"Mjlab-Velocity-Rough-Unitree-G1": "G1_VELOCITY_ROUGH",
            "Mjlab-Velocity-Rough-Unitree-Go1": "GO1_VELOCITY_ROUGH",
            "Mjlab-Velocity-Rough-Asimov": "ASIMOV_VELOCITY_ROUGH",
            "Mjlab-Velocity-Rough-Asimov-Toe": "ASIMOV_TOE_VELOCITY_ROUGH"}
# Phase 19b: Asimov velocity-rough on the height-field preset, registered as
# a user's task (phase 15's way); the dense efc_J above which it would have
# to run at fewer envs; the steady env steps it times.
HF_TASK = "Chip-Velocity-Rough-Asimov-HF"
HF_BASE_TASK = "Mjlab-Velocity-Rough-Asimov"
HF_EFC_J_CEILING = 20e9
HF_WARM_STEPS = 2
HF_TIMED_STEPS = 8
HF_STEPS = 8  # env steps of its PPO iteration (the other tasks' CUT_STEPS is 4)


def compose_path(card: str) -> None:
  """Phase 19a: the composer on the card host (no `mujoco`). Each rough
  task's scene and its play scene (the play overrides: 3 x 3 tiles, no
  curriculum) generated and composed from the robot's flat scene and the
  task's cfg, held against the committed npz (the JAX package's compile):
  integers exactly, floats within 1e-12 of each field's largest magnitude
  (`compose.mismatches`). Prints the ms of each generation and
  composition (host clock)."""
  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.assets import load_model_arrays
  from mjlab_tpu_torch.scene.compose import compose_arrays, mismatches
  from mjlab_tpu_torch.scripts.play import apply_play_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg
  from mjlab_tpu_torch.terrains import TerrainGenerator

  print(f"phase 19a the composer: each rough and play scene from its robot's flat scene and "
        f"its task's cfg, against the committed JAX compile (host clock) [{card}]:")
  for task, name in COMPOSED.items():
    for play in (False, True):
      cfg = load_env_cfg(task)
      if play:
        apply_play_overrides(cfg)
      flat = load_model_arrays(cfg.scene.model_file)
      t0 = time.perf_counter()
      generated = TerrainGenerator(cfg.scene.terrain.terrain_generator).generate()
      t1 = time.perf_counter()
      arrays = compose_arrays(flat, generated)
      t2 = time.perf_counter()
      want = load_model_arrays(getattr(assets, name + ("_PLAY" if play else "")))
      bad = mismatches(want, arrays)
      print(f"  {task}{' play' if play else ''}: {int(arrays['ngeom'])} geoms "
            f"({len(generated.geoms)} generated on {generated.terrain_origins.shape[:2]} tiles), "
            f"generation {1e3 * (t1 - t0):.2f} ms, composition {1e3 * (t2 - t1):.2f} ms; "
            f"{len(arrays)} arrays compared, mismatches {bad}")
      if bad:
        raise AssertionError(f"phase 19a: the composed {task} scene differs from its compile")


def hf_cfg():
  """The Asimov velocity-rough cfg with ROUGH_TERRAINS_WITH_HF_CFG under the
  curriculum, as a user sets it."""
  from mjlab_tpu_torch.tasks import load_env_cfg
  from mjlab_tpu_torch.terrains import config as presets

  cfg = load_env_cfg(HF_BASE_TASK)
  gen = presets.ROUGH_TERRAINS_WITH_HF_CFG
  gen.curriculum = True
  cfg.scene.terrain.terrain_generator = gen
  return cfg


def hf_first_variant(cfg) -> None:
  """`certain_variant` of HF_TASK with the height-field sub-terrains listed
  first, so that under the curriculum columns 0-7 are height fields and
  the float64 check's 4 envs (columns 0-3: pyramid slopes, random bumps)
  stand on them."""
  certain_variant(cfg)
  gen = cfg.scene.terrain.terrain_generator
  first = [k for k, sub in gen.sub_terrains.items() if type(sub).__name__.startswith("Hf")]
  gen.sub_terrains = {k: gen.sub_terrains[k]
                      for k in first + [k for k in gen.sub_terrains if k not in first]}


def hfield_slots(tp) -> int:
  """The height-field pairs' contact slots, which lead the slot order; the
  phase's scenes have no other pairs."""
  if not tp.pairs or any(p.type1 != 1 for p in tp.pairs):  # mjGEOM_HFIELD
    raise AssertionError("phase 19b: a pair that is not a height-field pair")
  return sum(p.ncon for p in tp.pairs)


class HfieldCollisionCheck:
  """After each card step of the float64 check: the card env's collision
  (height-field narrowphase on the card) against the CPU's on the same
  state, a copy of the card's Data. Each active contact's dist, pos and
  frame within 1e-8 relative to max(1, max |CPU|), and the same slots
  active. Counts the active height-field contacts it compared."""

  def __init__(self):
    self.cpu = None
    self.active = []

  def __call__(self, env, action) -> float:
    import dataclasses

    from mjlab_tpu_torch.physics import collision, io
    from mjlab_tpu_torch.scene.scene import load_compiled_model

    if self.cpu is None:
      tp, _ = io.put_model(load_compiled_model(env.cfg.scene), dtype=torch.float64,
                           device="cpu")
      m = env.model
      opt = {f.name: getattr(m.opt, f.name) for f in dataclasses.fields(m.opt)}
      model = type(m)(opt=type(m.opt)(**{k: v.cpu() if torch.is_tensor(v) else v
                                         for k, v in opt.items()}),
                      **{f: getattr(m, f).cpu() for f in io.model_fields()})
      self.cpu = (tp, model, hfield_slots(tp))
    tp, model, n_hf = self.cpu
    got = collision.collision(env.tp, env.model, env.data).contact
    state = io.data_from_arrays(io.data_to_arrays(env.data), dtype=torch.float64,
                                device="cpu")
    want = collision.collision(tp, model, state).contact
    active = want.dist < want.includemargin
    if not torch.equal((got.dist < got.includemargin).cpu(), active):
      raise AssertionError("phase 19b: the card's active contacts differ from the CPU's")
    self.active.append(int(active[:, :n_hf].sum()))
    err = 0.0
    for f in ("dist", "pos", "frame"):
      g, w = getattr(got, f).cpu()[active], getattr(want, f)[active]
      if w.numel():
        err = max(err, (g - w).abs().max().item() / max(1.0, w.abs().max().item()))
    if not err <= 1e-8:
      raise AssertionError(f"phase 19b: card vs CPU collision, relative error {err:.3e}")
    return err


def hf_path(card: str, attr: str, checks: KernelCheck) -> tuple[dict, dict]:
  """Phase 19b: Asimov velocity-rough on ROUGH_TERRAINS_WITH_HF_CFG (80
  height field tiles, each against the 2 foot hulls in the static pair
  table), registered as HF_TASK, at NUM_WORLDS envs, f32. The dense efc_J
  reckoned from the Topology before the build (the phase fails above
  HF_EFC_J_CEILING rather than run a cut it does not list); after the
  build the slots, rows and height fields, HF_TIMED_STEPS steady env steps
  of N(0, 1) actions (after HF_WARM_STEPS) under
  set_sync_debug_mode("error"), ms per env step by CUDA events, the
  peak memory, the envs whose height-field slots hold an active contact
  (some must), and one substep's stage times on that state (phase 5's
  split); then `task_path`: one PPO iteration of HF_STEPS env steps
  through build_runner with phase 8's checks and the launches of every
  kernel, the four kernels against their plain versions on this run's
  matrices, and the card's float64 env against the CPU's for
  CUT_F64_STEPS env steps from the CPU's state (the Asimov rule: 1e-8 or
  twice the CPU's spread under 6 qpos nudges of 1e-13) on
  `hf_first_variant`, its 4 envs on height-field tiles, with
  `HfieldCollisionCheck` after each card step (it must compare an active
  height-field contact). Returns the iteration's launches and each
  kernel's ms on the run's matrices."""
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.physics import io
  from mjlab_tpu_torch.scene.scene import load_compiled_model

  t_phase = time.perf_counter()
  tasks.register(HF_TASK, hf_cfg, lambda: tasks.load_rl_cfg(HF_BASE_TASK))
  tp_cpu, _ = io.put_model(load_compiled_model(hf_cfg().scene), device="cpu")
  efc_j = NUM_WORLDS * tp_cpu.nefc * tp_cpu.nv * 4
  print(f"phase 19b {HF_TASK} (Asimov velocity-rough on ROUGH_TERRAINS_WITH_HF_CFG, "
        f"curriculum): reckoned dense efc_J {NUM_WORLDS} x {tp_cpu.nefc} x {tp_cpu.nv} x 4 B = "
        f"{efc_j / 1e9:.3f} GB (ceiling {HF_EFC_J_CEILING / 1e9:.0f} GB: no cut of the envs)")
  if efc_j > HF_EFC_J_CEILING:
    raise AssertionError("phase 19b: efc_J passes its ceiling; the phase must cut its envs")
  del tp_cpu
  launches = {k: 0 for k in (*COUNTED, PGS_KERNEL)}
  path_ms: dict[str, dict[str, float]] = {k: {} for k in KERNELS}
  timed: dict[str, float] = {}

  def after_build(runner):
    env, tp = runner.env, runner.env.tp
    print_terrain(env, HF_TASK)
    hf_pairs = hfield_slots(tp)
    print(f"  height fields {tp.nhfield}; slots {tp.ncon_max}: {hf_pairs} in "
          f"{len(tp.pairs)} hfield-hull pairs + "
          + ", ".join(f"{g.slots} x {len(g.robot_geoms)} box-pool" for g in tp.terrain_groups)
          + f"; Newton rows {tp.nefc}; efc_J {tuple(env.data.efc_J.shape)} "
          f"{env.data.efc_J.numel() * env.data.efc_J.element_size() / 1e9:.3f} GB")
    if tp.nhfield != 80 or not hf_pairs:
      raise AssertionError("phase 19b: the height fields or their pairs")
    gen = torch.Generator(device="cuda").manual_seed(19)
    n_act = env.action_manager.total_action_dim
    for _ in range(HF_WARM_STEPS):
      env.step(torch.randn(NUM_WORLDS, n_act, generator=gen, device="cuda"))
    actions = [torch.randn(NUM_WORLDS, n_act, generator=gen, device="cuda")
               for _ in range(HF_TIMED_STEPS)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    start.record()
    for a in actions:
      obs, rew, *_ = env.step(a)
    end.record()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    timed["env_step_ms"] = start.elapsed_time(end) / HF_TIMED_STEPS
    timed["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(env.data.qpos).all() and torch.isfinite(rew).all()
                  and all(torch.isfinite(v).all() for v in obs.values()))
    print(f"  {HF_TIMED_STEPS} env steps (after {HF_WARM_STEPS}) under "
          f"set_sync_debug_mode('error'): {timed['env_step_ms']:.2f} ms per env step (CUDA "
          f"events), {NUM_WORLDS / timed['env_step_ms'] * 1e3:.1f} env-steps/s; peak memory "
          f"since the build {timed['peak_gb']:.2f} GB; finite {finite} [{card}]")
    if not finite:
      raise AssertionError("phase 19b: a non-finite state, reward or observation")
    c = env.data.contact
    on_hf = (c.dist[:, :hf_pairs] < c.includemargin[:, :hf_pairs]).sum(1)
    n_env, n_con = int((on_hf > 0).sum()), int(on_hf.sum())
    print(f"  after the last step: {n_env} envs hold {n_con} active height-field contacts")
    if not n_env:
      raise AssertionError("phase 19b: no height-field contact is active")
    per_stage = stage_times(tp, env.model, env.data)
    print("  one substep by stage on that state (CUDA events, mean of 3): "
          + ", ".join(f"{k} {v:.3f}"
                      for k, v in sorted(per_stage.items(), key=lambda kv: -kv[1])[:6])
          + f" ms; sum {sum(per_stage.values()):.3f} ms [{card}]")

  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  hf_check = HfieldCollisionCheck()
  host = task_path("phase 19b", HF_TASK, "asimov_hf", (48, 60), card, attr, checks, launches,
                   path_ms, after_build=after_build, ms_key="asimov_hf (n 18)",
                   iters=CUT_ITERS, steps=HF_STEPS, variant=hf_first_variant,
                   on_step=hf_check)
  print(f"  the float64 check on height-field tiles: active height-field contacts compared "
        f"after each card step {hf_check.active}")
  if not sum(hf_check.active):
    raise AssertionError("phase 19b: the float64 check compared no active height-field contact")
  terrain_metrics(HF_TASK, host)
  print(f"phase 19b: {time.perf_counter() - t_phase:.1f} s; launches over the iteration "
        f"{launches}; {timed['env_step_ms']:.2f} ms per env step, peak {timed['peak_gb']:.2f} GB")
  return launches, path_ms


def main() -> int:
  parser = argparse.ArgumentParser(description="Drive the PyTorch port on one CUDA card.")
  parser.add_argument("--f64-seeds", default=",".join(map(str, F64_SEEDS)),
                      help="seeds of the draws for phase 8's card-vs-CPU float64 "
                           "iteration, comma-separated (default %(default)s)")
  parser.add_argument("--dist-f64", metavar="DIR",
                      help="run as one process of phase 18c's float64 check (a rank under "
                           "torch.distributed.run), writing its arrays into DIR")
  args = parser.parse_args()
  f64_seeds = [int(x) for x in args.f64_seeds.split(",")]
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; nothing run",
          file=sys.stderr)
    return 2
  if args.dist_f64:
    dist_f64_worker(Path(args.dist_f64))
    return 0
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

  # The rest of the Newton iteration at the main path's shapes: random qM
  # and J (4096 x 1699 x 35), D on ~2% of the rows (the run's share), on all
  # of them (every world past the kernels' CAP of rows in shared memory) and
  # on none; x = a0 + noise, p random, 20 linesearch steps.
  from mjlab_tpu_torch.kernels import newton

  def iteration_set(share: float):
    qM_ = spd_batch(gen, NUM_WORLDS, N, torch.float32)
    J_ = torch.randn(NUM_WORLDS, NEFC, N, generator=gen, device="cuda") / N**0.5
    on = torch.rand(NUM_WORLDS, NEFC, generator=gen, device="cuda") < share
    D_ = torch.where(on, 0.5 + torch.rand(NUM_WORLDS, NEFC, generator=gen, device="cuda"),
                     torch.zeros((), device="cuda"))
    a0_ = torch.randn(NUM_WORLDS, N, generator=gen, device="cuda")
    rows_ = newton.Rows(qM_, J_, D_, torch.randn(NUM_WORLDS, NEFC, generator=gen,
                                                 device="cuda"), a0_)
    return (rows_, a0_ + 0.3 * torch.randn(NUM_WORLDS, N, generator=gen, device="cuda"),
            torch.randn(NUM_WORLDS, N, generator=gen, device="cuda"))

  print(f"  the Newton iteration's kernels, f32 ({NUM_WORLDS}, {NEFC}, {N}), 20 linesearch "
        f"steps; the 2% input touches ~57 MB, more than L2's 50 MB:")
  for label, share in (("2% active", 0.02), ("dense", 1.0), ("none active", 0.0)):
    res = iteration_kernels(f"random, {label}", *iteration_set(share), 20, False, checks, card,
                            time_plain=share == 0.02)
    if share == 0.02:
      iter_times = res
    del res
    torch.cuda.empty_cache()
  iter_cfg = print_iteration_launch(f"f32, {NUM_WORLDS} x {NEFC} x {N}", torch.float32, N,
                                    NEFC)
  print_iteration_launch("f64", torch.float64, N, NEFC)

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
  reset_counts()
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
  launches = launch_counts()
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
  newton_want = {k: substeps * v for k, v in newton_per_solve().items()}
  print(f"  the Newton iteration's kernels: {sum(newton_want.values()) // substeps} launches "
        f"per substep expected ({newton_want} in all)")
  if (nfact != 12 * substeps or launches["chol_solve"] != substeps
      or launches["newton_direction"] != 10 * substeps
      or any(launches[k] != v for k, v in newton_want.items())):
    raise AssertionError("expected 12 factorizations (10 Newton directions), 1 solve and "
                         f"{newton_want} per substep, got {launches}")

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
  # The Newton iteration's kernels on the run's rows, at a first iteration
  # from a0 along its Newton direction.
  rows_run = newton.Rows.of(sim.tp, d)
  run_iter = iteration_kernels("the run's rows", rows_run, *iteration_inputs(rows_run),
                               sim.model.opt.ls_iterations, False, checks, card)
  del rows_run
  zero_launches = zero_iteration_path(sim.tp, sim.model, d, card)

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
  # One more substep from there with solves of 0 iterations (phase 3c's
  # path).
  for dv, s in sims.items():
    ref[dv] = s.step_fn()(zero_iteration(s.model), ref[dv])
  for f in ("qacc", "efc_force", "qvel"):
    a, b_ = getattr(ref["cuda"], f).cpu(), getattr(ref["cpu"], f)
    err = (a - b_).abs().max().item()
    scale = max(1.0, b_.abs().max().item())
    print(f"  then 1 substep at 0 iterations: {f:10s} max_abs_err {err:.3e} "
          f"(tol 1e-8 x {scale:.3e}; max |efc_force| {ref['cpu'].efc_force.abs().max().item():.3e})")
    if not err <= 1e-8 * scale:
      raise AssertionError(f"card vs CPU mismatch on {f} at 0 iterations")
  del sims, ref

  clock.done(4)
  # -- 5. where one substep's time goes, stage by stage ---------------------------
  per_stage = stage_times(sim.tp, sim.model, d)
  total = sum(per_stage.values())
  print(f"phase 5 stage times of one substep (CUDA events, mean of 3) [{card}]:")
  for name, ms in per_stage.items():
    print(f"  {name:18s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
  print(f"  {'sum':18s} {total:9.3f} ms")
  split = solve_split(sim.tp, sim.model, d)
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
  events = [e for e in averages if str(e.device_type).endswith("CUDA") and e.key != SOLVE_SPAN]
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
  # No product with a (B, nefc, nv) operand (J) may run inside solve: the
  # Newton iteration's kernels read J's active rows themselves.
  def in_solve(e) -> bool:
    up = e.cpu_parent
    while up is not None:
      if up.name == SOLVE_SPAN:
        return True
      up = up.cpu_parent
    return False

  j_shape = sorted([NUM_WORLDS, NEFC, N])
  solve_spans = sum(1 for e in prof.events()
                    if e.name == SOLVE_SPAN and str(e.device_type).endswith("CPU"))
  dense = [e for e in prof.events()
           if e.name in ("aten::bmm", "aten::matmul") and in_solve(e)
           and any(len(sh) == 3 and sorted(sh) == j_shape for sh in e.input_shapes)]
  print(f"  products with a ({NUM_WORLDS}, {NEFC}, {N}) operand inside the {solve_spans} "
        f"solver.solve spans: {len(dense)}")
  if solve_spans != DECIMATION or dense:
    raise AssertionError(f"{len(dense)} (B, nefc, nv) products inside solve "
                         f"({solve_spans} spans)")
  # Each kernel's device time per launch on the main path, from the profile
  # (the Newton iteration's are instances of one kernel template,
  # newton_iter_kernel<T, mode, cone>: mode 1-2 the linesearch, 3 the warm
  # start; mode 0, the gradient, launches only in a solve of 0 iterations).
  kernel_keys = {name: (f"{name}_kernel<",) for name in KERNELS}
  kernel_keys.update({"warm_start": ("newton_iter_kernel<float, 3,",),
                      "newton_linesearch": ("newton_iter_kernel<float, 1,",
                                            "newton_iter_kernel<float, 2,")})
  path_ms = {}
  for name in PATH_KERNELS:
    hits = [e for e in events if any(key in e.key for key in kernel_keys[name])]
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
  reset_counts()
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
  env_launches = launch_counts()
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
  env_newton = newton_per_env_step(env.sim.model.opt)
  print(f"  the Newton iteration's kernels per env step: "
        + ", ".join(f"{k} {env_launches[k] / RL_STEPS:g}" for k in NEWTON_KERNELS)
        + f" (expected {env_newton})")
  if (env_fact != RL_FACT_PER_STEP * RL_STEPS
      or env_launches["chol_solve"] != RL_SOLVES_PER_STEP * RL_STEPS
      or any(env_launches[k] != v * RL_STEPS for k, v in env_newton.items())
      or any(env_launches[k] == 0 for k in PATH_KERNELS)):
    raise AssertionError(f"expected {RL_FACT_PER_STEP} factorizations, "
                         f"{RL_SOLVES_PER_STEP} solves and {env_newton} per env step, got "
                         f"{env_launches}")

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

  with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device only: parses faster
    env.step(action)
    torch.cuda.synchronize()
  averages = prof.key_averages()
  (OUT / "chip_smoke_env_profile.txt").write_text(averages.table(sort_by=attr, row_limit=40))
  events = [e for e in averages if str(e.device_type).endswith("CUDA") and e.key != SOLVE_SPAN]
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
  f64_env_check(TASK, n_steps=4)  # cut from 8

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
  cg_launches, cg_iter = cg_path(card, checks)
  scene_launches = scenes_path(card)
  print(f"phase 14 launches: G1 elliptic's {CUT_ITERS} iteration {ell['launches']}; G1 cg's "
        f"{CG_STEPS - 1} env steps {cg_launches}; the scenes' runs {scene_launches}")
  if any(scene_launches[k] == 0 for k in ALL_KERNELS):
    raise AssertionError(f"phase 14: a kernel did not run in the scenes: {scene_launches}")

  clock.done(14)
  # -- 15. the user surface: a sim-to-real cfg of the user's own -----------------
  surface_launches = surface_path(card, attr, checks, train_launches, steady_iter_ms)

  clock.done(15)
  # -- 16. a user's own robot and task: the CartPole tutorial and the surface scenes --
  t16 = time.perf_counter()
  user_ms: dict[str, dict[str, float]] = {k: {} for k in ALL_KERNELS}
  cart_launches = cartpole_path(card, checks, user_ms)
  user_launches = user_scenes_path(card, checks, user_ms)
  for k in user_launches:
    user_launches[k] += cart_launches[k]
  print(f"phase 16: {time.perf_counter() - t16:.1f} s; launches over CartPole's 2 iterations, "
        f"the scenes and the humanoid {user_launches}")
  if any(user_launches[k] == 0 for k in ALL_KERNELS):
    raise AssertionError(f"phase 16: a kernel did not run on the user-robot paths: "
                         f"{user_launches}")

  clock.done(16)
  # -- 17. the actuation and tendon surface, and G1 under PGS ---------------------
  t17 = time.perf_counter()
  pgs_run = pgs_path(card, checks)
  muscle_launches = muscle_scenes_path(card)
  print(f"phase 17: {time.perf_counter() - t17:.1f} s; launches over the scenes "
        f"{muscle_launches}")
  if muscle_launches[PGS_KERNEL] == 0 or any(muscle_launches[k] == 0 for k in KERNELS[:3]):
    raise AssertionError(f"phase 17: a kernel did not run in the scenes: {muscle_launches}")

  clock.done(17)
  # -- 18. the generic MDP terms, the new collision pairs, two ranks on the card ---
  t18 = time.perf_counter()
  generic = generic_mdp_path(card, checks)
  pair_launches = pair_scenes_path(card)
  dist_path(card, steady_iter_ms)
  print(f"phase 18: {time.perf_counter() - t18:.1f} s; launches over the generic env steps "
        f"{generic['launches']}, the pair scenes {pair_launches}")
  if any(pair_launches[k] == 0 for k in KERNELS[:3]):
    raise AssertionError(f"phase 18: a kernel did not run in the pair scenes: {pair_launches}")

  clock.done(18)
  # -- 19. generated terrain: the composer, and Asimov on the height-field preset --
  compose_path(card)
  hf_launches, hf_ms = hf_path(card, attr, checks)

  clock.done(19)
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
      "launches_hf_path": hf_launches[name],
      "ms_hf_run_matrices": hf_ms[name],
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
    k["launches_user_robot_path"] = user_launches[k["name"]]
    k["ms_user_robot_matrices_by_nv"] = user_ms[k["name"]]
    k["launches_pgs_path"] = pgs_run["launches"][k["name"]]
    k["launches_muscle_scenes_path"] = muscle_launches[k["name"]]
    k["launches_generic_mdp_path"] = generic["launches"][k["name"]]
    k["launches_pair_scenes_path"] = pair_launches[k["name"]]
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
    "launches_user_robot_path": user_launches[CONE_KERNEL],
    "ms_user_robot_matrices_by_nv": user_ms[CONE_KERNEL],
    "max_abs_err": checks.max_abs_err[CONE_KERNEL],
    "ms": ell["ms"],
    "plain_ms": ell["plain_ms"],
    "bound_ms": ell["bound"][0],
    "bound_by": ell["bound"][1],
    "library_ms": ell["library_ms"],
    "launch": ell["launch"],
    "launches_pgs_path": pgs_run["launches"][CONE_KERNEL],
    "launches_muscle_scenes_path": muscle_launches[CONE_KERNEL],
    "launches_generic_mdp_path": generic["launches"][CONE_KERNEL],
    "launches_pair_scenes_path": pair_launches[CONE_KERNEL],
    "launches_hf_path": hf_launches[CONE_KERNEL],
  })
  kernels.append({
    "name": PGS_KERNEL,
    "route": "cuda",
    "source": "mjlab_tpu_torch/csrc/pgs.cu",
    "replaces": "mjlab_tpu/physics/solver.py:327-362 (pgs_solve: A, b, then the row sweeps) "
                "and :366 (qfrc = J^T f)",
    "launches": pgs_run["launches"][PGS_KERNEL],
    "launches_pgs_path": pgs_run["launches"][PGS_KERNEL],
    "launches_pgs_training_path": pgs_run["train_launches"][PGS_KERNEL],
    "launches_muscle_scenes_path": muscle_launches[PGS_KERNEL],
    "launches_generic_mdp_path": generic["launches"][PGS_KERNEL],
    "launches_pair_scenes_path": pair_launches[PGS_KERNEL],
    "launches_hf_path": hf_launches[PGS_KERNEL],
    "max_abs_err": checks.max_abs_err[PGS_KERNEL],
    "ms": pgs_run["ms"],
    "plain_ms": pgs_run["plain_ms"],
    "bound_ms": pgs_run["bound"][0],
    "bound_by": pgs_run["bound"][1],
    "library_ms": None,
    "env_step_ms": pgs_run["env_step_ms"],
    "launch": pgs_run["launch"],
    "max_active_rows": pgs_run["max_rows"],
  })
  newton_replaces = {
    "warm_start": "mjlab_tpu/physics/solver.py:182-192 (total_cost, the warm start's choice), "
                  "then at the chosen point :218-224 (newton_iter's residual, forces, grad, "
                  "row_hess, cone blocks) or :300-303 (cg_solve's grad_at(x0))",
    "newton_linesearch": "mjlab_tpu/physics/solver.py:231-266 (newton_iter's linesearch and "
                         "acceptance, the elliptic safeguard), :268-287, :308-313 "
                         "(cg_solve's), then at the accepted point :218-224 (the next "
                         "iteration's grad, row_hess, cone blocks), :300-301 or :378-386",
    "newton_gradient": "mjlab_tpu/physics/solver.py:378-386 (the final forces, in a solve of 0 "
                       "iterations), :218-224 and :300-301 (the gradient, w and blocks at a "
                       "given point, with the list's build)",
  }
  paths = {"physics": launches, "training": train_launches, "tracking": track_launches,
           "lifecycle": lifecycle_launches, "asimov": asimov_launches,
           "rough_go1": rough_launches, "rough": rough13_launches,
           "elliptic": ell["launches"], "cg": cg_launches, "scenes": scene_launches,
           "surface": surface_launches, "user_robot": user_launches,
           "pgs": pgs_run["launches"], "muscle_scenes": muscle_launches,
           "generic_mdp": generic["launches"], "pair_scenes": pair_launches,
           "hf": hf_launches}
  paths["zero_iteration"] = zero_launches
  for name in NEWTON_KERNELS:
    gradient = name == "newton_gradient"
    kernels.append({
      "name": name,
      "route": "cuda",
      "source": "mjlab_tpu_torch/csrc/newton_iter.cu",
      "replaces": newton_replaces[name],
      # newton_gradient launches in solves of 0 iterations only (phase 3c).
      "launches": zero_launches[name] if gradient else env_launches[name],
      **{f"launches_{k}_path": v[name] for k, v in paths.items()},
      "max_abs_err": checks.max_abs_err[name],
      "ms": iter_times[name]["ms"],
      "ms_main_path": None if gradient else path_ms[name],
      "ms_run_rows": run_iter[name]["ms"],
      "ms_elliptic_rows": ell["iter"][name]["ms"],
      "ms_cg_rows": cg_iter[name]["ms"],
      "plain_ms": iter_times[name]["plain_ms"],
      "plain_ms_run_rows": run_iter[name]["plain_ms"],
      "bound_ms": iter_times[name]["bound"][0],
      "bound_by": iter_times[name]["bound"][1],
      "bound_ms_run_rows": run_iter[name]["bound"][0],
      "bound_ms_elliptic_rows": ell["iter"][name]["bound"][0],
      "bound_ms_cg_rows": cg_iter[name]["bound"][0],
      **({"ms_list_reused_run_rows": run_iter[name]["ms_list_reused"]}
         if name == "newton_gradient" else {}),
      **({"bound_ms_iteration_run_rows": run_iter["iteration"]["bound"][0],
          "bound_ms_iteration_elliptic_rows": ell["iter"]["iteration"]["bound"][0],
          "bound_ms_iteration_cg_rows": cg_iter["iteration"]["bound"][0]}
         if name == "newton_linesearch" else {}),
      # No PyTorch call computes an exact linesearch or this cost; the torch
      # path the kernel replaces is its plain version (plain_ms).
      "library_ms": None,
      "launch": iter_cfg[name],
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
