"""Process bootstrap of a multi-rank run, and who logs and saves.

`initialize_multihost()` reads the variables that `torch.distributed.run`
sets (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) and joins the process group. In a process started without
them it does nothing and returns False, so that every entry point can call
it. A configuration that names a rank but fails raises: it never degrades
to one process.

The backend is NCCL when each local rank has a card of its own, gloo when
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU. Under gloo the tensors stay on the card; gloo copies them through the
host for each collective.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _choose_backend(device: str | None) -> str:
  if device == "cpu" or not torch.cuda.is_available():
    return "gloo"
  local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
  return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def initialize_multihost(device: str | None = None) -> bool:
  """Join the process group torch.distributed.run describes; True if this
  process is (now) part of one. `device` "cpu" asks for gloo."""
  if dist.is_available() and dist.is_initialized():
    return True
  present = [v for v in _VARS if v in os.environ]
  if not present:
    return False
  if len(present) != len(_VARS):
    missing = [v for v in _VARS if v not in os.environ]
    raise ValueError(f"incomplete torch.distributed configuration: {missing} unset")
  rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
  backend = _choose_backend(device)
  if backend == "nccl":
    torch.cuda.set_device(local_device(device))
  print(f"[distributed] rank {rank} of {world}: backend {backend}", flush=True)
  # env:// reads MASTER_ADDR and MASTER_PORT, and joins the store that
  # torch.distributed.run's agent already serves there.
  dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
  return True


def local_device(device: str | None = None) -> torch.device:
  """This rank's device: the CPU where asked, else cuda:LOCAL_RANK, shared
  round robin where there are more local ranks than cards."""
  if device == "cpu":
    return torch.device("cpu")
  local = int(os.environ.get("LOCAL_RANK", "0"))
  return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def process_index() -> int:
  return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
  return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary_host() -> bool:
  """True on the process that owns logging, checkpoints and export."""
  return process_index() == 0


def global_env_offset(num_envs_per_rank: int) -> int:
  """The first global env id that this rank owns."""
  return process_index() * num_envs_per_rank
