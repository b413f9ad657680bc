"""The env axis split over ranks, and the few collectives the port needs.

A rank owns the envs [offset, offset + num_envs) of a batch of `total`
(`EnvShard`). A sharded run computes what the unsharded run computes:

- every per-env draw is the global batch's draw from the same-seeded
  generator, restricted to the rank's rows (`env_rows`), so that each
  generator advances as the unsharded run's does;
- a reduction over the env axis that the step's state depends on is taken
  over ranks (`any_over_ranks`, `sum_over_ranks`);
- the learner's update runs on every rank on the gathered batch
  (`gather_env_axis`), with the same permutations, so that its parameters
  stay equal without a gradient all-reduce.

torch.distributed's gloo backend offers only broadcast, all_reduce and
barrier on CUDA tensors, so the gather is an all_reduce of a zero-filled
global buffer into which each rank writes its own rows: x + 0 = x, exact,
and one code path for NCCL, gloo on the card and the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class EnvShard:
  offset: int  # the first global env id of this rank
  num_envs: int  # this rank's envs
  total: int  # the global batch

  @property
  def sharded(self) -> bool:
    return self.num_envs != self.total


# Sharded generators by id, each beside its generator (so that the id stays
# its own): some builds of torch cannot weakly reference a CUDA generator.
_SHARDS: dict[int, tuple[torch.Generator, EnvShard]] = {}


def shard_generator(generator: torch.Generator, shard: EnvShard) -> None:
  """Mark `generator` as the per-env generator of a rank owning `shard`."""
  _SHARDS[id(generator)] = (generator, shard)


def env_rows(draw, shape, *args, generator: torch.Generator, axis: int = 0, **kw):
  """`draw(*args, shape, generator=generator, **kw)` whose `axis` is the
  env axis. For a sharded generator: the global batch's draw, this rank's
  rows of it; else the draw itself."""
  held, shard = _SHARDS.get(id(generator), (None, None))
  if held is not generator or not shard.sharded:
    return draw(*args, shape, generator=generator, **kw)
  shape = tuple(shape)
  if shape[axis] != shard.num_envs:
    raise ValueError(f"env axis {axis} of {shape} is not this rank's {shard.num_envs} envs")
  full = shape[:axis] + (shard.total,) + shape[axis + 1 :]
  out = draw(*args, full, generator=generator, **kw)
  return out.narrow(axis, shard.offset, shard.num_envs).contiguous()


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
  """x summed over the ranks of the process group (x alone without one)."""
  if not (dist.is_available() and dist.is_initialized()):
    return x
  out = x.clone()
  dist.all_reduce(out, op=dist.ReduceOp.SUM)
  return out


def any_over_ranks(x: torch.Tensor) -> torch.Tensor:
  """A boolean tensor OR-ed over the ranks."""
  if not (dist.is_available() and dist.is_initialized()):
    return x
  return sum_over_ranks(x.to(torch.int32)) > 0


def gather_env_axis(x: torch.Tensor, shard: EnvShard, axis: int = 0) -> torch.Tensor:
  """The global batch of x, whose `axis` holds this rank's envs: each rank
  writes its rows into a zero-filled buffer of the global size, and the
  buffers are summed over ranks. Booleans travel as integers."""
  if not (dist.is_available() and dist.is_initialized()):
    return x
  shape = list(x.shape)
  shape[axis] = shard.total
  wire = torch.int32 if x.dtype == torch.bool else x.dtype
  buf = torch.zeros(shape, dtype=wire, device=x.device)
  buf.narrow(axis, shard.offset, shard.num_envs).copy_(x)
  dist.all_reduce(buf, op=dist.ReduceOp.SUM)
  return buf.to(x.dtype) if wire != x.dtype else buf
