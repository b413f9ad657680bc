"""Env-sharded data parallelism on torch.distributed (port of
mjlab_tpu/distributed/): one process per rank, each owning
num_envs / world_size envs on its card, the learner replicated."""

from mjlab_tpu_torch.distributed.multihost import (  # noqa: F401
  global_env_offset,
  initialize_multihost,
  is_primary_host,
  local_device,
  process_count,
  process_index,
)
from mjlab_tpu_torch.distributed.sharding import (  # noqa: F401
  EnvShard,
  any_over_ranks,
  env_rows,
  gather_env_axis,
  shard_generator,
  sum_over_ranks,
)
