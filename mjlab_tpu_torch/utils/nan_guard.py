"""NaN guard: a ring of physics-state snapshots, dumped on the first NaN
(port of mjlab_tpu/utils/nan_guard.py; reference utils/nan_guard.py).

`NanGuard.watch()`, called after a step or a training iteration, copies
qpos, qvel, qacc, ctrl and time of every env to the host in one copy (host
arrays that never alias the live state) and keeps the last `buffer_size`
snapshots. On the first snapshot with a NaN or inf in qpos or qvel it writes
the ring of up to `max_envs_to_dump` of the poisoned envs as
`env_<id>.npz`, the env's compiled model as `model.npz` (readable by
`mjlab_tpu_torch.assets.load_model_npz`) into `<output_dir>/nan_<stamp>/`,
and points the `latest` link there. The JAX guard writes the model as
`model.mjb` through `mujoco`, which the port does not import, and its
`nan_viz` viewer is not ported. A watch costs one pull of the state, and
only an enabled guard makes it.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

_FIELDS = ("qpos", "qvel", "qacc", "ctrl")


@dataclass
class NanGuardCfg:
  enabled: bool = False
  buffer_size: int = 20
  max_envs_to_dump: int = 4
  output_dir: str = "nan_dumps"


class NanGuard:
  def __init__(self, cfg: NanGuardCfg, env) -> None:
    self.cfg = cfg
    self.env = env
    self._ring: deque = deque(maxlen=cfg.buffer_size)
    self._fired = False

  def watch(self) -> bool:
    """Snapshot the env's state; True on the first snapshot with a NaN."""
    if not self.cfg.enabled or self._fired:
      return False
    data = self.env.data
    # (B, width) each; torch.cat makes a new tensor, so the host array never
    # aliases the live state, on the CPU too.
    parts = [getattr(data, f) for f in _FIELDS] + [data.time[:, None]]
    host = torch.cat([p.to(data.qpos.dtype) for p in parts], 1).cpu().numpy()
    cols = np.split(host, np.cumsum([p.shape[1] for p in parts])[:-1], axis=1)
    snap = dict(zip((*_FIELDS, "time"), cols))
    snap["time"] = snap["time"][:, 0]
    self._ring.append(snap)
    nan_mask = ~(np.isfinite(snap["qpos"]).all(-1) & np.isfinite(snap["qvel"]).all(-1))
    if not nan_mask.any():
      return False
    self._fired = True
    self._dump(np.nonzero(nan_mask)[0][: self.cfg.max_envs_to_dump])
    return True

  def _dump(self, env_ids: np.ndarray) -> None:
    from mjlab_tpu_torch.assets import save_model_npz

    out = Path(self.cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    run_dir = out / f"nan_{time.strftime('%Y%m%d_%H%M%S')}"
    run_dir.mkdir(exist_ok=True)
    for env_id in env_ids:
      arrays = {key: np.stack([s[key][env_id] for s in self._ring]) for key in self._ring[0]}
      np.savez(run_dir / f"env_{env_id}.npz", **arrays)
    save_model_npz(self.env.sim.mj_model, run_dir / "model.npz")
    latest = out / "latest"
    try:
      if latest.is_symlink() or latest.exists():
        latest.unlink()
      latest.symlink_to(run_dir.name)
    except OSError:
      pass
    print(f"[nan_guard] NaN detected! Dumped {len(env_ids)} envs × "
          f"{len(self._ring)} states to {run_dir}")
