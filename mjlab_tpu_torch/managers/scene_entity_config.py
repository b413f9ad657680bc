"""SceneEntityCfg: declarative entity sub-selection used in term params
(port of mjlab_tpu/managers/scene_entity_config.py).

Resolution is the JAX package's, except that resolved ids are int64 tensors
on the scene's device (so a term indexes with them without a host-to-device
copy), or `slice(None)` when the selection is everything in order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class SceneEntityCfg:
  name: str
  joint_names: str | tuple[str, ...] | None = None
  joint_ids: list[int] | slice | torch.Tensor = field(default_factory=lambda: slice(None))
  body_names: str | tuple[str, ...] | None = None
  body_ids: list[int] | slice | torch.Tensor = field(default_factory=lambda: slice(None))
  geom_names: str | tuple[str, ...] | None = None
  geom_ids: list[int] | slice | torch.Tensor = field(default_factory=lambda: slice(None))
  site_names: str | tuple[str, ...] | None = None
  site_ids: list[int] | slice | torch.Tensor = field(default_factory=lambda: slice(None))
  actuator_names: str | tuple[str, ...] | None = None
  actuator_ids: list[int] | slice | torch.Tensor = field(default_factory=lambda: slice(None))
  preserve_order: bool = False

  def resolve(self, scene) -> None:
    entity = scene[self.name]
    device = scene.device
    finders = {
      "joint": "find_joints",
      "body": "find_bodies",
      "geom": "find_geoms",
      "site": "find_sites",
      "actuator": "find_actuators",
    }
    for kind in ("joint", "body", "geom", "site", "actuator"):
      names = getattr(self, f"{kind}_names")
      ids = getattr(self, f"{kind}_ids")
      all_names = getattr(entity, f"{kind}_names")
      finder = getattr(entity, finders[kind])

      def tensor(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

      if names is not None and not isinstance(ids, slice):
        found_ids, found_names = finder(names, preserve_order=self.preserve_order)
        if list(found_ids) != [int(i) for i in ids]:
          raise ValueError(
            f"Inconsistent {kind} names/ids for entity '{self.name}': "
            f"{names} resolves to {found_ids}, got {ids}."
          )
        setattr(self, f"{kind}_ids", tensor(found_ids))
        setattr(self, f"{kind}_names", tuple(found_names))
      elif names is not None:
        found_ids, found_names = finder(names, preserve_order=self.preserve_order)
        if (len(found_ids) == len(all_names) and not self.preserve_order
            and list(found_ids) == list(range(len(all_names)))):
          setattr(self, f"{kind}_ids", slice(None))
        else:
          setattr(self, f"{kind}_ids", tensor(found_ids))
        setattr(self, f"{kind}_names", tuple(found_names))
      elif not isinstance(ids, slice):
        ids = [int(i) for i in ids]
        setattr(self, f"{kind}_ids", tensor(ids))
        setattr(self, f"{kind}_names", tuple(all_names[i] for i in ids))
