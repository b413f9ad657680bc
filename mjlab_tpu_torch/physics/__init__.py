"""Batched physics engine (port of mjlab_tpu.physics): the env axis is the
leading dimension of every Data tensor; Topology stays host numpy."""

from mjlab_tpu_torch.physics.types import Contact, Data, Model, Option, Topology
from mjlab_tpu_torch.physics.io import make_data, put_model
from mjlab_tpu_torch.physics.forward import forward, step

__all__ = [
  "Contact",
  "Data",
  "Model",
  "Option",
  "Topology",
  "put_model",
  "make_data",
  "forward",
  "step",
]
