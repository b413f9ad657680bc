"""Deployed-policy inference wrappers (port of mjlab_tpu/rl/onnx_policy.py;
reference rl/onnx_policy.py).

`TorchScriptPolicy` loads a `model_<iteration>_policy.pt` export of
rl/exporter.py with its embedded `metadata.json`; `OnnxPolicy` needs
onnxruntime and raises ImportError without it. Both map an observation
array to an action array on the CPU and expose the deployment metadata.
"""

from __future__ import annotations

import json

import numpy as np
import torch


class TorchScriptPolicy:
  def __init__(self, path: str) -> None:
    extra = {"metadata.json": ""}
    self._module = torch.jit.load(path, map_location="cpu", _extra_files=extra)
    self._module.eval()
    self.metadata = json.loads(extra["metadata.json"]) if extra["metadata.json"] else {}

  def __call__(self, obs: np.ndarray) -> np.ndarray:
    with torch.no_grad():
      return self._module(torch.from_numpy(np.asarray(obs, dtype=np.float32))).numpy()


class OnnxPolicy:
  def __init__(self, path: str) -> None:
    try:
      import onnxruntime as ort
    except ImportError as e:
      raise ImportError(
        "onnxruntime is required for OnnxPolicy; use TorchScriptPolicy for .pt exports."
      ) from e
    self._session = ort.InferenceSession(path)
    meta = self._session.get_modelmeta().custom_metadata_map
    self.metadata = {k: json.loads(v) for k, v in meta.items()}
    self._input = self._session.get_inputs()[0].name

  def __call__(self, obs: np.ndarray) -> np.ndarray:
    return self._session.run(None, {self._input: np.asarray(obs, np.float32)})[0]
