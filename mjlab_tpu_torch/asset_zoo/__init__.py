"""Robot constants as data (port of the data part of mjlab_tpu/asset_zoo).

The port composes no MjSpec: a robot's compiled model, with its actuator
gains, arrives in a scene npz (mjlab_tpu_torch/assets). What stays here
are the numbers the tasks read: keyframes, actuator groups, soft joint
limit factors and action scales."""
