"""mjlab_tpu_torch: the PyTorch/CUDA port of mjlab_tpu.

The JAX package `mjlab_tpu` stays the reference; this package mirrors its
module names (`physics/`, `sim/`, `core/`) so each function has an obvious
counterpart. Differences in form:
  * the env axis is written out as the leading dimension of every Data
    tensor instead of `vmap`ing single-world code;
  * model structure (`Topology`) stays host numpy, and every index tensor the
    step gathers or scatters with is uploaded once, at `put_model`;
  * hand-written CUDA kernels (`csrc/`, wrapped in `kernels/`) replace the
    stages XLA fused on the TPU. Each wrapper runs its plain PyTorch version
    for CPU tensors (the tests) and launches the kernel for CUDA tensors.

This package imports `torch` and never `jax`, `mujoco` or `mjlab_tpu`.
"""

__version__ = "0.1.0"
