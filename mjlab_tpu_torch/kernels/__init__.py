"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers. Each
wrapper module keeps the kernel's plain PyTorch version beside it."""
