"""Entry-point scripts of the port (`python -m mjlab_tpu_torch.scripts.train`)."""
