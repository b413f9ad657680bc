"""Motion-imitation task (port of mjlab_tpu/tasks/tracking)."""
