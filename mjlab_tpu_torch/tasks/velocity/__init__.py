"""Velocity-tracking locomotion task (port of mjlab_tpu/tasks/velocity)."""
