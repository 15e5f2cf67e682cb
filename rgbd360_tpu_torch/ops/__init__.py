"""Tensor ops of the port (twins of `rgbd360_tpu/ops`)."""
