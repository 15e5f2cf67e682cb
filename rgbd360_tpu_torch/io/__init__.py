"""Calibration and capture-format readers of the port (twins of `rgbd360_tpu/io`)."""
