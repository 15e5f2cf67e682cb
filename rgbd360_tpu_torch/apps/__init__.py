"""Applications of the port (twins of `rgbd360_tpu/apps`)."""
