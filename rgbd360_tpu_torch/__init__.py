"""rgbd360_tpu_torch — the PyTorch + CUDA port of `rgbd360_tpu`.

Module paths mirror `rgbd360_tpu/`, so each module's reference twin is the
file of the same name there.  The port imports `torch` and never `jax`; the
JAX-free host modules of the reference package (`config`, `io.calib`,
`io.bin_format`, `apps.grabber.synth_capture` with an explicit `rt=`) are
shared as they are.

Functions run on the device of their input tensors.  Every hand-written
CUDA kernel sits behind a wrapper in `ops/hopper_kernels.py` that launches
it for a CUDA tensor and uses its plain PyTorch version only for a CPU
tensor.
"""

import torch

# The reference pins every geometric product to full f32
# (`Precision.HIGHEST` at registration/dense.py:314,584-602 and
# ops/pyramid.py:180-181): TF32 would put ~1 px of error into the warp
# addresses.  PyTorch's matmul default is already full f32; cuDNN's is not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
