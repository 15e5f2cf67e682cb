"""rgbd360_tpu_torch — the PyTorch + CUDA port of `rgbd360_tpu`.

Module paths mirror `rgbd360_tpu/`, so each module's reference twin is the
file of the same name there.  The port imports `torch` and never `jax`, and
nothing of the reference package: `config`, `io.calib`, `io.clams`,
`apps.grabber` and `calibration.spec` are its own copies of the reference's
plain-Python modules, and `convert` rebuilds the port's dataclasses from
the reference's (and back) for the tests and the golden tool.

Entry points that create state (`core.frame.FrameBuilder`,
`RigFrame.from_raw`) put it on the card unless the caller names a device:
`device=None` resolves through `default_device()`, which raises where there
is no CUDA device and never picks the CPU by itself; the tests pass
`device="cpu"`.  Every other function runs on the device of its input
tensors.  Every hand-written CUDA kernel sits behind a wrapper in
`ops/hopper_kernels.py` that launches it for a CUDA tensor and uses its
plain PyTorch version only for a CPU tensor.
"""

import torch

# The reference pins every geometric product to full f32
# (`Precision.HIGHEST` at registration/dense.py:314,584-602 and
# ops/pyramid.py:180-181): TF32 would put ~1 px of error into the warp
# addresses.  PyTorch's matmul default is already full f32; cuDNN's is not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device of an entry point called without one: the card.  Raises
    where there is none; the CPU is used only when a caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rgbd360_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)
