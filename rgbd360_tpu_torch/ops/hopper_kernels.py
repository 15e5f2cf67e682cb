"""Hand-written Hopper kernels of the port, their wrappers and plain
versions.

`fused_gradients` (K1) replaces `rgbd360_tpu/ops/pallas_kernels.py:
fused_gradients`.  Its CUDA source is `csrc/fused_gradients.cu`, built by
`ops/_build.py` on first use.  The wrapper launches the kernel for a CUDA
tensor and raises if it cannot; it uses the plain PyTorch version only for
a tensor on the CPU.  `fused_gradients.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from rgbd360_tpu_torch.ops import _build


def _harmonic(fwd: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    mono = ((fwd > 0) & (bwd > 0)) | ((fwd < 0) & (bwd < 0))
    one = torch.ones_like(fwd)
    denom = torch.where(mono, one / torch.where(fwd == 0, 1e-12, fwd), 0.0) + torch.where(
        mono, one / torch.where(bwd == 0, 1e-12, bwd), 0.0
    )
    # tensor / tensor is IEEE division on every device (a Python scalar
    # numerator would become reciprocal * scalar)
    two = torch.full_like(fwd, 2.0)
    return torch.where(mono, two / torch.where(denom == 0, 1e-12, denom), 0.0)


def _axis_grad(a: torch.Tensor, dim: int) -> torch.Tensor:
    fwd = torch.roll(a, -1, dims=dim) - a
    bwd = a - torch.roll(a, 1, dims=dim)
    g = _harmonic(fwd, bwd)
    n = a.shape[dim]
    idx = torch.arange(n, device=a.device)
    shape = [1] * a.ndim
    shape[dim] = n
    interior = ((idx > 0) & (idx < n - 1)).reshape(shape)
    return torch.where(interior, g, 0.0)


def fused_gradients_plain(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: a port of
    `rgbd360_tpu/ops/pyramid.py:gradient_xy_multi` over (..., H, W)."""
    return _axis_grad(imgs, imgs.ndim - 1), _axis_grad(imgs, imgs.ndim - 2)


def fused_gradients(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) occlusion-aware harmonic-mean gradients of a stacked
    (C, H, W) float32 tensor, one launch for all channels and both axes."""
    if imgs.device.type == "cpu":
        return fused_gradients_plain(imgs)
    if imgs.device.type != "cuda":
        raise ValueError(f"fused_gradients: no kernel for device {imgs.device}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"fused_gradients: needs float32, got {imgs.dtype}")
    if imgs.ndim != 3:
        raise ValueError(f"fused_gradients: needs (C, H, W), got {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("fused_gradients: needs a contiguous tensor")
    c, h, w = imgs.shape
    lib = _build.load()
    gx = torch.empty_like(imgs)
    gy = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = lib.rgbd360_fused_gradients(
            imgs.data_ptr(), gx.data_ptr(), gy.data_ptr(), c, h, w, stream
        )
    _build.check(lib, code, "fused_gradients")
    fused_gradients.launches += 1
    return gx, gy


fused_gradients.launches = 0
