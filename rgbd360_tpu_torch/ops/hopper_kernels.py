"""Hand-written Hopper kernels of the port, their wrappers and plain
versions.

* `fused_gradients` (K1) replaces `rgbd360_tpu/ops/pallas_kernels.py:
  fused_gradients`; CUDA source `csrc/fused_gradients.cu`.
* `fused_pyr_down` (K2) replaces `rgbd360_tpu/ops/pallas_kernels.py:
  fused_pyr_down`; CUDA source `csrc/pyr_down.cu`.  One kernel serves two
  wrappers: `fused_pyr_down` (edge-clamped rows, as the Pallas kernel) and
  `fused_pyr_down_circular` (circular rows, what the pyramid's pyrDown
  computes, called on every level transition).

The sources are built by `ops/_build.py` on first use.  A wrapper launches
its kernel for a CUDA tensor and raises if it cannot; it uses the plain
PyTorch version only for a tensor on the CPU.  `<kernel>.launches` counts
kernel launches (K2's count is on `fused_pyr_down` and counts both
wrappers).
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


# ------------------------------------------------------------------ K2

_K0, _K1, _K2 = 1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0


def _blur5(m2, m1, c, p1, p2):
    """The Pallas body's order: k0*(m2+p2) + k1*(m1+p1) + k2*c.  (Not
    `ops/pyramid._sep_filter5`'s order.)"""
    return _K0 * (m2 + p2) + _K1 * (m1 + p1) + _K2 * c


def fused_pyr_down_plain(imgs: torch.Tensor, circular: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2 over (..., H, W) with even H and W: the
    5-tap binomial blur on rows (edge-clamped, or circular), then on
    columns (circular), keeping the even rows and columns."""
    h = imgs.shape[-2]
    even = torch.arange(0, h, 2, device=imgs.device)

    def rows(d):
        r = torch.remainder(even + d, h) if circular else torch.clamp(even + d, 0, h - 1)
        return imgs.index_select(-2, r)

    v = _blur5(rows(-2), rows(-1), rows(0), rows(1), rows(2))

    def cols(d):
        return torch.roll(v, -d, dims=-1)

    return _blur5(cols(-2), cols(-1), v, cols(1), cols(2))[..., ::2]


def _pyr_down(imgs: torch.Tensor, circular: bool, name: str) -> torch.Tensor:
    """The checks of both K2 wrappers (on every device, so the CPU tests
    see them), then the kernel, or the plain version for a CPU tensor."""
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {imgs.device}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {imgs.dtype}")
    if imgs.ndim != 3 or imgs.shape[1] % 2 or imgs.shape[2] % 2:
        raise ValueError(f"{name}: needs (C, H, W) with even H and W, got {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor")
    if imgs.device.type == "cpu":
        return fused_pyr_down_plain(imgs, circular)
    c, h, w = imgs.shape
    lib = _build.load()
    out = torch.empty((c, h // 2, w // 2), dtype=imgs.dtype, device=imgs.device)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = lib.rgbd360_pyr_down(
            imgs.data_ptr(), out.data_ptr(), c, h, w, int(circular), stream
        )
    _build.check(lib, code, name)
    fused_pyr_down.launches += 1
    return out


def fused_pyr_down(imgs: torch.Tensor) -> torch.Tensor:
    """K2: blur + 2x decimation of a stacked (C, H, W) float32 tensor with
    edge-clamped rows and circular columns, as the Pallas kernel."""
    return _pyr_down(imgs, False, "fused_pyr_down")


def fused_pyr_down_circular(imgs: torch.Tensor) -> torch.Tensor:
    """K2 with circular rows: the pyramid's pyrDown (the banded matmuls of
    `rgbd360_tpu/ops/pyramid.pyr_down`) of a stacked (C, H, W) tensor."""
    return _pyr_down(imgs, True, "fused_pyr_down_circular")


fused_pyr_down.launches = 0
