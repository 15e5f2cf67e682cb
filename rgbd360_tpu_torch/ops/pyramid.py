"""Image pyramids and gradients for dense alignment (twin of
`rgbd360_tpu/ops/pyramid.py`).

* Gray pyramid: 5-tap binomial pyrDown, as two banded constant matmuls
  A @ img @ B with circular wrap (correct in azimuth; the wrapped border
  rows are harmless because row-border gradients are zeroed downstream).
* Depth pyramid: 2x2 block mean over valid depths only.
* Gradients: the harmonic mean of forward and backward differences where
  the pixel lies strictly between its neighbours (kernel K1,
  `ops/hopper_kernels.fused_gradients`).  Border columns/rows are zeroed
  even though the sphere wraps, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rgbd360_tpu_torch.ops import hopper_kernels

_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


@functools.lru_cache(maxsize=None)
def _blur_decim_mats(h: int, w: int):
    """Banded matrices of pyrDown: out = A @ img @ B, A (h/2, h) blurs and
    decimates rows, B (w, w/2) columns, both with circular wrap."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0
    a = np.zeros((h // 2, h), np.float32)
    for t in range(5):
        for i in range(h // 2):
            a[i, (2 * i + t - 2) % h] += k[t]
    b = np.zeros((w, w // 2), np.float32)
    for t in range(5):
        for j in range(w // 2):
            b[(2 * j + t - 2) % w, j] += k[t]
    return a, b


@functools.lru_cache(maxsize=None)
def _box_sum_mats(h: int, w: int):
    """0/1 matrices whose sandwich product is the 2x2 block sum:
    A2 (h/2, h), B2 (w, w/2)."""
    a = np.zeros((h // 2, h), np.float32)
    a[np.arange(h // 2), 2 * np.arange(h // 2)] = 1.0
    a[np.arange(h // 2), 2 * np.arange(h // 2) + 1] = 1.0
    b = np.zeros((w, w // 2), np.float32)
    b[2 * np.arange(w // 2), np.arange(w // 2)] = 1.0
    b[2 * np.arange(w // 2) + 1, np.arange(w // 2)] = 1.0
    return a, b


@functools.lru_cache(maxsize=None)
def _level_down_mats(h: int, w: int):
    """Channel-stacked level-transition matrices: channel 0 blurs and
    decimates (gray), channels 1-2 block-sum (depth sum, valid count)."""
    a_blur, b_blur = _blur_decim_mats(h, w)
    a_box, b_box = _box_sum_mats(h, w)
    return np.stack([a_blur, a_box, a_box]), np.stack([b_blur, b_box, b_box])


@functools.lru_cache(maxsize=64)
def _on_device(fn, h: int, w: int, device: torch.device):
    """The matrices of `fn(h, w)` as tensors on `device`, made once."""
    return tuple(torch.from_numpy(m).to(device) for m in fn(h, w))


def _sep_filter5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur with circular shifts (odd shapes)."""
    k = [float(x) for x in _BINOMIAL5]
    acc = k[2] * img
    for i, wt in ((1, k[1]), (2, k[0])):
        acc = acc + wt * (torch.roll(img, i, dims=0) + torch.roll(img, -i, dims=0))
    img = acc
    acc = k[2] * img
    for i, wt in ((1, k[1]), (2, k[0])):
        acc = acc + wt * (torch.roll(img, i, dims=1) + torch.roll(img, -i, dims=1))
    return acc


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown equivalent: blur, then keep even rows and columns."""
    h, w = img.shape
    if h % 2 == 0 and w % 2 == 0 and h >= 6 and w >= 6:
        a, b = _on_device(_blur_decim_mats, h, w, img.device)
        return (a @ img) @ b
    return _sep_filter5(img)[::2, ::2]


def pyr_down_depth(
    depth: torch.Tensor, min_depth: float, max_depth: float
) -> torch.Tensor:
    """2x2 valid-mean downsample (reference `buildPyramidRange`)."""
    h, w = depth.shape
    valid = (depth > min_depth) & (depth < max_depth)
    masked = torch.where(valid, depth, 0.0)
    if h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2:
        a, b = _on_device(_box_sum_mats, h, w, depth.device)
        s = (a @ masked) @ b
        n = (a @ valid.to(depth.dtype)) @ b
        return torch.where(n > 0.5, s / torch.clamp(n, min=1.0), 0.0)
    h2, w2 = h // 2, w // 2
    s = masked[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).sum(dim=(1, 3))
    n = valid[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).sum(dim=(1, 3))
    return torch.where(n > 0, s / torch.clamp(n, min=1), 0.0)


def fused_level_down(
    gray: torch.Tensor, depth: torch.Tensor, min_depth: float, max_depth: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level for gray AND depth in two batched matmuls (the
    three sandwiches of `pyr_down` / `pyr_down_depth`, channel-stacked)."""
    h, w = gray.shape
    a, b = _on_device(_level_down_mats, h, w, gray.device)
    valid = (depth > min_depth) & (depth < max_depth)
    x = torch.stack([gray, torch.where(valid, depth, 0.0), valid.to(gray.dtype)])
    out = torch.bmm(torch.bmm(a, x), b)
    n = out[2]
    return out[0], torch.where(n > 0.5, out[1] / torch.clamp(n, min=1.0), 0.0)


def build_depth_pyramid(
    depth: torch.Tensor, levels: int, min_depth: float = 0.3, max_depth: float = 20.0
) -> list[torch.Tensor]:
    pyr = [depth]
    for _ in range(levels - 1):
        pyr.append(pyr_down_depth(pyr[-1], min_depth, max_depth))
    return pyr


def gradient_xy_multi(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) of a stacked (C, H, W) tensor in one K1 launch."""
    return hopper_kernels.fused_gradients(imgs.contiguous())


def gradient_xy(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) of one (H, W) image (reference `calcGradientXY`)."""
    gx, gy = gradient_xy_multi(img[None])
    return gx[0], gy[0]


def mask_seams(
    grad: torch.Tensor, num_sensors: int = 8, half_width: int = 1
) -> torch.Tensor:
    """Zero gradient columns at the uniform sensor seams."""
    w = grad.shape[-1]
    span = w // num_sensors
    col = torch.arange(w, device=grad.device)
    mask = torch.ones((w,), dtype=torch.bool, device=grad.device)
    for s in range(1, num_sensors):
        seam = s * span
        mask = mask & ~((col >= seam - half_width) & (col < seam + half_width))
    return grad * mask
