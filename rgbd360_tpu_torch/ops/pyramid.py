"""Image pyramids and gradients for dense alignment (twin of
`rgbd360_tpu/ops/pyramid.py`).

Every function takes one image (H, W) or a stack (B, H, W) of them.

* Gray pyramid: 5-tap binomial pyrDown with circular wrap (correct in
  azimuth; the wrapped border rows are harmless because row-border
  gradients are zeroed downstream): kernel K2,
  `ops/hopper_kernels.fused_pyr_down_circular`, for even shapes.
* Depth pyramid: 2x2 block mean over valid depths only.  Inside a frame
  pyramid it rides in K2's launch (`fused_level_down`, one launch per level
  transition for gray and depth); `pyr_down_depth` alone is a 0/1 matmul
  sandwich over the depth sum and the valid count.
* Gradients: the harmonic mean of forward and backward differences where
  the pixel lies strictly between its neighbours (kernel K1,
  `ops/hopper_kernels.fused_gradients`; `gradient_xy_levels` takes every
  level of a pyramid, and the seam masks, in one launch).  Border
  columns/rows are zeroed even though the sphere wraps, as in the
  reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rgbd360_tpu_torch.ops import hopper_kernels

_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


@functools.lru_cache(maxsize=64)
def _blur_decim_mats(h: int, w: int, device: torch.device):
    """Banded matrices of the reference's pyrDown, out = A @ img @ B: A
    (h/2, h) blurs and decimates rows, B (w, w/2) columns, both with
    circular wrap; on `device`, made once."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0
    a = np.zeros((h // 2, h), np.float32)
    for t in range(5):
        for i in range(h // 2):
            a[i, (2 * i + t - 2) % h] += k[t]
    b = np.zeros((w, w // 2), np.float32)
    for t in range(5):
        for j in range(w // 2):
            b[(2 * j + t - 2) % w, j] += k[t]
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


@functools.lru_cache(maxsize=64)
def _box_sum_mats(h: int, w: int, device: torch.device):
    """0/1 matrices whose sandwich product is the 2x2 block sum:
    A2 (h/2, h), B2 (w, w/2), on `device`, made once."""
    a = np.zeros((h // 2, h), np.float32)
    a[np.arange(h // 2), 2 * np.arange(h // 2)] = 1.0
    a[np.arange(h // 2), 2 * np.arange(h // 2) + 1] = 1.0
    b = np.zeros((w, w // 2), np.float32)
    b[2 * np.arange(w // 2), np.arange(w // 2)] = 1.0
    b[2 * np.arange(w // 2) + 1, np.arange(w // 2)] = 1.0
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def _sep_filter5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur with circular shifts (odd shapes)."""
    k = [float(x) for x in _BINOMIAL5]
    acc = k[2] * img
    for i, wt in ((1, k[1]), (2, k[0])):
        acc = acc + wt * (torch.roll(img, i, dims=-2) + torch.roll(img, -i, dims=-2))
    img = acc
    acc = k[2] * img
    for i, wt in ((1, k[1]), (2, k[0])):
        acc = acc + wt * (torch.roll(img, i, dims=-1) + torch.roll(img, -i, dims=-1))
    return acc


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown equivalent: blur, then keep even rows and columns; one
    K2 launch for the whole stack."""
    h, w = img.shape[-2:]
    if h % 2 == 0 and w % 2 == 0 and h >= 6 and w >= 6:
        out = hopper_kernels.fused_pyr_down_circular(img.reshape(-1, h, w).contiguous())
        return out.reshape(*img.shape[:-2], h // 2, w // 2)
    return _sep_filter5(img)[..., ::2, ::2]


def _valid_mean(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.where(n > 0.5, s / torch.clamp(n, min=1.0), 0.0)


def pyr_down_depth(
    depth: torch.Tensor, min_depth: float, max_depth: float
) -> torch.Tensor:
    """2x2 valid-mean downsample (reference `buildPyramidRange`)."""
    h, w = depth.shape[-2:]
    valid = (depth > min_depth) & (depth < max_depth)
    masked = torch.where(valid, depth, 0.0)
    if h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2:
        a, b = _box_sum_mats(h, w, depth.device)
        return _valid_mean((a @ masked) @ b, (a @ valid.to(depth.dtype)) @ b)
    h2, w2 = h // 2, w // 2
    lead = depth.shape[:-2]
    s = masked[..., : h2 * 2, : w2 * 2].reshape(*lead, h2, 2, w2, 2).sum(dim=(-3, -1))
    n = valid[..., : h2 * 2, : w2 * 2].reshape(*lead, h2, 2, w2, 2).sum(dim=(-3, -1))
    return torch.where(n > 0, s / torch.clamp(n, min=1), 0.0)


def fused_level_down(
    gray: torch.Tensor, depth: torch.Tensor, min_depth: float, max_depth: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level for gray AND depth.  Even shapes take ONE K2
    launch (`hopper_kernels.fused_level_down`): the gray's pyrDown and the
    depth's 2x2 valid mean, whose block sums have 2 addends per pass, so
    the depth is bit-equal to the reference's matmul sandwich.  Odd shapes
    (which no pyramid of the port reaches) keep the reference's
    banded-matmul gray, whose output is (H//2, W//2), and
    `pyr_down_depth`."""
    h, w = gray.shape[-2:]
    if h % 2 == 0 and w % 2 == 0:
        g2, d2 = hopper_kernels.fused_level_down(
            gray.reshape(-1, h, w).contiguous(), depth.reshape(-1, h, w).contiguous(),
            min_depth, max_depth,
        )
        return (g2.reshape(*gray.shape[:-2], h // 2, w // 2),
                d2.reshape(*depth.shape[:-2], h // 2, w // 2))
    a_g, b_g = _blur_decim_mats(h, w, gray.device)
    return (a_g @ gray) @ b_g, pyr_down_depth(depth, min_depth, max_depth)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[img, pyr_down(img), ...]: `levels` images, one K2 launch per level
    transition of an even shape."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


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


def gradient_xy_levels(stacks, masks=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(gx, gy)] of every (C, H, W) stack of a pyramid in ONE K1 launch,
    each multiplied by its (H, W) bool seam mask when `masks` is given."""
    return hopper_kernels.fused_gradients_levels([x.contiguous() for x in stacks], masks)


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
