"""CLAMS depth undistortion (twin of `rgbd360_tpu/ops/undistort.py`).

Reproduces `DiscreteFrustum::interpolatedUndistort` over whole images: each
pixel belongs to a static frustum, its depth selects one or two depth bins,
and the depth is scaled by the (optionally interpolated) multiplier.  Bins
with fewer than 50 training examples fall back to the nearest bin's
multiplier.
"""

from __future__ import annotations

import torch

_MIN_COUNT = 50.0


def precompute_pixel_tables(
    multipliers: torch.Tensor,
    counts: torch.Tensor,
    bin_width: int,
    bin_height: int,
    h: int,
    w: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand the (..., nby, nbx, nbins) frustum tables to bin-major
    per-pixel tables (..., nbins, H, W), once per calibration."""
    dev = multipliers.device
    yb = torch.arange(h, device=dev) // bin_height
    xb = torch.arange(w, device=dev) // bin_width
    m_img = multipliers[..., yb[:, None], xb[None, :], :]
    c_img = counts[..., yb[:, None], xb[None, :], :]
    return m_img.movedim(-1, -3).contiguous(), c_img.movedim(-1, -3).contiguous()


def undistort_depth_pixeltab(
    depth: torch.Tensor,
    m_img: torch.Tensor,
    c_img: torch.Tensor,
    bin_depth: float,
) -> torch.Tensor:
    """Undistort (..., H, W) f32 metre depth with the bin-major per-pixel
    tables of `precompute_pixel_tables`; 0 = invalid passes through.

    The bin lookup stays a select over the few bins (not a gather), in the
    reference's operation order, so the result is bit-equal to it."""
    nbins = m_img.shape[-3]
    z = depth
    idx = torch.clamp(torch.floor(z / bin_depth).to(torch.int32), max=nbins - 1)
    start = bin_depth * idx.to(z.dtype)
    idx1 = torch.where(z - start < 0.5 * bin_depth, idx, idx + 1)
    idx0 = idx1 - 1

    def sel(tab, i):
        ic = torch.clamp(i, 0, nbins - 1)
        acc = torch.zeros_like(z)
        for k in range(nbins):
            acc = acc + torch.where(ic == k, tab[..., k, :, :], 0.0)
        return acc

    m_near = sel(m_img, idx)
    m0 = sel(m_img, idx0)
    m1 = sel(m_img, idx1)
    c0 = sel(c_img, idx0)
    c1 = sel(c_img, idx1)

    z0 = idx1.to(z.dtype) * bin_depth - 0.5 * bin_depth
    coeff1 = (z - z0) / bin_depth
    m_interp = (1.0 - coeff1) * m0 + coeff1 * m1
    fallback = (idx0 < 0) | (idx1 >= nbins) | (c0 < _MIN_COUNT) | (c1 < _MIN_COUNT)
    mult = torch.where(fallback, m_near, m_interp)
    return torch.where(z > 0, z * mult, z)
