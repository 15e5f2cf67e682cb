"""Edge-preserving bilateral depth filtering (twin of
`rgbd360_tpu/ops/bilateral.py`).

A separable windowed bilateral, as the reference's stand-in for PCL's
`FastBilateralFilter` (sigmaS = 10 px, sigmaR = 0.05 m): one horizontal
pass, then one vertical pass, each a fan of rolled taps out to 2 sigmaS
whose weights combine the spatial Gaussian, the range Gaussian
exp(-0.5 ((d_n - d)/sigmaR)^2) and the neighbour's validity.  The rolls
wrap at the border, as the reference's do.
"""

from __future__ import annotations

import math

import torch


def _bilateral_pass(
    d: torch.Tensor, valid: torch.Tensor, sigma_s: float, sigma_r: float, dim: int
) -> torch.Tensor:
    """One 1-D bilateral sweep along `dim` (taps out to 2 sigma_s)."""
    radius = max(1, int(round(2.0 * sigma_s)))
    inv2ss = 0.5 / (sigma_s * sigma_s)
    inv2sr = 0.5 / (sigma_r * sigma_r)
    vf = valid.to(d.dtype)
    num = torch.where(valid, d, 0.0)
    den = vf
    for off in range(1, radius + 1):
        gs = math.exp(-(off * off) * inv2ss)
        for s in (off, -off):
            dn = torch.roll(d, s, dim)
            vn = torch.roll(vf, s, dim)
            diff = dn - d
            w = gs * vn * torch.exp(-(diff * diff) * inv2sr)
            num = num + w * dn
            den = den + w
    return torch.where(valid & (den > 1e-12), num / torch.clamp(den, min=1e-12), d)


def bilateral_depth(
    depth: torch.Tensor, sigma_s: float = 10.0, sigma_r: float = 0.05
) -> torch.Tensor:
    """Edge-preserving smoothing of (..., H, W) float32 metres; invalid
    (<= 0) pixels pass through untouched and contribute no weight.  (The
    reference's unused `num_slices` and `max_depth` are left out.)"""
    valid = depth > 0
    d = torch.where(valid, depth, 0.0)
    d = _bilateral_pass(d, valid, sigma_s, sigma_r, dim=-1)
    d = _bilateral_pass(d, valid, sigma_s, sigma_r, dim=-2)
    return torch.where(valid, d, depth)
