"""Pinhole and spherical camera models (twin of `rgbd360_tpu/ops/camera.py`).

Spherical image of size (H, W): row r has elevation
phi = (H/2 - 0.5 - r) * res, column c has azimuth theta = c * res with
res = 2*pi/W; the unit ray is (sin phi, -cos phi sin theta, -cos phi cos theta).
Projection: rho = |p|, phi = asin(x/rho), theta = atan2(y, z) + pi.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------- pinhole


def pinhole_backproject(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Backproject an organized depth map (..., H, W) to points (..., H, W, 3)."""
    h, w = depth.shape[-2], depth.shape[-1]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    x = (u - k[0, 2]) * depth / k[0, 0]
    y = (v - k[1, 2]) * depth / k[1, 1]
    return torch.stack([x, y, depth], dim=-1)


def pinhole_project(pts: torch.Tensor, k: torch.Tensor):
    """Project points (..., 3) -> pixel coords (..., 2) as (u, v) and depth."""
    z = pts[..., 2]
    zs = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    u = k[0, 0] * pts[..., 0] / zs + k[0, 2]
    v = k[1, 1] * pts[..., 1] / zs + k[1, 2]
    return torch.stack([u, v], dim=-1), z


def radial_scale(
    k: torch.Tensor, h: int, w: int, dtype=torch.float32
) -> torch.Tensor:
    """Per-pixel z-depth -> ray-length factor
    sqrt(1 + ((u-cx)/fx)^2 + ((v-cy)/fy)^2)."""
    v = torch.arange(h, dtype=dtype, device=k.device)[:, None]
    u = torch.arange(w, dtype=dtype, device=k.device)[None, :]
    xn = (u - k[0, 2]) / k[0, 0]
    yn = (v - k[1, 2]) / k[1, 1]
    return torch.sqrt(1.0 + xn * xn + yn * yn)


# ---------------------------------------------------------------- sphere


def sphere_angles(h: int, w: int, dtype=torch.float32, device=None):
    """(phi[h], theta[w]) grids for a spherical image."""
    res = 2.0 * math.pi / w
    r = torch.arange(h, dtype=dtype, device=device)
    c = torch.arange(w, dtype=dtype, device=device)
    phi = (0.5 * h - 0.5 - r) * res
    theta = c * res
    return phi, theta


def sphere_rays(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Unit rays (h, w, 3) for every pixel of a spherical image."""
    phi, theta = sphere_angles(h, w, dtype, device)
    sp, cp = torch.sin(phi)[:, None], torch.cos(phi)[:, None]
    st, ct = torch.sin(theta)[None, :], torch.cos(theta)[None, :]
    x = sp.expand(h, w)
    y = -cp * st
    z = -cp * ct
    return torch.stack([x, y, z], dim=-1)


def sphere_rays_at(r: torch.Tensor, c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Unit rays (..., 3) at the given (row, col) index tensors (the
    formulas of `sphere_rays`, evaluated only where needed)."""
    res = 2.0 * math.pi / w
    phi = (0.5 * h - 0.5 - r.to(torch.float32)) * res
    theta = c.to(torch.float32) * res
    sp, cp = torch.sin(phi), torch.cos(phi)
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([sp, -cp * st, -cp * ct], dim=-1)


def sphere_backproject(depth: torch.Tensor) -> torch.Tensor:
    """Organized spherical radial depth (..., H, W) -> points (..., H, W, 3);
    invalid (<= 0) depth yields the origin."""
    h, w = depth.shape[-2], depth.shape[-1]
    return sphere_rays(h, w, depth.dtype, depth.device) * depth[..., None]


def sphere_project(pts: torch.Tensor, h: int, w: int):
    """Points (..., 3) -> continuous pixel coords (..., 2) as (r, c) and range.

    Wrap-around in theta is the caller's concern (mod w on the column)."""
    rho = torch.linalg.norm(pts, dim=-1)
    rho_s = torch.clamp(rho, min=1e-12)
    phi = torch.arcsin(torch.clamp(pts[..., 0] / rho_s, -1.0, 1.0))
    theta = torch.atan2(pts[..., 1], pts[..., 2]) + math.pi
    res_inv = w / (2.0 * math.pi)
    r = 0.5 * h - 0.5 - phi * res_inv
    c = theta * res_inv
    return torch.stack([r, c], dim=-1), rho
