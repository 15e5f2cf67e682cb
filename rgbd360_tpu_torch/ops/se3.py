"""SE(3) Lie group operations in PyTorch (twin of `rgbd360_tpu/ops/se3.py`).

Closed-form, batched over leading axes.  Twist convention xi = (v, w),
translation first, so `se3_exp(xi) @ T` composes a Gauss-Newton update.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def skew(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector; batched over leading axes."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, numerically stable near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    wx = skew(w)
    wx2 = wx @ wx
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS)
    a = torch.where(theta2 > _EPS, a, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, b, 0.5 - theta2 / 24.0)
    return _eye3(wx) + a[..., None, None] * wx + b[..., None, None] * wx2


def _vee_asym(r: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3); returns the rotation vector."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    v = _vee_asym(r)
    scale = torch.where(
        torch.abs(sin_t) > _EPS,
        theta / (2.0 * sin_t + _EPS),
        0.5 + theta * theta / 12.0,
    )
    w = scale[..., None] * v
    # Near theta = pi the vee form degenerates; recover the axis from the
    # diagonal.
    near_pi = theta > 3.0
    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), min=0
    )
    axis = torch.sqrt(axis_sq)
    signs = torch.sign(v + _EPS)
    w_pi = theta[..., None] * axis * signs
    return torch.where(near_pi[..., None], w_pi, w)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    wx = skew(w)
    wx2 = wx @ wx
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS)
    c = (theta - torch.sin(theta)) / (theta2 * theta).clamp(min=_EPS * _EPS * _EPS)
    b = torch.where(theta2 > _EPS, b, 0.5 - theta2 / 24.0)
    c = torch.where(theta2 > _EPS, c, 1.0 / 6.0 - theta2 / 120.0)
    return _eye3(wx) + b[..., None, None] * wx + c[..., None, None] * wx2


def _homogeneous(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map: twist (v, w) -> 4x4 homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:]
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return _homogeneous(so3_exp(w), t)


def se3_log(t4: torch.Tensor) -> torch.Tensor:
    """Log map: 4x4 transform -> twist (v, w)."""
    w = so3_log(t4[..., :3, :3])
    jinv = torch.linalg.inv(_so3_left_jacobian(w))
    v = (jinv @ t4[..., :3, 3][..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inverse(t4: torch.Tensor) -> torch.Tensor:
    rt = t4[..., :3, :3].transpose(-1, -2)
    ti = -(rt @ t4[..., :3, 3][..., None])[..., 0]
    return _homogeneous(rt, ti)


def adjoint(t4: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3) for (v, w)-ordered twists, batched over leading axes:
    exp(adjoint(T) @ xi) == T @ exp(xi) @ inv(T)."""
    r = t4[..., :3, :3]
    top = torch.cat([r, skew(t4[..., :3, 3]) @ r], dim=-1)
    bottom = torch.cat([torch.zeros_like(r), r], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def transform_points(t4: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to (..., 3) points (full f32 product)."""
    return pts @ t4[..., :3, :3].transpose(-1, -2) + t4[..., :3, 3]


def rotation_angle(r: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def pose_distance(t_a: torch.Tensor, t_b: torch.Tensor):
    """(translation distance, rotation angle) between two poses."""
    dt = torch.linalg.norm(t_a[..., :3, 3] - t_b[..., :3, 3], dim=-1)
    dr = rotation_angle(t_a[..., :3, :3].transpose(-1, -2) @ t_b[..., :3, :3])
    return dt, dr


def yaw_grid(n: int = 16) -> np.ndarray:
    """(n, 4, 4) float64 numpy grid of rotations about the rig's vertical
    (x) axis, evenly covering [0, 2*pi)."""
    a = (2 * np.pi / n) * np.arange(n)
    g = np.tile(np.eye(4), (n, 1, 1))
    c, s = np.cos(a), np.sin(a)
    g[:, 1, 1] = c
    g[:, 1, 2] = -s
    g[:, 2, 1] = s
    g[:, 2, 2] = c
    return g
