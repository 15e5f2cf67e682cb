"""Spherical stitching of the 8 sensor images (twin of
`rgbd360_tpu/ops/stitch.py`).

The pixel -> sample mapping depends only on the calibration, so it is
computed once as dense gather maps (owning sensor, source pixel, radial
scale, validity); every stitch is then one gather over the stacked sensor
tensors.  Each sphere pixel belongs to the sensor that sees its ray most
head-on among the in-bounds projections, in one canonical sphere frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rgbd360_tpu_torch.ops import camera


@dataclass
class StitchMaps:
    """Precomputed gather maps from sphere pixels to sensor samples.

    sensor: (H, W) int32 — owning sensor per sphere pixel.
    u, v:   (H, W) int32 — nearest source pixel (truncated, like cv::Mat::at).
    scale:  (H, W) float32 — z-depth -> ray-length factor at the continuous
            source coordinates.
    valid:  (H, W) bool — projection landed inside the source image.
    """

    sensor: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    scale: torch.Tensor
    valid: torch.Tensor


def _trunc_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """int32(x) clipped to [0, n-1], as the reference's `astype` + clip.

    XLA's float -> int cast saturates (NaN -> 0); PyTorch's is undefined
    out of the int32 range (INT_MIN on x86, saturation on CUDA).  Clamping
    to [-1, n] first gives the reference's result on every device, because
    the clip that follows maps both ends to the same indices."""
    return torch.clamp(torch.clamp(x, -1.0, float(n)).to(torch.int32), 0, n - 1)


def compute_stitch_maps(
    rt_inv: torch.Tensor,
    k: torch.Tensor,
    sphere_h: int,
    sphere_w: int,
    sensor_h: int,
    sensor_w: int,
) -> StitchMaps:
    """Gather maps for a calibration: rt_inv (S, 4, 4) rig->sensor
    transforms, k (3, 3) pinhole intrinsics."""
    rays = camera.sphere_rays(sphere_h, sphere_w, device=rt_inv.device)  # (H, W, 3)
    # the unit virtual point of every ray, in every sensor's frame
    r_inv = rt_inv[:, :3, :3]
    t_inv = rt_inv[:, :3, 3]
    p = torch.einsum("sij,hwj->shwi", r_inv, rays) + t_inv[:, None, None, :]

    z = p[..., 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    u_f = k[0, 0] * p[..., 0] / zs + k[0, 2]
    v_f = k[1, 1] * p[..., 1] / zs + k[1, 2]

    in_bounds = (
        (z > 1e-6) & (u_f >= 0) & (u_f < sensor_w) & (v_f >= 0) & (v_f < sensor_h)
    )
    # the sensor that sees the ray most head-on (first maximum on ties)
    score = torch.where(in_bounds, z / torch.linalg.norm(p, dim=-1), -torch.inf)
    sensor = torch.argmax(score, dim=0)  # (H, W) int64

    def pick(a):
        return torch.gather(a, 0, sensor[None])[0]

    u_sel, v_sel, valid = pick(u_f), pick(v_f), pick(in_bounds)
    xn = (u_sel - k[0, 2]) / k[0, 0]
    yn = (v_sel - k[1, 2]) / k[1, 1]
    scale = torch.sqrt(1.0 + xn * xn + yn * yn)
    return StitchMaps(
        sensor=sensor.to(torch.int32),
        u=_trunc_index(u_sel, sensor_w),
        v=_trunc_index(v_sel, sensor_h),
        scale=scale.to(torch.float32),
        valid=valid,
    )


def seam_mask_from_maps(maps: StitchMaps, half_width: int = 1) -> torch.Tensor:
    """(H, W) bool mask, True away from sensor hand-off seams (where
    per-camera auto-shutter creates fake gradients)."""
    s = maps.sensor
    seam = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    for d in range(1, half_width + 1):
        seam |= s != torch.roll(s, d, dims=1)
        seam |= s != torch.roll(s, -d, dims=1)
    return ~seam


def stitch(
    maps: StitchMaps, rgb: torch.Tensor, depth: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather the spherical RGB and radial-depth images.

    rgb: (S, H, W, 3) any dtype; depth: (S, H, W) float32 metres.
    Returns (sphere_rgb (H', W', 3) float32, sphere_depth (H', W'))."""
    pack = torch.cat(
        [rgb.to(torch.float32), depth[..., None].to(torch.float32)], dim=-1
    )
    sh, sw = rgb.shape[1], rgb.shape[2]
    lin = (maps.sensor.long() * sh + maps.v.long()) * sw + maps.u.long()
    vals = pack.reshape(-1, 4)[lin]  # (H', W', 4)
    rgb_out = torch.where(maps.valid[..., None], vals[..., :3], 0.0)
    d = vals[..., 3]
    depth_out = torch.where(maps.valid & (d > 0), d * maps.scale, 0.0)
    return rgb_out, depth_out


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """BGR (capture order) -> normalized gray in [0, 1], float32, with
    OpenCV's BGR2GRAY weights in the reference's operation order."""
    b = rgb[..., 0].to(torch.float32)
    g = rgb[..., 1].to(torch.float32)
    r = rgb[..., 2].to(torch.float32)
    return (0.114 * b + 0.587 * g + 0.299 * r) * (1.0 / 255.0)
