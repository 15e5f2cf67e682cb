"""Spherical stitching of the 8 sensor images (twin of
`rgbd360_tpu/ops/stitch.py`).

The pixel -> sample mapping depends only on the calibration, so it is
computed once as dense gather maps (owning sensor, source pixel, radial
scale, validity); every stitch is then one gather over the stacked sensor
tensors.  Each sphere pixel belongs to the sensor that sees its ray most
head-on among the in-bounds projections, in one canonical sphere frame.
`stitch_refined` adds a second, parallax-corrected pass (each ray
re-projected at its measured depth); `fast_stitch` is the
concatenation-only panorama.
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


def _owned(mats: torch.Tensor, vecs: torch.Tensor, sensor: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """mats[s] @ x + vecs[s] per pixel, s = sensor (H, W): each pixel's
    owning sensor's transform, gathered (the reference contracts a one-hot
    over all the sensors' products, which selects the same values; the
    3-term sums here round without fused multiply-adds)."""
    m = mats[sensor]  # (H, W, 3, 3)
    return (m[..., 0] * x[..., 0:1] + m[..., 1] * x[..., 1:2]
            + m[..., 2] * x[..., 2:3]) + vecs[sensor]


def _project_at_depth(maps: StitchMaps, sphere_depth: torch.Tensor, rt_inv: torch.Tensor,
                      k: torch.Tensor, sensor_h: int, sensor_w: int):
    """Continuous sensor coordinates of each sphere ray placed at its
    measured radial depth, in its owning sensor: (u_f, v_f, ok, rays)."""
    rays = camera.sphere_rays(*sphere_depth.shape, device=sphere_depth.device)
    p_rig = rays * torch.clamp(sphere_depth, min=1e-3)[..., None]
    p = _owned(rt_inv[:, :3, :3], rt_inv[:, :3, 3], maps.sensor.long(), p_rig)
    z = p[..., 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    u_f = k[0, 0] * p[..., 0] / zs + k[0, 2]
    v_f = k[1, 1] * p[..., 1] / zs + k[1, 2]
    ok = (
        (sphere_depth > 0) & (z > 1e-6)
        & (u_f >= 0) & (u_f < sensor_w) & (v_f >= 0) & (v_f < sensor_h)
    )
    return u_f, v_f, ok, rays


def refine_stitch_maps(maps: StitchMaps, sphere_depth: torch.Tensor, rt_inv: torch.Tensor,
                       k: torch.Tensor, sensor_h: int, sensor_w: int) -> StitchMaps:
    """Parallax-corrected gather maps from a first-pass sphere depth.

    The calibration-only maps project each ray as a point 1 m away, so an
    off-centre sensor samples the wrong surface point at other depths (a
    fixed rig-locked warp of up to a few degrees).  This pass re-projects
    each ray at its measured radial depth into its owning sensor; pixels
    with no depth keep the first-pass mapping."""
    u_f, v_f, ok, _ = _project_at_depth(maps, sphere_depth, rt_inv, k, sensor_h, sensor_w)
    xn = (u_f - k[0, 2]) / k[0, 0]
    yn = (v_f - k[1, 2]) / k[1, 1]
    scale = torch.sqrt(1.0 + xn * xn + yn * yn).to(torch.float32)
    return StitchMaps(
        sensor=maps.sensor,
        u=torch.where(ok, _trunc_index(u_f, sensor_w), maps.u),
        v=torch.where(ok, _trunc_index(v_f, sensor_h), maps.v),
        scale=torch.where(ok, scale, maps.scale),
        valid=maps.valid,
    )


def stitch_refined(maps: StitchMaps, rgb: torch.Tensor, depth: torch.Tensor,
                   rt: torch.Tensor, rt_inv: torch.Tensor,
                   k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass parallax-corrected stitch of one capture.

    Pass 1 stitches with the calibration-only maps; pass 2 re-projects each
    ray at its measured radial depth into its owning sensor, gathers again
    and stores the exact rig-centred radial distance |R q + t| of the
    sampled sensor point q (the one-pass form stores the sensor-centred
    ray length, biased by the sensor's offset from the rig centre).

    rgb: (S, H, W, 3) any dtype; depth: (S, H, W) float32 metres; rt,
    rt_inv: (S, 4, 4); k: (3, 3).  Returns (sphere_rgb (H', W', 3) float32,
    sphere_depth (H', W'))."""
    sensor_h, sensor_w = rgb.shape[1], rgb.shape[2]
    _, d0 = stitch(maps, rgb, depth)
    u_f, v_f, ok, _ = _project_at_depth(maps, d0, rt_inv, k, sensor_h, sensor_w)
    s = maps.sensor.long()
    u_i = torch.where(ok, _trunc_index(u_f, sensor_w), maps.u).long()
    v_i = torch.where(ok, _trunc_index(v_f, sensor_h), maps.v).long()
    pack = torch.cat(
        [rgb.to(torch.float32), depth[..., None].to(torch.float32)], dim=-1
    ).reshape(-1, 4)
    vals = pack[(s * sensor_h + v_i) * sensor_w + u_i]  # (H', W', 4)
    rgb_out = torch.where(maps.valid[..., None], vals[..., :3], 0.0)
    d = vals[..., 3]
    # the rig-centred radial depth of the sampled point q = d * [xn, yn, 1]
    xn = (torch.where(ok, u_f, maps.u.to(torch.float32)) - k[0, 2]) / k[0, 0]
    yn = (torch.where(ok, v_f, maps.v.to(torch.float32)) - k[1, 2]) / k[1, 1]
    n_s = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    t_sel = rt[:, :3, 3][s]
    n_rig = _owned(rt[:, :3, :3], torch.zeros_like(rt[:, :3, 3]), s, n_s)
    radial = torch.sqrt(
        d * d * torch.sum(n_s * n_s, dim=-1)
        + 2.0 * d * torch.sum(n_rig * t_sel, dim=-1)
        + torch.sum(t_sel * t_sel, dim=-1)
    )
    depth_out = torch.where(maps.valid & (d > 0), radial, 0.0)
    return rgb_out, depth_out


def fast_stitch(rgb: torch.Tensor) -> torch.Tensor:
    """Concatenation-only panorama (reference `Frame360::fastStitchImage360`,
    `include/Frame360.h:348-383`): each sensor image rotated 90 degrees
    counter-clockwise (transpose, then a vertical flip), sensor (S-1-s) at
    column block s.  rgb: (S, H, W, ...) -> (W, S*H, ...)."""
    rot = torch.flip(torch.swapaxes(rgb, 1, 2), dims=(1,))  # (S, W, H, ...)
    return torch.cat(list(torch.flip(rot, dims=(0,))), dim=1)


def seam_mask_from_maps(maps: StitchMaps, half_width: int = 1) -> torch.Tensor:
    """(H, W) bool mask, True away from sensor hand-off seams (where
    per-camera auto-shutter creates fake gradients)."""
    s = maps.sensor
    seam = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    for d in range(1, half_width + 1):
        seam |= s != torch.roll(s, d, dims=1)
        seam |= s != torch.roll(s, -d, dims=1)
    return ~seam


def _gather_index(maps: StitchMaps, sh: int, sw: int) -> torch.Tensor:
    """(H', W') flat index into the (S, sh, sw) sensor stack of every
    sphere pixel: one index serves every frame of a batch."""
    return (maps.sensor.long() * sh + maps.v.long()) * sw + maps.u.long()


def stitch(
    maps: StitchMaps, rgb: torch.Tensor, depth: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather the spherical RGB and radial-depth images.

    rgb: (S, H, W, 3) any dtype; depth: (S, H, W) float32 metres.
    Returns (sphere_rgb (H', W', 3) float32, sphere_depth (H', W'))."""
    rgb_out, depth_out = stitch_batch(maps, rgb[None], depth[None])
    return rgb_out[0], depth_out[0]


def stitch_batch(
    maps: StitchMaps, rgb: torch.Tensor, depth: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stitch a batch of rig captures with one gather.

    rgb: (B, S, H, W, 3) any dtype; depth: (B, S, H, W) float32 metres.
    Returns (sphere_rgb (B, H', W', 3) float32, sphere_depth (B, H', W'))."""
    b, sh, sw = rgb.shape[0], rgb.shape[2], rgb.shape[3]
    pack = torch.cat(
        [rgb.to(torch.float32), depth[..., None].to(torch.float32)], dim=-1
    ).reshape(b, -1, 4)
    vals = pack[:, _gather_index(maps, sh, sw)]  # (B, H', W', 4)
    rgb_out = torch.where(maps.valid[..., None], vals[..., :3], 0.0)
    d = vals[..., 3]
    depth_out = torch.where(maps.valid & (d > 0), d * maps.scale, 0.0)
    return rgb_out, depth_out


def stitch_gray_depth_batch(
    maps: StitchMaps, gray: torch.Tensor, depth: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stitch a batch of per-sensor GRAY + depth images with one gather
    (tracking reads only the sphere's intensity and depth, so the gray
    conversion happens per sensor, before the stitch).

    gray: (B, S, H, W) float32 in [0, 1]; depth: (B, S, H, W) float32 metres.
    Returns (sphere_gray (B, H', W'), sphere_depth (B, H', W'))."""
    b, sh, sw = gray.shape[0], gray.shape[2], gray.shape[3]
    pack = torch.stack([gray, depth], dim=-1).reshape(b, -1, 2)
    vals = pack[:, _gather_index(maps, sh, sw)]  # (B, H', W', 2)
    gray_out = torch.where(maps.valid, vals[..., 0], 0.0)
    d = vals[..., 1]
    depth_out = torch.where(maps.valid & (d > 0), d * maps.scale, 0.0)
    return gray_out, depth_out


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """BGR (capture order) -> normalized gray in [0, 1], float32, with
    OpenCV's BGR2GRAY weights in the reference's operation order."""
    b = rgb[..., 0].to(torch.float32)
    g = rgb[..., 1].to(torch.float32)
    r = rgb[..., 2].to(torch.float32)
    return (0.114 * b + 0.587 * g + 0.299 * r) * (1.0 / 255.0)
