"""The spherical frame and its build pipeline (twin of
`rgbd360_tpu/core/frame.py`).

A raw rig capture (8 RGB-D images) becomes undistorted per-sensor depth,
the stitched spherical RGB / gray / depth images, and the per-sensor
organized clouds (2x downsampled, bilateral-smoothed, in each sensor's
frame and in the rig frame).  `build_with_pyramid` adds the frame's
alignment pyramid (kernels K1 and K2), `build_full` the frame's plane set
too: the whole per-frame tracking front end.  `build` and `segment_planes`
also take a leading batch axis of captures (the reference's `build_batch`
and `segment_planes_batch`); `build_gray_depth_batch` builds only the gray
and depth spheres of a batch.  The 8-sensor fan-out is a leading sensor
axis everywhere (no loop over sensors).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from rgbd360_tpu_torch import resolve_device
from rgbd360_tpu_torch.config import FrameworkConfig, default_config
from rgbd360_tpu_torch.io.bin_format import RawRigFrame  # noqa: F401  (re-exported)
from rgbd360_tpu_torch.io.calib import Calibration
from rgbd360_tpu_torch.ops import camera, pyramid as pyr_ops, segmentation as seg_ops
from rgbd360_tpu_torch.ops import stitch as stitch_ops, undistort as undistort_ops
from rgbd360_tpu_torch.ops.bilateral import bilateral_depth
from rgbd360_tpu_torch.registration import dense as dense_ops

_MAP_KEYS = ("sensor", "u", "v", "scale", "valid")


@dataclass
class RigFrame:
    """Raw rig capture.

    rgb:   (S, H, W, 3) uint8 BGR as captured.
    depth: (S, H, W) uint16 millimetres, 0 = invalid (or float32 metres).
    """

    rgb: torch.Tensor
    depth: torch.Tensor

    @staticmethod
    def from_raw(raw, device=None) -> "RigFrame":
        """From a `RawRigFrame` (any object with `rgb` and `depth_mm`),
        onto `device`: the card when None (`default_device()`)."""
        device = resolve_device(device)
        return RigFrame(
            rgb=torch.from_numpy(raw.rgb).to(device),
            depth=torch.from_numpy(raw.depth_mm).to(device),
        )


@dataclass
class SphereFrame:
    """Built spherical frame (a batch of frames has a leading axis B).

    sphere_rgb:   (Hs, Ws, 3) float32 BGR 0..255.
    sphere_gray:  (Hs, Ws) float32 in [0, 1].
    sphere_depth: (Hs, Ws) float32 radial metres, 0 = invalid.
    cloud_xyz:    (S, Hc, Wc, 3) float32 per-sensor organized clouds in the
                  rig frame (2x downsampled unless `downsample_cloud` is
                  off), NaN where invalid.
    cloud_rgb:    (S, Hc, Wc, 3) float32.
    cloud_valid:  (S, Hc, Wc) bool.
    local_xyz:    (S, Hc, Wc, 3) float32, the same clouds in each sensor's
                  frame (0 where invalid), which plane segmentation reads.
    """

    sphere_rgb: torch.Tensor
    sphere_gray: torch.Tensor
    sphere_depth: torch.Tensor
    cloud_xyz: torch.Tensor
    cloud_rgb: torch.Tensor
    cloud_valid: torch.Tensor
    local_xyz: torch.Tensor


def downsample2_depth(depth: torch.Tensor) -> torch.Tensor:
    """2x downsample of (..., H, W) depth: the mean of each 2x2 block's
    valid (> 0) depths, 0 where none is valid.  Even shapes sum through
    0/1 matmuls, whose 2-addend dot products are exact in any order."""
    h, w = depth.shape[-2], depth.shape[-1]
    valid = depth > 0
    if h % 2 == 0 and w % 2 == 0:
        a, b = pyr_ops._box_sum_mats(h, w, depth.device)
        s = (a @ torch.where(valid, depth, 0.0)) @ b
        n = (a @ valid.to(depth.dtype)) @ b
        return torch.where(n > 0.5, s / torch.clamp(n, min=1.0), 0.0)
    h2, w2 = h // 2, w // 2
    d = depth[..., : h2 * 2, : w2 * 2].reshape(*depth.shape[:-2], h2, 2, w2, 2)
    v = d > 0
    s = torch.sum(torch.where(v, d, 0.0), dim=(-3, -1))
    n = torch.sum(v, dim=(-3, -1))
    return torch.where(n > 0, s / torch.clamp(n, min=1), 0.0)


def downsample2_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """2x2 block mean of (..., H, W, 3) float rgb (sums of integer-valued
    captures are exact)."""
    h2, w2 = rgb.shape[-3] // 2, rgb.shape[-2] // 2
    r = rgb[..., : h2 * 2, : w2 * 2, :]
    r = r.reshape(*rgb.shape[:-3], h2, 2, w2, 2, 3)
    return torch.mean(r, dim=(-4, -2))


def _region(timer, name: str):
    return timer.region(name) if timer is not None else contextlib.nullcontext()


class FrameBuilder(nn.Module):
    """Builds SphereFrames from raw rig captures for a fixed calibration.

    The calibration tensors (stitch maps, extrinsics, intrinsics, CLAMS
    per-pixel tables, per-level seam masks) are registered buffers on
    `device`: the card when None (`default_device()`, which raises where
    there is none), the CPU only when asked for.  They are computed once on
    the host, so their values do not depend on the device, then moved; a
    frame is built on the buffers' device.
    `convert.frame_builder_state_dict` turns the reference builder's
    parameters into these buffers.  The cloud stage and the segmentation
    have no state of their own.
    """

    def __init__(
        self,
        calib: Calibration,
        config: FrameworkConfig | None = None,
        downsample_cloud: bool = True,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config or default_config()
        self.downsample_cloud = downsample_cloud
        rig, sph = self.config.rig, self.config.sphere
        rt = torch.as_tensor(calib.rt, dtype=torch.float32)
        rt_inv = torch.as_tensor(calib.rt_inv, dtype=torch.float32)
        k = torch.as_tensor(calib.k, dtype=torch.float32)
        maps = stitch_ops.compute_stitch_maps(
            rt_inv, k, sph.height, sph.width, rig.height, rig.width
        )
        for name in _MAP_KEYS:
            self.register_buffer(name, getattr(maps, name))
        self.register_buffer("rt", rt)
        self.register_buffer("rt_inv", rt_inv)
        self.register_buffer("k", k)
        self.clams_bin_depth = None
        if calib.clams_multipliers is not None:
            self.clams_bin_depth = float(calib.clams_bin_depth)
            m_img, c_img = undistort_ops.precompute_pixel_tables(
                torch.as_tensor(calib.clams_multipliers, dtype=torch.float32),
                torch.as_tensor(calib.clams_counts, dtype=torch.float32),
                calib.clams_bin_width, calib.clams_bin_height,
                rig.height, rig.width,
            )
            self.register_buffer("clams_m_img", m_img)
            self.register_buffer("clams_c_img", c_img)
        seam = stitch_ops.seam_mask_from_maps(maps, 1)
        levels = dense_ops.seam_masks_per_level(seam, self.config.dense.pyramid_levels)
        for lvl, m in enumerate(levels):
            self.register_buffer(f"seam_{lvl}", m)
        self.to(device)

    @property
    def maps(self) -> stitch_ops.StitchMaps:
        return stitch_ops.StitchMaps(**{k: getattr(self, k) for k in _MAP_KEYS})

    @property
    def seam_levels(self) -> tuple:
        return tuple(
            getattr(self, f"seam_{lvl}")
            for lvl in range(self.config.dense.pyramid_levels)
        )

    def undistort(self, frame: RigFrame) -> RigFrame:
        """CLAMS depth undistortion of a raw capture (reference
        `Frame360::undistort:293`).  Accepts u16 millimetre or f32 metre
        depth; returns metres."""
        self._check_device(frame.rgb, frame.depth)
        return RigFrame(rgb=frame.rgb, depth=self._undistort_depth(frame.depth))

    def _undistort_depth(self, depth_raw: torch.Tensor) -> torch.Tensor:
        """dtype normalization (u16 mm -> f32 m, multiplied in f32) and CLAMS
        undistortion of (..., S, H, W) depth."""
        if depth_raw.dtype != torch.float32:
            depth_raw = depth_raw.to(torch.float32) * 0.001
        if self.clams_bin_depth is None:
            return depth_raw
        return undistort_ops.undistort_depth_pixeltab(
            depth_raw, self.clams_m_img, self.clams_c_img, self.clams_bin_depth
        )

    def _check_device(self, rgb: torch.Tensor, depth_raw: torch.Tensor) -> None:
        if rgb.device != self.sensor.device or depth_raw.device != self.sensor.device:
            raise ValueError(
                f"frame on {rgb.device}/{depth_raw.device}, builder on "
                f"{self.sensor.device}: move one of them first"
            )

    def _cloud_stage(
        self, rgb, depth, sphere_rgb, sphere_gray, sphere_depth
    ) -> SphereFrame:
        """Per-sensor clouds of (..., S, H, W) f32 rgb and undistorted depth:
        the 2x downsample (like the reference's DOWNSAMPLE_160), the
        bilateral, the depth gate, the pinhole backprojection, the rig
        transform, NaN where invalid."""
        rig = self.config.rig
        if self.downsample_cloud:
            d_small = downsample2_depth(depth)
            rgb_small = downsample2_rgb(rgb)
            # principal point shifts under 2x decimation: (c - 0.25) ~ c/2
            k_small = torch.cat([self.k[:2] * 0.5, self.k[2:]])
        else:
            d_small, rgb_small, k_small = depth, rgb, self.k
        if rig.bilateral:
            # reference USE_BILATERAL_FILTER (default on), sigmaS = 10 px,
            # sigmaR = 0.05 m (`include/Frame360.h:40,492-499`)
            d_small = bilateral_depth(
                d_small, sigma_s=rig.bilateral_sigma_s, sigma_r=rig.bilateral_sigma_r
            )
        valid = (d_small > rig.min_depth) & (d_small < rig.max_depth)
        d_gated = torch.where(valid, d_small, 0.0)
        local_xyz = camera.pinhole_backproject(d_gated, k_small)  # (..., S, h, w, 3)
        r = self.rt[:, :3, :3]
        t = self.rt[:, :3, 3]
        cloud_xyz = local_xyz @ r.mT[:, None] + t[:, None, None, :]
        cloud_xyz = torch.where(valid[..., None], cloud_xyz, torch.nan)
        return SphereFrame(
            sphere_rgb=sphere_rgb, sphere_gray=sphere_gray, sphere_depth=sphere_depth,
            cloud_xyz=cloud_xyz, cloud_rgb=rgb_small, cloud_valid=valid,
            local_xyz=local_xyz,
        )

    def _build_impl(self, rgb: torch.Tensor, depth_raw: torch.Tensor, timer=None) -> SphereFrame:
        """One capture (S, H, W, ...) or a batch (B, S, H, W, ...): one
        stitch gather for the batch, then the cloud stage.  With
        `sphere.parallax_refine` one capture takes the two-pass
        `stitch_refined`; a batch never refines (the reference's
        `build_batch` stitches with the calibration-only maps)."""
        self._check_device(rgb, depth_raw)
        batched = rgb.ndim == 5
        with _region(timer, "stitch"):
            depth = self._undistort_depth(depth_raw)
            rgb = rgb.to(torch.float32)
            if not batched and self.config.sphere.parallax_refine:
                sphere_rgb, sphere_depth = stitch_ops.stitch_refined(
                    self.maps, rgb, depth, self.rt, self.rt_inv, self.k
                )
            else:
                sphere_rgb, sphere_depth = stitch_ops.stitch_batch(
                    self.maps, rgb if batched else rgb[None], depth if batched else depth[None]
                )
                if not batched:
                    sphere_rgb, sphere_depth = sphere_rgb[0], sphere_depth[0]
            sphere_gray = stitch_ops.rgb_to_gray(sphere_rgb)
        with _region(timer, "cloud"):
            return self._cloud_stage(rgb, depth, sphere_rgb, sphere_gray, sphere_depth)

    def build(self, frame: RigFrame) -> SphereFrame:
        """One capture, or a batch: rgb (B, S, H, W, 3) u8 and depth
        (B, S, H, W) u16 mm give a SphereFrame with a leading batch axis."""
        return self._build_impl(frame.rgb, frame.depth)

    def build_from_raw(self, raw) -> SphereFrame:
        return self.build(RigFrame.from_raw(raw, self.sensor.device))

    def build_gray_depth_batch(
        self, rgbs: torch.Tensor, depths_raw: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(sphere_gray (B, H', W'), sphere_depth (B, H', W')) of B raw
        captures, rgbs (B, S, H, W, 3) u8 BGR, depths_raw (B, S, H, W) u16
        mm: gray per sensor from the raw capture, then ONE stitch gather for
        the batch (the reference's `_build_gray_depth_batch_impl`)."""
        self._check_device(rgbs, depths_raw)
        return stitch_ops.stitch_gray_depth_batch(
            self.maps, stitch_ops.rgb_to_gray(rgbs), self._undistort_depth(depths_raw)
        )

    def pyramid(self, sphere: SphereFrame) -> dense_ops.FramePyramid:
        """The frame's alignment pyramid, with the calibration's per-level
        seam masks."""
        return dense_ops.build_frame_pyramid(
            sphere.sphere_gray, sphere.sphere_depth, self.config.dense, self.seam_levels
        )

    def build_with_pyramid(self, frame: RigFrame):
        """(SphereFrame, FramePyramid): the frame build and its alignment
        pyramid."""
        sphere = self.build(frame)
        return sphere, self.pyramid(sphere)

    def build_full(self, frame: RigFrame, timer=None):
        """(SphereFrame, FramePyramid, PlaneSet) of one raw capture in one
        call: the per-frame tracking front end (the reference's load /
        undistort / stitch / cloud / getPlanes sequence,
        `Frame360.h:231-615`), with each stage a region of `timer` (a
        `utils.trace.StageTimer`) when given."""
        sphere = self._build_impl(frame.rgb, frame.depth, timer)
        with _region(timer, "pyramid"):
            pyr = self.pyramid(sphere)
        with _region(timer, "segment"):
            planes = self.segment_planes(sphere)
        return sphere, pyr, planes

    # ------------------------------------------------------------- planes

    def segment_planes(self, frame: SphereFrame) -> seg_ops.PlaneSet:
        """The frame's PbMap-equivalent plane set (rig frame); a batch of
        frames gives a batch of sets.  Per-sensor segmentation + cross-sensor
        grouping (the reference `Frame360::getPlanes` -> `getPlanesSensor`
        -> `groupPlanes`/`mergePlanes`): all sensors (and frames) segment in
        one batched call, each sensor's set moves into the rig frame, then
        the sets of a frame merge."""
        seg_cfg = self.config.seg
        per_sensor = seg_ops.segment_planes_sensor(
            frame.local_xyz, frame.cloud_rgb, frame.cloud_valid, seg_cfg
        )
        rig_frame = seg_ops.transform_planes(per_sensor, self.rt)
        return seg_ops.merge_plane_sets(seg_ops.concat_sets(rig_frame), seg_cfg)

    def segment_planes_from_sphere(
        self, sphere_depth: torch.Tensor, sphere_rgb: torch.Tensor | None = None,
        downsample: int = 4,
    ) -> seg_ops.PlaneSet:
        """Plane segmentation directly from the spherical image (sources
        that provide only a stitched sphere, like the reference's
        `Frame360_stereo`)."""
        if sphere_rgb is None:
            sphere_rgb = torch.zeros(sphere_depth.shape + (3,), device=sphere_depth.device)
        d = sphere_depth[::downsample, ::downsample]
        r = sphere_rgb[::downsample, ::downsample]
        cfg = self.config.seg
        ps = seg_ops.segment_planes_sensor(camera.sphere_backproject(d), r, d > 0, cfg)
        return seg_ops.merge_plane_sets(ps, cfg)
