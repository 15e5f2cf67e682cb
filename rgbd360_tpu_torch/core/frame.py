"""The spherical frame and its build pipeline (twin of
`rgbd360_tpu/core/frame.py`).

A raw rig capture (8 RGB-D images) becomes undistorted per-sensor depth,
then the stitched spherical RGB / gray / depth images, and, through
`build_with_pyramid`, the frame's alignment pyramid; `build_gray_depth_batch`
builds the gray and depth spheres of a batch of captures.  The per-sensor
cloud stage of the reference is not ported yet (nor `build_batch`, which
needs it): tracking reads only the sphere's gray and depth.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from rgbd360_tpu.config import FrameworkConfig, default_config
from rgbd360_tpu.io.calib import Calibration
from rgbd360_tpu_torch.ops import stitch as stitch_ops, undistort as undistort_ops
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
        """From an `io.bin_format.RawRigFrame`, onto `device`."""
        return RigFrame(
            rgb=torch.from_numpy(raw.rgb).to(device),
            depth=torch.from_numpy(raw.depth_mm).to(device),
        )


@dataclass
class SphereFrame:
    """Built spherical frame.

    sphere_rgb:   (Hs, Ws, 3) float32 BGR 0..255.
    sphere_gray:  (Hs, Ws) float32 in [0, 1].
    sphere_depth: (Hs, Ws) float32 radial metres, 0 = invalid.
    """

    sphere_rgb: torch.Tensor
    sphere_gray: torch.Tensor
    sphere_depth: torch.Tensor


class FrameBuilder(nn.Module):
    """Builds SphereFrames from raw rig captures for a fixed calibration.

    The calibration tensors (stitch maps, extrinsics, intrinsics, CLAMS
    per-pixel tables, per-level seam masks) are registered buffers, so
    `.to(device)` moves them; a frame is built on the buffers' device.
    `convert.frame_builder_state_dict` turns the reference builder's
    parameters into these buffers.
    """

    def __init__(self, calib: Calibration, config: FrameworkConfig | None = None):
        super().__init__()
        self.config = config or default_config()
        if self.config.sphere.parallax_refine:
            raise NotImplementedError("the parallax-refined stitch is not ported yet")
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

    @property
    def maps(self) -> stitch_ops.StitchMaps:
        return stitch_ops.StitchMaps(**{k: getattr(self, k) for k in _MAP_KEYS})

    @property
    def seam_levels(self) -> tuple:
        return tuple(
            getattr(self, f"seam_{lvl}")
            for lvl in range(self.config.dense.pyramid_levels)
        )

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

    def _build_impl(self, rgb: torch.Tensor, depth_raw: torch.Tensor) -> SphereFrame:
        self._check_device(rgb, depth_raw)
        depth = self._undistort_depth(depth_raw)
        sphere_rgb, sphere_depth = stitch_ops.stitch(self.maps, rgb, depth)
        return SphereFrame(
            sphere_rgb=sphere_rgb,
            sphere_gray=stitch_ops.rgb_to_gray(sphere_rgb),
            sphere_depth=sphere_depth,
        )

    def build(self, frame: RigFrame) -> SphereFrame:
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

    def build_with_pyramid(self, frame: RigFrame):
        """(SphereFrame, FramePyramid): the frame build and its alignment
        pyramid, with the calibration's per-level seam masks."""
        sphere = self.build(frame)
        pyr = dense_ops.build_frame_pyramid(
            sphere.sphere_gray, sphere.sphere_depth, self.config.dense,
            self.seam_levels,
        )
        return sphere, pyr
